r"""Extended Phase Graphs (EPG): differentiable echo-train simulation
(counterpart of :mod:`mrphy_tpu.ops.epg`, its single-pool SPGR part).

Magnetization is tracked in the Fourier domain of the dephasing angle as
configuration states ``F+(k), F−(k), Z(k)``; the state is a real ``(...,
3, K, 2)`` tensor (trailing axis [re, im]), as in the JAX package.
Conventions follow the EPG literature (Weigel's tutorial, Hargreaves'
reference implementation): the RF mixing matrix about phase ``phi``, the
gradient shift ``F+(k)→F+(k+1)``, ``F−(k)→F−(k−1)``, ``F+(0) =
conj(F−(0))`` after the shift.

:func:`epg_spgr`, the MRF dictionary's train, has two routes
(:func:`mrphy_tpu_torch.ops.routing.route` says which a call takes):

- the plain route, a Python loop over TRs of the primitives below (JAX's
  ``lax.scan``), differentiable by torch autograd;
- the kernels of :mod:`mrphy_tpu_torch.kernels.epg` for a shared 1-D flip
  train: ``spgr_fwd``, or ``spgr_fwd_chk`` with the hand-written adjoint
  ``spgr_bwd`` when a gradient is needed.

``backend='auto'`` takes the kernels for CUDA tensors and the plain route
for CPU tensors; ``'cuda'`` insists on the kernels (and raises for CPU
tensors); ``'torch'`` runs the plain route on any device. Per-voxel 2-D
flip trains run the plain route under ``'auto'`` on any device, as JAX's
``'xla-fallback'`` does, and raise under ``'cuda'``. ``mesh=`` raises
(multi-device runs are not ported yet).

CPMG and EPG-X trains (``epg_cpmg``, ``epgx_*``) are not ported yet.
"""

import math

import numpy as np
import torch

from mrphy_tpu_torch.kernels import epg as kepg

__all__ = ['epg_state', 'epg_rf', 'epg_grad', 'epg_relax', 'epg_diffusion',
           'epg_spgr', 'ir_prep', 'rf_spoil_phases']


def _t(x, like):
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def epg_state(K: int, batch=(), M0=1.0, dtype=torch.float32, device=None):
    r"""Equilibrium EPG state: `(*batch, 3, K, 2)` real ([re, im]),
    ``Z(0) = M0``."""
    s = torch.zeros(tuple(batch) + (3, K, 2), dtype=dtype, device=device)
    s[..., 2, 0, 0] = torch.broadcast_to(_t(M0, s), tuple(batch))
    return s


def _cmul(cr, ci, xr, xi):
    r"""Complex multiply of coefficient (cr, ci) with state (xr, xi)."""
    return cr * xr - ci * xi, cr * xi + ci * xr


def epg_rf(FpFmZ, alpha, phi=0.0):
    r"""Apply an ideal RF pulse: flip ``alpha`` (rad) about phase ``phi``
    (rad, from +x). ``alpha``/``phi`` broadcast against the batch axes
    (e.g. a per-voxel B1-scaled flip map)."""
    alpha = _t(alpha, FpFmZ)[..., None]       # broadcast over k
    phi = _t(phi, FpFmZ)[..., None]
    ca2 = torch.cos(alpha / 2) ** 2
    sa2 = torch.sin(alpha / 2) ** 2
    sa, ca = torch.sin(alpha), torch.cos(alpha)
    c1, s1 = torch.cos(phi), torch.sin(phi)
    c2, s2 = torch.cos(2 * phi), torch.sin(2 * phi)

    Fpr, Fpi = FpFmZ[..., 0, :, 0], FpFmZ[..., 0, :, 1]
    Fmr, Fmi = FpFmZ[..., 1, :, 0], FpFmZ[..., 1, :, 1]
    Zr, Zi = FpFmZ[..., 2, :, 0], FpFmZ[..., 2, :, 1]

    # row 1: ca2·Fp + sa2·e^{2iφ}·Fm + sa·(sinφ − i·cosφ)·Z
    ar, ai = _cmul(sa2 * c2, sa2 * s2, Fmr, Fmi)
    br, bi = _cmul(sa * s1, -sa * c1, Zr, Zi)
    Fp1r, Fp1i = ca2 * Fpr + ar + br, ca2 * Fpi + ai + bi
    # row 2: sa2·e^{−2iφ}·Fp + ca2·Fm + sa·(sinφ + i·cosφ)·Z
    ar, ai = _cmul(sa2 * c2, -sa2 * s2, Fpr, Fpi)
    br, bi = _cmul(sa * s1, sa * c1, Zr, Zi)
    Fm1r, Fm1i = ar + ca2 * Fmr + br, ai + ca2 * Fmi + bi
    # row 3: (sa/2)·(−sinφ − i·cosφ)·Fp + (sa/2)·(−sinφ + i·cosφ)·Fm + ca·Z
    ar, ai = _cmul(-0.5 * sa * s1, -0.5 * sa * c1, Fpr, Fpi)
    br, bi = _cmul(-0.5 * sa * s1, 0.5 * sa * c1, Fmr, Fmi)
    Z1r, Z1i = ar + br + ca * Zr, ai + bi + ca * Zi

    return torch.stack([torch.stack([Fp1r, Fp1i], -1),
                        torch.stack([Fm1r, Fm1i], -1),
                        torch.stack([Z1r, Z1i], -1)], dim=-3)


def _grad_pos1(FpFmZ):
    r"""Unit positive dephasing (+1 k-quantum)."""
    Fp, Fm, Z = FpFmZ[..., 0, :, :], FpFmZ[..., 1, :, :], \
        FpFmZ[..., 2, :, :]
    Fm1 = torch.cat([Fm[..., 1:, :], torch.zeros_like(Fm[..., :1, :])],
                    dim=-2)
    conj0 = Fm1[..., :1, :] * torch.tensor([1.0, -1.0], dtype=Fm.dtype,
                                           device=Fm.device)
    Fp1 = torch.cat([conj0, Fp[..., :-1, :]], dim=-2)
    return torch.stack([Fp1, Fm1, Z], dim=-3)


def _grad_neg1(FpFmZ):
    r"""Unit negative dephasing (−1 k-quantum): the exact mirror —
    ``F+`` shifts down, ``F−`` up, and the new ``F−(0)`` is
    ``conj(F+(0))``."""
    Fp, Fm, Z = FpFmZ[..., 0, :, :], FpFmZ[..., 1, :, :], \
        FpFmZ[..., 2, :, :]
    Fp1 = torch.cat([Fp[..., 1:, :], torch.zeros_like(Fp[..., :1, :])],
                    dim=-2)
    conj0 = Fp1[..., :1, :] * torch.tensor([1.0, -1.0], dtype=Fp.dtype,
                                           device=Fp.device)
    Fm1 = torch.cat([conj0, Fm[..., :-1, :]], dim=-2)
    return torch.stack([Fp1, Fm1, Z], dim=-3)


def epg_grad(FpFmZ, k: int = 1):
    r"""Gradient dephasing by ``k`` k-quanta (nonzero int; ``k<0``
    rewinds). ``k=+1``: ``F+(k)→F+(k+1)``, ``F−(k)→F−(k−1)``, new ``F+(0)
    = conj(F−(0))``; ``k=−1`` is the exact mirror; larger |k| compose unit
    shifts. States shifted beyond the highest modeled order ``K-1`` are
    dropped."""
    k = int(k)
    if k == 0:
        raise ValueError('k must be a nonzero integer (use no-op for k=0)')
    op = _grad_pos1 if k > 0 else _grad_neg1
    for _ in range(abs(k)):
        FpFmZ = op(FpFmZ)
    return FpFmZ


def epg_relax(FpFmZ, tau, T1, T2, M0=1.0):
    r"""Relaxation over ``tau`` seconds: ``F·E2``, ``Z·E1``, with
    ``(1−E1)·M0`` recovery into ``Z(0)``. ``T1``/``T2``/``M0`` broadcast
    against the batch axes (per-voxel maps)."""
    tau = _t(tau, FpFmZ)
    E1 = torch.exp(-tau / _t(T1, FpFmZ))[..., None, None]
    E2 = torch.exp(-tau / _t(T2, FpFmZ))[..., None, None]
    Fp = FpFmZ[..., 0, :, :] * E2
    Fm = FpFmZ[..., 1, :, :] * E2
    Z = FpFmZ[..., 2, :, :] * E1
    z00 = Z[..., 0, 0] + (1 - E1[..., 0, 0]) * _t(M0, FpFmZ)
    Z0 = torch.stack([z00, Z[..., 0, 1]], -1)[..., None, :]
    Z = torch.cat([Z0, Z[..., 1:, :]], dim=-2)
    return torch.stack(torch.broadcast_tensors(Fp, Fm, Z), dim=-3)


def epg_diffusion(FpFmZ, D, dk, tau, delta: int = 0):
    r"""Diffusion attenuation over an interval of ``tau`` seconds during
    which the applied gradient shifts the configuration orders by
    ``delta`` k-quanta (apply BEFORE the matching :func:`epg_grad`).

    The b-factor of order ``k`` over the interval is ``b_T(k) =
    τ·dk²·(k² + kδ + δ²/3)`` (``F−(k)`` carries ``−k``: ``k² − kδ +
    δ²/3``) and ``b_L(k) = τ·dk²·k²``; the attenuation is ``exp(−b·D)``
    (the standard EPG-diffusion treatment, exact for piecewise-constant
    gradients).

    Inputs:
        - ``FpFmZ``: `(*batch, 3, K, 2)` state.
        - ``D``: `()` ⊻ `(*batch,)`, "cm²/Sec", diffusivity.
        - ``dk``: `()`, "Rad/cm", dephasing of ONE k-quantum.
        - ``tau``: `()`, "Sec"; ``delta``: int k-quanta shifted during
          THIS interval.
    """
    K = FpFmZ.shape[-2]
    k = torch.arange(K, dtype=FpFmZ.dtype, device=FpFmZ.device)
    q2t = _t(tau, FpFmZ) * _t(dk, FpFmZ) ** 2
    d = float(delta)
    bTp = q2t * (k * k + k * d + d * d / 3)
    bTm = q2t * (k * k - k * d + d * d / 3)
    bL = q2t * (k * k)
    Db = _t(D, FpFmZ)[..., None]
    att = torch.stack([torch.exp(-Db * bTp), torch.exp(-Db * bTm),
                       torch.exp(-Db * bL)], dim=-2)   # (*batch, 3, K)
    return FpFmZ * att[..., None]


def _ndim(x) -> int:
    return x.ndim if isinstance(x, torch.Tensor) else np.ndim(x)


def _shape(x) -> tuple:
    return tuple(x.shape) if isinstance(x, torch.Tensor) else np.shape(x)


def _scalar_batch(*xs) -> bool:
    r"""True iff every batch-like argument is a scalar (or None): the
    call then returns an UNBATCHED `(nT, 2)` train on every route."""
    return all(x is None or _ndim(x) == 0 for x in xs)


def _unbatch(out, scalar: bool):
    r"""Drop the kernels' 1-atom axis for all-scalar calls."""
    return out[0] if scalar else out


def _apply_b1(flips, b1):
    r"""Per-voxel transmit scale: ``b1`` `(*batch,)` multiplies the flip
    train (the dictionary's B1+ dimension)."""
    if b1 is None:
        return flips
    return _t(b1, flips)[..., None] * flips


def rf_spoil_phases(n: int, phi0=117.0, *, dtype=None, device=None):
    r"""Quadratic RF-spoiling phase schedule ``φ_j = φ0·j(j+1)/2`` (the
    classic 117°/50° schedules), "Rad"; ``phi0`` in degrees. Formed in
    float64, returned in ``dtype`` (default: torch's default dtype)."""
    j = torch.arange(n, dtype=torch.float64, device=device)
    return (math.radians(float(phi0)) * (j * (j + 1) / 2)).to(
        dtype or torch.get_default_dtype())


def ir_prep(ti, T1, M0=1.0, inv_eff=1.0):
    r"""Longitudinal magnetization ``TI`` seconds after an inversion:
    ``M0·(1 − (1 + inv_eff)·exp(−TI/T1))``, the inversion-recovery prep
    for :func:`epg_spgr`'s ``zinit`` (MRF-FISP, Jiang et al. MRM 74:1621,
    2015). Differentiable in every argument."""
    T1 = torch.as_tensor(T1)
    return _t(M0, T1) * (1 - (1 + _t(inv_eff, T1))
                         * torch.exp(-_t(ti, T1) / T1))


def _common(*xs):
    r"""``(dtype, device)`` of a call: the promoted floating type of the
    tensors among ``xs`` (or of their numpy arrays), on the first
    tensor's device (the CPU when none is a tensor)."""
    dtype, device = None, None
    for x in xs:
        if isinstance(x, torch.Tensor):
            device = x.device if device is None else device
        elif isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        else:
            continue
        if x.is_floating_point():
            dtype = x.dtype if dtype is None else torch.promote_types(
                dtype, x.dtype)
    return (dtype or torch.get_default_dtype(),
            torch.device('cpu') if device is None else device)


def epg_spgr(flips, phis=None, *, T1, T2, tr, te=0.0, M0=1.0, zinit=None,
             b1=None, kshift: int = 1, D=None, dk=0.0, K=None, mesh=None,
             backend: str = 'auto'):
    r"""Gradient-spoiled GRE (SPGR / FISP) signal train, the MRF
    dictionary workhorse.

    Per TR ``n``: RF pulse (flip ``flips[n]`` about phase ``phis[n]``),
    signal read at TE (``F+(0)`` demodulated by the transmit phase, with
    ``exp(-te/T2)`` decay), relaxation over TR, then the spoiler gradient
    shifts ``kshift`` k-quanta. With quadratic ``phis``
    (:func:`rf_spoil_phases`) this is RF-spoiled SPGR; with ``phis=None``
    (zero phases) it is FISP.

    Inputs:
        - ``flips``: `(nTR,)` or `(*batch, nTR)`, "Rad".
        - ``phis``: `(nTR,)` or `(*batch, nTR)`, "Rad" (None → 0).
        - ``T1``/``T2``: `()` ⊻ `(*batch,)`, "Sec".
        - ``tr``/``te``: `()` or `(nTR,)`, "Sec" (variable-TR/TE trains).
        - ``M0``: `()` ⊻ `(*batch,)`; ``zinit``: `()` ⊻ `(*batch,)`
          initial longitudinal magnetization (None → ``M0``;
          :func:`ir_prep` gives the inversion-recovery value).
        - ``b1``: `()` ⊻ `(*batch,)` transmit scale of the flip train.
        - ``D``/``dk``: diffusion weighting by the spoiler
          (:func:`epg_diffusion` with ``δ=kshift`` per TR), "cm²/Sec"
          and "Rad/cm" per k-quantum.
        - ``K``: modeled configuration orders (default: the exact
          ``nTR·|kshift| + 1``).
        - ``mesh``: multi-device runs are not ported yet (raises
          :class:`NotImplementedError`).
        - ``backend``: ``'auto'`` | ``'torch'`` | ``'cuda'`` (module
          docstring).
    Outputs:
        - ``signals``: `(*batch, nTR, 2)` real ([re, im] of the demodulated
          echo).

    Differentiable w.r.t. ``flips``/``phis``/``T1``/``T2``/``tr``/``te``/
    ``M0``/``zinit``/``b1``/``D``/``dk`` on every route.
    """
    from mrphy_tpu_torch.ops.routing import route
    if mesh is not None:
        raise NotImplementedError('mesh= (multi-device runs) is not ported '
                                  'to mrphy_tpu_torch yet')
    if int(kshift) == 0:
        raise ValueError('kshift must be a nonzero integer')
    kw = dict(T1=T1, T2=T2, tr=tr, te=te, M0=M0, zinit=zinit, b1=b1,
              kshift=int(kshift), D=D, dk=dk, K=K)
    path = route('epg_spgr', backend=backend, flips=flips, phis=phis,
                 **kw)['path']
    if path.startswith('cuda'):
        device = _common(flips, phis, T1, T2, tr, te, M0, zinit, b1, D)[1]
        if backend == 'cuda' and device.type != 'cuda':
            raise ValueError("backend='cuda' needs CUDA tensors, got "
                             f'{device}')
        return _spgr_kernels(flips, phis, **kw)
    return _spgr_scan(flips, phis, **kw)


def _spgr_scan(flips, phis=None, *, T1, T2, tr, te=0.0, M0=1.0, zinit=None,
               b1=None, kshift=1, D=None, dk=0.0, K=None):
    r"""The plain route: JAX's ``lax.scan`` as a loop over TRs."""
    dtype, device = _common(flips, phis, T1, T2)

    def arr(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    flips = _apply_b1(arr(flips), b1)
    nTR = flips.shape[-1]
    phis = torch.zeros(nTR, dtype=dtype, device=device) if phis is None \
        else arr(phis)
    T1b, T2b = arr(T1), arr(T2)
    trs = torch.broadcast_to(arr(tr), (nTR,))
    tes = torch.broadcast_to(arr(te), (nTR,))
    M0 = arr(M0)
    z0 = M0 if zinit is None else arr(zinit)
    batch = torch.broadcast_shapes(flips.shape[:-1], phis.shape[:-1],
                                   T1b.shape, T2b.shape, M0.shape, z0.shape)
    K = nTR * abs(kshift) + 1 if K is None else int(K)
    s = epg_state(K, batch, M0=torch.broadcast_to(z0, batch), dtype=dtype,
                  device=device)
    flips_t = torch.broadcast_to(flips, batch + (nTR,)).movedim(-1, 0)
    phis_t = torch.broadcast_to(phis, batch + (nTR,)).movedim(-1, 0)
    sigs = []
    for n in range(nTR):
        phi = phis_t[n]
        s = epg_rf(s, flips_t[n], phi)
        # demodulate by the transmit phase: s·e^{−iφ}, with TE decay
        fr, fi = s[..., 0, 0, 0], s[..., 0, 0, 1]
        c, si = torch.cos(phi), torch.sin(phi)
        sigs.append(torch.exp(-tes[n] / T2b)[..., None] * torch.stack(
            [c * fr + si * fi, c * fi - si * fr], -1))
        s = epg_relax(s, trs[n], T1b, T2b, M0)
        if D is not None:
            s = epg_diffusion(s, arr(D), dk, trs[n], delta=kshift)
        s = epg_grad(s, kshift)
    return torch.stack(torch.broadcast_tensors(*sigs), dim=-2)


def _spgr_rows(flips, phis=None, *, T1, T2, tr, te=0.0, M0=1.0, zinit=None,
               b1=None, kshift=1, D=None, dk=0.0, K=None):
    r"""The kernels' arguments for :func:`epg_spgr`'s inputs
    (``_spgr_dispatch``, ``epg_pallas.py:219-273``): ``(coef, par, cdiff,
    cfg, batch)``, the per-TR coefficient rows and the per-atom rows built
    by torch ops (whose autograd carries the gradients of every input back
    from the rows'), the atoms' batch shape flattened into ``par``'s
    columns."""
    dtype, device = _common(flips, phis, T1, T2, tr, te, M0, zinit, b1, D)

    def arr(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    flips = arr(flips)
    if flips.ndim != 1:
        raise ValueError('the kernels take a shared (nTR,) flip train, got '
                         f'{tuple(flips.shape)}')
    nTR = flips.shape[0]
    phis = torch.zeros_like(flips) if phis is None else arr(phis)
    if phis.shape != flips.shape:
        raise ValueError(f'phis {tuple(phis.shape)} and flips '
                         f'{tuple(flips.shape)} differ')
    batch = torch.broadcast_shapes(*(_shape(x) for x in
                                     (T1, T2, M0, zinit, b1, D)
                                     if x is not None))
    nA = math.prod(batch)

    def atoms(x):
        return torch.broadcast_to(arr(x), batch).reshape(nA)

    K = nTR * abs(kshift) + 1 if K is None else int(K)
    vartr = _ndim(tr) == 1 or _ndim(te) == 1
    has_d = D is not None
    coef = torch.stack([torch.cos(flips / 2) ** 2, torch.sin(flips / 2) ** 2,
                        torch.sin(flips), torch.cos(flips),
                        torch.cos(phis), torch.sin(phis),
                        torch.cos(2 * phis), torch.sin(2 * phis), flips])
    T1a, T2a, M0a = atoms(T1), atoms(T2), atoms(M0)
    if vartr:
        # the factors are formed per TR in the kernels from the rates and
        # the tr/te rows; the (E1, E2, E2te, rec) slots carry (R1, R2, M0,
        # 0)
        trs = torch.broadcast_to(arr(tr), (nTR,))
        tes = torch.broadcast_to(arr(te), (nTR,))
        coef = torch.cat([coef, trs[None], tes[None]])
        rows = [1 / T1a, 1 / T2a, M0a, torch.zeros_like(M0a)]
    else:
        trv, tev = arr(tr), arr(te)
        rows = [torch.exp(-trv / T1a), torch.exp(-trv / T2a),
                torch.exp(-tev / T2a), -torch.expm1(-trv / T1a) * M0a]
    rows.append(M0a if zinit is None else atoms(zinit))
    rows.append(atoms(1.0 if b1 is None else b1))
    if has_d:
        # A(k) = exp(−dq·c(k)): dq is D·dk²·tr at constant TR, the rate
        # D·dk² under variable TR (the kernels multiply by each TR's tr)
        dq = atoms(D) * arr(dk) ** 2
        rows.append(dq if vartr else dq * arr(tr))
    else:
        rows.append(torch.zeros_like(M0a))
    cfg = kepg.SpgrCfg(K=K, kshift=kshift, has_b1=b1 is not None,
                       vartr=vartr, has_d=has_d)
    return (coef, torch.stack(rows), kepg.diff_coef(K, kshift, dtype, device),
            cfg, batch)


def _spgr_kernels(flips, phis=None, **kw):
    r"""The kernels' route: :func:`_spgr_rows`, then
    :func:`mrphy_tpu_torch.kernels.epg.spgr` (the kernels' plain versions
    on CPU tensors)."""
    coef, par, cdiff, cfg, batch = _spgr_rows(flips, phis, **kw)
    sig = kepg.spgr(coef, par, cdiff, cfg)    # (nA, nTR, 2)
    if len(batch) > 1:
        return sig.reshape(batch + sig.shape[1:])
    return _unbatch(sig, _scalar_batch(*(kw.get(n) for n in (
        'T1', 'T2', 'M0', 'zinit', 'b1', 'D'))))
