r"""Extended Phase Graphs (EPG): differentiable echo-train simulation
(counterpart of :mod:`mrphy_tpu.ops.epg`: its single-pool SPGR and CPMG
parts and the two-pool EPG-X SPGR and CPMG trains).

Magnetization is tracked in the Fourier domain of the dephasing angle as
configuration states ``F+(k), F−(k), Z(k)``; the state is a real ``(...,
3, K, 2)`` tensor (trailing axis [re, im]), as in the JAX package.
Conventions follow the EPG literature (Weigel's tutorial, Hargreaves'
reference implementation): the RF mixing matrix about phase ``phi``, the
gradient shift ``F+(k)→F+(k+1)``, ``F−(k)→F−(k−1)``, ``F+(0) =
conj(F−(0))`` after the shift.

:func:`epg_spgr`, the MRF dictionary's train, and :func:`epg_cpmg`, the
spin-echo train of T2 mapping, have two routes each
(:func:`mrphy_tpu_torch.ops.routing.route` says which a call takes):

- the plain route, a Python loop over TRs or echoes of the primitives
  below (JAX's ``lax.scan``), differentiable by torch autograd;
- the kernels of :mod:`mrphy_tpu_torch.kernels.epg` for a shared 1-D flip
  train: ``spgr_fwd`` (``cpmg_fwd``), or ``spgr_fwd_chk`` with the
  hand-written adjoint ``spgr_bwd`` (``cpmg_fwd_chk`` with ``cpmg_bwd``)
  when a gradient is needed.

``backend='auto'`` takes the kernels for CUDA tensors and the plain route
for CPU tensors; ``'cuda'`` insists on the kernels (and raises for CPU
tensors); ``'torch'`` runs the plain route on any device. Per-voxel 2-D
flip trains run the plain route under ``'auto'`` on any device, as JAX's
``'xla-fallback'`` does, and raise under ``'cuda'``. ``mesh=`` raises
(multi-device runs are not ported yet).

The two-pool exchange trains (EPG-X, Malik et al. MRM 80(2):767, 2018; the
"full Bloch–McConnell" variant: both pools carry F states, and every
interval applies the exact exchange-relaxation propagator of each order)
carry a ``(..., 2, 3, K, 2)`` state, the pool axis before the single-pool
layout. :func:`epgx_spgr`, the exchange-sensitive MRF dictionary's train,
has the same two routes; its kernels (:mod:`mrphy_tpu_torch.kernels.epgx`)
take a shared 1-D flip train: at a scalar ``tr`` ``xspgr_fwd``, or
``xspgr_fwd_chk`` with ``xspgr_bwd`` under a gradient; over a ``(nTR,)``
``tr`` train ``xspgr_v_fwd``, or ``xspgr_v_fwd_chk`` with ``xspgr_v_bwd``,
which read the exchange–relaxation propagator of every step from per-step
planes (:func:`_x_step_entries`). :func:`epgx_cpmg`, the two-pool CPMG
train of myelin-water mapping, has the same two routes; its kernels take a
shared 1-D flip train: at a scalar ``esp`` ``xcpmg_fwd``, or
``xcpmg_fwd_chk`` with ``xcpmg_bwd`` under a gradient; over a ``(nE,)``
``esp`` train ``xcpmg_v_fwd``, or ``xcpmg_v_fwd_chk`` with
``xcpmg_v_bwd``, which read each echo's propagator over its half interval
from per-echo planes. The MT variant is not ported yet.
"""

import math

import numpy as np
import torch
import torch.utils.checkpoint

from mrphy_tpu_torch.kernels import epg as kepg
from mrphy_tpu_torch.kernels import epgx as kepgx
from mrphy_tpu_torch.ops.slowsims import _expm2

__all__ = ['epg_state', 'epg_rf', 'epg_grad', 'epg_relax', 'epg_diffusion',
           'epg_cpmg', 'epg_spgr', 'ir_prep', 'rf_spoil_phases',
           'epgx_state', 'epgx_rf', 'epgx_relax', 'epgx_spgr', 'epgx_cpmg']


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


def _add_z0(Z, r):
    r"""``Z (..., K, 2)`` with ``r`` added to its order 0's real part."""
    z0 = torch.stack([Z[..., 0, 0] + r, Z[..., 0, 1]], -1)[..., None, :]
    return torch.cat([z0, Z[..., 1:, :]], dim=-2)


def epg_relax(FpFmZ, tau, T1, T2, M0=1.0):
    r"""Relaxation over ``tau`` seconds: ``F·E2``, ``Z·E1``, with
    ``(1−E1)·M0`` recovery into ``Z(0)``. ``T1``/``T2``/``M0`` broadcast
    against the batch axes (per-voxel maps)."""
    tau = _t(tau, FpFmZ)
    E1 = torch.exp(-tau / _t(T1, FpFmZ))[..., None, None]
    E2 = torch.exp(-tau / _t(T2, FpFmZ))[..., None, None]
    Fp = FpFmZ[..., 0, :, :] * E2
    Fm = FpFmZ[..., 1, :, :] * E2
    Z = _add_z0(FpFmZ[..., 2, :, :] * E1,
                (1 - E1[..., 0, 0]) * _t(M0, FpFmZ))
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


def epg_cpmg(flips, *, T1, T2, esp, M0=1.0, phi_ex=math.pi / 2,
             alpha_ex=math.pi / 2, b1=None, mesh=None, D=None, dk=0.0,
             backend: str = 'auto'):
    r"""Echo amplitudes of a CPMG spin-echo train.

    Sequence: ``alpha_ex`` excitation about ``phi_ex`` (defaults 90° about
    +y, so the refocusing pulses about +x satisfy the CPMG condition), then
    for each entry of ``flips``: [τ = esp/2 relax + dephase, refocusing
    pulse, τ = esp/2 relax + dephase, echo].

    Inputs:
        - ``flips``: `(nEcho,)` or `(*batch, nEcho)`, "Rad", refocusing
          flip angles.
        - ``T1``/``T2``: `()` ⊻ `(*batch,)`, "Sec"; ``esp``: echo spacing,
          "Sec", a scalar or a `(nEcho,)` per-echo train.
        - ``M0``: `()` ⊻ `(*batch,)`; ``alpha_ex``/``phi_ex``: `()` ⊻
          `(*batch,)`, "Rad", the excitation (per voxel: slice-profile-
          resolved trains).
        - ``b1``: `()` ⊻ `(*batch,)` transmit scale of the refocusing train.
        - ``D``/``dk``: diffusion weighting (:func:`epg_diffusion`, one
          unit shift per half): diffusivity `()` ⊻ `(*batch,)`, "cm²/Sec",
          and the per-half-esp crusher dephasing, "Rad/cm".
        - ``mesh``: multi-device runs are not ported yet (raises
          :class:`NotImplementedError`).
        - ``backend``: ``'auto'`` | ``'torch'`` | ``'cuda'`` (module
          docstring).
    Outputs:
        - ``echoes``: `(*batch, nEcho, 2)` real ([re, im] of ``F+(0)`` at
          each echo; for perfect 180° refocusing the magnitude is
          ``exp(−(n+1)·esp/T2)·M0`` exactly).

    Differentiable w.r.t. ``flips``/``T1``/``T2``/``esp``/``M0``/
    ``alpha_ex``/``phi_ex``/``b1``/``D``/``dk`` on every route.
    """
    from mrphy_tpu_torch.ops.routing import route
    if mesh is not None:
        raise NotImplementedError('mesh= (multi-device runs) is not ported '
                                  'to mrphy_tpu_torch yet')
    kw = dict(T1=T1, T2=T2, esp=esp, M0=M0, phi_ex=phi_ex,
              alpha_ex=alpha_ex, b1=b1, D=D, dk=dk)
    path = route('epg_cpmg', backend=backend, flips=flips, **kw)['path']
    if path.startswith('cuda'):
        device = _common(flips, T1, T2, esp, M0, phi_ex, alpha_ex, b1,
                         D)[1]
        if backend == 'cuda' and device.type != 'cuda':
            raise ValueError("backend='cuda' needs CUDA tensors, got "
                             f'{device}')
        return _cpmg_kernels(flips, **kw)
    return _cpmg_scan(flips, **kw)


def _cpmg_scan(flips, *, T1, T2, esp, M0=1.0, phi_ex=math.pi / 2,
               alpha_ex=math.pi / 2, b1=None, D=None, dk=0.0):
    r"""The plain route: JAX's ``_epg_cpmg_body`` (a ``lax.scan``) as a loop
    over echoes."""
    dtype, device = _common(flips, T1, T2)

    def arr(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    flips = _apply_b1(arr(flips), b1)
    nE = flips.shape[-1]
    T1b, T2b, M0, alpha = arr(T1), arr(T2), arr(M0), arr(alpha_ex)
    esp = arr(esp)
    batch = torch.broadcast_shapes(flips.shape[:-1], T1b.shape, T2b.shape,
                                   M0.shape, alpha.shape)
    s = epg_state(nE + 1, batch, M0=torch.broadcast_to(M0, batch),
                  dtype=dtype, device=device)
    s = epg_rf(s, torch.broadcast_to(alpha, batch), arr(phi_ex))
    flips_t = torch.broadcast_to(flips, batch + (nE,)).movedim(-1, 0)
    Db = None if D is None else arr(D)

    def half(s, espn):
        s = epg_relax(s, espn / 2, T1b, T2b, M0)
        if Db is not None:
            s = epg_diffusion(s, Db, dk, espn / 2, delta=1)
        return epg_grad(s)

    echoes = []
    for n in range(nE):
        espn = esp[n] if esp.ndim == 1 else esp
        s = half(epg_rf(half(s, espn), flips_t[n], 0.0), espn)
        echoes.append(s[..., 0, 0, :])
    return torch.stack(echoes, dim=-2)                # (*batch, nE, 2)


def _cpmg_rows(flips, *, T1, T2, esp, M0=1.0, phi_ex=math.pi / 2,
               alpha_ex=math.pi / 2, b1=None, D=None, dk=0.0):
    r"""The kernels' arguments for :func:`epg_cpmg`'s inputs
    (``_cpmg_dispatch``, ``epg_pallas.py:362-411``): ``(coef, par, dq,
    cdiff, cfg, batch)``, the per-echo rows ``[cos²(α/2), sin²(α/2), sin
    α, cos α, α]`` (+ the esp train), the per-atom rows ``[E1h, E2h,
    rech, e_ss, e_sc, e_ca, b1]`` (``[R1, R2, M0, …]`` under an esp train)
    and the diffusion row, built by torch ops (whose autograd carries the
    gradients of every input back from the rows'), in the call's dtype,
    the atoms' batch shape flattened into the columns."""
    dtype, device = _common(flips, T1, T2, esp, M0, phi_ex, alpha_ex, b1, D)

    def arr(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    flips = arr(flips)
    if flips.ndim != 1:
        raise ValueError('the kernels take a shared (nEcho,) flip train, got '
                         f'{tuple(flips.shape)}')
    nE = flips.shape[0]
    batch = torch.broadcast_shapes(*(_shape(x) for x in
                                     (T1, T2, M0, alpha_ex, phi_ex, b1, D)
                                     if x is not None))
    nA = math.prod(batch)

    def atoms(x):
        return torch.broadcast_to(arr(x), batch).reshape(nA)

    esp = arr(esp)
    varesp = esp.ndim == 1
    if varesp and esp.shape != (nE,):
        raise ValueError(f'esp {tuple(esp.shape)} is not a ({nE},) train')
    coef = torch.stack([torch.cos(flips / 2) ** 2, torch.sin(flips / 2) ** 2,
                        torch.sin(flips), torch.cos(flips), flips])
    T1a, T2a, M0a = atoms(T1), atoms(T2), atoms(M0)
    if varesp:
        # the factors are formed per echo in the kernels from the rates
        # and the esp row; the (E1h, E2h, rech) slots carry (R1, R2, M0)
        coef = torch.cat([coef, esp[None]])
        rows = [1 / T1a, 1 / T2a, M0a]
    else:
        rows = [torch.exp(-esp / 2 / T1a), torch.exp(-esp / 2 / T2a),
                -torch.expm1(-esp / 2 / T1a) * M0a]
    al, ph = atoms(alpha_ex), atoms(phi_ex)
    rows += [torch.sin(al) * torch.sin(ph) * M0a,
             torch.sin(al) * torch.cos(ph) * M0a, torch.cos(al) * M0a,
             atoms(1.0 if b1 is None else b1)]
    if D is not None:
        # A(k) = exp(−dq·c(k)): dq is D·dk²·esp/2 at constant spacing, the
        # rate D·dk² under an esp train (the kernels take each echo's esp/2)
        dq = atoms(D) * arr(dk) ** 2
        dq = dq if varesp else dq * (esp / 2)
    else:
        dq = torch.zeros_like(M0a)
    cfg = kepg.CpmgCfg(nE=nE, has_b1=b1 is not None, varesp=varesp,
                       has_d=D is not None)
    return (coef, torch.stack(rows), dq[None],
            kepg.diff_coef(cfg.K, 1, dtype, device), cfg, batch)


def _cpmg_kernels(flips, **kw):
    r"""The kernels' route: :func:`_cpmg_rows`, then
    :func:`mrphy_tpu_torch.kernels.epg.cpmg` (the kernels' plain versions
    on CPU tensors)."""
    coef, par, dq, cdiff, cfg, batch = _cpmg_rows(flips, **kw)
    er, ei = kepg.cpmg(coef, par, dq, cdiff, cfg)     # (nE, nA) each
    return torch.stack([er.T, ei.T], -1).reshape(batch + (cfg.nE, 2))


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


# ==========================================================================
# EPG-X: two-pool exchange (Bloch–McConnell) extended phase graphs
# ==========================================================================

def _hypot(x, y):
    r"""``sqrt(x² + y²)`` as ``max·sqrt(1 + (min/max)²)``, JAX's
    ``jnp.hypot``: its gradient stays finite at ``x = y = 0``, where
    ``torch.hypot``'s is NaN."""
    ax, ay = x.abs(), y.abs()
    hi, lo = torch.maximum(ax, ay), torch.minimum(ax, ay)
    zero = hi == 0
    return torch.where(zero, hi, hi * torch.sqrt(
        1 + (lo / torch.where(zero, torch.ones_like(hi), hi)) ** 2))


def _csqrt(x, y):
    r"""Principal square root of ``x + iy`` in re/im pairs, differentiable
    on the real axis: the naive ``v = sqrt((r − x)/2)`` has an infinite
    derivative at ``y = 0, x > 0``; the smaller component comes instead from
    the identity ``u·v = y/2`` against the larger one. Every ``where``
    makes its untaken branch's argument safe first, so that no NaN reaches
    the gradient."""
    r = _hypot(x, y)
    big = x >= 0
    a = torch.clamp_min(torch.where(big, r + x, r - x) / 2, 0.0)
    pos = a > 0
    one = torch.ones_like(a)
    s = torch.where(pos, torch.sqrt(torch.where(pos, a, one)), 0.0)
    inv2s = torch.where(pos, 0.5 / torch.where(pos, s, one), 0.0)
    sgn = torch.where(y < 0, -1.0, 1.0)
    u = torch.where(big, s, y.abs() * inv2s)
    v = torch.where(big, y * inv2s, sgn * s)
    return u, v


def _expm2c(ar, ai, b, c, dr, di):
    r"""``expm([[a, b], [c, d]])`` with complex diagonal (``a``, ``d``) and
    real off-diagonals, in re/im pairs: ``e^μ (cosh(q) I + sinh(q)/q (A −
    μI))`` with complex ``μ = (a + d)/2``, ``q = sqrt(((a − d)/2)² + bc)``
    (:func:`mrphy_tpu_torch.ops.slowsims._expm2`'s identity); near ``q =
    0`` the Taylor ``sinh(q)/q = 1 + q²/6``. Returns the four entries
    ``(E00, E01, E10, E11)``, each an ``(re, im)`` pair."""
    mur, mui = (ar + dr) / 2, (ai + di) / 2
    hr, hi = (ar - dr) / 2, (ai - di) / 2
    q2r = hr * hr - hi * hi + b * c
    q2i = 2 * hr * hi
    qr, qi = _csqrt(q2r, q2i)
    chr_, chi = torch.cosh(qr) * torch.cos(qi), torch.sinh(qr) * torch.sin(qi)
    shr, shi = torch.sinh(qr) * torch.cos(qi), torch.cosh(qr) * torch.sin(qi)
    # sinh(q)/q, the Taylor branch at small |q|
    qn2 = qr * qr + qi * qi
    safe = qn2 > 1e-12
    qn2s = torch.where(safe, qn2, torch.ones_like(qn2))
    sqr = torch.where(safe, (shr * qr + shi * qi) / qn2s, 1.0 + q2r / 6)
    sqi = torch.where(safe, (shi * qr - shr * qi) / qn2s, q2i / 6)
    em = torch.exp(mur)
    emr, emi = em * torch.cos(mui), em * torch.sin(mui)

    def cm(xr, xi, yr, yi):
        return xr * yr - xi * yi, xr * yi + xi * yr

    e00 = cm(*cm(sqr, sqi, hr, hi), emr, emi)
    ch = cm(chr_, chi, emr, emi)
    sb = cm(sqr, sqi, emr, emi)
    return ((ch[0] + e00[0], ch[1] + e00[1]), (b * sb[0], b * sb[1]),
            (c * sb[0], c * sb[1]), (ch[0] - e00[0], ch[1] - e00[1]))


def _z_recovery(Z00, Z01, Z10, Z11, T1a, T1b, kab, kba, M0a, M0b):
    r"""Exact affine recovery of the coupled longitudinal system over one
    interval: ``rec = A⁻¹(E − I)·b``, ``A`` the rate matrix and ``b =
    [M0a/T1a, M0b/T1b]`` the source (the closed form of
    :func:`mrphy_tpu_torch.ops.slowsims.mc_propagators`). It equals ``(I −
    E)[M0a, M0b]`` only under detailed balance (``kab·M0a = kba·M0b``)."""
    a00, a01 = -1 / T1a - kab, kba
    a10, a11 = kab, -1 / T1b - kba
    det = a00 * a11 - a01 * a10
    ba, bb = M0a / T1a, M0b / T1b
    e00, e01, e10, e11 = Z00 - 1.0, Z01, Z10, Z11 - 1.0
    ra = (a11 * (e00 * ba + e01 * bb) - a01 * (e10 * ba + e11 * bb)) / det
    rb = (-a10 * (e00 * ba + e01 * bb) + a00 * (e10 * ba + e11 * bb)) / det
    return ra, rb


def epgx_state(K: int, batch=(), M0a=1.0, M0b=0.1, dtype=torch.float32,
               device=None):
    r"""Equilibrium two-pool EPG-X state: `(*batch, 2, 3, K, 2)` real (the
    pool axis before the single-pool `(3, K, [re, im])` layout), with
    ``Za(0) = M0a``, ``Zb(0) = M0b``."""
    s = torch.zeros(tuple(batch) + (2, 3, K, 2), dtype=dtype, device=device)
    s[..., 0, 2, 0, 0] = torch.broadcast_to(_t(M0a, s), tuple(batch))
    s[..., 1, 2, 0, 0] = torch.broadcast_to(_t(M0b, s), tuple(batch))
    return s


def epgx_rf(s, alpha, phi=0.0, b1b=1.0):
    r"""Ideal RF on both pools (flip ``alpha`` about ``phi``, rad); ``b1b``
    scales pool b's flip (1.0 for water–water exchange). ``alpha``/``phi``
    broadcast against the batch axes."""
    alpha = _t(alpha, s)
    phi = torch.broadcast_to(_t(phi, s), alpha.shape)
    return epg_rf(s, torch.stack([alpha, b1b * alpha], -1),
                  torch.stack([phi, phi], -1))


def epgx_relax(s, tau, *, T1a, T2a, T1b, T2b, kab, kba, M0a=1.0, M0b=0.1,
               dfb=0.0):
    r"""Exact relaxation–exchange(–shift) propagation of every order over
    ``tau`` seconds.

    Transverse: ``d/dt [Fa, Fb] = [[−R2a − kab, kba], [kab, −R2b − kba −
    i·2π·dfb]] [Fa, Fb]``, one complex 2×2 expm (``F−`` takes its
    conjugate). Longitudinal: the real 2×2 expm plus the exact affine
    recovery into ``Z(0)`` (:func:`_z_recovery`). All parameters broadcast
    against the batch axes (per-voxel maps)."""
    batch = s.shape[:-4]
    (tau, T1a, T2a, T1b, T2b, kab, kba, M0a, M0b, dfb) = (
        torch.broadcast_to(_t(x, s), batch) for x in
        (tau, T1a, T2a, T1b, T2b, kab, kba, M0a, M0b, dfb))
    w = 2 * math.pi * dfb
    E00, E01, E10, E11 = _expm2c(
        (-1 / T2a - kab) * tau, torch.zeros_like(tau), kba * tau, kab * tau,
        (-1 / T2b - kba) * tau, -w * tau)

    def capply(E, xr, xi):
        return E[0] * xr - E[1] * xi, E[0] * xi + E[1] * xr

    def tprop(Far, Fai, Fbr, Fbi, conj):
        sg = -1.0 if conj else 1.0

        def cc(E):
            return E[0][..., None], sg * E[1][..., None]

        ar, ai = capply(cc(E00), Far, Fai)
        br, bi = capply(cc(E01), Fbr, Fbi)
        cr, ci = capply(cc(E10), Far, Fai)
        dr, di = capply(cc(E11), Fbr, Fbi)
        return ar + br, ai + bi, cr + dr, ci + di

    Fa, Fb = s[..., 0, :, :, :], s[..., 1, :, :, :]
    pa_r, pa_i, pb_r, pb_i = tprop(Fa[..., 0, :, 0], Fa[..., 0, :, 1],
                                   Fb[..., 0, :, 0], Fb[..., 0, :, 1], False)
    ma_r, ma_i, mb_r, mb_i = tprop(Fa[..., 1, :, 0], Fa[..., 1, :, 1],
                                   Fb[..., 1, :, 0], Fb[..., 1, :, 1], True)
    Z00, Z01, Z10, Z11 = _expm2((-1 / T1a - kab) * tau, kba * tau,
                                kab * tau, (-1 / T1b - kba) * tau)
    Za, Zb = Fa[..., 2, :, :], Fb[..., 2, :, :]
    Za1 = Z00[..., None, None] * Za + Z01[..., None, None] * Zb
    Zb1 = Z10[..., None, None] * Za + Z11[..., None, None] * Zb
    ra, rb = _z_recovery(Z00, Z01, Z10, Z11, T1a, T1b, kab, kba, M0a, M0b)
    Za1, Zb1 = _add_z0(Za1, ra), _add_z0(Zb1, rb)
    pool_a = torch.stack([torch.stack([pa_r, pa_i], -1),
                          torch.stack([ma_r, ma_i], -1), Za1], dim=-3)
    pool_b = torch.stack([torch.stack([pb_r, pb_i], -1),
                          torch.stack([mb_r, mb_i], -1), Zb1], dim=-3)
    return torch.stack([pool_a, pool_b], dim=-4)


_XKEYS = ('T1a', 'T2a', 'T1b', 'T2b', 'kab', 'kba', 'M0a', 'M0b', 'dfb',
          'b1')


def _x_entries(T1a, T2a, T1b, T2b, kab, kba, M0a, M0b, dfb, tau):
    r"""The 14 entries ``[E00r, E00i, E01r, E01i, E10r, E10i, E11r, E11i,
    Z00, Z01, Z10, Z11, ra, rb]`` of the exchange–relaxation propagator
    over ``tau`` (:func:`epgx_relax`'s closed forms: :func:`_expm2c`,
    :func:`~mrphy_tpu_torch.ops.slowsims._expm2`, :func:`_z_recovery`),
    each of the broadcast shape of ``tau`` and the rates."""
    w = 2 * math.pi * dfb
    E00, E01, E10, E11 = _expm2c(
        (-1 / T2a - kab) * tau, torch.zeros_like(T2a * tau), kba * tau,
        kab * tau, (-1 / T2b - kba) * tau, -w * tau)
    Z00, Z01, Z10, Z11 = _expm2((-1 / T1a - kab) * tau, kba * tau, kab * tau,
                                (-1 / T1b - kba) * tau)
    ra, rb = _z_recovery(Z00, Z01, Z10, Z11, T1a, T1b, kab, kba, M0a, M0b)
    return [*E00, *E01, *E10, *E11, Z00, Z01, Z10, Z11, ra, rb]


def _x_step_entries(T1a, T2a, T1b, T2b, kab, kba, M0a, M0b, dfb, trs):
    r"""The per-step propagator planes ``pkt (nTR, 14, nA)`` of a
    variable-TR train ``trs (nTR,)`` for the atoms' rates `(nA,)`
    (``_x_step_entries``, ``epg_pallas.py:2608-2632``): :func:`_x_entries`
    with ``trs[:, None]`` broadcast against the rates, no loop over the
    steps."""
    return torch.stack(_x_entries(T1a, T2a, T1b, T2b, kab, kba, M0a, M0b,
                                  dfb, trs[:, None]), dim=1)


def epgx_spgr(flips, phis=None, *, T1a, T2a, T1b, T2b, kab, kba, tr,
              M0a=1.0, M0b=0.1, dfb=0.0, b1=None, kshift: int = 1, K=None,
              mesh=None, backend: str = 'auto'):
    r"""Gradient-spoiled GRE train of a two-pool exchanging system: the
    EPG-X dictionary of exchange-sensitive MRF.

    Per TR: the RF pulse on both pools, the demodulated total ``F+(0)``
    (``Fa+(0) + Fb+(0)``) read out, the exact exchange–relaxation over TR
    (:func:`epgx_relax`), the spoiler's shift of ``kshift`` k-quanta. See
    :func:`epg_spgr` for the single-pool conventions.

    Inputs:
        - ``flips``: `(nTR,)` or `(*batch, nTR)`, "Rad"; ``phis``: the same,
          or None (zero phases).
        - ``T1a``/``T2a``/``T1b``/``T2b``: `()` ⊻ `(*batch,)`, "Sec";
          ``kab``/``kba``: exchange rates, "1/Sec"; ``M0a``/``M0b``: the
          pools' equilibrium magnetizations; ``dfb``: pool b's frequency
          offset, "Hz".
        - ``tr``: `()` or a `(nTR,)` train, "Sec".
        - ``b1``: `()` ⊻ `(*batch,)` transmit scale of the flip train (both
          pools).
        - ``K``: modelled orders (default: the exact ``nTR·|kshift| +
          1``).
        - ``mesh``: multi-device runs are not ported yet (raises
          :class:`NotImplementedError`).
        - ``backend``: ``'auto'`` | ``'torch'`` | ``'cuda'`` (module
          docstring).
    Outputs:
        - ``signals``: `(*batch, nTR, 2)` real.

    Differentiable w.r.t. ``flips``/``phis``/``T1a``/``T2a``/``T1b``/
    ``T2b``/``kab``/``kba``/``tr``/``M0a``/``M0b``/``dfb``/``b1`` on every
    route.
    """
    from mrphy_tpu_torch.ops.routing import route
    if mesh is not None:
        raise NotImplementedError('mesh= (multi-device runs) is not ported '
                                  'to mrphy_tpu_torch yet')
    if int(kshift) == 0:
        raise ValueError('kshift must be a nonzero integer')
    kw = dict(T1a=T1a, T2a=T2a, T1b=T1b, T2b=T2b, kab=kab, kba=kba, tr=tr,
              M0a=M0a, M0b=M0b, dfb=dfb, b1=b1, kshift=int(kshift), K=K)
    path = route('epgx_spgr', backend=backend, flips=flips, phis=phis,
                 **kw)['path']
    if path.startswith('cuda'):
        device = _common(flips, phis, tr, *(kw[n] for n in _XKEYS))[1]
        if backend == 'cuda' and device.type != 'cuda':
            raise ValueError("backend='cuda' needs CUDA tensors, got "
                             f'{device}')
        return _xspgr_kernels(flips, phis, **kw)
    return _xspgr_scan(flips, phis, **kw)


def _xspgr_scan(flips, phis=None, *, T1a, T2a, T1b, T2b, kab, kba, tr,
                M0a=1.0, M0b=0.1, dfb=0.0, b1=None, kshift=1, K=None):
    r"""The plain route: JAX's ``lax.scan`` as a loop over TRs."""
    kw = dict(T1a=T1a, T2a=T2a, T1b=T1b, T2b=T2b, kab=kab, kba=kba,
              M0a=M0a, M0b=M0b, dfb=dfb)
    dtype = _common(flips, phis, T2a)[0]
    device = _common(flips, phis, tr, b1, *kw.values())[1]

    def arr(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    flips = _apply_b1(arr(flips), b1)
    nTR = flips.shape[-1]
    phis = torch.zeros(nTR, dtype=dtype, device=device) if phis is None \
        else arr(phis)
    batch = torch.broadcast_shapes(flips.shape[:-1], phis.shape[:-1],
                                   *(_shape(v) for v in kw.values()))
    K = nTR * abs(kshift) + 1 if K is None else int(K)
    s = epgx_state(K, batch, M0a=M0a, M0b=M0b, dtype=dtype, device=device)
    flips_t = torch.broadcast_to(flips, batch + (nTR,)).movedim(-1, 0)
    phis_t = torch.broadcast_to(phis, batch + (nTR,)).movedim(-1, 0)
    trs = torch.broadcast_to(arr(tr), (nTR,))
    sigs = []
    for n in range(nTR):
        phi = phis_t[n]
        s = epgx_rf(s, flips_t[n], phi)
        fr = s[..., 0, 0, 0].sum(-1)                 # total F+(0)
        fi = s[..., 0, 0, 1].sum(-1)
        c, si = torch.cos(phi), torch.sin(phi)
        sigs.append(torch.stack([c * fr + si * fi, c * fi - si * fr], -1))
        s = epg_grad(epgx_relax(s, trs[n], **kw), kshift)
    return torch.stack(sigs, dim=-2)


def _xspgr_rows(flips, phis=None, *, T1a, T2a, T1b, T2b, kab, kba, tr,
                M0a=1.0, M0b=0.1, dfb=0.0, b1=None, kshift=1, K=None):
    r"""The kernels' arguments for :func:`epgx_spgr`'s inputs: ``(coef,
    par, cfg, batch)``, SPGR's nine per-TR rows, the per-atom rows and the
    atoms' batch shape, flattened into the columns.

    At a scalar ``tr`` (``_epgx_dispatch``, ``epg_pallas.py:584-621``)
    ``par (17, nA)`` is ``[E00r, E00i, E01r, E01i, E10r, E10i, E11r, E11i,
    Z00, Z01, Z10, Z11, ra, rb, M0a, M0b, b1]``, the exchange–relaxation
    propagator over ``tr`` (:func:`_x_entries`) and the rest. Over a
    ``(nTR,)`` ``tr`` train (``_epgx_v_dispatch``,
    ``epg_pallas.py:2972-2995``) ``par`` is the pair ``(pk (3, nA) = [M0a,
    M0b, b1], pkt (nTR, 14, nA))``, the propagator over every step
    (:func:`_x_step_entries`), its construction under
    :func:`torch.utils.checkpoint.checkpoint` so that autograd keeps none
    of its intermediates (it builds them again for the backward). Torch
    autograd of the construction carries the gradients of every input,
    each element of ``tr`` among them, back from the rows'."""
    kw = dict(T1a=T1a, T2a=T2a, T1b=T1b, T2b=T2b, kab=kab, kba=kba, M0a=M0a,
              M0b=M0b, dfb=dfb, b1=b1)
    dtype, device = _common(flips, phis, tr, *kw.values())

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
    tr = arr(tr)
    if tr.ndim != 0 and tuple(tr.shape) != (nTR,):
        raise ValueError(f'tr must be a scalar or a ({nTR},) train, got '
                         f'{tuple(tr.shape)}')
    batch = torch.broadcast_shapes(*(_shape(x) for x in kw.values()
                                     if x is not None))
    nA = math.prod(batch)
    rates = [torch.broadcast_to(arr(1.0 if x is None else x),
                                batch).reshape(nA) for x in kw.values()]
    coef = torch.stack([torch.cos(flips / 2) ** 2, torch.sin(flips / 2) ** 2,
                        torch.sin(flips), torch.cos(flips),
                        torch.cos(phis), torch.sin(phis),
                        torch.cos(2 * phis), torch.sin(2 * phis), flips])
    M0a, M0b, b1v = rates[6], rates[7], rates[9]
    if tr.ndim == 0:
        par = torch.stack(_x_entries(*rates[:9], tr) + [M0a, M0b, b1v])
    else:
        pkt = torch.utils.checkpoint.checkpoint(
            _x_step_entries, *rates[:9], tr, use_reentrant=False)
        par = (torch.stack([M0a, M0b, b1v]), pkt)
    K = nTR * abs(kshift) + 1 if K is None else int(K)
    cfg = kepgx.XspgrCfg(K=K, kshift=kshift, has_b1=b1 is not None)
    return coef, par, cfg, batch


def _xspgr_kernels(flips, phis=None, **kw):
    r"""The kernels' route: :func:`_xspgr_rows`, then
    :func:`mrphy_tpu_torch.kernels.epgx.xspgr` at a scalar ``tr`` or
    :func:`~mrphy_tpu_torch.kernels.epgx.xspgr_v` over a ``(nTR,)`` train
    (the kernels' plain versions on CPU tensors)."""
    coef, par, cfg, batch = _xspgr_rows(flips, phis, **kw)
    if isinstance(par, tuple):
        sig = kepgx.xspgr_v(coef, *par, cfg)       # (nA, nTR, 2)
    else:
        sig = kepgx.xspgr(coef, par, cfg)
    if len(batch) > 1:
        return sig.reshape(batch + sig.shape[1:])
    return _unbatch(sig, _scalar_batch(*(kw.get(n) for n in _XKEYS)))


def epgx_cpmg(flips, *, T1a, T2a, T1b, T2b, kab, kba, esp, M0a=1.0,
              M0b=0.1, dfb=0.0, phi_ex=math.pi / 2, b1=None, mesh=None,
              backend: str = 'auto'):
    r"""CPMG echo train of a two-pool exchanging system (myelin-water
    fraction, exchange-sensitive T2 mapping).

    The sequence of :func:`epg_cpmg` (a π/2 excitation about ``phi_ex``,
    then per refocusing flip: esp/2 of exchange–relaxation and a unit
    shift, the refocusing about +x on both pools, the same half again),
    every half-interval one exact :func:`epgx_relax`. The receiver sees the
    total transverse magnetization, so each echo is ``Fa+(0) + Fb+(0)``,
    not demodulated.

    Inputs:
        - ``flips``: `(nEcho,)` or `(*batch, nEcho)`, "Rad", refocusing
          flips.
        - ``T1a``/``T2a``/``T1b``/``T2b``: `()` ⊻ `(*batch,)`, "Sec";
          ``kab``/``kba``: exchange rates, "1/Sec"; ``M0a``/``M0b``: the
          pools' equilibrium magnetizations; ``dfb``: pool b's frequency
          offset, "Hz"; ``phi_ex``: the excitation's phase, "Rad".
        - ``esp``: echo spacing, "Sec", a scalar or a `(nEcho,)` train.
        - ``b1``: `()` ⊻ `(*batch,)` transmit scale of the refocusing
          train (both pools).
        - ``mesh``: multi-device runs are not ported yet (raises
          :class:`NotImplementedError`).
        - ``backend``: ``'auto'`` | ``'torch'`` | ``'cuda'`` (module
          docstring).
    Outputs:
        - ``echoes``: `(*batch, nEcho, 2)` real ([re, im]).

    Differentiable w.r.t. ``flips``/``T1a``/``T2a``/``T1b``/``T2b``/
    ``kab``/``kba``/``esp``/``M0a``/``M0b``/``dfb``/``phi_ex``/``b1`` on
    every route.
    """
    from mrphy_tpu_torch.ops.routing import route
    if mesh is not None:
        raise NotImplementedError('mesh= (multi-device runs) is not ported '
                                  'to mrphy_tpu_torch yet')
    kw = dict(T1a=T1a, T2a=T2a, T1b=T1b, T2b=T2b, kab=kab, kba=kba, esp=esp,
              M0a=M0a, M0b=M0b, dfb=dfb, phi_ex=phi_ex, b1=b1)
    path = route('epgx_cpmg', backend=backend, flips=flips, **kw)['path']
    if path.startswith('cuda'):
        device = _common(flips, *kw.values())[1]
        if backend == 'cuda' and device.type != 'cuda':
            raise ValueError("backend='cuda' needs CUDA tensors, got "
                             f'{device}')
        return _xcpmg_kernels(flips, **kw)
    return _xcpmg_scan(flips, **kw)


def _xcpmg_scan(flips, *, T1a, T2a, T1b, T2b, kab, kba, esp, M0a=1.0,
                M0b=0.1, dfb=0.0, phi_ex=math.pi / 2, b1=None):
    r"""The plain route: JAX's XLA scan (``epg.py:767-789``) as a loop over
    echoes; a scalar or ``(nE,)`` ``esp``, per-voxel 2-D flips and batched
    maps."""
    kw = dict(T1a=T1a, T2a=T2a, T1b=T1b, T2b=T2b, kab=kab, kba=kba,
              M0a=M0a, M0b=M0b, dfb=dfb)
    dtype = _common(flips, T2a)[0]
    device = _common(flips, esp, phi_ex, b1, *kw.values())[1]

    def arr(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    flips = _apply_b1(arr(flips), b1)
    nE = flips.shape[-1]
    phi_ex = arr(phi_ex)
    batch = torch.broadcast_shapes(flips.shape[:-1], phi_ex.shape,
                                   *(_shape(v) for v in kw.values()))
    s = epgx_state(nE + 1, batch, M0a=M0a, M0b=M0b, dtype=dtype,
                   device=device)
    s = epgx_rf(s, math.pi / 2 * torch.ones(batch, dtype=dtype,
                                            device=device), phi_ex)
    flips_t = torch.broadcast_to(flips, batch + (nE,)).movedim(-1, 0)
    esp = arr(esp)

    def half(s, espn):
        return epg_grad(epgx_relax(s, espn / 2, **kw))

    echoes = []
    for n in range(nE):
        espn = esp[n] if esp.ndim == 1 else esp
        s = half(epgx_rf(half(s, espn), flips_t[n], 0.0), espn)
        echoes.append(s[..., 0, 0, :].sum(-2))       # Fa+(0) + Fb+(0)
    return torch.stack(echoes, dim=-2)                # (*batch, nE, 2)


def _xcpmg_rows(flips, *, T1a, T2a, T1b, T2b, kab, kba, esp, M0a=1.0,
                M0b=0.1, dfb=0.0, phi_ex=math.pi / 2, b1=None):
    r"""The kernels' arguments for :func:`epgx_cpmg`'s inputs: ``(coef,
    pk, cfg, batch)``, the per-echo rows ``[cos²(α/2), sin²(α/2), sin α,
    cos α, α]``, the per-atom rows and the atoms' batch shape, flattened
    into the columns, in the call's dtype.

    At a scalar ``esp`` (``_xcpmg_dispatch``, ``epg_pallas.py:781-819``)
    ``pk (19, nA)`` is ``[E00r, E00i, E01r, E01i, E10r, E10i, E11r, E11i,
    Z00, Z01, Z10, Z11, ra, rb, cos φ_ex, sin φ_ex, M0a, M0b, b1]``, the
    exchange–relaxation propagator over esp/2 (:func:`_x_entries`) and the
    rest. Over a ``(nE,)`` ``esp`` train (``_xcpmg_v_dispatch``,
    ``epg_pallas.py:3652-3674``) ``pk`` is the pair ``(pk (5, nA) = [cos
    φ_ex, sin φ_ex, M0a, M0b, b1], pkt (nE, 14, nA))``, the propagator over
    each echo's half interval ``esp[t]/2`` (:func:`_x_step_entries`), its
    construction under :func:`torch.utils.checkpoint.checkpoint` so that
    autograd keeps none of its intermediates. Torch autograd of the
    construction carries the gradients of every input (the rates, ``esp``
    and every element of a train, ``M0a``/``M0b`` through the initial state
    and the recovery ``ra``/``rb``, ``dfb``, ``phi_ex``, ``b1``) back from
    the rows'."""
    kw = dict(T1a=T1a, T2a=T2a, T1b=T1b, T2b=T2b, kab=kab, kba=kba, M0a=M0a,
              M0b=M0b, dfb=dfb, phi_ex=phi_ex, b1=b1)
    dtype, device = _common(flips, esp, *kw.values())

    def arr(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    flips = arr(flips)
    if flips.ndim != 1:
        raise ValueError('the kernels take a shared (nEcho,) flip train, got '
                         f'{tuple(flips.shape)}')
    nE = flips.shape[0]
    esp = arr(esp)
    if esp.ndim != 0 and tuple(esp.shape) != (nE,):
        raise ValueError(f'esp must be a scalar or a ({nE},) train, got '
                         f'{tuple(esp.shape)}')
    batch = torch.broadcast_shapes(*(_shape(x) for x in kw.values()
                                     if x is not None))
    nA = math.prod(batch)
    rates = [torch.broadcast_to(arr(1.0 if x is None else x),
                                batch).reshape(nA) for x in kw.values()]
    coef = torch.stack([torch.cos(flips / 2) ** 2, torch.sin(flips / 2) ** 2,
                        torch.sin(flips), torch.cos(flips), flips])
    M0a, M0b, phi, b1v = rates[6], rates[7], rates[9], rates[10]
    rest = [torch.cos(phi), torch.sin(phi), M0a, M0b, b1v]
    if esp.ndim == 0:
        pk = torch.stack(_x_entries(*rates[:9], esp / 2) + rest)
    else:
        pkt = torch.utils.checkpoint.checkpoint(
            _x_step_entries, *rates[:9], esp / 2, use_reentrant=False)
        pk = (torch.stack(rest), pkt)
    cfg = kepgx.XcpmgCfg(K=nE + 1, has_b1=b1 is not None)
    return coef, pk, cfg, batch


def _xcpmg_kernels(flips, **kw):
    r"""The kernels' route: :func:`_xcpmg_rows`, then
    :func:`mrphy_tpu_torch.kernels.epgx.xcpmg` at a scalar ``esp`` or
    :func:`~mrphy_tpu_torch.kernels.epgx.xcpmg_v` over a ``(nE,)`` train
    (the kernels' plain versions on CPU tensors)."""
    coef, pk, cfg, batch = _xcpmg_rows(flips, **kw)
    if isinstance(pk, tuple):
        er, ei = kepgx.xcpmg_v(coef, *pk, cfg)        # (nE, nA) each
    else:
        er, ei = kepgx.xcpmg(coef, pk, cfg)
    return torch.stack([er.T, ei.T], -1).reshape(batch + (cfg.K - 1, 2))
