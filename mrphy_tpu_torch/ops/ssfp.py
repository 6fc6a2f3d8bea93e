r"""Balanced SSFP signal models: transient trains and steady states
(counterpart of :mod:`mrphy_tpu.ops.ssfp`).

Balanced sequences rewind every gradient within the TR, so no
configuration orders develop: each voxel is ONE isochromat whose per-TR
evolution is an instantaneous RF rotation plus closed-form precession and
relaxation.

- :func:`bssfp_train`: the transient response to a variable flip, phase
  and TR train, the original MR-fingerprinting sequence (Ma et al., Nature
  495:187, 2013), whose signal depends on T1, T2 and off-resonance.
- :func:`bssfp_steady`: the steady state as one batched 3×3 linear solve
  ``m* = (I − A)⁻¹ b`` of the per-TR affine map.

Conventions are the package's Bloch engines': an RF pulse of flip ``α``
about phase ``φ`` is the rotation ``uphirot(u_φ, −α)``, and free precession
by ``df`` over ``dur`` rotates the transverse plane by ``−2π·df·dur``.
Signals are demodulated by the transmit phase and returned as real ``[re,
im]`` pairs.

:func:`bssfp_train` has two routes
(:func:`mrphy_tpu_torch.ops.routing.route` says which a call takes):

- the plain route, a loop over TRs (JAX's ``lax.scan``), differentiable by
  torch autograd;
- the kernels of :mod:`mrphy_tpu_torch.kernels.ssfp` for a shared 1-D flip
  train from equilibrium: ``bssfp_fwd``, or ``bssfp_fwd_chk`` with the
  hand-written adjoint ``bssfp_bwd`` when a gradient is needed.

``backend='auto'`` takes the kernels for CUDA tensors and the plain route
for CPU tensors; ``'cuda'`` insists on the kernels (and raises for CPU
tensors); ``'torch'`` runs the plain route on any device. Per-voxel 2-D
flip trains and a prepared ``Minit`` run the plain route under ``'auto'``
on any device, as JAX's ``'xla-fallback'`` does, and raise under
``'cuda'``. ``mesh=`` raises (multi-device runs are not ported yet).
"""

import math

import torch

from mrphy_tpu_torch import pi
from mrphy_tpu_torch.kernels import ssfp as kssfp
from mrphy_tpu_torch.kernels.signal import full_f32_matmul
from mrphy_tpu_torch.ops.epg import _common, _shape
from mrphy_tpu_torch.utils import uphirot

__all__ = ['bssfp_train', 'bssfp_steady']


def _relax_precess(M, dur, df, T1, T2, M0):
    r"""Closed-form free precession and relaxation over ``dur`` (batch
    scalars broadcast; ``freeprec`` semantics with an ``M0 ≠ 1``
    equilibrium)."""
    phi = -(2 * pi) * df * dur
    c, s = torch.cos(phi), torch.sin(phi)
    E2 = torch.exp(-dur / T2)
    # expm1: at ms TRs `1 - exp(-dur/T1)` cancels ~3 float32 digits
    e1_1 = -torch.expm1(-dur / T1)
    Mx = E2 * (c * M[..., 0] - s * M[..., 1])
    My = E2 * (s * M[..., 0] + c * M[..., 1])
    Mz = (1 - e1_1) * M[..., 2] + e1_1 * M0
    return torch.stack([Mx, My, Mz], -1)


def bssfp_train(flips, *, T1, T2, tr, df=0.0, te=None, phis=None,
                dphi=pi, M0=1.0, b1=None, Minit=None, mesh=None,
                backend: str = 'auto'):
    r"""Transient balanced-SSFP train: instantaneous RF pulses with exact
    inter-pulse precession and relaxation, one isochromat per voxel.

    Per TR ``n``: RF pulse (flip ``flips[n]`` about phase ``φₙ``),
    precess/relax to TE where the signal ``(Mx + iMy)·e^{−iφₙ}`` is read,
    then precess/relax over the TR remainder. No spoiling: the
    magnetization carries into the next TR, so the signal depends on
    off-resonance ``df``.

    Inputs:
        - ``flips``: `(nTR,)` or `(*batch, nTR)`, "Rad".
        - ``T1``/``T2``: `()` ⊻ `(*batch,)`, "Sec".
        - ``tr``: `()` or `(nTR,)`, "Sec"; an ``α/2−TR/2`` catalyzation is
          the half flip and half TR prepended to the train.
        - ``df``: `()` ⊻ `(*batch,)`, "Hz", off-resonance.
        - ``te``: `()` or `(nTR,)`, "Sec"; None → ``tr/2``.
        - ``phis``: `(nTR,)` or `(*batch, nTR)`, "Rad", the RF phase
          schedule; None → the linear cycle ``φₙ = n·dphi``.
        - ``dphi``: phase-cycle increment, "Rad" (default π, the
          alternating ±x scheme).
        - ``M0``: `()` ⊻ `(*batch,)`, equilibrium magnetization.
        - ``b1``: `()` ⊻ `(*batch,)` transmit scale of the flip train.
        - ``Minit``: `(*batch, xyz)` initial state; None → ``[0, 0, M0]``.
        - ``mesh``: multi-device runs are not ported yet (raises
          :class:`NotImplementedError`).
        - ``backend``: ``'auto'`` | ``'torch'`` | ``'cuda'`` (module
          docstring).
    Outputs:
        - ``signals``: `(*batch, nTR, 2)` real ([re, im] of the demodulated
          echo at TE).

    Differentiable w.r.t. ``flips``/``phis``/``T1``/``T2``/``df``/``M0``/
    ``b1``/``tr``/``te`` on every route.
    """
    from mrphy_tpu_torch.ops.routing import route
    if mesh is not None:
        raise NotImplementedError('mesh= (multi-device runs) is not ported '
                                  'to mrphy_tpu_torch yet')
    kw = dict(T1=T1, T2=T2, tr=tr, df=df, te=te, phis=phis, dphi=dphi, M0=M0,
              b1=b1)
    path = route('bssfp_train', backend=backend, flips=flips, Minit=Minit,
                 **kw)['path']
    if path.startswith('cuda'):
        device = _common(flips, T1, T2, tr, df, te, phis, M0, b1)[1]
        if backend == 'cuda' and device.type != 'cuda':
            raise ValueError("backend='cuda' needs CUDA tensors, got "
                             f'{device}')
        return _bssfp_kernels(flips, **kw)
    return _bssfp_scan(flips, Minit=Minit, **kw)


def _bssfp_scan(flips, *, T1, T2, tr, df=0.0, te=None, phis=None, dphi=pi,
                M0=1.0, b1=None, Minit=None):
    r"""The plain route: JAX's ``lax.scan`` (``ssfp.py:147-193``) as a loop
    over TRs."""
    dtype = _common(flips, b1, T1, T2, df, phis)[0]
    device = _common(flips, b1, T1, T2, df, phis, tr, te, M0, Minit)[1]

    def arr(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    flips = arr(flips)
    if b1 is not None:          # per-voxel transmit scale (B1+ dim)
        flips = arr(b1)[..., None] * flips
    nTR = flips.shape[-1]
    T1b, T2b, dfb, M0 = arr(T1), arr(T2), arr(df), arr(M0)
    if phis is None:
        phis = arr(dphi) * torch.arange(nTR, dtype=dtype, device=device)
    phis = arr(phis)
    trs = torch.broadcast_to(arr(tr), (nTR,))
    tes = trs / 2 if te is None else torch.broadcast_to(arr(te), (nTR,))
    batch = torch.broadcast_shapes(flips.shape[:-1], phis.shape[:-1],
                                   T1b.shape, T2b.shape, dfb.shape, M0.shape)
    T1b, T2b = torch.broadcast_to(T1b, batch), torch.broadcast_to(T2b, batch)
    dfb, M0b = torch.broadcast_to(dfb, batch), torch.broadcast_to(M0, batch)
    if Minit is None:
        M = torch.cat([torch.zeros(batch + (2,), dtype=dtype, device=device),
                       M0b[..., None]], -1)
    else:
        M = torch.broadcast_to(arr(Minit), batch + (3,))
    flips_t = torch.broadcast_to(flips, batch + (nTR,)).movedim(-1, 0)
    phis_t = torch.broadcast_to(phis, batch + (nTR,)).movedim(-1, 0)
    sigs = []
    for n in range(nTR):
        a, phi = flips_t[n], phis_t[n]
        c, s = torch.cos(phi), torch.sin(phi)
        M = uphirot(torch.stack([c, s, torch.zeros_like(phi)], -1), -a, M)
        M = _relax_precess(M, tes[n], dfb, T1b, T2b, M0b)
        sigs.append(torch.stack([c * M[..., 0] + s * M[..., 1],
                                 c * M[..., 1] - s * M[..., 0]], -1))
        M = _relax_precess(M, trs[n] - tes[n], dfb, T1b, T2b, M0b)
    return torch.stack(sigs, -2)                 # (*batch, nTR, 2)


def _bssfp_rows(flips, *, T1, T2, tr, df=0.0, te=None, phis=None, dphi=pi,
                M0=1.0, b1=None):
    r"""The kernels' arguments for :func:`bssfp_train`'s inputs, as
    ``_bssfp_dispatch`` (``ssfp_pallas.py:151-199``) builds them, without
    its padding of the train: ``(coef, pk, cfg, batch)``, the per-TR rows
    ``[cos α, sin α·sin φ, sin α·cos φ, (1 − cos α)·cos φ, (1 − cos α)·sin
    φ, cos φ, sin φ, α]`` (+ ``[te, tr − te]`` under a ``(nTR,)`` tr or te),
    the per-atom rows (at a constant TR/TE the relaxation and precession
    factors to TE and over the remainder, ``M0``, ``b1``; otherwise ``[1/T1,
    1/T2, −2π·df, M0, b1]``) and the atoms' batch shape, flattened into the
    columns, in the call's dtype. Torch autograd of the construction
    carries the gradients of every input back from the rows'."""
    dtype = _common(flips, b1, T1, T2, df, phis)[0]
    device = _common(flips, b1, T1, T2, df, phis, tr, te, M0)[1]

    def arr(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    flips = arr(flips)
    if flips.ndim != 1:
        raise ValueError('the kernels take a shared (nTR,) flip train, got '
                         f'{tuple(flips.shape)}')
    nTR = flips.shape[0]
    if phis is None:
        phis = arr(dphi) * torch.arange(nTR, dtype=dtype, device=device)
    phis = arr(phis)
    if phis.shape != (nTR,):
        raise ValueError(f'phis must be a ({nTR},) train, got '
                         f'{tuple(phis.shape)}')
    tr = arr(tr)
    te = tr / 2 if te is None else arr(te)
    for x, name in ((tr, 'tr'), (te, 'te')):
        if x.shape not in ((), (nTR,)):
            raise ValueError(f'{name} must be a scalar or a ({nTR},) train, '
                             f'got {tuple(x.shape)}')
    vartr = tr.ndim == 1 or te.ndim == 1
    ca, sa = torch.cos(flips), torch.sin(flips)
    cphi, sphi = torch.cos(phis), torch.sin(phis)
    rows = [ca, sa * sphi, sa * cphi, (1 - ca) * cphi, (1 - ca) * sphi,
            cphi, sphi, flips]
    if vartr:
        trs, tes = torch.broadcast_to(tr, (nTR,)), torch.broadcast_to(
            te, (nTR,))
        rows += [tes, trs - tes]
    coef = torch.stack(rows)
    batch = torch.broadcast_shapes(*(_shape(x) for x in (T1, T2, df, M0, b1)
                                     if x is not None))
    nA = math.prod(batch)
    T1v, T2v, dfv, M0v, b1v = (
        torch.broadcast_to(arr(1.0 if x is None else x), batch).reshape(nA)
        for x in (T1, T2, df, M0, b1))
    om = -(2 * pi) * dfv
    if vartr:
        planes = [1 / T1v, 1 / T2v, om, M0v, b1v]
    else:
        rem = tr - te
        planes = [torch.cos(om * te), torch.sin(om * te),
                  torch.exp(-te / T2v), -torch.expm1(-te / T1v),
                  torch.cos(om * rem), torch.sin(om * rem),
                  torch.exp(-rem / T2v), -torch.expm1(-rem / T1v), M0v, b1v]
    pk = torch.stack(planes)
    cfg = kssfp.BssfpCfg(has_b1=b1 is not None, vartr=vartr)
    return coef, pk, cfg, batch


def _bssfp_kernels(flips, **kw):
    r"""The kernels' route: :func:`_bssfp_rows`, then
    :func:`mrphy_tpu_torch.kernels.ssfp.bssfp` (the kernels' plain versions
    on CPU tensors), the echoes laid out ``(*batch, nTR, 2)``."""
    coef, pk, cfg, batch = _bssfp_rows(flips, **kw)
    er, ei = kssfp.bssfp(coef, pk, cfg)            # (nTR, nA) each
    return torch.stack([er.T, ei.T], -1).reshape(batch + (coef.shape[1], 2))


def _rz(theta, dtype):
    r"""Right-handed z-rotation matrices, `(*batch, 3, 3)`."""
    c, s = torch.cos(theta), torch.sin(theta)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, -s, z], -1),
                        torch.stack([s, c, z], -1),
                        torch.stack([z, z, o], -1)], -2).to(dtype)


def _rx(a, dtype):
    r"""Right-handed x-rotation matrices, `(*batch, 3, 3)`."""
    c, s = torch.cos(a), torch.sin(a)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([o, z, z], -1),
                        torch.stack([z, c, -s], -1),
                        torch.stack([z, s, c], -1)], -2).to(dtype)


def bssfp_steady(alpha, *, T1, T2, tr, df=0.0, te=None, dphi=pi, M0=1.0):
    r"""Balanced-SSFP steady state: one batched 3×3 solve.

    With a constant flip ``α`` and the linear phase cycle ``φₙ = n·dphi``,
    the per-TR evolution in the demodulated frame is the affine map ``m →
    A·m + b`` with ``A = D(E2, E2, E1)·Rz(θ_tr − dphi)·Rx(−α)``, ``b = (1 −
    E1)·M0·ẑ``, ``θ_tr = −2π·df·tr``; the steady state is the fixed point
    ``m* = (I − A)⁻¹ b`` (``torch.linalg.solve``). The echo is read at TE
    with its own precession and decay, demodulated by the transmit phase.

    Inputs:
        - ``alpha``: `()` ⊻ `(*batch,)`, "Rad".
        - ``T1``/``T2``/``df``/``M0``: `()` ⊻ `(*batch,)` (broadcast).
        - ``tr``/``te``: scalars, "Sec"; ``te=None`` → ``tr/2``.
        - ``dphi``: phase-cycle increment, "Rad" (π = alternating ±x).
    Outputs:
        - ``signal``: `(*batch, 2)` real ([re, im] of the demodulated
          steady-state echo at TE).

    On resonance with ``dphi=π``, ``te=0`` this is the mid-band amplitude
    ``M0·sinα·(1−E1)/(1 − (E1−E2)cosα − E1·E2)``; across ``df`` it traces
    the banding profile with nulls at ``df = ±1/(2·tr)``. Differentiable in
    every input.
    """
    dtype = _common(alpha, T1, T2, df)[0]
    device = _common(alpha, T1, T2, df, tr, te, M0)[1]

    def arr(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    alpha, dfb, T1b, T2b, M0 = arr(alpha), arr(df), arr(T1), arr(T2), arr(M0)
    tr = arr(tr)
    te = tr / 2 if te is None else arr(te)
    batch = torch.broadcast_shapes(alpha.shape, T1b.shape, T2b.shape,
                                   dfb.shape, M0.shape)
    alpha = torch.broadcast_to(alpha, batch)
    T1b, T2b = torch.broadcast_to(T1b, batch), torch.broadcast_to(T2b, batch)
    dfb, M0b = torch.broadcast_to(dfb, batch), torch.broadcast_to(M0, batch)
    eye = torch.eye(3, dtype=dtype, device=device)
    # expm1: the steady state divides the `(1 - E1)` recovery by the
    # similarly small `I - A`; keep both ends of that quotient exact
    e1_1 = -torch.expm1(-tr / T1b)
    E1, E2 = 1 - e1_1, torch.exp(-tr / T2b)
    D = torch.stack([E2, E2, E1], -1)[..., :, None] * eye
    theta = -(2 * pi) * dfb * tr
    b = torch.cat([torch.zeros(batch + (2,), dtype=dtype, device=device),
                   (e1_1 * M0b)[..., None]], -1)
    # JAX's HIGHEST-precision 3×3 chain: no TF32 on the card
    with full_f32_matmul():
        A = D @ _rz(theta - dphi, dtype) @ _rx(-alpha, dtype)
        m = torch.linalg.solve(eye - A, b[..., None])
        # read out at TE: precess/decay te, demodulation already folded in
        M1 = (_rx(-alpha, dtype) @ m)[..., 0]
    M2 = _relax_precess(M1, te, dfb, T1b, T2b, M0b)
    return M2[..., :2]
