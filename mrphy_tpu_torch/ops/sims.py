r"""Bloch simulation — the fast engines (counterpart of
:mod:`mrphy_tpu.ops.sims`).

- :func:`blochsim_rfgr`: the fused engine. B-effective is assembled per
  step inside the time loop from the raw waveforms, so the O(nM·nT)
  field tensor never materializes. Kernels ``rfgr_fwd`` and, for the
  gradient, ``rfgr_bwd``.
- :func:`blochsim`: the B-effective streaming engine. Kernels
  ``beff_fwd`` and ``beff_bwd``; a bfloat16 Beff is honoured as a storage
  format (its gradient is bfloat16 too).
- :func:`freeprec`: closed-form free precession.
- :func:`rfgr_phi_bound`: a bound on the per-step rotation angle.

Layout: the public API keeps the reference's ``(N, *Nd, nT, xyz)``
convention; inside, the engines use plain structure-of-arrays planes —
``(N, 3, nS)`` for the fused engine, ``(3, B)`` with the batch folded into
spins for the streaming engine. Kernels mask the ragged edge themselves,
so no spin padding is added.

``backend='auto'`` takes the CUDA kernels for CUDA tensors and the plain
PyTorch versions for CPU tensors; ``'cuda'`` insists on the kernels (and
raises for CPU tensors); ``'torch'`` runs the plain versions on any
device.

Gradients w.r.t. ``Mi``/``rf``/``gr``/``loc``/``df``/``b1Map``/``vel``
(:func:`blochsim_rfgr`) or ``Mi``/``Beff`` (:func:`blochsim`); ``T1``,
``T2``, ``gam`` and ``dt`` get zero gradients, as in the JAX engine (the
γ2πdt scale and the relaxation factors are detached). ``adjoint=``:

- ``'reconstruct'`` (default): the chunk-checkpointed reconstruction
  adjoint. The forward keeps only the chunk-end states, O(nM·nT/tc)
  memory; the backward rebuilds the trajectory in reverse. On
  ``backend='cuda'`` forward and backward are the kernels
  (``rfgr_fwd``+``rfgr_bwd``, ``beff_fwd``+``beff_bwd``); on
  ``backend='torch'`` their plain versions, in the same
  ``torch.autograd.Function``.
- ``'history'``: torch autograd through the plain time loop on any
  device, which keeps every step, O(nM·nT) memory (JAX routes it to its
  XLA engine); ``backend='cuda'`` refuses it.
"""

import functools
import math
from typing import Optional

import torch

from mrphy_tpu_torch import gamH, dt0, pi
from mrphy_tpu_torch._kwalias import kwalias
from mrphy_tpu_torch.kernels import bloch
from mrphy_tpu_torch.utils._shapes import asarr, rshape

__all__ = ['blochsim', 'blochsim_rfgr', 'rfgr_phi_bound', 'freeprec']

_ADJOINTS = ('reconstruct', 'history')


def _check_common(T1, T2, adjoint: str, backend: str, x) -> str:
    r"""Validate the shared keywords; return the resolved backend."""
    if (T1 is None) != (T2 is None):
        raise ValueError('pass both T1 and T2, or neither')
    if adjoint not in _ADJOINTS:
        raise ValueError(f'adjoint must be one of {_ADJOINTS}, not '
                         f'{adjoint!r}')
    if backend == 'cuda' and adjoint == 'history':
        raise ValueError("backend='cuda' implements adjoint='reconstruct' "
                         "only; adjoint='history' runs the plain loop")
    if backend == 'auto':
        return 'cuda' if x.device.type == 'cuda' else 'torch'
    if backend == 'cuda' and x.device.type != 'cuda':
        raise ValueError("backend='cuda' needs CUDA tensors, got "
                         f'{x.device}')
    if backend not in ('torch', 'cuda'):
        raise ValueError(f'unknown backend {backend!r}')
    return backend


def _engine(kernel, plain_loop, backend: str, adjoint: str):
    r"""The engine for the resolved ``backend`` and ``adjoint``: the
    kernel wrapper (kernels forward and backward), the same wrapper on
    the plain versions, or the plain loop under torch autograd."""
    if adjoint == 'history':
        return plain_loop
    return functools.partial(kernel, plain=backend != 'cuda')


def _promote(*xs) -> torch.dtype:
    dtype = xs[0].dtype
    for x in xs[1:]:
        dtype = torch.promote_types(dtype, x.dtype)
    return dtype


def beff_planes(Mi, Beff, *, T1=None, T2=None, gam=gamH, dt=dt0):
    r"""The ``beff_fwd`` kernel's arguments ``(mi, beff, E, e1_1, g2pd)``
    for a :func:`blochsim` call (same inputs, validated there)."""
    NNd, nT = tuple(Beff.shape[:-2]), Beff.shape[-2]
    B = math.prod(NNd)
    dtype = _promote(Mi, Beff)
    if dtype == torch.bfloat16:
        dtype = torch.float32                 # compute dtype
    store_dt = torch.bfloat16 if Beff.dtype == torch.bfloat16 else dtype
    Mi, Beff = Mi.to(dtype), Beff.to(device=Mi.device, dtype=store_dt)

    mi = Mi.reshape(B, 3).T.contiguous()                         # (3, B)
    beff = Beff.reshape(B, nT, 3).permute(1, 2, 0).contiguous()  # (nT,3,B)

    def flat(x):  # `()` ⊻ `(N ⊻ 1, *Nd ⊻ 1)` param → (B,), detached
        return rshape(asarr(x, Mi), len(NNd)).detach().expand(
            NNd).reshape(-1)

    g2pd = (2 * pi * flat(gam) * flat(dt)).contiguous()
    E = e1_1 = None
    if T1 is not None:
        E1 = torch.exp(-flat(dt) / flat(T1))
        E2 = torch.exp(-flat(dt) / flat(T2))
        E = torch.stack([E2, E2, E1])                            # (3, B)
        # expm1, not exp()-1: at µs dwell times E1 ≈ 1-4e-6 and the
        # subtraction cancels catastrophically
        e1_1 = torch.expm1(-flat(dt) / flat(T1)).contiguous()
    return mi, beff, E, e1_1, g2pd


@kwalias(**{'γ': 'gam'})
def blochsim(Mi, Beff, *, T1: Optional[torch.Tensor] = None,
             T2: Optional[torch.Tensor] = None, gam=gamH, dt=dt0,
             backend: str = 'auto', adjoint: str = 'reconstruct',
             max_phi: Optional[float] = None):
    r"""Bloch simulator on B-effective.

    Inputs:
        - ``Mi``: `(N, *Nd, xyz)`, spins (equilibrium ``[0, 0, 1]``).
        - ``Beff``: `(N, *Nd, nT, xyz)`, "Gauss". A **bfloat16** Beff is a
          storage format: the kernel streams it at half the bytes and
          widens it to float32 at load; accuracy is then bf16's ~3
          significant digits on the field.
    Optionals:
        - ``T1``/``T2``: `()` ⊻ `(N ⊻ 1, *Nd ⊻ 1,)`, "Sec" (both or neither).
        - ``gam`` (alias ``γ``): `()` ⊻ `(N ⊻ 1, *Nd ⊻ 1,)`, "Hz/Gauss".
        - ``dt``: `()` ⊻ `(N ⊻ 1,)`, "Sec".
        - ``backend``: ``'auto'`` | ``'torch'`` | ``'cuda'``.
        - ``adjoint``: ``'reconstruct'`` (default) | ``'history'``, see
          the module docstring.
        - ``max_phi``: accepted for API compatibility; it has no effect
          here (the CUDA kernels use the library ``sincos`` with its full
          range reduction at any angle).
    Outputs:
        - ``Mo``: `(N, *Nd, xyz)`.

    The wrapper permutes Beff to ``(nT, 3, B)`` for coalesced loads: one
    extra copy of Beff in memory (and one more for its gradient, which
    flows back through the permute and, for bf16, the cast).
    """
    Mi, Beff = torch.as_tensor(Mi), torch.as_tensor(Beff)
    if Mi.shape[:-1] != Beff.shape[:-2]:
        raise ValueError(f'Mi {tuple(Mi.shape)} and Beff '
                         f'{tuple(Beff.shape)} disagree on (N, *Nd)')
    backend = _check_common(T1, T2, adjoint, backend, Mi)
    args = beff_planes(Mi, Beff, T1=T1, T2=T2, gam=gam, dt=dt)
    run = _engine(bloch.beff_fwd, bloch.beff_fwd_torch, backend, adjoint)
    return run(*args)[-1].T.reshape(tuple(Mi.shape))


@kwalias(**{'γ': 'gam', 'Δf': 'df'})
def blochsim_rfgr(Mi, rf, gr, loc, *, T1: Optional[torch.Tensor] = None,
                  T2: Optional[torch.Tensor] = None, df=None, b1Map=None,
                  gam=gamH, dt=dt0, vel=None,
                  adjoint: str = 'reconstruct',
                  backend: str = 'auto', mesh=None,
                  max_phi: Optional[float] = None):
    r"""Fused Bloch simulator taking raw waveforms.

    Equivalent to ``blochsim(Mi, rfgr2beff(rf, gr, loc, ...), ...)`` but
    B-effective is assembled per step inside the time loop.

    Inputs:
        - ``Mi``: `(N, *Nd, xyz)`; ``rf``: `(N, xy, nT, (nCoils))`;
          ``gr``: `(N, xyz, nT)`; ``loc``: `(N, *Nd, xyz)`, "cm".
    Optionals: as :func:`blochsim`, plus ``df`` (alias ``Δf``)
        `(N ⊻ 1, *Nd ⊻ 1)`, "Hz", and ``b1Map`` `(N, *Nd, xy, (nCoils))`
        as :func:`mrphy_tpu_torch.ops.beffective.rfgr2beff`; ``vel``:
        `(N, *Nd, xyz)`, "cm/s" — per-spin velocities (flow): locations
        evolve as ``loc + vel·t`` inside the loop; ``mesh``: multi-device
        runs are not ported yet (raises :class:`NotImplementedError`).
    Outputs:
        - ``Mo``: `(N, *Nd, xyz)`.
    """
    if mesh is not None:
        raise NotImplementedError('mesh= (multi-device runs) is not ported '
                                  'to mrphy_tpu_torch yet')
    Mi, rf, gr, loc = (torch.as_tensor(x) for x in (Mi, rf, gr, loc))
    if Mi.shape[:-1] != loc.shape[:-1]:
        raise ValueError(f'Mi {tuple(Mi.shape)} and loc {tuple(loc.shape)} '
                         'disagree on (N, *Nd)')
    backend = _check_common(T1, T2, adjoint, backend, Mi)
    args = rfgr_planes(Mi, rf, gr, loc, T1=T1, T2=T2, df=df, b1Map=b1Map,
                       gam=gam, dt=dt, vel=vel)
    run = _engine(bloch.rfgr_fwd, bloch.rfgr_fwd_torch, backend, adjoint)
    return run(*args)[:, -1].transpose(1, 2).reshape(tuple(Mi.shape))


def rfgr_planes(Mi, rf, gr, loc, *, T1=None, T2=None, df=None, b1Map=None,
                gam=gamH, dt=dt0, vel=None):
    r"""The ``rfgr_fwd`` kernel's arguments ``(mi, rf2, gr2, loc_p, dfg,
    b1_p, E, e1_1, g2pd, vel_p, tarr2)`` for a :func:`blochsim_rfgr` call
    (same inputs, validated there)."""
    NNd = tuple(Mi.shape[:-1])
    N, Nd = NNd[0], NNd[1:]
    nS = math.prod(Nd)
    nT = gr.shape[2]
    dtype = _promote(rf, gr, Mi)
    Mi = Mi.to(dtype)

    def planes(x):  # (N, *Nd, 3) → (N, 3, nS)
        return asarr(x, Mi).reshape(N, nS, 3).transpose(1, 2)

    def flat(x):  # `()` ⊻ `(N ⊻ 1, *Nd ⊻ 1)` param → (N, nS)
        return rshape(asarr(x, Mi), len(NNd)).expand(NNd).reshape(N, nS)

    if rf.ndim == 3:
        rf = rf[..., None]                                # add coil dim
    rf = asarr(rf, Mi)                                    # dtype, device
    nC = rf.shape[-1]
    # waveform rows [x coils..., y coils...]
    rf2 = torch.cat([rf[:, 0].transpose(1, 2), rf[:, 1].transpose(1, 2)],
                    dim=1).contiguous()                   # (N, 2C, nT)
    gr2 = asarr(gr, Mi).contiguous()                      # (N, 3, nT)

    # Pre-scale the per-spin fields by γ2πdt ONCE, outside the time loop.
    # The scale is detached: the engine's contract gives zero gradients
    # w.r.t. γ/dt (a live scale would leak partial, wrong ones).
    g2pd = (2 * pi * flat(gam) * flat(dt)).detach().contiguous()
    loc_p = (g2pd[:, None] * planes(loc)).contiguous()
    vel_p = tarr2 = None
    if vel is not None:
        vel_p = (g2pd[:, None] * planes(
            asarr(vel, Mi).expand(NNd + (3,)))).contiguous()
        dt_b = asarr(dt, Mi).detach().reshape(-1).expand(N)
        tarr2 = (torch.arange(nT, dtype=dtype, device=Mi.device)[None, :]
                 * dt_b[:, None]).contiguous()            # (N, nT)
    # dfg = γ2πdt·(df/γ) = 2πdt·df — γ cancels exactly
    dfg = (None if df is None else
           (flat(df) * (2 * pi * flat(dt)).detach()).contiguous())

    b1_p = None
    if b1Map is not None:
        b1Map = asarr(b1Map, Mi)
        if b1Map.ndim == 2 + len(Nd):
            b1Map = b1Map[..., None]                      # add coil dim
        b1 = b1Map.reshape(N, -1, 2, b1Map.shape[-1]).expand(
            N, nS, 2, nC)                                 # (N, nS, 2, C)
        b1_p = (g2pd[:, None] * b1.reshape(N, nS, 2 * nC).transpose(1, 2)
                ).contiguous()                            # (N, 2C, nS)

    E = e1_1 = None
    if T1 is not None:
        E1 = torch.exp(-flat(dt) / flat(T1)).detach()
        E2 = torch.exp(-flat(dt) / flat(T2)).detach()
        E = torch.stack([E2, E2, E1], dim=1).contiguous()  # (N, 3, nS)
        # not exp()-1: catastrophic cancellation at E1 ≈ 1 (µs dwell)
        e1_1 = torch.expm1(-flat(dt) / flat(T1)).detach().contiguous()

    return (planes(Mi).contiguous(), rf2, gr2, loc_p, dfg, b1_p, E, e1_1,
            g2pd, vel_p, tarr2)


@kwalias(**{'γ': 'gam', 'Δf': 'df'})
def rfgr_phi_bound(rf, gr, loc, *, df=None, b1Map=None, gam=gamH,
                   dt=dt0, vel=None, dur=None):
    r"""Conservative upper bound on the per-step rotation angle
    ``ϕ = γ2πdt·|B_eff|`` (radians) for :func:`blochsim_rfgr` inputs —
    O(nM + nT) reductions, no field materialization.

    ``|B_z| ≤ max_t Σ_k |gr_k(t)|·max|loc_k (+|vel_k|·T)| + max|df|/γ``,
    ``|B_xy| ≤ max_t Σ_c |rf_c(t)|·max|b1_c|`` (or ``Σ_c|rf_c|`` bare);
    ``|B| ≤ sqrt(B_z² + B_xy²)``. Returns a 0-dim float32 tensor.
    """
    loc = torch.as_tensor(loc)

    def f32(x):  # float32, on loc's device
        return torch.as_tensor(x, dtype=torch.float32, device=loc.device)

    rf, gr, loc = f32(rf), f32(gr), f32(loc)
    if rf.ndim == 3:
        rf = rf[..., None]
    gam_max, dt_max = f32(gam).max(), f32(dt).max()
    locm = loc.abs()
    if vel is not None:
        T = (dt_max * gr.shape[-1]) if dur is None else dur
        locm = locm + T * f32(vel).abs()
    loc_max = locm.reshape(-1, 3).amax(dim=0)                  # (3,)
    bz = (gr.abs() * loc_max[None, :, None]).sum(dim=1).max()
    if df is not None:
        # γ cancels: the Bz contribution is df/γ, the angle is γ2πdt·Bz
        bz = bz + f32(df).abs().max() / gam_max
    rho = torch.hypot(rf[:, 0], rf[:, 1])                      # (N, nT, C)
    if b1Map is None:
        bxy = rho.sum(dim=-1).max()
    else:
        b1 = f32(b1Map)
        if b1.ndim == loc.ndim:              # missing coil dim
            b1 = b1[..., None]
        b1m = torch.hypot(b1[..., 0, :], b1[..., 1, :])        # (N,...,C)
        b1_max = b1m.reshape(-1, b1m.shape[-1]).amax(dim=0)    # (C,)
        bxy = (rho * b1_max).sum(dim=-1).max()
    return 2 * pi * gam_max * dt_max * torch.hypot(bz, bxy)


@kwalias(**{'Δf': 'df'})
def freeprec(Mi, dur, *, T1=None, T2=None, df=None):
    r"""Free precession (differentiable w.r.t. ``Mi`` only; ``dur``/
    ``T1``/``T2``/``df`` get zero gradients).

    Inputs:
        - ``Mi``: `(N, *Nd, xyz)`, spins.
        - ``dur``: `()` ⊻ `(N ⊻ 1,)`, "Sec".
    Optionals:
        - ``T1``/``T2``: `()` ⊻ `(N ⊻ 1, *Nd ⊻ 1,)`, "Sec" (both or neither).
        - ``df`` (alias ``Δf``): `(N ⊻ 1, *Nd ⊻ 1,)`, "Hz".
    Outputs:
        - ``Mo``: `(N, *Nd, xyz)`.
    """
    Mi = torch.as_tensor(Mi)
    ndim = Mi.ndim - 1  # rank of (N, *Nd)
    if (T1 is None) != (T2 is None):
        raise ValueError('pass both T1 and T2, or neither')

    def par(x):
        return rshape(asarr(x, Mi), ndim).detach()

    dur = par(dur)
    Mx, My, Mz = Mi.unbind(-1)
    if df is not None:
        phi = -(2 * pi) * par(df) * dur
        cphi, sphi = torch.cos(phi), torch.sin(phi)
        Mx, My = cphi * Mx - sphi * My, sphi * Mx + cphi * My
    if T1 is not None:
        E1, E2 = torch.exp(-dur / par(T1)), torch.exp(-dur / par(T2))
        Mx, My, Mz = E2 * Mx, E2 * My, E1 * Mz + 1 - E1
    return torch.stack(torch.broadcast_tensors(Mx, My, Mz), dim=-1)
