r"""Fused two-pool Bloch–McConnell engine taking raw waveforms — MT/CEST
simulation at volume scale (counterpart of :mod:`mrphy_tpu.ops.mc`).

:func:`blochsim_mc_rfgr` is to :func:`mrphy_tpu_torch.ops.slowsims.
blochsim_mc` what :func:`mrphy_tpu_torch.ops.sims.blochsim_rfgr` is to the
B-effective streaming engine: B-effective is assembled per step inside the
time loop from the rf/gr waveforms and the per-voxel fields, so live
memory is O(nM) for any nT. Kernels ``mc_fwd`` and, for the gradient,
``mc_bwd`` (:mod:`mrphy_tpu_torch.kernels.mc`).

``backend='auto'`` takes the CUDA kernels for CUDA tensors and their plain
PyTorch versions for CPU tensors; ``'cuda'`` insists on the kernels (and
raises for CPU tensors); ``'torch'`` runs the plain versions on any
device. Either way the backward is the two-phase chunk adjoint, which
keeps the chunk boundaries only.
"""

from typing import Optional

import torch

from mrphy_tpu_torch import gamH, dt0, pi
from mrphy_tpu_torch._kwalias import kwalias
from mrphy_tpu_torch.kernels import mc as kmc
from mrphy_tpu_torch.ops import sims
from mrphy_tpu_torch.ops.slowsims import mc_propagators
from mrphy_tpu_torch.utils._shapes import asarr, rshape

__all__ = ['blochsim_mc_rfgr']


def mc_planes(Mia, Mib, rf, gr, loc, *, T1a, T2a, T1b, T2b, kab, kba,
              Ma0=1.0, Mb0=0.1, dfb=0.0, df=None, b1Map=None, gam=gamH,
              dt=dt0):
    r"""The ``mc_fwd`` kernel's arguments ``(mi6, rf2, gr2, loc_p, dfg,
    b1_p, sb, Xp, Zp, g2pd)`` for a :func:`blochsim_mc_rfgr` call (same
    inputs, validated there)."""
    mi_a, rf2, gr2, loc_p, dfg, b1_p, _, _, g2pd, _, _ = sims.rfgr_planes(
        Mia, rf, gr, loc, df=df, b1Map=b1Map, gam=gam, dt=dt)
    NNd = tuple(Mia.shape[:-1])
    N, nS = NNd[0], mi_a.shape[-1]
    mi_b = asarr(Mib, mi_a).reshape(N, nS, 3).transpose(1, 2)
    mi6 = torch.cat([mi_a, mi_b], dim=1).contiguous()

    def flat(x):  # `()` ⊻ `(N ⊻ 1, *Nd ⊻ 1)` param → (N, nS)
        return rshape(asarr(x, mi_a), len(NNd)).expand(NNd).reshape(N, nS)

    # γ/dt zero-gradient contract: the scales are detached wherever they
    # enter (a live one would leak partial, wrong γ/dt gradients)
    dt_f = flat(dt).detach()
    sb = (flat(dfb) * (2 * pi * dt_f)).contiguous()      # pool-b z offset
    # the exact per-step exchange/relaxation propagators, per voxel;
    # autograd carries the tissue/exchange parameters' gradients here
    props = mc_propagators(flat(T1a), flat(T2a), flat(T1b), flat(T2b),
                           flat(kab), flat(kba), flat(Ma0), flat(Mb0), dt_f)
    Xp = torch.stack(props[:4], dim=1).contiguous()      # (N, 4, nS)
    Zp = torch.stack(props[4:], dim=1).contiguous()      # (N, 6, nS)
    return mi6, rf2, gr2, loc_p, dfg, b1_p, sb, Xp, Zp, g2pd


@kwalias(**{'γ': 'gam', 'Δf': 'df'})
def blochsim_mc_rfgr(Mia, Mib, rf, gr, loc, *, T1a, T2a, T1b, T2b, kab,
                     kba, Ma0=1.0, Mb0=0.1, dfb=0.0, df=None, b1Map=None,
                     gam=gamH, dt=dt0, backend: str = 'auto', mesh=None,
                     max_phi: Optional[float] = None):
    r"""Fused two-pool Bloch–McConnell simulator taking raw waveforms.

    Equivalent to ``slowsims.blochsim_mc(Mia, Mib, rfgr2beff(rf, gr, loc,
    Δf=df, b1Map=b1Map), ...)`` but B-effective is assembled per step
    inside the time loop.

    Inputs:
        - ``Mia``/``Mib``: `(N, *Nd, xyz)` pool states (absolute units —
          equilibria are ``Ma0``/``Mb0``);
        - ``rf``: `(N, xy, nT, (nCoils))`, "Gauss";
        - ``gr``: `(N, xyz, nT)`, "Gauss/cm"; ``loc``: `(N, *Nd, xyz)`,
          "cm".
    Optionals (each `()` ⊻ `(N ⊻ 1, *Nd ⊻ 1)` where per-voxel):
        - ``T1a``/``T2a``/``T1b``/``T2b``: "Sec"; ``kab``/``kba``:
          "1/Sec" exchange rates; ``Ma0``/``Mb0``: equilibria;
        - ``dfb``: "Hz", pool-b chemical shift; ``df`` (alias ``Δf``):
          "Hz", pool-a (B0) off-resonance — pool b sees ``df + dfb``;
        - ``b1Map``: `(N, *Nd, xy, (nCoils))` transmit sensitivities;
        - ``gam`` (alias ``γ``), ``dt``: as :func:`sims.blochsim_rfgr`;
        - ``backend``: ``'auto'`` | ``'torch'`` | ``'cuda'``;
        - ``mesh``: multi-device runs are not ported yet (raises
          :class:`NotImplementedError`);
        - ``max_phi``: accepted for API compatibility; it has no effect
          here (the CUDA kernels use the library ``sincos`` with its full
          range reduction at any angle).
    Outputs: ``(Ma, Mb)``, `(N, *Nd, xyz)` each.

    Differentiable w.r.t. every physics input: ``Mia``/``Mib``,
    ``rf``/``gr``, ``loc``, ``df``, ``b1Map`` and the tissue/exchange
    parameters ``T1a``/``T2a``/``T1b``/``T2b``/``kab``/``kba``/``Ma0``/
    ``Mb0``/``dfb`` (through the exact-propagator precompute). ``gam`` and
    ``dt`` get zero gradients.
    """
    if mesh is not None:
        raise NotImplementedError('mesh= (multi-device runs) is not ported '
                                  'to mrphy_tpu_torch yet')
    Mia, Mib, rf, gr, loc = (torch.as_tensor(x)
                             for x in (Mia, Mib, rf, gr, loc))
    if Mia.shape != Mib.shape:
        raise ValueError(f'Mia {tuple(Mia.shape)} and Mib '
                         f'{tuple(Mib.shape)} differ')
    if Mia.shape[:-1] != loc.shape[:-1]:
        raise ValueError(f'Mia {tuple(Mia.shape)} and loc '
                         f'{tuple(loc.shape)} disagree on (N, *Nd)')
    backend = sims._check_common(None, None, 'reconstruct', backend, Mia)
    args = mc_planes(Mia, Mib, rf, gr, loc, T1a=T1a, T2a=T2a, T1b=T1b,
                     T2b=T2b, kab=kab, kba=kba, Ma0=Ma0, Mb0=Mb0, dfb=dfb,
                     df=df, b1Map=b1Map, gam=gam, dt=dt)
    out = kmc.mc_fwd(*args, plain=backend != 'cuda')[:, -1]   # (N, 6, nS)
    shape = tuple(Mia.shape)
    return (out[:, :3].transpose(1, 2).reshape(shape),
            out[:, 3:].transpose(1, 2).reshape(shape))
