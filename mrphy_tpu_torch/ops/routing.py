r"""Backend-routing introspection: which path will a train family take?
(counterpart of :mod:`mrphy_tpu.ops.routing`)

:func:`route` answers, without running anything, which execution path
``<family>(..., backend=..., mesh=...)`` takes and why; the dispatchers of
:func:`mrphy_tpu_torch.ops.epg.epg_spgr`, :func:`~mrphy_tpu_torch.ops.epg.
epg_cpmg`, :func:`~mrphy_tpu_torch.ops.epg.epgx_spgr`,
:func:`~mrphy_tpu_torch.ops.epg.epgx_cpmg`,
:func:`~mrphy_tpu_torch.ops.epg.epgx_mt_spgr` and
:func:`mrphy_tpu_torch.ops.ssfp.bssfp_train` consult the same decision, so
the reported path cannot drift from the one taken.

Paths:

- ``'torch'``: the plain route, a loop over TRs (echoes) differentiable by
  torch autograd (``backend='torch'``, or ``'auto'`` on CPU tensors);
- ``'cuda-native-adjoint'``: the hand-written kernels, the forward and
  its hand-written adjoint (``backend='cuda'``, or ``'auto'`` on CUDA
  tensors);
- ``'torch-fallback'``: outside the kernels' scope (per-voxel 2-D flip
  trains; for ``bssfp_train`` also a prepared ``Minit``, for
  ``epgx_mt_spgr`` a batched ``wt``) under ``backend='auto'``, so the
  dispatcher runs the plain route on the card. Under ``backend='cuda'``
  such a train raises :class:`ValueError`: a caller who asks for the
  kernels is told that none would run.

The JAX package has a fourth path, ``'pallas-xla-vjp'``: a fused forward
with a recompute-through-XLA reverse, taken when the TPU adjoint's VMEM
scratch and HBM partials miss their budgets
(``epg_pallas.spgr_bwd_is_available``, ``cpmg_bwd_is_available``). The
port has no counterpart and no such gate: the H100 adjoints ``spgr_bwd``
and ``cpmg_bwd`` shorten the chunk to fit a fixed budget of per-chunk
scratch in device memory (:func:`mrphy_tpu_torch.kernels.epg.pick_tc`),
capped further for their lane route, which keeps the chunk's states on
chip, while its checkpoints fit a budget
(:func:`mrphy_tpu_torch.kernels.epg.adjoint_tc`), so each takes every
instance its forward takes; so do ``xspgr_bwd``'s, ``xspgr_v_bwd``'s,
``xcpmg_bwd``'s and ``xcpmg_v_bwd``'s, their chunk fitted and capped alike
for the two-pool state's 12 planes, and ``bssfp_bwd``'s, for an
isochromat's 3 (JAX's
``bssfp_bwd_is_available`` only warns there, and is not carried).
``epgx_spgr`` takes its kernels at a scalar ``tr`` and over a ``(nTR,)``
``tr`` train alike (the variable-TR instances ``xspgr_v_*`` stream each
step's propagator), and so does ``epgx_cpmg`` at a scalar ``esp`` and over
a ``(nE,)`` ``esp`` train (``xcpmg_v_*``), and ``epgx_mt_spgr`` at a scalar
``tr`` and over a ``(nTR,)`` ``tr`` train (``xmt_*`` and ``xmt_v_*``, their
chunk fitted for the bound-pool state's 8 planes).

Every family is ported. ``mesh=`` raises :class:`NotImplementedError`
(multi-device runs are not ported yet).
"""

import math

import numpy as np
import torch

__all__ = ['route', 'FAMILIES']

FAMILIES = ('epg_spgr', 'epg_cpmg', 'epgx_spgr', 'epgx_cpmg',
            'epgx_mt_spgr', 'bssfp_train')


def _shape(v) -> tuple:
    if v is None:
        return ()
    return tuple(v.shape) if isinstance(v, torch.Tensor) else np.shape(v)


def _n_atoms(kw, names) -> int:
    return math.prod(np.broadcast_shapes(*(_shape(kw.get(n))
                                           for n in names)))


def _mk(path, reason, **extra):
    return dict(path=path, fused=path.startswith('cuda'), reason=reason,
                **extra)


def _k_orders(kw, nT):
    kshift = int(kw.get('kshift', 1) or 1)
    K = kw.get('K')
    return nT * abs(kshift) + 1 if K is None else int(K)


def _train_ndim(kw, name):
    v = kw.get(name)
    if v is None:
        raise ValueError(f'route() needs `{name}`')
    shape = _shape(v)
    return len(shape), (shape[-1] if shape else 1)


def _per_voxel(kw, backend):
    r"""``(decision, nT)``: for a per-voxel 2-D train the plain route
    under ``'auto'`` (:class:`ValueError` under ``'cuda'``), for a shared
    1-D one None, left to the family's decider."""
    nd, nT = _train_ndim(kw, 'flips')
    if nd != 1 and backend == 'cuda':
        raise ValueError("backend='cuda': per-voxel trains are outside the "
                         f"kernels (flips ndim={nd}); use backend='auto' or "
                         "'torch' for the plain route")
    if nd != 1:
        return _mk('torch-fallback', 'per-voxel trains are outside the '
                   f'kernels (flips ndim={nd}); the dispatcher runs the '
                   'plain route'), nT
    return None, nT


def _decide_epg_spgr(kw, backend):
    from mrphy_tpu_torch.kernels.epg import adjoint_tc
    fallback, nT = _per_voxel(kw, backend)
    if fallback:
        return fallback
    nA = _n_atoms(kw, ('T1', 'T2', 'M0', 'b1', 'zinit', 'D'))
    K = _k_orders(kw, nT)
    varint = len(_shape(kw.get('tr'))) == 1 or len(_shape(kw.get('te'))) == 1
    return _mk('cuda-native-adjoint',
               'spgr_fwd, and spgr_fwd_chk + spgr_bwd under a gradient '
               '(nTR=%d, K=%d, nA=%d%s%s; the adjoint chunk tc=%d in '
               'float32)' % (nT, K, nA, ', variable tr/te' if varint else '',
                             ', diffusion' if kw.get('D') is not None
                             else '', adjoint_tc(nT, K, nA, 4)))


def _decide_epg_cpmg(kw, backend):
    from mrphy_tpu_torch.kernels.epg import adjoint_tc
    fallback, nE = _per_voxel(kw, backend)
    if fallback:
        return fallback
    nA = _n_atoms(kw, ('T1', 'T2', 'M0', 'b1', 'phi_ex', 'alpha_ex', 'D'))
    return _mk('cuda-native-adjoint',
               'cpmg_fwd, and cpmg_fwd_chk + cpmg_bwd under a gradient '
               '(nE=%d, nA=%d%s%s; the adjoint chunk tc=%d in float32)'
               % (nE, nA, ', variable esp' if len(_shape(kw.get('esp'))) == 1
                  else '', ', diffusion' if kw.get('D') is not None else '',
                  adjoint_tc(nE, nE + 1, nA, 4)))


def _decide_epgx_spgr(kw, backend):
    from mrphy_tpu_torch.kernels.epg import adjoint_tc
    from mrphy_tpu_torch.kernels.epgx import PLANES
    fallback, nT = _per_voxel(kw, backend)
    if fallback:
        return fallback
    nA = _n_atoms(kw, ('T1a', 'T2a', 'T1b', 'T2b', 'kab', 'kba', 'M0a',
                       'M0b', 'dfb', 'b1'))
    K = _k_orders(kw, nT)
    v = '_v' if len(_shape(kw.get('tr'))) == 1 else ''
    return _mk('cuda-native-adjoint',
               'xspgr%s_fwd, and xspgr%s_fwd_chk + xspgr%s_bwd under a '
               'gradient (nTR=%d, K=%d, nA=%d%s; the adjoint chunk tc=%d in '
               'float32)' % (v, v, v, nT, K, nA,
                             ', variable tr (per-step propagators)' if v
                             else '', adjoint_tc(nT, K, nA, 4, PLANES)))


def _decide_epgx_cpmg(kw, backend):
    from mrphy_tpu_torch.kernels.epg import adjoint_tc, pick_tc
    from mrphy_tpu_torch.kernels.epgx import PLANES
    fallback, nE = _per_voxel(kw, backend)
    if fallback:
        return fallback
    nA = _n_atoms(kw, ('T1a', 'T2a', 'T1b', 'T2b', 'kab', 'kba', 'M0a',
                       'M0b', 'dfb', 'phi_ex', 'b1'))
    v = '_v' if len(_shape(kw.get('esp'))) == 1 else ''
    # the scratch budget's chunk, and where the lane route caps it, its cap
    tc = pick_tc(nE, nE + 1, nA, 4, PLANES)
    lane_tc = adjoint_tc(nE, nE + 1, nA, 4, PLANES)
    cap = '' if lane_tc == tc else ' by the scratch budget, %d on the ' \
        'lane route,' % lane_tc
    return _mk('cuda-native-adjoint',
               'xcpmg%s_fwd, and xcpmg%s_fwd_chk + xcpmg%s_bwd under a '
               'gradient (nE=%d, K=%d, nA=%d%s; the adjoint chunk tc=%d%s in '
               'float32)' % (v, v, v, nE, nE + 1, nA,
                             ', variable esp (per-step propagators)' if v
                             else '', tc, cap))


def _decide_epgx_mt_spgr(kw, backend):
    from mrphy_tpu_torch.kernels.epg import pick_tc
    from mrphy_tpu_torch.kernels.epgx import PLANES_MT
    fallback, nT = _per_voxel(kw, backend)
    if fallback:
        return fallback
    if len(_shape(kw.get('wt'))) > 1:
        if backend == 'cuda':
            raise ValueError("backend='cuda': a batched wt is outside the "
                             'kernels (express a per-atom saturation through '
                             'wscale: kernels.epgx.xmt_spgr); use '
                             "backend='auto' or 'torch' for the plain route")
        return _mk('torch-fallback', 'a batched wt is outside the kernels '
                   '(express a per-atom saturation through wscale: '
                   'kernels.epgx.xmt_spgr); the dispatcher runs the plain '
                   'route')
    nA = _n_atoms(kw, ('T1a', 'T2a', 'T1b', 'kab', 'kba', 'M0a', 'M0b', 'b1',
                       'wscale'))
    K = _k_orders(kw, nT)
    v = '_v' if len(_shape(kw.get('tr'))) == 1 else ''
    return _mk('cuda-native-adjoint',
               'xmt%s_fwd, and xmt%s_fwd_chk + xmt%s_bwd under a gradient '
               '(nTR=%d, K=%d, nA=%d%s; the adjoint chunk tc=%d in float32)'
               % (v, v, v, nT, K, nA,
                  ', variable tr (per-TR propagators)' if v else '',
                  pick_tc(nT, K, nA, 4, PLANES_MT)))


def _decide_bssfp_train(kw, backend):
    from mrphy_tpu_torch.kernels.ssfp import chunk
    fallback, nT = _per_voxel(kw, backend)
    if fallback:
        return fallback
    if kw.get('Minit') is not None:
        if backend == 'cuda':
            raise ValueError("backend='cuda': the kernels start from "
                             'equilibrium, a prepared Minit is outside them; '
                             "use backend='auto' or 'torch' for the plain "
                             'route')
        return _mk('torch-fallback', 'the kernels start from equilibrium; a '
                   'prepared Minit runs the plain route')
    nA = _n_atoms(kw, ('T1', 'T2', 'df', 'M0', 'b1'))
    vartr = len(_shape(kw.get('tr'))) == 1 or len(_shape(kw.get('te'))) == 1
    return _mk('cuda-native-adjoint',
               'bssfp_fwd, and bssfp_fwd_chk + bssfp_bwd under a gradient '
               '(nTR=%d, nA=%d%s; the adjoint chunk tc=%d in float32)'
               % (nT, nA, ', variable tr/te' if vartr else '',
                  chunk(nT, nA, 4)))


_DECIDERS = {'epg_spgr': _decide_epg_spgr, 'epg_cpmg': _decide_epg_cpmg,
             'epgx_spgr': _decide_epgx_spgr, 'epgx_cpmg': _decide_epgx_cpmg,
             'epgx_mt_spgr': _decide_epgx_mt_spgr,
             'bssfp_train': _decide_bssfp_train}


def _on_cuda(kw) -> bool:
    return any(isinstance(v, torch.Tensor) and v.device.type == 'cuda'
               for v in kw.values())


def route(family: str, *, backend: str = 'auto', mesh=None, **kw):
    r"""Report the execution path ``<family>(..., backend=backend,
    mesh=mesh, **kw)`` will take.

    Inputs: the family's own keyword arguments (tensors, arrays or
    scalars: only their shapes, and for ``backend='auto'`` their devices,
    are inspected; nothing is computed). Returns ``{'path', 'fused',
    'reason'}`` with ``path`` one of ``'torch' | 'cuda-native-adjoint' |
    'torch-fallback'``. Raises :class:`ValueError` where the call would
    (``backend='cuda'`` with a per-voxel train, with ``bssfp_train``'s
    ``Minit`` or with ``epgx_mt_spgr``'s batched ``wt``).
    """
    if family not in FAMILIES:
        raise ValueError(f'unknown family {family!r}; one of {FAMILIES}')
    if mesh is not None:
        raise NotImplementedError('mesh= (multi-device runs) is not ported '
                                  'to mrphy_tpu_torch yet')
    if backend not in ('auto', 'torch', 'cuda'):
        raise ValueError(f'unknown backend {backend!r}')
    if backend == 'torch':
        return _mk('torch', "backend='torch' requested")
    if backend == 'auto' and not _on_cuda(kw):
        return _mk('torch', "backend='auto' on CPU tensors: the plain route")
    return _DECIDERS[family](kw, backend)
