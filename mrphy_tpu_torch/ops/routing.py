r"""Backend-routing introspection: which path will a train family take?
(counterpart of :mod:`mrphy_tpu.ops.routing`)

:func:`route` answers, without running anything, which execution path
``<family>(..., backend=..., mesh=...)`` takes and why; the dispatcher of
:func:`mrphy_tpu_torch.ops.epg.epg_spgr` consults the same decision, so the
reported path cannot drift from the one taken.

Paths:

- ``'torch'``: the plain route, a loop over TRs differentiable by torch
  autograd (``backend='torch'``, or ``'auto'`` on CPU tensors);
- ``'cuda-native-adjoint'``: the hand-written kernels, the forward and
  its hand-written adjoint (``backend='cuda'``, or ``'auto'`` on CUDA
  tensors);
- ``'torch-fallback'``: outside the kernels' scope (per-voxel 2-D flip
  trains) under ``backend='auto'``, so the dispatcher runs the plain route
  on the card. Under ``backend='cuda'`` such a train raises
  :class:`ValueError`: a caller who asks for the kernels is told that
  none would run.

The JAX package has a fourth path, ``'pallas-xla-vjp'``: a fused forward
with a recompute-through-XLA reverse, taken when the TPU adjoint's VMEM
scratch and HBM partials miss their budgets
(``epg_pallas.spgr_bwd_is_available``). The port has no counterpart and no
such gate: the H100 adjoint ``spgr_bwd`` keeps its per-chunk scratch in
device memory and shortens the chunk to fit a fixed budget
(:func:`mrphy_tpu_torch.kernels.epg.pick_tc`), so it takes every instance
the forward takes.

Only ``epg_spgr`` is ported; the other families raise
:class:`NotImplementedError` naming the slice of the port that brings
them. ``mesh=`` raises too (multi-device runs are not ported yet).
"""

import math

import numpy as np
import torch

__all__ = ['route', 'FAMILIES']

FAMILIES = ('epg_spgr', 'epg_cpmg', 'epgx_spgr', 'epgx_cpmg',
            'epgx_mt_spgr', 'bssfp_train')

# The slice of the port (ROADMAP.md, queue 1) that brings each family.
_SLICES = {'epg_cpmg': '10b', 'epgx_spgr': '10c-10d',
           'epgx_cpmg': '10e-10f', 'epgx_mt_spgr': '10g-10h',
           'bssfp_train': '11'}


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


def _decide_epg_spgr(kw, backend):
    from mrphy_tpu_torch.kernels.epg import pick_tc
    nd, nT = _train_ndim(kw, 'flips')
    if nd != 1 and backend == 'cuda':
        raise ValueError("backend='cuda': per-voxel trains are outside the "
                         f"kernels (flips ndim={nd}); use backend='auto' or "
                         "'torch' for the plain route")
    if nd != 1:
        return _mk('torch-fallback', 'per-voxel trains are outside the '
                   f'kernels (flips ndim={nd}); the dispatcher runs the '
                   'plain route')
    nA = _n_atoms(kw, ('T1', 'T2', 'M0', 'b1', 'zinit', 'D'))
    K = _k_orders(kw, nT)
    varint = len(_shape(kw.get('tr'))) == 1 or len(_shape(kw.get('te'))) == 1
    return _mk('cuda-native-adjoint',
               'spgr_fwd, and spgr_fwd_chk + spgr_bwd under a gradient '
               '(nTR=%d, K=%d, nA=%d%s%s; the adjoint chunk tc=%d in '
               'float32)' % (nT, K, nA, ', variable tr/te' if varint else '',
                             ', diffusion' if kw.get('D') is not None
                             else '', pick_tc(nT, K, nA, 4)))


_DECIDERS = {'epg_spgr': _decide_epg_spgr}


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
    (``backend='cuda'`` with a per-voxel train).
    """
    if family not in FAMILIES:
        raise ValueError(f'unknown family {family!r}; one of {FAMILIES}')
    if family not in _DECIDERS:
        raise NotImplementedError(
            f'{family} is not ported to mrphy_tpu_torch yet (slice '
            f'{_SLICES[family]} of ROADMAP.md queue 1)')
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
