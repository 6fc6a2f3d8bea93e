r"""1-D resampling as precomputed interpolation matrices (counterpart of
:mod:`mrphy_tpu.utils.interp`).

Every SciPy ``interp1d`` kind is a linear map of the sample values, so on
fixed sample and query grids the resampling is one `(nNew, nOld)` matrix,
built once on the host in float64 (:func:`interp_matrix`, numpy) and
applied on the tensor's device as one matrix product
(:func:`interp1d_apply`), which stays differentiable w.r.t. the samples.

- ``linear``/``nearest``/``nearest-up``/``previous``/``next``/``zero``:
  closed-form selection/weight rows (SciPy's conventions);
- ``cubic``: the not-a-knot cubic spline (what SciPy's ``kind='cubic'``
  builds) in second-derivative form; its data-independent solve folds
  into the matrix;
- any other kind: the matrix is probed column by column through SciPy.

The builder is the JAX package's, copied: importing
:mod:`mrphy_tpu.utils.interp` would import JAX.
"""

import functools

import numpy as np
import torch

__all__ = ['interp_matrix', 'interp1d_apply']

_NATIVE = ('linear', 'nearest', 'nearest-up', 'previous', 'next',
           'zero', 'cubic')


def _cubic_notaknot_matrix(t_o, t_n):
    r"""`(nNew, nOld)` not-a-knot cubic-spline resampling matrix: interior
    rows are the tridiagonal continuity conditions of the second
    derivatives M, the two boundary rows impose third-derivative
    continuity at the second and second-to-last knots. ``M = A⁻¹·B·y``
    with ``A`` and ``B`` data-independent, and the piecewise evaluation is
    linear in ``(y, M)``."""
    n = t_o.size
    if n < 4:
        raise ValueError(f'cubic (not-a-knot) needs >= 4 samples, got {n}')
    h = np.diff(t_o)                                   # (n-1,)
    A = np.zeros((n, n))
    B = np.zeros((n, n))
    i = np.arange(1, n - 1)
    A[i, i - 1] = h[:-1] / 6
    A[i, i] = (h[:-1] + h[1:]) / 3
    A[i, i + 1] = h[1:] / 6
    B[i, i - 1] = 1 / h[:-1]
    B[i, i] = -(1 / h[:-1] + 1 / h[1:])
    B[i, i + 1] = 1 / h[1:]
    A[0, :3] = (h[1], -(h[0] + h[1]), h[0])            # d3y cont. at t1
    A[-1, -3:] = (h[-1], -(h[-2] + h[-1]), h[-2])      # ... at t_{n-2}
    AinvB = np.linalg.solve(A, B)                      # (n, n)

    idx = np.clip(np.searchsorted(t_o, t_n, side='right') - 1, 0, n - 2)
    hi = h[idx]
    u = t_n - t_o[idx]                                 # left offset
    v = t_o[idx + 1] - t_n                             # right offset
    rows = np.arange(t_n.size)
    Wy = np.zeros((t_n.size, n))
    Wm = np.zeros((t_n.size, n))
    Wy[rows, idx] = v / hi
    Wy[rows, idx + 1] = u / hi
    Wm[rows, idx] = v ** 3 / (6 * hi) - hi * v / 6
    Wm[rows, idx + 1] = u ** 3 / (6 * hi) - hi * u / 6
    return Wy + Wm @ AinvB


def _selection_matrix(t_o, t_n, kind):
    r"""One-hot/weight rows for the non-spline kinds (SciPy conventions:
    ``nearest`` ties round down, ``nearest-up`` up; ``zero`` is the
    order-0 spline, the previous knot's value)."""
    n = t_o.size
    C = np.zeros((t_n.size, n))
    rows = np.arange(t_n.size)
    if kind == 'linear':
        idx = np.clip(np.searchsorted(t_o, t_n, side='right') - 1,
                      0, n - 2)
        w = (t_n - t_o[idx]) / (t_o[idx + 1] - t_o[idx])
        C[rows, idx] = 1 - w
        C[rows, idx + 1] = w
    elif kind in ('nearest', 'nearest-up'):
        mid = (t_o[:-1] + t_o[1:]) / 2
        side = 'left' if kind == 'nearest' else 'right'
        idx = np.searchsorted(mid, t_n, side=side)
        C[rows, np.clip(idx, 0, n - 1)] = 1
    elif kind in ('previous', 'zero'):
        idx = np.clip(np.searchsorted(t_o, t_n, side='right') - 1,
                      0, n - 1)
        C[rows, idx] = 1
    else:                                    # 'next'
        idx = np.clip(np.searchsorted(t_o, t_n, side='left'), 0, n - 1)
        C[rows, idx] = 1
    return C


@functools.lru_cache(maxsize=32)
def _interp_matrix_cached(t_o, t_n, kind):
    to = np.asarray(t_o, np.float64)
    tn = np.asarray(t_n, np.float64)
    if kind == 'cubic':
        return _cubic_notaknot_matrix(to, tn)
    if kind in _NATIVE:
        return _selection_matrix(to, tn, kind)
    # other kinds ('quadratic', 'slinear', integer orders, ...): interp1d
    # is linear in the data, so its action on the identity IS the matrix
    from scipy import interpolate
    return interpolate.interp1d(to, np.eye(to.size), kind=kind, axis=0,
                                copy=False, assume_sorted=True)(tn)


def interp_matrix(t_o, t_n, kind: str = 'cubic') -> np.ndarray:
    r"""The `(len(t_n), len(t_o))` float64 resampling matrix of SciPy
    ``interp1d`` semantics for ``kind``. ``t_o`` strictly increasing,
    ``t_n`` within ``[t_o[0], t_o[-1]]`` (no extrapolation). Cached on the
    grids and the kind (multi-scale design repeats them)."""
    to = np.asarray(t_o, np.float64)
    tn = np.asarray(t_n, np.float64)
    if to.ndim != 1 or tn.ndim != 1:
        raise ValueError(f'grids must be 1-d, got {to.shape}, {tn.shape}')
    if not np.all(np.diff(to) > 0):
        raise ValueError('t_o must be strictly increasing')
    if tn.size and (tn[0] < to[0] - 1e-12 or tn[-1] > to[-1] + 1e-12):
        raise ValueError('interp_matrix does not extrapolate')
    return _interp_matrix_cached(tuple(to.tolist()), tuple(tn.tolist()),
                                 kind)


def interp1d_apply(C, y, axis: int = -1):
    r"""Apply a resampling matrix along ``axis`` of ``y``:
    ``out[..., n, ...] = Σ_t C[n, t]·y[..., t, ...]``, one matrix product
    in ``y``'s dtype on ``y``'s device (in full float32 as long as
    ``torch.backends.cuda.matmul.allow_tf32`` stays False, its default),
    differentiable w.r.t. ``y``."""
    y = torch.as_tensor(y)
    Ct = torch.as_tensor(C, dtype=y.dtype, device=y.device)
    return torch.movedim(torch.movedim(y, axis, -1) @ Ct.T, -1, axis)
