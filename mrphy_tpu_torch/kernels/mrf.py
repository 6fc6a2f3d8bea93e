r"""The MRF matched-filter kernel: wrapper, plain PyTorch version and launch
count.

``match`` (``csrc/match.cu``, replaces ``_match_kernel`` of
:mod:`mrphy_tpu.ops.mrf_pallas`): for every probe ``x`` of ``X (nV, r)``
the best of the unit-norm atoms ``Dre (nA, r)``, scored ``|⟨d, x⟩|² =
(Dre·x)² + (Dim·x)²`` for re/im pair signals (``Dim``: the i-rotated
atoms) or the signed ``Dre·x`` for real ones. Returns ``(idx (nV,) int32,
best (nV,))``: the first atom of the maximum score (``argmax``'s tie rule)
and that score. The ``(nV, nA)`` score matrix never reaches device memory.

The plain version :func:`match_torch` is ``_match_flat``'s
(``mrf.py:180-213``): chunks of probes, one ``torch.matmul`` per chunk in
full float32 (no TF32, :func:`~mrphy_tpu_torch.kernels.signal.
full_f32_matmul`), then ``amax``/``argmax`` over the atoms; its peak memory
is the ``(chunk, nA)`` score tile. The two sum in other orders, so their
scores agree to rounding, and where two atoms' scores differ by less than
that the argmax may differ.

``LAUNCHES['match']`` rises by one at every launch of the kernel and
nowhere else. :func:`match` takes the plain version for CPU tensors and
launches the kernel for CUDA tensors (no fallback). Matching is a lookup
(argmax is piecewise constant): no gradient.
"""

import torch

from mrphy_tpu_torch.kernels.bloch import (_check, _device_kind, _ptr,
                                           _raise_on, _stream)
from mrphy_tpu_torch.kernels.signal import full_f32_matmul

__all__ = ['LAUNCHES', 'match', 'match_torch']

LAUNCHES = {'match': 0}


def match_torch(Dre, Dim, X, *, pairlike: bool, chunk: int):
    r"""Plain PyTorch version of the ``match`` kernel: ``chunk`` probes at a
    time, ``(idx (nV,) int32, best (nV,))``."""
    idx, best = [], []
    with full_f32_matmul():
        for c0 in range(0, X.shape[0], chunk):
            xc = X[c0:c0 + chunk]
            sre = torch.matmul(xc, Dre.T)
            if pairlike:
                sim = torch.matmul(xc, Dim.T)
                mag = sre * sre + sim * sim    # |⟨d̂,x⟩|² per (voxel, atom)
            else:
                mag = sre                      # signed real correlation
            best.append(torch.amax(mag, dim=-1))
            idx.append(torch.argmax(mag, dim=-1).to(torch.int32))
    return torch.cat(idx), torch.cat(best)


def _launch_match(Dre, Dim, X, pairlike):
    from mrphy_tpu_torch.kernels._build import library
    if X.dtype not in (torch.float32, torch.float64):
        raise TypeError(f'match takes float32 or float64, not {X.dtype}')
    (nA, r), nV = Dre.shape, X.shape[0]
    for x, name, shape in ((Dre, 'Dre', (nA, r)), (X, 'X', (nV, r))) + (
            ((Dim, 'Dim', (nA, r)),) if pairlike else ()):
        _check(x, name, shape, X.dtype, X.device)
    idx = torch.empty(nV, dtype=torch.int32, device=X.device)
    best = torch.empty(nV, dtype=X.dtype, device=X.device)
    lib, _ = library()
    fn = (lib.mrphy_match_f32 if X.dtype == torch.float32
          else lib.mrphy_match_f64)
    with torch.cuda.device(X.device):
        err = fn(*map(_ptr, (Dre, Dim if pairlike else None, X, idx, best)),
                 nA, nV, r, _stream(X.device))
    _raise_on(err, 'match')
    LAUNCHES['match'] += 1
    return idx, best


def match(Dre, Dim, X, *, pairlike: bool):
    r"""The ``match`` kernel on CUDA tensors (contiguous, one dtype, float32
    or float64), :func:`match_torch` on CPU tensors (all probes in one
    chunk)."""
    if _device_kind(X) == 'cpu':
        return match_torch(Dre, Dim, X, pairlike=pairlike,
                           chunk=max(1, X.shape[0]))
    return _launch_match(Dre, Dim, X, pairlike)
