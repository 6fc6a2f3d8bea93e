r"""MR fingerprinting: dictionary compression, matching and refinement
(counterpart of :mod:`mrphy_tpu.ops.mrf`, its matching half).

- **Signals are real re/im pairs** ``(..., nTR, 2)``, as in the JAX
  package: complex arithmetic (modulus matching, phase-invariant scores,
  complex proton density) is spelled out in pair arithmetic. Plain real
  signals ``(..., nT)`` work too (``pair`` auto-detected from the trailing
  2).
- **Matching** (:func:`dict_match`, :func:`dict_match_compressed`): on CUDA
  tensors with ``backend='auto'`` (or ``'cuda'``) the fused matched-filter
  kernel ``match`` (:mod:`mrphy_tpu_torch.kernels.mrf`) at every size: the
  score matrix never reaches device memory. ``backend='torch'`` and CPU
  tensors take its plain version, probe chunks of one ``torch.matmul``
  each (full float32: no TF32) and an ``argmax`` per row; the peak memory
  is the ``(chunk, nA)`` score tile.
- **Compression** (:func:`svd_basis`, :func:`compress`) is a Gram
  eigendecomposition (McGivney et al., IEEE TMI 33(12):2311, 2014), in the
  dictionary's dtype; for pair signals the Gram is augmented with the
  i-rotated atoms, so the retained (even-rank) subspace is J-invariant and
  complex inner products survive compression through ``J_c = BᵀJB``.
- **Refinement** (:func:`match_refine`): Adam (``torch.optim.Adam``, optax's
  update) through the signal model, started from the matched atoms.

``mesh=`` raises (multi-device runs are not ported yet). The k-space half
of the JAX module (``subspace_*``, ``kspace_subspace_recon``,
``slice_profile_integrate``) is not ported yet.
"""

from typing import Callable, NamedTuple, Optional

import torch

from mrphy_tpu_torch.kernels import mrf as kmrf
from mrphy_tpu_torch.kernels.signal import full_f32_matmul

__all__ = ['Basis', 'MatchResult', 'pair_rotate', 'svd_basis', 'compress',
           'dict_match', 'dict_match_compressed', 'match_refine']


class Basis(NamedTuple):
    r"""Temporal subspace basis from :func:`svd_basis`.

    - ``B``: `(nT, r)` orthonormal columns in the FLATTENED real signal
      space (``nT = nTR·2`` for pair signals).
    - ``jc``: `(r, r)` compressed i-rotation ``BᵀJB`` (pair signals;
      ``None`` for plain real dictionaries).
    - ``s``: `(nT,)` full singular-value spectrum (descending) of the
      (J-augmented) dictionary.
    - ``tail``: trailing signal shape the basis was built from, e.g.
      ``(nTR, 2)``; :func:`compress` checks inputs against it.
    """
    B: torch.Tensor
    jc: Optional[torch.Tensor]
    s: torch.Tensor
    tail: tuple


class MatchResult(NamedTuple):
    r"""Per-voxel match from :func:`dict_match`.

    - ``idx``: `(*batch,)` int32, the best atom.
    - ``score``: `(*batch,)`, ``|⟨d̂, x⟩|`` against the unit-norm atom
      (signed ``⟨d̂, x⟩`` for plain real signals).
    - ``m0``: `(*batch, 2)` re/im pair, the least-squares complex scale
      ``⟨d, x⟩/‖d‖²`` (proton density × receive phase); the im half is
      zero for plain real signals.
    """
    idx: torch.Tensor
    score: torch.Tensor
    m0: torch.Tensor


def _is_pair(x, pair):
    if pair is not None:
        return bool(pair)
    return x.ndim >= 1 and x.shape[-1] == 2


def pair_rotate(x):
    r"""Multiply a re/im pair signal by i: ``(re, im) → (−im, re)``.

    The rotation operator J of the pair representation; antisymmetric,
    ``J² = −I``. ``Im⟨d, x⟩ = (Jd)·x`` under the flattened real dot."""
    return torch.stack([-x[..., 1], x[..., 0]], -1)


def _flatten(x, tail_ndim):
    batch = tuple(x.shape[:x.ndim - tail_ndim])
    return x.reshape(batch + (-1,)), batch


def svd_basis(D, rank: Optional[int] = None, energy: float = 0.9999,
              pair: Optional[bool] = None) -> Basis:
    r"""Temporal subspace of a dictionary (SVD compression basis).

    One-shot (dictionary prep): the rank chosen from ``energy`` is
    data-dependent. Cost is one ``(nT, nA)·(nA, nT)`` Gram product and an
    ``eigh(nT)``, in ``D``'s dtype.

    Inputs:
        - ``D``: `(nA, nTR, 2)` pair signals (or `(nA, nT)` real).
    Optionals:
        - ``rank``: subspace size; default: the smallest rank capturing
          ``energy`` of the spectrum. Pair bases round up to EVEN rank
          (J-invariance needs the conjugate partner of every direction).
        - ``energy``: retained spectral energy (squared singular values)
          when ``rank`` is None.
    Outputs:
        - :class:`Basis`.
    """
    D = torch.as_tensor(D)
    p = _is_pair(D, pair)
    tail = tuple(D.shape[1:])
    Df, _ = _flatten(D, len(tail))
    nT = Df.shape[1]
    with full_f32_matmul():
        G = torch.matmul(Df.T, Df)
        if p:
            Jf = pair_rotate(Df.reshape(D.shape)).reshape(Df.shape)
            G = G + torch.matmul(Jf.T, Jf)
    vals, vecs = torch.linalg.eigh(G)
    vals, vecs = vals.flip(0), vecs.flip(1)
    vals = torch.clamp_min(vals, 0.0)
    if rank is None:
        cum = torch.cumsum(vals, 0)
        r = int(torch.searchsorted(cum, energy * cum[-1])) + 1
    else:
        r = int(rank)
    if p:
        r = min(nT, r + (r % 2))
    r = max(1, min(nT, r))
    B = vecs[:, :r]
    jc = None
    if p:
        JB = pair_rotate(B.T.reshape((r,) + tail)).reshape(r, nT).T
        with full_f32_matmul():
            jc = torch.matmul(B.T, JB)
    return Basis(B=B, jc=jc, s=torch.sqrt(vals), tail=tail)


def compress(x, basis: Basis):
    r"""Project signals onto a :class:`Basis`: `(..., *tail)` → `(...,
    r)`. Inner products (and, for pair bases, complex inner products via
    ``basis.jc``) are preserved up to the discarded spectral energy."""
    x = torch.as_tensor(x)
    tail = basis.tail
    if tuple(x.shape[x.ndim - len(tail):]) != tuple(tail):
        raise ValueError(f'signal tail {tuple(x.shape)} does not match the '
                         f'basis {tail}')
    xf, batch = _flatten(x, len(tail))
    with full_f32_matmul():
        out = torch.matmul(xf, basis.B)
    return out.reshape(batch + (out.shape[-1],))


def _pick_chunk(nV: int, nA: int) -> int:
    r"""Probe-chunk size of the plain matcher: cap the live `(chunk, nA)`
    score tile at ~256M elements (1 GB in float32), at least 256 rows."""
    c = max(256, (1 << 28) // max(1, nA))
    return min(nV, c)


def _use_kernel(backend: str, X) -> bool:
    if backend == 'auto':
        return X.device.type == 'cuda'
    if backend == 'cuda':
        if X.device.type != 'cuda':
            raise ValueError("backend='cuda' needs CUDA tensors, got "
                             f'{X.device}')
        return True
    if backend != 'torch':
        raise ValueError(f'unknown backend {backend!r}')
    return False


def _match_flat(Dre, Dim, X, nrm, *, chunk_probes: Optional[int],
                pairlike: bool, kernel: bool):
    r"""Argmax match in the flattened (or compressed) space.

    ``Dre``/``Dim``: `(nA, nT)` unit-norm atoms (+ their i-rotation;
    ignored when not pairlike). ``X``: `(nV, nT)` probes. The search is the
    ``match`` kernel (``kernel``) or its plain version, probe chunks
    (``chunk_probes``, default :func:`_pick_chunk`) of one matrix product
    each; ``m0`` comes after it from the winning atoms."""
    args = (Dre.contiguous(), Dim.contiguous() if pairlike else None,
            X.contiguous())
    if kernel:
        idx, best = kmrf.match(*args, pairlike=pairlike)
    else:
        chunk = int(chunk_probes or _pick_chunk(X.shape[0], Dre.shape[0]))
        idx, best = kmrf.match_torch(*args, pairlike=pairlike, chunk=chunk)
    return _finish_match(Dre, Dim, X, nrm, idx, best, pairlike=pairlike)


def _finish_match(Dre, Dim, X, nrm, idx, best, *, pairlike: bool):
    r"""score/m0 from the winning atom per probe: one row-gather, then
    row-wise dots."""
    score = torch.sqrt(torch.clamp_min(best, 0.0)) if pairlike else best
    i = idx.long()
    re = torch.sum(Dre[i] * X, -1)
    im = torch.sum(Dim[i] * X, -1) if pairlike else torch.zeros_like(re)
    m0 = torch.stack([re, im], -1) / torch.clamp_min(nrm[i], 1e-30)[:, None]
    return idx, score, m0


def _prep_dict(D, pair):
    r"""`(nA, *tail)` dictionary → unit-norm flat rows (+ i-rotation for
    pairs) and the original row norms."""
    D = torch.as_tensor(D)
    p = _is_pair(D, pair)
    tail = tuple(D.shape[1:])
    Df, _ = _flatten(D, len(tail))
    nrm = torch.linalg.vector_norm(Df, dim=1)
    Dn = Df / torch.clamp_min(nrm, 1e-30)[:, None]
    Dim = (pair_rotate(Dn.reshape((Dn.shape[0],) + tail)).reshape(Dn.shape)
           if p else Dn[:0])
    return Dn, Dim, nrm, p, tail


def dict_match(D, probes, *, chunk_probes: Optional[int] = None,
               pair: Optional[bool] = None, backend: str = 'auto',
               mesh=None) -> MatchResult:
    r"""Matched-filter dictionary search.

    Inputs:
        - ``D``: `(nA, nTR, 2)` pair dictionary (or `(nA, nT)` real).
        - ``probes``: `(*batch, nTR, 2)` (or `(*batch, nT)`) measured
          evolutions, any voxel batch shape.
    Optionals:
        - ``chunk_probes``: probes per score tile of the plain route
          (memory knob; default caps it at ~1 GB in float32).
        - ``pair``: force/deny pair (re/im) semantics; default
          auto-detects a trailing axis of 2.
        - ``backend``: ``'auto'`` (the kernel for CUDA tensors, the plain
          route for CPU tensors), ``'torch'``, ``'cuda'``.
        - ``mesh``: multi-device runs are not ported yet (raises
          :class:`NotImplementedError`).
    Outputs:
        - :class:`MatchResult` with ``idx``/``score``/``m0`` shaped like
          the probe batch.

    Pair matching maximizes the COMPLEX modulus ``|⟨d̂, x⟩|``: the result
    is invariant to per-voxel receive phase, which lands in ``m0``.
    """
    if mesh is not None:
        raise NotImplementedError('mesh= (multi-device runs) is not ported '
                                  'to mrphy_tpu_torch yet')
    Dn, Dim, nrm, p, tail = _prep_dict(D, pair)
    probes = torch.as_tensor(probes)
    Xf, batch = _flatten(probes, len(tail))
    if Xf.shape[-1] != Dn.shape[-1]:
        raise ValueError(f'probes {tuple(probes.shape)} and dictionary '
                         f'{tuple(Dn.shape)} disagree on the signal length')
    Xf = Xf.reshape(-1, Xf.shape[-1])
    idx, score, m0 = _match_flat(Dn, Dim, Xf, nrm, chunk_probes=chunk_probes,
                                 pairlike=p, kernel=_use_kernel(backend, Xf))
    return MatchResult(idx.reshape(batch), score.reshape(batch),
                       m0.reshape(batch + (2,)))


def dict_match_compressed(Dc, probes, basis: Basis, *,
                          chunk_probes: Optional[int] = None,
                          backend: str = 'auto', mesh=None) -> MatchResult:
    r"""Dictionary search in the compressed subspace.

    Inputs:
        - ``Dc``: `(nA, r)` compressed dictionary (``compress(D, basis)``).
        - ``probes``: raw `(*batch, *tail)` signals (compressed
          internally) or already-compressed `(*batch, r)` coefficients.
        - ``basis``: the :class:`Basis` that produced ``Dc``.
    Optionals: as :func:`dict_match`.

    Complex scores survive compression because the pair basis is
    J-invariant: ``Im⟨d, x⟩ ≈ (J_c d_c)·x_c`` with ``J_c = basis.jc``.
    """
    if mesh is not None:
        raise NotImplementedError('mesh= (multi-device runs) is not ported '
                                  'to mrphy_tpu_torch yet')
    Dc = torch.as_tensor(Dc)
    probes = torch.as_tensor(probes)
    tail = basis.tail
    r = basis.B.shape[1]
    if tuple(probes.shape[probes.ndim - len(tail):]) == tuple(tail):
        Xc = compress(probes, basis)
    elif probes.shape[-1] == r:
        Xc = probes
    else:
        raise ValueError(f'probes {tuple(probes.shape)} are neither signals '
                         f'{tail} nor coefficients of rank {r}')
    Xf, batch = _flatten(Xc, 1)
    Xf = Xf.reshape(-1, Xf.shape[-1])
    nrm = torch.linalg.vector_norm(Dc, dim=1)
    Dn = Dc / torch.clamp_min(nrm, 1e-30)[:, None]
    p = basis.jc is not None
    if p:
        with full_f32_matmul():
            Dim = torch.matmul(Dn, basis.jc.T)
    else:
        Dim = Dn[:0]
    idx, score, m0 = _match_flat(Dn, Dim, Xf, nrm, chunk_probes=chunk_probes,
                                 pairlike=p, kernel=_use_kernel(backend, Xf))
    return MatchResult(idx.reshape(batch), score.reshape(batch),
                       m0.reshape(batch + (2,)))


def match_refine(signal_fn: Callable, p0, probes, *, iters: int = 200,
                 lr: float = 0.02, pair: Optional[bool] = None,
                 batched: bool = False):
    r"""Continuous parameter refinement through the signal model.

    The dictionary quantizes parameters to its grid; Adam through the
    simulator, started from the matched atom, recovers continuous values
    below grid resolution. Scale- and (for pairs) phase-invariant loss:
    ``−|⟨ŝ(p), x̂⟩|``.

    Inputs:
        - ``signal_fn``: maps ONE parameter vector `(nP,)` to its signal
          `(*tail)` (e.g. ``lambda p: epg_spgr(flips, phis,
          T1=exp(p[0]), T2=exp(p[1]), tr=tr)``); the per-voxel losses are
          summed and differentiated together (JAX vmaps it). With
          ``batched=True`` it instead maps the WHOLE `(nVox, nP)` parameter
          array to `(nVox, *tail)` signals, one train per iteration (on
          CUDA tensors ``epg_spgr`` then runs its kernels, forward and
          adjoint). The gradients are the same either way.
        - ``p0``: `(*batch, nP)` starting parameters (matched atoms).
        - ``probes``: `(*batch, *tail)` measured evolutions.
    Optionals:
        - ``iters``/``lr``: the Adam schedule.
    Outputs:
        - ``p``: `(*batch, nP)` refined parameters.
        - ``score``: `(*batch,)` final correlation (1 = perfect fit).
    """
    p0 = torch.as_tensor(p0)
    probes = torch.as_tensor(probes)
    nP = p0.shape[-1]
    batch = tuple(p0.shape[:-1])
    P = p0.reshape(-1, nP).detach().clone().requires_grad_(True)
    with torch.no_grad():
        probe0 = signal_fn(P[:1]) if batched else signal_fn(P[0])
    tail = tuple(probe0.shape[1:]) if batched else tuple(probe0.shape)
    pr = _is_pair(probe0, pair)
    if tuple(probes.shape[probes.ndim - len(tail):]) != tail:
        raise ValueError(f'probes {tuple(probes.shape)} do not end in the '
                         f'signal shape {tail}')
    Xf = probes.reshape((-1,) + tail)
    Xf = Xf.reshape(Xf.shape[0], -1)
    Xn = Xf / torch.clamp_min(torch.linalg.vector_norm(Xf, dim=1,
                                                       keepdim=True), 1e-30)
    Xjn = (pair_rotate(Xn.reshape((-1,) + tail)).reshape(Xn.shape) if pr
           else torch.zeros_like(Xn))

    def corr(S):
        S = S / torch.clamp_min(torch.linalg.vector_norm(S, dim=1,
                                                         keepdim=True), 1e-30)
        re = torch.sum(S * Xn, -1)
        if not pr:
            return re
        im = torch.sum(S * Xjn, -1)
        return torch.sqrt(re * re + im * im + 1e-30)

    def signals(P):
        if batched:
            return signal_fn(P).reshape(P.shape[0], -1)
        return torch.stack([signal_fn(p).reshape(-1) for p in P.unbind(0)])

    opt = torch.optim.Adam([P], lr=lr)
    for _ in range(iters):
        opt.zero_grad()
        # the per-voxel losses are independent: the gradient of their sum
        # carries every voxel's own gradient
        (-torch.sum(corr(signals(P)))).backward()
        opt.step()
    with torch.no_grad():
        score = corr(signals(P))
    return P.detach().reshape(batch + (nP,)), score.reshape(batch)
