r"""Specific-absorption-rate (SAR) machinery for pTx design (counterpart
of :mod:`mrphy_tpu.utils.sar`).

The local SAR of a coil array at a position is a quadratic form over the
per-coil complex drive, ``z(t)^H Q z(t)``; virtual observation points
(VOPs, Eichfelder & Gebhardt, MRM 66:1468, 2011) compress millions of
such matrices to a few hundred. :func:`sar_vops` evaluates the VOPs'
time-averaged SAR with each Hermitian ``Q = Qr + i·Qi`` split into its
symmetric real and antisymmetric imaginary parts,
``z^H Q z = x^T Qr x + y^T Qr y + 2 y^T Qi x`` for ``z = x + i·y``;
:func:`vop_compress` builds them (numpy, one-time preprocessing).
"""

from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ['sar_vops', 'vop_compress']


def sar_vops(rf, Qr, Qi: Optional[torch.Tensor] = None):
    r"""Time-averaged SAR at each virtual observation point,
    ``S[n, v] = (1/nT) Σ_t z_t^H Q_v z_t`` for ``z_t = rf[n, 0, t, :] +
    i·rf[n, 1, t, :]``.

    Inputs:
        - ``rf``: `(N, xy, nT, (nCoils))`, "Gauss" (a missing coil dim
          means one coil).
        - ``Qr``: `(nVOP, nCoils, nCoils)`, symmetric real parts.
    Optionals:
        - ``Qi``: `(nVOP, nCoils, nCoils)`, antisymmetric imaginary parts.
    Outputs:
        - ``S``: `(N, nVOP)`, in the units of ``Q`` times Gauss².

    Matrix products in ``rf``'s dtype: full float32 on the card as long as
    ``torch.backends.cuda.matmul.allow_tf32`` stays False (its default).
    """
    rf = torch.as_tensor(rf)
    if rf.ndim == 3:
        rf = rf[..., None]
    Qr = torch.as_tensor(Qr, dtype=rf.dtype, device=rf.device)
    x, y = rf[:, 0], rf[:, 1]                       # (N, nT, nCoils)
    s = (torch.einsum('ntc,vcd,ntd->nv', x, Qr, x)
         + torch.einsum('ntc,vcd,ntd->nv', y, Qr, y))
    if Qi is not None:
        Qi = torch.as_tensor(Qi, dtype=rf.dtype, device=rf.device)
        s = s + 2.0 * torch.einsum('ntc,vcd,ntd->nv', y, Qi, x)
    return s / x.shape[-2]


def _split_hermitian(Q: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    Qr = np.real(Q)
    Qi = np.imag(Q)
    return 0.5 * (Qr + np.swapaxes(Qr, -1, -2)), \
        0.5 * (Qi - np.swapaxes(Qi, -1, -2))


def vop_compress(Q: np.ndarray, eps: float,
                 max_iter: Optional[int] = None
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    r"""Greedy virtual-observation-point compression (numpy).

    Reduces Hermitian PSD SAR matrices to a subset ``{V_k}`` such that for
    every input ``Q_j`` some VOP has ``V_k + eps·λ̄·I − Q_j ⪰ 0`` (λ̄ the
    largest spectral norm of the set): positions sorted by norm, first-fit
    dominance by a minimum-eigenvalue test.

    Inputs:
        - ``Q``: `(nPos, nCoils, nCoils)`, complex (or real) Hermitian PSD.
        - ``eps``: relative over-estimation margin (e.g. ``0.05``).
    Optionals:
        - ``max_iter``: cap on the number of VOPs (None: no cap); past it,
          a matrix is added onto its nearest VOP (the bound holds, looser).
    Outputs:
        - ``(Qr, Qi, idx)``: `(nVOP, nCoils, nCoils)` symmetric and
          antisymmetric parts for :func:`sar_vops`, with the ``eps·λ̄·I``
          margin folded in, and the selected position indices.
    """
    Q = np.asarray(Q)
    if Q.ndim != 3 or Q.shape[-1] != Q.shape[-2]:
        raise ValueError(f'Q must be (nPos, nCoils, nCoils), got {Q.shape}')
    n = Q.shape[0]
    norms = np.linalg.norm(Q, ord=2, axis=(-2, -1))
    lam_bar = float(norms.max()) if n else 0.0
    order = np.argsort(-norms)
    margin = eps * lam_bar * np.eye(Q.shape[-1])
    vops: list = []
    idx: list = []
    for j in order:
        dominated = False
        for V in vops:
            # V + margin − Q_j ⪰ 0 ⇔ min eig ≥ 0 (with a tolerance for the
            # eigensolver's rounding)
            w = np.linalg.eigvalsh(V + margin - Q[j])
            if w[0] >= -1e-12 * max(lam_bar, 1.0):
                dominated = True
                break
        if not dominated:
            if max_iter is not None and len(vops) >= max_iter:
                k = int(np.argmin([np.linalg.norm(V - Q[j], ord=2)
                                   for V in vops]))
                vops[k] = vops[k] + Q[j]
            else:
                vops.append(Q[j].copy())
                idx.append(int(j))
    V = np.stack(vops) if vops else np.zeros((0,) + Q.shape[1:], Q.dtype)
    Qr, Qi = _split_hermitian(V + margin)
    return Qr, Qi, np.asarray(idx, np.int64)
