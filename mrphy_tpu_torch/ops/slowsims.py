r"""Bloch simulation with implicit (autograd) Jacobians — the oracle engine
(counterpart of :mod:`mrphy_tpu.ops.slowsims`).

A plain Python time loop over the composed helpers (``beff2uphi`` +
``uphirot`` + relaxation), differentiable by torch autograd. It is the
correctness oracle the fast engine (:mod:`mrphy_tpu_torch.ops.sims`) is
tested against. ``blochsim_ab``, ``blochsim_segmented``,
``blochsim_tparallel`` and the two-pool ``blochsim_mc`` are not ported
yet.
"""

from typing import Optional

import torch

from mrphy_tpu_torch import gamH, dt0, pi
from mrphy_tpu_torch._kwalias import kwalias
from mrphy_tpu_torch.ops import beffective
from mrphy_tpu_torch.utils import uphirot
from mrphy_tpu_torch.utils._shapes import asarr, rshape

__all__ = ['blochsim_1step', 'blochsim', 'freeprec']


@kwalias(**{'γ2πdt': 'gam2pidt'})
def blochsim_1step(M, M1, b, E1, E1_1, E2, gam2pidt):
    r"""Single Bloch step: rotation by B-effective + relaxation.

    Inputs:
        - ``M``: `(N, *Nd, xyz)`, spins.
        - ``M1``: ignored (the reference's pre-allocated output buffer;
          kept for call compatibility).
        - ``b``: `(N, *Nd, xyz)`, "Gauss", B-effective of this step.
        - ``E1``, ``E1_1`` (=E1-1), ``E2``: `()` ⊻ `(N ⊻ 1, *Nd ⊻ 1,)`.
        - ``gam2pidt`` (alias ``γ2πdt``): `()` ⊻ broadcastable, "Rad/Gauss".
    Outputs:
        - ``(M, M1)``: stepped spins, and the previous spins.
    """
    M = torch.as_tensor(M)
    u, phi = beffective.beff2uphi(b, gam2pidt)
    Mr = uphirot(u, phi, M)
    E1, E1_1, E2 = (asarr(x, M) for x in (E1, E1_1, E2))
    Mnew = torch.cat([Mr[..., 0:2] * E2[..., None],
                      (Mr[..., 2] * E1 - E1_1)[..., None]], dim=-1)
    return Mnew, M


@kwalias(**{'γ': 'gam'})
def blochsim(M, Beff, *, T1: Optional[torch.Tensor] = None,
             T2: Optional[torch.Tensor] = None, gam=gamH, dt=dt0):
    r"""Bloch simulator with implicit (autograd) Jacobians.

    Inputs:
        - ``M``: `(N, *Nd, xyz)`, spins (equilibrium ``[0, 0, 1]``).
        - ``Beff``: `(N, *Nd, nT, xyz)`, "Gauss".
    Optionals:
        - ``T1``/``T2``: `()` ⊻ `(N ⊻ 1, *Nd ⊻ 1,)`, "Sec"; pass both
          ``None`` to ignore relaxation.
        - ``gam`` (alias ``γ``): `()` ⊻ `(N ⊻ 1, *Nd ⊻ 1,)`, "Hz/Gauss".
        - ``dt``: `()` ⊻ `(N ⊻ 1,)`, "Sec".
    Outputs:
        - ``M``: `(N, *Nd, xyz)`, spins after the pulse.
    """
    M, Beff = torch.as_tensor(M), torch.as_tensor(Beff)
    if M.shape[:-1] != Beff.shape[:-2]:
        raise ValueError(f'M {tuple(M.shape)} and Beff {tuple(Beff.shape)} '
                         'disagree on (N, *Nd)')
    if (T1 is None) != (T2 is None):
        raise ValueError('pass both T1 and T2, or neither')
    ndim = M.ndim - 1

    one = torch.ones((), dtype=M.dtype, device=M.device)
    dt_r = rshape(asarr(dt, M), ndim)
    E1 = one if T1 is None else torch.exp(-dt_r / rshape(asarr(T1, M), ndim))
    E2 = one if T2 is None else torch.exp(-dt_r / rshape(asarr(T2, M), ndim))
    # expm1, not exp()-1: E1 ≈ 1-4e-6 at µs dwell times and the
    # subtraction cancels catastrophically in f32
    E1_1 = (torch.zeros_like(one) if T1 is None
            else torch.expm1(-dt_r / rshape(asarr(T1, M), ndim)))
    gam2pidt = 2 * pi * rshape(asarr(gam, M), ndim) * dt_r

    for t in range(Beff.shape[-2]):
        M, _ = blochsim_1step(M, None, Beff[..., t, :], E1, E1_1, E2,
                              gam2pidt)
    return M


@kwalias(**{'Δf': 'df'})
def freeprec(M, dur, *, T1=None, T2=None, df=None):
    r"""Free precession with relaxation and off-resonance (closed form).

    Inputs:
        - ``M``: `(N, *Nd, xyz)`, spins.
        - ``dur``: `()` ⊻ `(N ⊻ 1,)`, "Sec", duration.
    Optionals:
        - ``T1``/``T2``: `()` ⊻ `(N ⊻ 1, *Nd ⊻ 1,)`, "Sec" (both or neither).
        - ``df`` (alias ``Δf``): `(N ⊻ 1, *Nd ⊻ 1,)`, "Hz"; positive ``df``
          dephases clockwise (negative φ).
    Outputs:
        - ``M``: `(N, *Nd, xyz)`.
    """
    M = torch.as_tensor(M)
    ndim = M.ndim
    dur = rshape(asarr(dur, M), ndim)

    Mx, My, Mz = M[..., 0:1], M[..., 1:2], M[..., 2:3]

    if df is not None:
        phi = -(2 * pi) * rshape(asarr(df, M), ndim) * dur
        cphi, sphi = torch.cos(phi), torch.sin(phi)
        Mx, My = cphi * Mx - sphi * My, sphi * Mx + cphi * My

    if (T1 is None) != (T2 is None):
        raise ValueError('pass both T1 and T2, or neither')
    if T1 is not None:
        T1, T2 = rshape(asarr(T1, M), ndim), rshape(asarr(T2, M), ndim)
        E1, E2 = torch.exp(-dur / T1), torch.exp(-dur / T2)
        Mx, My, Mz = E2 * Mx, E2 * My, E1 * Mz + 1 - E1

    return torch.cat((Mx, My, Mz), dim=-1)
