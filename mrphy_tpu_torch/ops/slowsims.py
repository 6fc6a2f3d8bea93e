r"""Bloch simulation with implicit (autograd) Jacobians — the oracle engine
(counterpart of :mod:`mrphy_tpu.ops.slowsims`).

A plain Python time loop over the composed helpers (``beff2uphi`` +
``uphirot`` + relaxation), differentiable by torch autograd. It is the
correctness oracle the fast engine (:mod:`mrphy_tpu_torch.ops.sims`) is
tested against; :func:`blochsim_segmented` is the same loop with
time-segmented rematerialization, :func:`blochsim_tparallel` composes the
per-step affine maps in a pairwise tree, and :func:`blochsim_mc` is the
two-pool Bloch–McConnell oracle of :mod:`mrphy_tpu_torch.ops.mc`.
"""

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from mrphy_tpu_torch import gamH, dt0, pi
from mrphy_tpu_torch._kwalias import kwalias
from mrphy_tpu_torch.ops import beffective
from mrphy_tpu_torch.utils import uphirot
from mrphy_tpu_torch.utils._shapes import asarr, rshape

__all__ = ['blochsim_1step', 'blochsim', 'blochsim_ab',
           'blochsim_segmented', 'blochsim_tparallel', 'blochsim_mc',
           'mc_propagators', 'freeprec']


def _refuse_mesh(mesh):
    if mesh is not None:
        raise NotImplementedError('mesh= (multi-device runs) is not ported '
                                  'to mrphy_tpu_torch yet')


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


def _relaxation(M, Beff, T1, T2, dt):
    r"""Validate ``M``/``Beff``/``T1``/``T2``; return the per-step factors
    ``(E1, E2, E1 − 1)``, ``(1, 1, 0)`` without relaxation."""
    if M.shape[:-1] != Beff.shape[:-2]:
        raise ValueError(f'M {tuple(M.shape)} and Beff {tuple(Beff.shape)} '
                         'disagree on (N, *Nd)')
    if (T1 is None) != (T2 is None):
        raise ValueError('pass both T1 and T2, or neither')
    ndim = M.ndim - 1
    one = torch.ones((), dtype=M.dtype, device=M.device)
    if T1 is None:
        return one, one, torch.zeros_like(one)
    dt_r = rshape(asarr(dt, M), ndim)
    E1 = torch.exp(-dt_r / rshape(asarr(T1, M), ndim))
    E2 = torch.exp(-dt_r / rshape(asarr(T2, M), ndim))
    # expm1, not exp()-1: E1 ≈ 1-4e-6 at µs dwell times and the
    # subtraction cancels catastrophically in f32
    return E1, E2, torch.expm1(-dt_r / rshape(asarr(T1, M), ndim))


@kwalias(**{'γ': 'gam'})
def blochsim(M, Beff, *, T1: Optional[torch.Tensor] = None,
             T2: Optional[torch.Tensor] = None, gam=gamH, dt=dt0,
             mesh=None):
    r"""Bloch simulator with implicit (autograd) Jacobians.

    Inputs:
        - ``M``: `(N, *Nd, xyz)`, spins (equilibrium ``[0, 0, 1]``).
        - ``Beff``: `(N, *Nd, nT, xyz)`, "Gauss".
    Optionals:
        - ``T1``/``T2``: `()` ⊻ `(N ⊻ 1, *Nd ⊻ 1,)`, "Sec"; pass both
          ``None`` to ignore relaxation.
        - ``gam`` (alias ``γ``): `()` ⊻ `(N ⊻ 1, *Nd ⊻ 1,)`, "Hz/Gauss".
        - ``dt``: `()` ⊻ `(N ⊻ 1,)`, "Sec".
        - ``mesh``: multi-device runs are not ported yet (raises
          :class:`NotImplementedError`).
    Outputs:
        - ``M``: `(N, *Nd, xyz)`, spins after the pulse.
    """
    _refuse_mesh(mesh)
    M, Beff = torch.as_tensor(M), torch.as_tensor(Beff)
    E1, E2, E1_1 = _relaxation(M, Beff, T1, T2, dt)
    ndim = M.ndim - 1
    gam2pidt = 2 * pi * rshape(asarr(gam, M), ndim) * rshape(asarr(dt, M),
                                                             ndim)
    for t in range(Beff.shape[-2]):
        M, _ = blochsim_1step(M, None, Beff[..., t, :], E1, E1_1, E2,
                              gam2pidt)
    return M


@kwalias(**{'γ': 'gam'})
def blochsim_segmented(M, Beff, *, T1=None, T2=None, gam=gamH, dt=dt0,
                       segments: int = 8):
    r"""Time-segmented, rematerialized Bloch simulation.

    Same result as :func:`blochsim`, but the time axis is split into
    ``segments`` chunks, each run under :func:`torch.utils.checkpoint.
    checkpoint`: the backward keeps only the segment-boundary states and
    recomputes within a segment. ``nT`` must be divisible by ``segments``.
    """
    M, Beff = torch.as_tensor(M), torch.as_tensor(Beff)
    nT = Beff.shape[-2]
    if nT % segments:
        raise ValueError(f'nT={nT} not divisible by segments={segments}')

    def run_segment(m, beff_seg):
        return blochsim(m, beff_seg, T1=T1, T2=T2, gam=gam, dt=dt)

    for beff_seg in Beff.split(nT // segments, dim=-2):
        M = checkpoint(run_segment, M, beff_seg, use_reentrant=False)
    return M


def blochsim_ab(M, A, B):
    r"""Apply a Hargreaves affine propagator: ``M → A·M + B``.

    Inputs:
        - ``M``: `(N, *Nd, xyz)`; ``A``: `(N, *Nd, xyz, 3)`;
          ``B``: `(N, *Nd, xyz)`.
    Outputs:
        - ``M``: `(N, *Nd, xyz)`.

    The contraction over xyz is written out elementwise (no float32
    matrix product, so no TF32).
    """
    M, A, B = (torch.as_tensor(x) for x in (M, A, B))
    return torch.sum(A * M[..., None, :], dim=-1) + B


@kwalias(**{'γ': 'gam'})
def blochsim_tparallel(M, Beff, *, T1=None, T2=None, gam=gamH, dt=dt0):
    r"""Parallel-in-time Bloch simulation: composes the per-step affine
    maps by pairwise tree reduction
    (:func:`mrphy_tpu_torch.ops.beffective.beff2ab_assoc`) and applies the
    resulting propagator. Same signature and result as :func:`blochsim`;
    it holds 12 planes of `(nT, nSpins)` at the first tree level.
    """
    M, Beff = torch.as_tensor(M), torch.as_tensor(Beff)
    E1, E2, _ = _relaxation(M, Beff, T1, T2, dt)
    A, B = beffective.beff2ab_assoc(Beff, E1=E1, E2=E2, gam=gam, dt=dt)
    return blochsim_ab(M, A, B)


def _expm2(a, b, c, d):
    r"""Closed-form matrix exponential of a 2×2 (batched elementwise):
    ``expm([[a, b], [c, d]])`` = ``e^μ (cosh(q) I + sinh(q)/q (A − μI))``,
    ``μ = (a+d)/2``, ``q² = ((a−d)/2)² + bc``; for exchange matrices ``bc
    ≥ 0``, so ``q`` is real. Near ``q = 0`` the Taylor terms stand in.
    Returns ``(E00, E01, E10, E11)``."""
    mu = 0.5 * (a + d)
    dev = 0.5 * (a - d)
    q2 = dev * dev + b * c
    # two wheres: a single one keeps sqrt in the graph at q2 = 0, and its
    # infinite derivative times the unused branch's 0 is NaN (the gradient
    # w.r.t. kab at zero exchange with T2a == T2b, a natural fitting init)
    safe = q2 > 1e-16
    q = torch.sqrt(torch.where(safe, q2, torch.ones_like(q2)))
    ch = torch.where(safe, torch.cosh(q), 1.0 + q2 / 2.0)
    shq = torch.where(safe, torch.sinh(q) / q, 1.0 + q2 / 6.0)
    em = torch.exp(mu)
    return (em * (ch + shq * dev), em * (shq * b),
            em * (shq * c), em * (ch - shq * dev))


def mc_propagators(T1a, T2a, T1b, T2b, kab, kba, Ma0, Mb0, dt):
    r"""Exact per-step two-pool exchange/relaxation propagators (batched
    elementwise over any common broadcast shape).

    Returns the ten planes ``(X00, X01, X10, X11, Z00, Z01, Z10, Z11, ca,
    cb)``: the transverse 2×2 interval propagator ``X = expm(dt·[[−1/T2a
    −kab, kba], [kab, −1/T2b−kba]])``, the longitudinal ``Z`` (the same
    with R1), and the affine recovery ``c = A⁻¹(Z−I)·r``, ``r = [R1a·Ma0,
    R1b·Mb0]·dt``: one step of free exchange and relaxation is ``[Ma⊥,
    Mb⊥] ← X·[Ma⊥, Mb⊥]`` and ``[Maz, Mbz] ← Z·[Maz, Mbz] + [ca, cb]``,
    exact for any ``dt``."""
    t00 = (-1 / T2a - kab) * dt
    t11 = (-1 / T2b - kba) * dt
    tob, tba = kba * dt, kab * dt
    X00, X01, X10, X11 = _expm2(t00, tob, tba, t11)       # transverse
    z00 = (-1 / T1a - kab) * dt
    z11 = (-1 / T1b - kba) * dt
    Z00, Z01, Z10, Z11 = _expm2(z00, tob, tba, z11)       # longitudinal
    # affine recovery: c = A⁻¹ (E − I) r, with r = [R1a·Ma0, R1b·Mb0]·dt
    ra, rb = Ma0 * dt / T1a, Mb0 * dt / T1b
    det = z00 * z11 - tob * tba
    ia, ib_ = z11 / det, -tob / det
    ic, id_ = -tba / det, z00 / det
    e00, e01, e10, e11 = Z00 - 1.0, Z01, Z10, Z11 - 1.0
    ca = (ia * e00 + ib_ * e10) * ra + (ia * e01 + ib_ * e11) * rb
    cb = (ic * e00 + id_ * e10) * ra + (ic * e01 + id_ * e11) * rb
    return X00, X01, X10, X11, Z00, Z01, Z10, Z11, ca, cb


@kwalias(**{'γ': 'gam'})
def blochsim_mc(Ma, Mb, Beff, *, T1a, T2a, T1b, T2b, kab, kba, Ma0=1.0,
                Mb0=0.1, dfb=0.0, gam=gamH, dt=dt0, mesh=None):
    r"""Two-pool Bloch–McConnell simulator (magnetization transfer /
    CEST), the autograd oracle of
    :func:`mrphy_tpu_torch.ops.mc.blochsim_mc_rfgr`.

    Each step: pool a rotates about ``Beff``, pool b about ``Beff + [0,
    0, dfb/γ]``, then exchange and relaxation mix the pools with the exact
    interval propagators of :func:`mc_propagators`.

    Inputs:
        - ``Ma``/``Mb``: `(N, *Nd, xyz)`, pool magnetizations (absolute
          units — equilibria are ``Ma0``/``Mb0``).
        - ``Beff``: `(N, *Nd, nT, xyz)`, "Gauss".
    Optionals (each `()` ⊻ `(N ⊻ 1, *Nd ⊻ 1)`):
        - ``T1a``/``T2a``/``T1b``/``T2b``: "Sec"; ``kab``/``kba``:
          "1/Sec"; ``Ma0``/``Mb0``: equilibria; ``dfb``: "Hz", pool-b
          chemical shift.
        - ``mesh``: multi-device runs are not ported yet (raises
          :class:`NotImplementedError`).
    Outputs:
        - ``(Ma, Mb)``: `(N, *Nd, xyz)` each, after all ``nT`` steps.

    Differentiable by autograd w.r.t. everything, the tissue and exchange
    parameters included.
    """
    _refuse_mesh(mesh)
    Ma, Mb, Beff = (torch.as_tensor(x) for x in (Ma, Mb, Beff))
    if Ma.shape != Mb.shape:
        raise ValueError(f'Ma {tuple(Ma.shape)} and Mb {tuple(Mb.shape)} '
                         'differ')
    if Ma.shape[:-1] != Beff.shape[:-2]:
        raise ValueError(f'Ma {tuple(Ma.shape)} and Beff '
                         f'{tuple(Beff.shape)} disagree on (N, *Nd)')
    ndim = Ma.ndim - 1

    def par(x):
        return rshape(asarr(x, Ma), ndim)

    (X00, X01, X10, X11, Z00, Z01, Z10, Z11, ca, cb) = mc_propagators(
        par(T1a), par(T2a), par(T1b), par(T2b), par(kab), par(kba),
        par(Ma0), par(Mb0), par(dt))
    gam_r = par(gam)
    gam2pidt = 2 * pi * gam_r * par(dt)
    ez = torch.tensor([0., 0., 1.], dtype=Ma.dtype, device=Ma.device)
    shift = (par(dfb) / gam_r)[..., None] * ez             # Gauss, pool b
    for t in range(Beff.shape[-2]):
        bt = Beff[..., t, :]
        ua, pa = beffective.beff2uphi(bt, gam2pidt)
        Ma1 = uphirot(ua, pa, Ma)
        ub, pb = beffective.beff2uphi(bt + shift, gam2pidt)
        Mb1 = uphirot(ub, pb, Mb)
        Ma = torch.stack(
            [X00 * Ma1[..., 0] + X01 * Mb1[..., 0],
             X00 * Ma1[..., 1] + X01 * Mb1[..., 1],
             Z00 * Ma1[..., 2] + Z01 * Mb1[..., 2] + ca], -1)
        Mb = torch.stack(
            [X10 * Ma1[..., 0] + X11 * Mb1[..., 0],
             X10 * Ma1[..., 1] + X11 * Mb1[..., 1],
             Z10 * Ma1[..., 2] + Z11 * Mb1[..., 2] + cb], -1)
    return Ma, Mb


@kwalias(**{'Δf': 'df'})
def freeprec(M, dur, *, T1=None, T2=None, df=None, mesh=None):
    r"""Free precession with relaxation and off-resonance (closed form).

    Inputs:
        - ``M``: `(N, *Nd, xyz)`, spins.
        - ``dur``: `()` ⊻ `(N ⊻ 1,)`, "Sec", duration.
    Optionals:
        - ``T1``/``T2``: `()` ⊻ `(N ⊻ 1, *Nd ⊻ 1,)`, "Sec" (both or neither).
        - ``df`` (alias ``Δf``): `(N ⊻ 1, *Nd ⊻ 1,)`, "Hz"; positive ``df``
          dephases clockwise (negative φ).
        - ``mesh``: multi-device runs are not ported yet (raises
          :class:`NotImplementedError`).
    Outputs:
        - ``M``: `(N, *Nd, xyz)`.
    """
    _refuse_mesh(mesh)
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
