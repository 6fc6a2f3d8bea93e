r"""The single-pool EPG kernels, SPGR / MRF-FISP and CPMG: wrappers, plain
PyTorch versions and launch counts.

Six kernels, each the Hopper counterpart of a TPU kernel of
:mod:`mrphy_tpu.ops.epg_pallas`; the three SPGR ones first:

- ``spgr_fwd`` (``csrc/spgr_fwd.cu``, replaces ``_spgr_kernel``): the
  gradient-spoiled train of every atom. Per TR: the RF mix (``epg_rf``),
  the echo ``F+(0)`` demodulated by the transmit phase with its TE decay,
  relaxation over TR with recovery into ``Z(0)``, the spoiler's diffusion
  attenuation, and ``|kshift|`` unit shifts of the configuration orders.
- ``spgr_fwd_chk`` (``csrc/spgr_fwd_lanes.cu`` and ``csrc/spgr_fwd.cu``,
  replaces ``_spgr_fwd_chk_kernel``): the same train, also writing the
  state at the start of every chunk of ``tc`` TRs; on two hand-written
  routes chosen by shape alone (:func:`forward_cfg` at 6 planes), the
  lanes (a group of 8, 16 or 32 lanes per atom over the orders, the state
  in registers, the step shared with the adjoint's phase 1 in
  ``csrc/spgr_lanes.cuh``) where an atom's orders fit its register slots,
  one thread per atom otherwise.
- ``spgr_bwd`` (``csrc/spgr_bwd_lanes.cu`` and ``csrc/spgr_bwd.cu``, replaces
  ``_spgr_bwd_kernel``): the two-phase chunk adjoint. Per chunk, newest first,
  phase 1 re-runs the forward from the chunk's start state and stores every
  pre-RF state; phase 2 walks them backwards (shift transpose, diffusion and
  relaxation transposes, the echo's cotangent, the RF-mix transpose).

Arguments, as ``_spgr_dispatch`` (``epg_pallas.py:219-273``) builds them:

- ``coef (nC, nTR)``: the per-TR rows ``[cos²(α/2), sin²(α/2), sin α,
  cos α, cos φ, sin φ, cos 2φ, sin 2φ, α]``, and under variable TR/TE
  (``vartr``) two more, ``[tr, te]`` (nC = 11, else 9);
- ``par (7, nA)``: the per-atom rows ``[E1, E2, E2te, rec, z0, b1, dq]``;
  under ``vartr`` the first four hold ``[R1, R2, M0, 0]`` and the kernels
  form the factors per TR (``E1 = exp(−tr·R1)`` and the recovery
  ``M0·(1 − E1)`` through ``expm1``); ``dq`` is ``D·dk²·tr`` at constant
  TR and the rate ``D·dk²`` under ``vartr``;
- ``cdiff (3, K)``: the b-factor coefficients of each order, ``[k² + kδ +
  δ²/3, k² − kδ + δ²/3, k²]`` with ``δ = kshift`` (:func:`diff_coef`);
- ``cfg``: :class:`SpgrCfg`, the static switches.

The forward returns the echoes ``sig (nA, nTR, 2)`` ([re, im]) and, with
``tc``, the chunk-start states ``chk (nTR / tc, 6, K, nA)``, rows ``[F+
re, F+ im, F− re, F− im, Z re, Z im]``. The adjoint takes ``chk`` and the
echoes' cotangent and returns ``dcoef (nC, nTR)`` (summed over atoms) and
``dpar (7, nA)``, ``[dE1, dE2, dE2te, drec, dz0, db1, ddq]`` (under
``vartr``: ``[dR1, dR2, dM0, 0, dz0, db1, ddq]``). The gradients of T1,
T2, tr, te, M0, zinit, b1, D and dk w.r.t. these rows come from torch
autograd of their construction (:func:`mrphy_tpu_torch.ops.epg.epg_spgr`).

Each kernel has beside it its plain PyTorch version (``*_torch``: a Python
loop over TRs on ``(nA, K)`` planes in the kernel's order of operations,
sums over the orders taken in the order the kernels take them; the
adjoint's uses no autograd) and a launch count, ``LAUNCHES[name]``,
raised by one at every launch of the kernel and nowhere else.

:func:`spgr` is a ``torch.autograd.Function``: with no gradient needed it
runs ``spgr_fwd``; otherwise ``spgr_fwd_chk``, and ``spgr_bwd`` as its
backward (the kernels on CUDA tensors, no fallback; the plain versions on
CPU tensors). The adjoint takes every instance the
forward takes, on one of two hand-written routes chosen by shape alone, as
``cpmg_bwd``'s below; :func:`spgr` takes the chunk :func:`adjoint_tc`.

The CPMG kernels (``csrc/cpmg_fwd.cu``, ``csrc/cpmg_bwd.cu``) are the same
three for the spin-echo train of T2 mapping: ``cpmg_fwd`` (replaces
``_cpmg_kernel``), ``cpmg_fwd_chk`` (``_cpmg_fwd_chk_kernel``) and
``cpmg_bwd`` (``_cpmg_bwd_kernel``). From the closed-form state the
excitation leaves, per echo: relaxation over esp/2 (with the crusher's
diffusion attenuation) and a unit shift, the refocusing mix about +x, the
same half again, the echo ``F+(0)``; the SPGR step functions serve both.
Arguments, as ``_cpmg_dispatch`` (``epg_pallas.py:362-411``) builds them:
``coef (5, nE)`` ``[cos²(α/2), sin²(α/2), sin α, cos α, α]`` (+ the esp
row under a spacing train, ``varesp``), ``par (7, nA)`` ``[E1h, E2h,
rech, e_ss, e_sc, e_ca, b1]`` (``[R1, R2, M0, …]`` under ``varesp``),
``dq (1, nA)``, ``cdiff (3, K)`` at ``δ = 1``, ``cfg`` :class:`CpmgCfg` (K =
nE + 1). The echoes come as ``(er, ei)``, each ``(nE, nA)``; the adjoint
returns ``dcoef (nC, nE)`` and ``dpar (8, nA)`` (the seven rows' and
``dq``'s). :func:`cpmg` is their autograd Function, as :func:`spgr`.
``cpmg_fwd_chk`` has two hand-written routes, chosen by shape alone
(:func:`forward_cfg` at 6 planes): ``csrc/cpmg_fwd_lanes.cu`` (a group of
8, 16 or 32 lanes per atom over the orders, the state in registers) where
an atom's orders fit its register slots, ``csrc/cpmg_fwd.cu``'s one
thread per atom otherwise; ``cpmg_fwd`` keeps one thread per atom.

``spgr_bwd`` and ``cpmg_bwd`` have two hand-written routes each, chosen by
shape alone (:func:`adjoint_cfg`): the lane route
(``csrc/spgr_bwd_lanes.cu``, ``csrc/cpmg_bwd_lanes.cu``: a group
of 8, 16 or 32 lanes per atom over the orders, state and adjoint in
registers, the chunk's states in shared memory, the checkpoints read once)
where an atom's orders fit its register slots and the chunk its shared
states, and ``csrc/spgr_bwd.cu``, ``csrc/cpmg_bwd.cu`` (one thread per
atom, the chunk's states in a device-memory scratch sized by
:func:`pick_tc`) otherwise. :func:`spgr` and :func:`cpmg` take the chunk
:func:`adjoint_tc`, :func:`pick_tc` capped at the lane route's shared
states while the extra checkpoints fit ``LANE_CHK_BYTES``. The plain
versions sum over the orders in the chosen route's order
(:func:`_lane_sum`). The two-pool ``xspgr_bwd``/``xspgr_v_bwd`` and
``xcpmg_bwd``/``xcpmg_v_bwd``, and EPG-X(MT)'s ``xmt_bwd``/``xmt_v_bwd``,
share the lane route's chooser (``kernels/epgx.py``).
"""

from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from mrphy_tpu_torch.kernels.bloch import (_check, _check_tc, _device_kind,
                                           _ptr, _raise_on, _stream)
from mrphy_tpu_torch.utils._shapes import largest_divisor_leq

__all__ = ['LAUNCHES', 'SpgrCfg', 'diff_coef', 'pick_tc', 'spgr',
           'spgr_fwd', 'spgr_fwd_torch', 'spgr_fwd_chk',
           'spgr_fwd_chk_torch', 'spgr_bwd', 'spgr_bwd_torch', 'CpmgCfg',
           'cpmg', 'cpmg_fwd', 'cpmg_fwd_torch', 'cpmg_fwd_chk',
           'cpmg_fwd_chk_torch', 'cpmg_bwd', 'cpmg_bwd_torch', 'AdjointCfg',
           'adjoint_cfg', 'adjoint_tc', 'lane_capacity', 'ForwardCfg',
           'forward_cfg']

LAUNCHES = {'spgr_fwd': 0, 'spgr_fwd_chk': 0, 'spgr_bwd': 0,
            'cpmg_fwd': 0, 'cpmg_fwd_chk': 0, 'cpmg_bwd': 0}

# The adjoint's scratch budget: the pre-RF states of one chunk of every
# atom, (tc, planes, K, nA) values, stay within 2 GiB (pick_tc).
SCRATCH_BYTES = 2 << 30
# The card's shared memory: a block may use 227 KB, an SM holds 228 KB and
# keeps 1 KB per resident block.
SMEM_BLOCK, SMEM_SM, SMEM_RESERVED = 232448, 233472, 1024


class SpgrCfg(NamedTuple):
    r"""The static switches of one SPGR train: ``K`` modelled orders, the
    spoiler's ``kshift`` k-quanta per TR, per-atom ``b1``, variable TR/TE
    (``vartr``) and spoiler diffusion (``has_d``)."""
    K: int
    kshift: int
    has_b1: bool
    vartr: bool
    has_d: bool

    @property
    def nC(self) -> int:
        return 11 if self.vartr else 9

    @property
    def flags(self) -> int:
        return int(self.has_b1) | 2 * int(self.vartr) | 4 * int(self.has_d)


def diff_coef(K: int, kshift: int, dtype, device) -> torch.Tensor:
    r"""``(3, K)``: the b-factor coefficient of each order, ``k² ± kδ +
    δ²/3`` for ``F±`` and ``k²`` for ``Z`` (``δ = kshift``), exactly
    :func:`mrphy_tpu_torch.ops.epg.epg_diffusion`'s."""
    k = torch.arange(K, dtype=dtype, device=device)
    d = float(kshift)
    return torch.stack([k * k + k * d + d * d / 3, k * k - k * d + d * d / 3,
                        k * k])


def pick_tc(nTR: int, K: int, nA: int, itemsize: int,
            planes: int = 6) -> int:
    r"""The adjoint's chunk length: the largest divisor of ``nTR`` whose
    scratch of pre-RF states, ``tc·planes·K·nA`` values, fits
    ``SCRATCH_BYTES`` (at least 1); ``planes`` is 6 for one pool's state,
    12 for EPG-X's two. At 65,536 atoms × 400 TRs, K 48, float32: tc 25
    for one pool (a 1.9 GB scratch and 16 checkpoints of 1.2 GB), tc 10
    for two (1.51 GB and 40 checkpoints of 151 MB)."""
    per_tr = planes * K * max(nA, 1) * itemsize
    return largest_divisor_leq(nTR, max(1, SCRATCH_BYTES // per_tr))


# ==========================================================================
# The plain versions
# ==========================================================================

def _flip_trig(coef, t, arow, b1, has_b1):
    r"""TR ``t``'s ``(cos²(α/2), sin²(α/2), sin α, cos α)``: the rows, or
    under ``has_b1`` per atom from ``α = flip·b1`` (the flip in row
    ``arow``) by the half-angle identities."""
    if not has_b1:
        return coef[0, t], coef[1, t], coef[2, t], coef[3, t]
    ah = (0.5 * coef[arow, t]) * b1
    ch, sh = torch.cos(ah), torch.sin(ah)
    ca2, sa2 = ch * ch, sh * sh
    return ca2, sa2, 2 * ch * sh, ca2 - sa2


def _trig(coef, t, b1, has_b1):
    r"""TR ``t``'s RF factors ``(cos²(α/2), sin²(α/2), sin α, cos α, cos φ,
    sin φ, cos 2φ, sin 2φ)`` (:func:`_flip_trig`, then the phase rows)."""
    return _flip_trig(coef, t, 8, b1, has_b1) + (coef[4, t], coef[5, t],
                                                 coef[6, t], coef[7, t])


def _factors(coef, t, p, vartr):
    r"""TR ``t``'s ``(E1, E2, E2te, rec)``: the per-atom rows, or under
    ``vartr`` formed from the rates and the tr/te rows."""
    if not vartr:
        return p[0], p[1], p[2], p[3]
    trn, ten = coef[9, t], coef[10, t]
    a1 = -torch.expm1(-(trn * p[0]))
    return 1 - a1, torch.exp(-(trn * p[1])), torch.exp(-(ten * p[1])), \
        p[2] * a1


def _att(coef, t, p, cdiff, cfg):
    r"""TR ``t``'s diffusion attenuation of each order, ``exp(−dq·c)``, or
    None without diffusion."""
    if not cfg.has_d:
        return None
    dqt = p[6] * coef[9, t] if cfg.vartr else p[6]
    return tuple(torch.exp(-dqt * c) for c in cdiff)


def _mix(tg, s):
    r"""The RF mix (``epg_rf``'s rows in real-pair arithmetic). A pulse
    about +x (``tg`` without its phase factors: CPMG's refocusing) drops
    the terms that carry sin φ or sin 2φ; the rest round as the general
    rows at φ = 0 do."""
    Fpr, Fpi, Fmr, Fmi, Zr, Zi = s
    if len(tg) == 4:
        ca2, sa2, sa, ca = tg
        hc = 0.5 * sa
        return ((ca2 * Fpr + sa2 * Fmr) + sa * Zi,
                (ca2 * Fpi + sa2 * Fmi) - sa * Zr,
                (sa2 * Fpr + ca2 * Fmr) - sa * Zi,
                (sa2 * Fpi + ca2 * Fmi) + sa * Zr,
                (hc * Fpi - hc * Fmi) + ca * Zr,
                (hc * Fmr - hc * Fpr) + ca * Zi)
    ca2, sa2, sa, ca, c1, s1, c2, s2 = tg
    sc2, ss2 = sa2 * c2, sa2 * s2
    ss, sc = sa * s1, sa * c1
    hs, hc = 0.5 * ss, 0.5 * sc
    return (ca2 * Fpr + (sc2 * Fmr - ss2 * Fmi) + (ss * Zr + sc * Zi),
            ca2 * Fpi + (sc2 * Fmi + ss2 * Fmr) + (ss * Zi - sc * Zr),
            (sc2 * Fpr + ss2 * Fpi) + ca2 * Fmr + (ss * Zr - sc * Zi),
            (sc2 * Fpi - ss2 * Fpr) + ca2 * Fmi + (ss * Zi + sc * Zr),
            (-hs * Fpr + hc * Fpi) + (-hs * Fmr - hc * Fmi) + ca * Zr,
            (-hs * Fpi - hc * Fpr) + (-hs * Fmi + hc * Fmr) + ca * Zi)


def _mix_T(tg, h):
    r"""The exact transpose of :func:`_mix`."""
    hFpr, hFpi, hFmr, hFmi, hZr, hZi = h
    if len(tg) == 4:
        ca2, sa2, sa, ca = tg
        hc = 0.5 * sa
        return ((ca2 * hFpr + sa2 * hFmr) - hc * hZi,
                (ca2 * hFpi + sa2 * hFmi) + hc * hZr,
                (sa2 * hFpr + ca2 * hFmr) + hc * hZi,
                (sa2 * hFpi + ca2 * hFmi) - hc * hZr,
                (sa * hFmi - sa * hFpi) + ca * hZr,
                (sa * hFpr - sa * hFmr) + ca * hZi)
    ca2, sa2, sa, ca, c1, s1, c2, s2 = tg
    sc2, ss2 = sa2 * c2, sa2 * s2
    ss, sc = sa * s1, sa * c1
    hs, hc = 0.5 * ss, 0.5 * sc
    return (ca2 * hFpr + sc2 * hFmr - ss2 * hFmi - hs * hZr - hc * hZi,
            ca2 * hFpi + ss2 * hFmr + sc2 * hFmi + hc * hZr - hs * hZi,
            sc2 * hFpr + ss2 * hFpi + ca2 * hFmr - hs * hZr + hc * hZi,
            -ss2 * hFpr + sc2 * hFpi + ca2 * hFmi - hc * hZr - hs * hZi,
            ss * hFpr - sc * hFpi + ss * hFmr + sc * hFmi + ca * hZr,
            sc * hFpr + ss * hFpi - sc * hFmr + ss * hFmi + ca * hZi)


def _at0(x, v):
    r"""``x`` with ``v`` in place of its order 0."""
    return torch.cat([v, x[:, 1:]], dim=1)


def _relax(E1t, E2t, rect, s, att):
    r"""Relaxation over TR with recovery into ``Z(0)``, then the
    diffusion attenuation (before the shift, as ``epg_diffusion``)."""
    Fpr, Fpi, Fmr, Fmi, Zr, Zi = s
    Fpr, Fpi, Fmr, Fmi = E2t * Fpr, E2t * Fpi, E2t * Fmr, E2t * Fmi
    Zr = E1t * Zr
    Zr, Zi = _at0(Zr, Zr[:, :1] + rect), E1t * Zi
    if att is not None:
        ATp, ATm, AL = att
        Fpr, Fpi, Fmr, Fmi = ATp * Fpr, ATp * Fpi, ATm * Fmr, ATm * Fmi
        Zr, Zi = AL * Zr, AL * Zi
    return Fpr, Fpi, Fmr, Fmi, Zr, Zi


def _shift(s, kshift):
    r"""``|kshift|`` unit spoiler shifts (``epg_grad``): ``F+`` up and
    ``F−`` down for ``kshift > 0`` with ``F+(0) = conj(F−(0))``, the
    mirror for ``kshift < 0``; orders past ``K − 1`` are dropped."""
    Fpr, Fpi, Fmr, Fmi, Zr, Zi = s
    zero = torch.zeros_like(Fpr[:, :1])
    for _ in range(abs(kshift)):
        if kshift > 0:
            Fmr = torch.cat([Fmr[:, 1:], zero], dim=1)
            Fmi = torch.cat([Fmi[:, 1:], zero], dim=1)
            Fpr = torch.cat([Fmr[:, :1], Fpr[:, :-1]], dim=1)
            Fpi = torch.cat([-Fmi[:, :1], Fpi[:, :-1]], dim=1)
        else:
            Fpr = torch.cat([Fpr[:, 1:], zero], dim=1)
            Fpi = torch.cat([Fpi[:, 1:], zero], dim=1)
            Fmr = torch.cat([Fpr[:, :1], Fmr[:, :-1]], dim=1)
            Fmi = torch.cat([-Fpi[:, :1], Fmi[:, :-1]], dim=1)
    return Fpr, Fpi, Fmr, Fmi, Zr, Zi


def _shift_T(h, kshift):
    r"""The transpose of :func:`_shift`: for ``kshift > 0`` one unit is
    ``F+(k) ← F+(k + 1)``, ``F−(k) ← F−(k − 1)``, and ``conj(F+(0))`` added
    to ``F−(1)`` (which fed the new ``F+(0)``); the mirror for ``kshift <
    0``."""
    hFpr, hFpi, hFmr, hFmi, hZr, hZi = h
    zero = torch.zeros_like(hFpr[:, :1])
    K = hFpr.shape[1]

    def up(x):      # x(k) ← x(k − 1), x(0) ← 0
        return torch.cat([zero, x[:, :-1]], dim=1)

    def down(x):    # x(k) ← x(k + 1), x(K − 1) ← 0
        return torch.cat([x[:, 1:], zero], dim=1)

    for _ in range(abs(kshift)):
        if kshift > 0:
            p0r, p0i = hFpr[:, :1], hFpi[:, :1]
            hFpr, hFpi, hFmr, hFmi = down(hFpr), down(hFpi), up(hFmr), \
                up(hFmi)
            if K > 1:
                hFmr = torch.cat([hFmr[:, :1], hFmr[:, 1:2] + p0r,
                                  hFmr[:, 2:]], dim=1)
                hFmi = torch.cat([hFmi[:, :1], hFmi[:, 1:2] - p0i,
                                  hFmi[:, 2:]], dim=1)
        else:
            m0r, m0i = hFmr[:, :1], hFmi[:, :1]
            hFmr, hFmi, hFpr, hFpi = down(hFmr), down(hFmi), up(hFpr), \
                up(hFpi)
            if K > 1:
                hFpr = torch.cat([hFpr[:, :1], hFpr[:, 1:2] + m0r,
                                  hFpr[:, 2:]], dim=1)
                hFpi = torch.cat([hFpi[:, :1], hFpi[:, 1:2] - m0i,
                                  hFpi[:, 2:]], dim=1)
    return hFpr, hFpi, hFmr, hFmi, hZr, hZi


def _echo(E2tet, c1, s1, fp0r, fp0i):
    return torch.cat([E2tet * (c1 * fp0r + s1 * fp0i),
                      E2tet * (c1 * fp0i - s1 * fp0r)], dim=1)


def _init_state(p, K):
    z = torch.zeros(p.shape[1], K, dtype=p.dtype, device=p.device)
    return z, z, z, z, _at0(z, p[4]), z


def _step(coef, t, p, cdiff, cfg, s):
    r"""TR ``t`` from the pre-RF state ``s``: ``(next pre-RF state, echo
    (nA, 2))``."""
    tg = _trig(coef, t, p[5], cfg.has_b1)
    E1t, E2t, E2tet, rect = _factors(coef, t, p, cfg.vartr)
    s1 = _mix(tg, s)
    echo = _echo(E2tet, tg[4], tg[5], s1[0][:, :1], s1[1][:, :1])
    s2 = _relax(E1t, E2t, rect, s1, _att(coef, t, p, cdiff, cfg))
    return _shift(s2, cfg.kshift), echo


def _fwd(coef, par, cdiff, cfg, tc):
    nTR = coef.shape[1]
    p = par.unsqueeze(-1)                              # (7, nA, 1)
    s = _init_state(p, cfg.K)
    echoes, chk = [], []
    for t in range(nTR):
        if tc and t % tc == 0:
            chk.append(torch.stack(s).transpose(1, 2))     # (6, K, nA)
        s, echo = _step(coef, t, p, cdiff, cfg, s)
        echoes.append(echo)
    sig = torch.stack(echoes, dim=1)                   # (nA, nTR, 2)
    return sig, (torch.stack(chk) if tc else None)


def spgr_fwd_torch(coef, par, cdiff, cfg: SpgrCfg):
    r"""Plain PyTorch version of the ``spgr_fwd`` kernel: ``sig (nA, nTR,
    2)``. Differentiable by torch autograd (which then keeps every
    TR)."""
    return _fwd(coef, par, cdiff, cfg, None)[0]


def spgr_fwd_chk_torch(coef, par, cdiff, cfg: SpgrCfg, *, tc: int):
    r"""Plain PyTorch version of the ``spgr_fwd_chk`` kernel: ``(sig (nA,
    nTR, 2), chk (nTR / tc, 6, K, nA))``."""
    _check_tc(coef.shape[1], tc)
    return _fwd(coef, par, cdiff, cfg, tc)


def _ksum(x):
    r"""``x (..., K)`` summed over its last axis one order at a time, as
    the kernels sum."""
    acc = x[..., 0]
    for k in range(1, x.shape[-1]):
        acc = acc + x[..., k]
    return acc


def _lane_parts(x, G, acc=None):
    r"""``x (..., K)`` summed per lane of a group of ``G`` in the order of
    the adjoints' lane route (``csrc/epg_lanes.cuh``): lane ``l`` adds
    orders ``l, l + G, …`` in turn onto ``acc (..., G)`` (nothing when
    None: lane ``l`` starts from order ``l``, or 0 past K − 1). Returns
    ``(..., G)``; only the orders' own additions are made, as the kernels
    skip the slots past K − 1."""
    K = x.shape[-1]
    start = 0
    if acc is None:
        acc = torch.nn.functional.pad(x[..., :G], (0, max(G - K, 0)))
        start = G
    for lo in range(start, K, G):
        n = min(G, K - lo)
        acc = torch.cat([acc[..., :n] + x[..., lo:lo + n], acc[..., n:]],
                        dim=-1)
    return acc


def _group_sum(acc):
    r"""The sum of ``acc (..., G)`` over its lanes in the order of the
    group's shuffle tree: lane ``l`` adds lane ``l + o`` for ``o`` = G/2,
    …, 1."""
    o = acc.shape[-1] // 2
    while o:
        acc = acc[..., :o] + acc[..., o:2 * o]
        o //= 2
    return acc[..., 0]


def _lane_sum(x, G):
    r"""``x (..., K)`` summed over its last axis in the order of the
    adjoints' lane route: each lane's orders in turn (:func:`_lane_parts`),
    then the group's lanes (:func:`_group_sum`). ``G`` 1 is the one-thread
    route's order, one order at a time (:func:`_ksum`)."""
    if G == 1:
        return _ksum(x)
    return _group_sum(_lane_parts(x, G))


def _warp_sums(r, W=32):
    r"""The sums of ``r (nA, n)`` over each warp's ``W`` atoms in the order
    of the kernels' shuffle tree (atom ``j`` adds atom ``j + o`` for ``o``
    = W/2, …, 1; atoms past nA add zeros): `(ceil(nA / W), n)`. A warp
    holds 32 atoms on the one-thread routes, ``32 / G`` on the adjoints'
    lane route."""
    nA = r.shape[0]
    nW = -(-nA // W)
    x = torch.nn.functional.pad(r, (0, 0, 0, nW * W - nA)).reshape(
        nW, W, -1)
    o = W // 2
    while o:
        x = x[:, :o] + x[:, o:2 * o]
        o //= 2
    return x[:, 0]


def _relax_T(h, x, f, att, cdiff):
    r"""The transpose of :func:`_relax` at its input ``x``, given the
    cotangent ``h`` of its output: ``(the cotangent of x, terms, ∂rec)``.
    ``terms`` are the per-order terms whose sums over the orders are ∂E2
    and ∂E1, led, under diffusion, by the one whose sum is −∂dq: the
    diffusion transpose ``h ← A·h``, with ``A = exp(−dq·c)`` adding ``−Σ
    c·A·(h·s2)`` to ∂dq (``s2``: ``x`` relaxed)."""
    E1, E2, rec = f
    terms = []
    if att is not None:
        ATp, ATm, AL = att
        cTp, cTm, cL = cdiff
        s2Zr = E1 * x[4]
        s2Zr = _at0(s2Zr, s2Zr[:, :1] + rec)
        terms.append(
            cTp * ATp * (h[0] * (E2 * x[0]) + h[1] * (E2 * x[1]))
            + cTm * ATm * (h[2] * (E2 * x[2]) + h[3] * (E2 * x[3]))
            + cL * AL * (h[4] * s2Zr + h[5] * (E1 * x[5])))
        h = (ATp * h[0], ATp * h[1], ATm * h[2], ATm * h[3], AL * h[4],
             AL * h[5])
    terms.append(h[0] * x[0] + h[1] * x[1] + h[2] * x[2] + h[3] * x[3])
    terms.append(h[4] * x[4] + h[5] * x[5])
    return ((E2 * h[0], E2 * h[1], E2 * h[2], E2 * h[3], E1 * h[4],
             E1 * h[5]), terms, h[4][:, :1])


def spgr_bwd_torch(coef, par, cdiff, cfg: SpgrCfg, chk, g, *, tc: int):
    r"""Plain PyTorch version of the ``spgr_bwd`` kernel: the two-phase
    chunk adjoint of :func:`spgr_fwd_chk_torch`, with no autograd.

    ``chk``: its checkpoints at the same ``tc``; ``g``: the echoes'
    cotangent `(nA, nTR, 2)`. Returns ``(dcoef (nC, nTR), dpar (7,
    nA))``. Every sum over the orders is taken in the order of the route
    the kernel takes at this shape (:func:`adjoint_cfg`,
    :func:`_lane_sum`), and the per-TR rows by warps (:func:`_warp_sums`),
    then over the warps, as the kernel and its wrapper sum them."""
    nTR = coef.shape[1]
    _check_tc(nTR, tc)
    ntc, K = chk.shape[0], cfg.K
    if ntc != nTR // tc:
        raise ValueError(f'chk holds {ntc} states, but nTR={nTR} in chunks '
                         f'of tc={tc} gives {nTR // tc}')
    # the sums over the orders in the order of the kernel's route
    G = adjoint_cfg(K, par.element_size(), 6, tc).G
    p = par.unsqueeze(-1)
    E1, E2, M0 = p[0], p[1], p[2]
    zero = torch.zeros_like(p[0])
    h = (torch.zeros_like(chk[0, 0].T),) * 6
    aE1 = aE2 = aE2te = arec = ab1 = aDq = zero
    # each warp's per-TR rows (a warp holds 32 / G atoms), as the kernel's
    dcf = coef.new_zeros((-(-par.shape[1] * G // 32), nTR, cfg.nC))
    for j in reversed(range(ntc)):
        # phase 1: the forward from the chunk's start state, every state
        s = tuple(chk[j, q].T for q in range(6))
        states = []
        for t in range(j * tc, (j + 1) * tc):
            states.append(s)
            s, _ = _step(coef, t, p, cdiff, cfg, s)
        # phase 2: the cotangent, backwards through the stored states
        for t in reversed(range(j * tc, (j + 1) * tc)):
            s = states.pop()
            tg = _trig(coef, t, p[5], cfg.has_b1)
            ca2, sa2, sa, ca, c1, s1c, c2, s2 = tg
            E1t, E2t, E2tet, rect = _factors(coef, t, p, cfg.vartr)
            s1 = _mix(tg, s)
            att = _att(coef, t, p, cdiff, cfg)
            h, terms, d_rec_t = _relax_T(_shift_T(h, cfg.kshift), s1,
                                         (E1t, E2t, rect), att, cdiff)
            # the echo's cotangent, injected at F+(0) (the echo reads the
            # state after the mix, before relaxation)
            gyr, gyi = g[:, t, 0:1], g[:, t, 1:2]
            fp0r, fp0i = s1[0][:, :1], s1[1][:, :1]
            d_E2te_t = (gyr * (c1 * fp0r + s1c * fp0i)
                        + gyi * (c1 * fp0i - s1c * fp0r))
            er = E2tet * (c1 * gyr - s1c * gyi)
            ei = E2tet * (s1c * gyr + c1 * gyi)
            h = (_at0(h[0], h[0][:, :1] + er),
                 _at0(h[1], h[1][:, :1] + ei)) + h[2:]
            d_c1e = E2tet * (gyr * fp0r + gyi * fp0i)
            d_s1e = E2tet * (gyr * fp0i - gyi * fp0r)
            # the RF mix's coefficients
            h1Fpr, h1Fpi, h1Fmr, h1Fmi, h1Zr, h1Zi = h
            Fpr, Fpi, Fmr, Fmi, Zr, Zi = s
            terms += [h1Fpr * Fpr + h1Fpi * Fpi + h1Fmr * Fmr + h1Fmi * Fmi,
                      h1Fpr * Fmr + h1Fpi * Fmi + h1Fmr * Fpr + h1Fmi * Fpi,
                      -h1Fpr * Fmi + h1Fpi * Fmr + h1Fmr * Fpi
                      - h1Fmi * Fpr,
                      (h1Fpr + h1Fmr) * Zr + (h1Fpi + h1Fmi) * Zi,
                      (h1Fpr - h1Fmr) * Zi - (h1Fpi - h1Fmi) * Zr,
                      -h1Zr * (Fpr + Fmr) - h1Zi * (Fpi + Fmi),
                      h1Zr * (Fpi - Fmi) + h1Zi * (Fmr - Fpr),
                      h1Zr * Zr + h1Zi * Zi]
            sums = _lane_sum(torch.stack(terms), G).unsqueeze(-1)  # (n,)
            if att is not None:
                contr, sums = -sums[0], sums[1:]
            (d_E2_t, d_E1_t, d_ca2, d_sc2, d_ss2, d_ss, d_sc, d_hs, d_hc,
             d_ca) = sums
            if cfg.vartr:
                trn, ten = coef[9, t], coef[10, t]
                d_E1tot = d_E1_t - M0 * d_rec_t
                aE2te = aE2te + (1 - E1t) * d_rec_t
                aE1 = aE1 - trn * E1t * d_E1tot
                aE2 = aE2 - trn * E2t * d_E2_t - ten * E2tet * d_E2te_t
                d_tr_row = -E1 * E1t * d_E1tot - E2 * E2t * d_E2_t
                if att is not None:
                    aDq = aDq + trn * contr
                    d_tr_row = d_tr_row + p[6] * contr
                d_te_row = -E2 * E2tet * d_E2te_t
            else:
                aE1, aE2 = aE1 + d_E1_t, aE2 + d_E2_t
                arec, aE2te = arec + d_rec_t, aE2te + d_E2te_t
                if att is not None:
                    aDq = aDq + contr
            d_sa2 = c2 * d_sc2 + s2 * d_ss2
            d_c2, d_s2 = sa2 * d_sc2, sa2 * d_ss2
            d_sa = s1c * (d_ss + 0.5 * d_hs) + c1 * (d_sc + 0.5 * d_hc)
            d_s1 = sa * (d_ss + 0.5 * d_hs) + d_s1e
            d_c1 = sa * (d_sc + 0.5 * d_hc) + d_c1e
            if cfg.has_b1:
                # α = flip·b1 through the half-angle trig
                d_al = 0.5 * sa * (d_sa2 - d_ca2) + ca * d_sa - sa * d_ca
                ab1 = ab1 + d_al * coef[8, t]
                rows = [zero, zero, zero, zero, d_c1, d_s1, d_c2, d_s2,
                        d_al * p[5]]
            else:
                rows = [d_ca2, d_sa2, d_sa, d_ca, d_c1, d_s1, d_c2, d_s2,
                        zero]
            if cfg.vartr:
                rows += [d_tr_row, d_te_row]
            dcf[:, t] = _warp_sums(torch.cat(rows, dim=1), 32 // G)
            h = _mix_T(tg, h)
    # the initial state is z0 on Z(0)'s real part
    dz0 = h[4][:, :1]
    dpar = torch.cat([aE1, aE2, aE2te, arec, dz0, ab1, aDq], dim=1).T
    # the warps' rows summed as the wrapper sums the kernel's
    return dcf.sum(dim=0).T.contiguous(), dpar.contiguous()


# ==========================================================================
# CPMG: the plain versions
# ==========================================================================

class CpmgCfg(NamedTuple):
    r"""The static switches of one CPMG train: ``nE`` echoes (``K = nE +
    1`` orders), per-atom ``b1``, a per-echo spacing train (``varesp``)
    and spoiler diffusion (``has_d``)."""
    nE: int
    has_b1: bool
    varesp: bool
    has_d: bool

    @property
    def K(self) -> int:
        return self.nE + 1

    @property
    def nC(self) -> int:
        return 6 if self.varesp else 5

    @property
    def flags(self) -> int:
        return int(self.has_b1) | 2 * int(self.varesp) | 4 * int(self.has_d)


def _cpmg_factors(coef, t, p, varesp):
    r"""Echo ``t``'s half-interval ``(E1h, E2h, rech)``: the atom's rows,
    or under ``varesp`` formed from the rates (``R1``, ``R2``), ``M0`` and
    the esp row, the recovery through expm1."""
    if not varesp:
        return p[0], p[1], p[2]
    hn = 0.5 * coef[5, t]
    a1 = -torch.expm1(-(hn * p[0]))
    return 1 - a1, torch.exp(-(hn * p[1])), p[2] * a1


def _cpmg_att(coef, t, dq, cdiff, cfg):
    r"""Echo ``t``'s diffusion attenuation of each order over one half,
    ``exp(−dq·c)`` (``dq`` the rate ``D·dk²`` times esp/2 under
    ``varesp``), or None without diffusion."""
    if not cfg.has_d:
        return None
    dqt = dq * (0.5 * coef[5, t]) if cfg.varesp else dq
    return tuple(torch.exp(-dqt * c) for c in cdiff)


def _cpmg_half(f, s, att):
    r"""One half echo: relaxation over esp/2 (and the attenuation), then
    the crusher's unit shift."""
    return _shift(_relax(*f, s, att), 1)


def _cpmg_echo(coef, t, p, dq, cdiff, cfg, s):
    r"""Echo ``t`` from its pre-echo state ``s``: half, the refocusing
    mix about +x, half; returns the state whose ``F+(0)`` is the echo."""
    f = _cpmg_factors(coef, t, p, cfg.varesp)
    att = _cpmg_att(coef, t, dq, cdiff, cfg)
    s = _cpmg_half(f, s, att)
    s = _mix(_flip_trig(coef, t, 4, p[6], cfg.has_b1), s)
    return _cpmg_half(f, s, att)


def _mix0_terms(h, x):
    r"""One pool's per-order terms of the refocusing mix's (about +x)
    coefficient gradients ``(∂ca2, ∂sa2, ∂sc, ∂hc, ∂ca)``: the cotangent
    ``h`` of the mixed state against its input ``x`` (``∂sa = ∂sc +
    ∂hc/2``)."""
    hFpr, hFpi, hFmr, hFmi, hZr, hZi = h
    Fpr, Fpi, Fmr, Fmi, Zr, Zi = x
    return [hFpr * Fpr + hFpi * Fpi + hFmr * Fmr + hFmi * Fmi,
            hFpr * Fmr + hFpi * Fmi + hFmr * Fpr + hFmi * Fpi,
            (hFpr - hFmr) * Zi - (hFpi - hFmi) * Zr,
            hZr * (Fpi - Fmi) + hZi * (Fmr - Fpr),
            hZr * Zr + hZi * Zi]


def _cpmg_init(p, K):
    r"""The closed-form state after the excitation of equilibrium ``M0``:
    ``F± = sinα·(sinφ ∓ i·cosφ)·M0``, ``Z = cosα·M0`` (the rows ``e_ss,
    e_sc, e_ca``)."""
    z = torch.zeros(p.shape[1], K, dtype=p.dtype, device=p.device)
    return (_at0(z, p[3]), _at0(z, -p[4]), _at0(z, p[3]), _at0(z, p[4]),
            _at0(z, p[5]), z)


def _cpmg_fwd(coef, par, dq, cdiff, cfg, tc):
    p, dq = par.unsqueeze(-1), dq.reshape(-1, 1)
    s = _cpmg_init(p, cfg.K)
    er, ei = [], []
    chk = par.new_empty((cfg.nE // tc, 6, cfg.K, par.shape[1])) if tc \
        else None
    for t in range(cfg.nE):
        if tc and t % tc == 0:
            chk[t // tc] = torch.stack(s).transpose(1, 2)  # (6, K, nA)
        s = _cpmg_echo(coef, t, p, dq, cdiff, cfg, s)
        er.append(s[0][:, 0])
        ei.append(s[1][:, 0])
    return torch.stack(er), torch.stack(ei), chk


def cpmg_fwd_torch(coef, par, dq, cdiff, cfg: CpmgCfg):
    r"""Plain PyTorch version of the ``cpmg_fwd`` kernel: the echoes ``(er,
    ei)``, each ``(nE, nA)``. Differentiable by torch autograd (which then
    keeps every echo)."""
    return _cpmg_fwd(coef, par, dq, cdiff, cfg, None)[:2]


def cpmg_fwd_chk_torch(coef, par, dq, cdiff, cfg: CpmgCfg, *, tc: int):
    r"""Plain PyTorch version of the ``cpmg_fwd_chk`` kernel: ``(er, ei,
    chk (nE / tc, 6, K, nA))``, the pre-echo state at the start of every
    chunk of ``tc`` echoes."""
    _check_tc(coef.shape[1], tc)
    return _cpmg_fwd(coef, par, dq, cdiff, cfg, tc)


def cpmg_bwd_torch(coef, par, dq, cdiff, cfg: CpmgCfg, chk, gr, gi, *,
                   tc: int):
    r"""Plain PyTorch version of the ``cpmg_bwd`` kernel: the two-phase
    chunk adjoint of :func:`cpmg_fwd_chk_torch`, with no autograd.

    ``chk``: its checkpoints at the same ``tc``; ``gr``/``gi``: the
    echoes' cotangent, each ``(nE, nA)``. Per echo, newest first: the
    cotangent injected at ``F+(0)``, the second half's transpose (shift,
    attenuation, relaxation), the refocusing mix's coefficients and
    transpose, the first half's transpose. Returns ``(dcoef (nC, nE),
    dpar (8, nA))``: ``dpar`` rows ``[dE1h, dE2h, drech, d_ss, d_sc, d_ca,
    db1, ddq]`` (under ``varesp`` the first three ``[dR1, dR2, dM0]``, and
    ``dcoef``'s row 5 the esp train's). Every sum over the orders is taken
    in the order of the route the kernel takes at this shape
    (:func:`adjoint_cfg`, :func:`_lane_sum`), and the per-echo rows by
    warps (:func:`_warp_sums`), then over the warps, as the kernel and its
    wrapper sum them."""
    nE = coef.shape[1]
    _check_tc(nE, tc)
    ntc, K = chk.shape[0], cfg.K
    if ntc != nE // tc:
        raise ValueError(f'chk holds {ntc} states, but nE={nE} in chunks '
                         f'of tc={tc} gives {nE // tc}')
    # the sums over the orders in the order of the kernel's route
    G = adjoint_cfg(K, par.element_size(), 6, tc).G
    p, dqc = par.unsqueeze(-1), dq.reshape(-1, 1)
    R1, R2, M0 = p[0], p[1], p[2]
    zero = torch.zeros_like(p[0])
    h = (torch.zeros_like(chk[0, 0].T),) * 6
    aE1 = aE2 = arec = ab1 = aDq = zero
    # each warp's per-echo rows (a warp holds 32 / G atoms), as the kernel's
    dcf = coef.new_zeros((-(-par.shape[1] * G // 32), nE, cfg.nC))
    for j in reversed(range(ntc)):
        # phase 1: the forward from the chunk's start state, every state
        s = tuple(chk[j, q].T for q in range(6))
        states = []
        for t in range(j * tc, (j + 1) * tc):
            states.append(s)
            s = _cpmg_echo(coef, t, p, dqc, cdiff, cfg, s)
        # phase 2: the cotangent, backwards through the stored states
        for t in reversed(range(j * tc, (j + 1) * tc)):
            s = states.pop()
            tg = _flip_trig(coef, t, 4, p[6], cfg.has_b1)
            ca2, sa2, sa, ca = tg
            f = _cpmg_factors(coef, t, p, cfg.varesp)
            E1h, E2h, _ = f
            att = _cpmg_att(coef, t, dqc, cdiff, cfg)
            sh1 = _cpmg_half(f, s, att)        # the refocusing's input
            s1 = _mix(tg, sh1)
            # the echo reads F+(0) after the second half
            h = (_at0(h[0], h[0][:, :1] + gr[t][:, None]),
                 _at0(h[1], h[1][:, :1] + gi[t][:, None])) + h[2:]
            h, t2, d_rec2 = _relax_T(_shift_T(h, 1), s1, f, att, cdiff)
            # the refocusing's coefficients (h: its output's cotangent)
            tm = _mix0_terms(h, sh1)
            h = _mix_T(tg, h)
            h, t1, d_rec1 = _relax_T(_shift_T(h, 1), s, f, att, cdiff)
            sums = _lane_sum(torch.stack(t2 + tm + t1), G).unsqueeze(-1)
            n2 = len(t2)
            d_esp = zero
            # each half's factors (and diffusion), the second half first
            for hs, d_rec in ((sums[:n2], d_rec2), (sums[n2 + 5:], d_rec1)):
                if att is not None:
                    contr, hs = -hs[0], hs[1:]
                    if cfg.varesp:
                        aDq = aDq + (0.5 * coef[5, t]) * contr
                        d_esp = d_esp + 0.5 * dqc * contr
                    else:
                        aDq = aDq + contr
                d_E2h, d_E1h = hs
                if cfg.varesp:
                    # the slots hold (R1, R2, M0); rech = M0·(1 − E1h)
                    hn = 0.5 * coef[5, t]
                    d_E1tot = d_E1h - M0 * d_rec
                    arec = arec + (1 - E1h) * d_rec
                    aE1 = aE1 - hn * E1h * d_E1tot
                    aE2 = aE2 - hn * E2h * d_E2h
                    d_esp = d_esp - 0.5 * (R1 * E1h * d_E1tot
                                           + R2 * E2h * d_E2h)
                else:
                    aE1, aE2, arec = aE1 + d_E1h, aE2 + d_E2h, arec + d_rec
            d_ca2, d_sa2, d_sc, d_hc, d_ca = sums[n2:n2 + 5]
            d_sa = d_sc + 0.5 * d_hc
            if cfg.has_b1:
                # α = flip·b1 through the half-angle trig
                d_al = 0.5 * sa * (d_sa2 - d_ca2) + ca * d_sa - sa * d_ca
                ab1 = ab1 + d_al * coef[4, t]
                rows = [zero, zero, zero, zero, d_al * p[6]]
            else:
                rows = [d_ca2, d_sa2, d_sa, d_ca, zero]
            if cfg.varesp:
                rows.append(d_esp)
            dcf[:, t] = _warp_sums(torch.cat(rows, dim=1), 32 // G)
    # the excitation's state: F+(0) = (e_ss, −e_sc), F−(0) = (e_ss, e_sc),
    # Z(0) = e_ca
    d_ss = h[0][:, :1] + h[2][:, :1]
    d_sc = -h[1][:, :1] + h[3][:, :1]
    dpar = torch.cat([aE1, aE2, arec, d_ss, d_sc, h[4][:, :1], ab1, aDq],
                     dim=1).T
    # the warps' rows summed as the wrapper sums the kernel's
    return dcf.sum(dim=0).T.contiguous(), dpar.contiguous()


# ==========================================================================
# The kernels
# ==========================================================================

def launch_cfg(K: int, itemsize: int, planes: int = 6):
    r"""``(threads per block, state in shared memory)``: a thread walks
    one atom and keeps its ``planes·K`` state values (6 for one pool, 12
    for EPG-X's two, 8 for EPG-X(MT)'s) in shared memory; of 128, 64 and
    32 threads per block the count that keeps the most threads resident on
    an SM. When even 32 threads' states exceed a block's shared memory (one
    pool: K > 295 in float32, K > 147 in float64; two: K > 151, K > 75;
    EPG-X(MT): K > 227, K > 113), the states live in device memory and
    blocks take 128 threads."""
    per_thread = planes * K * itemsize
    best = None
    for th in (128, 64, 32):
        smem = th * per_thread
        if smem > SMEM_BLOCK:
            continue
        resident = SMEM_SM // (smem + SMEM_RESERVED) * th
        if best is None or resident > best[1]:
            best = (th, resident)
    return (best[0], True) if best else (128, False)


# The adjoints K15 (spgr_bwd), K18 (cpmg_bwd), K21 (xspgr_bwd), K24
# (xspgr_v_bwd), K27 (xcpmg_bwd), K30 (xcpmg_v_bwd), K33 (xmt_bwd) and K36
# (xmt_v_bwd) on their lane route: 128 threads a block, a group of G lanes
# per atom, at most LANE_SLOTS_MAX order slots a lane (their registers: one
# pool's 6 planes, two pools' 12, EPG-X(MT)'s 8; by itemsize), at most
# LANE_STATES_MAX chunk states an atom in shared memory, sized so
# LANE_BLOCKS blocks fit an SM.
LANE_THREADS = 128
LANE_WIDTHS = (8, 16, 32)
LANE_SLOTS_MAX = {(6, 4): 5, (6, 8): 2, (8, 4): 5, (8, 8): 3, (12, 4): 3,
                  (12, 8): 1}
LANE_STATES_MAX = 8
LANE_BLOCKS = 3
# The capped chunk (adjoint_tc) makes the forwards write nTR/tc checkpoints
# of planes·K·nA values; it is taken while they fit 16 GiB, a fifth of the
# card, and pick_tc's chunk (the one-thread route) past that.
LANE_CHK_BYTES = 16 << 30


class AdjointCfg(NamedTuple):
    r"""How K15, K18, K21, K24, K27, K30, K33 or K36 runs: ``route``
    ``'lanes'`` (``csrc/*_bwd_lanes.cu``: ``G`` lanes per atom, ``M`` order
    slots a lane, at most ``S`` chunk states an atom in shared memory, a
    block using tc of them) or ``'thread'`` (``csrc/spgr_bwd.cu``,
    ``cpmg_bwd.cu``, ``xspgr_bwd.cu``, ``xcpmg_bwd.cu``, ``xmt_bwd.cu``:
    one thread per atom, :func:`launch_cfg`; ``G`` 1)."""
    route: str
    G: int
    M: int
    S: int


def lane_capacity(K: int, itemsize: int, planes: int = 6):
    r"""The lane route's :class:`AdjointCfg` for ``K`` orders of ``planes``
    planes (6: K15, K18; 12: K21, K24, K27, K30; 8: K33, K36) at
    ``itemsize``, or None where an atom's orders do not fit: the narrowest
    group of 8, 16 or 32 lanes whose ``M = ⌈K/G⌉`` slots fit
    ``LANE_SLOTS_MAX``, and ``S`` the states of ``M·G`` orders that shared
    memory holds for ``LANE_BLOCKS`` blocks an SM (at most
    ``LANE_STATES_MAX``). Float32: K ≤ 160 for one pool (K 33: G 8, M 5, S
    4; K 48: G 16, M 3, S 7; K 16: G 8, M 2, S 8), K ≤ 96 for two (K 48: G
    16, M 3, S 4; K 33: G 16, M 3, S 4; K 24: G 8, M 3, S 4), K ≤ 160 for
    EPG-X(MT) (K 48: G 16, M 3, S 6; K 32: G 8, M 4, S 4); float64: K ≤
    64 (K 32: G 16, M 2, S 5), K ≤ 32 and K ≤ 96 (K 32: G 16, M 2, S
    4)."""
    mmax = LANE_SLOTS_MAX[(planes, itemsize)]
    for G in LANE_WIDTHS:
        M = -(-K // G)
        if M > mmax:
            continue
        stride = planes * M * G + (G if G < 32 else 0)
        slot = LANE_THREADS // G * stride * itemsize
        S = min(LANE_STATES_MAX,
                (SMEM_SM // LANE_BLOCKS - SMEM_RESERVED) // slot)
        if S >= 1:
            return AdjointCfg('lanes', G, M, S)
    return None


def adjoint_cfg(K: int, itemsize: int, planes: int, tc: int) -> AdjointCfg:
    r"""The route of K15/K18 (``planes`` 6), K21/K24/K27/K30 (12) or
    K33/K36 (8) at chunk length ``tc``, by shape alone: the lanes where :func:`lane_capacity`
    fits and ``tc`` ≤ its ``S``, else one thread per atom (K > 160 and
    float64 K > 64 of one pool; K > 96 and float64 K > 32 of two, the
    32-echo train's K 33 in float64 among them; or a ``tc`` past ``S``,
    which :func:`adjoint_tc` gives where the capped chunk's checkpoints
    would pass ``LANE_CHK_BYTES``)."""
    cap = lane_capacity(K, itemsize, planes)
    if cap is not None and tc <= cap.S:
        return cap
    return AdjointCfg('thread', 1, 0, 0)


def adjoint_tc(nTR: int, K: int, nA: int, itemsize: int,
               planes: int = 6) -> int:
    r"""The chunk length of the adjoints K15, K18, K21/K24, K27/K30 and
    K33/K36 (and so of their forwards K14, K17, K20, K23, K26, K29, K32,
    K35). Where the lane route takes the shape (:func:`lane_capacity`), the
    largest divisor of ``nTR`` within the ``S`` states its shared memory
    keeps: it allocates no scratch, so :func:`pick_tc`'s bound does not
    hold it. Where that chunk is shorter than :func:`pick_tc`'s (more
    checkpoints, each read once) it is taken as long as its ``nTR/tc``
    checkpoints of ``planes·K·nA`` values fit ``LANE_CHK_BYTES``, and past
    that :func:`pick_tc`'s (one thread per atom); where it is longer (fewer
    checkpoints), always. Elsewhere :func:`pick_tc`'s.

    At the paths' shapes in float32: T2 map 1,048,576 × 32, K 33: 4
    (pick_tc 2; 6.6 GB of checkpoints against 13.3); bench_mrf CPMG 65,536
    × 32: 4 (pick_tc 32; 0.42 GB); two-pool 65,536 × 400, K 48: 4 (pick_tc
    10; 15.1 GB against 6.0); at 131,072 atoms 5 (pick_tc's: 30.2 GB would
    pass the budget); one pool 65,536 × 400, K 48: 5 (pick_tc 25; 6.04 GB
    against 1.21); the MWF fit's block 262,144 × 32, K 33, two pools: 4
    (pick_tc's); the MWF map 1,048,576 × 32 at once, two pools: 4 (pick_tc
    1; 13.3 GB against 53.2); the qMT dictionary 65,536 × 400, K 48, 8
    planes: 5 (pick_tc 20; 8.05 GB against 2.01). The shapes whose chunk
    grows past pick_tc's are those where pick_tc < S: of the paths', the
    T2 map and the MWF map at once."""
    tc = pick_tc(nTR, K, nA, itemsize, planes)
    cap = lane_capacity(K, itemsize, planes)
    if cap is None:
        return tc
    lane_tc = largest_divisor_leq(nTR, cap.S)
    if lane_tc >= tc:
        return lane_tc
    chk = nTR // lane_tc * planes * K * max(nA, 1) * itemsize
    return lane_tc if chk <= LANE_CHK_BYTES else tc


# The forwards with checkpoints K14 (spgr_fwd_chk) and K17 (cpmg_fwd_chk)
# (6 planes), K20 (xspgr_fwd_chk), K23 (xspgr_v_fwd_chk), K26
# (xcpmg_fwd_chk) and K29 (xcpmg_v_fwd_chk) (12 planes) on their lane route
# (csrc/spgr_fwd_lanes.cu, csrc/cpmg_fwd_lanes.cu, csrc/xspgr_fwd_lanes.cu,
# csrc/xcpmg_fwd_lanes.cu): 128 threads a block, a
# group of G lanes per atom, at most FWD_SLOTS_MAX order slots a lane (by
# planes and itemsize). They keep one staging slot an atom in
# shared memory and no chunk states, so neither the chunk nor S bounds them;
# the slots are bounded by registers: ptxas -v shows no spills at 16 warps
# an SM (128 registers) for float32 M ≤ 3 and at 12 warps (168) for float32
# M 4-5 and float64 M 1-2, the occupancy each instance is built for
# (`lanes::kFwdBlocks`). M 6 (float32 K 161 at 32 lanes) is not built. The
# one-pool forwards' 6 planes take up to M 8 in float32 and 4 in float64,
# each instance built for the warps an SM its `kBlocks` names
# (csrc/cpmg_fwd_lanes.cu, csrc/spgr_fwd_lanes.cu; `kSlotsMax`).
FWD_SLOTS_MAX = {(6, 4): 8, (6, 8): 4, (12, 4): 5, (12, 8): 2}


class ForwardCfg(NamedTuple):
    r"""How K14, K17, K20, K23, K26 or K29 runs: ``route`` ``'lanes'``
    (``csrc/spgr_fwd_lanes.cu``, ``csrc/cpmg_fwd_lanes.cu``,
    ``csrc/xspgr_fwd_lanes.cu``, ``csrc/xcpmg_fwd_lanes.cu``: ``G`` lanes
    per atom, ``M`` order slots a lane) or ``'thread'``
    (``csrc/spgr_fwd.cu``, ``csrc/cpmg_fwd.cu``, ``csrc/xspgr_fwd.cu``,
    ``csrc/xcpmg_fwd.cu``: one thread per atom, :func:`launch_cfg`; ``G``
    1, ``M`` 0)."""
    route: str
    G: int
    M: int


def forward_cfg(K: int, itemsize: int, planes: int = 12) -> ForwardCfg:
    r"""The route of the forwards with checkpoints (``planes`` 12: K20, K23,
    K26, K29; 6: K14, K17) for ``K`` orders at ``itemsize``, by shape alone
    and for any chunk: the narrowest group of 8, 16 or 32 lanes whose ``M =
    ⌈K/G⌉`` slots fit ``FWD_SLOTS_MAX``, else one thread per atom. Two
    pools, float32: K ≤ 160 (K 24: G 8, M 3; K 33: G 8, M 5; K 48: G 16, M
    3; K 101: G 32, M 4), one thread at K 161 and 201; float64: K ≤ 64 (K
    24: G 16, M 2; K 33 and 48: G 32, M 2), one thread at K 81 and 101. One
    pool, float32: K ≤ 256 (K 33: G 8, M 5; K 65: G 16, M 5; K14 at
    bench_mrf_fisp and the MRF pipeline's dictionary, K 48: G 8, M 6; at its
    refinement, K 16: G 8, M 2), one thread at K 401 (the default K of a
    400-TR train at kshift 1); float64: K ≤ 128 (K 17: G 8, M 3; K 32 and
    33: G 8, M 4 and G 16, M 3), one thread at K 201. The checkpoints'
    layout is the same on both routes, so either adjoint route reads
    them."""
    mmax = FWD_SLOTS_MAX[(planes, itemsize)]
    for G in LANE_WIDTHS:
        M = -(-K // G)
        if M <= mmax:
            return ForwardCfg('lanes', G, M)
    return ForwardCfg('thread', 1, 0)


def _sizes(name, coef, par, cdiff, cfg):
    if par.dtype not in (torch.float32, torch.float64):
        raise TypeError(f'{name} takes float32 or float64, not {par.dtype}')
    if par.ndim != 2 or par.shape[0] != 7:
        raise ValueError(f'par must be (7, nA), got {tuple(par.shape)}')
    nA, nTR, K = par.shape[1], coef.shape[-1], cfg.K
    if K < 1 or cfg.kshift == 0:
        raise ValueError(f'{name} needs K >= 1 and kshift != 0, got K={K}, '
                         f'kshift={cfg.kshift}')
    for x, xname, shape in ((coef, 'coef', (cfg.nC, nTR)),
                            (par, 'par', (7, nA)),
                            (cdiff, 'cdiff', (3, K))):
        _check(x, xname, shape, par.dtype, par.device)
    return nA, nTR


def _entry(lib, name, dtype):
    r"""Kernel ``name``'s C entry point for ``dtype``."""
    return getattr(lib, f'mrphy_{name}_'
                   f'{"f32" if dtype == torch.float32 else "f64"}')


def _launch_fwd(coef, par, cdiff, cfg, tc):
    r"""``spgr_fwd`` (``tc`` None, one thread per atom) or ``spgr_fwd_chk``
    on the route :func:`forward_cfg` gives its shape at 6 planes: ``(sig,
    chk)``."""
    from mrphy_tpu_torch.kernels._build import library
    name = 'spgr_fwd' if tc is None else 'spgr_fwd_chk'
    nA, nTR = _sizes(name, coef, par, cdiff, cfg)
    dt, dev = par.dtype, par.device
    sig = torch.empty((nA, nTR, 2), dtype=dt, device=dev)
    chk = None
    route = ForwardCfg('thread', 1, 0)
    if tc is not None:
        _check_tc(nTR, tc)
        chk = torch.empty((nTR // tc, 6, cfg.K, nA), dtype=dt, device=dev)
        route = forward_cfg(cfg.K, par.element_size(), 6)
    lib, _ = library()
    if route.route == 'lanes':
        with torch.cuda.device(dev):
            err = _entry(lib, name + '_lanes', dt)(
                *map(_ptr, (coef, par, cdiff, sig, chk)), nA, nTR, cfg.nC,
                cfg.K, cfg.kshift, cfg.flags, tc, route.G, route.M,
                _stream(dev))
    else:
        threads, in_smem = launch_cfg(cfg.K, par.element_size())
        state = None if in_smem else torch.empty((6, cfg.K, nA), dtype=dt,
                                                 device=dev)
        with torch.cuda.device(dev):
            err = _entry(lib, name, dt)(
                *map(_ptr, (coef, par, cdiff, sig, chk, state)), nA, nTR,
                cfg.nC, cfg.K, cfg.kshift, cfg.flags, tc or nTR, threads,
                _stream(dev))
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return sig, chk


def _launch_bwd(coef, par, cdiff, cfg, chk, g, tc):
    from mrphy_tpu_torch.kernels._build import library
    nA, nTR = _sizes('spgr_bwd', coef, par, cdiff, cfg)
    _check_tc(nTR, tc)
    dt, dev = par.dtype, par.device
    _check(chk, 'chk', (nTR // tc, 6, cfg.K, nA), dt, dev)
    _check(g, 'g', (nA, nTR, 2), dt, dev)
    route = adjoint_cfg(cfg.K, par.element_size(), 6, tc)
    dpar = torch.empty((7, nA), dtype=dt, device=dev)
    # each warp's per-TR coefficient rows (summed over its atoms)
    dcf = torch.empty((-(-nA * route.G // 32), nTR, cfg.nC), dtype=dt,
                      device=dev)
    lib, _ = library()
    if route.route == 'lanes':
        with torch.cuda.device(dev):
            err = _entry(lib, 'spgr_bwd_lanes', dt)(
                *map(_ptr, (coef, par, cdiff, chk, g, dpar, dcf)), nA, nTR,
                cfg.nC, cfg.K, cfg.kshift, cfg.flags, tc, route.G, route.M,
                _stream(dev))
    else:
        threads, in_smem = launch_cfg(cfg.K, par.element_size())
        # phase 1's pre-RF states of one chunk (the first is chk's own) and
        # the adjoint state when it does not fit in shared memory
        scratch = torch.empty((max(tc - 1, 1), 6, cfg.K, nA), dtype=dt,
                              device=dev)
        hstate = None if in_smem else torch.empty((6, cfg.K, nA), dtype=dt,
                                                  device=dev)
        with torch.cuda.device(dev):
            err = _entry(lib, 'spgr_bwd', dt)(
                *map(_ptr, (coef, par, cdiff, chk, g, scratch, hstate, dpar,
                            dcf)), nA, nTR, cfg.nC, cfg.K, cfg.kshift,
                cfg.flags, tc, threads, _stream(dev))
    _raise_on(err, 'spgr_bwd')
    LAUNCHES['spgr_bwd'] += 1
    # the warps' partial rows, summed in a fixed order
    return dcf.sum(dim=0).T.contiguous(), dpar


def spgr_fwd(coef, par, cdiff, cfg: SpgrCfg):
    r"""The ``spgr_fwd`` kernel on CUDA tensors (contiguous, one dtype,
    float32 or float64), :func:`spgr_fwd_torch` on CPU tensors."""
    if _device_kind(par) == 'cpu':
        return spgr_fwd_torch(coef, par, cdiff, cfg)
    return _launch_fwd(coef, par, cdiff, cfg, None)[0]


def spgr_fwd_chk(coef, par, cdiff, cfg: SpgrCfg, *, tc: int):
    r"""The ``spgr_fwd_chk`` kernel on CUDA tensors,
    :func:`spgr_fwd_chk_torch` on CPU tensors."""
    if _device_kind(par) == 'cpu':
        return spgr_fwd_chk_torch(coef, par, cdiff, cfg, tc=tc)
    return _launch_fwd(coef, par, cdiff, cfg, tc)


def spgr_bwd(coef, par, cdiff, cfg: SpgrCfg, chk, g, *, tc: int):
    r"""The ``spgr_bwd`` kernel on CUDA tensors, :func:`spgr_bwd_torch` on
    CPU tensors."""
    if _device_kind(par) == 'cpu':
        return spgr_bwd_torch(coef, par, cdiff, cfg, chk, g, tc=tc)
    return _launch_bwd(coef, par, cdiff, cfg, chk, g, tc)


class _Spgr(torch.autograd.Function):

    @staticmethod
    def forward(ctx, plain, cfg, coef, par, cdiff):
        ctx.plain, ctx.cfg = plain, cfg
        if not any(ctx.needs_input_grad[2:4]):
            if plain:
                return spgr_fwd_torch(coef, par, cdiff, cfg)
            return _launch_fwd(coef, par, cdiff, cfg, None)[0]
        tc = adjoint_tc(coef.shape[1], cfg.K, par.shape[1],
                        par.element_size())
        if plain:
            sig, chk = spgr_fwd_chk_torch(coef, par, cdiff, cfg, tc=tc)
        else:
            sig, chk = _launch_fwd(coef, par, cdiff, cfg, tc)
        ctx.tc = tc
        ctx.save_for_backward(coef, par, cdiff, chk)
        return sig

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        coef, par, cdiff, chk = ctx.saved_tensors
        g = g.contiguous()
        if ctx.plain:
            dcoef, dpar = spgr_bwd_torch(coef, par, cdiff, ctx.cfg, chk, g,
                                         tc=ctx.tc)
        else:
            dcoef, dpar = _launch_bwd(coef, par, cdiff, ctx.cfg, chk, g,
                                      ctx.tc)
        return None, None, dcoef, dpar, None


def spgr(coef, par, cdiff, cfg: SpgrCfg):
    r"""The SPGR train ``sig (nA, nTR, 2)``: the kernels on CUDA tensors
    (``spgr_fwd``, or ``spgr_fwd_chk`` and ``spgr_bwd`` when a gradient is
    needed), their plain versions on CPU tensors. Differentiable w.r.t.
    ``coef`` and ``par``."""
    plain = _device_kind(par) == 'cpu'
    return _Spgr.apply(plain, cfg, coef.contiguous(), par.contiguous(),
                       cdiff.contiguous())


# ==========================================================================
# CPMG: the kernels
# ==========================================================================

def _cpmg_sizes(name, coef, par, dq, cdiff, cfg):
    if par.dtype not in (torch.float32, torch.float64):
        raise TypeError(f'{name} takes float32 or float64, not {par.dtype}')
    if par.ndim != 2 or par.shape[0] != 7:
        raise ValueError(f'par must be (7, nA), got {tuple(par.shape)}')
    nA, nE = par.shape[1], cfg.nE
    if nE < 1:
        raise ValueError(f'{name} needs nE >= 1, got {nE}')
    for x, xname, shape in ((coef, 'coef', (cfg.nC, nE)),
                            (par, 'par', (7, nA)), (dq, 'dq', (1, nA)),
                            (cdiff, 'cdiff', (3, cfg.K))):
        _check(x, xname, shape, par.dtype, par.device)
    return nA, nE


def _launch_cpmg_fwd(coef, par, dq, cdiff, cfg, tc):
    r"""``cpmg_fwd`` (``tc`` None, one thread per atom) or ``cpmg_fwd_chk``
    on the route :func:`forward_cfg` gives its shape: ``(er, ei, chk)``."""
    from mrphy_tpu_torch.kernels._build import library
    name = 'cpmg_fwd' if tc is None else 'cpmg_fwd_chk'
    nA, nE = _cpmg_sizes(name, coef, par, dq, cdiff, cfg)
    dt, dev = par.dtype, par.device
    threads, in_smem = launch_cfg(cfg.K, par.element_size())
    er = torch.empty((nE, nA), dtype=dt, device=dev)
    ei = torch.empty((nE, nA), dtype=dt, device=dev)
    chk = None
    route = ForwardCfg('thread', 1, 0)
    if tc is not None:
        _check_tc(nE, tc)
        chk = torch.empty((nE // tc, 6, cfg.K, nA), dtype=dt, device=dev)
        route = forward_cfg(cfg.K, par.element_size(), 6)
    lib, _ = library()
    if route.route == 'lanes':
        with torch.cuda.device(dev):
            err = _entry(lib, name + '_lanes', dt)(
                *map(_ptr, (coef, par, dq, cdiff, er, ei, chk)), nA, nE,
                cfg.nC, cfg.flags, tc, route.G, route.M, _stream(dev))
    else:
        state = None if in_smem else torch.empty((6, cfg.K, nA), dtype=dt,
                                                 device=dev)
        with torch.cuda.device(dev):
            err = _entry(lib, name, dt)(
                *map(_ptr, (coef, par, dq, cdiff, er, ei, chk, state)), nA,
                nE, cfg.nC, cfg.flags, tc or nE, threads, _stream(dev))
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return er, ei, chk


def _launch_cpmg_bwd(coef, par, dq, cdiff, cfg, chk, gr, gi, tc):
    from mrphy_tpu_torch.kernels._build import library
    nA, nE = _cpmg_sizes('cpmg_bwd', coef, par, dq, cdiff, cfg)
    _check_tc(nE, tc)
    dt, dev = par.dtype, par.device
    _check(chk, 'chk', (nE // tc, 6, cfg.K, nA), dt, dev)
    _check(gr, 'gr', (nE, nA), dt, dev)
    _check(gi, 'gi', (nE, nA), dt, dev)
    route = adjoint_cfg(cfg.K, par.element_size(), 6, tc)
    dpar = torch.empty((8, nA), dtype=dt, device=dev)
    # each warp's per-echo coefficient rows (summed over its atoms)
    dcf = torch.empty((-(-nA * route.G // 32), nE, cfg.nC), dtype=dt,
                      device=dev)
    lib, _ = library()
    if route.route == 'lanes':
        with torch.cuda.device(dev):
            err = _entry(lib, 'cpmg_bwd_lanes', dt)(
                *map(_ptr, (coef, par, dq, cdiff, chk, gr, gi, dpar, dcf)),
                nA, nE, cfg.nC, cfg.flags, tc, route.G, route.M,
                _stream(dev))
    else:
        threads, in_smem = launch_cfg(cfg.K, par.element_size())
        # phase 1's pre-echo states of one chunk (the first is chk's own)
        # and the adjoint state when it does not fit in shared memory
        scratch = torch.empty((max(tc - 1, 1), 6, cfg.K, nA), dtype=dt,
                              device=dev)
        hstate = None if in_smem else torch.empty((6, cfg.K, nA), dtype=dt,
                                                  device=dev)
        with torch.cuda.device(dev):
            err = _entry(lib, 'cpmg_bwd', dt)(
                *map(_ptr, (coef, par, dq, cdiff, chk, gr, gi, scratch,
                            hstate, dpar, dcf)), nA, nE, cfg.nC, cfg.flags,
                tc, threads, _stream(dev))
    _raise_on(err, 'cpmg_bwd')
    LAUNCHES['cpmg_bwd'] += 1
    # the warps' partial rows, summed in a fixed order
    return dcf.sum(dim=0).T.contiguous(), dpar


def cpmg_fwd(coef, par, dq, cdiff, cfg: CpmgCfg):
    r"""The ``cpmg_fwd`` kernel on CUDA tensors (contiguous, one dtype,
    float32 or float64), :func:`cpmg_fwd_torch` on CPU tensors."""
    if _device_kind(par) == 'cpu':
        return cpmg_fwd_torch(coef, par, dq, cdiff, cfg)
    return _launch_cpmg_fwd(coef, par, dq, cdiff, cfg, None)[:2]


def cpmg_fwd_chk(coef, par, dq, cdiff, cfg: CpmgCfg, *, tc: int):
    r"""The ``cpmg_fwd_chk`` kernel on CUDA tensors,
    :func:`cpmg_fwd_chk_torch` on CPU tensors."""
    if _device_kind(par) == 'cpu':
        return cpmg_fwd_chk_torch(coef, par, dq, cdiff, cfg, tc=tc)
    return _launch_cpmg_fwd(coef, par, dq, cdiff, cfg, tc)


def cpmg_bwd(coef, par, dq, cdiff, cfg: CpmgCfg, chk, gr, gi, *, tc: int):
    r"""The ``cpmg_bwd`` kernel on CUDA tensors, :func:`cpmg_bwd_torch` on
    CPU tensors."""
    if _device_kind(par) == 'cpu':
        return cpmg_bwd_torch(coef, par, dq, cdiff, cfg, chk, gr, gi, tc=tc)
    return _launch_cpmg_bwd(coef, par, dq, cdiff, cfg, chk, gr, gi, tc)


class _Cpmg(torch.autograd.Function):

    @staticmethod
    def forward(ctx, plain, cfg, coef, par, dq, cdiff):
        ctx.plain, ctx.cfg = plain, cfg
        if not any(ctx.needs_input_grad[2:5]):
            if plain:
                return cpmg_fwd_torch(coef, par, dq, cdiff, cfg)
            return _launch_cpmg_fwd(coef, par, dq, cdiff, cfg, None)[:2]
        tc = adjoint_tc(cfg.nE, cfg.K, par.shape[1], par.element_size())
        if plain:
            er, ei, chk = cpmg_fwd_chk_torch(coef, par, dq, cdiff, cfg,
                                             tc=tc)
        else:
            er, ei, chk = _launch_cpmg_fwd(coef, par, dq, cdiff, cfg, tc)
        ctx.tc = tc
        ctx.save_for_backward(coef, par, dq, cdiff, chk)
        return er, ei

    @staticmethod
    @once_differentiable
    def backward(ctx, gr, gi):
        coef, par, dq, cdiff, chk = ctx.saved_tensors
        args = (coef, par, dq, cdiff, ctx.cfg, chk, gr.contiguous(),
                gi.contiguous())
        if ctx.plain:
            dcoef, dpar = cpmg_bwd_torch(*args, tc=ctx.tc)
        else:
            dcoef, dpar = _launch_cpmg_bwd(*args, ctx.tc)
        return None, None, dcoef, dpar[:7], dpar[7:], None


def cpmg(coef, par, dq, cdiff, cfg: CpmgCfg):
    r"""The CPMG echoes ``(er, ei)``, each ``(nE, nA)``: the kernels on CUDA
    tensors (``cpmg_fwd``, or ``cpmg_fwd_chk`` and ``cpmg_bwd`` when a
    gradient is needed), their plain versions on CPU tensors.
    Differentiable w.r.t. ``coef``, ``par`` and ``dq``."""
    plain = _device_kind(par) == 'cpu'
    return _Cpmg.apply(plain, cfg, coef.contiguous(), par.contiguous(),
                       dq.contiguous(), cdiff.contiguous())
