r"""The two-pool EPG-X kernels: wrappers, plain PyTorch versions and launch
counts.

Eighteen kernels, each the Hopper counterpart of a TPU kernel of
:mod:`mrphy_tpu.ops.epg_pallas`: six for the gradient-spoiled train of a
two-pool exchanging system (:func:`mrphy_tpu_torch.ops.epg.epgx_spgr`), at
a fixed TR and over a variable-TR train, six for its CPMG echo train
(:func:`mrphy_tpu_torch.ops.epg.epgx_cpmg`, below), at a fixed echo
spacing and over an echo-spacing train, and six for the bound-pool
EPG-X(MT) train of qMT (:func:`mrphy_tpu_torch.ops.epg.epgx_mt_spgr`, last
below) at a fixed TR and over a variable-TR train:

- ``xspgr_fwd`` (``csrc/xspgr_fwd.cu``, replaces ``_epgx_kernel``): per
  atom and TR, the RF mix on pool a and on pool b, the echo (the total
  ``Fa+(0) + Fb+(0)`` demodulated by the transmit phase), the exact
  exchange–relaxation of every order (the complex 2×2 propagator on
  ``F+``, its conjugate on ``F−``, the real 2×2 on ``Z`` with the affine
  recovery into ``Z(0)``), and ``|kshift|`` unit shifts of both pools.
- ``xspgr_fwd_chk`` (the same source, replaces ``_xspgr_fwd_chk_kernel``):
  the same train, also writing the state at the start of every chunk of
  ``tc`` TRs.
- ``xspgr_bwd`` (``csrc/xspgr_bwd_lanes.cu`` and ``csrc/xspgr_bwd.cu``,
  replaces ``_xspgr_bwd_kernel``): the two-phase chunk adjoint. Per chunk,
  newest first, phase 1 re-runs the forward from the chunk's start state
  and stores every pre-RF state; phase 2 walks them backwards (the shift's
  transpose, the exchange–relaxation transpose with its 14 entry
  gradients, the echo's cotangent into both pools' ``F+(0)``, the RF mix's
  coefficients and transpose on both pools). Two hand-written routes,
  chosen by shape alone (:func:`mrphy_tpu_torch.kernels.epg.adjoint_cfg`):
  a group of lanes per atom over the orders with the chunk's states in
  shared memory where they fit (the entry points' chunk,
  :func:`_adjoint_chunk`, is capped so), one thread per atom otherwise.
- ``xspgr_v_fwd``, ``xspgr_v_fwd_chk`` and ``xspgr_v_bwd`` (the same two
  sources, instances for a variable-TR train; replace ``_epgx_v_kernel``,
  ``_xv_fwd_chk_kernel`` and ``_xv_bwd_kernel``): the same recursions
  with the 14 propagator entries of each step read from per-step planes,
  and the adjoint writing each step's 14 entry gradients (``dpkt``)
  instead of summing them over the train.

Arguments, as ``_epgx_dispatch`` (``epg_pallas.py:584-621``) builds them:

- ``coef (9, nTR)``: SPGR's per-TR rows ``[cos²(α/2), sin²(α/2), sin α,
  cos α, cos φ, sin φ, cos 2φ, sin 2φ, α]``;
- ``par (17, nA)``: the per-atom rows ``[E00r, E00i, E01r, E01i, E10r,
  E10i, E11r, E11i, Z00, Z01, Z10, Z11, ra, rb, M0a, M0b, b1]``: the
  transverse propagator's entries (re, im), the longitudinal one's, the
  recovery into ``Za(0)``/``Zb(0)``, the initial ``Z(0)`` of each pool and
  the transmit scale;
- ``cfg``: :class:`XspgrCfg`, the static switches.

Over a variable-TR train (``_epgx_v_dispatch``, ``epg_pallas.py:2972-2995``)
``par`` splits in two: ``pk (3, nA) = [M0a, M0b, b1]`` and the per-step
planes ``pkt (nTR, 14, nA)``, the propagator's 14 entries over each
interval ``tr[t]``.

An atom's state is 12 planes of K orders, pool a's rows ``[F+ re, F+ im,
F− re, F− im, Z re, Z im]`` then pool b's. The forward returns the echoes
``sig (nA, nTR, 2)`` and, with ``tc``, the chunk-start states ``chk (nTR /
tc, 12, K, nA)``. The adjoint takes ``chk`` and the echoes' cotangent and
returns ``dcoef (9, nTR)`` (summed over atoms) and ``dpar (17, nA)``: the
14 propagator entries' gradients, ``dM0a``/``dM0b`` (the cotangents of the
initial ``Za(0)``/``Zb(0)``) and ``db1``; over a variable-TR train ``dpk
(3, nA) = [dM0a, dM0b, db1]`` and ``dpkt (nTR, 14, nA)``, each step's entry
gradients. The gradients of T1a, T2a, T1b, T2b, kab, kba, tr (every
element of a train), M0a, M0b, dfb and b1 w.r.t. these rows come from
torch autograd of their construction (:func:`mrphy_tpu_torch.ops.epg.
_xspgr_rows`); ``M0a``/``M0b`` reach the echoes twice, through ``Z(0)``
and through the recovery, and autograd adds both.

Each kernel has beside it its plain PyTorch version (``*_torch``: a loop over
TRs on ``(nA, K)`` planes in the kernel's order of operations, the single-pool
SPGR step functions of :mod:`mrphy_tpu_torch.kernels.epg` for each pool's mix
and shift, sums over the orders in the order of the kernel's route; the
adjoint's uses no autograd) and a launch count, ``LAUNCHES[name]``, raised by
one at every launch of the kernel and nowhere else. :func:`xspgr` is their
``torch.autograd.Function``: ``xspgr_fwd`` with no gradient needed, otherwise
``xspgr_fwd_chk`` with ``xspgr_bwd`` as its backward (the kernels on CUDA
tensors, no fallback; the plain versions on CPU tensors); :func:`xspgr_v` the
same for the variable-TR kernels. Their chunk is :func:`_adjoint_chunk`'s
(``adjoint_tc`` for 12 planes); the one-thread route's per-chunk scratch lies
in device memory.

The two-pool CPMG kernels (``csrc/xcpmg_fwd.cu``; the adjoint's two routes
``csrc/xcpmg_bwd_lanes.cu`` and ``csrc/xcpmg_bwd.cu``, chosen by shape alone as
``xspgr_bwd``'s) are the same three for the spin-echo train of myelin-water
mapping: ``xcpmg_fwd`` (replaces ``_xcpmg_kernel``), ``xcpmg_fwd_chk``
(``_xcpmg_fwd_chk_kernel``) and ``xcpmg_bwd`` (``_xcpmg_bwd_kernel``). From the
closed-form state a π/2 excitation about ``φ_ex`` leaves on the equilibrium
(``F± = (sin φ_ex ∓ i·cos φ_ex)·M0p``, ``Z = 0``, per pool), per echo: the
exchange–relaxation over esp/2 and a unit shift of both pools, the refocusing
mix about +x on both pools (CPMG's single-pool ``_mix``), the same half again,
the echo ``Fa+(0) + Fb+(0)``. Arguments, as ``_xcpmg_dispatch``
(``epg_pallas.py:781-819``) builds them: ``coef (5, nE)`` ``[cos²(α/2),
sin²(α/2), sin α, cos α, α]``, ``pk (19, nA)`` ``[E00r, …, Z11, ra, rb, cos
φ_ex, sin φ_ex, M0a, M0b, b1]`` (the propagator over esp/2), ``cfg``
:class:`XcpmgCfg`. The echoes come as ``(er, ei)``, each ``(nE, nA)``; the
adjoint returns ``dcoef (5, nE)`` and ``dpk (19, nA)`` (the 14 entries'
gradients summed over both halves of every echo, then those of ``cos φ_ex``,
``sin φ_ex``, ``M0a``, ``M0b`` through the initial state, and ``db1``).
:func:`xcpmg` is their autograd Function.

Over an echo-spacing train (``_xcpmg_v_dispatch``,
``epg_pallas.py:3652-3674``) the same sources give ``xcpmg_v_fwd``
(replaces ``_xcpmg_v_kernel``), ``xcpmg_v_fwd_chk`` (``_xcv_fwd_chk_kernel``)
and ``xcpmg_v_bwd`` (``_xcv_bwd_kernel``): ``pk (5, nA) = [cos φ_ex, sin
φ_ex, M0a, M0b, b1]`` and the per-echo planes ``pkt (nE, 14, nA)``, the
propagator over ``esp[t]/2``, which both halves of echo ``t`` apply; the
adjoint returns ``dpk (5, nA)`` (``dM0a``/``dM0b`` through the initial
state only) and ``dpkt (nE, 14, nA)``, each echo's entry gradients, its
second half's and its first's added. :func:`xcpmg_v` is their autograd
Function.

The EPG-X(MT) kernels (``csrc/xmt_fwd.cu``, ``csrc/xmt_bwd.cu``) carry 8
planes an atom: pool a's F+, F−, Z and the bound pool's Z, which has no F
states. ``xmt_fwd`` (replaces ``_mt_kernel``), ``xmt_fwd_chk``
(``_mt_fwd_chk_kernel``) and ``xmt_bwd`` (``_mt_bwd_kernel``): per atom and
TR, the RF mix on pool a and the saturation ``Zb ← exp(−wt_t·wscale)·Zb``,
the echo (pool a's ``F+(0)`` demodulated), pool a's transverse decay
``E2a``, the real 2×2 exchange of the Z pair with the recovery into
``Z(0)``, and ``|kshift|`` unit shifts of pool a. Arguments, as
``_mt_dispatch`` (``epg_pallas.py:956-989``) builds them: ``coef (10,
nTR)``, SPGR's nine rows and ``wt``; ``pk (11, nA) = [Z00, Z01, Z10, Z11,
ra, rb, E2a, M0a, M0b, b1, wscale]``; ``cfg`` :class:`XmtCfg`. The forward
returns ``sig (nA, nTR, 2)`` and, with ``tc``, ``chk (nTR / tc, 8, K,
nA)``; the adjoint ``dcoef (10, nTR)`` (summed over atoms, the per-TR
``∂wt`` among them) and ``dpk (11, nA)``. :func:`xmt` is their autograd
Function, :func:`xmt_spgr` the qMT dictionary's entry point with a per-atom
``wscale``.

Over a variable-TR train (``_mt_v_dispatch``, ``epg_pallas.py:4432-4459``)
the same two sources give ``xmt_v_fwd`` (replaces ``_mtv_kernel``),
``xmt_v_fwd_chk`` (``_mtv_fwd_chk_kernel``) and ``xmt_v_bwd``
(``_mtv_bwd_kernel``): ``pk (4, nA) = [M0a, M0b, b1, wscale]`` and the
per-TR planes ``pkt (nTR, 7, nA)``, the entries ``[Z00, Z01, Z10, Z11, ra,
rb, E2a]`` over each interval ``tr[t]``
(:func:`mrphy_tpu_torch.ops.epg._mt_step_entries`); the adjoint returns
``dcoef (10, nTR)``, ``dpk (4, nA) = [dM0a, dM0b, db1, dwscale]``
(``dM0a``/``dM0b`` through the initial state only; autograd of the planes
adds their share through the recovery) and ``dpkt (nTR, 7, nA)``, each TR's
entry gradients. :func:`xmt_v` is their autograd Function; :func:`xmt_spgr`
takes it for a ``(nTR,)`` ``tr``.
"""

from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from mrphy_tpu_torch.kernels.bloch import (_check, _check_tc, _device_kind,
                                           _ptr, _raise_on, _stream)
from mrphy_tpu_torch.kernels.epg import (_at0, _entry, _flip_trig,
                                         _group_sum, _ksum, _lane_parts,
                                         _lane_sum, _mix, _mix0_terms, _mix_T,
                                         _shift, _shift_T, _trig, _warp_sums,
                                         adjoint_cfg, adjoint_tc, launch_cfg,
                                         pick_tc)

__all__ = ['LAUNCHES', 'PLANES', 'XspgrCfg', 'xspgr', 'xspgr_fwd',
           'xspgr_fwd_torch', 'xspgr_fwd_chk', 'xspgr_fwd_chk_torch',
           'xspgr_bwd', 'xspgr_bwd_torch', 'xspgr_v', 'xspgr_v_fwd',
           'xspgr_v_fwd_torch', 'xspgr_v_fwd_chk', 'xspgr_v_fwd_chk_torch',
           'xspgr_v_bwd', 'xspgr_v_bwd_torch', 'XcpmgCfg', 'xcpmg',
           'xcpmg_fwd', 'xcpmg_fwd_torch', 'xcpmg_fwd_chk',
           'xcpmg_fwd_chk_torch', 'xcpmg_bwd', 'xcpmg_bwd_torch', 'xcpmg_v',
           'xcpmg_v_fwd', 'xcpmg_v_fwd_torch', 'xcpmg_v_fwd_chk',
           'xcpmg_v_fwd_chk_torch', 'xcpmg_v_bwd', 'xcpmg_v_bwd_torch',
           'PLANES_MT', 'XmtCfg', 'xmt', 'xmt_spgr', 'xmt_fwd',
           'xmt_fwd_torch', 'xmt_fwd_chk', 'xmt_fwd_chk_torch', 'xmt_bwd',
           'xmt_bwd_torch', 'xmt_v', 'xmt_v_fwd', 'xmt_v_fwd_torch',
           'xmt_v_fwd_chk', 'xmt_v_fwd_chk_torch', 'xmt_v_bwd',
           'xmt_v_bwd_torch']

LAUNCHES = {'xspgr_fwd': 0, 'xspgr_fwd_chk': 0, 'xspgr_bwd': 0,
            'xspgr_v_fwd': 0, 'xspgr_v_fwd_chk': 0, 'xspgr_v_bwd': 0,
            'xcpmg_fwd': 0, 'xcpmg_fwd_chk': 0, 'xcpmg_bwd': 0,
            'xcpmg_v_fwd': 0, 'xcpmg_v_fwd_chk': 0, 'xcpmg_v_bwd': 0,
            'xmt_fwd': 0, 'xmt_fwd_chk': 0, 'xmt_bwd': 0,
            'xmt_v_fwd': 0, 'xmt_v_fwd_chk': 0, 'xmt_v_bwd': 0}

# The state planes of one atom: both pools' F+, F−, Z (re, im).
PLANES = 12
NPAR = 17
# The propagator entries of one step, and the variable-TR train's other
# per-atom rows [M0a, M0b, b1].
NENT = 14
NPK = 3
# The CPMG train's per-atom rows: the 14 entries, [cos φ_ex, sin φ_ex, M0a,
# M0b, b1]; over an echo-spacing train the last five.
NXC = 19
NXCV = 5
# The EPG-X(MT) train: an atom's state planes (pool a's F+, F−, Z and pool
# b's Z, re and im), its per-atom rows [Z00, Z01, Z10, Z11, ra, rb, E2a,
# M0a, M0b, b1, wscale] and its per-TR rows (SPGR's nine and wt); over a
# variable-TR train the propagator entries of one TR (the first 7 rows) and
# the other per-atom rows [M0a, M0b, b1, wscale].
PLANES_MT = 8
NPK_MT = 11
NC_MT = 10
NENT_MT = 7
NPK_MTV = 4


class XspgrCfg(NamedTuple):
    r"""The static switches of one EPG-X SPGR train: ``K`` modelled
    orders, the spoiler's ``kshift`` k-quanta per TR and per-atom ``b1``."""
    K: int
    kshift: int
    has_b1: bool

    nC = 9

    @property
    def flags(self) -> int:
        return int(self.has_b1)


class XcpmgCfg(NamedTuple):
    r"""The static switches of one EPG-X CPMG train: ``K`` modelled orders
    (``nE + 1`` from :func:`mrphy_tpu_torch.ops.epg.epgx_cpmg`, at least 2)
    and per-atom ``b1``."""
    K: int
    has_b1: bool

    nC = 5

    @property
    def flags(self) -> int:
        return int(self.has_b1)


# ==========================================================================
# The plain versions
# ==========================================================================

def _xrelax(p, x):
    r"""The exchange–relaxation over TR of a mixed two-pool state ``x``
    (the complex propagator E on F+, its conjugate on F−, the real Z with
    the recovery into order 0)."""
    (E00r, E00i, E01r, E01i, E10r, E10i, E11r, E11i,
     Z00, Z01, Z10, Z11, ra, rb) = p[:14]
    Par, Pai, Mar, Mai, Zar, Zai, Pbr, Pbi, Mbr, Mbi, Zbr, Zbi = x
    Z2ar = Z00 * Zar + Z01 * Zbr
    Z2br = Z10 * Zar + Z11 * Zbr
    return ((E00r * Par - E00i * Pai) + (E01r * Pbr - E01i * Pbi),
            (E00r * Pai + E00i * Par) + (E01r * Pbi + E01i * Pbr),
            (E00r * Mar + E00i * Mai) + (E01r * Mbr + E01i * Mbi),
            (E00r * Mai - E00i * Mar) + (E01r * Mbi - E01i * Mbr),
            _at0(Z2ar, Z2ar[:, :1] + ra),
            Z00 * Zai + Z01 * Zbi,
            (E10r * Par - E10i * Pai) + (E11r * Pbr - E11i * Pbi),
            (E10r * Pai + E10i * Par) + (E11r * Pbi + E11i * Pbr),
            (E10r * Mar + E10i * Mai) + (E11r * Mbr + E11i * Mbi),
            (E10r * Mai - E10i * Mar) + (E11r * Mbi - E11i * Mbr),
            _at0(Z2br, Z2br[:, :1] + rb),
            Z10 * Zai + Z11 * Zbi)


def _xrelax_T(p, h, x):
    r"""The transpose of :func:`_xrelax` at its input ``x``, given the
    cotangent ``h`` of its output: ``(the cotangent of x, terms, (∂ra,
    ∂rb))``, ``terms`` the 12 per-order terms whose sums over the orders
    are the entries' gradients ``[∂E00r, ∂E00i, …, ∂E11i, ∂Z00, …,
    ∂Z11]``. The cotangent takes conj(E)ᵀ on F+, Eᵀ on F−, Zᵀ on Z."""
    (E00r, E00i, E01r, E01i, E10r, E10i, E11r, E11i,
     Z00, Z01, Z10, Z11) = p[:12]
    hPar, hPai, hMar, hMai, hZar, hZai, hPbr, hPbi, hMbr, hMbi, hZbr, hZbi = h
    Par, Pai, Mar, Mai, Zar, Zai, Pbr, Pbi, Mbr, Mbi, Zbr, Zbi = x
    terms = [
        hPar * Par + hPai * Pai + hMar * Mar + hMai * Mai,
        -hPar * Pai + hPai * Par + hMar * Mai - hMai * Mar,
        hPar * Pbr + hPai * Pbi + hMar * Mbr + hMai * Mbi,
        -hPar * Pbi + hPai * Pbr + hMar * Mbi - hMai * Mbr,
        hPbr * Par + hPbi * Pai + hMbr * Mar + hMbi * Mai,
        -hPbr * Pai + hPbi * Par + hMbr * Mai - hMbi * Mar,
        hPbr * Pbr + hPbi * Pbi + hMbr * Mbr + hMbi * Mbi,
        -hPbr * Pbi + hPbi * Pbr + hMbr * Mbi - hMbi * Mbr,
        hZar * Zar + hZai * Zai,
        hZar * Zbr + hZai * Zbi,
        hZbr * Zar + hZbi * Zai,
        hZbr * Zbr + hZbi * Zbi]
    cot = (E00r * hPar + E00i * hPai + E10r * hPbr + E10i * hPbi,
           -E00i * hPar + E00r * hPai - E10i * hPbr + E10r * hPbi,
           E00r * hMar - E00i * hMai + E10r * hMbr - E10i * hMbi,
           E00i * hMar + E00r * hMai + E10i * hMbr + E10r * hMbi,
           Z00 * hZar + Z10 * hZbr,
           Z00 * hZai + Z10 * hZbi,
           E01r * hPar + E01i * hPai + E11r * hPbr + E11i * hPbi,
           -E01i * hPar + E01r * hPai - E11i * hPbr + E11r * hPbi,
           E01r * hMar - E01i * hMai + E11r * hMbr - E11i * hMbi,
           E01i * hMar + E01r * hMai + E11i * hMbr + E11r * hMbi,
           Z01 * hZar + Z11 * hZbr,
           Z01 * hZai + Z11 * hZbi)
    return cot, terms, (hZar[:, :1], hZbr[:, :1])


def _mix_terms(h, x):
    r"""One pool's per-order terms of the RF mix's coefficient gradients
    ``(∂ca2, ∂sc2, ∂ss2, ∂ss, ∂sc, ∂hs, ∂hc, ∂ca)``: the cotangent ``h`` of
    the mixed state against the pre-RF state ``x``."""
    hFpr, hFpi, hFmr, hFmi, hZr, hZi = h
    Fpr, Fpi, Fmr, Fmi, Zr, Zi = x
    return [hFpr * Fpr + hFpi * Fpi + hFmr * Fmr + hFmi * Fmi,
            hFpr * Fmr + hFpi * Fmi + hFmr * Fpr + hFmi * Fpi,
            -hFpr * Fmi + hFpi * Fmr + hFmr * Fpi - hFmi * Fpr,
            (hFpr + hFmr) * Zr + (hFpi + hFmi) * Zi,
            (hFpr - hFmr) * Zi - (hFpi - hFmi) * Zr,
            -hZr * (Fpr + Fmr) - hZi * (Fpi + Fmi),
            hZr * (Fpi - Fmi) + hZi * (Fmr - Fpr),
            hZr * Zr + hZi * Zi]


def _xmix(tg, s):
    return _mix(tg, s[:6]) + _mix(tg, s[6:])


def _xstep(coef, t, p, cfg, s):
    r"""TR ``t`` from the pre-RF state ``s``, ``p`` the step's 17 rows:
    ``(next pre-RF state, echo (nA, 2))``."""
    tg = _trig(coef, t, p[16], cfg.has_b1)
    s1 = _xmix(tg, s)
    c1, s1c = tg[4], tg[5]
    fr = s1[0][:, :1] + s1[6][:, :1]
    fi = s1[1][:, :1] + s1[7][:, :1]
    echo = torch.cat([c1 * fr + s1c * fi, c1 * fi - s1c * fr], dim=1)
    s2 = _xrelax(p, s1)
    return _shift(s2[:6], cfg.kshift) + _shift(s2[6:], cfg.kshift), echo


def _fixed_rows(par):
    r"""Every step's rows at a fixed interval: ``par``'s (17 of SPGR, 19 of
    CPMG, 11 of EPG-X(MT)), each `(nA, 1)`."""
    p = par.unsqueeze(-1)
    return lambda t: p


def _train_rows(pk, pkt):
    r"""Step ``t``'s rows over an interval train: the planes' entries of
    step ``t`` (the two-pool trains' 14, EPG-X(MT)'s 7), then ``pk``'s
    (SPGR's ``[M0a, M0b, b1]``, CPMG's ``[cos φ_ex, sin φ_ex, M0a, M0b,
    b1]``, EPG-X(MT)'s ``[M0a, M0b, b1, wscale]``), each `(nA, 1)`."""
    pv, pt = tuple(pk.unsqueeze(-1)), pkt.unsqueeze(-1)
    return lambda t: tuple(pt[t]) + pv


def _xfwd(coef, rows, cfg, tc):
    r"""The train from the equilibrium state, ``rows(t)`` step ``t``'s 17
    rows: ``(echoes (nA, nTR, 2), chk or None)``."""
    nTR = coef.shape[1]
    p = rows(0)
    z = torch.zeros(p[14].shape[0], cfg.K, dtype=p[14].dtype,
                    device=p[14].device)
    s = (z, z, z, z, _at0(z, p[14]), z, z, z, z, z, _at0(z, p[15]), z)
    echoes = []
    chk = z.new_empty((nTR // tc, PLANES, cfg.K, z.shape[0])) if tc \
        else None
    for t in range(nTR):
        if tc and t % tc == 0:
            chk[t // tc] = torch.stack(s).transpose(1, 2)  # (12, K, nA)
        s, echo = _xstep(coef, t, rows(t), cfg, s)
        echoes.append(echo)
    return torch.stack(echoes, dim=1), chk             # (nA, nTR, 2)


def _xbwd(coef, rows, cfg, chk, g, tc, take):
    r"""The two-phase chunk adjoint of :func:`_xfwd` from its checkpoints
    ``chk`` at chunk length ``tc`` and the echoes' cotangent ``g (nA, nTR,
    2)``, with no autograd. Per TR, newest first: the shift's transpose on
    both pools, the exchange–relaxation transpose (:func:`_xrelax_T`), the
    echo's cotangent into both pools' ``F+(0)``, the mix's coefficient
    terms summed over the pools order by order, the mix's transpose. Every
    sum over the orders is taken in the order of the route the kernel takes
    at this shape (:func:`~mrphy_tpu_torch.kernels.epg.adjoint_cfg`,
    ``_lane_sum``), and the per-TR rows by warps of ``32 / G`` atoms
    (:func:`~mrphy_tpu_torch.kernels.epg._warp_sums`), then over the warps,
    as the kernel and its wrapper sum them. ``take(t, d)`` receives step ``t``'s 14 entry gradients ``d`` (each
    `(nA, 1)`). Returns ``(dcoef (9, nTR), dM0a, dM0b, db1)``, the last
    three `(nA, 1)`: the cotangents of the initial ``Za(0)``/``Zb(0)`` and
    the b1 gradient."""
    nTR = coef.shape[1]
    _check_tc(nTR, tc)
    ntc = chk.shape[0]
    if ntc != nTR // tc:
        raise ValueError(f'chk holds {ntc} states, but nTR={nTR} in chunks '
                         f'of tc={tc} gives {nTR // tc}')
    zero = torch.zeros_like(rows(0)[0])
    h = (torch.zeros_like(chk[0, 0].T),) * PLANES
    G = adjoint_cfg(cfg.K, chk.element_size(), PLANES, tc).G
    ab1 = zero
    # each warp's per-TR rows (a warp holds 32 / G atoms), as the kernel's
    dcf = coef.new_zeros((-(-zero.shape[0] * G // 32), nTR, XspgrCfg.nC))
    for j in reversed(range(ntc)):
        # phase 1: the forward from the chunk's start state, every state
        s = tuple(chk[j, q].T for q in range(PLANES))
        states = []
        for t in range(j * tc, (j + 1) * tc):
            states.append(s)
            s, _ = _xstep(coef, t, rows(t), cfg, s)
        # phase 2: the cotangent, backwards through the stored states
        for t in reversed(range(j * tc, (j + 1) * tc)):
            s = states.pop()
            p = rows(t)
            tg = _trig(coef, t, p[16], cfg.has_b1)
            ca2, sa2, sa, ca, c1, s1c, c2, s2 = tg
            s1 = _xmix(tg, s)
            h = _shift_T(h[:6], cfg.kshift) + _shift_T(h[6:], cfg.kshift)
            h, terms, (d_ra, d_rb) = _xrelax_T(p, h, s1)
            # the echo's cotangent, injected at both pools' F+(0) (the echo
            # reads the mixed state, before the relaxation)
            gyr, gyi = g[:, t, 0:1], g[:, t, 1:2]
            fr = s1[0][:, :1] + s1[6][:, :1]
            fi = s1[1][:, :1] + s1[7][:, :1]
            er = c1 * gyr - s1c * gyi
            ei = s1c * gyr + c1 * gyi
            h = ((_at0(h[0], h[0][:, :1] + er), _at0(h[1], h[1][:, :1] + ei))
                 + h[2:6]
                 + (_at0(h[6], h[6][:, :1] + er), _at0(h[7], h[7][:, :1] + ei))
                 + h[8:])
            d_c1e = gyr * fr + gyi * fi
            d_s1e = gyr * fi - gyi * fr
            # the mix's coefficients, both pools' terms summed order by order
            terms += [a + b for a, b in zip(_mix_terms(h[:6], s[:6]),
                                            _mix_terms(h[6:], s[6:]))]
            sums = _lane_sum(torch.stack(terms), G).unsqueeze(-1)  # (20, nA, 1)
            take(t, list(sums[:12]) + [d_ra, d_rb])
            d_ca2, d_sc2, d_ss2, d_ss, d_sc, d_hs, d_hc, d_ca = sums[12:]
            d_sa2 = c2 * d_sc2 + s2 * d_ss2
            d_c2, d_s2 = sa2 * d_sc2, sa2 * d_ss2
            d_sa = s1c * (d_ss + 0.5 * d_hs) + c1 * (d_sc + 0.5 * d_hc)
            d_s1 = sa * (d_ss + 0.5 * d_hs) + d_s1e
            d_c1 = sa * (d_sc + 0.5 * d_hc) + d_c1e
            if cfg.has_b1:
                # α = flip·b1 through the half-angle trig
                d_al = 0.5 * sa * (d_sa2 - d_ca2) + ca * d_sa - sa * d_ca
                ab1 = ab1 + d_al * coef[8, t]
                rows_t = [zero, zero, zero, zero, d_c1, d_s1, d_c2, d_s2,
                          d_al * p[16]]
            else:
                rows_t = [d_ca2, d_sa2, d_sa, d_ca, d_c1, d_s1, d_c2, d_s2,
                          zero]
            dcf[:, t] = _warp_sums(torch.cat(rows_t, dim=1), 32 // G)
            h = _mix_T(tg, h[:6]) + _mix_T(tg, h[6:])
    # the initial state: M0a on Za(0)'s real part, M0b on Zb(0)'s; the
    # warps' rows summed as the wrapper sums the kernel's
    return (dcf.sum(dim=0).T.contiguous(), h[4][:, :1], h[10][:, :1], ab1)


def xspgr_fwd_torch(coef, par, cfg: XspgrCfg):
    r"""Plain PyTorch version of the ``xspgr_fwd`` kernel: ``sig (nA, nTR,
    2)``. Differentiable by torch autograd (which then keeps every TR)."""
    return _xfwd(coef, _fixed_rows(par), cfg, None)[0]


def xspgr_fwd_chk_torch(coef, par, cfg: XspgrCfg, *, tc: int):
    r"""Plain PyTorch version of the ``xspgr_fwd_chk`` kernel: ``(sig (nA,
    nTR, 2), chk (nTR / tc, 12, K, nA))``."""
    _check_tc(coef.shape[1], tc)
    return _xfwd(coef, _fixed_rows(par), cfg, tc)


def xspgr_bwd_torch(coef, par, cfg: XspgrCfg, chk, g, *, tc: int):
    r"""Plain PyTorch version of the ``xspgr_bwd`` kernel: the two-phase
    chunk adjoint of :func:`xspgr_fwd_chk_torch` (:func:`_xbwd`), with no
    autograd, the entries' gradients summed over the train.

    ``chk``: its checkpoints at the same ``tc``; ``g``: the echoes'
    cotangent `(nA, nTR, 2)`. Returns ``(dcoef (9, nTR), dpar (17,
    nA))``."""
    acc = [torch.zeros_like(par[:1].T)] * NENT

    def take(t, d):
        for i in range(NENT):
            acc[i] = acc[i] + d[i]

    dcoef, dM0a, dM0b, db1 = _xbwd(coef, _fixed_rows(par), cfg, chk, g, tc,
                                   take)
    dpar = torch.cat(acc + [dM0a, dM0b, db1], dim=1).T
    return dcoef, dpar.contiguous()


def xspgr_v_fwd_torch(coef, pk, pkt, cfg: XspgrCfg):
    r"""Plain PyTorch version of the ``xspgr_v_fwd`` kernel: ``sig (nA,
    nTR, 2)`` over the variable-TR train whose step ``t`` takes the
    entries ``pkt[t]``. Differentiable by torch autograd (which then keeps
    every TR)."""
    return _xfwd(coef, _train_rows(pk, pkt), cfg, None)[0]


def xspgr_v_fwd_chk_torch(coef, pk, pkt, cfg: XspgrCfg, *, tc: int):
    r"""Plain PyTorch version of the ``xspgr_v_fwd_chk`` kernel: ``(sig
    (nA, nTR, 2), chk (nTR / tc, 12, K, nA))``."""
    _check_tc(coef.shape[1], tc)
    return _xfwd(coef, _train_rows(pk, pkt), cfg, tc)


def xspgr_v_bwd_torch(coef, pk, pkt, cfg: XspgrCfg, chk, g, *, tc: int):
    r"""Plain PyTorch version of the ``xspgr_v_bwd`` kernel: the two-phase
    chunk adjoint of :func:`xspgr_v_fwd_chk_torch` (:func:`_xbwd`), with
    no autograd, each step's entry gradients written as they are formed.
    Returns ``(dcoef (9, nTR), dpk (3, nA) = [dM0a, dM0b, db1], dpkt (nTR,
    14, nA))``: ``dM0a``/``dM0b`` the cotangents of the initial
    ``Za(0)``/``Zb(0)``, ``dpkt[t]`` the gradients of ``pkt[t]``."""
    dpkt = torch.empty_like(pkt)

    def take(t, d):
        dpkt[t] = torch.cat(d, dim=1).T

    dcoef, dM0a, dM0b, db1 = _xbwd(coef, _train_rows(pk, pkt), cfg, chk, g,
                                   tc, take)
    return dcoef, torch.cat([dM0a, dM0b, db1], dim=1).T.contiguous(), dpkt


# ==========================================================================
# The kernels
# ==========================================================================

def _sizes(name, coef, par, cfg, pkt=None):
    r"""Validate a kernel's arguments (``par`` is ``pk`` when the
    variable-TR planes ``pkt`` are given); returns ``(nA, nTR)``."""
    pname, rows = ('par', NPAR) if pkt is None else ('pk', NPK)
    if par.dtype not in (torch.float32, torch.float64):
        raise TypeError(f'{name} takes float32 or float64, not {par.dtype}')
    if par.ndim != 2 or par.shape[0] != rows:
        raise ValueError(f'{pname} must be ({rows}, nA), got '
                         f'{tuple(par.shape)}')
    nA, nTR = par.shape[1], coef.shape[-1]
    if cfg.K < 1 or cfg.kshift == 0:
        raise ValueError(f'{name} needs K >= 1 and kshift != 0, got '
                         f'K={cfg.K}, kshift={cfg.kshift}')
    _check(coef, 'coef', (cfg.nC, nTR), par.dtype, par.device)
    _check(par, pname, (rows, nA), par.dtype, par.device)
    if pkt is not None:
        _check(pkt, 'pkt', (nTR, NENT, nA), par.dtype, par.device)
    return nA, nTR


def _launch_fwd(coef, par, cfg, tc, pkt=None):
    r"""``xspgr_fwd`` (``tc`` None) or ``xspgr_fwd_chk``; with ``pkt``,
    their variable-TR instances, ``par`` then ``pk``."""
    from mrphy_tpu_torch.kernels._build import library
    name = (('xspgr_fwd' if pkt is None else 'xspgr_v_fwd')
            + ('' if tc is None else '_chk'))
    nA, nTR = _sizes(name, coef, par, cfg, pkt)
    dt, dev = par.dtype, par.device
    threads, in_smem = launch_cfg(cfg.K, par.element_size(), PLANES)
    sig = torch.empty((nA, nTR, 2), dtype=dt, device=dev)
    chk = None
    if tc is not None:
        _check_tc(nTR, tc)
        chk = torch.empty((nTR // tc, PLANES, cfg.K, nA), dtype=dt,
                          device=dev)
    state = None if in_smem else torch.empty((PLANES, cfg.K, nA), dtype=dt,
                                             device=dev)
    ins = (coef, par) if pkt is None else (coef, par, pkt)
    lib, _ = library()
    with torch.cuda.device(dev):
        err = _entry(lib, name, dt)(
            *map(_ptr, ins + (sig, chk, state)), nA, nTR, cfg.K,
            cfg.kshift, cfg.flags, tc or nTR, threads, _stream(dev))
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return sig, chk


def _launch_bwd(coef, par, cfg, chk, g, tc, pkt=None):
    r"""``xspgr_bwd``: ``(dcoef, dpar)``; with ``pkt``, ``xspgr_v_bwd``,
    ``par`` then ``pk``: ``(dcoef, dpk, dpkt)``."""
    from mrphy_tpu_torch.kernels._build import library
    name = 'xspgr_bwd' if pkt is None else 'xspgr_v_bwd'
    nA, nTR = _sizes(name, coef, par, cfg, pkt)
    _check_tc(nTR, tc)
    dt, dev = par.dtype, par.device
    _check(chk, 'chk', (nTR // tc, PLANES, cfg.K, nA), dt, dev)
    _check(g, 'g', (nA, nTR, 2), dt, dev)
    route = adjoint_cfg(cfg.K, par.element_size(), PLANES, tc)
    dpar = torch.empty(par.shape, dtype=dt, device=dev)
    # each warp's per-TR coefficient rows (summed over its atoms)
    dcf = torch.empty((-(-nA * route.G // 32), nTR, cfg.nC), dtype=dt,
                      device=dev)
    if pkt is None:
        ins, outs = (coef, par, chk, g), (dpar, dcf)
    else:
        dpkt = torch.empty((nTR, NENT, nA), dtype=dt, device=dev)
        ins, outs = (coef, par, pkt, chk, g), (dpar, dcf, dpkt)
    lib, _ = library()
    if route.route == 'lanes':
        with torch.cuda.device(dev):
            err = _entry(lib, name + '_lanes', dt)(
                *map(_ptr, ins + outs), nA, nTR, cfg.K, cfg.kshift,
                cfg.flags, tc, route.G, route.M, _stream(dev))
    else:
        threads, in_smem = launch_cfg(cfg.K, par.element_size(), PLANES)
        # phase 1's pre-RF states of one chunk (the first is chk's own) and
        # the adjoint state when it does not fit in shared memory
        scratch = torch.empty((max(tc - 1, 1), PLANES, cfg.K, nA), dtype=dt,
                              device=dev)
        hstate = None if in_smem else torch.empty((PLANES, cfg.K, nA),
                                                  dtype=dt, device=dev)
        with torch.cuda.device(dev):
            err = _entry(lib, name, dt)(
                *map(_ptr, ins + (scratch, hstate) + outs), nA, nTR, cfg.K,
                cfg.kshift, cfg.flags, tc, threads, _stream(dev))
    _raise_on(err, name)
    LAUNCHES[name] += 1
    # the warps' partial rows, summed in a fixed order
    dcoef = dcf.sum(dim=0).T.contiguous()
    return (dcoef, dpar) if pkt is None else (dcoef, dpar, dpkt)


def xspgr_fwd(coef, par, cfg: XspgrCfg):
    r"""The ``xspgr_fwd`` kernel on CUDA tensors (contiguous, one dtype,
    float32 or float64), :func:`xspgr_fwd_torch` on CPU tensors."""
    if _device_kind(par) == 'cpu':
        return xspgr_fwd_torch(coef, par, cfg)
    return _launch_fwd(coef, par, cfg, None)[0]


def xspgr_fwd_chk(coef, par, cfg: XspgrCfg, *, tc: int):
    r"""The ``xspgr_fwd_chk`` kernel on CUDA tensors,
    :func:`xspgr_fwd_chk_torch` on CPU tensors."""
    if _device_kind(par) == 'cpu':
        return xspgr_fwd_chk_torch(coef, par, cfg, tc=tc)
    return _launch_fwd(coef, par, cfg, tc)


def xspgr_bwd(coef, par, cfg: XspgrCfg, chk, g, *, tc: int):
    r"""The ``xspgr_bwd`` kernel on CUDA tensors, :func:`xspgr_bwd_torch`
    on CPU tensors."""
    if _device_kind(par) == 'cpu':
        return xspgr_bwd_torch(coef, par, cfg, chk, g, tc=tc)
    return _launch_bwd(coef, par, cfg, chk, g, tc)


def xspgr_v_fwd(coef, pk, pkt, cfg: XspgrCfg):
    r"""The ``xspgr_v_fwd`` kernel on CUDA tensors (contiguous, one dtype,
    float32 or float64), :func:`xspgr_v_fwd_torch` on CPU tensors."""
    if _device_kind(pk) == 'cpu':
        return xspgr_v_fwd_torch(coef, pk, pkt, cfg)
    return _launch_fwd(coef, pk, cfg, None, pkt)[0]


def xspgr_v_fwd_chk(coef, pk, pkt, cfg: XspgrCfg, *, tc: int):
    r"""The ``xspgr_v_fwd_chk`` kernel on CUDA tensors,
    :func:`xspgr_v_fwd_chk_torch` on CPU tensors."""
    if _device_kind(pk) == 'cpu':
        return xspgr_v_fwd_chk_torch(coef, pk, pkt, cfg, tc=tc)
    return _launch_fwd(coef, pk, cfg, tc, pkt)


def xspgr_v_bwd(coef, pk, pkt, cfg: XspgrCfg, chk, g, *, tc: int):
    r"""The ``xspgr_v_bwd`` kernel on CUDA tensors,
    :func:`xspgr_v_bwd_torch` on CPU tensors."""
    if _device_kind(pk) == 'cpu':
        return xspgr_v_bwd_torch(coef, pk, pkt, cfg, chk, g, tc=tc)
    return _launch_bwd(coef, pk, cfg, chk, g, tc, pkt)


def _adjoint_chunk(coef, par, cfg):
    r"""The two-pool adjoints' chunk (EPG-X SPGR and CPMG), capped for their
    lane route (:func:`~mrphy_tpu_torch.kernels.epg.adjoint_tc`)."""
    return adjoint_tc(coef.shape[1], cfg.K, par.shape[1], par.element_size(),
                      PLANES)


class _Xspgr(torch.autograd.Function):

    @staticmethod
    def forward(ctx, cfg, coef, par):
        ctx.cfg = cfg
        if not any(ctx.needs_input_grad[1:3]):
            return xspgr_fwd(coef, par, cfg)
        tc = _adjoint_chunk(coef, par, cfg)
        sig, chk = xspgr_fwd_chk(coef, par, cfg, tc=tc)
        ctx.tc = tc
        ctx.save_for_backward(coef, par, chk)
        return sig

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        coef, par, chk = ctx.saved_tensors
        dcoef, dpar = xspgr_bwd(coef, par, ctx.cfg, chk, g.contiguous(),
                                tc=ctx.tc)
        return None, dcoef, dpar


class _XspgrV(torch.autograd.Function):

    @staticmethod
    def forward(ctx, cfg, coef, pk, pkt):
        ctx.cfg = cfg
        if not any(ctx.needs_input_grad[1:4]):
            return xspgr_v_fwd(coef, pk, pkt, cfg)
        tc = _adjoint_chunk(coef, pk, cfg)
        sig, chk = xspgr_v_fwd_chk(coef, pk, pkt, cfg, tc=tc)
        ctx.tc = tc
        ctx.save_for_backward(coef, pk, pkt, chk)
        return sig

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        coef, pk, pkt, chk = ctx.saved_tensors
        dcoef, dpk, dpkt = xspgr_v_bwd(coef, pk, pkt, ctx.cfg, chk,
                                       g.contiguous(), tc=ctx.tc)
        return None, dcoef, dpk, dpkt


def xspgr(coef, par, cfg: XspgrCfg):
    r"""The EPG-X SPGR train ``sig (nA, nTR, 2)`` at a fixed TR: the
    kernels on CUDA tensors (``xspgr_fwd``, or ``xspgr_fwd_chk`` and
    ``xspgr_bwd`` when a gradient is needed), their plain versions on CPU
    tensors. Differentiable w.r.t. ``coef`` and ``par``."""
    return _Xspgr.apply(cfg, coef.contiguous(), par.contiguous())


def xspgr_v(coef, pk, pkt, cfg: XspgrCfg):
    r"""The EPG-X SPGR train ``sig (nA, nTR, 2)`` over a variable-TR train:
    the kernels on CUDA tensors (``xspgr_v_fwd``, or ``xspgr_v_fwd_chk``
    and ``xspgr_v_bwd`` when a gradient is needed), their plain versions on
    CPU tensors. Differentiable w.r.t. ``coef``, ``pk`` and ``pkt``."""
    return _XspgrV.apply(cfg, coef.contiguous(), pk.contiguous(),
                         pkt.contiguous())


# ==========================================================================
# The two-pool CPMG train: the plain versions
# ==========================================================================

def _xcpmg_init(p, K):
    r"""The closed-form state a π/2 excitation about ``φ_ex`` leaves on the
    equilibrium: per pool ``F± = (sin φ_ex ∓ i·cos φ_ex)·M0p``, ``Z = 0``
    (the rows ``cos φ_ex, sin φ_ex, M0a, M0b``)."""
    exc, exs, M0a, M0b = p[14:18]
    z = torch.zeros(exc.shape[0], K, dtype=exc.dtype, device=exc.device)

    def pool(M0):
        return (_at0(z, exs * M0), _at0(z, -exc * M0), _at0(z, exs * M0),
                _at0(z, exc * M0), z, z)

    return pool(M0a) + pool(M0b)


def _xhalf(p, s):
    r"""One half echo of both pools: the exchange–relaxation over esp/2,
    then the crusher's unit shift."""
    s = _xrelax(p, s)
    return _shift(s[:6], 1) + _shift(s[6:], 1)


def _xecho(coef, t, p, cfg, s):
    r"""Echo ``t`` from its pre-echo state ``s``: half, the refocusing mix
    about +x on both pools, half; returns the state whose ``Fa+(0) +
    Fb+(0)`` is the echo."""
    tg = _flip_trig(coef, t, 4, p[18], cfg.has_b1)
    return _xhalf(p, _xmix(tg, _xhalf(p, s)))


def _xcpmg_fwd(coef, rows, cfg, tc):
    r"""The train from the excitation's state, ``rows(t)`` echo ``t``'s 19
    rows: ``(er, ei, chk or None)``."""
    nE = coef.shape[1]
    p = rows(0)
    s = _xcpmg_init(p, cfg.K)
    er, ei = [], []
    chk = p[14].new_empty((nE // tc, PLANES, cfg.K, p[14].shape[0])) if tc \
        else None
    for t in range(nE):
        if tc and t % tc == 0:
            chk[t // tc] = torch.stack(s).transpose(1, 2)  # (12, K, nA)
        s = _xecho(coef, t, rows(t), cfg, s)
        er.append(s[0][:, 0] + s[6][:, 0])
        ei.append(s[1][:, 0] + s[7][:, 0])
    return torch.stack(er), torch.stack(ei), chk


def _xcpmg_bwd(coef, rows, cfg, chk, gr, gi, tc, per_echo):
    r"""The two-phase chunk adjoint of :func:`_xcpmg_fwd` from its
    checkpoints ``chk`` at chunk length ``tc`` and the echoes' cotangent
    ``gr``/``gi`` (each ``(nE, nA)``), with no autograd. Per echo, newest
    first (``_xcpmg_bwd_kernel``'s order, ``epg_pallas.py:3072-3201``): the
    cotangent into both pools' ``F+(0)``, the shift's transpose, the
    exchange–relaxation's transpose at the mixed state (its 14 entry terms),
    the refocusing mix's coefficient terms (both pools, order by order) and
    transpose, the shift's transpose, the exchange–relaxation's transpose at
    the stored pre-echo state. Under ``b1`` the angle's gradient goes to
    ``db1`` and to the flip row, the other coefficient rows stay 0.

    Every sum is taken in the order of the route the kernel takes at this
    shape (:func:`~mrphy_tpu_torch.kernels.epg.adjoint_cfg`): the mix's
    terms over the orders by ``_lane_sum``; the 12 entry terms on the
    one-thread route (``G`` 1) over each half's orders one order at a
    time, the second half's sum then the first's added, and on the lane
    route each lane's orders in turn over the second half then the first
    (``_lane_parts``), over the whole train at a fixed spacing and per echo
    with ``per_echo``, the group's lanes added last (``_group_sum``); ∂ra and
    ∂rb (order 0's) the second half's then the first's. The per-echo rows
    are summed over the atoms by warps of ``32 / G``
    (:func:`_warp_sums`), then over the warps by one ``torch.sum``, as the
    wrappers sum the kernels' partial rows. Returns ``(dcoef (5, nE),
    tail, ents)``: ``tail`` the `(nA, 1)` gradients ``[d cos φ_ex, d sin
    φ_ex, dM0a, dM0b]`` of the initial state and ``db1``; ``ents`` the 14
    entries' gradients summed over the train (each `(nA, 1)`), or with
    ``per_echo`` each echo's, both halves', ``(nE, 14, nA)``."""
    nE = coef.shape[1]
    _check_tc(nE, tc)
    ntc = chk.shape[0]
    if ntc != nE // tc:
        raise ValueError(f'chk holds {ntc} states, but nE={nE} in chunks '
                         f'of tc={tc} gives {nE // tc}')
    zero = torch.zeros_like(rows(0)[0])
    nA = zero.shape[0]
    h = (torch.zeros_like(chk[0, 0].T),) * PLANES
    G = adjoint_cfg(cfg.K, chk.element_size(), PLANES, tc).G
    ab1 = zero
    # the entries' sums: 14 on the one-thread route; each lane's 12 and
    # lane 0's ∂ra, ∂rb on the lane route
    acc = [zero] * NENT
    lanes = chk.new_zeros((12, nA, G))
    dpkt = chk.new_empty((nE, NENT, nA)) if per_echo else None
    # each warp's per-echo rows (a warp holds 32 / G atoms), as the kernel's
    dcf = coef.new_zeros((-(-nA * G // 32), nE, XcpmgCfg.nC))
    for j in reversed(range(ntc)):
        # phase 1: the forward from the chunk's start state, every state
        s = tuple(chk[j, q].T for q in range(PLANES))
        states = []
        for t in range(j * tc, (j + 1) * tc):
            states.append(s)
            s = _xecho(coef, t, rows(t), cfg, s)
        # phase 2: the cotangent, backwards through the stored states
        for t in reversed(range(j * tc, (j + 1) * tc)):
            s = states.pop()
            p = rows(t)
            tg = _flip_trig(coef, t, 4, p[18], cfg.has_b1)
            ca2, sa2, sa, ca = tg
            sh1 = _xhalf(p, s)                 # the refocusing's input
            s1 = _xmix(tg, sh1)
            # the echo reads both pools' F+(0) after the second half
            gyr, gyi = gr[t][:, None], gi[t][:, None]
            h = ((_at0(h[0], h[0][:, :1] + gyr), _at0(h[1], h[1][:, :1] + gyi))
                 + h[2:6]
                 + (_at0(h[6], h[6][:, :1] + gyr),
                    _at0(h[7], h[7][:, :1] + gyi))
                 + h[8:])
            h = _shift_T(h[:6], 1) + _shift_T(h[6:], 1)
            h, t2, r2 = _xrelax_T(p, h, s1)
            # the refocusing's coefficients (h: its output's cotangent)
            tm = [a + b for a, b in zip(_mix0_terms(h[:6], sh1[:6]),
                                        _mix0_terms(h[6:], sh1[6:]))]
            h = _mix_T(tg, h[:6]) + _mix_T(tg, h[6:])
            h = _shift_T(h[:6], 1) + _shift_T(h[6:], 1)
            h, t1, r1 = _xrelax_T(p, h, s)
            t2, t1 = torch.stack(t2), torch.stack(t1)
            if G == 1:
                d2 = list(_ksum(t2).unsqueeze(-1)) + list(r2)
                d1 = list(_ksum(t1).unsqueeze(-1)) + list(r1)
                if per_echo:
                    dpkt[t] = torch.cat([x + y for x, y in zip(d2, d1)],
                                        dim=1).T
                else:
                    acc = [(a + x) + y for a, x, y in zip(acc, d2, d1)]
            elif per_echo:
                ents = _group_sum(_lane_parts(t1, G, _lane_parts(t2, G)))
                dpkt[t] = torch.cat([ents.T] + [x + y for x, y in
                                                zip(r2, r1)], dim=1).T
            else:
                lanes = _lane_parts(t1, G, _lane_parts(t2, G, lanes))
                acc[12:] = [(a + x) + y for a, x, y in zip(acc[12:], r2, r1)]
            d_ca2, d_sa2, d_sc, d_hc, d_ca = _lane_sum(
                torch.stack(tm), G).unsqueeze(-1)
            d_sa = d_sc + 0.5 * d_hc
            if cfg.has_b1:
                # α = flip·b1 through the half-angle trig
                d_al = 0.5 * sa * (d_sa2 - d_ca2) + ca * d_sa - sa * d_ca
                ab1 = ab1 + d_al * coef[4, t]
                rows_t = [zero, zero, zero, zero, d_al * p[18]]
            else:
                rows_t = [d_ca2, d_sa2, d_sa, d_ca, zero]
            dcf[:, t] = _warp_sums(torch.cat(rows_t, dim=1), 32 // G)
    if G > 1 and not per_echo:
        acc[:12] = list(_group_sum(lanes).unsqueeze(-1))
    # the excitation's state: per pool F+(0) = (exs, −exc)·M0p, F−(0) =
    # (exs, exc)·M0p
    exc, exs, M0a, M0b = rows(0)[14:18]
    ra_ = h[0][:, :1] + h[2][:, :1]
    ia_ = -h[1][:, :1] + h[3][:, :1]
    rb_ = h[6][:, :1] + h[8][:, :1]
    ib_ = -h[7][:, :1] + h[9][:, :1]
    return dcf.sum(dim=0).T.contiguous(), [
        M0a * ia_ + M0b * ib_, M0a * ra_ + M0b * rb_, exs * ra_ + exc * ia_,
        exs * rb_ + exc * ib_, ab1], (dpkt if per_echo else acc)


def xcpmg_fwd_torch(coef, pk, cfg: XcpmgCfg):
    r"""Plain PyTorch version of the ``xcpmg_fwd`` kernel: the echoes ``(er,
    ei)``, each ``(nE, nA)``. Differentiable by torch autograd (which then
    keeps every echo)."""
    return _xcpmg_fwd(coef, _fixed_rows(pk), cfg, None)[:2]


def xcpmg_fwd_chk_torch(coef, pk, cfg: XcpmgCfg, *, tc: int):
    r"""Plain PyTorch version of the ``xcpmg_fwd_chk`` kernel: ``(er, ei,
    chk (nE / tc, 12, K, nA))``, the pre-echo state at the start of every
    chunk of ``tc`` echoes."""
    _check_tc(coef.shape[1], tc)
    return _xcpmg_fwd(coef, _fixed_rows(pk), cfg, tc)


def xcpmg_bwd_torch(coef, pk, cfg: XcpmgCfg, chk, gr, gi, *, tc: int):
    r"""Plain PyTorch version of the ``xcpmg_bwd`` kernel: the two-phase
    chunk adjoint of :func:`xcpmg_fwd_chk_torch` (:func:`_xcpmg_bwd`), with
    no autograd.

    ``chk``: its checkpoints at the same ``tc``; ``gr``/``gi``: the echoes'
    cotangent, each ``(nE, nA)``. Returns ``(dcoef (5, nE), dpk (19,
    nA))``: the 14 entries' gradients (both halves of every echo), ``[d cos
    φ_ex, d sin φ_ex, dM0a, dM0b]`` of the initial state, ``db1``."""
    dcoef, tail, ents = _xcpmg_bwd(coef, _fixed_rows(pk), cfg, chk, gr, gi,
                                   tc, False)
    return dcoef, torch.cat(ents + tail, dim=1).T.contiguous()


def xcpmg_v_fwd_torch(coef, pk, pkt, cfg: XcpmgCfg):
    r"""Plain PyTorch version of the ``xcpmg_v_fwd`` kernel: the echoes
    ``(er, ei)``, each ``(nE, nA)``, over the echo-spacing train whose echo
    ``t`` takes the entries ``pkt[t]`` in both halves. Differentiable by
    torch autograd (which then keeps every echo)."""
    return _xcpmg_fwd(coef, _train_rows(pk, pkt), cfg, None)[:2]


def xcpmg_v_fwd_chk_torch(coef, pk, pkt, cfg: XcpmgCfg, *, tc: int):
    r"""Plain PyTorch version of the ``xcpmg_v_fwd_chk`` kernel: ``(er, ei,
    chk (nE / tc, 12, K, nA))``."""
    _check_tc(coef.shape[1], tc)
    return _xcpmg_fwd(coef, _train_rows(pk, pkt), cfg, tc)


def xcpmg_v_bwd_torch(coef, pk, pkt, cfg: XcpmgCfg, chk, gr, gi, *,
                      tc: int):
    r"""Plain PyTorch version of the ``xcpmg_v_bwd`` kernel: the two-phase
    chunk adjoint of :func:`xcpmg_v_fwd_chk_torch` (:func:`_xcpmg_bwd`),
    with no autograd, each echo's entry gradients written as they are
    formed. Returns ``(dcoef (5, nE), dpk (5, nA) = [d cos φ_ex, d sin φ_ex,
    dM0a, dM0b, db1], dpkt (nE, 14, nA))``: ``dM0a``/``dM0b`` through the
    initial state only (their share through the recovery ``ra``/``rb`` is in
    ``dpkt``), ``dpkt[t]`` the gradients of ``pkt[t]``, the second half's
    and the first's added."""
    dcoef, tail, dpkt = _xcpmg_bwd(coef, _train_rows(pk, pkt), cfg, chk, gr,
                                   gi, tc, True)
    return dcoef, torch.cat(tail, dim=1).T.contiguous(), dpkt


# ==========================================================================
# The two-pool CPMG train: the kernels
# ==========================================================================

def _xcpmg_sizes(name, coef, pk, cfg, pkt=None):
    r"""Validate a two-pool CPMG kernel's arguments (``pk`` the 5 rows of
    an echo-spacing train when its planes ``pkt`` are given); returns
    ``(nA, nE)``."""
    rows = NXC if pkt is None else NXCV
    if pk.dtype not in (torch.float32, torch.float64):
        raise TypeError(f'{name} takes float32 or float64, not {pk.dtype}')
    if pk.ndim != 2 or pk.shape[0] != rows:
        raise ValueError(f'pk must be ({rows}, nA), got {tuple(pk.shape)}')
    nA, nE = pk.shape[1], coef.shape[-1]
    if cfg.K < 2 or nE < 1:
        raise ValueError(f'{name} needs K >= 2 and nE >= 1, got K={cfg.K}, '
                         f'nE={nE}')
    _check(coef, 'coef', (cfg.nC, nE), pk.dtype, pk.device)
    _check(pk, 'pk', (rows, nA), pk.dtype, pk.device)
    if pkt is not None:
        _check(pkt, 'pkt', (nE, NENT, nA), pk.dtype, pk.device)
    return nA, nE


def _launch_xcpmg_fwd(coef, pk, cfg, tc, pkt=None):
    r"""``xcpmg_fwd`` (``tc`` None) or ``xcpmg_fwd_chk``; with ``pkt``,
    their echo-spacing-train instances: ``(er, ei, chk)``."""
    from mrphy_tpu_torch.kernels._build import library
    name = (('xcpmg_fwd' if pkt is None else 'xcpmg_v_fwd')
            + ('' if tc is None else '_chk'))
    nA, nE = _xcpmg_sizes(name, coef, pk, cfg, pkt)
    dt, dev = pk.dtype, pk.device
    threads, in_smem = launch_cfg(cfg.K, pk.element_size(), PLANES)
    er = torch.empty((nE, nA), dtype=dt, device=dev)
    ei = torch.empty((nE, nA), dtype=dt, device=dev)
    chk = None
    if tc is not None:
        _check_tc(nE, tc)
        chk = torch.empty((nE // tc, PLANES, cfg.K, nA), dtype=dt,
                          device=dev)
    state = None if in_smem else torch.empty((PLANES, cfg.K, nA), dtype=dt,
                                             device=dev)
    ins = (coef, pk) if pkt is None else (coef, pk, pkt)
    lib, _ = library()
    with torch.cuda.device(dev):
        err = _entry(lib, name, dt)(
            *map(_ptr, ins + (er, ei, chk, state)), nA, nE, cfg.K,
            cfg.flags, tc or nE, threads, _stream(dev))
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return er, ei, chk


def _launch_xcpmg_bwd(coef, pk, cfg, chk, gr, gi, tc, pkt=None):
    r"""``xcpmg_bwd``: ``(dcoef, dpk)``; with ``pkt``, ``xcpmg_v_bwd``:
    ``(dcoef, dpk, dpkt)``."""
    from mrphy_tpu_torch.kernels._build import library
    name = 'xcpmg_bwd' if pkt is None else 'xcpmg_v_bwd'
    nA, nE = _xcpmg_sizes(name, coef, pk, cfg, pkt)
    _check_tc(nE, tc)
    dt, dev = pk.dtype, pk.device
    _check(chk, 'chk', (nE // tc, PLANES, cfg.K, nA), dt, dev)
    _check(gr, 'gr', (nE, nA), dt, dev)
    _check(gi, 'gi', (nE, nA), dt, dev)
    route = adjoint_cfg(cfg.K, pk.element_size(), PLANES, tc)
    dpk = torch.empty(pk.shape, dtype=dt, device=dev)
    # each warp's per-echo coefficient rows (summed over its atoms)
    dcf = torch.empty((-(-nA * route.G // 32), nE, cfg.nC), dtype=dt,
                      device=dev)
    if pkt is None:
        ins, outs = (coef, pk, chk, gr, gi), (dpk, dcf)
    else:
        dpkt = torch.empty((nE, NENT, nA), dtype=dt, device=dev)
        ins, outs = (coef, pk, pkt, chk, gr, gi), (dpk, dcf, dpkt)
    lib, _ = library()
    if route.route == 'lanes':
        with torch.cuda.device(dev):
            err = _entry(lib, name + '_lanes', dt)(
                *map(_ptr, ins + outs), nA, nE, cfg.K, cfg.flags, tc,
                route.G, route.M, _stream(dev))
    else:
        threads, in_smem = launch_cfg(cfg.K, pk.element_size(), PLANES)
        # phase 1's pre-echo states of one chunk (the first is chk's own)
        # and the adjoint state when it does not fit in shared memory
        scratch = torch.empty((max(tc - 1, 1), PLANES, cfg.K, nA), dtype=dt,
                              device=dev)
        hstate = None if in_smem else torch.empty((PLANES, cfg.K, nA),
                                                  dtype=dt, device=dev)
        with torch.cuda.device(dev):
            err = _entry(lib, name, dt)(
                *map(_ptr, ins + (scratch, hstate) + outs), nA, nE, cfg.K,
                cfg.flags, tc, threads, _stream(dev))
    _raise_on(err, name)
    LAUNCHES[name] += 1
    # the warps' partial rows, summed in a fixed order
    dcoef = dcf.sum(dim=0).T.contiguous()
    return (dcoef, dpk) if pkt is None else (dcoef, dpk, dpkt)


def xcpmg_fwd(coef, pk, cfg: XcpmgCfg):
    r"""The ``xcpmg_fwd`` kernel on CUDA tensors (contiguous, one dtype,
    float32 or float64), :func:`xcpmg_fwd_torch` on CPU tensors."""
    if _device_kind(pk) == 'cpu':
        return xcpmg_fwd_torch(coef, pk, cfg)
    return _launch_xcpmg_fwd(coef, pk, cfg, None)[:2]


def xcpmg_fwd_chk(coef, pk, cfg: XcpmgCfg, *, tc: int):
    r"""The ``xcpmg_fwd_chk`` kernel on CUDA tensors,
    :func:`xcpmg_fwd_chk_torch` on CPU tensors."""
    if _device_kind(pk) == 'cpu':
        return xcpmg_fwd_chk_torch(coef, pk, cfg, tc=tc)
    return _launch_xcpmg_fwd(coef, pk, cfg, tc)


def xcpmg_bwd(coef, pk, cfg: XcpmgCfg, chk, gr, gi, *, tc: int):
    r"""The ``xcpmg_bwd`` kernel on CUDA tensors, :func:`xcpmg_bwd_torch` on
    CPU tensors."""
    if _device_kind(pk) == 'cpu':
        return xcpmg_bwd_torch(coef, pk, cfg, chk, gr, gi, tc=tc)
    return _launch_xcpmg_bwd(coef, pk, cfg, chk, gr, gi, tc)


def xcpmg_v_fwd(coef, pk, pkt, cfg: XcpmgCfg):
    r"""The ``xcpmg_v_fwd`` kernel on CUDA tensors (contiguous, one dtype,
    float32 or float64), :func:`xcpmg_v_fwd_torch` on CPU tensors."""
    if _device_kind(pk) == 'cpu':
        return xcpmg_v_fwd_torch(coef, pk, pkt, cfg)
    return _launch_xcpmg_fwd(coef, pk, cfg, None, pkt)[:2]


def xcpmg_v_fwd_chk(coef, pk, pkt, cfg: XcpmgCfg, *, tc: int):
    r"""The ``xcpmg_v_fwd_chk`` kernel on CUDA tensors,
    :func:`xcpmg_v_fwd_chk_torch` on CPU tensors."""
    if _device_kind(pk) == 'cpu':
        return xcpmg_v_fwd_chk_torch(coef, pk, pkt, cfg, tc=tc)
    return _launch_xcpmg_fwd(coef, pk, cfg, tc, pkt)


def xcpmg_v_bwd(coef, pk, pkt, cfg: XcpmgCfg, chk, gr, gi, *, tc: int):
    r"""The ``xcpmg_v_bwd`` kernel on CUDA tensors,
    :func:`xcpmg_v_bwd_torch` on CPU tensors."""
    if _device_kind(pk) == 'cpu':
        return xcpmg_v_bwd_torch(coef, pk, pkt, cfg, chk, gr, gi, tc=tc)
    return _launch_xcpmg_bwd(coef, pk, cfg, chk, gr, gi, tc, pkt)


class _Xcpmg(torch.autograd.Function):

    @staticmethod
    def forward(ctx, cfg, coef, pk):
        ctx.cfg = cfg
        if not any(ctx.needs_input_grad[1:3]):
            return xcpmg_fwd(coef, pk, cfg)
        tc = _adjoint_chunk(coef, pk, cfg)
        er, ei, chk = xcpmg_fwd_chk(coef, pk, cfg, tc=tc)
        ctx.tc = tc
        ctx.save_for_backward(coef, pk, chk)
        return er, ei

    @staticmethod
    @once_differentiable
    def backward(ctx, gr, gi):
        coef, pk, chk = ctx.saved_tensors
        dcoef, dpk = xcpmg_bwd(coef, pk, ctx.cfg, chk, gr.contiguous(),
                               gi.contiguous(), tc=ctx.tc)
        return None, dcoef, dpk


class _XcpmgV(torch.autograd.Function):

    @staticmethod
    def forward(ctx, cfg, coef, pk, pkt):
        ctx.cfg = cfg
        if not any(ctx.needs_input_grad[1:4]):
            return xcpmg_v_fwd(coef, pk, pkt, cfg)
        tc = _adjoint_chunk(coef, pk, cfg)
        er, ei, chk = xcpmg_v_fwd_chk(coef, pk, pkt, cfg, tc=tc)
        ctx.tc = tc
        ctx.save_for_backward(coef, pk, pkt, chk)
        return er, ei

    @staticmethod
    @once_differentiable
    def backward(ctx, gr, gi):
        coef, pk, pkt, chk = ctx.saved_tensors
        dcoef, dpk, dpkt = xcpmg_v_bwd(coef, pk, pkt, ctx.cfg, chk,
                                       gr.contiguous(), gi.contiguous(),
                                       tc=ctx.tc)
        return None, dcoef, dpk, dpkt


def xcpmg(coef, pk, cfg: XcpmgCfg):
    r"""The EPG-X CPMG echoes ``(er, ei)``, each ``(nE, nA)``, at a fixed
    echo spacing: the kernels on CUDA tensors (``xcpmg_fwd``, or
    ``xcpmg_fwd_chk`` and ``xcpmg_bwd`` when a gradient is needed), their
    plain versions on CPU tensors. Differentiable w.r.t. ``coef`` and
    ``pk``."""
    return _Xcpmg.apply(cfg, coef.contiguous(), pk.contiguous())


def xcpmg_v(coef, pk, pkt, cfg: XcpmgCfg):
    r"""The EPG-X CPMG echoes ``(er, ei)``, each ``(nE, nA)``, over an
    echo-spacing train: the kernels on CUDA tensors (``xcpmg_v_fwd``, or
    ``xcpmg_v_fwd_chk`` and ``xcpmg_v_bwd`` when a gradient is needed),
    their plain versions on CPU tensors. Differentiable w.r.t. ``coef``,
    ``pk`` and ``pkt``."""
    return _XcpmgV.apply(cfg, coef.contiguous(), pk.contiguous(),
                         pkt.contiguous())


# ==========================================================================
# The EPG-X(MT) train (bound pool: Z states only): the plain versions
# ==========================================================================

class XmtCfg(NamedTuple):
    r"""The static switches of one EPG-X(MT) SPGR train: ``K`` modelled
    orders, the spoiler's ``kshift`` k-quanta per TR and per-atom ``b1``."""
    K: int
    kshift: int
    has_b1: bool

    nC = NC_MT

    @property
    def flags(self) -> int:
        return int(self.has_b1)


def _mt_relax(p, s):
    r"""Pool a's transverse decay ``E2a`` and the exchange of the Z pair with
    its recovery into order 0 (``_mt_relax``, ``epg_pallas.py:3688``), on a
    mixed state ``s`` of 8 planes."""
    Z00, Z01, Z10, Z11, ra, rb, E2a = p[:7]
    Fpr, Fpi, Fmr, Fmi, Zr, Zi, Zbr, Zbi = s
    Z2r = Z00 * Zr + Z01 * Zbr
    Zb2r = Z10 * Zr + Z11 * Zbr
    return (E2a * Fpr, E2a * Fpi, E2a * Fmr, E2a * Fmi,
            _at0(Z2r, Z2r[:, :1] + ra), Z00 * Zi + Z01 * Zbi,
            _at0(Zb2r, Zb2r[:, :1] + rb), Z10 * Zi + Z11 * Zbi)


def _mt_mix(coef, t, p, cfg, s):
    r"""TR ``t``'s RF event on the pre-RF state ``s``: ``(tg, sat, s1)``,
    the pool-a factors (:func:`~mrphy_tpu_torch.kernels.epg._trig`), the
    bound pool's saturation ``exp(−wt_t·wscale)`` `(nA, 1)` and the mixed
    state (pool a mixed, ``Zb`` saturated)."""
    tg = _trig(coef, t, p[9], cfg.has_b1)
    sat = torch.exp(-coef[9, t] * p[10])
    return tg, sat, _mix(tg, s[:6]) + (sat * s[6], sat * s[7])


def _mt_next(p, cfg, s1):
    r"""The pre-RF state of the next TR from the mixed state ``s1``: the
    exchange–relaxation, then the shift of pool a's F states."""
    s2 = _mt_relax(p, s1)
    return _shift(s2[:6], cfg.kshift) + s2[6:]


def _mt_fwd(coef, rows, cfg, tc):
    r"""The train from the equilibrium state, ``rows(t)`` TR ``t``'s 11 rows
    (:func:`_fixed_rows`, :func:`_train_rows`): ``(echoes (nA, nTR, 2), chk
    or None)``, ``chk (nTR / tc, 8, K, nA)`` the chunk-start states."""
    nTR = coef.shape[1]
    p = rows(0)
    z = torch.zeros(p[7].shape[0], cfg.K, dtype=p[7].dtype,
                    device=p[7].device)
    s = (z, z, z, z, _at0(z, p[7]), z, _at0(z, p[8]), z)
    echoes = []
    chk = z.new_empty((nTR // tc, PLANES_MT, cfg.K, z.shape[0])) if tc \
        else None
    for t in range(nTR):
        if tc and t % tc == 0:
            chk[t // tc] = torch.stack(s).transpose(1, 2)  # (8, K, nA)
        p = rows(t)
        tg, _, s1 = _mt_mix(coef, t, p, cfg, s)
        c1, s1c = tg[4], tg[5]
        fr, fi = s1[0][:, :1], s1[1][:, :1]
        echoes.append(torch.cat([c1 * fr + s1c * fi, c1 * fi - s1c * fr],
                                dim=1))
        s = _mt_next(p, cfg, s1)
    return torch.stack(echoes, dim=1), chk


def _mt_bwd(coef, rows, cfg, chk, g, tc, take):
    r"""The two-phase chunk adjoint of :func:`_mt_fwd` from its checkpoints
    ``chk`` at chunk length ``tc`` and the echoes' cotangent ``g (nA, nTR,
    2)``, with no autograd, in ``_mt_bwd_kernel``'s order
    (``epg_pallas.py:3793-3971``; ``_mtv_bwd_kernel``'s, ``:4183-4328``).

    Per chunk, newest first, phase 1 runs the forward from the chunk's start
    state and keeps each TR's pre-RF state, factors and mixed state; phase 2
    walks them backwards: the shift's transpose (pool a's F), the
    exchange–relaxation's transpose at the mixed state (its 7 entry terms),
    the echo's cotangent into ``Fa+(0)``, the saturation's transpose
    (``∂wt_t = −wscale·sat·Σ_k h·Zb``, ``∂wscale`` adds ``−wt_t·sat·Σ_k
    h·Zb``), pool a's RF coefficient terms and transpose. Sums over the
    orders are taken one order at a time, the per-TR rows summed over the
    atoms by warps of 32 (:func:`_warp_sums`) and then over the warps, as
    the wrapper sums the kernel's partial rows. Under ``b1`` the angle's
    gradient goes to ``db1`` and to the flip row (rows 0–3 stay 0).
    ``take(t, d)`` receives TR ``t``'s 7 entry gradients ``d`` (each `(nA,
    1)`, in the rows' order ``[Z00, Z01, Z10, Z11, ra, rb, E2a]``).

    Returns ``(dcoef (10, nTR), dM0a, dM0b, db1, dwscale)``, the last four
    `(nA, 1)`: the cotangents of the initial ``Za(0)``/``Zb(0)``, the b1 and
    the saturation scale's gradients."""
    nTR = coef.shape[1]
    _check_tc(nTR, tc)
    ntc = chk.shape[0]
    if ntc != nTR // tc:
        raise ValueError(f'chk holds {ntc} states, but nTR={nTR} in chunks '
                         f'of tc={tc} gives {nTR // tc}')
    wsc = rows(0)[10]
    zero = torch.zeros_like(wsc)
    h = (torch.zeros_like(chk[0, 0].T),) * PLANES_MT
    ab1 = awsc = zero
    dcf = coef.new_zeros((-(-zero.shape[0] // 32), nTR, NC_MT))
    for j in reversed(range(ntc)):
        # phase 1: the forward from the chunk's start state, every pre-RF
        # state with its TR's factors and mixed state
        s = tuple(chk[j, q].T for q in range(PLANES_MT))
        steps = []
        for t in range(j * tc, (j + 1) * tc):
            p = rows(t)
            tg, sat, s1 = _mt_mix(coef, t, p, cfg, s)
            steps.append((s, tg, sat, s1))
            if t + 1 < (j + 1) * tc:
                s = _mt_next(p, cfg, s1)
        # phase 2: the cotangent, backwards through the stored TRs
        for t in reversed(range(j * tc, (j + 1) * tc)):
            s, tg, sat, s1 = steps.pop()
            p = rows(t)
            ca2, sa2, sa, ca, c1, s1c, c2, s2 = tg
            h = _shift_T(h[:6], cfg.kshift) + h[6:]
            # the exchange-relaxation's transpose at the mixed state
            hFpr, hFpi, hFmr, hFmi, hZr, hZi, hZbr, hZbi = h
            Fpr, Fpi, Fmr, Fmi, Zr, Zi, Zbr, Zbi = s1
            terms = [hZr * Zr + hZi * Zi, hZr * Zbr + hZi * Zbi,
                     hZbr * Zr + hZbi * Zi, hZbr * Zbr + hZbi * Zbi,
                     hFpr * Fpr + hFpi * Fpi + hFmr * Fmr + hFmi * Fmi]
            d_ra, d_rb = hZr[:, :1], hZbr[:, :1]
            Z00, Z01, Z10, Z11, _, _, E2a = p[:7]
            h = (E2a * hFpr, E2a * hFpi, E2a * hFmr, E2a * hFmi,
                 Z00 * hZr + Z10 * hZbr, Z00 * hZi + Z10 * hZbi,
                 Z01 * hZr + Z11 * hZbr, Z01 * hZi + Z11 * hZbi)
            # the echo's cotangent into Fa+(0) (the echo reads the mixed
            # state)
            gyr, gyi = g[:, t, 0:1], g[:, t, 1:2]
            fr, fi = s1[0][:, :1], s1[1][:, :1]
            h = (_at0(h[0], h[0][:, :1] + (c1 * gyr - s1c * gyi)),
                 _at0(h[1], h[1][:, :1] + (s1c * gyr + c1 * gyi))) + h[2:]
            d_c1e = gyr * fr + gyi * fi
            d_s1e = gyr * fi - gyi * fr
            # the saturation's terms, then pool a's mix coefficients
            terms += [h[6] * s[6] + h[7] * s[7]] + _mix_terms(h[:6], s[:6])
            sums = _ksum(torch.stack(terms)).unsqueeze(-1)   # (14, nA, 1)
            take(t, list(sums[:4]) + [d_ra, d_rb, sums[4]])
            dsat = sums[5]
            d_wt = -wsc * sat * dsat
            awsc = awsc + (-coef[9, t]) * sat * dsat
            d_ca2, d_sc2, d_ss2, d_ss, d_sc, d_hs, d_hc, d_ca = sums[6:]
            d_sa2 = c2 * d_sc2 + s2 * d_ss2
            d_sa = s1c * (d_ss + 0.5 * d_hs) + c1 * (d_sc + 0.5 * d_hc)
            rows_t = [d_ca2, d_sa2, d_sa, d_ca,
                      sa * (d_sc + 0.5 * d_hc) + d_c1e,
                      sa * (d_ss + 0.5 * d_hs) + d_s1e,
                      sa2 * d_sc2, sa2 * d_ss2, zero, d_wt]
            if cfg.has_b1:
                # α = flip·b1 through the half-angle trig
                d_al = 0.5 * sa * (d_sa2 - d_ca2) + ca * d_sa - sa * d_ca
                ab1 = ab1 + d_al * coef[8, t]
                rows_t[:4] = [zero] * 4
                rows_t[8] = d_al * p[9]
            dcf[:, t] = _warp_sums(torch.cat(rows_t, dim=1))
            h = _mix_T(tg, h[:6]) + (sat * h[6], sat * h[7])
    # the initial state: M0a on Za(0)'s real part, M0b on Zb(0)'s
    return (dcf.sum(dim=0).T.contiguous(), h[4][:, :1], h[6][:, :1], ab1,
            awsc)


def xmt_fwd_torch(coef, pk, cfg: XmtCfg):
    r"""Plain PyTorch version of the ``xmt_fwd`` kernel: ``sig (nA, nTR,
    2)``. Differentiable by torch autograd (which then keeps every TR)."""
    return _mt_fwd(coef, _fixed_rows(pk), cfg, None)[0]


def xmt_fwd_chk_torch(coef, pk, cfg: XmtCfg, *, tc: int):
    r"""Plain PyTorch version of the ``xmt_fwd_chk`` kernel: ``(sig (nA,
    nTR, 2), chk (nTR / tc, 8, K, nA))``."""
    _check_tc(coef.shape[1], tc)
    return _mt_fwd(coef, _fixed_rows(pk), cfg, tc)


def xmt_bwd_torch(coef, pk, cfg: XmtCfg, chk, g, *, tc: int):
    r"""Plain PyTorch version of the ``xmt_bwd`` kernel: the two-phase chunk
    adjoint of :func:`xmt_fwd_chk_torch` (:func:`_mt_bwd`), with no
    autograd, the entries' gradients summed over the train.

    ``chk``: its checkpoints at the same ``tc``; ``g``: the echoes'
    cotangent `(nA, nTR, 2)`. Returns ``(dcoef (10, nTR), dpk (11, nA))``:
    ``dpk`` the gradients of ``[Z00, Z01, Z10, Z11, ra, rb, E2a]`` summed
    over the train, ``dM0a`` and ``dM0b`` (the cotangents of the initial
    ``Za(0)``/``Zb(0)``), ``db1`` and ``dwscale``."""
    acc = [torch.zeros_like(pk[:1].T)] * 7

    def take(t, d):
        for i in range(7):
            acc[i] = acc[i] + d[i]

    dcoef, *dm = _mt_bwd(coef, _fixed_rows(pk), cfg, chk, g, tc, take)
    return dcoef, torch.cat(acc + dm, dim=1).T.contiguous()


def xmt_v_fwd_torch(coef, pk, pkt, cfg: XmtCfg):
    r"""Plain PyTorch version of the ``xmt_v_fwd`` kernel: ``sig (nA, nTR,
    2)`` over the variable-TR train whose TR ``t`` takes the entries
    ``pkt[t]`` (``pk (4, nA) = [M0a, M0b, b1, wscale]``). Differentiable by
    torch autograd (which then keeps every TR)."""
    return _mt_fwd(coef, _train_rows(pk, pkt), cfg, None)[0]


def xmt_v_fwd_chk_torch(coef, pk, pkt, cfg: XmtCfg, *, tc: int):
    r"""Plain PyTorch version of the ``xmt_v_fwd_chk`` kernel: ``(sig (nA,
    nTR, 2), chk (nTR / tc, 8, K, nA))``."""
    _check_tc(coef.shape[1], tc)
    return _mt_fwd(coef, _train_rows(pk, pkt), cfg, tc)


def xmt_v_bwd_torch(coef, pk, pkt, cfg: XmtCfg, chk, g, *, tc: int):
    r"""Plain PyTorch version of the ``xmt_v_bwd`` kernel: the two-phase
    chunk adjoint of :func:`xmt_v_fwd_chk_torch` (:func:`_mt_bwd`), with no
    autograd, each TR's entry gradients written as they are formed.
    Returns ``(dcoef (10, nTR), dpk (4, nA) = [dM0a, dM0b, db1, dwscale],
    dpkt (nTR, 7, nA))``: ``dM0a``/``dM0b`` the cotangents of the initial
    ``Za(0)``/``Zb(0)`` (``_mtv_bwd_kernel``'s ``dpar``), ``dpkt[t]`` the
    gradients of ``pkt[t]``."""
    dpkt = torch.empty_like(pkt)

    def take(t, d):
        dpkt[t] = torch.cat(d, dim=1).T

    dcoef, *dm = _mt_bwd(coef, _train_rows(pk, pkt), cfg, chk, g, tc, take)
    return dcoef, torch.cat(dm, dim=1).T.contiguous(), dpkt


# ==========================================================================
# The EPG-X(MT) train: the kernels
# ==========================================================================

def _mt_sizes(name, coef, pk, cfg, pkt=None):
    r"""Validate an EPG-X(MT) kernel's arguments (over a variable-TR train
    ``pk`` has 4 rows and ``pkt`` holds the per-TR planes); returns ``(nA,
    nTR)``."""
    rows = NPK_MT if pkt is None else NPK_MTV
    if pk.dtype not in (torch.float32, torch.float64):
        raise TypeError(f'{name} takes float32 or float64, not {pk.dtype}')
    if pk.ndim != 2 or pk.shape[0] != rows:
        raise ValueError(f'pk must be ({rows}, nA), got {tuple(pk.shape)}')
    nA, nTR = pk.shape[1], coef.shape[-1]
    if cfg.K < 1 or cfg.kshift == 0:
        raise ValueError(f'{name} needs K >= 1 and kshift != 0, got '
                         f'K={cfg.K}, kshift={cfg.kshift}')
    _check(coef, 'coef', (NC_MT, nTR), pk.dtype, pk.device)
    _check(pk, 'pk', (rows, nA), pk.dtype, pk.device)
    if pkt is not None:
        _check(pkt, 'pkt', (nTR, NENT_MT, nA), pk.dtype, pk.device)
    return nA, nTR


def _launch_xmt_fwd(coef, pk, cfg, tc, pkt=None):
    r"""``xmt_fwd`` (``tc`` None) or ``xmt_fwd_chk``: ``(sig, chk)``; with
    ``pkt``, their variable-TR instances."""
    from mrphy_tpu_torch.kernels._build import library
    name = (('xmt_fwd' if pkt is None else 'xmt_v_fwd')
            + ('' if tc is None else '_chk'))
    nA, nTR = _mt_sizes(name, coef, pk, cfg, pkt)
    dt, dev = pk.dtype, pk.device
    threads, in_smem = launch_cfg(cfg.K, pk.element_size(), PLANES_MT)
    sig = torch.empty((nA, nTR, 2), dtype=dt, device=dev)
    chk = None
    if tc is not None:
        _check_tc(nTR, tc)
        chk = torch.empty((nTR // tc, PLANES_MT, cfg.K, nA), dtype=dt,
                          device=dev)
    state = None if in_smem else torch.empty((PLANES_MT, cfg.K, nA),
                                             dtype=dt, device=dev)
    ins = (coef, pk) if pkt is None else (coef, pk, pkt)
    lib, _ = library()
    with torch.cuda.device(dev):
        err = _entry(lib, name, dt)(
            *map(_ptr, ins + (sig, chk, state)), nA, nTR, cfg.K,
            cfg.kshift, cfg.flags, tc or nTR, threads, _stream(dev))
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return sig, chk


def _launch_xmt_bwd(coef, pk, cfg, chk, g, tc, pkt=None):
    r"""``xmt_bwd``: ``(dcoef, dpk)``; with ``pkt``, ``xmt_v_bwd``:
    ``(dcoef, dpk, dpkt)``."""
    from mrphy_tpu_torch.kernels._build import library
    name = 'xmt_bwd' if pkt is None else 'xmt_v_bwd'
    nA, nTR = _mt_sizes(name, coef, pk, cfg, pkt)
    _check_tc(nTR, tc)
    dt, dev = pk.dtype, pk.device
    _check(chk, 'chk', (nTR // tc, PLANES_MT, cfg.K, nA), dt, dev)
    _check(g, 'g', (nA, nTR, 2), dt, dev)
    threads, in_smem = launch_cfg(cfg.K, pk.element_size(), PLANES_MT)
    # phase 1's pre-RF states of one chunk (the first is chk's own), the
    # adjoint state when it does not fit in shared memory, and each warp's
    # per-TR coefficient rows (summed over its atoms)
    scratch = torch.empty((max(tc - 1, 1), PLANES_MT, cfg.K, nA), dtype=dt,
                          device=dev)
    hstate = None if in_smem else torch.empty((PLANES_MT, cfg.K, nA),
                                              dtype=dt, device=dev)
    dpk = torch.empty(pk.shape, dtype=dt, device=dev)
    dcf = torch.empty((-(-nA // 32), nTR, NC_MT), dtype=dt, device=dev)
    if pkt is None:
        ins, outs = (coef, pk, chk, g), (dpk, dcf)
    else:
        dpkt = torch.empty((nTR, NENT_MT, nA), dtype=dt, device=dev)
        ins, outs = (coef, pk, pkt, chk, g), (dpk, dcf, dpkt)
    lib, _ = library()
    with torch.cuda.device(dev):
        err = _entry(lib, name, dt)(
            *map(_ptr, ins + (scratch, hstate) + outs), nA, nTR, cfg.K,
            cfg.kshift, cfg.flags, tc, threads, _stream(dev))
    _raise_on(err, name)
    LAUNCHES[name] += 1
    # the warps' partial rows, summed in a fixed order
    dcoef = dcf.sum(dim=0).T.contiguous()
    return (dcoef, dpk) if pkt is None else (dcoef, dpk, dpkt)


def xmt_fwd(coef, pk, cfg: XmtCfg):
    r"""The ``xmt_fwd`` kernel on CUDA tensors (contiguous, one dtype,
    float32 or float64), :func:`xmt_fwd_torch` on CPU tensors."""
    if _device_kind(pk) == 'cpu':
        return xmt_fwd_torch(coef, pk, cfg)
    return _launch_xmt_fwd(coef, pk, cfg, None)[0]


def xmt_fwd_chk(coef, pk, cfg: XmtCfg, *, tc: int):
    r"""The ``xmt_fwd_chk`` kernel on CUDA tensors, :func:`xmt_fwd_chk_torch`
    on CPU tensors."""
    if _device_kind(pk) == 'cpu':
        return xmt_fwd_chk_torch(coef, pk, cfg, tc=tc)
    return _launch_xmt_fwd(coef, pk, cfg, tc)


def xmt_bwd(coef, pk, cfg: XmtCfg, chk, g, *, tc: int):
    r"""The ``xmt_bwd`` kernel on CUDA tensors, :func:`xmt_bwd_torch` on CPU
    tensors."""
    if _device_kind(pk) == 'cpu':
        return xmt_bwd_torch(coef, pk, cfg, chk, g, tc=tc)
    return _launch_xmt_bwd(coef, pk, cfg, chk, g, tc)


def xmt_v_fwd(coef, pk, pkt, cfg: XmtCfg):
    r"""The ``xmt_v_fwd`` kernel on CUDA tensors (contiguous, one dtype,
    float32 or float64), :func:`xmt_v_fwd_torch` on CPU tensors."""
    if _device_kind(pk) == 'cpu':
        return xmt_v_fwd_torch(coef, pk, pkt, cfg)
    return _launch_xmt_fwd(coef, pk, cfg, None, pkt)[0]


def xmt_v_fwd_chk(coef, pk, pkt, cfg: XmtCfg, *, tc: int):
    r"""The ``xmt_v_fwd_chk`` kernel on CUDA tensors,
    :func:`xmt_v_fwd_chk_torch` on CPU tensors."""
    if _device_kind(pk) == 'cpu':
        return xmt_v_fwd_chk_torch(coef, pk, pkt, cfg, tc=tc)
    return _launch_xmt_fwd(coef, pk, cfg, tc, pkt)


def xmt_v_bwd(coef, pk, pkt, cfg: XmtCfg, chk, g, *, tc: int):
    r"""The ``xmt_v_bwd`` kernel on CUDA tensors, :func:`xmt_v_bwd_torch` on
    CPU tensors."""
    if _device_kind(pk) == 'cpu':
        return xmt_v_bwd_torch(coef, pk, pkt, cfg, chk, g, tc=tc)
    return _launch_xmt_bwd(coef, pk, cfg, chk, g, tc, pkt)


def _mt_chunk(coef, pk, cfg):
    return pick_tc(coef.shape[1], cfg.K, pk.shape[1], pk.element_size(),
                   PLANES_MT)


class _Xmt(torch.autograd.Function):

    @staticmethod
    def forward(ctx, cfg, coef, pk):
        ctx.cfg = cfg
        if not any(ctx.needs_input_grad[1:3]):
            return xmt_fwd(coef, pk, cfg)
        tc = _mt_chunk(coef, pk, cfg)
        sig, chk = xmt_fwd_chk(coef, pk, cfg, tc=tc)
        ctx.tc = tc
        ctx.save_for_backward(coef, pk, chk)
        return sig

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        coef, pk, chk = ctx.saved_tensors
        dcoef, dpk = xmt_bwd(coef, pk, ctx.cfg, chk, g.contiguous(),
                             tc=ctx.tc)
        return None, dcoef, dpk


class _XmtV(torch.autograd.Function):

    @staticmethod
    def forward(ctx, cfg, coef, pk, pkt):
        ctx.cfg = cfg
        if not any(ctx.needs_input_grad[1:4]):
            return xmt_v_fwd(coef, pk, pkt, cfg)
        tc = _mt_chunk(coef, pk, cfg)
        sig, chk = xmt_v_fwd_chk(coef, pk, pkt, cfg, tc=tc)
        ctx.tc = tc
        ctx.save_for_backward(coef, pk, pkt, chk)
        return sig

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        coef, pk, pkt, chk = ctx.saved_tensors
        dcoef, dpk, dpkt = xmt_v_bwd(coef, pk, pkt, ctx.cfg, chk,
                                     g.contiguous(), tc=ctx.tc)
        return None, dcoef, dpk, dpkt


def xmt(coef, pk, cfg: XmtCfg):
    r"""The EPG-X(MT) SPGR train ``sig (nA, nTR, 2)`` at a fixed TR: the
    kernels on CUDA tensors (``xmt_fwd``, or ``xmt_fwd_chk`` and ``xmt_bwd``
    when a gradient is needed), their plain versions on CPU tensors.
    Differentiable w.r.t. ``coef`` and ``pk``."""
    return _Xmt.apply(cfg, coef.contiguous(), pk.contiguous())


def xmt_v(coef, pk, pkt, cfg: XmtCfg):
    r"""The EPG-X(MT) SPGR train ``sig (nA, nTR, 2)`` over a variable-TR
    train: the kernels on CUDA tensors (``xmt_v_fwd``, or ``xmt_v_fwd_chk``
    and ``xmt_v_bwd`` when a gradient is needed), their plain versions on
    CPU tensors. Differentiable w.r.t. ``coef``, ``pk`` and ``pkt``."""
    return _XmtV.apply(cfg, coef.contiguous(), pk.contiguous(),
                       pkt.contiguous())


def xmt_spgr(flips, phis=None, *, T1a, T2a, T1b, kab, kba, tr, wt=0.0,
             wscale=None, M0a=1.0, M0b=0.1, b1=None, kshift: int = 1,
             K=None):
    r"""The EPG-X(MT) gradient-spoiled train of a qMT dictionary through the
    kernels (counterpart of ``epg_pallas.epgx_mt_spgr_pallas``).

    The semantics of :func:`mrphy_tpu_torch.ops.epg.epgx_mt_spgr` for the
    dictionary workload: a shared `(nTR,)` flip (and phase) train, a shared
    ``wt`` `()` or `(nTR,)` saturation train, a scalar ``tr`` or a shared
    `(nTR,)` ``tr`` train (a fingerprinting schedule: the variable-TR
    kernels over the per-TR planes), the tissue and exchange maps per atom,
    flattened into one atom axis. The per-atom
    saturation scale ``wscale`` (the bound pool's lineshape ``G(Δ, T2b)``)
    multiplies the shared ``wt``: the effective saturation equals the plain
    route's batched ``wt[None]·wscale[:, None]``. ``b1`` scales the flips
    per atom. Returns ``(nAtoms, nTR, 2)``: the kernels (``xmt_fwd``, or
    ``xmt_fwd_chk`` and ``xmt_bwd`` under a gradient; over a ``tr`` train
    ``xmt_v_fwd``, or ``xmt_v_fwd_chk`` and ``xmt_v_bwd``) on CUDA tensors,
    their plain versions on CPU tensors. Differentiable w.r.t. every input,
    ``wt``, ``wscale`` and every element of a ``tr`` train among them."""
    from mrphy_tpu_torch.ops.epg import _xmt_rows
    if int(kshift) == 0:
        raise ValueError('kshift must be a nonzero integer')
    coef, pk, cfg, _ = _xmt_rows(flips, phis, T1a=T1a, T2a=T2a, T1b=T1b,
                                 kab=kab, kba=kba, tr=tr, wt=wt,
                                 wscale=wscale, M0a=M0a, M0b=M0b, b1=b1,
                                 kshift=int(kshift), K=K)
    if isinstance(pk, tuple):
        return xmt_v(coef, *pk, cfg)
    return xmt(coef, pk, cfg)
