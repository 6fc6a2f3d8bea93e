r"""The balanced-SSFP kernels: wrappers, plain PyTorch versions and launch
counts.

Three kernels, each the Hopper counterpart of a TPU kernel of
:mod:`mrphy_tpu.ops.ssfp_pallas`, for the transient balanced-SSFP train of
:func:`mrphy_tpu_torch.ops.ssfp.bssfp_train` (one isochromat per atom, no
configuration orders):

- ``bssfp_fwd`` (``csrc/bssfp_fwd.cu``, replaces ``_bssfp_kernel``): per
  atom and TR, the RF rotation about ``(cos φ, sin φ, 0)`` by ``−α``
  (Rodrigues), precession and relaxation to TE, the echo demodulated by the
  transmit phase, then precession and relaxation over the TR remainder.
- ``bssfp_fwd_chk`` (the same source, replaces ``_bssfp_fwd_chk_kernel``):
  the same train, also writing the state at the start of every chunk of
  ``tc`` TRs.
- ``bssfp_bwd`` (``csrc/bssfp_bwd.cu``, replaces ``_bssfp_bwd_kernel``):
  the two-phase chunk adjoint. Per chunk, newest first, phase 1 re-runs the
  forward from the chunk's start state and stores every pre-RF state;
  phase 2 walks them backwards (the remainder's transpose, the echo's
  cotangent, the TE transpose, the RF rotation's transpose).

Arguments, as ``_bssfp_dispatch`` (``ssfp_pallas.py:151-199``) builds them
(without its padding of the train to a multiple of 8, which the TPU's
unrolled loop needed):

- ``coef (nC, nTR)``: the per-TR rows ``[cos α, sin α·sin φ, sin α·cos φ,
  (1 − cos α)·cos φ, (1 − cos α)·sin φ, cos φ, sin φ, α]``, and under a
  variable TR or TE (``vartr``) two more, ``[te, tr − te]`` (nC = 10, else
  8);
- ``pk (nP, nA)``: at a constant TR/TE the per-atom rows ``[cos(ω·te),
  sin(ω·te), E2(te), 1 − E1(te), cos(ω·rem), sin(ω·rem), E2(rem), 1 −
  E1(rem), M0, b1]`` (ω = −2π·df, rem = tr − te; nP = 10); under ``vartr``
  the rates ``[1/T1, 1/T2, ω, M0, b1]`` (nP = 5), from which the kernels
  form the factors per TR (the recovery through ``expm1``);
- ``cfg``: :class:`BssfpCfg`, the static switches.

The forward returns the echoes ``(er, ei)``, each ``(nTR, nA)``, and, with
``tc``, the chunk-start states ``chk (nTR / tc, 3, nA)``, rows ``[Mx, My,
Mz]``. The adjoint takes ``chk`` and the echoes' cotangent and returns
``dcoef (nC, nTR)`` (summed over atoms) and ``dpk (nP, nA)``. Under ``b1``
the angle ``α·b1`` is formed per atom, and the adjoint chains its gradient
itself: ``dcoef``'s rows 0–4 stay 0, rows 5–7 carry cos φ's, sin φ's and
α's, and the b1 row of ``dpk`` gathers ``Σ_t d(α·b1)·α_t``; without b1 that
row is 0. The initial state ``(0, 0, M0)``'s cotangent is added to the M0
row. The gradients of flips, phis, T1, T2, df, M0, b1, tr and te w.r.t.
these rows come from torch autograd of their construction
(:func:`mrphy_tpu_torch.ops.ssfp._bssfp_rows`).

Each kernel has beside it its plain PyTorch version (``*_torch``: a loop
over TRs on ``(nA,)`` planes in the kernel's order of operations; the
adjoint's uses no autograd and sums the per-TR rows over the atoms in the
kernel's order, :func:`mrphy_tpu_torch.kernels.epgx._warp_sums`) and a
launch count, ``LAUNCHES[name]``, raised by one at every launch of the
kernel and nowhere else. :func:`bssfp` is their ``torch.autograd.Function``:
``bssfp_fwd`` with no gradient needed, otherwise ``bssfp_fwd_chk`` with
``bssfp_bwd`` as its backward (the kernels on CUDA tensors, no fallback;
the plain versions on CPU tensors). The adjoint takes every instance the
forward takes: its per-chunk scratch of pre-RF states, ``(tc, 3, nA)``,
lies in device memory, the chunk sized by
:func:`mrphy_tpu_torch.kernels.epg.pick_tc` for 3 planes.
"""

from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from mrphy_tpu_torch.kernels.bloch import (_check, _check_tc, _device_kind,
                                           _ptr, _raise_on, _stream)
from mrphy_tpu_torch.kernels.epg import _entry, pick_tc
from mrphy_tpu_torch.kernels.epgx import _warp_sums

__all__ = ['LAUNCHES', 'PLANES', 'BssfpCfg', 'bssfp', 'chunk',
           'bssfp_fwd', 'bssfp_fwd_torch', 'bssfp_fwd_chk',
           'bssfp_fwd_chk_torch', 'bssfp_bwd', 'bssfp_bwd_torch']

LAUNCHES = {'bssfp_fwd': 0, 'bssfp_fwd_chk': 0, 'bssfp_bwd': 0}

# An atom's state: (Mx, My, Mz).
PLANES = 3


class BssfpCfg(NamedTuple):
    r"""The static switches of one bSSFP train: per-atom ``b1`` and a
    variable TR or TE (``vartr``)."""
    has_b1: bool
    vartr: bool

    @property
    def nC(self) -> int:
        return 10 if self.vartr else 8

    @property
    def nP(self) -> int:
        return 5 if self.vartr else 10

    @property
    def m0_row(self) -> int:
        return 3 if self.vartr else 8

    @property
    def flags(self) -> int:
        return int(self.has_b1) | 2 * int(self.vartr)


# ==========================================================================
# The plain versions
# ==========================================================================

def _rf(coef, t, b1, has_b1):
    r"""TR ``t``'s RF factors ``(cos α, sin α, A, B, vc, vs, cos φ, sin
    φ)``, ``A = sin α·sin φ``, ``B = sin α·cos φ``, ``vc``/``vs`` ``(1 −
    cos α)·cos φ``/``sin φ``: the rows, or under ``has_b1`` per atom from
    ``α = flip·b1`` (``sin α`` only then)."""
    cphi, sphi = coef[5, t], coef[6, t]
    if has_b1:
        al = coef[7, t] * b1
        ca, sa = torch.cos(al), torch.sin(al)
        A, B = sa * sphi, sa * cphi
        oc = 1 - ca
        return ca, sa, A, B, oc * cphi, oc * sphi, cphi, sphi
    return (coef[0, t], None, coef[1, t], coef[2, t], coef[3, t], coef[4, t],
            cphi, sphi)


def _relax(coef, t, pk, vartr):
    r"""TR ``t``'s ``(cos, sin, E2, 1 − E1)`` to TE, then over the
    remainder: the per-atom rows, or under ``vartr`` formed from the rates
    and the te/rem rows."""
    if not vartr:
        return tuple(pk[:8])
    R1, R2, om = pk[0], pk[1], pk[2]
    out = []
    for dur in (coef[8, t], coef[9, t]):
        ph = om * dur
        out += [torch.cos(ph), torch.sin(ph), torch.exp(-dur * R2),
                -torch.expm1(-(dur * R1))]
    return tuple(out)


def _te(rf, rx, M0, M):
    r"""From the pre-RF state ``M``: the RF rotation and the TE interval.
    Returns the step's intermediates ``(dot, Mx1, My1, Mz1, MxE, MyE,
    MzE)``: the rotated state and the state at TE."""
    ca, _, A, B, vc, vs, cphi, sphi = rf
    cte, ste, E2te, a1te = rx[:4]
    Mx, My, Mz = M
    dot = cphi * Mx + sphi * My
    Mx1 = ca * Mx - A * Mz + vc * dot
    My1 = ca * My + B * Mz + vs * dot
    Mz1 = ca * Mz + A * Mx - B * My
    MxE = E2te * (cte * Mx1 - ste * My1)
    MyE = E2te * (ste * Mx1 + cte * My1)
    MzE = (1 - a1te) * Mz1 + a1te * M0
    return dot, Mx1, My1, Mz1, MxE, MyE, MzE


def _rem(rx, M0, MxE, MyE, MzE):
    r"""The TR's remainder from the state at TE: the next pre-RF state."""
    crem, srem, E2rem, a1rem = rx[4:]
    Mx2 = E2rem * (crem * MxE - srem * MyE)
    My2 = E2rem * (srem * MxE + crem * MyE)
    Mz2 = (1 - a1rem) * MzE + a1rem * M0
    return Mx2, My2, Mz2


def _step(rf, rx, M0, M):
    r"""One full TR from the pre-RF state ``M``: the RF rotation, the TE
    interval, the echo, the remainder. Returns ``(M', (er, ei))``."""
    cphi, sphi = rf[6], rf[7]
    MxE, MyE, MzE = _te(rf, rx, M0, M)[4:]
    er = cphi * MxE + sphi * MyE
    ei = cphi * MyE - sphi * MxE
    return _rem(rx, M0, MxE, MyE, MzE), (er, ei)


def _tr(coef, t, pk, cfg, M):
    return _step(_rf(coef, t, pk[-1], cfg.has_b1),
                 _relax(coef, t, pk, cfg.vartr), pk[cfg.m0_row], M)


def _fwd(coef, pk, cfg, tc):
    r"""The train from equilibrium: ``(er, ei, chk or None)``."""
    nTR = coef.shape[1]
    M0 = pk[cfg.m0_row]
    z = torch.zeros_like(M0)
    M = (z, z, M0)
    er, ei = [], []
    chk = M0.new_empty((nTR // tc, PLANES, M0.shape[0])) if tc else None
    for t in range(nTR):
        if tc and t % tc == 0:
            chk[t // tc] = torch.stack(M)
        M, (r, i) = _tr(coef, t, pk, cfg, M)
        er.append(r)
        ei.append(i)
    return torch.stack(er), torch.stack(ei), chk


def bssfp_fwd_torch(coef, pk, cfg: BssfpCfg):
    r"""Plain PyTorch version of the ``bssfp_fwd`` kernel: the echoes ``(er,
    ei)``, each ``(nTR, nA)``. Differentiable by torch autograd (which then
    keeps every TR)."""
    return _fwd(coef, pk, cfg, None)[:2]


def bssfp_fwd_chk_torch(coef, pk, cfg: BssfpCfg, *, tc: int):
    r"""Plain PyTorch version of the ``bssfp_fwd_chk`` kernel: ``(er, ei,
    chk (nTR / tc, 3, nA))``, the pre-RF state at the start of every chunk
    of ``tc`` TRs."""
    _check_tc(coef.shape[1], tc)
    return _fwd(coef, pk, cfg, tc)


def bssfp_bwd_torch(coef, pk, cfg: BssfpCfg, chk, gr, gi, *, tc: int):
    r"""Plain PyTorch version of the ``bssfp_bwd`` kernel: the two-phase
    chunk adjoint of :func:`bssfp_fwd_chk_torch` from its checkpoints
    ``chk`` at chunk length ``tc`` and the echoes' cotangent ``gr``/``gi``
    (each ``(nTR, nA)``), with no autograd, in ``_bssfp_bwd_kernel``'s
    order (``ssfp_pallas.py:363-540``). The per-TR rows are summed over the
    atoms in the kernel's order: by warps of 32 (``_warp_sums``), then over
    the warps by one ``torch.sum``, as the wrapper sums the kernel's
    partial rows. Returns ``(dcoef (nC, nTR), dpk (nP, nA))``."""
    nTR = coef.shape[1]
    _check_tc(nTR, tc)
    ntc = chk.shape[0]
    if ntc != nTR // tc:
        raise ValueError(f'chk holds {ntc} states, but nTR={nTR} in chunks '
                         f'of tc={tc} gives {nTR // tc}')
    M0, b1 = pk[cfg.m0_row], pk[-1]
    zero = torch.zeros_like(M0)
    hx2 = hy2 = hz2 = zero
    acc = [zero] * cfg.nP
    dcf = coef.new_zeros((-(-M0.shape[0] // 32), nTR, cfg.nC))
    for j in reversed(range(ntc)):
        # phase 1: the forward from the chunk's start state, every pre-RF
        # state with its TR's factors and intermediates (no echo, and no
        # remainder after the chunk's last TR)
        M = tuple(chk[j])
        states = []
        for t in range(j * tc, (j + 1) * tc):
            rf = _rf(coef, t, b1, cfg.has_b1)
            rx = _relax(coef, t, pk, cfg.vartr)
            mid = _te(rf, rx, M0, M)
            states.append((M, rf, rx, mid))
            if t + 1 < (j + 1) * tc:
                M = _rem(rx, M0, *mid[4:])
        # phase 2: the cotangent, backwards through the stored states
        for t in reversed(range(j * tc, (j + 1) * tc)):
            (Mx, My, Mz), rf, rx, mid = states.pop()
            ca, sa, A, B, vc, vs, cphi, sphi = rf
            cte, ste, E2te, a1te, crem, srem, E2rem, a1rem = rx
            dot, Mx1, My1, Mz1, MxE, MyE, MzE = mid
            # the remainder's transpose and its factors' gradients
            d_E2rem = hx2 * (crem * MxE - srem * MyE) \
                + hy2 * (srem * MxE + crem * MyE)
            d_crem = E2rem * (hx2 * MxE + hy2 * MyE)
            d_srem = E2rem * (hy2 * MxE - hx2 * MyE)
            d_a1rem = hz2 * (M0 - MzE)
            d_M0 = a1rem * hz2
            hxE = E2rem * (crem * hx2 + srem * hy2)
            hyE = E2rem * (crem * hy2 - srem * hx2)
            hzE = (1 - a1rem) * hz2
            # the echo's cotangent (the echo reads the TE state)
            gyr, gyi = gr[t], gi[t]
            d_cphi = gyr * MxE + gyi * MyE
            d_sphi = gyr * MyE - gyi * MxE
            hxE = hxE + cphi * gyr - sphi * gyi
            hyE = hyE + sphi * gyr + cphi * gyi
            # the TE transpose and its factors' gradients
            d_E2te = hxE * (cte * Mx1 - ste * My1) \
                + hyE * (ste * Mx1 + cte * My1)
            d_cte = E2te * (hxE * Mx1 + hyE * My1)
            d_ste = E2te * (hyE * Mx1 - hxE * My1)
            d_a1te = hzE * (M0 - Mz1)
            d_M0 = d_M0 + a1te * hzE
            hx1 = E2te * (cte * hxE + ste * hyE)
            hy1 = E2te * (cte * hyE - ste * hxE)
            hz1 = (1 - a1te) * hzE
            # the RF rotation's transpose and its coefficients' gradients
            d_ca = hx1 * Mx + hy1 * My + hz1 * Mz
            d_A = hz1 * Mx - hx1 * Mz
            d_B = hy1 * Mz - hz1 * My
            d_vc = hx1 * dot
            d_vs = hy1 * dot
            hdot = vc * hx1 + vs * hy1
            d_cphi = d_cphi + hdot * Mx
            d_sphi = d_sphi + hdot * My
            hx2 = ca * hx1 + A * hz1 + cphi * hdot
            hy2 = ca * hy1 - B * hz1 + sphi * hdot
            hz2 = -A * hx1 + B * hy1 + ca * hz1
            if cfg.has_b1:
                # α = flip·b1: A, B, vc, vs chained back to (α, φ) here
                d_sa = sphi * d_A + cphi * d_B
                d_catot = d_ca - cphi * d_vc - sphi * d_vs
                d_al = ca * d_sa - sa * d_catot
                acc[-1] = acc[-1] + d_al * coef[7, t]
                d_cphi = d_cphi + sa * d_B + (1 - ca) * d_vc
                d_sphi = d_sphi + sa * d_A + (1 - ca) * d_vs
                rows = [zero] * 5 + [d_cphi, d_sphi, d_al * b1]
            else:
                rows = [d_ca, d_A, d_B, d_vc, d_vs, d_cphi, d_sphi, zero]
            if cfg.vartr:
                R1, R2, om = pk[0], pk[1], pk[2]
                ten, remn = coef[8, t], coef[9, t]
                d_pte = cte * d_ste - ste * d_cte
                d_prem = crem * d_srem - srem * d_crem
                acc[2] = acc[2] + d_pte * ten + d_prem * remn
                acc[1] = acc[1] - ten * E2te * d_E2te \
                    - remn * E2rem * d_E2rem
                acc[0] = acc[0] + ten * (1 - a1te) * d_a1te \
                    + remn * (1 - a1rem) * d_a1rem
                acc[3] = acc[3] + d_M0
                rows += [om * d_pte - R2 * E2te * d_E2te
                         + R1 * (1 - a1te) * d_a1te,
                         om * d_prem - R2 * E2rem * d_E2rem
                         + R1 * (1 - a1rem) * d_a1rem]
            else:
                for a, v in enumerate((d_cte, d_ste, d_E2te, d_a1te, d_crem,
                                       d_srem, d_E2rem, d_a1rem, d_M0)):
                    acc[a] = acc[a] + v
            dcf[:, t] = _warp_sums(torch.stack(rows, dim=1))
    # the initial state (0, 0, M0)
    acc[cfg.m0_row] = acc[cfg.m0_row] + hz2
    return dcf.sum(dim=0).T.contiguous(), torch.stack(acc)


# ==========================================================================
# The kernels
# ==========================================================================

def _sizes(name, coef, pk, cfg):
    r"""Validate a bSSFP kernel's arguments; returns ``(nA, nTR)``."""
    if pk.dtype not in (torch.float32, torch.float64):
        raise TypeError(f'{name} takes float32 or float64, not {pk.dtype}')
    if pk.ndim != 2 or pk.shape[0] != cfg.nP:
        raise ValueError(f'pk must be ({cfg.nP}, nA), got '
                         f'{tuple(pk.shape)}')
    nA, nTR = pk.shape[1], coef.shape[-1]
    if nA < 1 or nTR < 1:
        raise ValueError(f'{name} needs nA >= 1 and nTR >= 1, got nA={nA}, '
                         f'nTR={nTR}')
    _check(coef, 'coef', (cfg.nC, nTR), pk.dtype, pk.device)
    _check(pk, 'pk', (cfg.nP, nA), pk.dtype, pk.device)
    return nA, nTR


def _launch_fwd(coef, pk, cfg, tc):
    r"""``bssfp_fwd`` (``tc`` None) or ``bssfp_fwd_chk``: ``(er, ei,
    chk)``."""
    from mrphy_tpu_torch.kernels._build import library
    name = 'bssfp_fwd' if tc is None else 'bssfp_fwd_chk'
    nA, nTR = _sizes(name, coef, pk, cfg)
    dt, dev = pk.dtype, pk.device
    er = torch.empty((nTR, nA), dtype=dt, device=dev)
    ei = torch.empty((nTR, nA), dtype=dt, device=dev)
    chk = None
    if tc is not None:
        _check_tc(nTR, tc)
        chk = torch.empty((nTR // tc, PLANES, nA), dtype=dt, device=dev)
    lib, _ = library()
    with torch.cuda.device(dev):
        err = _entry(lib, name, dt)(
            *map(_ptr, (coef, pk, er, ei, chk)), nA, nTR, cfg.flags,
            tc or nTR, _stream(dev))
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return er, ei, chk


def _launch_bwd(coef, pk, cfg, chk, gr, gi, tc):
    r"""``bssfp_bwd``: ``(dcoef, dpk)``."""
    from mrphy_tpu_torch.kernels._build import library
    name = 'bssfp_bwd'
    nA, nTR = _sizes(name, coef, pk, cfg)
    _check_tc(nTR, tc)
    dt, dev = pk.dtype, pk.device
    _check(chk, 'chk', (nTR // tc, PLANES, nA), dt, dev)
    _check(gr, 'gr', (nTR, nA), dt, dev)
    _check(gi, 'gi', (nTR, nA), dt, dev)
    # phase 1's pre-RF states of one chunk, and each warp's per-TR
    # coefficient rows (summed over its atoms)
    scratch = torch.empty((tc, PLANES, nA), dtype=dt, device=dev)
    dpk = torch.empty(pk.shape, dtype=dt, device=dev)
    dcf = torch.empty((-(-nA // 32), nTR, cfg.nC), dtype=dt, device=dev)
    lib, _ = library()
    with torch.cuda.device(dev):
        err = _entry(lib, name, dt)(
            *map(_ptr, (coef, pk, chk, gr, gi, scratch, dpk, dcf)), nA, nTR,
            cfg.flags, tc, _stream(dev))
    _raise_on(err, name)
    LAUNCHES[name] += 1
    # the warps' partial rows, summed in a fixed order
    return dcf.sum(dim=0).T.contiguous(), dpk


def bssfp_fwd(coef, pk, cfg: BssfpCfg):
    r"""The ``bssfp_fwd`` kernel on CUDA tensors (contiguous, one dtype,
    float32 or float64), :func:`bssfp_fwd_torch` on CPU tensors."""
    if _device_kind(pk) == 'cpu':
        return bssfp_fwd_torch(coef, pk, cfg)
    return _launch_fwd(coef, pk, cfg, None)[:2]


def bssfp_fwd_chk(coef, pk, cfg: BssfpCfg, *, tc: int):
    r"""The ``bssfp_fwd_chk`` kernel on CUDA tensors,
    :func:`bssfp_fwd_chk_torch` on CPU tensors."""
    if _device_kind(pk) == 'cpu':
        return bssfp_fwd_chk_torch(coef, pk, cfg, tc=tc)
    return _launch_fwd(coef, pk, cfg, tc)


def bssfp_bwd(coef, pk, cfg: BssfpCfg, chk, gr, gi, *, tc: int):
    r"""The ``bssfp_bwd`` kernel on CUDA tensors, :func:`bssfp_bwd_torch` on
    CPU tensors."""
    if _device_kind(pk) == 'cpu':
        return bssfp_bwd_torch(coef, pk, cfg, chk, gr, gi, tc=tc)
    return _launch_bwd(coef, pk, cfg, chk, gr, gi, tc)


def chunk(nTR: int, nA: int, itemsize: int) -> int:
    r"""The adjoint's chunk length: :func:`~mrphy_tpu_torch.kernels.epg.
    pick_tc` for the 3 planes of an isochromat (tc 100 at 1,048,576 atoms ×
    200 TRs in float32: a 1.26 GB scratch and 2 checkpoints of 12.6 MB)."""
    return pick_tc(nTR, 1, nA, itemsize, PLANES)


class _Bssfp(torch.autograd.Function):

    @staticmethod
    def forward(ctx, cfg, coef, pk):
        ctx.cfg = cfg
        if not any(ctx.needs_input_grad[1:3]):
            return bssfp_fwd(coef, pk, cfg)
        tc = chunk(coef.shape[1], pk.shape[1], pk.element_size())
        er, ei, chk = bssfp_fwd_chk(coef, pk, cfg, tc=tc)
        ctx.tc = tc
        ctx.save_for_backward(coef, pk, chk)
        return er, ei

    @staticmethod
    @once_differentiable
    def backward(ctx, gr, gi):
        coef, pk, chk = ctx.saved_tensors
        dcoef, dpk = bssfp_bwd(coef, pk, ctx.cfg, chk, gr.contiguous(),
                               gi.contiguous(), tc=ctx.tc)
        return None, dcoef, dpk


def bssfp(coef, pk, cfg: BssfpCfg):
    r"""The bSSFP echoes ``(er, ei)``, each ``(nTR, nA)``: the kernels on
    CUDA tensors (``bssfp_fwd``, or ``bssfp_fwd_chk`` and ``bssfp_bwd`` when
    a gradient is needed), their plain versions on CPU tensors.
    Differentiable w.r.t. ``coef`` and ``pk``."""
    return _Bssfp.apply(cfg, coef.contiguous(), pk.contiguous())
