r"""The two-pool EPG-X kernels: wrappers, plain PyTorch versions and launch
counts.

Three kernels, each the Hopper counterpart of a TPU kernel of
:mod:`mrphy_tpu.ops.epg_pallas`, for the gradient-spoiled train of a
two-pool exchanging system at a fixed TR (:func:`mrphy_tpu_torch.ops.epg.
epgx_spgr`):

- ``xspgr_fwd`` (``csrc/xspgr_fwd.cu``, replaces ``_epgx_kernel``): per
  atom and TR, the RF mix on pool a and on pool b, the echo (the total
  ``Fa+(0) + Fb+(0)`` demodulated by the transmit phase), the exact
  exchange–relaxation of every order (the complex 2×2 propagator on
  ``F+``, its conjugate on ``F−``, the real 2×2 on ``Z`` with the affine
  recovery into ``Z(0)``), and ``|kshift|`` unit shifts of both pools.
- ``xspgr_fwd_chk`` (the same source, replaces ``_xspgr_fwd_chk_kernel``):
  the same train, also writing the state at the start of every chunk of
  ``tc`` TRs.
- ``xspgr_bwd`` (``csrc/xspgr_bwd.cu``, replaces ``_xspgr_bwd_kernel``):
  the two-phase chunk adjoint. Per chunk, newest first, phase 1 re-runs the
  forward from the chunk's start state and stores every pre-RF state;
  phase 2 walks them backwards (the shift's transpose, the
  exchange–relaxation transpose with its 14 entry gradients, the echo's
  cotangent into both pools' ``F+(0)``, the RF mix's coefficients and
  transpose on both pools).

Arguments, as ``_epgx_dispatch`` (``epg_pallas.py:584-621``) builds them:

- ``coef (9, nTR)``: SPGR's per-TR rows ``[cos²(α/2), sin²(α/2), sin α,
  cos α, cos φ, sin φ, cos 2φ, sin 2φ, α]``;
- ``par (17, nA)``: the per-atom rows ``[E00r, E00i, E01r, E01i, E10r,
  E10i, E11r, E11i, Z00, Z01, Z10, Z11, ra, rb, M0a, M0b, b1]``: the
  transverse propagator's entries (re, im), the longitudinal one's, the
  recovery into ``Za(0)``/``Zb(0)``, the initial ``Z(0)`` of each pool and
  the transmit scale;
- ``cfg``: :class:`XspgrCfg`, the static switches.

An atom's state is 12 planes of K orders, pool a's rows ``[F+ re, F+ im,
F− re, F− im, Z re, Z im]`` then pool b's. The forward returns the echoes
``sig (nA, nTR, 2)`` and, with ``tc``, the chunk-start states ``chk (nTR /
tc, 12, K, nA)``. The adjoint takes ``chk`` and the echoes' cotangent and
returns ``dcoef (9, nTR)`` (summed over atoms) and ``dpar (17, nA)``: the
14 propagator entries' gradients, ``dM0a``/``dM0b`` (the cotangents of the
initial ``Za(0)``/``Zb(0)``) and ``db1``. The gradients of T1a, T2a, T1b,
T2b, kab, kba, tr, M0a, M0b, dfb and b1 w.r.t. these rows come from torch
autograd of their construction (:func:`mrphy_tpu_torch.ops.epg.
_xspgr_rows`); ``M0a``/``M0b`` reach the echoes twice, through ``Z(0)``
and through the recovery, and autograd adds both.

Each kernel has beside it its plain PyTorch version (``*_torch``: a loop
over TRs on ``(nA, K)`` planes in the kernel's order of operations, the
single-pool SPGR step functions of :mod:`mrphy_tpu_torch.kernels.epg` for
each pool's mix and shift, sums over the orders one order at a time; the
adjoint's uses no autograd) and a launch count, ``LAUNCHES[name]``, raised
by one at every launch of the kernel and nowhere else. :func:`xspgr` is
their ``torch.autograd.Function``: ``xspgr_fwd`` with no gradient needed,
otherwise ``xspgr_fwd_chk`` with ``xspgr_bwd`` as its backward (the
kernels on CUDA tensors, no fallback; the plain versions on CPU tensors).
The adjoint's per-chunk scratch lies in device memory, its chunk sized by
:func:`mrphy_tpu_torch.kernels.epg.pick_tc` for 12 planes.
"""

from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from mrphy_tpu_torch.kernels.bloch import (_check, _check_tc, _device_kind,
                                           _ptr, _raise_on, _stream)
from mrphy_tpu_torch.kernels.epg import (_at0, _entry, _ksum, _mix, _mix_T,
                                         _shift, _shift_T, _trig, launch_cfg,
                                         pick_tc)

__all__ = ['LAUNCHES', 'PLANES', 'XspgrCfg', 'xspgr', 'xspgr_fwd',
           'xspgr_fwd_torch', 'xspgr_fwd_chk', 'xspgr_fwd_chk_torch',
           'xspgr_bwd', 'xspgr_bwd_torch']

LAUNCHES = {'xspgr_fwd': 0, 'xspgr_fwd_chk': 0, 'xspgr_bwd': 0}

# The state planes of one atom: both pools' F+, F−, Z (re, im).
PLANES = 12
NPAR = 17


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
    r"""TR ``t`` from the pre-RF state ``s``: ``(next pre-RF state, echo
    (nA, 2))``."""
    tg = _trig(coef, t, p[16], cfg.has_b1)
    s1 = _xmix(tg, s)
    c1, s1c = tg[4], tg[5]
    fr = s1[0][:, :1] + s1[6][:, :1]
    fi = s1[1][:, :1] + s1[7][:, :1]
    echo = torch.cat([c1 * fr + s1c * fi, c1 * fi - s1c * fr], dim=1)
    s2 = _xrelax(p, s1)
    return _shift(s2[:6], cfg.kshift) + _shift(s2[6:], cfg.kshift), echo


def _xfwd(coef, par, cfg, tc):
    nTR = coef.shape[1]
    p = par.unsqueeze(-1)                              # (17, nA, 1)
    z = torch.zeros(par.shape[1], cfg.K, dtype=par.dtype, device=par.device)
    s = (z, z, z, z, _at0(z, p[14]), z, z, z, z, z, _at0(z, p[15]), z)
    echoes = []
    chk = par.new_empty((nTR // tc, PLANES, cfg.K, par.shape[1])) if tc \
        else None
    for t in range(nTR):
        if tc and t % tc == 0:
            chk[t // tc] = torch.stack(s).transpose(1, 2)  # (12, K, nA)
        s, echo = _xstep(coef, t, p, cfg, s)
        echoes.append(echo)
    return torch.stack(echoes, dim=1), chk             # (nA, nTR, 2)


def xspgr_fwd_torch(coef, par, cfg: XspgrCfg):
    r"""Plain PyTorch version of the ``xspgr_fwd`` kernel: ``sig (nA, nTR,
    2)``. Differentiable by torch autograd (which then keeps every TR)."""
    return _xfwd(coef, par, cfg, None)[0]


def xspgr_fwd_chk_torch(coef, par, cfg: XspgrCfg, *, tc: int):
    r"""Plain PyTorch version of the ``xspgr_fwd_chk`` kernel: ``(sig (nA,
    nTR, 2), chk (nTR / tc, 12, K, nA))``."""
    _check_tc(coef.shape[1], tc)
    return _xfwd(coef, par, cfg, tc)


def xspgr_bwd_torch(coef, par, cfg: XspgrCfg, chk, g, *, tc: int):
    r"""Plain PyTorch version of the ``xspgr_bwd`` kernel: the two-phase
    chunk adjoint of :func:`xspgr_fwd_chk_torch`, with no autograd.

    ``chk``: its checkpoints at the same ``tc``; ``g``: the echoes'
    cotangent `(nA, nTR, 2)`. Per TR, newest first: the shift's transpose
    on both pools, the exchange–relaxation transpose (:func:`_xrelax_T`),
    the echo's cotangent into both pools' ``F+(0)``, the mix's coefficient
    terms summed over the pools order by order, the mix's transpose.
    Returns ``(dcoef (9, nTR), dpar (17, nA))``."""
    nTR = coef.shape[1]
    _check_tc(nTR, tc)
    ntc = chk.shape[0]
    if ntc != nTR // tc:
        raise ValueError(f'chk holds {ntc} states, but nTR={nTR} in chunks '
                         f'of tc={tc} gives {nTR // tc}')
    p = par.unsqueeze(-1)
    zero = torch.zeros_like(p[0])
    h = (torch.zeros_like(chk[0, 0].T),) * PLANES
    acc = [zero] * 14
    ab1 = zero
    dcoef = coef.new_zeros(XspgrCfg.nC, nTR)
    for j in reversed(range(ntc)):
        # phase 1: the forward from the chunk's start state, every state
        s = tuple(chk[j, q].T for q in range(PLANES))
        states = []
        for t in range(j * tc, (j + 1) * tc):
            states.append(s)
            s, _ = _xstep(coef, t, p, cfg, s)
        # phase 2: the cotangent, backwards through the stored states
        for t in reversed(range(j * tc, (j + 1) * tc)):
            s = states.pop()
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
            sums = _ksum(torch.stack(terms)).unsqueeze(-1)   # (20, nA, 1)
            for i in range(12):
                acc[i] = acc[i] + sums[i]
            acc[12] = acc[12] + d_ra
            acc[13] = acc[13] + d_rb
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
                rows = [zero, zero, zero, zero, d_c1, d_s1, d_c2, d_s2,
                        d_al * p[16]]
            else:
                rows = [d_ca2, d_sa2, d_sa, d_ca, d_c1, d_s1, d_c2, d_s2,
                        zero]
            dcoef[:, t] = torch.cat(rows, dim=1).sum(dim=0)
            h = _mix_T(tg, h[:6]) + _mix_T(tg, h[6:])
    # the initial state: M0a on Za(0)'s real part, M0b on Zb(0)'s
    dpar = torch.cat(acc + [h[4][:, :1], h[10][:, :1], ab1], dim=1).T
    return dcoef, dpar.contiguous()


# ==========================================================================
# The kernels
# ==========================================================================

def _sizes(name, coef, par, cfg):
    if par.dtype not in (torch.float32, torch.float64):
        raise TypeError(f'{name} takes float32 or float64, not {par.dtype}')
    if par.ndim != 2 or par.shape[0] != NPAR:
        raise ValueError(f'par must be ({NPAR}, nA), got {tuple(par.shape)}')
    nA, nTR = par.shape[1], coef.shape[-1]
    if cfg.K < 1 or cfg.kshift == 0:
        raise ValueError(f'{name} needs K >= 1 and kshift != 0, got '
                         f'K={cfg.K}, kshift={cfg.kshift}')
    _check(coef, 'coef', (cfg.nC, nTR), par.dtype, par.device)
    _check(par, 'par', (NPAR, nA), par.dtype, par.device)
    return nA, nTR


def _launch_fwd(coef, par, cfg, tc):
    from mrphy_tpu_torch.kernels._build import library
    name = 'xspgr_fwd' if tc is None else 'xspgr_fwd_chk'
    nA, nTR = _sizes(name, coef, par, cfg)
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
    lib, _ = library()
    with torch.cuda.device(dev):
        err = _entry(lib, name, dt)(
            *map(_ptr, (coef, par, sig, chk, state)), nA, nTR, cfg.K,
            cfg.kshift, cfg.flags, tc or nTR, threads, _stream(dev))
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return sig, chk


def _launch_bwd(coef, par, cfg, chk, g, tc):
    from mrphy_tpu_torch.kernels._build import library
    nA, nTR = _sizes('xspgr_bwd', coef, par, cfg)
    _check_tc(nTR, tc)
    dt, dev = par.dtype, par.device
    _check(chk, 'chk', (nTR // tc, PLANES, cfg.K, nA), dt, dev)
    _check(g, 'g', (nA, nTR, 2), dt, dev)
    threads, in_smem = launch_cfg(cfg.K, par.element_size(), PLANES)
    # phase 1's pre-RF states of one chunk (the first is chk's own), the
    # adjoint state when it does not fit in shared memory, and each warp's
    # per-TR coefficient rows (summed over its atoms)
    scratch = torch.empty((max(tc - 1, 1), PLANES, cfg.K, nA), dtype=dt,
                          device=dev)
    hstate = None if in_smem else torch.empty((PLANES, cfg.K, nA), dtype=dt,
                                              device=dev)
    dpar = torch.empty((NPAR, nA), dtype=dt, device=dev)
    dcf = torch.empty((-(-nA // 32), nTR, cfg.nC), dtype=dt, device=dev)
    lib, _ = library()
    with torch.cuda.device(dev):
        err = _entry(lib, 'xspgr_bwd', dt)(
            *map(_ptr, (coef, par, chk, g, scratch, hstate, dpar, dcf)), nA,
            nTR, cfg.K, cfg.kshift, cfg.flags, tc, threads, _stream(dev))
    _raise_on(err, 'xspgr_bwd')
    LAUNCHES['xspgr_bwd'] += 1
    # the warps' partial rows, summed in a fixed order
    return dcf.sum(dim=0).T.contiguous(), dpar


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


class _Xspgr(torch.autograd.Function):

    @staticmethod
    def forward(ctx, cfg, coef, par):
        ctx.cfg = cfg
        if not any(ctx.needs_input_grad[1:3]):
            return xspgr_fwd(coef, par, cfg)
        tc = pick_tc(coef.shape[1], cfg.K, par.shape[1], par.element_size(),
                     PLANES)
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


def xspgr(coef, par, cfg: XspgrCfg):
    r"""The EPG-X SPGR train ``sig (nA, nTR, 2)``: the kernels on CUDA
    tensors (``xspgr_fwd``, or ``xspgr_fwd_chk`` and ``xspgr_bwd`` when a
    gradient is needed), their plain versions on CPU tensors.
    Differentiable w.r.t. ``coef`` and ``par``."""
    return _Xspgr.apply(cfg, coef.contiguous(), par.contiguous())
