r"""The two-pool Bloch–McConnell kernels: wrappers, plain PyTorch versions
and launch counts.

Two kernels, each the Hopper counterpart of a TPU kernel of
:mod:`mrphy_tpu.ops.mc_pallas`:

- ``mc_fwd`` (``csrc/mc_fwd.cu``, replaces ``_mc_fwd_kernel``): the fused
  two-pool engine. Per step it builds B-effective from the waveforms and
  the per-voxel fields (as ``rfgr_fwd`` does, without flow), rotates pool
  a about it and pool b about it plus ``ẑ·sb`` (pool b's chemical shift),
  then mixes the pools with the exact 2×2 exchange/relaxation
  propagators: ``[a⊥, b⊥] ← X·[a⊥, b⊥]``, ``[az, bz] ← Z·[az, bz] + c``.
- ``mc_bwd`` (``csrc/mc_bwd.cu``, replaces ``_mc_bwd_kernel``): its
  two-phase chunk adjoint. Per chunk, newest first, phase 1 re-runs the
  forward from the chunk's start state and stores every step's two-pool
  state; phase 2 walks the stored states backwards (mix transpose, both
  pools' rotation adjoints). It never inverts a step: an MT bound pool
  (T2b ~10 µs) makes ``X`` ≈ 0, and inverting it would overflow within
  one chunk, so K2's reverse reconstruction cannot serve here.

Layout: per-voxel planes ``mi6 (N, 6, nS)`` (rows ``[ax, ay, az, bx, by,
bz]``), ``loc_p (N, 3, nS)``, ``dfg``/``sb``/``g2pd (N, nS)``, ``b1_p
(N, 2C, nS)``, the propagator planes ``Xp (N, 4, nS)`` (X00, X01, X10,
X11) and ``Zp (N, 6, nS)`` (Z00, Z01, Z10, Z11, ca, cb); waveforms ``rf2
(N, 2C, nT)`` (rows [x coils…, y coils…]) and ``gr2 (N, 3, nT)``. The
per-voxel fields come pre-scaled by γ2πdt, ``sb`` = 2πdt·dfb (see
:func:`mrphy_tpu_torch.ops.mc.blochsim_mc_rfgr`).

The forward returns ``chk (N, ntc + 1, 6, nS)``: the state at the start
of each chunk of ``tc`` steps (``tc`` = :func:`bloch.pick_tc` (nT)), the
final state last. The adjoint takes ``chk`` and its cotangent ``g`` (the
same shape: a loss on any chunk boundary gets its gradient) and returns
``(dmi6, drf2, dgr2, dloc, ddfg, db1, dsb, dX, dZ)``; ``dX``/``dZ`` are
the cotangents of the propagator planes, through which autograd carries
the tissue and exchange parameters' gradients
(:func:`mrphy_tpu_torch.ops.slowsims.mc_propagators`).

Each kernel has beside it its plain PyTorch version (``*_torch``, a
Python time loop in the kernel's order of operations; the adjoint's uses
no autograd and keeps one chunk of states at a time, as the kernel does)
and a launch count, ``LAUNCHES[name]``, raised by one at every launch of
the kernel and nowhere else.

:func:`mc_fwd` is a ``torch.autograd.Function``: the ``mc_fwd`` kernel and
the ``mc_bwd`` kernel as its backward on CUDA tensors (no fallback), the
plain forward and plain adjoint on CPU tensors or with ``plain=True``.
Either way the backward keeps only ``chk`` and the inputs. ``g2pd`` gets
no gradient (the zero-gradient contract for γ and dt).
"""

import torch
from torch.autograd.function import once_differentiable

from mrphy_tpu_torch.kernels.bloch import (
    THREADS, _check, _check_tc, _device_kind, _ptr, _raise_on, _rfgr_field,
    _rot_adj, _rot_relax, _rows_to_waveforms, _stream, pick_tc)

__all__ = ['LAUNCHES', 'mc_fwd', 'mc_fwd_torch', 'mc_bwd', 'mc_bwd_torch']

LAUNCHES = {'mc_fwd': 0, 'mc_bwd': 0}


def _field(t, loc, rf2, gr2, dfg, b1_p, g2pd):
    return _rfgr_field(t, *loc, rf2, gr2, dfg, b1_p, g2pd, None, None)


def _mc_step(ma, mb, f, sb, X, Z):
    r"""One two-pool step: rotate pool a about ``f``, pool b about ``f +
    ẑ·sb``, then the exchange/relaxation mix. The arithmetic of
    ``csrc/mc_fwd.cu``."""
    fx, fy, fz = f
    a1x, a1y, a1z = _rot_relax(*ma, fx, fy, fz, None, None, None)
    b1x, b1y, b1z = _rot_relax(*mb, fx, fy, fz + sb, None, None, None)
    X00, X01, X10, X11 = X
    Z00, Z01, Z10, Z11, ca, cb = Z
    return ((X00 * a1x + X01 * b1x, X00 * a1y + X01 * b1y,
             Z00 * a1z + Z01 * b1z + ca),
            (X10 * a1x + X11 * b1x, X10 * a1y + X11 * b1y,
             Z10 * a1z + Z11 * b1z + cb))


def mc_fwd_torch(mi6, rf2, gr2, loc_p, dfg, b1_p, sb, Xp, Zp, g2pd, *,
                 tc=None):
    r"""Plain PyTorch version of the ``mc_fwd`` kernel; arguments as the
    module docstring says (``dfg`` and ``b1_p`` may be None). Returns
    ``chk (N, ntc + 1, 6, nS)``. Differentiable by torch autograd (which
    then keeps every step)."""
    nT = gr2.shape[-1]
    tc = pick_tc(nT) if tc is None else tc
    _check_tc(nT, tc)
    m = mi6.unbind(1)
    ma, mb = m[:3], m[3:]
    loc, X, Z = loc_p.unbind(1), Xp.unbind(1), Zp.unbind(1)
    chk = [mi6]
    for t in range(nT):
        _, f = _field(t, loc, rf2, gr2, dfg, b1_p, g2pd)
        ma, mb = _mc_step(ma, mb, f, sb, X, Z)
        if (t + 1) % tc == 0:
            chk.append(torch.stack(ma + mb, dim=1))
    return torch.stack(chk, dim=1)


def mc_bwd_torch(chk, g, rf2, gr2, loc_p, dfg, b1_p, sb, Xp, Zp, g2pd, *,
                 tc=None):
    r"""Plain PyTorch version of the ``mc_bwd`` kernel: the two-phase
    chunk adjoint of :func:`mc_fwd_torch`, with no autograd.

    ``chk``: `(N, ntc + 1, 6, nS)` from ``mc_fwd`` with the same ``tc``;
    ``g``: its cotangent, the same shape. Returns ``(dmi6 (N, 6, nS), drf2
    (N, 2C, nT), dgr2 (N, 3, nT), dloc (N, 3, nS), ddfg (N, nS), db1 (N,
    2C, nS), dsb (N, nS), dX (N, 4, nS), dZ (N, 6, nS))``, None where the
    input is None.
    """
    N, ntc1, _, nS = chk.shape
    nT, nC = gr2.shape[-1], rf2.shape[1] // 2
    tc = pick_tc(nT) if tc is None else tc
    _check_tc(nT, tc)
    if ntc1 != nT // tc + 1:
        raise ValueError(f'chk holds {ntc1} states, but nT={nT} in chunks '
                         f'of tc={tc} gives {nT // tc + 1}')
    loc = loc_p.unbind(1)
    X00, X01, X10, X11 = X = Xp.unbind(1)
    Z = Zp.unbind(1)
    Z00, Z01, Z10, Z11 = Z[:4]
    zero = torch.zeros_like(sb)
    h = g[:, -1].unbind(1)
    dloc, dsb, ddfg = [zero] * 3, zero, zero
    dX, dZ, db1 = [zero] * 4, [zero] * 6, [zero] * (2 * nC)
    dwf = chk.new_empty((N, nT, 3 + (2 * nC if b1_p is not None else 2)))
    for j in reversed(range(ntc1 - 1)):
        # phase 1: the forward from the chunk's start state, every state
        m = chk[:, j].unbind(1)
        ma, mb, states = m[:3], m[3:], []
        for t in range(j * tc, (j + 1) * tc):
            states.append((ma, mb))
            _, f = _field(t, loc, rf2, gr2, dfg, b1_p, g2pd)
            ma, mb = _mc_step(ma, mb, f, sb, X, Z)
        # phase 2: the cotangent, backwards through the stored states
        for t in reversed(range(j * tc, (j + 1) * tc)):
            ma, mb = states.pop()
            (ex, ey, ez), (fx, fy, fz) = _field(t, loc, rf2, gr2, dfg, b1_p,
                                                g2pd)
            hax, hay, haz, hbx, hby, hbz = h
            # the mix transposed: cotangents at the two rotation outputs
            ha1 = (X00 * hax + X10 * hbx, X00 * hay + X10 * hby,
                   Z00 * haz + Z10 * hbz)
            hb1 = (X01 * hax + X11 * hbx, X01 * hay + X11 * hby,
                   Z01 * haz + Z11 * hbz)
            a1, h0a, dba = _rot_adj(ma, ha1, (fx, fy, fz))
            b1, h0b, dbb = _rot_adj(mb, hb1, (fx, fy, fz + sb))
            # the propagator planes' cotangents
            dX = [dX[0] + hax * a1[0] + hay * a1[1],
                  dX[1] + hax * b1[0] + hay * b1[1],
                  dX[2] + hbx * a1[0] + hby * a1[1],
                  dX[3] + hbx * b1[0] + hby * b1[1]]
            dZ = [dZ[0] + haz * a1[2], dZ[1] + haz * b1[2],
                  dZ[2] + hbz * a1[2], dZ[3] + hbz * b1[2],
                  dZ[4] + haz, dZ[5] + hbz]
            dbx, dby, dbz = dba[0] + dbb[0], dba[1] + dbb[1], dba[2] + dbb[2]
            dsb = dsb + dbb[2]
            gx, gy, gz = (gr2[:, k, t, None] for k in range(3))
            dloc = [dloc[0] + dbz * gx, dloc[1] + dbz * gy,
                    dloc[2] + dbz * gz]
            if dfg is not None:
                ddfg = ddfg + dbz
            r = rf2[:, :, t, None]
            if b1_p is not None:
                for c in range(nC):
                    rx, ry = r[:, c], r[:, nC + c]
                    db1[c] = db1[c] + dbx * rx + dby * ry
                    db1[nC + c] = db1[nC + c] + dby * rx - dbx * ry
            # the per-step waveform-gradient rows: sums over voxels
            rows = [dbz * ex, dbz * ey, dbz * ez]
            if b1_p is None:
                rows += [g2pd * dbx, g2pd * dby]
            else:
                rows += [b1_p[:, c] * dbx + b1_p[:, nC + c] * dby
                         for c in range(nC)]
                rows += [b1_p[:, c] * dby - b1_p[:, nC + c] * dbx
                         for c in range(nC)]
            dwf[:, t] = torch.stack(rows, dim=-1).sum(dim=1)
            h = h0a + h0b
        h = tuple(a + b for a, b in zip(h, g[:, j].unbind(1)))
    drf2, dgr2 = _rows_to_waveforms(dwf, nC)
    return (torch.stack(h, dim=1), drf2, dgr2, torch.stack(dloc, dim=1),
            None if dfg is None else ddfg,
            None if b1_p is None else torch.stack(db1, dim=1), dsb,
            torch.stack(dX, dim=1), torch.stack(dZ, dim=1))


def _mc_sizes(name, mi6, rf2, gr2, loc_p, dfg, b1_p, sb, Xp, Zp, g2pd, tc):
    r"""Validate the kernels' per-voxel arguments (``mi6`` stands for any
    `(N, 6, nS)` plane of the compute dtype); returns ``(N, nS, nT,
    nC)``."""
    if mi6.dtype not in (torch.float32, torch.float64):
        raise TypeError(f'{name} takes float32 or float64, not {mi6.dtype}')
    if mi6.ndim != 3 or mi6.shape[1] != 6:
        raise ValueError(f'mi6 must be (N, 6, nS), got {tuple(mi6.shape)}')
    N, _, nS = mi6.shape
    nT, nR = gr2.shape[-1], rf2.shape[1]
    if nR == 0 or nR % 2:
        raise ValueError(f'rf2 must have 2C rows, got {nR}')
    _check_tc(nT, tc)
    dt, dev = mi6.dtype, mi6.device
    for x, xname, shape in ((mi6, 'mi6', (N, 6, nS)),
                            (rf2, 'rf2', (N, nR, nT)),
                            (gr2, 'gr2', (N, 3, nT)),
                            (loc_p, 'loc_p', (N, 3, nS)),
                            (dfg, 'dfg', (N, nS)),
                            (b1_p, 'b1_p', (N, nR, nS)),
                            (sb, 'sb', (N, nS)), (Xp, 'Xp', (N, 4, nS)),
                            (Zp, 'Zp', (N, 6, nS)),
                            (g2pd, 'g2pd', (N, nS))):
        if x is not None:
            _check(x, xname, shape, dt, dev)
    return N, nS, nT, nR // 2


def _entry(lib, kind, dtype):
    return getattr(lib, f'mrphy_mc_{kind}_'
                   f'{"f32" if dtype == torch.float32 else "f64"}')


def _launch_mc_fwd(mi6, rf2, gr2, loc_p, dfg, b1_p, sb, Xp, Zp, g2pd, tc):
    from mrphy_tpu_torch.kernels._build import library
    N, nS, nT, nC = _mc_sizes('mc_fwd', mi6, rf2, gr2, loc_p, dfg, b1_p, sb,
                              Xp, Zp, g2pd, tc)
    chk = torch.empty((N, nT // tc + 1, 6, nS), dtype=mi6.dtype,
                      device=mi6.device)
    lib, _ = library()
    with torch.cuda.device(mi6.device):
        err = _entry(lib, 'fwd', mi6.dtype)(
            *map(_ptr, (mi6, rf2, gr2, loc_p, dfg, b1_p, g2pd, sb, Xp, Zp,
                        chk)), N, nS, nT, nC, tc, _stream(mi6.device))
    _raise_on(err, 'mc_fwd')
    LAUNCHES['mc_fwd'] += 1
    return chk


def _launch_mc_bwd(chk, g, rf2, gr2, loc_p, dfg, b1_p, sb, Xp, Zp, g2pd,
                   tc):
    from mrphy_tpu_torch.kernels._build import library
    dt, dev = loc_p.dtype, loc_p.device
    N, nS, nT, nC = _mc_sizes('mc_bwd', Zp, rf2, gr2, loc_p, dfg, b1_p, sb,
                              Xp, Zp, g2pd, tc)
    for x, xname in ((chk, 'chk'), (g, 'g')):
        _check(x, xname, (N, nT // tc + 1, 6, nS), dt, dev)
    nblk = -(-nS // THREADS)
    Kw = 3 + (2 * nC if b1_p is not None else 2)

    def new(*shape):
        return torch.empty(shape, dtype=dt, device=dev)

    # phase 1's states: one chunk of every voxel, coalesced over voxels
    states = new(N, tc, 6, nS)
    dmi, dloc, dwf = new(N, 6, nS), new(N, 3, nS), new(N, nblk, nT, Kw)
    dsb, dX, dZ = new(N, nS), new(N, 4, nS), new(N, 6, nS)
    ddfg = None if dfg is None else new(N, nS)
    db1 = None if b1_p is None else new(N, 2 * nC, nS)
    lib, _ = library()
    with torch.cuda.device(dev):
        err = _entry(lib, 'bwd', dt)(
            *map(_ptr, (chk, g, rf2, gr2, loc_p, dfg, b1_p, g2pd, sb, Xp, Zp,
                        states, dmi, dwf, dloc, ddfg, db1, dsb, dX, dZ)),
            N, nS, nT, nC, tc, _stream(dev))
    _raise_on(err, 'mc_bwd')
    LAUNCHES['mc_bwd'] += 1
    # the blocks' partial rows, summed in a fixed order
    drf2, dgr2 = _rows_to_waveforms(dwf.sum(dim=1), nC)
    return dmi, drf2, dgr2, dloc, ddfg, db1, dsb, dX, dZ


class _McFwd(torch.autograd.Function):

    @staticmethod
    def forward(ctx, plain, tc, mi6, rf2, gr2, loc_p, dfg, b1_p, sb, Xp, Zp,
                g2pd):
        args = (rf2, gr2, loc_p, dfg, b1_p, sb, Xp, Zp, g2pd)
        if plain:
            chk = mc_fwd_torch(mi6, *args, tc=tc)
        else:
            chk = _launch_mc_fwd(mi6, *args, tc)
        ctx.plain, ctx.tc = plain, tc
        ctx.save_for_backward(chk, *args)
        return chk

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        chk, *args = ctx.saved_tensors
        g = g.contiguous()
        if ctx.plain:
            grads = mc_bwd_torch(chk, g, *args, tc=ctx.tc)
        else:
            grads = _launch_mc_bwd(chk, g, *args, ctx.tc)
        # None for plain, tc and g2pd: no gradient
        return (None, None) + tuple(grads) + (None,)


def mc_fwd(mi6, rf2, gr2, loc_p, dfg, b1_p, sb, Xp, Zp, g2pd, *, tc=None,
           plain=False):
    r"""The ``mc_fwd`` kernel on CUDA tensors (contiguous, one dtype,
    float32 or float64), its plain version on CPU tensors or with
    ``plain=True``. Arguments and result as :func:`mc_fwd_torch`;
    differentiable through the two-phase chunk adjoint (``mc_bwd``, the
    kernel where the forward was the kernel)."""
    tc = pick_tc(gr2.shape[-1]) if tc is None else tc
    plain = plain or _device_kind(mi6) == 'cpu'
    return _McFwd.apply(plain, tc, mi6, rf2, gr2, loc_p, dfg, b1_p, sb, Xp,
                        Zp, g2pd)


def mc_bwd(chk, g, rf2, gr2, loc_p, dfg, b1_p, sb, Xp, Zp, g2pd, *,
           tc=None):
    r"""The ``mc_bwd`` kernel on CUDA tensors, its plain version
    :func:`mc_bwd_torch` on CPU tensors; arguments and results as
    there."""
    tc = pick_tc(gr2.shape[-1]) if tc is None else tc
    if _device_kind(chk) == 'cpu':
        return mc_bwd_torch(chk, g, rf2, gr2, loc_p, dfg, b1_p, sb, Xp, Zp,
                            g2pd, tc=tc)
    return _launch_mc_bwd(chk, g, rf2, gr2, loc_p, dfg, b1_p, sb, Xp, Zp,
                          g2pd, tc)
