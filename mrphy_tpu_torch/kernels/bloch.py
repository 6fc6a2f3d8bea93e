r"""The Bloch kernels: wrappers, plain PyTorch versions and launch counts.

Four kernels, each the Hopper counterpart of a TPU kernel of
:mod:`mrphy_tpu.ops.pallas_kernels`:

- ``rfgr_fwd`` (``csrc/rfgr_fwd.cu``, replaces ``_rfgr_fwd_kernel``): the
  fused rf/gr engine. Layout: per-spin planes ``(N, 3, nS)`` /
  ``(N, nS)``, waveforms ``rf2 (N, 2C, nT)`` (rows [x coils…, y coils…])
  and ``gr2 (N, 3, nT)``.
- ``rfgr_bwd`` (``csrc/rfgr_bwd.cu``, replaces ``_rfgr_bwd_kernel``): its
  reconstruction adjoint: ``dmi``, the waveform gradients ``drf2``/``dgr2``
  (sums over spins) and the per-spin ``dloc``/``ddfg``/``db1``/``dvel``.
- ``beff_fwd`` (``csrc/beff_fwd.cu``, replaces ``_beff_fwd_kernel``): the
  B-effective streaming engine. Layout: ``(3, B)`` planes with the batch
  folded into spins, ``beff (nT, 3, B)`` in the compute dtype or bf16.
- ``beff_bwd`` (``csrc/beff_bwd.cu``, replaces ``_beff_bwd_kernel``): its
  reconstruction adjoint: ``dmi`` and ``dbeff`` in Beff's storage dtype.

The forward kernels return the chunk-end states ``chk`` (final state
last), chunks of ``tc`` steps with ``tc`` = :func:`pick_tc` (nT). The
adjoints take ``chk`` and its cotangent ``g`` (the same shape: a loss on
any chunk end gets its gradient), restart the state from ``chk`` at every
chunk, newest first, and carry the cotangent across chunks. The per-spin
fields come pre-scaled by γ2πdt (see
:func:`mrphy_tpu_torch.ops.sims.blochsim_rfgr`).

Each kernel has beside it:

- its plain PyTorch version (``*_torch``): the same arguments and result,
  a Python time loop of tensor ops in the kernel's order of operations.
  The adjoints' plain versions use no autograd and store no history.
- a launch count, ``LAUNCHES[name]``, raised by one at every launch of the
  kernel and nowhere else.

The wrappers :func:`rfgr_fwd` / :func:`beff_fwd` are
``torch.autograd.Function``\ s: forward kernel, and the adjoint kernel as
backward, on CUDA tensors (no fallback); the plain forward and the plain
adjoint on CPU tensors, or anywhere with ``plain=True``. Either way the
backward keeps only ``chk`` and the inputs: O(nS·nT/tc) memory, where
torch autograd through the plain loop keeps O(nS·nT). ``E``, ``e1_1``,
``g2pd`` and ``tarr2`` get no gradient (the zero-gradient contract for γ,
dt, T1 and T2). The wrappers :func:`rfgr_bwd` / :func:`beff_bwd` launch
the adjoint kernels on CUDA tensors and take their plain versions on CPU
tensors.
"""

import torch
from torch.autograd.function import once_differentiable

from mrphy_tpu_torch.utils._shapes import largest_divisor_leq

__all__ = ['LAUNCHES', 'TC_MAX', 'pick_tc', 'rfgr_fwd', 'rfgr_fwd_torch',
           'rfgr_bwd', 'rfgr_bwd_torch', 'beff_fwd', 'beff_fwd_torch',
           'beff_bwd', 'beff_bwd_torch']

LAUNCHES = {'rfgr_fwd': 0, 'rfgr_bwd': 0, 'beff_fwd': 0, 'beff_bwd': 0}

# Chunk length bound, one rule for all kernels: inverting relaxation in
# the reconstruction adjoint compounds rounding as exp(tc·dt/T2), so the
# forward checkpoints the state at most every TC_MAX steps (the rule of
# mrphy_tpu's XLA engine, `sims._pick_tc_xla`).
TC_MAX = 256

# Threads per block of the CUDA kernels (`kThreads`, csrc/bloch_step.cuh):
# rfgr_bwd writes one partial waveform-gradient row per block.
THREADS = 256

_PHI_EPS = 1e-12


def pick_tc(nT: int) -> int:
    r"""Chunk length: the largest divisor of ``nT`` that is ≤ ``TC_MAX``
    (divisor-poor ``nT`` only gets more checkpoints)."""
    return largest_divisor_leq(nT, TC_MAX)


def _rotation(bx, by, bz):
    r"""The rotation by the field impulse ``b`` (radians): ``(u, 1/ϕ, sin ϕ,
    cos ϕ, cos ϕ − 1)``. The arithmetic of ``csrc/bloch_step.cuh``
    ``rotation_of``."""
    n2 = torch.clamp_min(bx * bx + by * by + bz * bz, _PHI_EPS ** 2)
    inv = torch.rsqrt(n2)
    phi = n2 * inv
    s, c = torch.sin(phi), torch.cos(phi)
    return (bx * inv, by * inv, bz * inv), inv, s, c, c - 1


def _rodrigues(r, s, m):
    r"""``m − s·(u×m) + (c−1)·(m − (uᵀm)·u)`` and ``uᵀm`` for the rotation
    ``r``; ``s`` = −sin ϕ rotates back. The arithmetic of
    ``csrc/bloch_step.cuh`` ``rodrigues``."""
    (ux, uy, uz), _, _, _, c1 = r
    mx, my, mz = m
    utm = ux * mx + uy * my + uz * mz
    return ((mx - s * (uy * mz - uz * my) + c1 * (mx - utm * ux),
             my - s * (uz * mx - ux * mz) + c1 * (my - utm * uy),
             mz - s * (ux * my - uy * mx) + c1 * (mz - utm * uz)), utm)


def _rot_relax(mx, my, mz, bx, by, bz, E2, E1, e1_1):
    r"""One step on xyz components: rotate by the field impulse ``b``
    (radians) about ``u = b/|b|``, then relax if ``E2`` is given. The
    arithmetic of ``csrc/bloch_step.cuh`` ``rot_relax``."""
    r = _rotation(bx, by, bz)
    (m1x, m1y, m1z), _ = _rodrigues(r, r[2], (mx, my, mz))
    if E2 is not None:
        m1x, m1y, m1z = m1x * E2, m1y * E2, m1z * E1 - e1_1
    return m1x, m1y, m1z


def _rot_relax_bwd(m, h, b, E2, E1, e1_1, iE2, iE1):
    r"""One reverse step of the reconstruction adjoint on xyz components:
    from the state ``m`` after the step and its cotangent ``h``, return
    the state before the step, its cotangent and ∂L/∂b. The arithmetic of
    ``csrc/bloch_step.cuh`` ``rot_relax_bwd`` (derivation: JAX
    ``sims._fused_bwd_step``)."""
    r = _rotation(*b)
    if E2 is not None:        # undo relaxation: m̃ = (m₁ + e1z)/E, h̃ = E∘h₁
        (mx, my, mz), (hx, hy, hz) = m, h
        m = mx * iE2, my * iE2, (mz + e1_1) * iE1
        h = hx * E2, hy * E2, hz * E1
    m0, utm = _rodrigues(r, -r[2], m)           # uᵀm̃ == uᵀm₀
    h0, db = _adj_tail(r, utm, m0, h)
    return m0, h0, db


def _adj_tail(r, utm, m0, h):
    r"""The adjoint of the rotation ``r`` given its input ``m0``, ``utm`` =
    uᵀm₀ and the cotangent ``h`` at its output: ``(h0, ∂L/∂b)``. The
    arithmetic of ``csrc/bloch_step.cuh`` ``rot_adj_tail``."""
    (ux, uy, uz), inv, s, c, c1 = r
    (m0x, m0y, m0z), (hx, hy, hz) = m0, h
    uth = ux * hx + uy * hy + uz * hz
    uxhx, uxhy, uxhz = uy * hz - uz * hy, uz * hx - ux * hz, ux * hy - uy * hx
    h0x = hx + s * uxhx + c1 * (hx - uth * ux)
    h0y = hy + s * uxhy + c1 * (hy - uth * uy)
    h0z = hz + s * uxhz + c1 * (hz - uth * uz)
    sp, c1p = s * inv, c1 * inv
    mxhx = m0y * hz - m0z * hy
    mxhy = m0z * hx - m0x * hz
    mxhz = m0x * hy - m0y * hx
    tt = ux * mxhx + uy * mxhy + uz * mxhz
    hm = hx * m0x + hy * m0y + hz * m0z
    k = (sp - c) * tt + (2 * c1p + s) * utm * uth - s * hm
    dbx = -sp * mxhx - c1p * (uth * m0x + utm * hx) + k * ux
    dby = -sp * mxhy - c1p * (uth * m0y + utm * hy) + k * uy
    dbz = -sp * mxhz - c1p * (uth * m0z + utm * hz) + k * uz
    return (h0x, h0y, h0z), (dbx, dby, dbz)


def _rot_adj(m0, h, b):
    r"""The adjoint of one rotation (no relaxation) from its input state
    ``m0`` (no inversion): returns the rotated state ``m1``, the cotangent
    ``h0`` at the input and ∂L/∂b, from the cotangent ``h`` at the
    output. The arithmetic of ``csrc/bloch_step.cuh`` ``rot_adj``."""
    r = _rotation(*b)
    m1, utm = _rodrigues(r, r[2], m0)
    h0, db = _adj_tail(r, utm, m0, h)
    return m1, h0, db


def _relax_planes(E, axis):
    r"""``(E2, E1, iE2, iE1)`` from the stacked ``[E2, E2, E1]`` planes,
    all None without relaxation; the inverses are hoisted as the kernels
    hoist them."""
    if E is None:
        return None, None, None, None
    E2, E1 = E.select(axis, 0), E.select(axis, 2)
    return E2, E1, torch.reciprocal(E2), torch.reciprocal(E1)


def _check_tc(nT: int, tc: int) -> None:
    if not (0 < tc <= nT and nT % tc == 0):
        raise ValueError(f'chunk length tc={tc} must divide nT={nT}')


def _check_chk(nT: int, tc: int, ntc: int) -> None:
    _check_tc(nT, tc)
    if ntc != nT // tc:
        raise ValueError(f'chk holds {ntc} chunk ends, but nT={nT} in '
                         f'chunks of tc={tc} gives {nT // tc}')


def _device_kind(x: torch.Tensor) -> str:
    if x.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'no Bloch kernel for device {x.device}')
    return x.device.type


# ==========================================================================
# rfgr_fwd / rfgr_bwd
# ==========================================================================

def _rfgr_field(t, lx, ly, lz, rf2, gr2, dfg, b1_p, g2pd, vel_p, tarr2):
    r"""Step ``t``'s field ``(bx, by, bz)`` of the fused engine and the
    moved locations ``(ex, ey, ez)`` it used; the arithmetic of the
    kernels' field assembly."""
    nC = rf2.shape[1] // 2
    ex, ey, ez = lx, ly, lz
    if vel_p is not None:                     # loc + vel·t
        tv = tarr2[:, t, None]
        ex, ey, ez = (lx + tv * vel_p[:, 0], ly + tv * vel_p[:, 1],
                      lz + tv * vel_p[:, 2])
    g = gr2[:, :, t, None]                    # (N, 3, 1)
    bz = g[:, 0] * ex + g[:, 1] * ey + g[:, 2] * ez
    if dfg is not None:
        bz = bz + dfg
    r = rf2[:, :, t, None]                    # (N, 2C, 1)
    if b1_p is None:
        rx, ry = r[:, 0], r[:, nC]
        for c in range(1, nC):
            rx, ry = rx + r[:, c], ry + r[:, nC + c]
        bx, by = g2pd * rx, g2pd * ry
    else:
        bx = by = 0
        for c in range(nC):
            b1x, b1y = b1_p[:, c], b1_p[:, nC + c]
            rx, ry = r[:, c], r[:, nC + c]
            bx = bx + (b1x * rx - b1y * ry)
            by = by + (b1x * ry + b1y * rx)
    return (ex, ey, ez), (bx, by, bz)


def rfgr_fwd_torch(mi, rf2, gr2, loc_p, dfg, b1_p, E, e1_1, g2pd,
                   vel_p=None, tarr2=None, *, tc=None):
    r"""Plain PyTorch version of the ``rfgr_fwd`` kernel.

    ``mi``/``loc_p``/``E``/``vel_p``: `(N, 3, nS)`; ``dfg``/``e1_1``/
    ``g2pd``: `(N, nS)`; ``b1_p``: `(N, 2C, nS)` or None; ``rf2``:
    `(N, 2C, nT)`; ``gr2``: `(N, 3, nT)`; ``tarr2``: `(N, nT)` step times
    (with ``vel_p``). ``dfg``, ``b1_p``, ``E``+``e1_1`` and
    ``vel_p``+``tarr2`` may be None. Returns ``chk`` `(N, ntc, 3, nS)`.
    Differentiable by torch autograd (which then keeps every step).
    """
    nT = gr2.shape[-1]
    tc = pick_tc(nT) if tc is None else tc
    _check_tc(nT, tc)
    mx, my, mz = mi.unbind(1)
    lx, ly, lz = loc_p.unbind(1)
    E2, E1, _, _ = _relax_planes(E, 1)
    chk = []
    for t in range(nT):
        _, (bx, by, bz) = _rfgr_field(t, lx, ly, lz, rf2, gr2, dfg, b1_p,
                                      g2pd, vel_p, tarr2)
        mx, my, mz = _rot_relax(mx, my, mz, bx, by, bz, E2, E1, e1_1)
        if (t + 1) % tc == 0:
            chk.append(torch.stack([mx, my, mz], dim=1))
    return torch.stack(chk, dim=1)


def _rows_to_waveforms(dwf, nC: int):
    r"""Per-step gradient rows ``(N, nT, Kw)`` → ``(drf2 (N, 2C, nT),
    dgr2 (N, 3, nT))``. Without B1 (Kw = 5) the two rf rows hold for every
    coil."""
    N, nT, Kw = dwf.shape
    dgr2 = dwf[..., :3].transpose(1, 2).contiguous()
    rows = dwf[..., 3:]
    if Kw == 5 and nC != 1:
        rows = torch.cat([rows[..., :1].expand(N, nT, nC),
                          rows[..., 1:].expand(N, nT, nC)], dim=-1)
    return rows.transpose(1, 2).contiguous(), dgr2


def rfgr_bwd_torch(chk, g, rf2, gr2, loc_p, dfg, b1_p, E, e1_1, g2pd,
                   vel_p=None, tarr2=None, *, tc=None):
    r"""Plain PyTorch version of the ``rfgr_bwd`` kernel: the
    reconstruction adjoint of :func:`rfgr_fwd_torch`, with no autograd.

    ``chk``: `(N, ntc, 3, nS)` from ``rfgr_fwd`` with the same ``tc``;
    ``g``: its cotangent, the same shape; the rest as
    :func:`rfgr_fwd_torch`. Returns ``(dmi, drf2, dgr2, dloc, ddfg, db1,
    dvel)``: `(N, 3, nS)`, `(N, 2C, nT)`, `(N, 3, nT)`, `(N, 3, nS)`,
    `(N, nS)`, `(N, 2C, nS)`, `(N, 3, nS)` (None where the input is None).
    """
    N, ntc, _, nS = chk.shape
    nT, nC = gr2.shape[-1], rf2.shape[1] // 2
    tc = pick_tc(nT) if tc is None else tc
    _check_chk(nT, tc, ntc)
    lx, ly, lz = loc_p.unbind(1)
    E2, E1, iE2, iE1 = _relax_planes(E, 1)
    zero = torch.zeros_like(lx)
    h = (zero, zero, zero)
    dloc = [zero] * 3
    ddfg, dvel = zero, [zero] * 3
    db1 = [zero] * (2 * nC)
    dwf = chk.new_empty((N, nT, 3 + (2 * nC if b1_p is not None else 2)))
    for j in reversed(range(ntc)):
        m = chk[:, j].unbind(1)               # restart from the chunk end
        h = tuple(a + b for a, b in zip(h, g[:, j].unbind(1)))
        for t in reversed(range(j * tc, (j + 1) * tc)):
            (ex, ey, ez), b = _rfgr_field(t, lx, ly, lz, rf2, gr2, dfg,
                                          b1_p, g2pd, vel_p, tarr2)
            m, h, (dbx, dby, dbz) = _rot_relax_bwd(m, h, b, E2, E1, e1_1,
                                                   iE2, iE1)
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
            if vel_p is not None:
                tv = tarr2[:, t, None]
                dvel = [dvel[0] + dbz * (gx * tv), dvel[1] + dbz * (gy * tv),
                        dvel[2] + dbz * (gz * tv)]
            # the per-step waveform-gradient rows: sums over spins
            rows = [dbz * ex, dbz * ey, dbz * ez]
            if b1_p is None:
                rows += [g2pd * dbx, g2pd * dby]
            else:
                rows += [b1_p[:, c] * dbx + b1_p[:, nC + c] * dby
                         for c in range(nC)]
                rows += [b1_p[:, c] * dby - b1_p[:, nC + c] * dbx
                         for c in range(nC)]
            dwf[:, t] = torch.stack(rows, dim=-1).sum(dim=1)
    drf2, dgr2 = _rows_to_waveforms(dwf, nC)
    return (torch.stack(h, dim=1), drf2, dgr2, torch.stack(dloc, dim=1),
            None if dfg is None else ddfg,
            None if b1_p is None else torch.stack(db1, dim=1),
            None if vel_p is None else torch.stack(dvel, dim=1))


def _check(x, name, shape, dtype, device):
    if x.device != device:
        raise ValueError(f'{name} is on {x.device}, expected {device}')
    if x.dtype != dtype:
        raise TypeError(f'{name} is {x.dtype}, expected {dtype}')
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f'{name} has shape {tuple(x.shape)}, expected '
                         f'{tuple(shape)}')
    if not x.is_contiguous():
        raise ValueError(f'{name} must be contiguous')


def _ptr(x):
    return None if x is None else x.data_ptr()


def _both_or_neither(a, b, names):
    if (a is None) != (b is None):
        raise ValueError(f'pass both {names} or neither')


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f'{name} kernel launch failed: cudaError_t {err}')


def _rfgr_sizes(name, mi, rf2, gr2, loc_p, dfg, b1_p, E, e1_1, g2pd,
                vel_p, tarr2, tc):
    r"""Validate the fused engine's kernel arguments (``mi`` stands for
    any `(N, 3, nS)` plane of the compute dtype); returns ``(N, nS, nT,
    nC)``."""
    if mi.dtype not in (torch.float32, torch.float64):
        raise TypeError(f'{name} takes float32 or float64, not {mi.dtype}')
    if mi.ndim != 3 or mi.shape[1] != 3:
        raise ValueError(f'mi must be (N, 3, nS), got {tuple(mi.shape)}')
    N, _, nS = mi.shape
    nT, nR = gr2.shape[-1], rf2.shape[1]
    if nR == 0 or nR % 2:
        raise ValueError(f'rf2 must have 2C rows, got {nR}')
    _check_tc(nT, tc)
    _both_or_neither(E, e1_1, 'E and e1_1')
    _both_or_neither(vel_p, tarr2, 'vel_p and tarr2')
    dt, dev = mi.dtype, mi.device
    for x, xname, shape in ((mi, 'mi', (N, 3, nS)),
                            (rf2, 'rf2', (N, nR, nT)),
                            (gr2, 'gr2', (N, 3, nT)),
                            (loc_p, 'loc_p', (N, 3, nS)),
                            (dfg, 'dfg', (N, nS)),
                            (b1_p, 'b1_p', (N, nR, nS)),
                            (E, 'E', (N, 3, nS)), (e1_1, 'e1_1', (N, nS)),
                            (g2pd, 'g2pd', (N, nS)),
                            (vel_p, 'vel_p', (N, 3, nS)),
                            (tarr2, 'tarr2', (N, nT))):
        if x is not None:
            _check(x, xname, shape, dt, dev)
    return N, nS, nT, nR // 2


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _launch_rfgr_fwd(mi, rf2, gr2, loc_p, dfg, b1_p, E, e1_1, g2pd, vel_p,
                     tarr2, tc):
    from mrphy_tpu_torch.kernels._build import library
    N, nS, nT, nC = _rfgr_sizes('rfgr_fwd', mi, rf2, gr2, loc_p, dfg, b1_p,
                                E, e1_1, g2pd, vel_p, tarr2, tc)
    chk = torch.empty((N, nT // tc, 3, nS), dtype=mi.dtype, device=mi.device)
    lib, _ = library()
    fn = (lib.mrphy_rfgr_fwd_f32 if mi.dtype == torch.float32
          else lib.mrphy_rfgr_fwd_f64)
    with torch.cuda.device(mi.device):
        err = fn(*map(_ptr, (mi, rf2, gr2, loc_p, dfg, b1_p, E, e1_1, g2pd,
                             vel_p, tarr2, chk)),
                 N, nS, nT, nC, tc, _stream(mi.device))
    _raise_on(err, 'rfgr_fwd')
    LAUNCHES['rfgr_fwd'] += 1
    return chk


def _launch_rfgr_bwd(chk, g, rf2, gr2, loc_p, dfg, b1_p, E, e1_1, g2pd,
                     vel_p, tarr2, tc):
    from mrphy_tpu_torch.kernels._build import library
    N, nS, nT, nC = _rfgr_sizes('rfgr_bwd', loc_p, rf2, gr2, loc_p, dfg,
                                b1_p, E, e1_1, g2pd, vel_p, tarr2, tc)
    dt, dev = loc_p.dtype, loc_p.device
    for x, xname in ((chk, 'chk'), (g, 'g')):
        _check(x, xname, (N, nT // tc, 3, nS), dt, dev)
    nblk = -(-nS // THREADS)
    Kw = 3 + (2 * nC if b1_p is not None else 2)

    def new(*shape):
        return torch.empty(shape, dtype=dt, device=dev)

    dmi, dloc, dwf = new(N, 3, nS), new(N, 3, nS), new(N, nblk, nT, Kw)
    ddfg = None if dfg is None else new(N, nS)
    db1 = None if b1_p is None else new(N, 2 * nC, nS)
    dvel = None if vel_p is None else new(N, 3, nS)
    lib, _ = library()
    fn = (lib.mrphy_rfgr_bwd_f32 if dt == torch.float32
          else lib.mrphy_rfgr_bwd_f64)
    with torch.cuda.device(dev):
        err = fn(*map(_ptr, (chk, g, rf2, gr2, loc_p, dfg, b1_p, E, e1_1,
                             g2pd, vel_p, tarr2, dmi, dwf, dloc, ddfg, db1,
                             dvel)),
                 N, nS, nT, nC, tc, _stream(dev))
    _raise_on(err, 'rfgr_bwd')
    LAUNCHES['rfgr_bwd'] += 1
    # the blocks' partial rows, summed in a fixed order
    drf2, dgr2 = _rows_to_waveforms(dwf.sum(dim=1), nC)
    return dmi, drf2, dgr2, dloc, ddfg, db1, dvel


class _RfgrFwd(torch.autograd.Function):

    @staticmethod
    def forward(ctx, plain, tc, mi, rf2, gr2, loc_p, dfg, b1_p, E, e1_1,
                g2pd, vel_p, tarr2):
        args = (rf2, gr2, loc_p, dfg, b1_p, E, e1_1, g2pd, vel_p, tarr2)
        if plain:
            chk = rfgr_fwd_torch(mi, *args, tc=tc)
        else:
            chk = _launch_rfgr_fwd(mi, *args, tc)
        ctx.plain, ctx.tc = plain, tc
        ctx.save_for_backward(chk, *args)
        return chk

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        chk, *args = ctx.saved_tensors
        g = g.contiguous()
        if ctx.plain:
            grads = rfgr_bwd_torch(chk, g, *args, tc=ctx.tc)
        else:
            grads = _launch_rfgr_bwd(chk, g, *args, ctx.tc)
        dmi, drf2, dgr2, dloc, ddfg, db1, dvel = grads
        # None for plain, tc, E, e1_1, g2pd and tarr2: no gradient
        return (None, None, dmi, drf2, dgr2, dloc, ddfg, db1, None, None,
                None, dvel, None)


def rfgr_fwd(mi, rf2, gr2, loc_p, dfg, b1_p, E, e1_1, g2pd, vel_p=None,
             tarr2=None, *, tc=None, plain=False):
    r"""The ``rfgr_fwd`` kernel on CUDA tensors (contiguous, one dtype,
    float32 or float64), its plain version on CPU tensors or with
    ``plain=True``. Arguments and result as :func:`rfgr_fwd_torch`;
    differentiable through the reconstruction adjoint (``rfgr_bwd``, the
    kernel where the forward was the kernel)."""
    tc = pick_tc(gr2.shape[-1]) if tc is None else tc
    plain = plain or _device_kind(mi) == 'cpu'
    return _RfgrFwd.apply(plain, tc, mi, rf2, gr2, loc_p, dfg, b1_p, E,
                          e1_1, g2pd, vel_p, tarr2)


def rfgr_bwd(chk, g, rf2, gr2, loc_p, dfg, b1_p, E, e1_1, g2pd, vel_p=None,
             tarr2=None, *, tc=None):
    r"""The ``rfgr_bwd`` kernel on CUDA tensors, its plain version
    :func:`rfgr_bwd_torch` on CPU tensors; arguments and results as
    there."""
    tc = pick_tc(gr2.shape[-1]) if tc is None else tc
    if _device_kind(chk) == 'cpu':
        return rfgr_bwd_torch(chk, g, rf2, gr2, loc_p, dfg, b1_p, E, e1_1,
                              g2pd, vel_p, tarr2, tc=tc)
    return _launch_rfgr_bwd(chk, g, rf2, gr2, loc_p, dfg, b1_p, E, e1_1,
                            g2pd, vel_p, tarr2, tc)


# ==========================================================================
# beff_fwd / beff_bwd
# ==========================================================================

def _beff_field(beff_t, g2pd):
    return tuple(g2pd * b for b in beff_t.to(g2pd.dtype).unbind(0))


def beff_fwd_torch(mi, beff, E, e1_1, g2pd, *, tc=None):
    r"""Plain PyTorch version of the ``beff_fwd`` kernel.

    ``mi``/``E``: `(3, B)`; ``beff``: `(nT, 3, B)`, in the compute dtype
    or bfloat16 (widened at use); ``e1_1``/``g2pd``: `(B,)`. ``E`` and
    ``e1_1`` may be None. Returns ``chk`` `(ntc, 3, B)`. Differentiable
    by torch autograd (which then keeps every step).
    """
    nT = beff.shape[0]
    tc = pick_tc(nT) if tc is None else tc
    _check_tc(nT, tc)
    mx, my, mz = mi.unbind(0)
    E2, E1, _, _ = _relax_planes(E, 0)
    chk = []
    for t in range(nT):
        bx, by, bz = _beff_field(beff[t], g2pd)
        mx, my, mz = _rot_relax(mx, my, mz, bx, by, bz, E2, E1, e1_1)
        if (t + 1) % tc == 0:
            chk.append(torch.stack([mx, my, mz]))
    return torch.stack(chk)


def beff_bwd_torch(chk, g, beff, E, e1_1, g2pd, *, tc=None):
    r"""Plain PyTorch version of the ``beff_bwd`` kernel: the
    reconstruction adjoint of :func:`beff_fwd_torch`, with no autograd.

    ``chk``: `(ntc, 3, B)` from ``beff_fwd`` with the same ``tc``; ``g``:
    its cotangent, the same shape; the rest as :func:`beff_fwd_torch`.
    Returns ``(dmi (3, B), dbeff (nT, 3, B))``, ``dbeff`` in ``beff``'s
    dtype.
    """
    ntc, nT = chk.shape[0], beff.shape[0]
    tc = pick_tc(nT) if tc is None else tc
    _check_chk(nT, tc, ntc)
    E2, E1, iE2, iE1 = _relax_planes(E, 0)
    zero = torch.zeros_like(g2pd)
    h = (zero, zero, zero)
    dbeff = torch.empty_like(beff)
    for j in reversed(range(ntc)):
        m = chk[j].unbind(0)                  # restart from the chunk end
        h = tuple(a + b for a, b in zip(h, g[j].unbind(0)))
        for t in reversed(range(j * tc, (j + 1) * tc)):
            m, h, db = _rot_relax_bwd(m, h, _beff_field(beff[t], g2pd), E2,
                                      E1, e1_1, iE2, iE1)
            dbeff[t] = torch.stack([g2pd * d for d in db])
    return torch.stack(h), dbeff


_BEFF_TYPES = ((torch.float32, torch.float32, 'f32'),
               (torch.float32, torch.bfloat16, 'f32_bf16'),
               (torch.float64, torch.float64, 'f64'))


def _beff_entry(kind, g2pd, beff):
    r"""The C entry point of ``mrphy_beff_<kind>`` for the (compute,
    storage) dtypes of ``g2pd`` and ``beff``."""
    for dt, st, suffix in _BEFF_TYPES:
        if (g2pd.dtype, beff.dtype) == (dt, st):
            return f'mrphy_beff_{kind}_{suffix}'
    raise TypeError(f'beff_{kind} takes (compute, storage) dtypes '
                    f'{[(str(a), str(b)) for a, b, _ in _BEFF_TYPES]}, not '
                    f'({g2pd.dtype}, {beff.dtype})')


def _beff_sizes(beff, E, e1_1, g2pd, tc):
    r"""Validate the streaming engine's per-spin arguments against
    ``g2pd`` `(B,)`, of the compute dtype; returns ``(B, nT)``."""
    if g2pd.ndim != 1:
        raise ValueError(f'g2pd must be (B,), got {tuple(g2pd.shape)}')
    B, nT = g2pd.shape[0], beff.shape[0]
    _check_tc(nT, tc)
    _both_or_neither(E, e1_1, 'E and e1_1')
    dt, dev = g2pd.dtype, g2pd.device
    _check(beff, 'beff', (nT, 3, B), beff.dtype, dev)
    for x, name, shape in ((E, 'E', (3, B)), (e1_1, 'e1_1', (B,)),
                           (g2pd, 'g2pd', (B,))):
        if x is not None:
            _check(x, name, shape, dt, dev)
    return B, nT


def _launch_beff_fwd(mi, beff, E, e1_1, g2pd, tc):
    from mrphy_tpu_torch.kernels._build import library
    if mi.ndim != 2 or mi.shape[0] != 3:
        raise ValueError(f'mi must be (3, B), got {tuple(mi.shape)}')
    entry = _beff_entry('fwd', mi, beff)
    B, nT = _beff_sizes(beff, E, e1_1, g2pd, tc)
    _check(mi, 'mi', (3, B), mi.dtype, g2pd.device)
    chk = torch.empty((nT // tc, 3, B), dtype=mi.dtype, device=mi.device)
    lib, _ = library()
    with torch.cuda.device(mi.device):
        err = getattr(lib, entry)(
            *map(_ptr, (mi, beff, E, e1_1, g2pd, chk)), B, nT, tc,
            _stream(mi.device))
    _raise_on(err, 'beff_fwd')
    LAUNCHES['beff_fwd'] += 1
    return chk


def _launch_beff_bwd(chk, g, beff, E, e1_1, g2pd, tc):
    from mrphy_tpu_torch.kernels._build import library
    entry = _beff_entry('bwd', g2pd, beff)
    B, nT = _beff_sizes(beff, E, e1_1, g2pd, tc)
    dt, dev = g2pd.dtype, g2pd.device
    for x, name in ((chk, 'chk'), (g, 'g')):
        _check(x, name, (nT // tc, 3, B), dt, dev)
    dmi = torch.empty((3, B), dtype=dt, device=dev)
    dbeff = torch.empty_like(beff)
    lib, _ = library()
    with torch.cuda.device(dev):
        err = getattr(lib, entry)(
            *map(_ptr, (chk, g, beff, E, e1_1, g2pd, dmi, dbeff)), B, nT,
            tc, _stream(dev))
    _raise_on(err, 'beff_bwd')
    LAUNCHES['beff_bwd'] += 1
    return dmi, dbeff


class _BeffFwd(torch.autograd.Function):

    @staticmethod
    def forward(ctx, plain, tc, mi, beff, E, e1_1, g2pd):
        if plain:
            chk = beff_fwd_torch(mi, beff, E, e1_1, g2pd, tc=tc)
        else:
            chk = _launch_beff_fwd(mi, beff, E, e1_1, g2pd, tc)
        ctx.plain, ctx.tc = plain, tc
        ctx.save_for_backward(chk, beff, E, e1_1, g2pd)
        return chk

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        chk, *args = ctx.saved_tensors
        g = g.contiguous()
        if ctx.plain:
            dmi, dbeff = beff_bwd_torch(chk, g, *args, tc=ctx.tc)
        else:
            dmi, dbeff = _launch_beff_bwd(chk, g, *args, ctx.tc)
        # None for plain, tc, E, e1_1 and g2pd: no gradient
        return None, None, dmi, dbeff, None, None, None


def beff_fwd(mi, beff, E, e1_1, g2pd, *, tc=None, plain=False):
    r"""The ``beff_fwd`` kernel on CUDA tensors (contiguous; compute dtype
    float32 with a float32 or bfloat16 ``beff``, or float64 throughout),
    its plain version on CPU tensors or with ``plain=True``. Arguments and
    result as :func:`beff_fwd_torch`; differentiable through the
    reconstruction adjoint (``beff_bwd``, the kernel where the forward was
    the kernel), ``beff``'s gradient in its own dtype."""
    tc = pick_tc(beff.shape[0]) if tc is None else tc
    plain = plain or _device_kind(mi) == 'cpu'
    return _BeffFwd.apply(plain, tc, mi, beff, E, e1_1, g2pd)


def beff_bwd(chk, g, beff, E, e1_1, g2pd, *, tc=None):
    r"""The ``beff_bwd`` kernel on CUDA tensors, its plain version
    :func:`beff_bwd_torch` on CPU tensors; arguments and results as
    there."""
    tc = pick_tc(beff.shape[0]) if tc is None else tc
    if _device_kind(chk) == 'cpu':
        return beff_bwd_torch(chk, g, beff, E, e1_1, g2pd, tc=tc)
    return _launch_beff_bwd(chk, g, beff, E, e1_1, g2pd, tc)
