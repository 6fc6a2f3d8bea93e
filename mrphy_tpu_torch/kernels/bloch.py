r"""The Bloch forward kernels: wrappers, plain PyTorch versions and launch
counts.

Two kernels, each the Hopper counterpart of a TPU kernel of
:mod:`mrphy_tpu.ops.pallas_kernels`:

- ``rfgr_fwd`` (``csrc/rfgr_fwd.cu``, replaces ``_rfgr_fwd_kernel``): the
  fused rf/gr engine. Layout: per-spin planes ``(N, 3, nS)`` /
  ``(N, nS)``, waveforms ``rf2 (N, 2C, nT)`` (rows [x coils…, y coils…])
  and ``gr2 (N, 3, nT)``.
- ``beff_fwd`` (``csrc/beff_fwd.cu``, replaces ``_beff_fwd_kernel``): the
  B-effective streaming engine. Layout: ``(3, B)`` planes with the batch
  folded into spins, ``beff (nT, 3, B)`` in the compute dtype or bf16.

Both return the chunk-end states ``chk`` (final state last), chunks of
``tc`` steps with ``tc`` = :func:`pick_tc` (nT). The per-spin fields come
pre-scaled by γ2πdt (see :func:`mrphy_tpu_torch.ops.sims.blochsim_rfgr`).

Each kernel has beside it:

- its plain PyTorch version (``rfgr_fwd_torch``, ``beff_fwd_torch``): the
  same arguments and result, a Python time loop of tensor ops. The
  wrappers ``rfgr_fwd`` / ``beff_fwd`` take it only for tensors on the
  CPU, where torch autograd differentiates through it. For CUDA tensors
  they launch the kernel or raise; there is no fallback.
- a ``torch.autograd.Function`` whose backward raises
  :class:`NotImplementedError`: the adjoint kernels (K2
  ``_rfgr_bwd_kernel``, K4 ``_beff_bwd_kernel``) are not ported yet, and
  differentiating through the plain loop on the card instead would be a
  silent change of engine.
- a launch count, ``LAUNCHES[name]``, raised by one at every launch of the
  kernel and nowhere else.
"""

import torch

from mrphy_tpu_torch.utils._shapes import largest_divisor_leq

__all__ = ['LAUNCHES', 'TC_MAX', 'pick_tc', 'rfgr_fwd', 'rfgr_fwd_torch',
           'beff_fwd', 'beff_fwd_torch']

LAUNCHES = {'rfgr_fwd': 0, 'beff_fwd': 0}

# Chunk length bound, one rule for both kernels: inverting relaxation in
# the reconstruction adjoint compounds rounding as exp(tc·dt/T2), so the
# forward checkpoints the state at most every TC_MAX steps (the rule of
# mrphy_tpu's XLA engine, `sims._pick_tc_xla`).
TC_MAX = 256

_PHI_EPS = 1e-12


def pick_tc(nT: int) -> int:
    r"""Chunk length: the largest divisor of ``nT`` that is ≤ ``TC_MAX``
    (divisor-poor ``nT`` only gets more checkpoints)."""
    return largest_divisor_leq(nT, TC_MAX)


def _rot_relax(mx, my, mz, bx, by, bz, E2, E1, e1_1):
    r"""One step on xyz components: rotate by the field impulse ``b``
    (radians) about ``u = b/|b|``, then relax if ``E2`` is given. The
    arithmetic of ``csrc/bloch_step.cuh``."""
    n2 = torch.clamp_min(bx * bx + by * by + bz * bz, _PHI_EPS ** 2)
    inv = torch.rsqrt(n2)
    phi = n2 * inv
    ux, uy, uz = bx * inv, by * inv, bz * inv
    s, c1 = torch.sin(phi), torch.cos(phi) - 1
    utm = ux * mx + uy * my + uz * mz
    m1x = mx - s * (uy * mz - uz * my) + c1 * (mx - utm * ux)
    m1y = my - s * (uz * mx - ux * mz) + c1 * (my - utm * uy)
    m1z = mz - s * (ux * my - uy * mx) + c1 * (mz - utm * uz)
    if E2 is not None:
        m1x, m1y, m1z = m1x * E2, m1y * E2, m1z * E1 - e1_1
    return m1x, m1y, m1z


def _check_tc(nT: int, tc: int) -> None:
    if not (0 < tc <= nT and nT % tc == 0):
        raise ValueError(f'chunk length tc={tc} must divide nT={nT}')


def _device_kind(x: torch.Tensor) -> str:
    if x.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'no Bloch kernel for device {x.device}')
    return x.device.type


# ==========================================================================
# rfgr_fwd
# ==========================================================================

def rfgr_fwd_torch(mi, rf2, gr2, loc_p, dfg, b1_p, E, e1_1, g2pd,
                   vel_p=None, tarr2=None, *, tc=None):
    r"""Plain PyTorch version of the ``rfgr_fwd`` kernel.

    ``mi``/``loc_p``/``E``/``vel_p``: `(N, 3, nS)`; ``dfg``/``e1_1``/
    ``g2pd``: `(N, nS)`; ``b1_p``: `(N, 2C, nS)` or None; ``rf2``:
    `(N, 2C, nT)`; ``gr2``: `(N, 3, nT)`; ``tarr2``: `(N, nT)` step times
    (with ``vel_p``). ``dfg``, ``b1_p``, ``E``+``e1_1`` and
    ``vel_p``+``tarr2`` may be None. Returns ``chk`` `(N, ntc, 3, nS)`.
    """
    nT = gr2.shape[-1]
    nC = rf2.shape[1] // 2
    tc = pick_tc(nT) if tc is None else tc
    _check_tc(nT, tc)
    mx, my, mz = mi.unbind(1)
    lx, ly, lz = loc_p.unbind(1)
    E2 = E1 = None
    if E is not None:
        E2, E1 = E[:, 0], E[:, 2]
    chk = []
    for t in range(nT):
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
        mx, my, mz = _rot_relax(mx, my, mz, bx, by, bz, E2, E1, e1_1)
        if (t + 1) % tc == 0:
            chk.append(torch.stack([mx, my, mz], dim=1))
    return torch.stack(chk, dim=1)


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


def _launch_rfgr_fwd(mi, rf2, gr2, loc_p, dfg, b1_p, E, e1_1, g2pd, vel_p,
                     tarr2, tc):
    from mrphy_tpu_torch.kernels._build import library
    if mi.dtype not in (torch.float32, torch.float64):
        raise TypeError(f'rfgr_fwd takes float32 or float64, not {mi.dtype}')
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
    for x, name, shape in ((mi, 'mi', (N, 3, nS)), (rf2, 'rf2', (N, nR, nT)),
                           (gr2, 'gr2', (N, 3, nT)),
                           (loc_p, 'loc_p', (N, 3, nS)),
                           (dfg, 'dfg', (N, nS)), (b1_p, 'b1_p', (N, nR, nS)),
                           (E, 'E', (N, 3, nS)), (e1_1, 'e1_1', (N, nS)),
                           (g2pd, 'g2pd', (N, nS)),
                           (vel_p, 'vel_p', (N, 3, nS)),
                           (tarr2, 'tarr2', (N, nT))):
        if x is not None:
            _check(x, name, shape, dt, dev)
    chk = torch.empty((N, nT // tc, 3, nS), dtype=dt, device=dev)
    lib, _ = library()
    fn = (lib.mrphy_rfgr_fwd_f32 if dt == torch.float32
          else lib.mrphy_rfgr_fwd_f64)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*map(_ptr, (mi, rf2, gr2, loc_p, dfg, b1_p, E, e1_1, g2pd,
                             vel_p, tarr2, chk)),
                 N, nS, nT, nR // 2, tc, stream)
    _raise_on(err, 'rfgr_fwd')
    LAUNCHES['rfgr_fwd'] += 1
    return chk


class _RfgrFwd(torch.autograd.Function):

    @staticmethod
    def forward(ctx, mi, rf2, gr2, loc_p, dfg, b1_p, E, e1_1, g2pd, vel_p,
                tarr2, tc):
        return _launch_rfgr_fwd(mi, rf2, gr2, loc_p, dfg, b1_p, E, e1_1,
                                g2pd, vel_p, tarr2, tc)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            'the CUDA backward of rfgr_fwd is kernel K2 (_rfgr_bwd_kernel '
            'of mrphy_tpu/ops/pallas_kernels.py), which is not ported yet')


def rfgr_fwd(mi, rf2, gr2, loc_p, dfg, b1_p, E, e1_1, g2pd, vel_p=None,
             tarr2=None, *, tc=None):
    r"""The ``rfgr_fwd`` kernel on CUDA tensors (contiguous, one dtype,
    float32 or float64), its plain version :func:`rfgr_fwd_torch` on CPU
    tensors. Arguments and result as :func:`rfgr_fwd_torch`."""
    tc = pick_tc(gr2.shape[-1]) if tc is None else tc
    if _device_kind(mi) == 'cpu':
        return rfgr_fwd_torch(mi, rf2, gr2, loc_p, dfg, b1_p, E, e1_1, g2pd,
                              vel_p, tarr2, tc=tc)
    return _RfgrFwd.apply(mi, rf2, gr2, loc_p, dfg, b1_p, E, e1_1, g2pd,
                          vel_p, tarr2, tc)


# ==========================================================================
# beff_fwd
# ==========================================================================

def beff_fwd_torch(mi, beff, E, e1_1, g2pd, *, tc=None):
    r"""Plain PyTorch version of the ``beff_fwd`` kernel.

    ``mi``/``E``: `(3, B)`; ``beff``: `(nT, 3, B)`, in the compute dtype
    or bfloat16 (widened at use); ``e1_1``/``g2pd``: `(B,)`. ``E`` and
    ``e1_1`` may be None. Returns ``chk`` `(ntc, 3, B)`.
    """
    nT = beff.shape[0]
    tc = pick_tc(nT) if tc is None else tc
    _check_tc(nT, tc)
    mx, my, mz = mi.unbind(0)
    E2 = E1 = None
    if E is not None:
        E2, E1 = E[0], E[2]
    chk = []
    for t in range(nT):
        bx, by, bz = (g2pd * b for b in beff[t].to(g2pd.dtype).unbind(0))
        mx, my, mz = _rot_relax(mx, my, mz, bx, by, bz, E2, E1, e1_1)
        if (t + 1) % tc == 0:
            chk.append(torch.stack([mx, my, mz]))
    return torch.stack(chk)


_BEFF_ENTRIES = {(torch.float32, torch.float32): 'mrphy_beff_fwd_f32',
                 (torch.float32, torch.bfloat16): 'mrphy_beff_fwd_f32_bf16',
                 (torch.float64, torch.float64): 'mrphy_beff_fwd_f64'}


def _launch_beff_fwd(mi, beff, E, e1_1, g2pd, tc):
    from mrphy_tpu_torch.kernels._build import library
    entry = _BEFF_ENTRIES.get((mi.dtype, beff.dtype))
    if entry is None:
        raise TypeError(f'beff_fwd takes (compute, storage) dtypes '
                        f'{sorted(map(str, _BEFF_ENTRIES))}, not '
                        f'({mi.dtype}, {beff.dtype})')
    if mi.ndim != 2 or mi.shape[0] != 3:
        raise ValueError(f'mi must be (3, B), got {tuple(mi.shape)}')
    B, nT = mi.shape[1], beff.shape[0]
    _check_tc(nT, tc)
    _both_or_neither(E, e1_1, 'E and e1_1')
    dt, dev = mi.dtype, mi.device
    _check(beff, 'beff', (nT, 3, B), beff.dtype, dev)
    for x, name, shape in ((mi, 'mi', (3, B)), (E, 'E', (3, B)),
                           (e1_1, 'e1_1', (B,)), (g2pd, 'g2pd', (B,))):
        if x is not None:
            _check(x, name, shape, dt, dev)
    chk = torch.empty((nT // tc, 3, B), dtype=dt, device=dev)
    lib, _ = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, entry)(
            *map(_ptr, (mi, beff, E, e1_1, g2pd, chk)), B, nT, tc, stream)
    _raise_on(err, 'beff_fwd')
    LAUNCHES['beff_fwd'] += 1
    return chk


class _BeffFwd(torch.autograd.Function):

    @staticmethod
    def forward(ctx, mi, beff, E, e1_1, g2pd, tc):
        return _launch_beff_fwd(mi, beff, E, e1_1, g2pd, tc)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            'the CUDA backward of beff_fwd is kernel K4 (_beff_bwd_kernel '
            'of mrphy_tpu/ops/pallas_kernels.py), which is not ported yet')


def beff_fwd(mi, beff, E, e1_1, g2pd, *, tc=None):
    r"""The ``beff_fwd`` kernel on CUDA tensors (contiguous; compute dtype
    float32 with a float32 or bfloat16 ``beff``, or float64 throughout),
    its plain version :func:`beff_fwd_torch` on CPU tensors. Arguments and
    result as :func:`beff_fwd_torch`."""
    tc = pick_tc(beff.shape[0]) if tc is None else tc
    if _device_kind(mi) == 'cpu':
        return beff_fwd_torch(mi, beff, E, e1_1, g2pd, tc=tc)
    return _BeffFwd.apply(mi, beff, E, e1_1, g2pd, tc)
