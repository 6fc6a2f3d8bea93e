r"""The k-space signal kernels: wrappers, plain PyTorch versions and launch
counts.

Three kernels, each the Hopper counterpart of a TPU kernel of
:mod:`mrphy_tpu.ops.signal_pallas`, with the same "planes" outputs:

- ``sig_fwd`` (``csrc/sig_fwd.cu``, replaces ``_sig_fwd_kernel``): the
  forward encoding ``U = w2 · C``, ``V = w2 · S`` summed over spins, with
  the factor matrices ``C = E·cos ψ``, ``S = E·sin ψ``, ``ψ = −2πφ``, the
  phase in cycles ``φ = k_t·x + Δf·t_t``, ``E = exp(−t_t/T2*)`` and
  ``t_t = (t+1)·dt``. The signal is ``s_re = U[:nC] − V[nC:]``, ``s_im =
  V[:nC] + U[nC:]``.
- ``sig_adj`` (``csrc/sig_adj.cu``, replaces ``_sig_adj_kernel``): the
  conjugate-phase back-projection ``XR = Σ_t C·s2``, ``XS = Σ_t S·s2`` per
  spin.
- ``sig_vjp`` (``csrc/sig_vjp.cu``, replaces ``_sig_vjp_kernel``): the
  forward's full VJP in one pass: ``XR``/``XS`` of the cotangent rows
  ``g2``, and the phase-chain cotangents ``dloc = Σ_t dφ·k_t``, ``ddf =
  Σ_t dφ·t_t``, ``di2 = −Σ_t t_t·(C·P + S·Q)`` (w.r.t. 1/T2*) and ``dk =
  Σ_m dφ·x_m``, with ``P = Σ_r w2·g2``, ``Q = Σ_r w2·g2q``, ``g2q = [g_im;
  −g_re]`` and ``dφ = 2π(P·S − Q·C)``.

Layout (the port's own: spins last, so a thread per spin reads
coalesced): ``w2 (N, 2nC, nM)`` coil-weighted spins, rows ``[w_re coils…;
w_im coils…]``; ``pos (Np, 3, nM)`` spin locations, "cm"; ``df``/``it2
(Nd, nM)`` off-resonance, "Hz", and 1/T2*, "1/Sec" (each may be None);
``k (Nk, 3, nT)`` Rx k-space, "cycle/cm"; signal or cotangent rows ``s2``/
``g2 (N, 2nC, nT)``. Every per-spin or per-sample input has a leading
batch of N or 1 (broadcast). Outputs: ``U``/``V (N, 2nC, nT)``,
``XR``/``XS (N, 2nC, nM)``, ``dloc (N, 3, nM)``, ``ddf``/``di2 (N, nM)``,
``dk (N, 3, nT)``, per batch entry (the caller sums broadcast inputs'
gradients).

The phase is never a matrix product: it is formed by broadcast products
in cycles, ``((x·k_x + y·k_y) + z·k_z) + Δf·t_t`` (the kernels' order,
so both round alike), reduced by exact half cycles, ``j = rint(2φ)``,
``r = φ − j/2`` (exact in the working type, ``|r| ≤ 1/4``), and
``sin/cos ψ = (−1)^j sin/cos(−2πr)``. The kernels take ``sincospi`` of
the exact argument ``−2r``; the plain versions ``sin``/``cos`` of
``−2π·r``: they differ by an ulp or two of the factor.

The plain versions (``*_torch``) are the JAX package's XLA route, by
chunks of spins: the ``(chunk, nT)`` factor matrices, then the reduction
over spins or samples as ``torch.matmul``. On CUDA tensors that product
must not run in TF32, which keeps ~10 bits of the mantissa: the reductions
run inside :func:`full_f32_matmul`, which sets
``torch.set_float32_matmul_precision('highest')`` (the call that keeps
PyTorch's legacy and new TF32 flags consistent) and restores the previous
setting on exit. The setting is process-wide, so it is not thread-safe
against another thread changing it at the same time.

Each kernel has a launch count, ``LAUNCHES[name]``, raised by one at
every launch of the kernel and nowhere else. The wrappers
(:func:`sig_fwd`, :func:`sig_adj`, :func:`sig_vjp`) take the plain
version for tensors on the CPU and launch the kernel for CUDA tensors (no
fallback). The kernels ignore ``chunk``.
"""

import contextlib
import math

import torch

from mrphy_tpu_torch.kernels.bloch import (_check, _device_kind, _ptr,
                                           _raise_on, _stream)

__all__ = ['LAUNCHES', 'full_f32_matmul', 'pick_chunk', 'sig_fwd',
           'sig_fwd_torch', 'sig_adj', 'sig_adj_torch', 'sig_vjp',
           'sig_vjp_torch']

LAUNCHES = {'sig_fwd': 0, 'sig_vjp': 0, 'sig_adj': 0}

# Threads per block of the CUDA kernels (`kThreads`, csrc/sig_common.cuh).
THREADS = 256
# Coils per accumulator group of the kernels (`kGroup`): more coils take
# several groups, each recomputing the phase.
GROUP = 8
# Blocks per streaming multiprocessor the kernels aim for when they split
# a sum over spins across blocks (sig_fwd) or let a block walk several spin
# tiles (sig_vjp).
BLOCKS_PER_SM = {'sig_fwd': 4, 'sig_vjp': 2}


@contextlib.contextmanager
def full_f32_matmul():
    r"""Run float32 matrix products in full float32 (no TF32) inside the
    block; restore the previous process-wide setting on exit."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision('highest')
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def pick_chunk(nM: int, nT: int) -> int:
    r"""Spins per chunk of the plain versions: the ``(chunk, nT)`` factor
    matrices near 32 MB of float32, in multiples of 256 (the rule of
    ``mrphy_tpu.ops.signal._pick_chunk``)."""
    target = max(256, (8 << 20) // max(nT, 1) // 4 * 4)
    return min(nM, (target // 256) * 256 or 256)


def _tt(nT: int, dt: float, like: torch.Tensor) -> torch.Tensor:
    r"""Sample times ``(t+1)·dt`` in the working type."""
    return (torch.arange(nT, dtype=like.dtype, device=like.device) + 1) * dt


def _factors(pos, df, it2, k, tt, m0, m1):
    r"""The factor matrices ``C``, ``S`` `(Nb, m1−m0, nT)` of spins
    ``m0:m1``: the phase in cycles by broadcast products, the exact
    half-cycle reduction, then sin/cos and the decay. The arithmetic of
    ``csrc/sig_common.cuh`` ``factors``."""
    x, y, z = (pos[:, i, m0:m1, None] for i in range(3))
    kx, ky, kz = (k[:, i, None, :] for i in range(3))
    phi = x * kx + y * ky + z * kz
    if df is not None:
        phi = phi + df[:, m0:m1, None] * tt
    j = torch.round(phi + phi)                 # nearest half cycle
    r = phi - 0.5 * j                          # exact, |r| ≤ 1/4
    psi = r * (-2 * math.pi)
    sgn = 1 - 2 * torch.remainder(j, 2)        # (−1)^j
    E = sgn if it2 is None else sgn * torch.exp(-(tt * it2[:, m0:m1, None]))
    return E * torch.cos(psi), E * torch.sin(psi)


def _chunks(nM: int, nT: int, chunk):
    c = pick_chunk(nM, nT) if chunk is None else max(1, min(int(chunk), nM))
    return [(m0, min(m0 + c, nM)) for m0 in range(0, nM, c)]


def sig_fwd_torch(w2, pos, df, it2, k, dt, *, chunk=None):
    r"""Plain PyTorch version of the ``sig_fwd`` kernel: ``(U, V)``, each
    `(N, 2nC, nT)` (layout in the module docstring)."""
    nM, nT = w2.shape[-1], k.shape[-1]
    tt = _tt(nT, dt, w2)
    U = V = 0
    with full_f32_matmul():
        for m0, m1 in _chunks(nM, nT, chunk):
            C, S = _factors(pos, df, it2, k, tt, m0, m1)
            wc = w2[:, :, m0:m1]
            U = U + torch.matmul(wc, C)
            V = V + torch.matmul(wc, S)
    return U, V


def sig_adj_torch(s2, pos, df, it2, k, dt, *, chunk=None):
    r"""Plain PyTorch version of the ``sig_adj`` kernel: ``(XR, XS)``,
    each `(N, 2nC, nM)`."""
    nM, nT = pos.shape[-1], k.shape[-1]
    tt = _tt(nT, dt, s2)
    XR, XS = [], []
    with full_f32_matmul():
        for m0, m1 in _chunks(nM, nT, chunk):
            C, S = _factors(pos, df, it2, k, tt, m0, m1)
            XR.append(torch.matmul(s2, C.transpose(1, 2)))
            XS.append(torch.matmul(s2, S.transpose(1, 2)))
    return torch.cat(XR, dim=2), torch.cat(XS, dim=2)


def sig_vjp_torch(g2, w2, pos, df, it2, k, dt, *, chunk=None):
    r"""Plain PyTorch version of the ``sig_vjp`` kernel: ``(XR, XS, dloc,
    dk, ddf, di2)`` — `(N, 2nC, nM)` ×2, `(N, 3, nM)`, `(N, 3, nT)`, and
    `(N, nM)` ×2 (None where ``df`` / ``it2`` is None)."""
    N, nR, nM = w2.shape
    nC, nT = nR // 2, k.shape[-1]
    tt = _tt(nT, dt, w2)
    g2q = torch.cat([g2[:, nC:], -g2[:, :nC]], dim=1)
    XR, XS, dloc, ddf, di2 = [], [], [], [], []
    dk = 0
    with full_f32_matmul():
        for m0, m1 in _chunks(nM, nT, chunk):
            C, S = _factors(pos, df, it2, k, tt, m0, m1)
            XR.append(torch.matmul(g2, C.transpose(1, 2)))
            XS.append(torch.matmul(g2, S.transpose(1, 2)))
            wT = w2[:, :, m0:m1].transpose(1, 2)           # (N, c, 2nC)
            P, Q = torch.matmul(wT, g2), torch.matmul(wT, g2q)
            dphi = (2 * math.pi) * (P * S - Q * C)          # (N, c, nT)
            dloc.append(torch.matmul(k, dphi.transpose(1, 2)))
            dk = dk + torch.matmul(pos[:, :, m0:m1], dphi)
            if df is not None:
                ddf.append(torch.matmul(dphi, tt))
            if it2 is not None:
                di2.append(-torch.matmul(C * P + S * Q, tt))
    cat = (lambda xs, d: torch.cat(xs, dim=d) if xs else None)  # noqa: E731
    return (cat(XR, 2), cat(XS, 2), cat(dloc, 2), dk, cat(ddf, 1),
            cat(di2, 1))


# ==========================================================================
# The CUDA launches
# ==========================================================================

def _sizes(name, rows, pos, df, it2, k, N):
    r"""Validate the per-spin and per-sample inputs against ``rows``
    (`(N, 2nC, n)`, the compute dtype and device); returns ``(nM, nT, nC,
    the number of coil groups, batch strides of pos/df/it2/k)``."""
    if rows.dtype not in (torch.float32, torch.float64):
        raise TypeError(f'{name} takes float32 or float64, not {rows.dtype}')
    if rows.ndim != 3 or rows.shape[1] == 0 or rows.shape[1] % 2:
        raise ValueError(f'{name}: rows must be (N, 2nC, n), got '
                         f'{tuple(rows.shape)}')
    nM, nT, nC = pos.shape[-1], k.shape[-1], rows.shape[1] // 2
    dt, dev = rows.dtype, rows.device
    strides = []
    for x, xname, shape in ((pos, 'pos', (3, nM)), (df, 'df', (nM,)),
                            (it2, 'it2', (nM,)), (k, 'k', (3, nT))):
        if x is None:
            strides.append(0)
            continue
        nb = x.shape[0] if x.ndim == len(shape) + 1 else -1
        if nb not in (1, N):
            raise ValueError(f'{name}: {xname} must have a batch of 1 or '
                             f'{N}, got {tuple(x.shape)}')
        _check(x, xname, (nb,) + shape, dt, dev)
        strides.append(0 if nb == 1 else math.prod(shape))
    ng = -(-nC // GROUP)
    if N * ng > 65535:
        raise ValueError(f'{name}: N·ceil(nC/{GROUP}) = {N}·{ng} exceeds '
                         'the grid limit 65535')
    return nM, nT, nC, ng, strides


def _entry(kind, dtype):
    from mrphy_tpu_torch.kernels._build import library
    lib, _ = library()
    return getattr(lib, f'mrphy_sig_{kind}_'
                   f'{"f32" if dtype == torch.float32 else "f64"}')


def _target_blocks(name, dev) -> int:
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return BLOCKS_PER_SM[name] * sms


def _launch_sig_fwd(w2, pos, df, it2, k, dt):
    N = w2.shape[0]
    nM, nT, nC, ng, bs = _sizes('sig_fwd', w2, pos, df, it2, k, N)
    _check(w2, 'w2', (N, 2 * nC, nM), w2.dtype, w2.device)
    tblocks, tiles = -(-nT // THREADS), -(-nM // THREADS)
    # split the spins over enough blocks to fill the card; each split
    # writes its own partial rows, summed below in a fixed order
    nsplit = max(1, min(tiles, -(-_target_blocks('sig_fwd', w2.device)
                                 // (tblocks * N * ng))))
    part = torch.empty((2, nsplit, N, 2 * nC, nT), dtype=w2.dtype,
                       device=w2.device)
    with torch.cuda.device(w2.device):
        err = _entry('fwd', w2.dtype)(
            *map(_ptr, (w2, pos, df, it2, k, part[0], part[1])),
            *bs, N, nM, nT, nC, nsplit, float(dt), _stream(w2.device))
    _raise_on(err, 'sig_fwd')
    LAUNCHES['sig_fwd'] += 1
    U, V = part.sum(dim=1)
    return U, V


def _launch_sig_adj(s2, pos, df, it2, k, dt):
    N = s2.shape[0]
    nM, nT, nC, _, bs = _sizes('sig_adj', s2, pos, df, it2, k, N)
    _check(s2, 's2', (N, 2 * nC, nT), s2.dtype, s2.device)
    out = torch.empty((2, N, 2 * nC, nM), dtype=s2.dtype, device=s2.device)
    with torch.cuda.device(s2.device):
        err = _entry('adj', s2.dtype)(
            *map(_ptr, (s2, pos, df, it2, k, out[0], out[1])),
            *bs, N, nM, nT, nC, float(dt), _stream(s2.device))
    _raise_on(err, 'sig_adj')
    LAUNCHES['sig_adj'] += 1
    return out[0], out[1]


def _launch_sig_vjp(g2, w2, pos, df, it2, k, dt):
    N = w2.shape[0]
    nM, nT, nC, ng, bs = _sizes('sig_vjp', w2, pos, df, it2, k, N)
    for x, xname, n in ((w2, 'w2', nM), (g2, 'g2', nT)):
        _check(x, xname, (N, 2 * nC, n), w2.dtype, w2.device)
    tiles = -(-nM // THREADS)
    # a block walks several spin tiles, so that the per-block partial rows
    # of dk stay small (at 64³ spins × 16k samples one row per tile would
    # be 201 MB in float32)
    nblk = max(1, min(tiles, -(-_target_blocks('sig_vjp', w2.device)
                               // (N * ng))))

    def new(*shape):
        return torch.empty(shape, dtype=w2.dtype, device=w2.device)

    XR, XS = new(N, 2 * nC, nM), new(N, 2 * nC, nM)
    dloc = new(ng, N, 3, nM)
    ddf = None if df is None else new(ng, N, nM)
    di2 = None if it2 is None else new(ng, N, nM)
    dk = new(N, ng * nblk, 3, nT)
    with torch.cuda.device(w2.device):
        err = _entry('vjp', w2.dtype)(
            *map(_ptr, (g2, w2, pos, df, it2, k, XR, XS, dloc, ddf, di2,
                        dk)),
            *bs, N, nM, nT, nC, nblk, float(dt), _stream(w2.device))
    _raise_on(err, 'sig_vjp')
    LAUNCHES['sig_vjp'] += 1
    # the coil groups' and blocks' partials, summed in a fixed order
    return (XR, XS, dloc.sum(dim=0), dk.sum(dim=1),
            None if ddf is None else ddf.sum(dim=0),
            None if di2 is None else di2.sum(dim=0))


def sig_fwd(w2, pos, df, it2, k, dt, *, chunk=None):
    r"""The ``sig_fwd`` kernel on CUDA tensors (contiguous, one dtype,
    float32 or float64), its plain version :func:`sig_fwd_torch` on CPU
    tensors (``chunk`` applies there only)."""
    if _device_kind(w2) == 'cpu':
        return sig_fwd_torch(w2, pos, df, it2, k, dt, chunk=chunk)
    return _launch_sig_fwd(w2, pos, df, it2, k, dt)


def sig_adj(s2, pos, df, it2, k, dt, *, chunk=None):
    r"""The ``sig_adj`` kernel on CUDA tensors, :func:`sig_adj_torch` on
    CPU tensors."""
    if _device_kind(s2) == 'cpu':
        return sig_adj_torch(s2, pos, df, it2, k, dt, chunk=chunk)
    return _launch_sig_adj(s2, pos, df, it2, k, dt)


def sig_vjp(g2, w2, pos, df, it2, k, dt, *, chunk=None):
    r"""The ``sig_vjp`` kernel on CUDA tensors, :func:`sig_vjp_torch` on
    CPU tensors."""
    if _device_kind(w2) == 'cpu':
        return sig_vjp_torch(g2, w2, pos, df, it2, k, dt, chunk=chunk)
    return _launch_sig_vjp(g2, w2, pos, df, it2, k, dt)
