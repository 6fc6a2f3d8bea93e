r"""The gridding NUFFT interpolation kernels: wrappers, plain PyTorch
versions, launch counts and the autograd Functions that pair them.

Three kernels, the Hopper counterparts of the TPU kernels of
:mod:`mrphy_tpu.ops.nufft_pallas` (which serve d = 3 there; these serve
d = 1, 2 and 3):

- ``nufft_sample`` (``csrc/nufft_sample.cu``, replaces ``_fwd3d_kernel``
  of ``sample3d``): type-2 interpolation, the oversampled spectrum
  ``(N, ΠG, 2)`` → samples ``(N, nT, 2)``,
  ``s[t] = Σ_taps w(k_t; tap)·B[tap]`` over the W^d Kaiser–Bessel taps.
- ``nufft_spread`` (``csrc/nufft_spread.cu``, replaces ``_adj3d_kernel``
  of ``scatter3d``): its exact transpose, the samples spread onto the
  grid, ``B[tap] += w(k_t; tap)·s[t]``.
- ``nufft_dk`` (``csrc/nufft_dk.cu``, replaces ``_dk3d_kernel`` of
  ``dk3d``): the trajectory cotangent
  ``dk_a[t] = Σ_taps ∂w/∂k_a·(g_r[t]·B_r[tap] + g_i[t]·B_i[tap])``, all d
  axes in one pass. It serves both stages: for the sample stage ``B`` is
  the spectrum and ``g`` the sample cotangent; for the spread stage ``B``
  is the grid cotangent and ``g`` the spread samples.

The taps are JAX's ``_coords``/``_taps`` rule (``mrphy_tpu/ops/
nufft.py``): per axis ``v = (k·fov)·(G/n)`` in grid units, ``base =
floor(v − W/2) + 1``, taps ``base + j`` (j < W) wrapped mod G, weights
``φ(v − tap)`` with ``φ(δ) = I₀(β√(1 − (2δ/W)²))/I₀(β)`` and I₀ the
Abramowitz–Stegun 9.8.1/9.8.2 polynomials (not the library's), its
derivative written out analytically (the tap-edge clamp ``arg > 1e-12``,
where JAX's autodiff would give NaN), and the chain factor ``fov·G/n``.
Separable weights multiply as ``(w_0·w_1)·w_2`` over the flat tap order
(axis 0 outermost). Every division by a constant is a product with its
reciprocal (PyTorch divides a CUDA tensor by a scalar that way), and the
plain versions sum the taps one by one in that order, so with
``-fmad=false`` the sample and dk kernels can round exactly as their plain
versions. The spread's sums take the atomics' order, which changes from
run to run: under ``torch.use_deterministic_algorithms(True)`` its launch
raises (warns under ``warn_only=True``; :func:`refuse_nondeterministic`).

Layout: the grid and the samples are re/im pairs in the last axis (the
real view of a complex tensor, so the FFT stage hands them over without a
copy): ``grid (N, ΠG, 2)``, ``s``/``g (N, nT, 2)``; the trajectory ``k
(Nk, d, nT)`` in "cycle/cm" with ``Nk`` ∈ {1, N} (1: shared by the
batch); ``dk (N, d, nT)`` per batch entry (the caller sums a broadcast
trajectory's). The geometry is a :class:`Geom`.

Each kernel has a launch count, ``LAUNCHES[name]``, raised by one at
every launch and nowhere else. The wrappers take the plain version for
CPU tensors and launch the kernel for CUDA tensors (no fallback);
``chunk=`` bounds the plain versions' `(chunk, W^d)` tap tables and is
ignored by the kernels. :class:`Sample` and :class:`Spread` are the
``torch.autograd.Function``\ s of the two stages: each one's backward is
the other stage (the data cotangent) and ``nufft_dk`` (the trajectory
cotangent), the kernels on CUDA tensors and the plain versions elsewhere
or when asked (``plain=True``).
"""

import ctypes
import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from mrphy_tpu_torch.kernels.bloch import (_check, _device_kind, _ptr,
                                           _raise_on, _stream)

__all__ = ['LAUNCHES', 'Geom', 'taps', 'nufft_sample', 'nufft_sample_torch',
           'nufft_spread', 'nufft_spread_torch', 'nufft_dk',
           'nufft_dk_torch', 'Sample', 'Spread', 'refuse_nondeterministic']

LAUNCHES = {'nufft_sample': 0, 'nufft_spread': 0, 'nufft_dk': 0}

# Threads per block of the CUDA kernels (`kThreads`, csrc/nufft_common.cuh).
THREADS = 256
# Kernel widths the CUDA kernels take (`dispatch_w`, nufft_common.cuh: 4-6
# with instances of their own, the others through one at run time).
WIDTHS = range(2, 9)

# I₀ polynomials, Abramowitz & Stegun 9.8.1 (|x| < 3.75, in t = (x/3.75)²)
# and 9.8.2 (x ≥ 3.75, in u = 3.75/x, times eˣ/√x); the derivatives'
# coefficients j·c_j. The same literals are in csrc/nufft_common.cuh.
_I0S = (1.0, 3.5156229, 3.0899424, 1.2067492, 0.2659732, 0.0360768,
        0.0045813)
_I0L = (0.39894228, 0.01328592, 0.00225319, -0.00157565, 0.00916281,
        -0.02057706, 0.02635537, -0.01647633, 0.00392377)
_I0S_D = tuple(j * c for j, c in enumerate(_I0S) if j)
_I0L_D = tuple(j * c for j, c in enumerate(_I0L) if j)


class Geom(NamedTuple):
    r"""The scalar geometry of a gridding plan: image and oversampled grid
    sizes, FOV ("cm"), kernel width and KB shape."""
    im_size: tuple
    grid_size: tuple
    fov: tuple
    width: int
    beta: float

    @property
    def ndim(self) -> int:
        return len(self.im_size)

    def consts(self) -> tuple:
        r"""The doubles the kernels take (``geo``, csrc/nufft_common.cuh)
        and the plain versions use: per axis G, fov, G/n, fov·G/n (padded
        to 3 axes), then W/2, 2/W, −4/W², β and 1/I₀(β)."""
        pad = (0,) * (3 - self.ndim)
        scl = tuple(G / n for G, n in zip(self.grid_size, self.im_size))
        chain = tuple(f * s for f, s in zip(self.fov, scl))
        W = self.width
        return (tuple(float(g) for g in self.grid_size) + pad
                + self.fov + pad + scl + pad + chain + pad
                + (W / 2.0, 2.0 / W, -4.0 / W ** 2, self.beta,
                   1.0 / float(np.i0(self.beta))))


# ==========================================================================
# Taps and weights (the plain versions' arithmetic)
# ==========================================================================

def _horner(x, cs):
    r"""``c0 + x·(c1 + x·(… + x·cn))``, innermost first."""
    p = x * cs[-1]
    for c in cs[-2:0:-1]:
        p = (p + c) * x
    return p + cs[0]


def _i0(x, deriv: bool):
    r"""I₀(x) and, with ``deriv``, dI₀/dx, for x ≥ 0: the arithmetic of
    ``i0_parts`` in csrc/nufft_common.cuh, each branch on its own
    elements, as the kernels take one branch per tap."""
    small = x < 3.75
    val = torch.empty_like(x)
    dval = torch.empty_like(x) if deriv else None
    q = x[small] * (1 / 3.75)
    t = q * q
    val[small] = _horner(t, _I0S)
    if deriv:
        dval[small] = _horner(t, _I0S_D) * (q * (2 / 3.75))
    large = ~small
    xl = x[large]
    r = xl.reciprocal()
    u = r * 3.75
    E = torch.exp(xl) / torch.sqrt(xl)
    Q = _horner(u, _I0L)
    val[large] = E * Q
    if deriv:
        dval[large] = E * ((1 - r * 0.5) * Q - (u * r) * _horner(u, _I0L_D))
    return val, dval


def _axis(k, a: int, c: tuple, W: int, deriv: bool):
    r"""Axis ``a``'s wrapped tap indices `(…, nT, W)` int64, KB weights and
    (with ``deriv``) their derivatives w.r.t. ``k`` `(…, nT, W)`, for
    ``k`` `(…, nT)` in cycle/cm; ``c`` is :meth:`Geom.consts`."""
    G, fov, scl, chain = int(c[a]), c[3 + a], c[6 + a], c[9 + a]
    half, two_w, dk_c, beta, inv = c[12:17]
    v = k * fov * scl
    base = torch.floor(v - half) + 1.0
    offs = torch.arange(W, dtype=k.dtype, device=k.device)
    delta = v[..., None] - (base[..., None] + offs)
    idx = (base.long()[..., None]
           + torch.arange(W, device=k.device)) % G
    q = delta * two_w
    arg = 1.0 - q * q
    s = torch.sqrt(arg.clamp_min(0.0))
    i0, i0p = _i0(s * beta, deriv)
    w = torch.where(arg > 0, i0, 0.0) * inv
    if not deriv:
        return idx, w, None
    ok = arg > 1e-12
    s = torch.where(ok, s, 1.0)
    d = (i0p * beta) * (delta * dk_c) / s
    return idx, w, torch.where(ok, d, 0.0) * inv * chain


def taps(k, geom: Geom, deriv: bool = False):
    r"""Flat tap indices ``fi`` `(Nk, nT, W^d)` into the `(ΠG,)` grid,
    product weights ``fw`` `(Nk, nT, W^d)` and, with ``deriv``, the d
    weight-derivative tables ``[∂fw/∂k_a]``, for ``k`` `(Nk, d, nT)`. Tap
    order and products: axis 0 outermost, ``(w_0·w_1)·w_2``."""
    d, W, c = geom.ndim, geom.width, geom.consts()
    axes = [_axis(k[:, a], a, c, W, deriv) for a in range(d)]
    G = geom.grid_size

    def outer(xs):                                 # (…, W) per axis
        if d == 1:
            return xs[0]
        if d == 2:
            return xs[0][..., :, None] * xs[1][..., None, :]
        return (xs[0][..., :, None, None] * xs[1][..., None, :, None]
                * xs[2][..., None, None, :])

    ix = [x[0] for x in axes]
    if d == 1:
        fi = ix[0]
    elif d == 2:
        fi = ix[0][..., :, None] * G[1] + ix[1][..., None, :]
    else:
        fi = ((ix[0][..., :, None, None] * G[1]
               + ix[1][..., None, :, None]) * G[2]
              + ix[2][..., None, None, :])
    flat = fi.shape[:2] + (-1,)
    wts = [x[1] for x in axes]
    fw = outer(wts).reshape(flat)
    if not deriv:
        return fi.reshape(flat), fw, None
    dws = [outer(wts[:a] + [axes[a][2]] + wts[a + 1:]).reshape(flat)
           for a in range(d)]
    return fi.reshape(flat), fw, dws


def _chunks(nT: int, chunk):
    c = nT if chunk is None else max(1, min(int(chunk), nT))
    return [(t0, min(t0 + c, nT)) for t0 in range(0, nT, c)]


def _gather(grid, fi):
    r"""``grid (N, nG, 2)`` at the taps ``fi (Nk, c, P)`` → `(N, c, P, 2)`."""
    n = torch.arange(grid.shape[0], device=grid.device)[:, None, None]
    return grid[n, fi]


def _tapsum(x):
    r"""Sum over the tap axis (dim 2) one tap after another, in tap order."""
    acc = x[:, :, 0]
    for j in range(1, x.shape[2]):
        acc = acc + x[:, :, j]
    return acc


def nufft_sample_torch(grid, k, geom: Geom, *, chunk=None):
    r"""Plain PyTorch version of the ``nufft_sample`` kernel: samples
    `(N, nT, 2)` of ``grid (N, ΠG, 2)`` at ``k (Nk, d, nT)``."""
    out = []
    for t0, t1 in _chunks(k.shape[-1], chunk):
        fi, fw, _ = taps(k[..., t0:t1], geom)
        out.append(_tapsum(_gather(grid, fi) * fw[..., None]))
    return torch.cat(out, dim=1)


def nufft_spread_torch(s, k, geom: Geom, *, chunk=None):
    r"""Plain PyTorch version of the ``nufft_spread`` kernel: the grid
    `(N, ΠG, 2)` of samples ``s (N, nT, 2)`` spread from ``k (Nk, d, nT)``
    (``index_add_``)."""
    N, nG = s.shape[0], int(np.prod(geom.grid_size))
    grid = s.new_zeros((N * nG, 2))
    off = torch.arange(N, device=s.device)[:, None, None] * nG
    for t0, t1 in _chunks(k.shape[-1], chunk):
        fi, fw, _ = taps(k[..., t0:t1], geom)
        vals = fw[..., None] * s[:, t0:t1, None, :]        # (N, c, P, 2)
        grid.index_add_(0, (fi + off).reshape(-1), vals.reshape(-1, 2))
    return grid.reshape(N, nG, 2)


def nufft_dk_torch(grid, k, g, geom: Geom, *, chunk=None):
    r"""Plain PyTorch version of the ``nufft_dk`` kernel: ``dk (N, d,
    nT)`` from ``grid (N, ΠG, 2)``, ``k (Nk, d, nT)`` and ``g (N, nT,
    2)``."""
    out = []
    for t0, t1 in _chunks(k.shape[-1], chunk):
        fi, _, dws = taps(k[..., t0:t1], geom, deriv=True)
        B = _gather(grid, fi)                              # (N, c, P, 2)
        gc = g[:, t0:t1, None, :]
        Gv = gc[..., 0] * B[..., 0] + gc[..., 1] * B[..., 1]
        out.append(torch.stack([_tapsum(dw * Gv) for dw in dws], dim=1))
    return torch.cat(out, dim=2)


# ==========================================================================
# The CUDA launches
# ==========================================================================

def _sizes(name, rows, k, geom: Geom):
    r"""Validate ``rows`` (`(N, n, 2)`, the compute dtype and device) and
    ``k``; returns ``(N, nT, d, k's batch stride)``."""
    if rows.dtype not in (torch.float32, torch.float64):
        raise TypeError(f'{name} takes float32 or float64, not {rows.dtype}')
    if rows.ndim != 3 or rows.shape[2] != 2:
        raise ValueError(f'{name}: expected (N, n, 2) re/im rows, got '
                         f'{tuple(rows.shape)}')
    d, N = geom.ndim, rows.shape[0]
    if d not in (1, 2, 3):
        raise ValueError(f'{name}: {d}-dim grids are not supported (1..3)')
    if geom.width not in WIDTHS:
        raise ValueError(f'{name}: kernel width {geom.width} not in '
                         f'{WIDTHS.start}..{WIDTHS.stop - 1}')
    if not 0 < N <= 65535:
        raise ValueError(f'{name}: batch {N} outside 1..65535')
    nk = k.shape[0] if k.ndim == 3 else -1
    if nk not in (1, N):
        raise ValueError(f'{name}: k must be (1 or {N}, {d}, nT), got '
                         f'{tuple(k.shape)}')
    nT = k.shape[-1]
    _check(k, 'k', (nk, d, nT), rows.dtype, rows.device)
    return N, nT, d, 0 if nk == 1 else d * nT


def _entry(kind, dtype):
    from mrphy_tpu_torch.kernels._build import library
    lib, _ = library()
    return getattr(lib, f'mrphy_nufft_{kind}_'
                   f'{"f32" if dtype == torch.float32 else "f64"}')


def _geo(geom: Geom):
    return (ctypes.c_double * 17)(*geom.consts())


def _launch_sample(grid, k, geom: Geom):
    N, nT, d, k_bs = _sizes('nufft_sample', grid, k, geom)
    _check(grid, 'grid', (N, int(np.prod(geom.grid_size)), 2), grid.dtype,
           grid.device)
    out = torch.empty((N, nT, 2), dtype=grid.dtype, device=grid.device)
    with torch.cuda.device(grid.device):
        err = _entry('sample', grid.dtype)(
            *map(_ptr, (grid, k, out)), _geo(geom), k_bs, N, nT, d,
            geom.width, _stream(grid.device))
    _raise_on(err, 'nufft_sample')
    LAUNCHES['nufft_sample'] += 1
    return out


def refuse_nondeterministic(name: str) -> None:
    r"""A kernel that sums with ``atomicAdd`` gives results that change from
    run to run in their last bits. Under
    ``torch.use_deterministic_algorithms(True)`` this raises
    :class:`RuntimeError`, as PyTorch's own such CUDA operations do; under
    ``warn_only=True`` it warns and the kernel runs."""
    if not torch.are_deterministic_algorithms_enabled():
        return
    msg = (f'{name} sums with atomicAdd on CUDA tensors, so its result '
           'changes from run to run in the last bits, and '
           'torch.use_deterministic_algorithms(True) is set')
    if torch.is_deterministic_algorithms_warn_only_enabled():
        warnings.warn(msg, UserWarning, stacklevel=3)
    else:
        raise RuntimeError(msg + "; the plain route (interp='gather', or "
                           'CPU tensors) is deterministic')


def _launch_spread(s, k, geom: Geom):
    refuse_nondeterministic('nufft_spread')
    N, nT, d, k_bs = _sizes('nufft_spread', s, k, geom)
    _check(s, 's', (N, nT, 2), s.dtype, s.device)
    grid = torch.zeros((N, int(np.prod(geom.grid_size)), 2), dtype=s.dtype,
                       device=s.device)
    with torch.cuda.device(s.device):
        err = _entry('spread', s.dtype)(
            *map(_ptr, (s, k, grid)), _geo(geom), k_bs, N, nT, d,
            geom.width, _stream(s.device))
    _raise_on(err, 'nufft_spread')
    LAUNCHES['nufft_spread'] += 1
    return grid


def _launch_dk(grid, k, g, geom: Geom):
    N, nT, d, k_bs = _sizes('nufft_dk', g, k, geom)
    _check(g, 'g', (N, nT, 2), g.dtype, g.device)
    _check(grid, 'grid', (N, int(np.prod(geom.grid_size)), 2), g.dtype,
           g.device)
    dk = torch.empty((N, d, nT), dtype=g.dtype, device=g.device)
    with torch.cuda.device(g.device):
        err = _entry('dk', g.dtype)(
            *map(_ptr, (grid, k, g, dk)), _geo(geom), k_bs, N, nT, d,
            geom.width, _stream(g.device))
    _raise_on(err, 'nufft_dk')
    LAUNCHES['nufft_dk'] += 1
    return dk


def nufft_sample(grid, k, geom: Geom, *, chunk=None):
    r"""The ``nufft_sample`` kernel on CUDA tensors (contiguous, one dtype,
    float32 or float64), :func:`nufft_sample_torch` on CPU tensors."""
    if _device_kind(grid) == 'cpu':
        return nufft_sample_torch(grid, k, geom, chunk=chunk)
    return _launch_sample(grid, k, geom)


def nufft_spread(s, k, geom: Geom, *, chunk=None):
    r"""The ``nufft_spread`` kernel on CUDA tensors,
    :func:`nufft_spread_torch` on CPU tensors."""
    if _device_kind(s) == 'cpu':
        return nufft_spread_torch(s, k, geom, chunk=chunk)
    return _launch_spread(s, k, geom)


def nufft_dk(grid, k, g, geom: Geom, *, chunk=None):
    r"""The ``nufft_dk`` kernel on CUDA tensors, :func:`nufft_dk_torch` on
    CPU tensors."""
    if _device_kind(g) == 'cpu':
        return nufft_dk_torch(grid, k, g, geom, chunk=chunk)
    return _launch_dk(grid, k, g, geom)


# ==========================================================================
# The autograd Functions
# ==========================================================================

def _route(plain: bool):
    if plain:
        return nufft_sample_torch, nufft_spread_torch, nufft_dk_torch
    return nufft_sample, nufft_spread, nufft_dk


def _sum_to(dk, k):
    r"""``dk (N, d, nT)`` summed over the batch where ``k`` broadcasts."""
    return dk.sum(dim=0, keepdim=True) if k.shape[0] == 1 != dk.shape[0] \
        else dk


class Sample(torch.autograd.Function):
    r"""``Sample.apply(plain, geom, chunk, grid, k)``: the sample stage,
    differentiable w.r.t. the spectrum and the trajectory."""

    @staticmethod
    def forward(ctx, plain: bool, geom: Geom, chunk: Optional[int], grid,
                k):
        ctx.plain, ctx.geom, ctx.chunk = plain, geom, chunk
        ctx.save_for_backward(grid, k)
        return _route(plain)[0](grid, k, geom, chunk=chunk)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        grid, k = ctx.saved_tensors
        _, spread, dk = _route(ctx.plain)
        g = g.contiguous()
        dgrid = dkk = None
        if ctx.needs_input_grad[3]:
            dgrid = spread(g, k, ctx.geom, chunk=ctx.chunk)
        if ctx.needs_input_grad[4]:
            dkk = _sum_to(dk(grid, k, g, ctx.geom, chunk=ctx.chunk), k)
        return None, None, None, dgrid, dkk


class Spread(torch.autograd.Function):
    r"""``Spread.apply(plain, geom, chunk, s, k)``: the spread stage,
    differentiable w.r.t. the samples and the trajectory."""

    @staticmethod
    def forward(ctx, plain: bool, geom: Geom, chunk: Optional[int], s, k):
        ctx.plain, ctx.geom, ctx.chunk = plain, geom, chunk
        ctx.save_for_backward(s, k)
        return _route(plain)[1](s, k, geom, chunk=chunk)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        s, k = ctx.saved_tensors
        sample, _, dk = _route(ctx.plain)
        g = g.contiguous()
        ds = dkk = None
        if ctx.needs_input_grad[3]:
            ds = sample(g, k, ctx.geom, chunk=ctx.chunk)
        if ctx.needs_input_grad[4]:
            dkk = _sum_to(dk(g, k, s, ctx.geom, chunk=ctx.chunk), k)
        return None, None, None, ds, dkk
