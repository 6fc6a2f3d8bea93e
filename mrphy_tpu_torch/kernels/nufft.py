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
  grid, ``B[tap] += w(k_t; tap)·s[t]``, as a deterministic binned spread:
  :func:`bin_plan` bins the samples by the grid tile of their first tap
  (``nufft_bin_keys``, a stable ``torch.sort``, ``nufft_bin_offsets``)
  and cuts each bin into subproblems of at most :func:`spread_p` samples; a warp spreads a
  subproblem into its padded tile in shared memory, sample after sample
  and without atomics, and a second pass sums each grid point's partials
  in a fixed order. The plan is made inside every launch.
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
versions. The spread's weights and products round as its plain version's;
its sums run by bin, then subproblem, then sample, an order the trajectory
alone fixes, so its grid is the same from launch to launch (also under
``torch.use_deterministic_algorithms(True)``) and meets ``index_add_``'s
to rounding.

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
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from mrphy_tpu_torch.kernels.bloch import (_check, _device_kind, _ptr,
                                           _raise_on, _stream)

__all__ = ['LAUNCHES', 'Geom', 'taps', 'nufft_sample', 'nufft_sample_torch',
           'nufft_spread', 'nufft_spread_torch', 'nufft_dk',
           'nufft_dk_torch', 'Sample', 'Spread', 'Tiles', 'spread_tiles',
           'BinPlan', 'bin_plan', 'bin_plan_torch', 'bin_keys_torch',
           'bin_offsets_torch', 'spread_p', 'SPREAD_TILE', 'SPREAD_P']

LAUNCHES = {'nufft_sample': 0, 'nufft_spread': 0, 'nufft_dk': 0}

# Threads per block of the CUDA kernels (`kThreads`, csrc/nufft_common.cuh).
THREADS = 256
# Kernel widths the CUDA kernels take (`dispatch_w`, nufft_common.cuh: 4-6
# with instances of their own, the others through one at run time).
WIDTHS = range(2, 9)
# The deterministic spread (csrc/nufft_spread.cu): tiles of SPREAD_TILE[d]
# grid points an axis in d dimensions (at least W − 1 for every W taken,
# so a sample's taps reach at most the tiles after its own), each bin cut
# into subproblems of at most P samples (:func:`spread_p`: SPREAD_P from
# 2^19 samples up, down to 64 for small trajectories, so that a warp's
# chain of samples stays short and the card has subproblems enough; on an
# H100 P 512 spread the recon3d plan's koosh ball in 0.68 ms where 1024
# took 0.88), and the partial tiles of a launch kept within
# SPREAD_PART_BYTES by spreading a batch in parts.
SPREAD_TILE = {1: 256, 2: 16, 3: 8}
SPREAD_P = 512
SPREAD_PART_BYTES = 2 << 30

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
# The spread's bins
# ==========================================================================

class Tiles(NamedTuple):
    r"""The deterministic spread's tiling of a grid (axes past ``d`` padded
    with 1): per axis the tile ``B``, the tiles ``nb = ⌈G/B⌉`` and the
    padded tile ``Bp = B + W − 1``; the points ``npts`` of a padded tile
    and the bins ``nbins = Πnb``."""
    B: tuple
    nb: tuple
    Bp: tuple
    npts: int
    nbins: int


def spread_tiles(geom: Geom) -> Tiles:
    r"""The tiling :func:`nufft_spread` takes for ``geom``: tiles of
    ``SPREAD_TILE[d]`` points an axis (the whole axis where it is
    shorter). At the recon3d plan (192³, W 4): 24³ tiles of 8³, padded
    11³ = 1,331 points; at bench_nufft (256², W 5): 16² tiles of 16²,
    padded 20²."""
    d, W = geom.ndim, geom.width
    B, nb, Bp = [1] * 3, [1] * 3, [1] * 3
    for a in range(d):
        G = int(geom.grid_size[a])
        B[a] = min(G, SPREAD_TILE[d])
        nb[a], Bp[a] = -(-G // B[a]), B[a] + W - 1
    return Tiles(tuple(B), tuple(nb), tuple(Bp), Bp[0] * Bp[1] * Bp[2],
                 nb[0] * nb[1] * nb[2])


def spread_p(nT: int) -> int:
    r"""The subproblems' size for ``nT`` samples: the power of two at or
    above nT/1024, within [64, ``SPREAD_P``] (2,285,568 samples: 512;
    169,200: 256; 32,768: 64)."""
    want = 1 << max(0, (max(1, nT // 1024) - 1).bit_length())
    return min(SPREAD_P, max(64, want))


class BinPlan(NamedTuple):
    r"""The samples of a trajectory ``(Nk, d, nT)`` binned for the spread,
    one row per trajectory: ``perm (Nk, nT)`` the samples in bin order
    (stable: in sample order within a bin), ``bin_start (Nk, nbins + 1)``
    where each bin starts in ``perm``, ``sub_first (Nk, nbins + 1)`` each
    bin's first subproblem (a bin of ``c`` samples has ``⌈c/P⌉``, its
    samples cut in order into runs of ``P``), ``nsub_max`` a bound on any
    row's subproblems (the partial buffer's), the ``tiles`` and ``P``."""
    tiles: Tiles
    P: int
    perm: torch.Tensor
    bin_start: torch.Tensor
    sub_first: torch.Tensor
    nsub_max: int


def _key_dtype(tiles: Tiles):
    r"""The keys' integer type: int16 where the bins fit (a radix sort of
    half the passes), else int32."""
    return torch.int16 if tiles.nbins <= 32767 else torch.int32


def bin_keys_torch(k, geom: Geom, tiles: Tiles):
    r"""Plain PyTorch version of the ``nufft_bin_keys`` kernel: the bin
    `(Nk, nT)` of each sample of ``k (Nk, d, nT)``, the tile that holds its
    first tap on every axis (the first tap as :func:`_axis` computes it),
    row-major over the axes; int16 where the bins fit, else int32."""
    c = geom.consts()
    key = torch.zeros(k.shape[0], k.shape[-1], dtype=torch.int64,
                      device=k.device)
    for a in range(geom.ndim):
        v = k[:, a] * c[3 + a] * c[6 + a]
        m = (torch.floor(v - c[12]) + 1.0).long() % int(c[a])
        key = key * tiles.nb[a] + m // tiles.B[a]
    return key.to(_key_dtype(tiles))


def bin_offsets_torch(skeys, nbins: int, P: int):
    r"""Plain PyTorch version of the ``nufft_bin_offsets`` kernels: from
    sorted keys `(Nk, nT)`, each bin's start `(Nk, nbins + 1)` (the first
    place whose key is the bin or more; nT past the last) and its first
    subproblem (the exclusive sum of ``⌈count/P⌉`` over the bins before
    it; the last entry the row's total), both int32."""
    Nk = skeys.shape[0]
    edges = torch.arange(nbins + 1, dtype=skeys.dtype,
                         device=skeys.device).expand(Nk, -1).contiguous()
    bin_start = torch.searchsorted(skeys.contiguous(), edges, out_int32=True)
    nsub = (bin_start[:, 1:] - bin_start[:, :-1] + (P - 1)) // P
    sub_first = torch.zeros_like(bin_start)
    sub_first[:, 1:] = torch.cumsum(nsub, dim=1, dtype=torch.int32)
    return bin_start, sub_first


def _plan(k, geom: Geom, P, keys_of, offsets_of) -> BinPlan:
    r"""The plan from the keys and offsets of ``keys_of``/``offsets_of``:
    the keys' stable sort between them (one row sorted flat, with less work
    on the host)."""
    P = spread_p(k.shape[-1]) if P is None else int(P)
    tiles = spread_tiles(geom)
    keys = keys_of(k, geom, tiles, P)
    if keys.shape[0] == 1:
        skeys, perm = torch.sort(keys[0], stable=True)
        skeys, perm = skeys[None], perm[None]
    else:
        skeys, perm = torch.sort(keys, dim=-1, stable=True)
    bin_start, sub_first = offsets_of(skeys, tiles.nbins, P)
    nT = keys.shape[1]
    return BinPlan(tiles, P, perm.contiguous(), bin_start, sub_first,
                   (nT + min(tiles.nbins, nT) * (P - 1)) // P)


def bin_plan_torch(k, geom: Geom, P: int = None) -> BinPlan:
    r"""Plain PyTorch version of :func:`bin_plan`: :func:`bin_keys_torch`,
    the keys' stable sort, :func:`bin_offsets_torch`."""
    return _plan(k, geom, P, lambda k, g, t, P: bin_keys_torch(k, g, t),
                 bin_offsets_torch)


def bin_plan(k, geom: Geom, P: int = None) -> BinPlan:
    r"""The spread's :class:`BinPlan` of ``k (Nk, d, nT)``: the keys
    (``nufft_bin_keys``), their stable sort (``torch.sort``), and each
    bin's start and first subproblem (``nufft_bin_offsets``) on CUDA
    tensors, :func:`bin_plan_torch` on CPU tensors; integer bookkeeping,
    no transfer to the host. ``P`` defaults to :func:`spread_p`'s."""
    if _device_kind(k) == 'cpu':
        return bin_plan_torch(k, geom, P)
    return _plan(k, geom, P, _launch_bin_keys, _launch_bin_offsets)


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


def _tiles_arg(tiles: Tiles, P: int):
    return (ctypes.c_int64 * 12)(*tiles.B, *tiles.nb, *tiles.Bp,
                                 tiles.npts, tiles.nbins, P)


def _launch_bin_keys(k, geom: Geom, tiles: Tiles, P: int):
    if k.dtype not in (torch.float32, torch.float64):
        raise TypeError(f'nufft_bin_keys takes float32 or float64, not '
                        f'{k.dtype}')
    Nk, d, nT = k.shape
    _check(k, 'k', (Nk, d, nT), k.dtype, k.device)
    keys = torch.empty((Nk, nT), dtype=_key_dtype(tiles), device=k.device)
    with torch.cuda.device(k.device):
        err = _entry('bin_keys', k.dtype)(
            _ptr(k), _ptr(keys), _geo(geom), _tiles_arg(tiles, P), d * nT,
            Nk, nT, d, geom.width, keys.element_size(), _stream(k.device))
    _raise_on(err, 'nufft_bin_keys')
    return keys


def _launch_bin_offsets(skeys, nbins: int, P: int):
    from mrphy_tpu_torch.kernels._build import library
    Nk, nT = skeys.shape
    skeys = skeys.contiguous()
    bin_start = torch.empty((Nk, nbins + 1), dtype=torch.int32,
                            device=skeys.device)
    sub_first = torch.empty_like(bin_start)
    with torch.cuda.device(skeys.device):
        err = library()[0].mrphy_nufft_bin_offsets(
            _ptr(skeys), _ptr(bin_start), _ptr(sub_first), Nk, nT, nbins, P,
            skeys.element_size(), _stream(skeys.device))
    _raise_on(err, 'nufft_bin_offsets')
    return bin_start, sub_first


def _launch_spread(s, k, geom: Geom):
    N, nT, d, k_bs = _sizes('nufft_spread', s, k, geom)
    _check(s, 's', (N, nT, 2), s.dtype, s.device)
    plan = bin_plan(k, geom)
    tl, npts = plan.tiles, plan.tiles.npts
    grid = torch.empty((N, int(np.prod(geom.grid_size)), 2), dtype=s.dtype,
                       device=s.device)
    # the batch in parts whose partial tiles fit SPREAD_PART_BYTES
    per_entry = plan.nsub_max * npts * 2 * s.element_size()
    step = max(1, min(N, SPREAD_PART_BYTES // per_entry))
    part = torch.empty((step, plan.nsub_max, npts, 2), dtype=s.dtype,
                       device=s.device)
    targ = _tiles_arg(tl, plan.P)
    with torch.cuda.device(s.device):
        for n0 in range(0, N, step):
            n1 = min(N, n0 + step)
            rows = slice(n0, n1) if k_bs else slice(0, 1)
            err = _entry('spread', s.dtype)(
                *map(_ptr, (s[n0:n1], k[rows], plan.perm[rows],
                            plan.bin_start[rows], plan.sub_first[rows], part,
                            grid[n0:n1])), _geo(geom), targ, k_bs, n1 - n0,
                nT, d, geom.width, plan.nsub_max, _stream(s.device))
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
