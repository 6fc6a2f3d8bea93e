r"""The deterministic spread's bins on the CPU (K11 ``nufft_spread``,
:func:`mrphy_tpu_torch.kernels.nufft.bin_plan`): the tiling at the paths'
plans, and the plan's plain function on 1-D, 2-D and 3-D trajectories that
reach past the Nyquist box, so that first taps wrap at the grid's edges.
Every sample lands in exactly one subproblem; a subproblem holds at most
``P`` samples of one bin, in sample order; each sample's bin is the tile of
its first tap as :func:`~mrphy_tpu_torch.kernels.nufft.taps` computes it;
the plan of a shared trajectory equals that of the same trajectory repeated
per entry. Then the spread's plain route against the JAX package's XLA
scatter (the gather route's ``_adj_scatter``) in float64 at 1e-12 of the
largest value, the bar ``tests/test_torch_nufft.py`` takes against JAX's
gather route. The kernels themselves run on the card only
(``tests/test_torch_cuda.py``).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mrphy_tpu.ops import nufft as jnf
from mrphy_tpu_torch.kernels import nufft as knf
from mrphy_tpu_torch.ops import nufft as tnf


def _plan(im_size, fov, width, osf=2.0):
    return tnf.nufft_plan(im_size, fov, width=width, osf=osf,
                          dtype=torch.float64, device='cpu')


def _subproblems(bp, row):
    r"""Row ``row``'s subproblems of the plan ``bp`` in the order of the
    kernel's blocks: ``(bin, first, end)`` into ``perm``, as a block finds
    them from its index."""
    bs, sf = bp.bin_start[row].tolist(), bp.sub_first[row].tolist()
    out = []
    for b in range(bp.tiles.nbins):
        for j in range(sf[b + 1] - sf[b]):
            i0 = bs[b] + j * bp.P
            out.append((b, i0, min(i0 + bp.P, bs[b + 1])))
    return out


def _k(rng, im_size, fov, Nk, nT, reach=1.5):
    r"""``(Nk, d, nT)`` uniform within ``reach`` × the Nyquist box."""
    return torch.as_tensor(np.stack([
        rng.uniform(-reach * n / (2 * f), reach * n / (2 * f), (Nk, nT))
        for n, f in zip(im_size, fov)], 1))


# image size, FOV, W, osf -> the grid's tiling: B, nb and Bp per axis. The
# paths' plans and the edges of the tiling: a 3-D axis of 18 points at W 8
# (tiles of 8, 8 and 2; the padded tile longer than the last), 1-D at W 8
# past 256 points (a last tile of 44), and a 1-D grid of one tile.
TILES = [
    (((128,) * 3, (24.0,) * 3, 4, 1.5),
     ((8, 8, 8), (24, 24, 24), (11, 11, 11))),          # recon3d at 128
    (((96,) * 3, (24.0,) * 3, 4, 1.25),
     ((8, 8, 8), (15, 15, 15), (11, 11, 11))),          # bench_nufft3d
    (((128, 128), (25.6, 25.6), 5, 2.0),
     ((16, 16, 1), (16, 16, 1), (20, 20, 1))),          # bench_nufft
    (((40,) * 3, (24.0,) * 3, 7, 2.0),
     ((8, 8, 8), (10, 10, 10), (14, 14, 14))),          # W 7
    (((9, 11, 9), (9.0, 11.0, 9.0), 8, 2.0),
     ((8, 8, 8), (3, 3, 3), (15, 15, 15))),
    (((150,), (24.0,), 8, 2.0), ((256, 1, 1), (2, 1, 1), (263, 1, 1))),
    (((40,), (24.0,), 6, 2.0), ((80, 1, 1), (1, 1, 1), (85, 1, 1)))]


@pytest.mark.parametrize('geo,want', TILES, ids=[
    'recon3d', 'bench_nufft3d', 'bench_nufft', '3d-w7', '3d-w8-edges',
    '1d-two-tiles', '1d-one-tile'])
def test_spread_tiles(geo, want):
    r"""The tiling by shape: tiles of ``SPREAD_TILE[d]`` (the axis where it
    is shorter), at least W − 1 wherever an axis has two tiles or more, so
    a sample's taps reach only the tiles after its own."""
    im_size, fov, W, osf = geo
    plan = _plan(im_size, fov, W, osf)
    t = knf.spread_tiles(plan.geom)
    assert (t.B, t.nb, t.Bp) == want
    for a, G in enumerate(plan.grid_size):
        assert t.nb[a] == -(-G // t.B[a]) and t.Bp[a] == t.B[a] + W - 1
        assert t.nb[a] == 1 or t.B[a] >= W - 1
    assert t.npts == int(np.prod(t.Bp)) and t.nbins == int(np.prod(t.nb))


@pytest.mark.parametrize('nT,want', [(2_285_568, 512), (524_288, 512),
                                     (169_200, 256), (32_768, 64), (1, 64)])
def test_spread_p(nT, want):
    r"""The subproblems' size: ``SPREAD_P`` for large trajectories (the
    recon3d plan's koosh ball), a power of two down to 64 for small ones
    (recon3d's own 1200 spokes: 256)."""
    assert knf.spread_p(nT) == want <= knf.SPREAD_P


# image size, FOV, W, samples, P: 1-D, 2-D and 3-D, grids whose last tile
# is short (50·2 = 100 points at tiles of 16; 9·2 = 18 at tiles of 8), P
# small enough that bins split into several subproblems
PLANS = [((300,), (24.0,), 6, 900, 64), ((50, 24), (20.0, 12.0), 5, 700, 9),
         ((9, 12, 10), (9.0, 12.0, 10.0), 4, 500, 5)]


@pytest.mark.parametrize('im_size,fov,W,nT,P', PLANS,
                         ids=['1d', '2d', '3d'])
def test_bin_plan(im_size, fov, W, nT, P):
    r"""The plan of a trajectory (two entries) whose taps wrap at the
    edges: each sample's bin holds its first tap (``taps``' first index
    on each axis); the subproblems, in the order of the kernel's blocks,
    take every sample exactly once, at most ``P`` of one bin each, in
    sample order, no more of them than ``nsub_max``; and the plan of the
    first entry shared by a batch equals its row of the per-entry plan."""
    rng = np.random.default_rng(11)
    plan = _plan(im_size, fov, W)
    geom, d = plan.geom, len(im_size)
    k = _k(rng, im_size, fov, 2, nT)
    bp = knf.bin_plan(k, geom, P)
    t = bp.tiles
    assert bp.P == P and bp.perm.shape == (2, nT)
    assert bp.bin_start.shape == bp.sub_first.shape == (2, t.nbins + 1)
    assert bp.bin_start.dtype == bp.sub_first.dtype == torch.int32
    keys = knf.bin_keys_torch(k, geom, t)
    # the first tap on each axis, as taps() gives it, in its bin's tile
    fi, _, _ = knf.taps(k, geom)
    first = fi[..., 0]
    G = plan.grid_size
    wrapped = False
    for a in reversed(range(d)):
        ia = first % G[a]
        first = first // G[a]
        ba = (keys // int(np.prod(t.nb[a + 1:d]))) % t.nb[a]
        assert torch.equal(ia // t.B[a], ba.long())
        wrapped |= bool((ia >= G[a] - W + 1).any())
    assert wrapped                        # some taps wrap past the edge
    for row in range(2):
        subs = _subproblems(bp, row)
        assert 0 < len(subs) <= bp.nsub_max
        assert len(subs) == int(bp.sub_first[row, -1])
        seen = []
        for b, i0, i1 in subs:
            assert 0 < i1 - i0 <= P
            idx = bp.perm[row, i0:i1]
            assert bool((keys[row, idx] == b).all())
            assert bool((idx[1:] > idx[:-1]).all())      # sample order
            if seen and seen[-1][0] == b:
                assert i0 == seen[-1][2]                 # cut in order
            seen.append((b, i0, i1))
        taken = torch.cat([bp.perm[row, i0:i1] for _, i0, i1 in subs])
        assert torch.equal(torch.sort(taken).values, torch.arange(nT))
        assert int(bp.bin_start[row, -1]) == nT
    shared = knf.bin_plan(k[:1], geom, P)
    repeated = knf.bin_plan(k[:1].expand(3, -1, -1).contiguous(), geom, P)
    for x, y, z in ((shared.perm, repeated.perm, bp.perm),
                    (shared.bin_start, repeated.bin_start, bp.bin_start),
                    (shared.sub_first, repeated.sub_first, bp.sub_first)):
        assert x.shape[0] == 1 and torch.equal(x[0], z[0])
        assert all(torch.equal(x[0], y[r]) for r in range(3))
    assert shared.nsub_max == repeated.nsub_max == bp.nsub_max


def test_bin_plan_hot_centre():
    r"""A koosh-ball-like pile-up: half the samples within a tile of k = 0.
    The centre bins split into ⌈c/P⌉ subproblems each, so none holds more
    than ``P``; the bound ``nsub_max`` holds."""
    rng = np.random.default_rng(5)
    im_size, fov, P = (16, 16, 16), (24.0,) * 3, 50
    plan = _plan(im_size, fov, 4, osf=1.5)
    k = _k(rng, im_size, fov, 1, 4000)
    k[..., :2000] *= 0.05
    bp = knf.bin_plan(k, plan.geom, P)
    counts = (bp.bin_start[0, 1:] - bp.bin_start[0, :-1]).long()
    nsub = (bp.sub_first[0, 1:] - bp.sub_first[0, :-1]).long()
    assert int(counts.max()) > 10 * P
    assert torch.equal(nsub, (counts + P - 1) // P)
    assert int(nsub.sum()) <= bp.nsub_max


def test_spread_plain_vs_jax_scatter():
    r"""The spread's plain route (``index_add_`` over the taps) against
    JAX's XLA scatter, float64, 2-D, W 5, k to 1.5× the Nyquist box (taps
    wrapping on both axes), at 1e-12 of the largest grid value."""
    rng = np.random.default_rng(17)
    im_size, fov = (16, 12), (24.0, 18.0)
    k = _k(rng, im_size, fov, 1, 211).numpy()
    s = rng.standard_normal((211, 2))
    jp = jnf.nufft_plan(im_size, fov, width=5, dtype=jnp.float64,
                        interp='gather')
    tp = _plan(im_size, fov, 5)
    ref = jax.jit(lambda s, k: jnf._adj_scatter(jp, s, k, None)).lower(
        jnp.asarray(s), jnp.asarray(k[0])).compile(
        compiler_options={'xla_backend_optimization_level': 0})(
        jnp.asarray(s), jnp.asarray(k[0]))
    out = knf.nufft_spread_torch(torch.as_tensor(s)[None],
                                 torch.as_tensor(k), tp.geom)[0]
    ref = np.asarray(ref)
    assert out.shape == (ref.shape[1], 2)
    np.testing.assert_allclose(out.T.numpy(), ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())
