r"""The EPG adjoints' lane route on the CPU: the route and chunk chooser of
K15 ``spgr_bwd``, K18 ``cpmg_bwd``, K21 ``xspgr_bwd``, K24 ``xspgr_v_bwd``,
K27 ``xcpmg_bwd``, K30 ``xcpmg_v_bwd``, K33 ``xmt_bwd`` and K36
``xmt_v_bwd`` (:func:`mrphy_tpu_torch.kernels.epg.adjoint_cfg`,
``adjoint_tc``) and the route chooser of the forwards with checkpoints
K14, K17, K20, K23, K26 and K29 (``forward_cfg``; K14's beside the
routing report's reason), in pure
Python at the main paths' shapes and at the large-K shapes that keep one
thread per atom, the order in which the plain versions sum over the
orders (``_lane_sum``) against a sequential sum, K15's and K27/K30's
plain versions in the lane order against their one-thread order, K18's
plain version equal at two chunks, and K33's and K36's plain versions in
the lane order (8 lanes of 2 slots) against the JAX package: float64
through its XLA scan at rtol 1e-9, float32 through its Pallas kernels in
interpret mode at 3e-6 (signals) and 2e-5 (gradients), one tiny shape
each, compiled as ``test_torch_epgx._jax`` compiles. The kernels
themselves run on the card only (``tests/test_torch_cuda.py``); their
plain versions' other JAX parity is in ``test_torch_epg.py``,
``test_torch_cpmg.py``, ``test_torch_epgx.py``, ``test_torch_epgxv.py``,
``test_torch_epgx_cpmg.py``, ``test_torch_epgx_cpmg_v.py``,
``test_torch_epgx_mt.py`` and ``test_torch_epgx_mt_v.py``.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mrphy_tpu_torch.kernels import epg as kepg
from mrphy_tpu_torch.kernels import epgx as kx
from mrphy_tpu_torch.ops import epg
from mrphy_tpu_torch.utils._shapes import largest_divisor_leq
from test_torch_epgx import _jax
from test_torch_epgx_mt import _case, _inputs, _mt_loss, _port

# (K, itemsize, planes) -> (G, M, S) of the lane route, or None: one thread
# per atom
CAPACITY = [
    ((33, 4, 6), (8, 5, 4)),      # T2 map, bench_mrf CPMG: 32 echoes
    ((33, 8, 6), (32, 2, 6)),     # phase 19's float64 case
    ((25, 4, 6), (8, 4, 6)),
    ((41, 4, 6), (16, 3, 7)),
    ((160, 4, 6), (32, 5, 5)),    # the largest one-pool K in float32
    ((161, 4, 6), None),
    ((401, 4, 6), None),          # phase 19's device-memory state
    ((64, 8, 6), (32, 2, 6)),
    ((65, 8, 6), None),
    ((201, 8, 6), None),
    ((48, 4, 6), (16, 3, 7)),     # bench_mrf_fisp, K15
    ((16, 4, 6), (8, 2, 8)),      # the MRF refinement's K 16
    ((32, 8, 6), (16, 2, 5)),     # phase 16's float64 K 32 case
    ((48, 4, 12), (16, 3, 4)),    # bench_mrf two-pool, exchange-MRF
    ((24, 4, 12), (8, 3, 4)),     # bench_mrf variable-TR two-pool
    ((37, 4, 12), (16, 3, 4)),    # K not a multiple of G
    ((32, 4, 12), (16, 2, 6)),
    ((33, 4, 12), (16, 3, 4)),    # MWF's 32 echoes, K27 and K30
    ((96, 4, 12), (32, 3, 4)),    # the largest two-pool K in float32
    ((97, 4, 12), None),
    ((201, 4, 12), None),         # phase 21's device-memory state
    ((32, 8, 12), (32, 1, 6)),
    ((33, 8, 12), None),          # MWF's float64 example: one thread
    ((101, 8, 12), None),
    ((48, 4, 8), (16, 3, 6)),     # the qMT dictionary, K33 and K36
    ((32, 4, 8), (8, 4, 4)),      # phase 31's 16k x 200 cases
    ((12, 4, 8), (8, 2, 8)),
    ((40, 4, 8), (8, 5, 3)),
    ((160, 4, 8), (32, 5, 3)),    # the largest EPG-X(MT) K in float32
    ((161, 4, 8), None),
    ((401, 4, 8), None),          # phases 31 and 33's default K
    ((32, 8, 8), (16, 2, 4)),     # phase 31's float64 case
    ((12, 8, 8), (8, 2, 4)),
    ((48, 8, 8), (16, 3, 3)),
    ((96, 8, 8), (32, 3, 3)),
    ((97, 8, 8), None),
]


@pytest.mark.parametrize('key,want', CAPACITY,
                         ids=[f'K{k}-{i}B-{p}planes' for (k, i, p), _ in
                              CAPACITY])
def test_lane_capacity(key, want):
    r"""The narrowest group whose slots fit the registers, the states that
    fit shared memory for 3 blocks an SM (at most 8)."""
    cap = kepg.lane_capacity(*key)
    if want is None:
        assert cap is None
        return
    K, itemsize, planes = key
    assert (cap.route, cap.G, cap.M, cap.S) == ('lanes',) + want
    G, M, S = want
    assert (M - 1) * G < K <= M * G
    smem = S * 128 // G * (planes * M * G + (G < 32) * G) * itemsize
    assert 3 * (smem + kepg.SMEM_RESERVED) <= kepg.SMEM_SM


def test_adjoint_cfg_and_tc():
    r"""The route by shape: the lanes up to S chunk states, one thread per
    atom past it and where the orders do not fit; the entry points' chunk
    is the largest divisor of the steps within S where the lanes take the
    shape (also where pick_tc is shorter: the T2 map's 2 becomes 4), and
    pick_tc where they do not."""
    assert kepg.adjoint_cfg(33, 4, 6, 4).route == 'lanes'
    assert kepg.adjoint_cfg(33, 4, 6, 5) == kepg.AdjointCfg('thread', 1, 0,
                                                            0)
    assert kepg.adjoint_cfg(401, 4, 6, 1).route == 'thread'
    assert kepg.adjoint_cfg(48, 4, 12, 4).G == 16
    assert kepg.adjoint_cfg(48, 4, 12, 5).route == 'thread'
    # the paths' shapes: T2 map, bench_mrf CPMG, two-pool, variable TR,
    # the exchange-MRF refinement, the segments
    assert kepg.pick_tc(32, 33, 1 << 20, 4) == 2
    assert kepg.adjoint_tc(32, 33, 1 << 20, 4) == 4
    assert kepg.pick_tc(32, 33, 65536, 4) == 32
    assert kepg.adjoint_tc(32, 33, 65536, 4) == 4
    assert kepg.pick_tc(400, 48, 65536, 4, 12) == 10
    assert kepg.adjoint_tc(400, 48, 65536, 4, 12) == 4
    assert kepg.adjoint_tc(400, 24, 65536, 4, 12) == 4
    assert kepg.adjoint_tc(200, 48, 4096, 4, 12) == 4
    assert kepg.adjoint_tc(100, 37, 16384, 4, 12) == 4
    assert kepg.adjoint_tc(30, 33, 1000, 8) == 6
    # large K: pick_tc as it was
    assert kepg.adjoint_tc(400, 401, 2048, 4) == kepg.pick_tc(400, 401,
                                                              2048, 4)
    assert kepg.adjoint_tc(200, 201, 2048, 4, 12) == kepg.pick_tc(
        200, 201, 2048, 4, 12)
    for nT, K, nA, isz, planes in ((32, 33, 65536, 4, 6),
                                   (400, 48, 65536, 4, 12),
                                   (200, 32, 8192, 8, 12)):
        tc = kepg.adjoint_tc(nT, K, nA, isz, planes)
        assert nT % tc == 0
        assert kepg.adjoint_cfg(K, isz, planes, tc).route == 'lanes'


def test_adjoint_tc_checkpoint_budget():
    r"""The capped chunk is taken while its checkpoints fit
    ``LANE_CHK_BYTES`` (16 GiB), pick_tc's past that (the one-thread
    route): two pools, K 48, 400 TRs in float32 at 65,536 atoms (100 of 151
    MB, 15.1 GB: 4) and at 131,072 (30.2 GB: 5); one pool, K 33, 262,144
    atoms at 32 echoes (1.7 GB: 4) and at 400 (20.8 GB: 10); two pools, K
    96 (30.2 GB: 5); and where pick_tc is within S, the largest divisor
    within S at any size, its checkpoints fewer (float64, K 32, 131,072
    atoms × 200: 5, pick_tc's too; one pool, K 33, 1,048,576 atoms × 32: 4,
    pick_tc 2; two pools there: 4, pick_tc 1)."""
    assert kepg.LANE_CHK_BYTES == 16 << 30
    for shape, want, route in (((400, 48, 65536, 4, 12), 4, 'lanes'),
                               ((400, 48, 131072, 4, 12), 5, 'thread'),
                               ((32, 33, 1 << 18, 4, 6), 4, 'lanes'),
                               ((400, 33, 1 << 18, 4, 6), 10, 'thread'),
                               ((400, 96, 65536, 4, 12), 5, 'thread'),
                               ((200, 32, 1 << 17, 8, 12), 5, 'lanes'),
                               ((32, 33, 1 << 20, 4, 6), 4, 'lanes'),
                               ((32, 33, 1 << 20, 4, 12), 4, 'lanes')):
        nT, K, nA, isz, planes = shape
        tc = kepg.adjoint_tc(*shape)
        assert tc == want, shape
        assert kepg.adjoint_cfg(K, isz, planes, tc).route == route, shape
        pick = kepg.pick_tc(*shape)
        S = kepg.lane_capacity(K, isz, planes).S
        capped = nT // S * planes * K * nA * isz
        if pick <= S:
            assert tc == largest_divisor_leq(nT, S) >= pick
        elif route == 'thread':
            assert tc == pick and capped > kepg.LANE_CHK_BYTES
        else:
            assert tc == S and capped <= kepg.LANE_CHK_BYTES


# (K, itemsize) -> (route, G, M) of the two-pool forwards with checkpoints
# K20, K23, K26 and K29 (kernels/epg.py forward_cfg at 12 planes): the
# narrowest group whose slots fit FWD_SLOTS_MAX (5 in float32, 2 in
# float64), one thread per atom past it, for any chunk.
FORWARD = [
    ((24, 4), ('lanes', 8, 3)),       # bench_mrf variable-TR two-pool
    ((33, 4), ('lanes', 8, 5)),       # MWF's 32 echoes
    ((48, 4), ('lanes', 16, 3)),      # bench_mrf two-pool, exchange-MRF
    ((101, 4), ('lanes', 32, 4)),     # past the adjoint's slots
    ((161, 4), ('thread', 1, 0)),     # phase 25's device-memory state
    ((201, 4), ('thread', 1, 0)),     # phase 21's default K
    ((24, 8), ('lanes', 16, 2)),
    ((33, 8), ('lanes', 32, 2)),      # MWF's float64 example (26b)
    ((48, 8), ('lanes', 32, 2)),
    ((101, 8), ('thread', 1, 0)),     # phase 21's float64 default K
    ((161, 8), ('thread', 1, 0)),
    ((201, 8), ('thread', 1, 0))]


# The same for K17 (6 planes): up to 8 slots in float32, 4 in float64.
FORWARD_CPMG = [
    ((33, 4), ('lanes', 8, 5)),       # the T2 map, bench_mrf CPMG: 32 echoes
    ((17, 4), ('lanes', 8, 3)),
    ((64, 4), ('lanes', 8, 8)),
    ((65, 4), ('lanes', 16, 5)),
    ((256, 4), ('lanes', 32, 8)),     # the largest one-pool K in float32
    ((257, 4), ('thread', 1, 0)),
    ((401, 4), ('thread', 1, 0)),     # phase 19's device-memory state
    ((17, 8), ('lanes', 8, 3)),       # the DWI example's 16 echoes (20b)
    ((33, 8), ('lanes', 16, 3)),      # phase 19's float64 case
    ((128, 8), ('lanes', 32, 4)),
    ((129, 8), ('thread', 1, 0)),
    ((201, 8), ('thread', 1, 0))]     # phase 19's float64 K 201


@pytest.mark.parametrize('key,want,planes', [
    (k, w, 12) for k, w in FORWARD] + [(k, w, 6) for k, w in FORWARD_CPMG],
    ids=[f'K{k}-{i}B' for (k, i), _ in FORWARD]
    + [f'K{k}-{i}B-6planes' for (k, i), _ in FORWARD_CPMG])
def test_forward_cfg(key, want, planes):
    r"""The forwards' route by shape alone: the narrowest group of 8, 16 or
    32 lanes whose ``M = ⌈K/G⌉`` slots fit ``FWD_SLOTS_MAX``, else one
    thread per atom; the lanes take every K ≤ 32·FWD_SLOTS_MAX."""
    K, itemsize = key
    cfg = kepg.forward_cfg(K, itemsize, planes)
    assert tuple(cfg) == want
    mmax = kepg.FWD_SLOTS_MAX[(planes, itemsize)]
    assert (cfg.route == 'lanes') == (K <= 32 * mmax)
    if cfg.route == 'lanes':
        assert (cfg.M - 1) * cfg.G < K <= cfg.M * cfg.G <= cfg.G * mmax
        assert all(-(-K // G) > mmax for G in kepg.LANE_WIDTHS
                   if G < cfg.G)


# K14 (spgr_fwd_chk, 6 planes) at the MRF paths' shapes, 400 TRs:
# bench_mrf_fisp and the pipeline's dictionary at K 48 (8 lanes of 6 slots
# in float32), the refinement at K 16, with diffusion and at kshift −1 and
# 2; the default K (401, 801 at kshift 2) keeps one thread per atom, as
# float64 past 128 orders does. (K, itemsize, kshift, diffusion, atoms) ->
# (route, G, M).
SPGR_FORWARD = [
    ((48, 4, 1, False, 65536), ('lanes', 8, 6)),
    ((48, 4, 1, True, 65536), ('lanes', 8, 6)),
    ((16, 4, -1, False, 4096), ('lanes', 8, 2)),
    ((16, 4, 2, True, 4096), ('lanes', 8, 2)),
    ((None, 4, 1, False, 2048), ('thread', 1, 0)),
    ((None, 4, 2, True, 2048), ('thread', 1, 0)),
    ((48, 8, 2, True, 8192), ('lanes', 16, 3)),
    ((16, 8, -1, False, 4096), ('lanes', 8, 2)),
    ((None, 8, 1, False, 1000), ('thread', 1, 0))]


@pytest.mark.parametrize('key,want', SPGR_FORWARD, ids=[
    f'K{k[0] or "default"}-{k[1]}B-kshift{k[2]}' + ('-diffusion' if k[3]
                                                    else '')
    for k, _ in SPGR_FORWARD])
def test_spgr_fwd_chk_route(key, want):
    r"""K14's route by shape alone (``forward_cfg`` at 6 planes, the
    chooser K17 takes): the lanes wherever an atom's orders fit, one thread
    per atom at the default K; the routing report's reason for the same
    ``epg_spgr`` call keeps its words (the forward's route is the chooser's
    to say)."""
    from mrphy_tpu_torch.ops.routing import route
    K, itemsize, kshift, diff, nA = key
    nTR = 400
    Kk = nTR * abs(kshift) + 1 if K is None else K
    assert tuple(kepg.forward_cfg(Kk, itemsize, 6)) == want
    kw = dict(flips=np.zeros(nTR), T1=np.zeros(nA), T2=np.zeros(nA),
              tr=np.zeros(nTR), kshift=kshift, K=K)
    if diff:
        kw['D'] = np.zeros(nA)
    r = route('epg_spgr', backend='cuda', **kw)
    assert r['path'] == 'cuda-native-adjoint'
    assert r['reason'] == (
        'spgr_fwd, and spgr_fwd_chk + spgr_bwd under a gradient (nTR=%d, '
        'K=%d, nA=%d, variable tr/te%s; the adjoint chunk tc=%d in '
        'float32)' % (nTR, Kk, nA, ', diffusion' if diff else '',
                      kepg.adjoint_tc(nTR, Kk, nA, 4)))


@pytest.mark.parametrize('G', [1, 8, 16, 32])
@pytest.mark.parametrize('K', [1, 5, 33, 48, 101])
def test_lane_sum_order(G, K):
    r"""``_lane_sum`` against a sequential sum in float64 (1e-13 of the
    sum of magnitudes), bit for bit against the sum it spells out (each
    lane's orders in turn, then the lanes at offsets G/2, …, 1), and equal
    to ``_ksum`` at G 1."""
    x = torch.as_tensor(np.random.default_rng(K * 97 + G).standard_normal(
        (3, 7, K)))
    got = kepg._lane_sum(x, G)
    seq = x[..., 0]
    for k in range(1, K):
        seq = seq + x[..., k]
    assert float((got - seq).abs().max()) <= 1e-13 * float(
        x.abs().sum(-1).max())
    if G == 1:
        assert torch.equal(got, kepg._ksum(x))
        return
    lanes = []
    for lane in range(G):
        acc = torch.zeros_like(x[..., 0])
        for k in range(lane, K, G):
            acc = acc + x[..., k]
        lanes.append(acc)
    o = G // 2
    while o:
        lanes = [lanes[i] + lanes[i + o] for i in range(o)]
        o //= 2
    assert torch.equal(got, lanes[0])



@pytest.mark.parametrize('shape,want', [
    ((400, 48, 65536, 4, 6), 5),        # bench_mrf_fisp (pick_tc 25)
    ((400, 16, 4096, 4, 6), 8),         # the MRF refinement (pick_tc 400)
    ((32, 33, 1 << 18, 4, 12), 4),      # the MWF fit's block (pick_tc's)
    ((32, 33, 65536, 4, 12), 4),        # bench_mrf's EPG-X CPMG (16)
    ((32, 33, 4096, 4, 12), 4)],        # the MWF accuracy fit (32)
    ids=['mrf-fisp', 'mrf-refine', 'mwf-block', 'xcpmg-64k', 'mwf-4096'])
def test_adjoint_tc_k15_k27(shape, want):
    r"""K15's and K27/K30's chunk at their paths' shapes: pick_tc capped at
    S, on the lane route; K14 at bench_mrf_fisp then writes 80 checkpoints
    of 75.5 MB (6.04 GB, within ``LANE_CHK_BYTES``)."""
    nT, K, nA, isz, planes = shape
    tc = kepg.adjoint_tc(*shape)
    assert tc == want and nT % tc == 0
    assert kepg.adjoint_cfg(K, isz, planes, tc).route == 'lanes'
    assert tc <= kepg.pick_tc(*shape)
    if shape[:3] == (400, 48, 65536):
        assert kepg.pick_tc(*shape) == 25
        assert nT // tc * planes * K * nA * isz == 80 * 75497472
    # float64 at K 33, two pools, keeps one thread per atom
    if planes == 12:
        assert kepg.adjoint_cfg(K, 8, 12, tc).route == 'thread'


def _spy_lane_parts(monkeypatch):
    r"""Record the group width of every ``_lane_parts`` call the plain
    versions make."""
    seen = []
    orig = kepg._lane_parts

    def spy(x, G, acc=None):
        seen.append(G)
        return orig(x, G, acc)

    monkeypatch.setattr(kepg, '_lane_parts', spy)
    monkeypatch.setattr(kx, '_lane_parts', spy)
    return seen


def _one_thread(monkeypatch):
    r"""Make the plain versions take the one-thread route's order."""
    thread = kepg.AdjointCfg('thread', 1, 0, 0)
    monkeypatch.setattr(kepg, 'adjoint_cfg', lambda *a: thread)
    monkeypatch.setattr(kx, 'adjoint_cfg', lambda *a: thread)


def _close(a, b):
    assert a.shape == b.shape
    scale = float(b.abs().max())
    assert float((a - b).abs().max()) <= 1e-12 * scale


def test_spgr_bwd_torch_lane_order(monkeypatch):
    r"""``spgr_bwd_torch`` at a shape the lanes take (float64, K 10: 8
    lanes of 2 slots; kshift 2, b1, a TR/TE train, diffusion; 37 atoms,
    a ragged warp) sums in the lane order and meets its one-thread order
    within float64 rounding."""
    rng = np.random.default_rng(11)
    nA, nTR, tc = 37, 12, 4

    def arr(x):
        return torch.as_tensor(x, dtype=torch.float64)

    coef, par, cdiff, cfg, _ = epg._spgr_rows(
        arr(rng.uniform(0.1, 1.2, nTR)), arr(rng.uniform(0, 6, nTR)),
        T1=arr(rng.uniform(0.2, 3, nA)), T2=arr(rng.uniform(0.02, 0.4, nA)),
        tr=arr(rng.uniform(0.008, 0.016, nTR)),
        te=arr(rng.uniform(1e-3, 4e-3, nTR)),
        b1=arr(rng.uniform(0.8, 1.2, nA)),
        D=arr(rng.uniform(0.4e-5, 3.2e-5, nA)), dk=450.0, kshift=2, K=10)
    assert kepg.adjoint_cfg(10, 8, 6, tc) == kepg.AdjointCfg('lanes', 8, 2, 5)
    _, chk = kepg.spgr_fwd_chk_torch(coef, par, cdiff, cfg, tc=tc)
    g = arr(rng.standard_normal((nA, nTR, 2)))
    seen = _spy_lane_parts(monkeypatch)
    lanes = kepg.spgr_bwd_torch(coef, par, cdiff, cfg, chk, g, tc=tc)
    assert seen and set(seen) == {8}
    _one_thread(monkeypatch)
    seen.clear()
    thread = kepg.spgr_bwd_torch(coef, par, cdiff, cfg, chk, g, tc=tc)
    assert not seen
    for a, b in zip(lanes, thread):
        _close(a, b)


@pytest.mark.parametrize('varesp', [False, True], ids=['esp', 'esp-train'])
def test_xcpmg_bwd_torch_lane_order(monkeypatch, varesp):
    r"""``xcpmg_bwd_torch`` and ``xcpmg_v_bwd_torch`` at a shape the lanes
    take (float64, 6 echoes, K 7: 8 lanes of 1 slot; b1; 37 atoms) sum in
    the lane order (the entries per lane over both halves, over the train
    or per echo) and meet their one-thread order within float64
    rounding."""
    rng = np.random.default_rng(13)
    nA, nE, tc = 37, 6, 3

    def arr(x):
        return torch.as_tensor(x, dtype=torch.float64)

    esp = arr(rng.uniform(0.008, 0.018, nE)) if varesp else 0.01
    coef, pk, cfg, _ = epg._xcpmg_rows(
        arr(rng.uniform(1.75, 3.14, nE)), T1a=arr(rng.uniform(0.5, 2, nA)),
        T2a=arr(rng.uniform(0.05, 0.3, nA)),
        T1b=arr(rng.uniform(0.2, 0.6, nA)),
        T2b=arr(rng.uniform(0.005, 0.03, nA)), kab=arr(rng.uniform(1, 10, nA)),
        kba=arr(rng.uniform(5, 40, nA)), esp=esp,
        M0b=arr(rng.uniform(0.05, 0.3, nA)), dfb=arr(rng.uniform(-20, 20, nA)),
        b1=arr(rng.uniform(0.8, 1.2, nA)))
    assert kepg.adjoint_cfg(cfg.K, 8, 12, tc) == kepg.AdjointCfg(
        'lanes', 8, 1, 5)
    par = tuple(pk) if varesp else (pk,)
    v = '_v' if varesp else ''
    chk = getattr(kx, f'xcpmg{v}_fwd_chk_torch')(coef, *par, cfg, tc=tc)[2]
    gr, gi = arr(rng.standard_normal((2, nE, nA)))
    bwd = getattr(kx, f'xcpmg{v}_bwd_torch')
    seen = _spy_lane_parts(monkeypatch)
    lanes = bwd(coef, *par, cfg, chk, gr, gi, tc=tc)
    assert seen and set(seen) == {8}
    _one_thread(monkeypatch)
    seen.clear()
    thread = bwd(coef, *par, cfg, chk, gr, gi, tc=tc)
    assert not seen
    for a, b in zip(lanes, thread):
        _close(a, b)


@pytest.mark.parametrize('shape,want', [
    ((32, 33, 1 << 20, 4, 6), (4, 2, ('lanes', 8, 5, 4))),
    ((400, 48, 65536, 4, 8), (5, 20, ('lanes', 16, 3, 6))),
    ((200, 32, 16384, 4, 8), (4, 100, ('lanes', 8, 4, 4))),
    ((200, 32, 8192, 8, 8), (4, 100, ('lanes', 16, 2, 4))),
    ((400, 401, 2048, 4, 8), (80, 80, ('thread', 1, 0, 0))),
    ((201, 32, 1001, 4, 8), (3, 201, ('lanes', 8, 4, 4)))],
    ids=['t2map', 'qmt-dict', 'qmt-16k', 'qmt-f64', 'qmt-K401',
         'qmt-ragged'])
def test_adjoint_tc_t2map_and_qmt(shape, want):
    r"""K17/K18's chunk at the T2 map (1,048,576 × 32, K 33: 4 where
    pick_tc gives 2, 6.6 GB of checkpoints) and K32–K36's at 8 planes: the
    qMT dictionary (65,536 × 400, K 48: 16 lanes of 3 slots, S 6, tc 5
    where pick_tc gives 20; K32's 80 checkpoints of 100.7 MB, 8.05 GB, within
    ``LANE_CHK_BYTES``), phase 31's cases, and the default K 401 on one
    thread per atom at pick_tc's chunk."""
    tc, pick, cfg = want
    nT, K, nA, isz, planes = shape
    assert kepg.pick_tc(*shape) == pick
    assert kepg.adjoint_tc(*shape) == tc
    assert tuple(kepg.adjoint_cfg(K, isz, planes, tc)) == cfg
    chk = nT // tc * planes * K * nA * isz
    assert chk <= kepg.LANE_CHK_BYTES
    if shape[:3] == (32, 33, 1 << 20):
        assert chk == 8 * 6 * 33 * (1 << 20) * 4      # 6.6 GB
    if shape[:3] == (400, 48, 65536):
        assert chk == 80 * 8 * 48 * 65536 * 4         # 8.05 GB
    # a chunk past S: one thread per atom
    if cfg[0] == 'lanes':
        assert kepg.adjoint_cfg(K, isz, planes, cfg[3] + 1).route == 'thread'


def test_cpmg_bwd_torch_same_at_two_chunks():
    r"""K18's plain version (float64, 32 echoes, K 33: 32 lanes of 2 slots;
    b1, an esp train, diffusion, the slice-profile excitation; 37 atoms) at
    tc 2 and tc 4 on the lane route: phase 1 recomputes the forward's own
    states, so the per-atom gradients and the per-echo rows are equal bit
    for bit, and so are the echoes of the two forwards."""
    rng = np.random.default_rng(17)
    nA, nE = 37, 32

    def arr(x):
        return torch.as_tensor(x, dtype=torch.float64)

    coef, par, dq, cdiff, cfg, _ = epg._cpmg_rows(
        arr(np.deg2rad(rng.uniform(120, 180, nE))),
        T1=arr(rng.uniform(0.2, 3.0, nA)), T2=arr(rng.uniform(0.02, 0.4, nA)),
        esp=arr(rng.uniform(0.008, 0.012, nE)),
        D=arr(rng.uniform(0.5e-5, 3e-5, nA)), dk=450.0,
        alpha_ex=arr(rng.uniform(1.0, 1.7, nA)),
        phi_ex=arr(rng.uniform(0, 6, nA)), M0=arr(rng.uniform(0.7, 1.2, nA)),
        b1=arr(rng.uniform(0.7, 1.15, nA)))
    args = (coef, par, dq, cdiff, cfg)
    gr, gi = arr(rng.standard_normal((2, nE, nA)))
    out = []
    for tc in (2, 4):
        assert kepg.adjoint_cfg(cfg.K, 8, 6, tc) == kepg.AdjointCfg(
            'lanes', 32, 2, 6)
        er, ei, chk = kepg.cpmg_fwd_chk_torch(*args, tc=tc)
        assert chk.shape == (nE // tc, 6, cfg.K, nA)
        out.append((er, ei) + kepg.cpmg_bwd_torch(*args, chk, gr, gi, tc=tc))
    for a, b in zip(*out):
        assert torch.equal(a, b)


# K33's and K36's plain versions in the lanes' order against the JAX
# package: K 12 (8 lanes of 2 slots in float32 and float64), b1, a shared wt
# train, at a scalar tr (K33) and over a (nTR,) tr train (K36).
XMT_K = 12
XMT_LANE_CASES = [('tr', dict(wt='wt', tr=0.03, b1='b1')),
                  ('tr-train', dict(wt='wt', tr='trs', b1='b1'))]


@functools.cache
def _xmt_refs_f64():
    r"""JAX's XLA scan under ``jax.value_and_grad`` on both cases, one
    compiled call: ``[(signals, gradients)]``."""
    inp = _inputs(6)
    fns, args = [], []
    for _, kw in XMT_LANE_CASES:
        base, diff = _case(inp, kw)
        fns.append(_mt_loss(base, diff, inp['w'], 1, XMT_K))
        args.append([jnp.asarray(base[n], jnp.float64) for n in diff])
    res = _jax(lambda args: [f(*a) for f, a in zip(fns, args)], args)
    return jax.tree_util.tree_map(np.asarray, res)


@pytest.mark.parametrize('ci', range(len(XMT_LANE_CASES)),
                         ids=[c[0] for c in XMT_LANE_CASES])
def test_xmt_bwd_torch_lane_order_f64_vs_jax(monkeypatch, ci):
    r"""``xmt_bwd_torch`` (``tr``) and ``xmt_v_bwd_torch`` (``tr-train``)
    under the kernels' autograd Function at the lane route's chunk (6 atoms
    × 12 TRs, float64: tc 4, three chunks), summing in the lanes' order (8
    lanes), against JAX's XLA scan: signals at 1e-10 of their largest
    value, the gradients w.r.t. every input at rtol 1e-9."""
    _, kw = XMT_LANE_CASES[ci]
    inp = _inputs(6)
    base, diff = _case(inp, kw)
    nA, nTR = inp['T1a'].shape[0], inp['flips'].shape[0]
    tc = kepg.adjoint_tc(nTR, XMT_K, nA, 8, kx.PLANES_MT)
    assert tc == 4
    assert kepg.adjoint_cfg(XMT_K, 8, kx.PLANES_MT, tc) == kepg.AdjointCfg(
        'lanes', 8, 2, 4)
    seen = _spy_lane_parts(monkeypatch)
    out, grads = _port(epg._xmt_kernels, base, diff, inp['w'], 1, XMT_K)
    assert seen and set(seen) == {8}
    (_, out_j), grads_j = _xmt_refs_f64()[ci]
    np.testing.assert_allclose(out, out_j, rtol=0,
                               atol=1e-10 * float(np.abs(out_j).max()))
    for n, g, gj in zip(diff, grads, grads_j):
        np.testing.assert_allclose(g, gj, rtol=1e-9,
                                   atol=1e-9 * float(np.abs(gj).max()),
                                   err_msg=n)


def test_xmt_bwd_torch_lane_order_f32_vs_pallas_interpret(monkeypatch):
    r"""``xmt_bwd_torch`` and ``xmt_v_bwd_torch`` in float32 under
    ``kernels.epgx.xmt_spgr`` (24 atoms × 12 TRs, K 12: 8 lanes of 2 slots,
    tc 6; b1, wscale, rf-spoiled phases, a wt train; a scalar tr and a tr
    train) against JAX's Pallas kernels in interpret mode under
    ``jax.value_and_grad`` (both trains in one compiled call): signals at
    3e-6, the gradients w.r.t. every input at 2e-5 of each one's largest
    value. Interpreted, the Pallas kernels' hand unroll only multiplies the
    traced program, so it is traced once a TR."""
    from mrphy_tpu.ops import epg_pallas
    monkeypatch.setattr(epg_pallas, '_UNROLL', 1)
    nA, nTR = 24, 12
    inp = _inputs(7, nA=nA, nTR=nTR)
    f32 = np.float32
    names = ('flips', 'phis', 'wt', 'T1a', 'T2a', 'T1b', 'kab', 'kba',
             'M0a', 'M0b', 'b1', 'wscale', 'trs')
    w = inp['w'].astype(f32)
    assert kepg.adjoint_tc(nTR, XMT_K, nA, 4, kx.PLANES_MT) == 6
    assert kepg.adjoint_cfg(XMT_K, 4, kx.PLANES_MT, 6) == kepg.AdjointCfg(
        'lanes', 8, 2, 8)

    def jloss(*a):
        d = dict(zip(names, a))
        trs = d.pop('trs')
        out = [epg_pallas.epgx_mt_spgr_pallas(
            d['flips'], d['phis'], **{k: v for k, v in d.items()
                                      if k not in ('flips', 'phis')},
            tr=tr, K=XMT_K, tile=128, interpret=True) for tr in (0.03, trs)]
        return sum(jnp.sum(w * o) for o in out), out

    (_, refs), grefs = _jax(jax.value_and_grad(
        jloss, argnums=tuple(range(len(names))), has_aux=True),
        *(jnp.asarray(inp[n], f32) for n in names))
    seen = _spy_lane_parts(monkeypatch)
    ta = {n: torch.tensor(inp[n], dtype=torch.float32, requires_grad=True)
          for n in names}
    kw = {n: ta[n] for n in names if n != 'trs'}
    outs = [kx.xmt_spgr(**kw, tr=tr, K=XMT_K) for tr in (0.03, ta['trs'])]
    loss = sum((torch.as_tensor(w) * o).sum() for o in outs)
    grads = torch.autograd.grad(loss, list(ta.values()))
    assert seen and set(seen) == {8}
    for o, r in zip(outs, refs):
        assert o.dtype == torch.float32 and o.shape == r.shape
        o, r = o.detach().double(), torch.tensor(np.asarray(r)).double()
        assert float((o - r).abs().max()) <= 3e-6 * float(r.abs().max())
    for n, g, gj in zip(names, grads, grefs):
        assert g.dtype == torch.float32, n
        g, gj = g.double(), torch.tensor(np.asarray(gj)).double()
        assert float((g - gj).abs().max()) <= 2e-5 * float(
            gj.abs().max()), n
