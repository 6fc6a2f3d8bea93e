r"""The EPG adjoints' lane route on the CPU: the route and chunk chooser of
K15 ``spgr_bwd``, K18 ``cpmg_bwd``, K21 ``xspgr_bwd``, K24 ``xspgr_v_bwd``,
K27 ``xcpmg_bwd`` and K30 ``xcpmg_v_bwd``
(:func:`mrphy_tpu_torch.kernels.epg.adjoint_cfg`, ``adjoint_tc``), in pure
Python at the main paths' shapes and at the large-K shapes that keep one
thread per atom, the order in which the plain versions sum over the
orders (``_lane_sum``) against a sequential sum, and K15's and K27/K30's
plain versions in the lane order against their one-thread order. The
kernels themselves run on the card only (``tests/test_torch_cuda.py``);
their plain versions' JAX parity is in ``test_torch_epg.py``,
``test_torch_cpmg.py``, ``test_torch_epgx.py``, ``test_torch_epgxv.py``,
``test_torch_epgx_cpmg.py`` and ``test_torch_epgx_cpmg_v.py``.
"""

import numpy as np
import pytest
import torch

from mrphy_tpu_torch.kernels import epg as kepg
from mrphy_tpu_torch.kernels import epgx as kx
from mrphy_tpu_torch.ops import epg

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
    is pick_tc capped at S (to a divisor of the steps), and pick_tc where
    the lanes do not take the shape."""
    assert kepg.adjoint_cfg(33, 4, 6, 4).route == 'lanes'
    assert kepg.adjoint_cfg(33, 4, 6, 5) == kepg.AdjointCfg('thread', 1, 0,
                                                            0)
    assert kepg.adjoint_cfg(401, 4, 6, 1).route == 'thread'
    assert kepg.adjoint_cfg(48, 4, 12, 4).G == 16
    assert kepg.adjoint_cfg(48, 4, 12, 5).route == 'thread'
    # the paths' shapes: T2 map, bench_mrf CPMG, two-pool, variable TR,
    # the exchange-MRF refinement, the segments
    assert kepg.pick_tc(32, 33, 1 << 20, 4) == 2
    assert kepg.adjoint_tc(32, 33, 1 << 20, 4) == 2
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
    96 (30.2 GB: 5); and pick_tc's own chunk where it is within S, at any
    size (float64, K 32, 131,072 atoms × 200: 5)."""
    assert kepg.LANE_CHK_BYTES == 16 << 30
    for shape, want, route in (((400, 48, 65536, 4, 12), 4, 'lanes'),
                               ((400, 48, 131072, 4, 12), 5, 'thread'),
                               ((32, 33, 1 << 18, 4, 6), 4, 'lanes'),
                               ((400, 33, 1 << 18, 4, 6), 10, 'thread'),
                               ((400, 96, 65536, 4, 12), 5, 'thread'),
                               ((200, 32, 1 << 17, 8, 12), 5, 'lanes')):
        nT, K, nA, isz, planes = shape
        tc = kepg.adjoint_tc(*shape)
        assert tc == want, shape
        assert kepg.adjoint_cfg(K, isz, planes, tc).route == route, shape
        pick = kepg.pick_tc(*shape)
        S = kepg.lane_capacity(K, isz, planes).S
        capped = nT // S * planes * K * nA * isz
        if pick <= S:
            assert tc == pick
        elif route == 'thread':
            assert tc == pick and capped > kepg.LANE_CHK_BYTES
        else:
            assert tc == S and capped <= kepg.LANE_CHK_BYTES


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
