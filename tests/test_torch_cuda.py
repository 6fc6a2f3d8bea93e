r"""The CUDA kernels of :mod:`mrphy_tpu_torch.kernels` on the card (the
Bloch kernels and the two-pool ``mc_fwd``/``mc_bwd``): each against its
plain PyTorch version, the launch counts, the wrappers' refusals, and
backward through the engines reaching the adjoint kernels.

Every test here is marked ``cuda`` and skips without a CUDA device.
``tests/conftest.py`` imports JAX; where JAX is not installed, run them
with::

    python -m pytest --noconftest -q tests/test_torch_cuda.py -m cuda

This file imports no JAX. Its case builders are shared with
``tests/test_torch_kernels.py``. Tolerances: 2e-6 in float32 and 1e-12
in float64 (the kernels follow their plain versions' operations; on an
H100 they have agreed bit for bit). The adjoints' waveform-gradient rows
are sums over spins in another order than the plain version's: they are
held at 1e-5 (float32) and 1e-12 (float64) of the row's largest value.
"""

import numpy as np
import pytest
import torch

from mrphy_tpu_torch.kernels import bloch

G2PD = 2 * np.pi * 4257.6 * 4e-6   # γ2πdt at 4 µs, rad/Gauss


def _tt(a):
    return {k: torch.as_tensor(v) for k, v in a.items()}


def rfgr_args(N=2, nS=300, nT=64, nC=2, seed=0, dtype=np.float32):
    r"""Pre-scaled ``rfgr_fwd`` arguments (numpy): per-spin planes and
    waveforms of physical size; every optional input present."""
    rng = np.random.default_rng(seed)
    g2pd = np.full((N, nS), G2PD) * (1 + 0.1 * rng.random((N, nS)))
    E1 = 1 - rng.random((N, nS)) * 1e-5
    E2 = 1 - rng.random((N, nS)) * 1e-4
    a = dict(
        mi=rng.random((N, 3, nS)) - 0.5,
        rf2=(rng.random((N, 2 * nC, nT)) - 0.5) * 0.3,
        gr2=(rng.random((N, 3, nT)) - 0.5) * 4,
        loc_p=g2pd[:, None] * (rng.random((N, 3, nS)) - 0.5) * 4,
        dfg=2 * np.pi * 4e-6 * (rng.random((N, nS)) - 0.5) * 200,
        b1_p=g2pd[:, None] * (rng.random((N, 2 * nC, nS)) - 0.5),
        E=np.stack([E2, E2, E1], 1),
        e1_1=E1 - 1,
        g2pd=g2pd,
        vel_p=g2pd[:, None] * (rng.random((N, 3, nS)) - 0.5) * 50,
        tarr2=np.arange(nT)[None, :] * np.full((N, 1), 4e-6),
    )
    return {k: v.astype(dtype) for k, v in a.items()}


def beff_args(B=500, nT=96, seed=1, dtype=np.float32):
    rng = np.random.default_rng(seed)
    E1 = 1 - rng.random(B) * 1e-5
    E2 = 1 - rng.random(B) * 1e-4
    a = dict(mi=rng.random((3, B)) - 0.5,
             beff=(rng.random((nT, 3, B)) - 0.5) * 4,
             E=np.stack([E2, E2, E1]), e1_1=E1 - 1,
             g2pd=np.full(B, G2PD) * (1 + 0.1 * rng.random(B)))
    return {k: v.astype(dtype) for k, v in a.items()}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,bar', [(torch.float32, 2e-6),
                                       (torch.float64, 1e-12)])
def test_kernels_vs_plain_on_card(cuda, dtype, bar):
    npdt = np.float32 if dtype == torch.float32 else np.float64
    a = {k: v.to(cuda) for k, v in _tt(rfgr_args(dtype=npdt)).items()}
    args = (a['mi'], a['rf2'], a['gr2'], a['loc_p'], a['dfg'], a['b1_p'],
            a['E'], a['e1_1'], a['g2pd'], a['vel_p'], a['tarr2'])
    n0 = bloch.LAUNCHES['rfgr_fwd']
    torch.testing.assert_close(bloch.rfgr_fwd(*args),
                               bloch.rfgr_fwd_torch(*args), rtol=0, atol=bar)
    assert bloch.LAUNCHES['rfgr_fwd'] == n0 + 1
    b = {k: v.to(cuda) for k, v in _tt(beff_args(dtype=npdt)).items()}
    bargs = (b['mi'], b['beff'], b['E'], b['e1_1'], b['g2pd'])
    torch.testing.assert_close(bloch.beff_fwd(*bargs),
                               bloch.beff_fwd_torch(*bargs), rtol=0, atol=bar)


RFGR_KEYS = ('rf2', 'gr2', 'loc_p', 'dfg', 'b1_p', 'E', 'e1_1', 'g2pd',
             'vel_p', 'tarr2')


@pytest.mark.cuda
def test_kernel_wrappers_refuse_and_backward_raises(cuda):
    r"""The wrappers refuse what the kernels do not take; backward through
    them launches the adjoint kernels and nothing raises."""
    b = {k: v.to(cuda) for k, v in _tt(beff_args(B=64, nT=8)).items()}
    with pytest.raises(TypeError):
        bloch.beff_fwd(b['mi'].double(), b['beff'], b['E'], b['e1_1'],
                       b['g2pd'])
    with pytest.raises(ValueError, match='contiguous'):
        bloch.beff_fwd(b['mi'][:, ::2], b['beff'][..., ::2], None, None,
                       b['g2pd'][::2])
    mi = b['mi'].clone().requires_grad_()
    n0 = dict(bloch.LAUNCHES)
    chk = bloch.beff_fwd(mi, b['beff'], b['E'], b['e1_1'], b['g2pd'])
    chk.sum().backward()
    assert bloch.LAUNCHES['beff_bwd'] == n0['beff_bwd'] + 1
    assert bool(torch.isfinite(mi.grad).all())
    a = {k: v.to(cuda) for k, v in _tt(rfgr_args(nT=8)).items()}
    rf2 = a['rf2'].clone().requires_grad_()
    chk = bloch.rfgr_fwd(a['mi'], rf2, a['gr2'], a['loc_p'], None, None,
                         None, None, a['g2pd'])
    chk.sum().backward()
    assert bloch.LAUNCHES['rfgr_bwd'] == n0['rfgr_bwd'] + 1
    assert bool(torch.isfinite(rf2.grad).all())


def _rows_close(x, y, rel):
    scale = float(y.abs().max()) + 1e-30
    torch.testing.assert_close(x / scale, y / scale, rtol=0, atol=rel)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,bar,rows', [(torch.float32, 2e-6, 1e-5),
                                            (torch.float64, 1e-12, 1e-12)])
@pytest.mark.parametrize('nC,b1', [(2, True), (1, False), (3, False),
                                   (12, True)])
def test_adjoint_kernels_vs_plain_on_card(cuda, dtype, bar, rows, nC, b1):
    r"""``rfgr_bwd`` against its plain version: B1 in registers (2 coils),
    no B1 (1 and 3 coils), and B1 of more coils than the register arrays
    hold (12, read from device memory)."""
    npdt = np.float32 if dtype == torch.float32 else np.float64
    a = {k: v.to(cuda) for k, v in
         _tt(rfgr_args(nC=nC, dtype=npdt)).items()}
    if not b1:
        a['b1_p'] = None
    args = tuple(a[k] for k in RFGR_KEYS)
    chk = bloch.rfgr_fwd(a['mi'], *args, tc=16)
    g = torch.as_tensor(np.random.default_rng(5).normal(
        size=tuple(chk.shape)).astype(npdt), device=cuda)
    n0 = bloch.LAUNCHES['rfgr_bwd']
    k = bloch.rfgr_bwd(chk, g, *args, tc=16)
    assert bloch.LAUNCHES['rfgr_bwd'] == n0 + 1
    p = bloch.rfgr_bwd_torch(chk, g, *args, tc=16)
    for i, (x, y) in enumerate(zip(k, p)):
        if y is None:
            assert x is None
        elif i in (1, 2):                     # drf2, dgr2: sums over spins
            _rows_close(x, y, rows)
        else:
            torch.testing.assert_close(x, y, rtol=0, atol=bar)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,store', [(torch.float32, torch.float32),
                                         (torch.float32, torch.bfloat16),
                                         (torch.float64, torch.float64)])
def test_beff_bwd_vs_plain_on_card(cuda, dtype, store):
    npdt = np.float32 if dtype == torch.float32 else np.float64
    b = {k: v.to(cuda) for k, v in _tt(beff_args(dtype=npdt)).items()}
    beff = b['beff'].to(store)
    args = (beff, b['E'], b['e1_1'], b['g2pd'])
    chk = bloch.beff_fwd(b['mi'], *args, tc=32)
    g = torch.as_tensor(np.random.default_rng(6).normal(
        size=tuple(chk.shape)).astype(npdt), device=cuda)
    n0 = bloch.LAUNCHES['beff_bwd']
    dmi, dbeff = bloch.beff_bwd(chk, g, *args, tc=32)
    assert bloch.LAUNCHES['beff_bwd'] == n0 + 1
    pmi, pbeff = bloch.beff_bwd_torch(chk, g, *args, tc=32)
    assert dbeff.dtype == store
    bar = 2e-6 if dtype == torch.float32 else 1e-12
    torch.testing.assert_close(dmi, pmi, rtol=0, atol=bar)
    torch.testing.assert_close(dbeff.double(), pbeff.double(), rtol=0,
                               atol=bar if store != torch.bfloat16 else
                               2 ** -8 * float(pbeff.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_engine_gradients_cuda_vs_plain(cuda, dtype):
    r"""Gradients through ``sims.blochsim_rfgr`` and ``sims.blochsim`` on
    the card: kernels (``backend='cuda'``) against the plain versions
    (``backend='torch'``) on the same CUDA tensors."""
    from mrphy_tpu_torch.ops import sims
    rng = np.random.default_rng(3)
    nS, nT = 500, 64

    def leaf(*shape, scale=1.0):
        return torch.tensor((rng.random(shape) - 0.5) * scale, dtype=dtype,
                            device=cuda, requires_grad=True)

    Mi, loc, vel = leaf(1, nS, 3), leaf(1, nS, 3, scale=8), leaf(1, nS, 3)
    rf, gr = leaf(1, 2, nT, 2, scale=0.3), leaf(1, 3, nT, scale=4)
    df = leaf(1, nS, scale=200)
    b1 = leaf(1, nS, 2, 2)
    W = torch.as_tensor(rng.normal(size=(1, nS, 3)), dtype=dtype,
                        device=cuda)
    kw = dict(T1=torch.tensor(1.0), T2=torch.tensor(0.05), df=df,
              b1Map=b1, vel=vel)
    xs = (Mi, rf, gr, loc, df, b1, vel)
    n0 = dict(bloch.LAUNCHES)
    gk = torch.autograd.grad((W * sims.blochsim_rfgr(
        Mi, rf, gr, loc, backend='cuda', **kw)).sum(), xs)
    assert bloch.LAUNCHES['rfgr_bwd'] == n0['rfgr_bwd'] + 1
    gp = torch.autograd.grad((W * sims.blochsim_rfgr(
        Mi, rf, gr, loc, backend='torch', **kw)).sum(), xs)
    assert bloch.LAUNCHES['rfgr_bwd'] == n0['rfgr_bwd'] + 1
    rel = 1e-5 if dtype == torch.float32 else 1e-10
    for x, y in zip(gk, gp):
        _rows_close(x, y, rel)
    Beff = leaf(1, nS, nT, 3, scale=2)
    gk = torch.autograd.grad((W * sims.blochsim(Mi, Beff,
                                                backend='cuda')).sum(),
                             (Mi, Beff))
    assert bloch.LAUNCHES['beff_bwd'] == n0['beff_bwd'] + 1
    gp = torch.autograd.grad((W * sims.blochsim(Mi, Beff,
                                                backend='torch')).sum(),
                             (Mi, Beff))
    for x, y in zip(gk, gp):
        _rows_close(x, y, rel)


def mc_args(N=2, nS=300, nT=64, nC=2, seed=4, dtype=np.float32):
    r"""Pre-scaled ``mc_fwd`` arguments (numpy): per-voxel planes and
    waveforms of physical size, every third voxel an MT bound pool (T2b
    10 µs, so X ≈ 0), exchange rates varying by voxel."""
    from mrphy_tpu_torch.ops.slowsims import mc_propagators
    rng = np.random.default_rng(seed)
    g2pd = np.full((N, nS), G2PD) * (1 + 0.1 * rng.random((N, nS)))
    T2b = np.full((N, nS), 0.01)
    T2b[:, ::3] = 1e-5
    kab = 3.0 * (1 + rng.random((N, nS)))
    pr = mc_propagators(*(torch.as_tensor(v) for v in (
        1.2, 0.06, 1.0, T2b, kab, 50 * kab, 1.0, 0.02, 4e-6)))
    a = dict(mi6=rng.random((N, 6, nS)) - 0.5,
             rf2=(rng.random((N, 2 * nC, nT)) - 0.5) * 0.1,
             gr2=(rng.random((N, 3, nT)) - 0.5) * 4,
             loc_p=g2pd[:, None] * (rng.random((N, 3, nS)) - 0.5) * 4,
             dfg=2 * np.pi * 4e-6 * (rng.random((N, nS)) - 0.5) * 600,
             b1_p=g2pd[:, None] * (rng.random((N, 2 * nC, nS)) - 0.5),
             sb=np.full((N, nS), 2 * np.pi * 4e-6 * 750.0),
             Xp=torch.stack(pr[:4], 1).numpy(),
             Zp=torch.stack(pr[4:], 1).numpy(), g2pd=g2pd)
    return {k: v.astype(dtype) for k, v in a.items()}


MC_KEYS = ('rf2', 'gr2', 'loc_p', 'dfg', 'b1_p', 'sb', 'Xp', 'Zp', 'g2pd')


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,bar,rows', [(torch.float32, 2e-6, 1e-5),
                                            (torch.float64, 1e-12, 1e-12)])
@pytest.mark.parametrize('nC,b1,dfg', [(2, True, True), (1, False, True),
                                       (3, False, False), (12, True, True)])
def test_mc_kernels_vs_plain_on_card(cuda, dtype, bar, rows, nC, b1, dfg):
    r"""``mc_fwd`` and ``mc_bwd`` against their plain versions: B1 in
    registers (2 coils), no B1 (1 and 3 coils, with and without Δf), and
    B1 of more coils than the register arrays hold (12)."""
    from mrphy_tpu_torch.kernels import mc as kmc
    npdt = np.float32 if dtype == torch.float32 else np.float64
    a = {k: v.to(cuda) for k, v in _tt(mc_args(nC=nC, dtype=npdt)).items()}
    a['b1_p'] = a['b1_p'] if b1 else None
    a['dfg'] = a['dfg'] if dfg else None
    args = tuple(a[k] for k in MC_KEYS)
    n0 = dict(kmc.LAUNCHES)
    chk = kmc.mc_fwd(a['mi6'], *args, tc=16)
    assert kmc.LAUNCHES['mc_fwd'] == n0['mc_fwd'] + 1
    torch.testing.assert_close(chk, kmc.mc_fwd_torch(a['mi6'], *args, tc=16),
                               rtol=0, atol=bar)
    g = torch.as_tensor(np.random.default_rng(5).normal(
        size=tuple(chk.shape)).astype(npdt), device=cuda)
    k = kmc.mc_bwd(chk, g, *args, tc=16)
    assert kmc.LAUNCHES['mc_bwd'] == n0['mc_bwd'] + 1
    p = kmc.mc_bwd_torch(chk, g, *args, tc=16)
    for i, (x, y) in enumerate(zip(k, p)):
        if y is None:
            assert x is None
        elif i in (1, 2):                     # drf2, dgr2: sums over voxels
            _rows_close(x, y, rows)
        else:
            torch.testing.assert_close(x, y, rtol=0, atol=bar)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_mc_engine_gradients_cuda_vs_plain(cuda, dtype):
    r"""Every gradient through ``mc.blochsim_mc_rfgr`` on the card: the
    kernels (``backend='cuda'``) against the plain versions
    (``backend='torch'``) on the same CUDA tensors, the tissue and
    exchange maps included."""
    from mrphy_tpu_torch.kernels import mc as kmc
    from mrphy_tpu_torch.ops import mc
    rng = np.random.default_rng(6)
    nS, nT = 400, 64

    def leaf(*shape, lo=-0.5, hi=0.5):
        return torch.tensor(rng.uniform(lo, hi, shape), dtype=dtype,
                            device=cuda, requires_grad=True)

    pos = (leaf(1, nS, 3), leaf(1, nS, 3, lo=-0.01, hi=0.01),
           leaf(1, 2, nT, 2, lo=-0.05, hi=0.05), leaf(1, 3, nT),
           leaf(1, nS, 3, lo=-4, hi=4))
    kw = dict(df=leaf(1, nS, lo=-300, hi=300), b1Map=leaf(1, nS, 2, 2),
              T1a=leaf(1, nS, lo=1, hi=1.4), T2a=leaf(1, nS, lo=.05, hi=.07),
              T1b=leaf(1, nS, lo=.9, hi=1.1), T2b=leaf(1, nS, lo=1e-5, hi=.01),
              kab=leaf(1, nS, lo=.5, hi=5), kba=leaf(1, nS, lo=25, hi=250),
              Ma0=leaf(1, nS, lo=.9, hi=1.1), Mb0=leaf(1, nS, lo=.01, hi=.03),
              dfb=leaf(1, nS, lo=700, hi=800))
    xs = pos + tuple(kw.values())
    W = torch.as_tensor(rng.normal(size=(2, 1, nS, 3)), dtype=dtype,
                        device=cuda)
    n0 = dict(kmc.LAUNCHES)
    grads = []
    for backend in ('cuda', 'torch'):
        Ma, Mb = mc.blochsim_mc_rfgr(*pos, backend=backend, **kw)
        grads.append(torch.autograd.grad((W[0] * Ma).sum() + (W[1] * Mb)
                                         .sum(), xs))
    assert kmc.LAUNCHES['mc_fwd'] == n0['mc_fwd'] + 1
    assert kmc.LAUNCHES['mc_bwd'] == n0['mc_bwd'] + 1
    rel = 1e-5 if dtype == torch.float32 else 1e-10
    for x, y in zip(*grads):
        assert bool(torch.isfinite(x).all())
        _rows_close(x, y, rel)
