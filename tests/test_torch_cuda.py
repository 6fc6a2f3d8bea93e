r"""The CUDA kernels of :mod:`mrphy_tpu_torch.kernels` on the card (the
Bloch kernels, the two-pool ``mc_fwd``/``mc_bwd``, the k-space signal
kernels ``sig_fwd``/``sig_adj``/``sig_vjp``, the gridding NUFFT's
``nufft_sample``/``nufft_spread``/``nufft_dk``, the EPG trains'
``spgr_*``/``cpmg_*``/``xspgr_*``/``xspgr_v_*``/``xcpmg_*``/``xcpmg_v_*``/
``xmt_*``/``xmt_v_*``, the balanced-SSFP train's ``bssfp_*`` and the
matched filter ``match``): each against its plain PyTorch version,
the launch counts, the wrappers' refusals, and backward through the engines
reaching the adjoint kernels.

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
The signal kernels take sincospi where their plain versions take sin/cos
and sum in another order (the plain versions by matrix products): their
outputs are held at 2e-5 (float32, the bar tests/test_signal.py sets
between two float32 routes) and 1e-12 (float64) of each output's largest
value.
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


def sig_args(N=2, nM=300, nT=97, nC=3, seed=7, dtype=np.float32, df=True,
             t2=True, bcast=True):
    r"""The signal kernels' arguments (numpy): coil-weighted spins ``w2``,
    cotangent rows ``g2``, locations over ±12 cm, a k-space walk of
    readout gradients up to 2 G/cm at 4 µs, Δf ∈ ±100 Hz, T2* ∈ [5, 50]
    ms; with ``bcast`` the per-spin and per-sample inputs have a batch of
    1 (broadcast over N)."""
    rng = np.random.default_rng(seed)
    Nb = 1 if bcast else N
    a = dict(w2=rng.standard_normal((N, 2 * nC, nM)),
             g2=rng.standard_normal((N, 2 * nC, nT)),
             pos=rng.uniform(-12, 12, (Nb, 3, nM)),
             df=rng.uniform(-100, 100, (Nb, nM)) if df else None,
             it2=1 / rng.uniform(5e-3, 5e-2, (Nb, nM)) if t2 else None,
             k=np.cumsum(rng.uniform(-2, 2, (Nb, 3, nT)), -1) * 4257.6 * 4e-6)
    return {k: None if v is None else v.astype(dtype) for k, v in a.items()}


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,bar', [(torch.float32, 2e-5),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize('kw', [dict(nC=1, df=False, t2=False),
                                dict(nC=3, bcast=False),
                                dict(nC=8, N=1, nM=1000, nT=300),
                                dict(nC=32, nM=257, nT=129)],
                         ids=['1coil-bare', '3coil-batched', '8coil',
                              '32coil-ragged'])
def test_signal_kernels_vs_plain_on_card(cuda, dtype, bar, kw):
    r"""``sig_fwd``, ``sig_adj`` and ``sig_vjp`` against their plain
    versions: one coil with neither Δf nor T2*, a batch with per-batch
    inputs, 8 coils (one full group), 32 coils (four groups) on ragged
    sizes."""
    from mrphy_tpu_torch.kernels import signal as ks
    npdt = np.float32 if dtype == torch.float32 else np.float64
    a = {k: None if v is None else torch.as_tensor(v, device=cuda)
         for k, v in sig_args(dtype=npdt, **kw).items()}
    sp = (a['pos'], a['df'], a['it2'], a['k'], 4e-6)
    n0 = dict(ks.LAUNCHES)
    outs = [(ks.sig_fwd(a['w2'], *sp), ks.sig_fwd_torch(a['w2'], *sp)),
            (ks.sig_adj(a['g2'], *sp), ks.sig_adj_torch(a['g2'], *sp)),
            (ks.sig_vjp(a['g2'], a['w2'], *sp),
             ks.sig_vjp_torch(a['g2'], a['w2'], *sp))]
    assert all(ks.LAUNCHES[k] == n0[k] + 1 for k in ks.LAUNCHES)
    for kern, plain in outs:
        for x, y in zip(kern, plain):
            if y is None:
                assert x is None
            else:
                assert x.shape == y.shape
                _rows_close(x, y, bar)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_signal_gradients_cuda_vs_plain(cuda, dtype):
    r"""Every gradient through ``ops.signal.signal`` on the card, the
    kernels (``backend='cuda'``: ``sig_fwd`` + ``sig_vjp``) against the
    plain versions (``backend='torch'``), and ``signal_adjoint`` through
    ``sig_adj``; the wrappers refuse what the kernels do not take."""
    from mrphy_tpu_torch.kernels import signal as ks
    from mrphy_tpu_torch.ops import signal as sig
    rng = np.random.default_rng(8)
    N, nM, nT, nC = 2, 300, 130, 4

    def leaf(*shape, lo=-1.0, hi=1.0):
        return torch.tensor(rng.uniform(lo, hi, shape), dtype=dtype,
                            device=cuda, requires_grad=True)

    xs = (leaf(N, nM, 3), leaf(1, nM, 3, lo=-12, hi=12),
          leaf(N, 3, nT, lo=-0.5, hi=0.5), leaf(1, nM, 2, nC),
          leaf(1, nM, lo=-100, hi=100), leaf(1, nM, lo=5e-3, hi=5e-2))
    W = torch.as_tensor(rng.normal(size=(N, nC, nT, 2)), dtype=dtype,
                        device=cuda)
    n0 = dict(ks.LAUNCHES)
    grads = []
    for backend in ('cuda', 'torch'):
        s = sig.signal(xs[0], xs[1], xs[2], sens=xs[3], df=xs[4], T2s=xs[5],
                       backend=backend)
        grads.append(torch.autograd.grad((W * s).sum(), xs))
    assert ks.LAUNCHES['sig_fwd'] == n0['sig_fwd'] + 1
    assert ks.LAUNCHES['sig_vjp'] == n0['sig_vjp'] + 1
    rel = 2e-5 if dtype == torch.float32 else 1e-10
    for x, y in zip(*grads):
        assert bool(torch.isfinite(x).all())
        _rows_close(x, y, rel)
    assert float(grads[0][0][..., 2].abs().max()) == 0.0
    args = tuple(x.detach() for x in xs[1:3])
    kw = dict(sens=xs[3].detach(), df=xs[4].detach(), T2s=xs[5].detach())
    m_k = sig.signal_adjoint(W, *args, backend='cuda', **kw)
    m_p = sig.signal_adjoint(W, *args, backend='torch', **kw)
    assert ks.LAUNCHES['sig_adj'] == n0['sig_adj'] + 1
    _rows_close(m_k, m_p, rel)
    pos, k = args[0].transpose(1, 2).contiguous(), args[1].contiguous()
    s2 = torch.zeros((N, 4, 2 * nT), dtype=dtype, device=cuda)
    with pytest.raises(ValueError, match='contiguous'):
        ks.sig_adj(s2[..., ::2], pos, None, None, k, 4e-6)
    with pytest.raises(TypeError):
        ks.sig_adj(s2[..., :nT].to(torch.float16), pos, None, None, k, 4e-6)


@pytest.mark.cuda
def test_objects_default_to_the_card_on_card(cuda):
    r"""With no ``device=`` the objects and the numpy builders give CUDA
    tensors."""
    from mrphy_tpu_torch.models.mobjs import Examples, Pulse
    cube = Examples.spincube()
    assert cube.M_.device.type == 'cuda' and cube.loc_.device.type == 'cuda'
    assert Examples.pulse().rf.device.type == 'cuda'
    assert Pulse(rf=np.zeros((1, 2, 4))).rf.device.type == 'cuda'
    assert Examples.spinbolus().vel_.device.type == 'cuda'


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,bar', [(torch.float32, 2e-6),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize('im_size,fov,width,N,Nk', [
    ((16, 12), (24.0, 18.0), 5, 3, 1), ((12, 10, 14), (18.0, 15.0, 21.0),
                                         4, 2, 2),
    ((8, 6, 10), (16.0, 12.0, 20.0), 6, 1, 1),
    ((20, 16), (24.0, 18.0), 3, 2, 2), ((12, 10, 14), (18.0, 15.0, 21.0),
                                        7, 1, 1),
    ((40,), (24.0,), 8, 2, 1)],
    ids=['2d-w5-broadcast-k', '3d-w4-batched-k', '3d-w6', '2d-w3-batched-k',
         '3d-w7', '1d-w8-broadcast-k'])
def test_nufft_kernels_vs_plain_on_card(cuda, dtype, bar, im_size, fov,
                                        width, N, Nk):
    r"""``nufft_sample``, ``nufft_spread`` and ``nufft_dk`` against their
    plain versions on the card, k up to 1.5× the Nyquist box (taps wrap),
    at widths with their own instance (4–6) and through the run-time-width
    instance (3, 7, 8). The spread sums by atomics in another order than
    ``index_add_``: its grid is held at the same relative bar."""
    from mrphy_tpu_torch.kernels import nufft as knf
    from mrphy_tpu_torch.ops import nufft as tnf
    rng = np.random.default_rng(19)
    plan = tnf.nufft_plan(im_size, fov, width=width, device=cuda)
    nT, nG = 333, int(np.prod(plan.grid_size))
    k = np.stack([rng.uniform(-1.5 * n / (2 * f), 1.5 * n / (2 * f),
                              (Nk, nT)) for n, f in zip(im_size, fov)], 1)

    def arr(x):
        return torch.as_tensor(x, dtype=dtype, device=cuda)

    k, grid = arr(k), arr(rng.standard_normal((N, nG, 2)))
    s = arr(rng.standard_normal((N, nT, 2)))
    g = plan.geom
    n0 = dict(knf.LAUNCHES)
    outs = [(knf.nufft_sample(grid, k, g), knf.nufft_sample_torch(grid, k, g)),
            (knf.nufft_spread(s, k, g), knf.nufft_spread_torch(s, k, g)),
            (knf.nufft_dk(grid, k, s, g), knf.nufft_dk_torch(grid, k, s, g))]
    assert all(knf.LAUNCHES[n] == n0[n] + 1 for n in knf.LAUNCHES)
    for x, y in outs:
        assert x.shape == y.shape
        _rows_close(x, y, bar)
    with pytest.raises(ValueError, match='contiguous'):
        knf.nufft_spread(s.transpose(1, 2).contiguous().transpose(1, 2), k,
                         g)
    with pytest.raises(TypeError):
        knf.nufft_sample(grid.half(), k.half(), g)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_nufft_path_on_card(cuda, dtype):
    r"""The NUFFT path on CUDA tensors: ``acquire(backend='nufft')``
    launches ``nufft_sample``; ``nufft``/``nufft_adjoint`` and their
    gradients w.r.t. image, samples and trajectory through the kernels
    (``interp='auto'``) against the plain route (``interp='gather'``)."""
    from mrphy_tpu_torch.kernels import nufft as knf
    from mrphy_tpu_torch.models.mobjs import SpinCube
    from mrphy_tpu_torch.ops import nufft as tnf
    rng = np.random.default_rng(23)
    cube = SpinCube((1, 12, 10, 1), [[24., 20., 1.]], ofst=[[1., -2., 3.]],
                    device=cuda, dtype=dtype)
    cube.M_ = torch.as_tensor(rng.standard_normal((1, cube.nM, 3)),
                              dtype=dtype, device=cuda)
    cube.df_ = torch.as_tensor(rng.uniform(-40, 40, (1, cube.nM)),
                               dtype=dtype, device=cuda)
    gr = torch.as_tensor(rng.uniform(-0.4, 0.4, (1, 3, 200)), dtype=dtype,
                         device=cuda)
    sens = torch.as_tensor(rng.standard_normal((1, cube.nM, 2, 3)),
                           dtype=dtype, device=cuda)
    n0 = knf.LAUNCHES['nufft_sample']
    s = cube.acquire(gr, sens_=sens, T2s_=0.05, backend='nufft', nseg=4)
    assert knf.LAUNCHES['nufft_sample'] == n0 + 4      # one per segment
    assert s.shape == (1, 3, 200, 2) and bool(torch.isfinite(s).all())
    im_size, fov = (10, 8, 12), (15.0, 12.0, 18.0)
    k = torch.as_tensor(np.stack([rng.uniform(-n / (2 * f), n / (2 * f), 150)
                                  for n, f in zip(im_size, fov)]),
                        dtype=dtype, device=cuda)
    img = torch.as_tensor(rng.standard_normal(im_size + (2,)), dtype=dtype,
                          device=cuda)
    y = torch.as_tensor(rng.standard_normal((150, 2)), dtype=dtype,
                        device=cuda)
    grads = []
    for interp in ('auto', 'gather'):
        plan = tnf.nufft_plan(im_size, fov, width=4, osf=1.5, dtype=dtype,
                              interp=interp, device=cuda)
        xs = (img.clone().requires_grad_(), y.clone().requires_grad_(),
              k.clone().requires_grad_())
        loss = ((tnf.nufft(plan, xs[0], xs[2]) ** 2).sum()
                + (tnf.nufft_adjoint(plan, xs[1], xs[2]) ** 2).sum())
        grads.append(torch.autograd.grad(loss, xs))
    rel = 1e-5 if dtype == torch.float32 else 1e-10
    for a, b in zip(*grads):
        _rows_close(a, b, rel)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,bar', [(torch.float32, 2e-5),
                                       (torch.float64, 1e-12)])
def test_nufft_toeplitz_and_dcf_on_card(cuda, dtype, bar):
    r"""``toeplitz_kernel`` (weighted, 3-D) and ``dcf_pipe_menon`` (2-D,
    48 spokes at random angles, 65 samples at random radii: off the
    lattice, so float32 and float64 take the same taps) on CUDA tensors
    against float64 on the CPU: the Toeplitz products in full float32
    (TF32 would miss the bar by ~50×), the Pipe–Menon iteration through
    ``nufft_spread`` then ``nufft_sample``."""
    from mrphy_tpu_torch.kernels import nufft as knf
    from mrphy_tpu_torch.ops import nufft as tnf
    rng = np.random.default_rng(29)
    im_size, fov = (10, 8, 12), (15.0, 12.0, 18.0)
    k = np.stack([rng.uniform(-n / (2 * f), n / (2 * f), 301)
                  for n, f in zip(im_size, fov)])
    w = rng.uniform(0.2, 1.0, 301)
    outs = []
    for dev, dt in ((cuda, dtype), ('cpu', torch.float64)):
        plan = tnf.nufft_plan(im_size, fov, dtype=dt, device=dev)
        outs.append(tnf.toeplitz_kernel(
            plan, torch.as_tensor(k, dtype=dt, device=dev),
            weights=torch.as_tensor(w, dtype=dt, device=dev), chunk=128))
    _rows_close(outs[0].cpu().double(), outs[1], bar)
    n, fv = 16, 24.0
    th = rng.uniform(0, np.pi, (48, 1))
    r = n / (2 * fv) * rng.uniform(-1, 1, (48, 65))
    k = np.stack([(np.cos(th) * r).reshape(-1), (np.sin(th) * r).reshape(-1)])
    outs = []
    n0 = dict(knf.LAUNCHES)
    for dev, dt in ((cuda, dtype), ('cpu', torch.float64)):
        plan = tnf.nufft_plan((n, n), (fv, fv), dtype=dt, device=dev)
        outs.append(tnf.dcf_pipe_menon(
            plan, torch.as_tensor(k, dtype=dt, device=dev), iters=20))
    assert knf.LAUNCHES['nufft_spread'] >= n0['nufft_spread'] + 20
    assert knf.LAUNCHES['nufft_sample'] >= n0['nufft_sample'] + 20
    _rows_close(outs[0].cpu().double(), outs[1],
                1e-4 if dtype == torch.float32 else 1e-10)


@pytest.mark.cuda
def test_nufft_spread_refuses_under_deterministic_algorithms(cuda):
    r"""``nufft_spread`` sums with atomics: under
    ``torch.use_deterministic_algorithms(True)`` its launch raises, on the
    wrapper and through the adjoint's and the sample stage's autograd
    (whose backward spreads), and under ``warn_only=True`` it warns and
    runs."""
    from mrphy_tpu_torch.kernels import nufft as knf
    from mrphy_tpu_torch.ops import nufft as tnf
    rng = np.random.default_rng(31)
    plan = tnf.nufft_plan((12, 10), (18.0, 15.0), device=cuda)
    k = torch.as_tensor(rng.uniform(-0.3, 0.3, (2, 77)), dtype=torch.float32,
                        device=cuda)
    s = torch.as_tensor(rng.standard_normal((77, 2)), dtype=torch.float32,
                        device=cuda)
    img = torch.zeros((12, 10, 2), device=cuda, requires_grad=True)
    was = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    n0 = knf.LAUNCHES['nufft_spread']
    try:
        torch.use_deterministic_algorithms(True)
        with pytest.raises(RuntimeError, match='atomicAdd'):
            tnf.nufft_adjoint(plan, s, k)
        with pytest.raises(RuntimeError, match='atomicAdd'):
            tnf.nufft(plan, img, k).sum().backward()
        assert knf.LAUNCHES['nufft_spread'] == n0
        torch.use_deterministic_algorithms(True, warn_only=True)
        with pytest.warns(UserWarning, match='atomicAdd'):
            out = tnf.nufft_adjoint(plan, s, k)
        assert knf.LAUNCHES['nufft_spread'] == n0 + 1
        assert bool(torch.isfinite(out).all())
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn)


def _spgr_case(cuda, dtype, nA, nTR, K, kshift, b1, vartr, D, seed):
    r"""``epg_spgr`` keywords (CUDA tensors): an rf-spoiled train with IR
    prep and, as asked, per-atom b1, a variable TR/TE and diffusion."""
    from mrphy_tpu_torch.ops import epg
    rng = np.random.default_rng(seed)

    def arr(x):
        return torch.as_tensor(x, dtype=dtype, device=cuda)

    T1 = arr(rng.uniform(0.2, 3.0, nA))
    kw = dict(flips=arr(rng.uniform(0.1, 1.2, nTR)),
              phis=epg.rf_spoil_phases(nTR, dtype=dtype, device=cuda), T1=T1,
              T2=arr(rng.uniform(0.02, 0.4, nA)),
              tr=arr(rng.uniform(0.008, 0.016, nTR)) if vartr else 0.012,
              te=arr(rng.uniform(1e-3, 4e-3, nTR)) if vartr else 2e-3,
              zinit=epg.ir_prep(0.018, T1), kshift=kshift, K=K)
    if b1:
        kw['b1'] = arr(rng.uniform(0.8, 1.2, nA))
    if D:
        kw.update(D=arr(rng.uniform(0.4e-5, 3.2e-5, nA)), dk=450.0)
    return kw


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,bar,rows', [(torch.float32, 2e-6, 1e-4),
                                            (torch.float64, 1e-12, 1e-12)])
@pytest.mark.parametrize('nA,nTR,K,kshift,b1,vartr,D', [
    (333, 40, 12, 1, False, True, False), (200, 36, 10, -1, True, False,
                                           False),
    (129, 30, 9, 2, True, True, True), (65, 60, None, 1, False, True, True)],
    ids=['var-tr', 'b1-kshift-1', 'b1-var-tr-diffusion-kshift2',
         'default-K-diffusion'])
def test_spgr_kernels_vs_plain_on_card(cuda, dtype, bar, rows, nA, nTR, K,
                                       kshift, b1, vartr, D):
    r"""``spgr_fwd``, ``spgr_fwd_chk`` and ``spgr_bwd`` against their plain
    versions on the card (per-atom outputs at ``bar``, the adjoint's
    per-TR rows, summed over atoms by warps, at ``rows`` of their largest
    value), over several chunks; the launch counts; the refusals."""
    from mrphy_tpu_torch.kernels import epg as kepg
    from mrphy_tpu_torch.ops import epg
    from mrphy_tpu_torch.utils._shapes import largest_divisor_leq
    kw = _spgr_case(cuda, dtype, nA, nTR, K, kshift, b1, vartr, D, 37)
    coef, par, cdiff, cfg, _ = epg._spgr_rows(**kw)
    coef, par = coef.contiguous(), par.contiguous()
    tc = largest_divisor_leq(nTR, nTR // 3)          # three chunks or more
    n0 = dict(kepg.LAUNCHES)
    sig = kepg.spgr_fwd(coef, par, cdiff, cfg)
    sig2, chk = kepg.spgr_fwd_chk(coef, par, cdiff, cfg, tc=tc)
    g = torch.as_tensor(np.random.default_rng(3).standard_normal(
        sig.shape), dtype=dtype, device=cuda)
    dcoef, dpar = kepg.spgr_bwd(coef, par, cdiff, cfg, chk, g, tc=tc)
    assert {n: kepg.LAUNCHES[n] - n0[n] for n in kepg.LAUNCHES} == dict(
        dict.fromkeys(kepg.LAUNCHES, 0), spgr_fwd=1, spgr_fwd_chk=1,
        spgr_bwd=1)
    sig_p, chk_p = kepg.spgr_fwd_chk_torch(coef, par, cdiff, cfg, tc=tc)
    dcoef_p, dpar_p = kepg.spgr_bwd_torch(coef, par, cdiff, cfg, chk_p, g,
                                          tc=tc)
    for x, y in ((sig, sig_p), (sig2, sig_p), (chk, chk_p), (dpar, dpar_p)):
        _rows_close(x, y, bar)
    _rows_close(dcoef, dcoef_p, rows)
    with pytest.raises(ValueError, match='contiguous'):
        kepg.spgr_fwd(coef.T.contiguous().T, par, cdiff, cfg)
    with pytest.raises(TypeError):
        kepg.spgr_fwd(coef.half(), par.half(), cdiff.half(), cfg)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_epg_spgr_gradients_cuda_vs_plain(cuda, dtype):
    r"""``epg_spgr`` on CUDA tensors runs ``spgr_fwd`` for a value and
    ``spgr_fwd_chk`` + ``spgr_bwd`` under a gradient, whose gradients
    w.r.t. every input meet the plain route's."""
    from mrphy_tpu_torch.kernels import epg as kepg
    from mrphy_tpu_torch.ops import epg
    names = ('flips', 'phis', 'T1', 'T2', 'tr', 'te', 'b1', 'D')
    kw = _spgr_case(cuda, dtype, 70, 24, 8, -1, True, True, True, 41)
    w = torch.as_tensor(np.random.default_rng(5).standard_normal((70, 24, 2)),
                        dtype=dtype, device=cuda)
    grads = []
    for backend in ('auto', 'torch'):
        xs = {n: kw[n].detach().clone().requires_grad_() for n in names}
        n0 = dict(kepg.LAUNCHES)
        out = epg.epg_spgr(**dict(kw, **xs, zinit=epg.ir_prep(0.018,
                                                              xs['T1'])),
                           backend=backend)
        grads.append(torch.autograd.grad((w * out).sum(), list(xs.values())))
        launched = {n: kepg.LAUNCHES[n] - n0[n] for n in kepg.LAUNCHES}
        assert launched == dict(dict.fromkeys(kepg.LAUNCHES, 0),
                                **({'spgr_fwd_chk': 1, 'spgr_bwd': 1}
                                   if backend == 'auto' else {}))
    n0 = kepg.LAUNCHES['spgr_fwd']
    with torch.no_grad():
        epg.epg_spgr(**kw)
    assert kepg.LAUNCHES['spgr_fwd'] == n0 + 1
    bar = 1e-4 if dtype == torch.float32 else 1e-10
    for n, x, y in zip(names, *grads):
        _rows_close(x, y, bar)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,bar', [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize('nA,nV,r,pair', [(1000, 3001, 16, True),
                                          (77, 130, 5, True),
                                          (513, 700, 37, False)])
def test_match_kernel_vs_plain_on_card(cuda, dtype, bar, nA, nV, r, pair):
    r"""``match`` against its plain version on the card: the best scores
    at ``bar`` of the largest, the atoms equal (random atoms: no
    near-ties); through ``dict_match_compressed`` on CUDA tensors the
    kernel runs."""
    from mrphy_tpu_torch.kernels import mrf as kmrf
    from mrphy_tpu_torch.ops import mrf
    rng = np.random.default_rng(43)

    def arr(x):
        return torch.as_tensor(x, dtype=dtype, device=cuda)

    D = arr(rng.standard_normal((nA, r)))
    D = D / torch.linalg.vector_norm(D, dim=1, keepdim=True)
    Dim = arr(rng.standard_normal((nA, r))) if pair else None
    X = arr(rng.standard_normal((nV, r)))
    n0 = kmrf.LAUNCHES['match']
    ik, bk = kmrf.match(D, Dim, X, pairlike=pair)
    assert kmrf.LAUNCHES['match'] == n0 + 1 and ik.dtype == torch.int32
    ip, bp = kmrf.match_torch(D, Dim, X, pairlike=pair, chunk=256)
    assert torch.equal(ik, ip)
    _rows_close(bk, bp, bar)
    if pair:
        B = torch.linalg.qr(arr(rng.standard_normal((2 * r, r))))[0]
        J = torch.zeros((2 * r, 2 * r), dtype=dtype, device=cuda)
        J[1::2, 0::2] = torch.eye(r, dtype=dtype, device=cuda)
        J[0::2, 1::2] = -torch.eye(r, dtype=dtype, device=cuda)
        basis = mrf.Basis(B=B, jc=B.T @ J @ B, s=torch.ones(2 * r,
                                                           dtype=dtype,
                                                           device=cuda),
                          tail=(r, 2))
        res = mrf.dict_match_compressed(D, X, basis)
        ref = mrf.dict_match_compressed(D.cpu(), X.cpu(), mrf.Basis(
            *(None if v is None else v.cpu() if torch.is_tensor(v) else v
              for v in basis)))
        assert kmrf.LAUNCHES['match'] == n0 + 2
        assert torch.equal(res.idx.cpu(), ref.idx)
        _rows_close(res.m0.cpu(), ref.m0, 1e2 * bar)


def _cpmg_case(cuda, dtype, nA, nE, b1, varesp, D, ex, seed):
    r"""``(flips, epg_cpmg keywords)`` (CUDA tensors): refocusing flips of
    120-180° and, as asked, per-atom b1, an esp train, diffusion and a
    per-voxel excitation with M0."""
    rng = np.random.default_rng(seed)

    def arr(x):
        return torch.as_tensor(x, dtype=dtype, device=cuda)

    kw = dict(T1=arr(rng.uniform(0.2, 3.0, nA)),
              T2=arr(rng.uniform(0.02, 0.4, nA)),
              esp=arr(rng.uniform(0.008, 0.012, nE)) if varesp else 0.01)
    if b1:
        kw['b1'] = arr(rng.uniform(0.7, 1.15, nA))
    if D:
        kw.update(D=arr(rng.uniform(0.5e-5, 3e-5, nA)), dk=450.0)
    if ex:
        kw.update(alpha_ex=arr(rng.uniform(1.0, 1.7, nA)),
                  phi_ex=arr(rng.uniform(0, 6, nA)),
                  M0=arr(rng.uniform(0.7, 1.2, nA)))
    return arr(np.deg2rad(rng.uniform(120, 180, nE))), kw


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,bar,rows', [(torch.float32, 2e-6, 1e-4),
                                            (torch.float64, 1e-12, 1e-12)])
@pytest.mark.parametrize('nA,nE,b1,varesp,D,ex', [
    (333, 24, False, False, False, False),
    (200, 30, True, True, True, True), (129, 12, False, True, False, True),
    (65, 330, True, False, True, False)],
    ids=['plain-train', 'every-option', 'esp-train-excitation',
         'device-memory-state'])
def test_cpmg_kernels_vs_plain_on_card(cuda, dtype, bar, rows, nA, nE, b1,
                                       varesp, D, ex):
    r"""``cpmg_fwd``, ``cpmg_fwd_chk`` and ``cpmg_bwd`` against their plain
    versions on the card (per-atom outputs at ``bar``, the adjoint's
    per-echo rows, summed over atoms by warps, at ``rows`` of their largest
    value), over several chunks; the launch counts; the refusals."""
    from mrphy_tpu_torch.kernels import epg as kepg
    from mrphy_tpu_torch.ops import epg
    from mrphy_tpu_torch.utils._shapes import largest_divisor_leq
    flips, kw = _cpmg_case(cuda, dtype, nA, nE, b1, varesp, D, ex, 37)
    coef, par, dq, cdiff, cfg, _ = epg._cpmg_rows(flips, **kw)
    args = (coef.contiguous(), par.contiguous(), dq.contiguous(), cdiff, cfg)
    tc = largest_divisor_leq(nE, nE // 3)            # three chunks or more
    n0 = dict(kepg.LAUNCHES)
    er, ei = kepg.cpmg_fwd(*args)
    er2, ei2, chk = kepg.cpmg_fwd_chk(*args, tc=tc)
    gr, gi = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (2, nE, nA)), dtype=dtype, device=cuda)
    dcoef, dpar = kepg.cpmg_bwd(*args, chk, gr, gi, tc=tc)
    assert {n: kepg.LAUNCHES[n] - n0[n] for n in kepg.LAUNCHES} == dict(
        dict.fromkeys(kepg.LAUNCHES, 0), cpmg_fwd=1, cpmg_fwd_chk=1,
        cpmg_bwd=1)
    er_p, ei_p, chk_p = kepg.cpmg_fwd_chk_torch(*args, tc=tc)
    dcoef_p, dpar_p = kepg.cpmg_bwd_torch(*args, chk_p, gr, gi, tc=tc)
    for x, y in ((er, er_p), (ei, ei_p), (er2, er_p), (ei2, ei_p),
                 (chk, chk_p), (dpar, dpar_p)):
        _rows_close(x, y, bar)
    _rows_close(dcoef, dcoef_p, rows)
    with pytest.raises(ValueError, match='contiguous'):
        kepg.cpmg_fwd(args[0].T.contiguous().T, *args[1:])
    with pytest.raises(TypeError):
        kepg.cpmg_fwd(*(x.half() for x in args[:4]), cfg)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_epg_cpmg_gradients_cuda_vs_plain(cuda, dtype):
    r"""``epg_cpmg`` on CUDA tensors runs ``cpmg_fwd`` for a value and
    ``cpmg_fwd_chk`` + ``cpmg_bwd`` under a gradient, whose gradients
    w.r.t. every input meet the plain route's; ``backend='cuda'`` refuses
    a per-voxel 2-D train, and CPU tensors."""
    from mrphy_tpu_torch.kernels import epg as kepg
    from mrphy_tpu_torch.ops import epg
    names = ('flips', 'T1', 'T2', 'esp', 'M0', 'alpha_ex', 'phi_ex', 'b1',
             'D')
    flips, kw = _cpmg_case(cuda, dtype, 70, 24, True, True, True, True, 41)
    kw['flips'] = flips
    w = torch.as_tensor(np.random.default_rng(5).standard_normal((70, 24, 2)),
                        dtype=dtype, device=cuda)
    grads = []
    for backend in ('auto', 'torch'):
        xs = {n: kw[n].detach().clone().requires_grad_() for n in names}
        n0 = dict(kepg.LAUNCHES)
        out = epg.epg_cpmg(**dict(kw, **xs), backend=backend)
        grads.append(torch.autograd.grad((w * out).sum(), list(xs.values())))
        launched = {n: kepg.LAUNCHES[n] - n0[n] for n in kepg.LAUNCHES}
        assert launched == dict(dict.fromkeys(kepg.LAUNCHES, 0),
                                **({'cpmg_fwd_chk': 1, 'cpmg_bwd': 1}
                                   if backend == 'auto' else {}))
    n0 = kepg.LAUNCHES['cpmg_fwd']
    with torch.no_grad():
        epg.epg_cpmg(**kw)
    assert kepg.LAUNCHES['cpmg_fwd'] == n0 + 1
    bar = 1e-4 if dtype == torch.float32 else 1e-10
    for n, x, y in zip(names, *grads):
        _rows_close(x, y, bar)
    with pytest.raises(ValueError, match='per-voxel trains'):
        epg.epg_cpmg(**dict(kw, flips=flips.expand(70, 24)), backend='cuda')
    with pytest.raises(ValueError, match='CUDA tensors'):
        epg.epg_cpmg(flips.cpu(), T1=1.0, T2=0.1, esp=0.01, backend='cuda')


def _xspgr_case(cuda, dtype, nA, nTR, K, kshift, b1, seed, vartr=False):
    r"""``epgx_spgr`` keywords (CUDA tensors): an rf-spoiled train over a
    two-pool system with per-atom rates, M0b and dfb and, as asked, b1 and
    a ``(nTR,)`` tr train (8-16 ms) in place of tr 12 ms."""
    from mrphy_tpu_torch.ops import epg
    rng = np.random.default_rng(seed)

    def arr(x):
        return torch.as_tensor(x, dtype=dtype, device=cuda)

    kw = dict(flips=arr(rng.uniform(0.1, 1.2, nTR)),
              phis=epg.rf_spoil_phases(nTR, dtype=dtype, device=cuda),
              T1a=arr(rng.uniform(0.2, 3.0, nA)),
              T2a=arr(rng.uniform(0.02, 0.5, nA)),
              T1b=arr(rng.uniform(0.2, 0.6, nA)),
              T2b=arr(rng.uniform(0.005, 0.03, nA)),
              kab=arr(rng.uniform(1.0, 10.0, nA)),
              kba=arr(rng.uniform(5.0, 40.0, nA)),
              M0a=arr(rng.uniform(0.8, 1.2, nA)),
              M0b=arr(rng.uniform(0.05, 0.3, nA)),
              dfb=arr(rng.uniform(-20, 20, nA)), tr=0.012, kshift=kshift,
              K=K)
    if b1:
        kw['b1'] = arr(rng.uniform(0.8, 1.2, nA))
    if vartr:
        kw['tr'] = arr(rng.uniform(0.008, 0.016, nTR))
    return kw


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,bar,rows', [(torch.float32, 2e-6, 1e-4),
                                            (torch.float64, 1e-12, 1e-12)])
@pytest.mark.parametrize('nA,nTR,K,kshift,b1', [
    (333, 40, 12, 1, False), (200, 36, 10, -1, True), (129, 30, 9, 2, True),
    (65, 160, None, 1, False)],
    ids=['plain-train', 'b1-kshift-1', 'b1-kshift2',
         'default-K-device-memory-state'])
def test_xspgr_kernels_vs_plain_on_card(cuda, dtype, bar, rows, nA, nTR, K,
                                        kshift, b1):
    r"""``xspgr_fwd``, ``xspgr_fwd_chk`` and ``xspgr_bwd`` against their
    plain versions on the card (per-atom outputs at ``bar``, the adjoint's
    per-TR rows, summed over atoms by warps, at ``rows`` of their largest
    value), over several chunks; the launch counts; the refusals."""
    from mrphy_tpu_torch.kernels import epgx as kx
    from mrphy_tpu_torch.ops import epg
    from mrphy_tpu_torch.utils._shapes import largest_divisor_leq
    kw = _xspgr_case(cuda, dtype, nA, nTR, K, kshift, b1, 37)
    coef, par, cfg, _ = epg._xspgr_rows(kw.pop('flips'), kw.pop('phis'),
                                        **kw)
    coef, par = coef.contiguous(), par.contiguous()
    tc = largest_divisor_leq(nTR, nTR // 3)          # three chunks or more
    n0 = dict(kx.LAUNCHES)
    sig = kx.xspgr_fwd(coef, par, cfg)
    sig2, chk = kx.xspgr_fwd_chk(coef, par, cfg, tc=tc)
    g = torch.as_tensor(np.random.default_rng(3).standard_normal(
        sig.shape), dtype=dtype, device=cuda)
    dcoef, dpar = kx.xspgr_bwd(coef, par, cfg, chk, g, tc=tc)
    assert {n: kx.LAUNCHES[n] - n0[n] for n in kx.LAUNCHES} == dict(
        dict.fromkeys(kx.LAUNCHES, 0), xspgr_fwd=1, xspgr_fwd_chk=1,
        xspgr_bwd=1)
    sig_p, chk_p = kx.xspgr_fwd_chk_torch(coef, par, cfg, tc=tc)
    dcoef_p, dpar_p = kx.xspgr_bwd_torch(coef, par, cfg, chk_p, g, tc=tc)
    for x, y in ((sig, sig_p), (sig2, sig_p), (chk, chk_p), (dpar, dpar_p)):
        _rows_close(x, y, bar)
    _rows_close(dcoef, dcoef_p, rows)
    with pytest.raises(ValueError, match='contiguous'):
        kx.xspgr_fwd(coef.T.contiguous().T, par, cfg)
    with pytest.raises(TypeError):
        kx.xspgr_fwd(coef.half(), par.half(), cfg)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('vartr', [False, True], ids=['tr', 'tr-train'])
def test_epgx_spgr_gradients_cuda_vs_plain(cuda, dtype, vartr):
    r"""``epgx_spgr`` on CUDA tensors runs ``xspgr_fwd`` for a value and
    ``xspgr_fwd_chk`` + ``xspgr_bwd`` under a gradient at a scalar tr, and
    ``xspgr_v_fwd``, or ``xspgr_v_fwd_chk`` + ``xspgr_v_bwd``, over a
    ``(nTR,)`` tr train, under ``backend='auto'`` and ``'cuda'``; their
    gradients w.r.t. every input (each element of the tr train among them)
    meet the plain route's; ``backend='cuda'`` refuses CPU tensors."""
    from mrphy_tpu_torch.kernels import epgx as kx
    from mrphy_tpu_torch.ops import epg
    names = ('flips', 'phis', 'T1a', 'T2a', 'T1b', 'T2b', 'kab', 'kba', 'tr',
             'M0a', 'M0b', 'dfb', 'b1')
    kw = _xspgr_case(cuda, dtype, 70, 24, 8, -1, True, 41, vartr=vartr)
    if not vartr:
        kw['tr'] = torch.tensor(0.012, dtype=dtype, device=cuda)
    v = '_v' if vartr else ''
    w = torch.as_tensor(np.random.default_rng(5).standard_normal((70, 24, 2)),
                        dtype=dtype, device=cuda)
    grads = []
    for backend in ('auto', 'cuda', 'torch'):
        xs = {n: kw[n].detach().clone().requires_grad_() for n in names}
        n0 = dict(kx.LAUNCHES)
        out = epg.epgx_spgr(**dict(kw, **xs), backend=backend)
        grads.append(torch.autograd.grad((w * out).sum(), list(xs.values())))
        launched = {n: kx.LAUNCHES[n] - n0[n] for n in kx.LAUNCHES}
        assert launched == dict(
            dict.fromkeys(kx.LAUNCHES, 0),
            **({f'xspgr{v}_fwd_chk': 1, f'xspgr{v}_bwd': 1}
               if backend != 'torch' else {}))
    n0 = dict(kx.LAUNCHES)
    with torch.no_grad():
        epg.epgx_spgr(**kw)
    assert {n: kx.LAUNCHES[n] - n0[n] for n in kx.LAUNCHES} == dict(
        dict.fromkeys(kx.LAUNCHES, 0), **{f'xspgr{v}_fwd': 1})
    bar = 1e-4 if dtype == torch.float32 else 1e-10
    for g in grads[:2]:
        for n, x, y in zip(names, g, grads[2]):
            _rows_close(x, y, bar)
    with pytest.raises(ValueError, match='CUDA tensors'):
        epg.epgx_spgr(kw['flips'].cpu(), T1a=1.0, T2a=0.08, T1b=1.0,
                      T2b=0.02, kab=5.0, kba=20.0,
                      tr=kw['tr'].cpu() if vartr else 0.01, backend='cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,bar,rows', [(torch.float32, 2e-6, 1e-4),
                                            (torch.float64, 1e-12, 1e-12)])
@pytest.mark.parametrize('nA,nTR,K,kshift,b1', [
    (333, 40, 12, 1, False), (200, 36, 10, -1, True), (129, 30, 9, 2, True),
    (65, 160, None, 1, False)],
    ids=['plain-train', 'b1-kshift-1', 'b1-kshift2',
         'default-K-device-memory-state'])
def test_xspgr_v_kernels_vs_plain_on_card(cuda, dtype, bar, rows, nA, nTR, K,
                                          kshift, b1):
    r"""``xspgr_v_fwd``, ``xspgr_v_fwd_chk`` and ``xspgr_v_bwd`` against
    their plain versions on the card over a ``(nTR,)`` tr train (per-atom
    outputs, ``dpkt`` per atom and step among them, at ``bar``, the
    adjoint's per-TR rows at ``rows`` of their largest value), over several
    chunks; the launch counts; the refusals."""
    from mrphy_tpu_torch.kernels import epgx as kx
    from mrphy_tpu_torch.ops import epg
    from mrphy_tpu_torch.utils._shapes import largest_divisor_leq
    kw = _xspgr_case(cuda, dtype, nA, nTR, K, kshift, b1, 37, vartr=True)
    coef, (pk, pkt), cfg, _ = epg._xspgr_rows(kw.pop('flips'),
                                              kw.pop('phis'), **kw)
    coef, pk, pkt = coef.contiguous(), pk.contiguous(), pkt.contiguous()
    tc = largest_divisor_leq(nTR, nTR // 3)          # three chunks or more
    n0 = dict(kx.LAUNCHES)
    sig = kx.xspgr_v_fwd(coef, pk, pkt, cfg)
    sig2, chk = kx.xspgr_v_fwd_chk(coef, pk, pkt, cfg, tc=tc)
    g = torch.as_tensor(np.random.default_rng(3).standard_normal(
        sig.shape), dtype=dtype, device=cuda)
    dcoef, dpk, dpkt = kx.xspgr_v_bwd(coef, pk, pkt, cfg, chk, g, tc=tc)
    assert {n: kx.LAUNCHES[n] - n0[n] for n in kx.LAUNCHES} == dict(
        dict.fromkeys(kx.LAUNCHES, 0), xspgr_v_fwd=1, xspgr_v_fwd_chk=1,
        xspgr_v_bwd=1)
    sig_p, chk_p = kx.xspgr_v_fwd_chk_torch(coef, pk, pkt, cfg, tc=tc)
    dcoef_p, dpk_p, dpkt_p = kx.xspgr_v_bwd_torch(coef, pk, pkt, cfg, chk_p,
                                                  g, tc=tc)
    assert dpk.shape == (3, nA) and dpkt.shape == (nTR, 14, nA)
    for x, y in ((sig, sig_p), (sig2, sig_p), (chk, chk_p), (dpk, dpk_p),
                 (dpkt, dpkt_p)):
        _rows_close(x, y, bar)
    _rows_close(dcoef, dcoef_p, rows)
    with pytest.raises(ValueError, match='pkt'):
        kx.xspgr_v_fwd(coef, pk, pkt[1:], cfg)
    with pytest.raises(ValueError, match='pk'):
        kx.xspgr_v_fwd(coef, pk[:2].contiguous(), pkt, cfg)
    with pytest.raises(TypeError):
        kx.xspgr_v_fwd(coef.half(), pk.half(), pkt.half(), cfg)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_xspgr_v_constant_train_equals_xspgr_on_card(cuda, dtype):
    r"""Over a constant ``(nTR,)`` train the variable-TR kernels' echoes
    equal the fixed-TR kernel's (``xspgr_fwd``) at the same scalar tr: the
    per-step planes repeat the per-atom rows bit for bit."""
    from mrphy_tpu_torch.kernels import epgx as kx
    from mrphy_tpu_torch.ops import epg
    kw = _xspgr_case(cuda, dtype, 150, 30, 10, 1, True, 43)
    fl, ph = kw.pop('flips'), kw.pop('phis')
    coef, par, cfg, _ = epg._xspgr_rows(fl, ph, **kw)
    coef_v, (pk, pkt), cfg_v, _ = epg._xspgr_rows(
        fl, ph, **dict(kw, tr=torch.full((30,), 0.012, dtype=dtype,
                                         device=cuda)))
    assert cfg_v == cfg and torch.equal(pkt[7], par[:14])
    sig = kx.xspgr_fwd(coef.contiguous(), par.contiguous(), cfg)
    assert torch.equal(kx.xspgr_v_fwd(coef_v, pk.contiguous(), pkt, cfg),
                       sig)
    assert torch.equal(kx.xspgr_v_fwd_chk(coef_v, pk.contiguous(), pkt, cfg,
                                          tc=10)[0], sig)


# The adjoints' two routes (kernels/epg.py adjoint_cfg): the lanes where an
# atom's orders fit the slots and the chunk the shared states, one thread
# per atom otherwise; at a ragged nA, K not a multiple of the group's
# lanes, and in float64.
ADJOINT_ROUTE_CASES = [
    (torch.float32, 2e-6, 1e-4, 2, 'lanes'),
    (torch.float32, 2e-6, 1e-4, 16, 'thread'),
    (torch.float64, 1e-12, 1e-12, 4, 'lanes'),
    (torch.float64, 1e-12, 1e-12, 16, 'thread')]
ADJOINT_ROUTE_IDS = ['f32-lanes', 'f32-thread', 'f64-lanes', 'f64-thread']


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,bar,rows,tc,route', ADJOINT_ROUTE_CASES,
                         ids=ADJOINT_ROUTE_IDS)
def test_cpmg_bwd_routes_on_card(cuda, dtype, bar, rows, tc, route):
    r"""``cpmg_bwd`` on both routes against its plain version (which sums
    over the orders in the route's order) at 1,001 atoms × 32 echoes (K 33:
    8 lanes of 5 slots in float32, 32 of 2 in float64), every option; one
    launch each."""
    from mrphy_tpu_torch.kernels import epg as kepg
    from mrphy_tpu_torch.ops import epg
    flips, kw = _cpmg_case(cuda, dtype, 1001, 32, True, True, True, True, 47)
    coef, par, dq, cdiff, cfg, _ = epg._cpmg_rows(flips, **kw)
    args = (coef.contiguous(), par.contiguous(), dq.contiguous(), cdiff, cfg)
    assert kepg.adjoint_cfg(cfg.K, par.element_size(), 6,
                            tc).route == route
    chk = kepg.cpmg_fwd_chk(*args, tc=tc)[2]
    gr, gi = torch.as_tensor(np.random.default_rng(4).standard_normal(
        (2, 32, 1001)), dtype=dtype, device=cuda)
    n0 = kepg.LAUNCHES['cpmg_bwd']
    dcoef, dpar = kepg.cpmg_bwd(*args, chk, gr, gi, tc=tc)
    assert kepg.LAUNCHES['cpmg_bwd'] == n0 + 1
    dcoef_p, dpar_p = kepg.cpmg_bwd_torch(*args, chk, gr, gi, tc=tc)
    _rows_close(dpar, dpar_p, bar)
    _rows_close(dcoef, dcoef_p, rows)


# K21's cases add (K, kshift): K 37 / 29 at kshift 2, and the lane route
# at shifts of more orders than the group has lanes (K 24 in float32: 8
# lanes of 3 slots), which run in pieces of at most 7 lanes.
XSPGR_ROUTE_CASES = [c + ((37 if c[0] == torch.float32 else 29), 2)
                     for c in ADJOINT_ROUTE_CASES] + [
    (torch.float32, 2e-6, 1e-4, 4, 'lanes', 24, ks) for ks in (-9, 9, -17)]
XSPGR_ROUTE_IDS = ADJOINT_ROUTE_IDS + [
    f'f32-lanes-K24-kshift{ks}' for ks in (-9, 9, -17)]


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,bar,rows,tc,route,K,kshift',
                         XSPGR_ROUTE_CASES, ids=XSPGR_ROUTE_IDS)
@pytest.mark.parametrize('vartr', [False, True], ids=['tr', 'tr-train'])
def test_xspgr_bwd_routes_on_card(cuda, dtype, bar, rows, tc, route, K,
                                  kshift, vartr):
    r"""``xspgr_bwd`` and ``xspgr_v_bwd`` on both routes against their plain
    versions at 1,001 atoms × 32 TRs, b1: kshift 2 (K 37 in float32: 16
    lanes of 3 slots; K 29 in float64: 32 lanes of 1), and the lane route
    at kshift ±9 and −17 (K 24: 8 lanes of 3); one launch each."""
    from mrphy_tpu_torch.kernels import epg as kepg
    from mrphy_tpu_torch.kernels import epgx as kx
    from mrphy_tpu_torch.ops import epg
    kw = _xspgr_case(cuda, dtype, 1001, 32, K, kshift, True, 49, vartr=vartr)
    coef, par, cfg, _ = epg._xspgr_rows(kw.pop('flips'), kw.pop('phis'),
                                        **kw)
    assert kepg.adjoint_cfg(K, coef.element_size(), 12, tc).route == route
    g = torch.as_tensor(np.random.default_rng(6).standard_normal(
        (1001, 32, 2)), dtype=dtype, device=cuda)
    coef = coef.contiguous()
    name = 'xspgr_v_bwd' if vartr else 'xspgr_bwd'
    n0 = kx.LAUNCHES[name]
    if vartr:
        pk, pkt = par[0].contiguous(), par[1].contiguous()
        chk = kx.xspgr_v_fwd_chk(coef, pk, pkt, cfg, tc=tc)[1]
        out = kx.xspgr_v_bwd(coef, pk, pkt, cfg, chk, g, tc=tc)
        ref = kx.xspgr_v_bwd_torch(coef, pk, pkt, cfg, chk, g, tc=tc)
    else:
        par = par.contiguous()
        chk = kx.xspgr_fwd_chk(coef, par, cfg, tc=tc)[1]
        out = kx.xspgr_bwd(coef, par, cfg, chk, g, tc=tc)
        ref = kx.xspgr_bwd_torch(coef, par, cfg, chk, g, tc=tc)
    assert kx.LAUNCHES[name] == n0 + 1
    _rows_close(out[0], ref[0], rows)
    for x, y in zip(out[1:], ref[1:]):
        _rows_close(x, y, bar)


@pytest.mark.cuda
def test_fit_paths_take_the_lane_route_once_on_card(cuda):
    r"""A T2 fit's and an exchange-MRF refinement's gradient, at a chunk
    the lane route takes (:func:`adjoint_tc`), launch ``cpmg_bwd`` and
    ``xspgr_bwd`` (and over a tr train ``xspgr_v_bwd``) once per
    backward."""
    from mrphy_tpu_torch.kernels import epg as kepg
    from mrphy_tpu_torch.kernels import epgx as kx
    from mrphy_tpu_torch.ops import epg
    flips, kw = _cpmg_case(cuda, torch.float32, 4096, 32, True, False, False,
                           False, 51)
    assert kepg.adjoint_cfg(33, 4, 6, kepg.adjoint_tc(
        32, 33, 4096, 4)).route == 'lanes'
    T2 = kw['T2'].clone().requires_grad_()
    for _ in range(2):
        n0 = dict(kepg.LAUNCHES)
        loss = epg.epg_cpmg(flips, **dict(kw, T2=T2)).square().sum()
        (gT2,) = torch.autograd.grad(loss, T2)
        assert {n: kepg.LAUNCHES[n] - n0[n] for n in kepg.LAUNCHES} == dict(
            dict.fromkeys(kepg.LAUNCHES, 0), cpmg_fwd_chk=1, cpmg_bwd=1)
        assert bool(torch.isfinite(gT2).all())
    for vartr in (False, True):
        kw = _xspgr_case(cuda, torch.float32, 4096, 200, 48, 1, False, 53,
                         vartr=vartr)
        assert kepg.adjoint_cfg(48, 4, 12, kepg.adjoint_tc(
            200, 48, 4096, 4, 12)).route == 'lanes'
        T1a = kw['T1a'].clone().requires_grad_()
        v = '_v' if vartr else ''
        n0 = dict(kx.LAUNCHES)
        loss = epg.epgx_spgr(**dict(kw, T1a=T1a)).square().sum()
        (gT1a,) = torch.autograd.grad(loss, T1a)
        assert {n: kx.LAUNCHES[n] - n0[n] for n in kx.LAUNCHES} == dict(
            dict.fromkeys(kx.LAUNCHES, 0),
            **{f'xspgr{v}_fwd_chk': 1, f'xspgr{v}_bwd': 1})
        assert bool(torch.isfinite(gT1a).all())


def _xcpmg_case(cuda, dtype, nA, nE, b1, seed):
    r"""``epgx_cpmg`` keywords (CUDA tensors): refocusing flips 100-180° over
    a two-pool system with per-atom rates, M0a, M0b, dfb and phi_ex (some
    atoms with dfb = 0, some without exchange) and, as asked, b1."""
    rng = np.random.default_rng(seed)

    def arr(x):
        return torch.as_tensor(x, dtype=dtype, device=cuda)

    kw = dict(flips=rng.uniform(1.75, 3.14, nE),
              T1a=rng.uniform(0.5, 2.0, nA), T2a=rng.uniform(0.05, 0.3, nA),
              T1b=rng.uniform(0.2, 0.6, nA),
              T2b=rng.uniform(0.005, 0.03, nA),
              kab=rng.uniform(1.0, 10.0, nA), kba=rng.uniform(5.0, 40.0, nA),
              M0a=rng.uniform(0.7, 1.0, nA), M0b=rng.uniform(0.05, 0.3, nA),
              dfb=rng.uniform(-20, 20, nA), phi_ex=rng.uniform(0, 6, nA))
    kw['dfb'][:7] = 0.0
    kw['kab'][7:11] = kw['kba'][7:11] = 0.0
    if b1:
        kw['b1'] = rng.uniform(0.8, 1.2, nA)
    return {n: arr(v) for n, v in kw.items()}


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,bar,rows', [(torch.float32, 2e-6, 1e-4),
                                            (torch.float64, 1e-12, 1e-12)])
@pytest.mark.parametrize('nA,nE,b1,tc', [
    (333, 32, True, 4), (200, 12, False, 3), (65, 24, True, 1),
    (47, 160, False, 40)],
    ids=['mwf-train-b1', 'plain-train', 'b1-tc1',
         'long-train-device-memory-state'])
def test_xcpmg_kernels_vs_plain_on_card(cuda, dtype, bar, rows, nA, nE, b1,
                                        tc):
    r"""``xcpmg_fwd``, ``xcpmg_fwd_chk`` and ``xcpmg_bwd`` against their
    plain versions on the card (per-atom outputs at ``bar``: bit for bit
    expected; the adjoint's per-echo rows, summed over atoms by warps, at
    ``rows`` of their largest value), over several chunks; the launch
    counts; the refusals."""
    from mrphy_tpu_torch.kernels import epgx as kx
    from mrphy_tpu_torch.ops import epg
    kw = _xcpmg_case(cuda, dtype, nA, nE, b1, 47)
    coef, pk, cfg, _ = epg._xcpmg_rows(kw.pop('flips'), **kw, esp=0.01)
    coef, pk = coef.contiguous(), pk.contiguous()
    n0 = dict(kx.LAUNCHES)
    er, ei = kx.xcpmg_fwd(coef, pk, cfg)
    er2, ei2, chk = kx.xcpmg_fwd_chk(coef, pk, cfg, tc=tc)
    rng = np.random.default_rng(3)
    gr, gi = (torch.as_tensor(rng.standard_normal((nE, nA)), dtype=dtype,
                              device=cuda) for _ in range(2))
    dcoef, dpk = kx.xcpmg_bwd(coef, pk, cfg, chk, gr, gi, tc=tc)
    torch.cuda.synchronize()
    assert {n: kx.LAUNCHES[n] - n0[n] for n in kx.LAUNCHES} == dict(
        dict.fromkeys(kx.LAUNCHES, 0), xcpmg_fwd=1, xcpmg_fwd_chk=1,
        xcpmg_bwd=1)
    er_p, ei_p, chk_p = kx.xcpmg_fwd_chk_torch(coef, pk, cfg, tc=tc)
    dcoef_p, dpk_p = kx.xcpmg_bwd_torch(coef, pk, cfg, chk_p, gr, gi, tc=tc)
    for x, y in ((er, er_p), (ei, ei_p), (er2, er_p), (ei2, ei_p),
                 (chk, chk_p), (dpk, dpk_p)):
        _rows_close(x, y, bar)
    _rows_close(dcoef, dcoef_p, rows)
    with pytest.raises(ValueError, match='contiguous'):
        kx.xcpmg_fwd(coef.T.contiguous().T, pk, cfg)
    with pytest.raises(TypeError):
        kx.xcpmg_fwd(coef.half(), pk.half(), cfg)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_epgx_cpmg_gradients_cuda_vs_plain(cuda, dtype):
    r"""``epgx_cpmg`` on CUDA tensors runs ``xcpmg_fwd`` for a value and
    ``xcpmg_fwd_chk`` + ``xcpmg_bwd`` under a gradient, under
    ``backend='auto'`` and ``'cuda'``; their gradients w.r.t. every input
    meet the plain route's; an ``(nE,)`` esp train runs the echo-spacing
    kernels (``xcpmg_v_fwd``, or ``xcpmg_v_fwd_chk`` + ``xcpmg_v_bwd``)
    under both, and a per-voxel 2-D train is refused under ``'cuda'``;
    ``backend='cuda'`` refuses CPU tensors."""
    from mrphy_tpu_torch.kernels import epgx as kx
    from mrphy_tpu_torch.ops import epg
    names = ('flips', 'T1a', 'T2a', 'T1b', 'T2b', 'kab', 'kba', 'esp', 'M0a',
             'M0b', 'dfb', 'phi_ex', 'b1')
    kw = _xcpmg_case(cuda, dtype, 70, 24, True, 41)
    kw['esp'] = torch.tensor(0.012, dtype=dtype, device=cuda)
    w = torch.as_tensor(np.random.default_rng(5).standard_normal((70, 24, 2)),
                        dtype=dtype, device=cuda)
    grads = []
    for backend in ('auto', 'cuda', 'torch'):
        xs = {n: kw[n].detach().clone().requires_grad_() for n in names}
        n0 = dict(kx.LAUNCHES)
        out = epg.epgx_cpmg(**dict(kw, **xs), backend=backend)
        grads.append(torch.autograd.grad((w * out).sum(), list(xs.values())))
        launched = {n: kx.LAUNCHES[n] - n0[n] for n in kx.LAUNCHES}
        assert launched == dict(
            dict.fromkeys(kx.LAUNCHES, 0),
            **({'xcpmg_fwd_chk': 1, 'xcpmg_bwd': 1}
               if backend != 'torch' else {}))
    n0 = dict(kx.LAUNCHES)
    with torch.no_grad():
        epg.epgx_cpmg(**kw)
    assert {n: kx.LAUNCHES[n] - n0[n] for n in kx.LAUNCHES} == dict(
        dict.fromkeys(kx.LAUNCHES, 0), xcpmg_fwd=1)
    bar = 1e-4 if dtype == torch.float32 else 1e-10
    for g in grads[:2]:
        for n, x, y in zip(names, g, grads[2]):
            _rows_close(x, y, bar)
    esps = torch.full((24,), 0.012, dtype=dtype, device=cuda)
    for backend in ('auto', 'cuda'):
        n0 = dict(kx.LAUNCHES)
        with torch.no_grad():
            out = epg.epgx_cpmg(**dict(kw, esp=esps), backend=backend)
        assert {n: kx.LAUNCHES[n] - n0[n] for n in kx.LAUNCHES} == dict(
            dict.fromkeys(kx.LAUNCHES, 0), xcpmg_v_fwd=1)
        _rows_close(out, epg.epgx_cpmg(**dict(kw, esp=esps),
                                       backend='torch'), bar)
    with pytest.raises(ValueError, match='per-voxel trains'):
        epg.epgx_cpmg(**dict(kw, flips=kw['flips'].expand(70, 24)),
                      backend='cuda')
    with pytest.raises(ValueError, match='CUDA tensors'):
        epg.epgx_cpmg(kw['flips'].cpu(), T1a=1.0, T2a=0.08, T1b=0.4,
                      T2b=0.015, kab=0.3, kba=3.0, esp=0.01, backend='cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,bar,rows', [(torch.float32, 2e-6, 1e-4),
                                            (torch.float64, 1e-12, 1e-12)])
@pytest.mark.parametrize('nA,nE,b1,tc', [
    (333, 32, True, 4), (200, 12, False, 3), (65, 24, True, 1),
    (47, 160, False, 40)],
    ids=['mwf-train-b1', 'plain-train', 'b1-tc1',
         'long-train-device-memory-state'])
def test_xcpmg_v_kernels_vs_plain_on_card(cuda, dtype, bar, rows, nA, nE,
                                          b1, tc):
    r"""``xcpmg_v_fwd``, ``xcpmg_v_fwd_chk`` and ``xcpmg_v_bwd`` against
    their plain versions on the card over an esp train of 8-18 ms (per-atom
    outputs, ``dpkt`` per atom and echo among them, at ``bar``: bit for bit
    expected; the adjoint's per-echo rows at ``rows`` of their largest
    value), over several chunks; the launch counts; the refusals."""
    from mrphy_tpu_torch.kernels import epgx as kx
    from mrphy_tpu_torch.ops import epg
    kw = _xcpmg_case(cuda, dtype, nA, nE, b1, 53)
    esps = torch.as_tensor(np.random.default_rng(8).uniform(0.008, 0.018, nE),
                           dtype=dtype, device=cuda)
    coef, (pk, pkt), cfg, _ = epg._xcpmg_rows(kw.pop('flips'), **kw,
                                              esp=esps)
    coef, pk, pkt = coef.contiguous(), pk.contiguous(), pkt.contiguous()
    n0 = dict(kx.LAUNCHES)
    er, ei = kx.xcpmg_v_fwd(coef, pk, pkt, cfg)
    er2, ei2, chk = kx.xcpmg_v_fwd_chk(coef, pk, pkt, cfg, tc=tc)
    rng = np.random.default_rng(3)
    gr, gi = (torch.as_tensor(rng.standard_normal((nE, nA)), dtype=dtype,
                              device=cuda) for _ in range(2))
    dcoef, dpk, dpkt = kx.xcpmg_v_bwd(coef, pk, pkt, cfg, chk, gr, gi, tc=tc)
    torch.cuda.synchronize()
    assert {n: kx.LAUNCHES[n] - n0[n] for n in kx.LAUNCHES} == dict(
        dict.fromkeys(kx.LAUNCHES, 0), xcpmg_v_fwd=1, xcpmg_v_fwd_chk=1,
        xcpmg_v_bwd=1)
    er_p, ei_p, chk_p = kx.xcpmg_v_fwd_chk_torch(coef, pk, pkt, cfg, tc=tc)
    dcoef_p, dpk_p, dpkt_p = kx.xcpmg_v_bwd_torch(coef, pk, pkt, cfg, chk_p,
                                                  gr, gi, tc=tc)
    assert dpk.shape == (5, nA) and dpkt.shape == (nE, 14, nA)
    for x, y in ((er, er_p), (ei, ei_p), (er2, er_p), (ei2, ei_p),
                 (chk, chk_p), (dpk, dpk_p), (dpkt, dpkt_p)):
        _rows_close(x, y, bar)
    _rows_close(dcoef, dcoef_p, rows)
    with pytest.raises(ValueError, match='pkt'):
        kx.xcpmg_v_fwd(coef, pk, pkt[1:], cfg)
    with pytest.raises(ValueError, match='pk'):
        kx.xcpmg_v_fwd(coef, pk[:4].contiguous(), pkt, cfg)
    with pytest.raises(TypeError):
        kx.xcpmg_v_fwd(coef.half(), pk.half(), pkt.half(), cfg)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_xcpmg_v_constant_train_equals_xcpmg_on_card(cuda, dtype):
    r"""Over a constant ``(nE,)`` train the echo-spacing kernels' echoes
    equal the fixed-spacing kernel's (``xcpmg_fwd``) at the same scalar esp
    (bit for bit expected: the planes repeat the per-atom rows)."""
    from mrphy_tpu_torch.kernels import epgx as kx
    from mrphy_tpu_torch.ops import epg
    kw = _xcpmg_case(cuda, dtype, 150, 32, True, 59)
    fl = kw.pop('flips')
    coef, pk, cfg, _ = epg._xcpmg_rows(fl, **kw, esp=0.01)
    coef_v, (pk5, pkt), cfg_v, _ = epg._xcpmg_rows(
        fl, **kw, esp=torch.full((32,), 0.01, dtype=dtype, device=cuda))
    assert cfg_v == cfg
    er, ei = kx.xcpmg_fwd(coef.contiguous(), pk.contiguous(), cfg)
    er_v, ei_v = kx.xcpmg_v_fwd(coef_v, pk5.contiguous(), pkt, cfg)
    _rows_close(er_v, er, 2e-6 if dtype == torch.float32 else 1e-12)
    _rows_close(ei_v, ei, 2e-6 if dtype == torch.float32 else 1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_epgx_cpmg_esp_train_gradients_cuda_vs_plain(cuda, dtype):
    r"""``epgx_cpmg`` over an ``(nE,)`` esp train on CUDA tensors runs
    ``xcpmg_v_fwd_chk`` + ``xcpmg_v_bwd`` under a gradient, under
    ``backend='auto'`` and ``'cuda'``; the gradients w.r.t. every input,
    each element of the train among them, meet the plain route's."""
    from mrphy_tpu_torch.kernels import epgx as kx
    from mrphy_tpu_torch.ops import epg
    names = ('flips', 'T1a', 'T2a', 'T1b', 'T2b', 'kab', 'kba', 'esp', 'M0a',
             'M0b', 'dfb', 'phi_ex', 'b1')
    kw = _xcpmg_case(cuda, dtype, 70, 24, True, 61)
    kw['esp'] = torch.as_tensor(
        np.random.default_rng(6).uniform(0.008, 0.018, 24), dtype=dtype,
        device=cuda)
    w = torch.as_tensor(np.random.default_rng(5).standard_normal((70, 24, 2)),
                        dtype=dtype, device=cuda)
    grads = []
    for backend in ('auto', 'cuda', 'torch'):
        xs = {n: kw[n].detach().clone().requires_grad_() for n in names}
        n0 = dict(kx.LAUNCHES)
        out = epg.epgx_cpmg(**dict(kw, **xs), backend=backend)
        grads.append(torch.autograd.grad((w * out).sum(), list(xs.values())))
        launched = {n: kx.LAUNCHES[n] - n0[n] for n in kx.LAUNCHES}
        assert launched == dict(
            dict.fromkeys(kx.LAUNCHES, 0),
            **({'xcpmg_v_fwd_chk': 1, 'xcpmg_v_bwd': 1}
               if backend != 'torch' else {}))
    bar = 1e-4 if dtype == torch.float32 else 1e-10
    assert grads[0][names.index('esp')].shape == (24,)
    for g in grads[:2]:
        for n, x, y in zip(names, g, grads[2]):
            _rows_close(x, y, bar)


def _bssfp_case(cuda, dtype, nA, nTR, vartr, b1, seed):
    r"""``bssfp_train`` keywords (CUDA tensors): a flip and phase train,
    per-atom T1, T2, df (±80 Hz) and M0, a 4-6 ms tr train (``vartr``) or
    tr 5 ms and, as asked, b1."""
    rng = np.random.default_rng(seed)

    def arr(x):
        return torch.as_tensor(x, dtype=dtype, device=cuda)

    kw = dict(flips=rng.uniform(0.1, 1.2, nTR), phis=rng.uniform(-3, 3, nTR),
              T1=rng.uniform(0.3, 2.0, nA), T2=rng.uniform(0.03, 0.3, nA),
              df=rng.uniform(-80, 80, nA), M0=rng.uniform(0.7, 1.2, nA))
    if vartr:
        kw['tr'] = rng.uniform(0.004, 0.006, nTR)
    if b1:
        kw['b1'] = rng.uniform(0.8, 1.2, nA)
    kw = {n: arr(v) for n, v in kw.items()}
    kw.setdefault('tr', 0.005)
    return kw


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,bar', [(torch.float32, 2e-6),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize('nA,nTR,vartr,b1,tc', [
    (1000, 200, True, False, 100), (333, 48, False, True, 4),
    (65, 201, True, True, 67), (4096, 16, False, False, 1)],
    ids=['fit-train', 'const-b1', 'catalysed-b1-ragged', 'const-tc1'])
def test_bssfp_kernels_vs_plain_on_card(cuda, dtype, bar, nA, nTR, vartr, b1,
                                        tc):
    r"""``bssfp_fwd``, ``bssfp_fwd_chk`` and ``bssfp_bwd`` against their
    plain versions on the card (per-atom outputs and, as the plain version
    sums them in the kernel's order, the per-TR rows at ``bar``: bit for
    bit expected), over several chunks; the launch counts; the refusals."""
    from mrphy_tpu_torch.kernels import ssfp as ks
    from mrphy_tpu_torch.ops import ssfp
    kw = _bssfp_case(cuda, dtype, nA, nTR, vartr, b1, 71)
    coef, pk, cfg, _ = ssfp._bssfp_rows(kw.pop('flips'), **kw)
    coef, pk = coef.contiguous(), pk.contiguous()
    assert cfg == ks.BssfpCfg(has_b1=b1, vartr=vartr)
    n0 = dict(ks.LAUNCHES)
    er, ei = ks.bssfp_fwd(coef, pk, cfg)
    er2, ei2, chk = ks.bssfp_fwd_chk(coef, pk, cfg, tc=tc)
    rng = np.random.default_rng(3)
    gr, gi = (torch.as_tensor(rng.standard_normal((nTR, nA)), dtype=dtype,
                              device=cuda) for _ in range(2))
    dcoef, dpk = ks.bssfp_bwd(coef, pk, cfg, chk, gr, gi, tc=tc)
    torch.cuda.synchronize()
    assert {n: ks.LAUNCHES[n] - n0[n] for n in ks.LAUNCHES} == dict(
        bssfp_fwd=1, bssfp_fwd_chk=1, bssfp_bwd=1)
    er_p, ei_p, chk_p = ks.bssfp_fwd_chk_torch(coef, pk, cfg, tc=tc)
    dcoef_p, dpk_p = ks.bssfp_bwd_torch(coef, pk, cfg, chk_p, gr, gi, tc=tc)
    for x, y in ((er, er_p), (ei, ei_p), (er2, er_p), (ei2, ei_p),
                 (chk, chk_p), (dpk, dpk_p), (dcoef, dcoef_p)):
        _rows_close(x, y, bar)
    with pytest.raises(ValueError, match='contiguous'):
        ks.bssfp_fwd(coef.T.contiguous().T, pk, cfg)
    with pytest.raises(ValueError, match='pk must be'):
        ks.bssfp_fwd(coef, pk[:4].contiguous(), cfg)
    with pytest.raises(ValueError, match='is on cpu'):
        ks.bssfp_fwd(coef.cpu(), pk, cfg)
    with pytest.raises(TypeError):
        ks.bssfp_fwd(coef.half(), pk.half(), cfg)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('vartr', [False, True], ids=['const', 'vartr'])
def test_bssfp_train_gradients_cuda_vs_plain(cuda, dtype, vartr):
    r"""``bssfp_train`` on CUDA tensors runs ``bssfp_fwd`` for a value and
    ``bssfp_fwd_chk`` + ``bssfp_bwd`` under a gradient, under
    ``backend='auto'`` and ``'cuda'``; their gradients w.r.t. every input
    (flips, phis, T1, T2, df, M0, b1 and tr) meet the plain route's; a
    per-voxel 2-D train and a prepared Minit are refused under ``'cuda'``
    and take the plain route under ``'auto'``; ``backend='cuda'`` refuses
    CPU tensors."""
    from mrphy_tpu_torch.kernels import ssfp as ks
    from mrphy_tpu_torch.ops import ssfp
    kw = _bssfp_case(cuda, dtype, 70, 40, vartr, True, 73)
    if not vartr:
        kw['tr'] = torch.tensor(0.005, dtype=dtype, device=cuda)
    names = tuple(kw)
    w = torch.as_tensor(np.random.default_rng(5).standard_normal((70, 40, 2)),
                        dtype=dtype, device=cuda)
    grads = []
    for backend in ('auto', 'cuda', 'torch'):
        xs = {n: kw[n].detach().clone().requires_grad_() for n in names}
        n0 = dict(ks.LAUNCHES)
        out = ssfp.bssfp_train(**xs, backend=backend)
        grads.append(torch.autograd.grad((w * out).sum(), list(xs.values())))
        assert {n: ks.LAUNCHES[n] - n0[n] for n in ks.LAUNCHES} == (
            dict(bssfp_fwd=0, bssfp_fwd_chk=1, bssfp_bwd=1)
            if backend != 'torch' else dict.fromkeys(ks.LAUNCHES, 0))
    n0 = dict(ks.LAUNCHES)
    with torch.no_grad():
        ssfp.bssfp_train(**kw)
    assert {n: ks.LAUNCHES[n] - n0[n] for n in ks.LAUNCHES} == dict(
        bssfp_fwd=1, bssfp_fwd_chk=0, bssfp_bwd=0)
    bar = 1e-4 if dtype == torch.float32 else 1e-10
    for g in grads[:2]:
        for x, y in zip(g, grads[2]):
            _rows_close(x, y, bar)
    fl2 = kw['flips'].expand(70, 40)
    minit = torch.zeros((70, 3), dtype=dtype, device=cuda)
    for extra in (dict(flips=fl2), dict(Minit=minit)):
        with pytest.raises(ValueError, match="backend='cuda'"):
            ssfp.bssfp_train(**dict(kw, **extra), backend='cuda')
        n0 = dict(ks.LAUNCHES)
        with torch.no_grad():
            out = ssfp.bssfp_train(**dict(kw, **extra))
        assert dict(ks.LAUNCHES) == n0 and out.shape == (70, 40, 2)
    with pytest.raises(ValueError, match='CUDA tensors'):
        ssfp.bssfp_train(kw['flips'].cpu(), T1=1.0, T2=0.1, tr=0.005,
                         backend='cuda')


def _xmt_case(cuda, dtype, nA, nTR, K, kshift, b1, seed, wscale=True):
    r"""``xmt_spgr`` keywords (CUDA tensors): an rf-spoiled train with a
    per-TR saturation train ``wt`` (0–1.5) over a qMT system with per-atom
    rates, M0a and M0b, no detailed balance, and, as asked, b1 and a
    per-atom saturation scale ``wscale`` (0.5–1.5)."""
    from mrphy_tpu_torch.ops import epg
    rng = np.random.default_rng(seed)

    def arr(x):
        return torch.as_tensor(x, dtype=dtype, device=cuda)

    kw = dict(flips=arr(rng.uniform(0.1, 1.2, nTR)),
              phis=epg.rf_spoil_phases(nTR, dtype=dtype, device=cuda),
              wt=arr(rng.uniform(0.0, 1.5, nTR)),
              T1a=arr(rng.uniform(0.5, 2.0, nA)),
              T2a=arr(rng.uniform(0.03, 0.1, nA)),
              T1b=arr(rng.uniform(0.5, 1.5, nA)),
              kab=arr(rng.uniform(0.5, 5.0, nA)),
              kba=arr(rng.uniform(5.0, 40.0, nA)),
              M0a=arr(rng.uniform(0.8, 1.0, nA)),
              M0b=arr(rng.uniform(0.05, 0.25, nA)), tr=0.03,
              kshift=kshift, K=K)
    if b1:
        kw['b1'] = arr(rng.uniform(0.8, 1.2, nA))
    if wscale:
        kw['wscale'] = arr(rng.uniform(0.5, 1.5, nA))
    return kw


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,bar', [(torch.float32, 2e-6),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize('nA,nTR,K,kshift,b1', [
    (333, 40, 12, 1, False), (200, 36, 10, -1, True), (129, 30, 9, 2, True),
    (65, 160, None, 1, False)],
    ids=['plain-train', 'b1-kshift-1', 'b1-kshift2',
         'default-K-device-memory-state'])
def test_xmt_kernels_vs_plain_on_card(cuda, dtype, bar, nA, nTR, K, kshift,
                                      b1):
    r"""``xmt_fwd``, ``xmt_fwd_chk`` and ``xmt_bwd`` against their plain
    versions on the card (per-atom outputs and, as the plain version sums
    them in the kernel's order, the per-TR rows at ``bar``: bit for bit
    expected), over several chunks; the launch counts; the refusals."""
    from mrphy_tpu_torch.kernels import epgx as kx
    from mrphy_tpu_torch.ops import epg
    from mrphy_tpu_torch.utils._shapes import largest_divisor_leq
    kw = _xmt_case(cuda, dtype, nA, nTR, K, kshift, b1, 43)
    coef, pk, cfg, _ = epg._xmt_rows(kw.pop('flips'), kw.pop('phis'), **kw)
    coef, pk = coef.contiguous(), pk.contiguous()
    tc = largest_divisor_leq(nTR, nTR // 3)          # three chunks or more
    n0 = dict(kx.LAUNCHES)
    sig = kx.xmt_fwd(coef, pk, cfg)
    sig2, chk = kx.xmt_fwd_chk(coef, pk, cfg, tc=tc)
    g = torch.as_tensor(np.random.default_rng(3).standard_normal(
        sig.shape), dtype=dtype, device=cuda)
    dcoef, dpk = kx.xmt_bwd(coef, pk, cfg, chk, g, tc=tc)
    torch.cuda.synchronize()
    assert {n: kx.LAUNCHES[n] - n0[n] for n in kx.LAUNCHES} == dict(
        dict.fromkeys(kx.LAUNCHES, 0), xmt_fwd=1, xmt_fwd_chk=1, xmt_bwd=1)
    sig_p, chk_p = kx.xmt_fwd_chk_torch(coef, pk, cfg, tc=tc)
    dcoef_p, dpk_p = kx.xmt_bwd_torch(coef, pk, cfg, chk_p, g, tc=tc)
    for x, y in ((sig, sig_p), (sig2, sig_p), (chk, chk_p), (dpk, dpk_p),
                 (dcoef, dcoef_p)):
        _rows_close(x, y, bar)
    with pytest.raises(ValueError, match='contiguous'):
        kx.xmt_fwd(coef.T.contiguous().T, pk, cfg)
    with pytest.raises(ValueError, match='pk must be'):
        kx.xmt_fwd(coef, pk[:7].contiguous(), cfg)
    with pytest.raises(TypeError):
        kx.xmt_fwd(coef.half(), pk.half(), cfg)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,bar', [(torch.float32, 2e-6),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize('nA,nTR,K,kshift,b1', [
    (333, 40, 12, 1, False), (200, 36, 10, -1, True), (129, 30, 9, 2, True),
    (65, 160, None, 1, False)],
    ids=['plain-train', 'b1-kshift-1', 'b1-kshift2',
         'default-K-device-memory-state'])
def test_xmt_v_kernels_vs_plain_on_card(cuda, dtype, bar, nA, nTR, K, kshift,
                                        b1):
    r"""``xmt_v_fwd``, ``xmt_v_fwd_chk`` and ``xmt_v_bwd`` over a ``(nTR,)``
    tr train (25–35 ms) against their plain versions on the card (per-atom
    outputs, ``dpkt`` per atom and TR among them, and the per-TR rows at
    ``bar``: bit for bit expected), over several chunks; the launch counts;
    the refusals."""
    from mrphy_tpu_torch.kernels import epgx as kx
    from mrphy_tpu_torch.ops import epg
    from mrphy_tpu_torch.utils._shapes import largest_divisor_leq
    kw = _xmt_case(cuda, dtype, nA, nTR, K, kshift, b1, 53)
    kw['tr'] = torch.as_tensor(np.random.default_rng(7).uniform(
        0.025, 0.035, nTR), dtype=dtype, device=cuda)
    coef, (pk, pkt), cfg, _ = epg._xmt_rows(kw.pop('flips'), kw.pop('phis'),
                                            **kw)
    coef, pk, pkt = coef.contiguous(), pk.contiguous(), pkt.contiguous()
    assert pk.shape == (4, nA) and pkt.shape == (nTR, 7, nA)
    tc = largest_divisor_leq(nTR, nTR // 3)          # three chunks or more
    n0 = dict(kx.LAUNCHES)
    sig = kx.xmt_v_fwd(coef, pk, pkt, cfg)
    sig2, chk = kx.xmt_v_fwd_chk(coef, pk, pkt, cfg, tc=tc)
    g = torch.as_tensor(np.random.default_rng(3).standard_normal(
        sig.shape), dtype=dtype, device=cuda)
    dcoef, dpk, dpkt = kx.xmt_v_bwd(coef, pk, pkt, cfg, chk, g, tc=tc)
    torch.cuda.synchronize()
    assert {n: kx.LAUNCHES[n] - n0[n] for n in kx.LAUNCHES} == dict(
        dict.fromkeys(kx.LAUNCHES, 0), xmt_v_fwd=1, xmt_v_fwd_chk=1,
        xmt_v_bwd=1)
    sig_p, chk_p = kx.xmt_v_fwd_chk_torch(coef, pk, pkt, cfg, tc=tc)
    dcoef_p, dpk_p, dpkt_p = kx.xmt_v_bwd_torch(coef, pk, pkt, cfg, chk_p,
                                                g, tc=tc)
    for x, y in ((sig, sig_p), (sig2, sig_p), (chk, chk_p), (dpk, dpk_p),
                 (dpkt, dpkt_p), (dcoef, dcoef_p)):
        _rows_close(x, y, bar)
    with pytest.raises(ValueError, match='contiguous'):
        kx.xmt_v_fwd(coef, pk, pkt.transpose(0, 1).contiguous()
                     .transpose(0, 1), cfg)
    with pytest.raises(ValueError, match='pk must be'):
        kx.xmt_v_fwd(coef, pk[:3].contiguous(), pkt, cfg)
    with pytest.raises(ValueError, match='pkt'):
        kx.xmt_v_fwd(coef, pk, pkt[:, :6].contiguous(), cfg)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_xmt_spgr_tr_train_gradients_cuda_vs_plain(cuda, dtype):
    r"""``kernels.epgx.xmt_spgr`` with a per-atom ``wscale`` over a ``(nTR,)``
    tr train runs ``xmt_v_fwd_chk`` + ``xmt_v_bwd`` under a gradient; the
    echoes and the gradients w.r.t. every input (every element of the tr
    train, the wt train and ``wscale`` among them) meet the plain route's
    batched ``wt[None]·wscale[:, None]`` over the same train."""
    from mrphy_tpu_torch.kernels import epgx as kx
    from mrphy_tpu_torch.ops import epg
    names = ('flips', 'phis', 'T1a', 'T2a', 'T1b', 'kab', 'kba', 'tr', 'wt',
             'M0a', 'M0b', 'b1', 'wscale')
    kw = _xmt_case(cuda, dtype, 70, 24, 8, -1, True, 59)
    kw['tr'] = torch.as_tensor(np.random.default_rng(9).uniform(
        0.025, 0.035, 24), dtype=dtype, device=cuda)
    w = torch.as_tensor(np.random.default_rng(5).standard_normal((70, 24, 2)),
                        dtype=dtype, device=cuda)
    xs = {n: kw[n].detach().clone().requires_grad_() for n in names}
    n0 = dict(kx.LAUNCHES)
    out = kx.xmt_spgr(**dict(kw, **xs))
    ga = torch.autograd.grad((w * out).sum(), list(xs.values()))
    assert {n: kx.LAUNCHES[n] - n0[n] for n in kx.LAUNCHES} == dict(
        dict.fromkeys(kx.LAUNCHES, 0), xmt_v_fwd_chk=1, xmt_v_bwd=1)
    xs2 = {n: kw[n].detach().clone().requires_grad_() for n in names}
    kw2 = dict(kw, **xs2)
    kw2['wt'] = xs2['wt'][None] * kw2.pop('wscale')[:, None]
    out2 = epg.epgx_mt_spgr(**kw2, backend='torch')
    gb = torch.autograd.grad((w * out2).sum(), list(xs2.values()))
    bar = 1e-4 if dtype == torch.float32 else 1e-10
    _rows_close(out.detach(), out2.detach(), bar)
    for n, x, y in zip(names, ga, gb):
        assert x.shape == y.shape, n
        _rows_close(x, y, bar)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_epgx_mt_spgr_gradients_cuda_vs_plain(cuda, dtype):
    r"""``epgx_mt_spgr`` on CUDA tensors with a shared train and a scalar tr
    runs ``xmt_fwd`` for a value and ``xmt_fwd_chk`` + ``xmt_bwd`` under a
    gradient, under ``backend='auto'`` and ``'cuda'``; their gradients
    w.r.t. every input (the wt train among them) meet the plain route's;
    ``xmt_spgr`` with ``wscale`` meets the plain route's batched
    ``wt[None]·wscale[:, None]``; a batched wt takes the plain route under
    ``'auto'`` and is refused under ``'cuda'``; a ``(nTR,)`` tr train runs
    the variable-TR kernel ``xmt_v_fwd`` under ``'cuda'`` and ``'auto'``,
    its echoes those of the plain route; ``backend='cuda'`` refuses CPU
    tensors."""
    from mrphy_tpu_torch.kernels import epgx as kx
    from mrphy_tpu_torch.ops import epg
    names = ('flips', 'phis', 'T1a', 'T2a', 'T1b', 'kab', 'kba', 'tr', 'wt',
             'M0a', 'M0b', 'b1')
    kw = _xmt_case(cuda, dtype, 70, 24, 8, -1, True, 47)
    wsc = kw.pop('wscale')
    kw['tr'] = torch.tensor(0.03, dtype=dtype, device=cuda)
    w = torch.as_tensor(np.random.default_rng(5).standard_normal((70, 24, 2)),
                        dtype=dtype, device=cuda)
    grads = []
    for backend in ('auto', 'cuda', 'torch'):
        xs = {n: kw[n].detach().clone().requires_grad_() for n in names}
        n0 = dict(kx.LAUNCHES)
        out = epg.epgx_mt_spgr(**dict(kw, **xs), backend=backend)
        grads.append(torch.autograd.grad((w * out).sum(), list(xs.values())))
        assert {n: kx.LAUNCHES[n] - n0[n] for n in kx.LAUNCHES} == dict(
            dict.fromkeys(kx.LAUNCHES, 0),
            **({'xmt_fwd_chk': 1, 'xmt_bwd': 1} if backend != 'torch'
               else {}))
    n0 = dict(kx.LAUNCHES)
    with torch.no_grad():
        epg.epgx_mt_spgr(**kw)
    assert {n: kx.LAUNCHES[n] - n0[n] for n in kx.LAUNCHES} == dict(
        dict.fromkeys(kx.LAUNCHES, 0), xmt_fwd=1)
    bar = 1e-4 if dtype == torch.float32 else 1e-10
    for g in grads[:2]:
        for x, y in zip(g, grads[2]):
            _rows_close(x, y, bar)
    # the per-atom saturation scale against the plain route's batched wt
    xs = {n: kw[n].detach().clone().requires_grad_() for n in names}
    wsc_ = wsc.detach().clone().requires_grad_()
    out = kx.xmt_spgr(**dict(kw, **xs), wscale=wsc_)
    ga = torch.autograd.grad((w * out).sum(), list(xs.values()) + [wsc_])
    xs2 = {n: kw[n].detach().clone().requires_grad_() for n in names}
    wsc2 = wsc.detach().clone().requires_grad_()
    kw2 = dict(kw, **xs2)
    kw2['wt'] = xs2['wt'][None] * wsc2[:, None]
    out2 = epg.epgx_mt_spgr(**kw2)
    gb = torch.autograd.grad((w * out2).sum(), list(xs2.values()) + [wsc2])
    _rows_close(out.detach(), out2.detach(), bar)
    for x, y in zip(ga, gb):
        _rows_close(x, y, bar)
    # outside the kernels: a batched wt
    wt2 = kw['wt'][None] * wsc[:, None]
    with pytest.raises(ValueError, match='wscale'):
        epg.epgx_mt_spgr(**dict(kw, wt=wt2), backend='cuda')
    n0 = dict(kx.LAUNCHES)
    with torch.no_grad():
        out = epg.epgx_mt_spgr(**dict(kw, wt=wt2))
    assert dict(kx.LAUNCHES) == n0 and out.shape == (70, 24, 2)
    # a (nTR,) tr train: the variable-TR kernel, under 'cuda' and 'auto'
    trs = torch.linspace(0.025, 0.035, 24, dtype=dtype, device=cuda)
    with torch.no_grad():
        ref = epg.epgx_mt_spgr(**dict(kw, tr=trs), backend='torch')
        for backend in ('cuda', 'auto'):
            n0 = dict(kx.LAUNCHES)
            out = epg.epgx_mt_spgr(**dict(kw, tr=trs), backend=backend)
            assert {n: kx.LAUNCHES[n] - n0[n] for n in kx.LAUNCHES} == dict(
                dict.fromkeys(kx.LAUNCHES, 0), xmt_v_fwd=1)
            _rows_close(out, ref, bar)
    with pytest.raises(ValueError, match='CUDA tensors'):
        epg.epgx_mt_spgr(kw['flips'].cpu(), T1a=1.0, T2a=0.06, T1b=1.0,
                         kab=2.0, kba=20.0, tr=0.03, backend='cuda')


# K15's two routes (kernels/epg.py adjoint_cfg), every option (b1,
# diffusion; a fixed TR and a TR/TE train) at a ragged 1,001 atoms × 40
# TRs: the lanes at kshift −1 (K 24: 8 lanes of 3 slots), 2 (K 37: 16 of
# 3), 9, more orders than the group has lanes (K 16: 8 of 2, shifted in
# pieces of at most 7), and in float64 (K 32: 16 of 2); one thread per
# atom for a chunk past the S shared states (K 48: S 7, tc 8) and for
# orders past the slots (K 161; float64 K 65).
SPGR_ROUTE_CASES = [
    (torch.float32, 2e-6, 1e-4, 24, -1, 5, 'lanes'),
    (torch.float32, 2e-6, 1e-4, 37, 2, 4, 'lanes'),
    (torch.float32, 2e-6, 1e-4, 16, 9, 8, 'lanes'),
    (torch.float32, 2e-6, 1e-4, 48, 1, 8, 'thread'),
    (torch.float32, 2e-6, 1e-4, 161, 1, 4, 'thread'),
    (torch.float64, 1e-12, 1e-12, 32, 1, 5, 'lanes'),
    (torch.float64, 1e-12, 1e-12, 65, -1, 4, 'thread')]
SPGR_ROUTE_IDS = ['f32-lanes-K24-kshift-1', 'f32-lanes-K37-kshift2',
                  'f32-lanes-K16-kshift9', 'f32-thread-tc-past-S',
                  'f32-thread-K161', 'f64-lanes-K32', 'f64-thread-K65']


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,bar,rows,K,kshift,tc,route',
                         SPGR_ROUTE_CASES, ids=SPGR_ROUTE_IDS)
@pytest.mark.parametrize('vartr', [False, True], ids=['tr', 'tr-train'])
def test_spgr_bwd_routes_on_card(cuda, dtype, bar, rows, K, kshift, tc,
                                 route, vartr):
    r"""``spgr_bwd`` on both routes against its plain version (which sums
    over the orders and the warps' atoms in the route's order): per-atom
    rows at ``bar``, per-TR rows at ``rows`` of their largest value; one
    launch each."""
    from mrphy_tpu_torch.kernels import epg as kepg
    from mrphy_tpu_torch.ops import epg
    kw = _spgr_case(cuda, dtype, 1001, 40, K, kshift, True, vartr, True, 57)
    coef, par, cdiff, cfg, _ = epg._spgr_rows(**kw)
    coef, par = coef.contiguous(), par.contiguous()
    assert kepg.adjoint_cfg(K, par.element_size(), 6, tc).route == route
    chk = kepg.spgr_fwd_chk(coef, par, cdiff, cfg, tc=tc)[1]
    g = torch.as_tensor(np.random.default_rng(7).standard_normal(
        (1001, 40, 2)), dtype=dtype, device=cuda)
    n0 = kepg.LAUNCHES['spgr_bwd']
    dcoef, dpar = kepg.spgr_bwd(coef, par, cdiff, cfg, chk, g, tc=tc)
    torch.cuda.synchronize()
    assert kepg.LAUNCHES['spgr_bwd'] == n0 + 1
    dcoef_p, dpar_p = kepg.spgr_bwd_torch(coef, par, cdiff, cfg, chk, g,
                                          tc=tc)
    _rows_close(dpar, dpar_p, bar)
    _rows_close(dcoef, dcoef_p, rows)


# K27's and K30's two routes, b1, at a ragged 1,001 atoms: the lanes at
# 32 echoes (K 33: 16 lanes of 3 slots, S 4) and 24 (K 25: 16 of 2), in
# float64 at 24 (K 25: 32 lanes of 1); one thread per atom for a chunk
# past S (K 33, tc 8), for orders past the slots (K 101) and at the
# 32-echo train's K 33 in float64.
XCPMG_ROUTE_CASES = [
    (torch.float32, 2e-6, 1e-4, 32, 4, 'lanes'),
    (torch.float32, 2e-6, 1e-4, 24, 3, 'lanes'),
    (torch.float32, 2e-6, 1e-4, 32, 8, 'thread'),
    (torch.float32, 2e-6, 1e-4, 100, 4, 'thread'),
    (torch.float64, 1e-12, 1e-12, 24, 3, 'lanes'),
    (torch.float64, 1e-12, 1e-12, 32, 4, 'thread')]
XCPMG_ROUTE_IDS = ['f32-lanes-K33', 'f32-lanes-K25', 'f32-thread-tc-past-S',
                   'f32-thread-K101', 'f64-lanes-K25', 'f64-thread-K33']


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,bar,rows,nE,tc,route', XCPMG_ROUTE_CASES,
                         ids=XCPMG_ROUTE_IDS)
@pytest.mark.parametrize('varesp', [False, True],
                         ids=['esp', 'esp-train'])
def test_xcpmg_bwd_routes_on_card(cuda, dtype, bar, rows, nE, tc, route,
                                  varesp):
    r"""``xcpmg_bwd`` and ``xcpmg_v_bwd`` on both routes against their plain
    versions (which sum in the route's order): per-atom outputs (``dpkt``
    per atom and echo among them) at ``bar``, per-echo rows at ``rows`` of
    their largest value; one launch each."""
    from mrphy_tpu_torch.kernels import epg as kepg
    from mrphy_tpu_torch.kernels import epgx as kx
    from mrphy_tpu_torch.ops import epg
    kw = _xcpmg_case(cuda, dtype, 1001, nE, True, 61)
    flips = kw.pop('flips')
    esp = (torch.as_tensor(np.random.default_rng(9).uniform(0.008, 0.018, nE),
                           dtype=dtype, device=cuda) if varesp else 0.01)
    coef, pk, cfg, _ = epg._xcpmg_rows(flips, **kw, esp=esp)
    assert kepg.adjoint_cfg(cfg.K, coef.element_size(), 12,
                            tc).route == route
    coef = coef.contiguous()
    par = tuple(x.contiguous() for x in (pk if varesp else (pk,)))
    v = '_v' if varesp else ''
    fwd_chk, bwd, bwd_t = (getattr(kx, f'xcpmg{v}_{n}')
                           for n in ('fwd_chk', 'bwd', 'bwd_torch'))
    chk = fwd_chk(coef, *par, cfg, tc=tc)[2]
    gr, gi = torch.as_tensor(np.random.default_rng(4).standard_normal(
        (2, nE, 1001)), dtype=dtype, device=cuda)
    n0 = kx.LAUNCHES[f'xcpmg{v}_bwd']
    out = bwd(coef, *par, cfg, chk, gr, gi, tc=tc)
    torch.cuda.synchronize()
    assert kx.LAUNCHES[f'xcpmg{v}_bwd'] == n0 + 1
    ref = bwd_t(coef, *par, cfg, chk, gr, gi, tc=tc)
    _rows_close(out[0], ref[0], rows)
    for x, y in zip(out[1:], ref[1:]):
        _rows_close(x, y, bar)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,ents', [(torch.float32, 1e-5),
                                        (torch.float64, 1e-12)])
def test_xcpmg_v_bwd_constant_train_equals_xcpmg_bwd_on_card(cuda, dtype,
                                                            ents):
    r"""Over a constant 10 ms train K30's lane route meets K27's at the
    scalar esp: the per-echo rows and the initial state's and b1's
    gradients alike (bit for bit expected: the same operations), the
    per-echo entry gradients summed over the train within ``ents`` of the
    largest (K27 sums them per lane over the train, K30 per echo)."""
    from mrphy_tpu_torch.kernels import epg as kepg
    from mrphy_tpu_torch.kernels import epgx as kx
    from mrphy_tpu_torch.ops import epg
    kw = _xcpmg_case(cuda, dtype, 1001, 24, True, 67)
    fl = kw.pop('flips')
    coef, pk, cfg, _ = epg._xcpmg_rows(fl, **kw, esp=0.01)
    coef_v, (pk5, pkt), _, _ = epg._xcpmg_rows(
        fl, **kw, esp=torch.full((24,), 0.01, dtype=dtype, device=cuda))
    coef, pk, pk5 = coef.contiguous(), pk.contiguous(), pk5.contiguous()
    tc = 3
    assert kepg.adjoint_cfg(cfg.K, coef.element_size(), 12,
                            tc).route == 'lanes'
    chk = kx.xcpmg_fwd_chk(coef, pk, cfg, tc=tc)[2]
    gr, gi = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (2, 24, 1001)), dtype=dtype, device=cuda)
    dcoef, dpk = kx.xcpmg_bwd(coef, pk, cfg, chk, gr, gi, tc=tc)
    dcoef_v, dpk_v, dpkt = kx.xcpmg_v_bwd(coef_v, pk5, pkt, cfg, chk, gr, gi,
                                          tc=tc)
    bar = 2e-6 if dtype == torch.float32 else 1e-12
    _rows_close(dcoef_v, dcoef, bar)
    _rows_close(dpk_v, dpk[14:], bar)
    _rows_close(dpkt.sum(dim=0), dpk[:14], ents)


@pytest.mark.cuda
def test_mrf_and_mwf_gradients_take_the_lane_route_once_on_card(cuda):
    r"""An MRF-FISP dictionary's gradient (K 48, TR/TE train, diffusion)
    and an MWF fit step's (K 33, b1), at the chunk the lane route takes
    (:func:`adjoint_tc`), launch ``spgr_bwd`` and ``xcpmg_bwd`` (over an
    esp train ``xcpmg_v_bwd``) once per backward, with finite gradients."""
    from mrphy_tpu_torch.kernels import epg as kepg
    from mrphy_tpu_torch.kernels import epgx as kx
    from mrphy_tpu_torch.ops import epg
    kw = _spgr_case(cuda, torch.float32, 4096, 400, 48, 1, False, True, True,
                    71)
    assert kepg.adjoint_cfg(48, 4, 6, kepg.adjoint_tc(
        400, 48, 4096, 4)).route == 'lanes'
    T1 = kw['T1'].clone().requires_grad_()
    n0 = dict(kepg.LAUNCHES)
    loss = epg.epg_spgr(**dict(kw, T1=T1)).square().sum()
    (gT1,) = torch.autograd.grad(loss, T1)
    assert {n: kepg.LAUNCHES[n] - n0[n] for n in kepg.LAUNCHES} == dict(
        dict.fromkeys(kepg.LAUNCHES, 0), spgr_fwd_chk=1, spgr_bwd=1)
    assert bool(torch.isfinite(gT1).all())
    for varesp in (False, True):
        kw = _xcpmg_case(cuda, torch.float32, 4096, 32, True, 73)
        if varesp:
            kw['esp'] = torch.linspace(0.006, 0.014, 32, device=cuda)
        else:
            kw['esp'] = 0.01
        assert kepg.adjoint_cfg(33, 4, 12, kepg.adjoint_tc(
            32, 33, 4096, 4, 12)).route == 'lanes'
        T2a = kw['T2a'].clone().requires_grad_()
        v = '_v' if varesp else ''
        n0 = dict(kx.LAUNCHES)
        loss = epg.epgx_cpmg(**dict(kw, T2a=T2a)).square().sum()
        (gT2a,) = torch.autograd.grad(loss, T2a)
        assert {n: kx.LAUNCHES[n] - n0[n] for n in kx.LAUNCHES} == dict(
            dict.fromkeys(kx.LAUNCHES, 0),
            **{f'xcpmg{v}_fwd_chk': 1, f'xcpmg{v}_bwd': 1})
        assert bool(torch.isfinite(gT2a).all())
