r"""The Bloch kernels of :mod:`mrphy_tpu_torch.kernels`: their plain
PyTorch versions against the TPU kernels they replace (JAX Pallas in
interpret mode; the forwards' chunk-end states ``chk`` compared chunk by
chunk, the adjoints fed the same ``chk``), the ``chk`` contract, the
cotangents of intermediate chunk ends, the CPU dispatch, and the build's
error path.

The kernels themselves on the card: ``tests/test_torch_cuda.py``.

Tolerances, the bars ``tests/test_pallas.py`` uses for Pallas against XLA
(the TPU kernels' polynomial sincos vs the library sin/cos, ~1e-7 per
step): forwards 2e-6 in float32; adjoints 2e-5 for the per-spin outputs
(relative to the output's largest value where that exceeds 1: the field
gradients sum over the steps to values up to ~100), 2e-3 of the largest
value for the waveform rows (sums over spins), 2e-4 of the largest value
for a float32 dBeff. A bfloat16 dBeff is rounded to bf16 on both sides:
where the float32 values straddle a rounding boundary the two differ by
one bf16 step, so it is held at 2⁻⁸ of its largest value.
"""

import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mrphy_tpu.ops import pallas_kernels as pk
from mrphy_tpu_torch.kernels import _build, bloch
from mrphy_tpu_torch.ops import sims as tsims
from tests.test_torch_cuda import _tt
from tests.test_torch_cuda import beff_args as _beff_args
from tests.test_torch_cuda import rfgr_args as _rfgr_args


def _tpu_planes(x, fill=0.0):
    r"""(..., n) → (..., S1, 128), the spin axis padded to 1024."""
    n = x.shape[-1]
    Sp = -(-n // 1024) * 1024
    pad = [(0, 0)] * (x.ndim - 1) + [(0, Sp - n)]
    x = np.pad(x, pad, constant_values=fill)
    return jnp.asarray(x.reshape(x.shape[:-1] + (Sp // 128, 128)))


RFGR_KEYS = ('rf2', 'gr2', 'loc_p', 'dfg', 'b1_p', 'E', 'e1_1', 'g2pd',
             'vel_p', 'tarr2')


def _close_rel(x, ref, bar, floor=1.0):
    r"""|x − ref| ≤ bar·max(floor, max|ref|)."""
    ref = np.asarray(ref)
    scale = max(floor, float(np.abs(ref).max()))
    np.testing.assert_allclose(np.asarray(x), ref, rtol=0, atol=bar * scale)


def test_rfgr_fwd_plain_vs_pallas_interpret():
    a = _rfgr_args()
    N, _, nS = a['mi'].shape
    spin = {k: _tpu_planes(v, fill=1.0 if k == 'E' else 0.0)
            for k, v in a.items() if k not in ('rf2', 'gr2', 'tarr2')}
    ref = pk.rfgr_fwd_planes(
        spin['mi'], jnp.asarray(a['rf2']), jnp.asarray(a['gr2']),
        spin['loc_p'], spin['dfg'], spin['b1_p'], spin['E'], spin['e1_1'],
        spin['g2pd'], spin['vel_p'], jnp.asarray(a['tarr2']), tc=16,
        interpret=True)
    ref = np.asarray(ref).reshape(N, 4, 3, -1)[..., :nS]
    t = _tt(a)
    chk = bloch.rfgr_fwd(t['mi'], t['rf2'], t['gr2'], t['loc_p'], t['dfg'],
                         t['b1_p'], t['E'], t['e1_1'], t['g2pd'],
                         t['vel_p'], t['tarr2'], tc=16)
    assert chk.shape == (N, 4, 3, nS) and chk.dtype == torch.float32
    np.testing.assert_allclose(chk.numpy(), ref, rtol=0, atol=2e-6)


@pytest.mark.parametrize('store', ['float32', 'bfloat16'])
def test_beff_fwd_plain_vs_pallas_interpret(store):
    a = _beff_args()
    B = a['mi'].shape[1]
    beff = jnp.asarray(a['beff'], jnp.dtype(store))
    nT = beff.shape[0]
    beff_p = jnp.pad(beff, ((0, 0), (0, 0), (0, 1024 - B))).reshape(
        nT, 3, 8, 128)
    ref = pk.blochsim_fwd_planes(
        _tpu_planes(a['mi']), beff_p, _tpu_planes(a['E'], fill=1.0),
        _tpu_planes(a['e1_1']), _tpu_planes(a['g2pd']), tc=32,
        interpret=True)
    ref = np.asarray(ref).reshape(3, 3, -1)[..., :B]
    t = _tt({k: v for k, v in a.items() if k != 'beff'})
    tbeff = torch.as_tensor(np.asarray(beff.astype(np.float32))).to(
        getattr(torch, store))
    chk = bloch.beff_fwd(t['mi'], tbeff, t['E'], t['e1_1'], t['g2pd'],
                         tc=32)
    assert chk.shape == (3, 3, B) and chk.dtype == torch.float32
    np.testing.assert_allclose(chk.numpy(), ref, rtol=0, atol=2e-6)


def test_rfgr_bwd_plain_vs_pallas_interpret():
    r"""``rfgr_bwd_torch`` against ``_rfgr_bwd_kernel`` (interpret), both
    fed the same ``chk``: B1 with 2 coils, flow, relaxation, Δf."""
    a = _rfgr_args()
    N, _, nS = a['mi'].shape
    t = _tt(a)
    chk = bloch.rfgr_fwd_torch(t['mi'], *(t[k] for k in RFGR_KEYS), tc=16)
    g = np.random.default_rng(4).normal(size=chk.shape).astype(np.float32)
    g[:, :-1] = 0                 # the TPU kernel takes the final state's
    spin = {k: _tpu_planes(v, fill=1.0 if k == 'E' else 0.0)
            for k, v in a.items() if k not in ('rf2', 'gr2', 'tarr2')}
    ref = pk.rfgr_bwd_planes(
        _tpu_planes(chk.numpy()), _tpu_planes(g[:, -1]),
        jnp.asarray(a['rf2']), jnp.asarray(a['gr2']), spin['loc_p'],
        spin['dfg'], spin['b1_p'], spin['E'], spin['e1_1'], spin['g2pd'],
        spin['vel_p'], jnp.asarray(a['tarr2']), tc=16, interpret=True)
    out = bloch.rfgr_bwd(chk, torch.as_tensor(g),
                         *(t[k] for k in RFGR_KEYS), tc=16)
    names = ('dmi', 'drf2', 'dgr2', 'dloc', 'ddfg', 'db1', 'dvel')
    for name, r, o in zip(names, ref, out):
        r = np.asarray(r)
        if name in ('drf2', 'dgr2'):
            assert o.shape == r.shape, name
            _close_rel(o, r, 2e-3, floor=0.0)
        else:
            r = r.reshape(r.shape[:-2] + (-1,))[..., :nS]
            assert o.shape == r.shape and o.dtype == torch.float32, name
            _close_rel(o, r, 2e-5)


@pytest.mark.parametrize('store', ['float32', 'bfloat16'])
def test_beff_bwd_plain_vs_pallas_interpret(store):
    a = _beff_args()
    B = a['mi'].shape[1]
    t = _tt(a)
    beff = t['beff'].to(getattr(torch, store))
    chk = bloch.beff_fwd_torch(t['mi'], beff, t['E'], t['e1_1'], t['g2pd'],
                               tc=32)
    g = np.random.default_rng(5).normal(size=chk.shape).astype(np.float32)
    g[:-1] = 0
    jbeff = jnp.asarray(beff.float().numpy(), jnp.dtype(store))
    nT = jbeff.shape[0]
    dmi, dbeff = pk.blochsim_bwd_planes(
        _tpu_planes(chk.numpy()), _tpu_planes(g[-1]),
        jnp.pad(jbeff, ((0, 0), (0, 0), (0, 1024 - B))).reshape(
            nT, 3, 8, 128),
        _tpu_planes(a['E'], fill=1.0), _tpu_planes(a['e1_1']),
        _tpu_planes(a['g2pd']), tc=32, interpret=True)
    tmi, tbeff = bloch.beff_bwd(chk, torch.as_tensor(g), beff, t['E'],
                                t['e1_1'], t['g2pd'], tc=32)
    assert tbeff.dtype == beff.dtype and tbeff.shape == beff.shape
    _close_rel(tmi, np.asarray(dmi).reshape(3, -1)[:, :B], 2e-5)
    ref = np.asarray(dbeff.astype(np.float32)).reshape(nT, 3, -1)[..., :B]
    _close_rel(tbeff.float(), ref, 2e-4 if store == 'float32' else 2 ** -8,
               floor=0.0)


def test_intermediate_chunk_end_cotangents():
    r"""A loss on every chunk end, ``chk[:, 0]`` included, gets the same
    gradient through the reconstruction Function (plain forward and
    plain adjoint) as through torch autograd of the plain loop."""
    a = _tt(_rfgr_args(N=1, nS=40, nT=48, nC=2, dtype=np.float64))
    W = torch.as_tensor(np.random.default_rng(9).normal(size=(1, 3, 3, 40)))
    xs = [a[k].clone().requires_grad_()
          for k in ('mi', 'rf2', 'gr2', 'loc_p', 'dfg', 'b1_p', 'vel_p')]
    mi, rf2, gr2, loc_p, dfg, b1_p, vel_p = xs
    args = (mi, rf2, gr2, loc_p, dfg, b1_p, a['E'], a['e1_1'], a['g2pd'],
            vel_p, a['tarr2'])
    for loss in (lambda c: (W[:, :1] * c[:, :1]).sum(),
                 lambda c: (W * c).sum()):
        g_fn = torch.autograd.grad(loss(bloch.rfgr_fwd(*args, tc=16)), xs)
        g_ad = torch.autograd.grad(loss(bloch.rfgr_fwd_torch(*args, tc=16)),
                                   xs)
        for x, y in zip(g_fn, g_ad):
            np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-10,
                                       atol=1e-12 * float(y.abs().max()))
    b = _tt(_beff_args(B=30, nT=48, dtype=np.float64))
    mi, beff = (b[k].clone().requires_grad_() for k in ('mi', 'beff'))
    Wb = torch.as_tensor(np.random.default_rng(10).normal(size=(1, 3, 30)))
    bargs = (mi, beff, b['E'], b['e1_1'], b['g2pd'])
    g_fn = torch.autograd.grad(
        (Wb * bloch.beff_fwd(*bargs, tc=16)[:1]).sum(), (mi, beff))
    g_ad = torch.autograd.grad(
        (Wb * bloch.beff_fwd_torch(*bargs, tc=16)[:1]).sum(), (mi, beff))
    for x, y in zip(g_fn, g_ad):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-10,
                                   atol=1e-12 * float(y.abs().max()))


def test_adjoint_contract():
    r"""The plain adjoints refuse a ``chk`` of another chunk length, and
    return None where an input is absent; without B1 every coil gets the
    same rf gradient row."""
    a = _tt(_rfgr_args(N=1, nS=20, nT=24, nC=2))
    args = [a[k] for k in RFGR_KEYS]
    args[3] = args[4] = None          # no dfg, no b1
    args[8] = args[9] = None          # no flow
    chk = bloch.rfgr_fwd_torch(a['mi'], *args, tc=8)
    g = torch.ones_like(chk)
    dmi, drf2, dgr2, dloc, ddfg, db1, dvel = bloch.rfgr_bwd(chk, g, *args,
                                                            tc=8)
    assert ddfg is None and db1 is None and dvel is None
    assert drf2.shape == (1, 4, 24) and dgr2.shape == (1, 3, 24)
    torch.testing.assert_close(drf2[:, 0], drf2[:, 1], rtol=0, atol=0)
    with pytest.raises(ValueError, match='chunk ends'):
        bloch.rfgr_bwd_torch(chk, g, *args, tc=12)
    b = _tt(_beff_args(B=10, nT=24))
    bchk = bloch.beff_fwd_torch(b['mi'], b['beff'], None, None, b['g2pd'],
                                tc=8)
    with pytest.raises(ValueError, match='chunk ends'):
        bloch.beff_bwd(bchk, bchk, b['beff'], None, None, b['g2pd'], tc=6)


@pytest.mark.parametrize('nT,tc', [(1000, 250), (512, 256), (96, 96),
                                   (300, 150), (257, 1), (7, 7)])
def test_pick_tc(nT, tc):
    assert bloch.pick_tc(nT) == tc
    assert nT % tc == 0 and tc <= bloch.TC_MAX


@pytest.mark.parametrize('nT', [24, 600])
def test_chk_contract(nT):
    r"""The plain versions end on the final state and checkpoint every
    ``pick_tc(nT)`` steps; the engines return ``chk``'s last entry."""
    a = _rfgr_args(N=1, nS=20, nT=nT, nC=1, dtype=np.float64)
    t = _tt(a)
    args = (t['mi'], t['rf2'], t['gr2'], t['loc_p'], t['dfg'], t['b1_p'],
            t['E'], t['e1_1'], t['g2pd'], t['vel_p'], t['tarr2'])
    chk = bloch.rfgr_fwd_torch(*args)
    tc = bloch.pick_tc(nT)
    assert chk.shape == (1, nT // tc, 3, 20)
    # each checkpoint restarts the rest of the pulse exactly
    t0 = (nT // tc - 1) * tc
    tail = bloch.rfgr_fwd_torch(
        chk[:, -2] if nT // tc > 1 else t['mi'], t['rf2'][..., t0:],
        t['gr2'][..., t0:], *args[3:10], t['tarr2'][..., t0:], tc=tc)
    np.testing.assert_allclose(tail[:, -1].numpy(), chk[:, -1].numpy(),
                               atol=1e-13)

    b = _beff_args(B=30, nT=nT, dtype=np.float64)
    tb = _tt(b)
    bchk = bloch.beff_fwd_torch(tb['mi'], tb['beff'], tb['E'], tb['e1_1'],
                                tb['g2pd'])
    assert bchk.shape == (nT // tc, 3, 30)
    out = tsims.blochsim(tb['mi'].T[None], tb['beff'].permute(2, 0, 1)[None],
                         T1=1.0, T2=0.05)
    assert out.shape == (1, 30, 3)
    with pytest.raises(ValueError, match='must divide'):
        bloch.beff_fwd_torch(tb['mi'], tb['beff'], None, None, tb['g2pd'],
                             tc=nT + 1)


def test_wrappers_take_plain_version_on_cpu_without_counting():
    a = _tt(_rfgr_args(N=1, nS=10, nT=12))
    b = _tt(_beff_args(B=10, nT=12))
    before = dict(bloch.LAUNCHES)
    rargs = (a['mi'], a['rf2'], a['gr2'], a['loc_p'], a['dfg'], None,
             None, None, a['g2pd'])
    chk = bloch.rfgr_fwd(*rargs)
    torch.testing.assert_close(chk, bloch.rfgr_fwd_torch(*rargs), rtol=0,
                               atol=0)
    g = torch.ones_like(chk)
    for x, y in zip(bloch.rfgr_bwd(chk, g, *rargs[1:]),
                    bloch.rfgr_bwd_torch(chk, g, *rargs[1:])):
        assert (x is None and y is None) or torch.equal(x, y)
    bargs = (b['mi'], b['beff'], b['E'], b['e1_1'], b['g2pd'])
    bchk = bloch.beff_fwd(*bargs)
    torch.testing.assert_close(bchk, bloch.beff_fwd_torch(*bargs), rtol=0,
                               atol=0)
    for x, y in zip(bloch.beff_bwd(bchk, bchk, *bargs[1:]),
                    bloch.beff_bwd_torch(bchk, bchk, *bargs[1:])):
        assert torch.equal(x, y)
    assert bloch.LAUNCHES == before
    with pytest.raises(ValueError, match='no Bloch kernel'):
        bloch.beff_fwd(b['mi'].to('meta'), b['beff'].to('meta'), None,
                       None, b['g2pd'].to('meta'))


def test_import_without_jax():
    r"""The port imports, builds nothing and runs on the CPU with JAX
    made unimportable."""
    code = ('import sys; sys.modules["jax"] = None\n'
            'import torch, mrphy_tpu_torch as m\n'
            'from mrphy_tpu_torch.models.mobjs import Examples\n'
            'M = Examples.spincube().applypulse(Examples.pulse())\n'
            'assert M.shape == (1, 15, 3) and bool(torch.isfinite(M).all())\n'
            'assert not any(k.startswith("jax") and sys.modules[k] '
            'for k in sys.modules)\n'
            'print(m.cuda_is_available())\n')
    r = subprocess.run([sys.executable, '-c', code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() in ('True', 'False')


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setattr(_build.shutil, 'which', lambda name: None)
    monkeypatch.setattr(_build.Path, 'exists', lambda self: False)
    with pytest.raises(_build.KernelBuildError, match='nvcc not found'):
        _build.nvcc_path()


def test_build_key_follows_sources(tmp_path, monkeypatch):
    (tmp_path / 'a.cu').write_text('// one')
    monkeypatch.setattr(_build, 'CSRC_DIR', tmp_path)
    k1 = _build._digest(_build._sources())
    (tmp_path / 'a.cu').write_text('// two')
    assert _build._digest(_build._sources()) != k1
    assert [p.name for p in _build._sources()] == ['a.cu']


def test_kernel_sources_present():
    names = {p.name for p in (_build.Path(_build.__file__).parent
                              / 'csrc').glob('*.cu')}
    assert names == {'rfgr_fwd.cu', 'beff_fwd.cu', 'rfgr_bwd.cu',
                     'beff_bwd.cu', 'mc_fwd.cu', 'mc_bwd.cu'}
    assert '--use_fast_math' not in _build.NVCC_FLAGS
    assert 'arch=compute_90a,code=sm_90a' in _build.NVCC_FLAGS
