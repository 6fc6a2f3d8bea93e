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
    r"""Every module of the port imports, builds nothing and runs on the
    CPU (``device='cpu'``: excite, acquire, back-project) with JAX and the
    JAX package made unimportable."""
    code = ('import sys; sys.modules["jax"] = None\n'
            'sys.modules["mrphy_tpu"] = None\n'
            'import importlib, pkgutil, torch, mrphy_tpu_torch as m\n'
            'for i in pkgutil.walk_packages(m.__path__, m.__name__ + "."):\n'
            '    importlib.import_module(i.name)\n'
            'from mrphy_tpu_torch.models.mobjs import Examples\n'
            'from mrphy_tpu_torch.ops import signal\n'
            'from mrphy_tpu_torch.utils import spiral2d\n'
            'cube = Examples.spincube(device="cpu")\n'
            'p = Examples.pulse(device="cpu")\n'
            'M = cube.applypulse(p, doUpdate=True)\n'
            'assert M.shape == (1, 15, 3) and bool(torch.isfinite(M).all())\n'
            'gr, _ = spiral2d(3.0, 4, direction="out")\n'
            's = cube.acquire(torch.as_tensor(gr), T2s_=0.05)\n'
            'x = signal.signal_adjoint(s, cube.loc_, torch.zeros(1, 3, '
            's.shape[2]))\n'
            'assert x.shape == (1, 15, 2) and bool(torch.isfinite(x).all())\n'
            'assert not any(k.startswith(("jax", "mrphy_tpu.")) and '
            'sys.modules[k] for k in sys.modules)\n'
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
                     'beff_bwd.cu', 'mc_fwd.cu', 'mc_bwd.cu', 'sig_fwd.cu',
                     'sig_adj.cu', 'sig_vjp.cu', 'nufft_sample.cu',
                     'nufft_spread.cu', 'nufft_dk.cu', 'spgr_fwd.cu',
                     'spgr_bwd.cu', 'match.cu', 'cpmg_fwd.cu',
                     'cpmg_bwd.cu', 'xspgr_fwd.cu', 'xspgr_bwd.cu',
                     'xcpmg_fwd.cu', 'xcpmg_bwd.cu', 'bssfp_fwd.cu',
                     'bssfp_bwd.cu', 'xmt_fwd.cu', 'xmt_bwd.cu',
                     'cpmg_bwd_lanes.cu', 'xspgr_bwd_lanes.cu',
                     'spgr_bwd_lanes.cu', 'xcpmg_bwd_lanes.cu',
                     'xspgr_fwd_lanes.cu', 'xcpmg_fwd_lanes.cu',
                     'cpmg_fwd_lanes.cu', 'xmt_bwd_lanes.cu',
                     'spgr_fwd_lanes.cu'}
    assert '--use_fast_math' not in _build.NVCC_FLAGS
    assert 'arch=compute_90a,code=sm_90a' in _build.NVCC_FLAGS


# the JAX package's top-level names that wait for later slices of the port
NOT_PORTED = {'dixon', 'field', 'parallel', 'tpu_is_available'}


def test_top_level_names_and_flat_paths_match_jax():
    r"""The port's top-level ``__all__`` holds ``mrphy_tpu``'s, less the
    names not ported yet, and each module among them also imports by its
    flat path (``import mrphy_tpu_torch.signal``), as in ``mrphy_tpu``."""
    import importlib
    import types
    import mrphy_tpu as jm
    import mrphy_tpu_torch as tm
    assert not NOT_PORTED & set(tm.__all__)
    assert set(jm.__all__) - NOT_PORTED <= set(tm.__all__)
    for name in sorted(set(jm.__all__) - NOT_PORTED):
        if isinstance(getattr(jm, name), types.ModuleType):
            assert importlib.import_module(f'mrphy_tpu_torch.{name}') is \
                getattr(tm, name), name


# The deliberate differences of the port's public signatures from the JAX
# package's (the port's name → the differences, as _sig_diffs spells them).
# Everywhere: a constructor or entry point may add `device=` (the port's
# objects and arrays default to the CUDA card) and drops the JAX-only
# `_pallas_interpret` switch of the TPU kernels.
SIG_DIFFS_EVERYWHERE = {'port only: device', 'JAX only: _pallas_interpret'}
SIG_DIFFS = {
    # the port's backends are 'auto' | 'torch' | 'cuda'; 'auto' takes the
    # kernels on CUDA tensors, as JAX's 'xla' default does not
    **{f'ops.epg.{n}': {'default: backend'}
       for n in ('epg_spgr', 'epg_cpmg', 'epgx_spgr', 'epgx_cpmg',
                 'epgx_mt_spgr')},
    'ops.routing.route': {'default: backend'},
    'ops.ssfp.bssfp_train': {'default: backend'},
    'models.mobjs.SpinArray.acquire': {'default: backend'},
    'models.mobjs.SpinCube.acquire': {'default: backend'},
    'ops.signal.signal': {'default: backend'},
    'ops.signal.signal_adjoint': {'default: backend'},
    # a port-only name: the kernels' argument planes of a signal call
    'ops.signal.signal_planes': {'port only'},
    # the gridding plan: 'auto' takes the kernels; the TPU's real-pair DFT
    # matrices are not carried (torch.fft)
    'ops.nufft.NufftPlan': {'default: interp', 'JAX only: dft_re',
                            'JAX only: dft_im'},
    # the kernels' geometry of a plan
    'ops.nufft.NufftPlan.geom': {'port only'},
    # the schedule's dtype (JAX's follows its x64 switch)
    'ops.epg.rf_spoil_phases': {'port only: dtype'},
    # torch.optim keeps its own state; an optimizer is built over its
    # parameters; the loss's options ride in `args`
    'design.joint.design_step': {'JAX only: opt_state', 'JAX only: kw'},
    'design.joint.make_optimizer': {'port only: params'},
    # torch.Generator in place of a JAX PRNG key
    **{f'utils.coils.{n}': {'port only: generator', 'JAX only: key'}
       for n in ('add_noise', 'gfactor_replica', 'replica_std')},
    # passes every keyword of SpinArray.applypulse on through **kw
    'models.mobjs.SpinBolus.applypulse': {
        f'JAX only: {n}' for n in ('doEmbed', 'doRelax', 'doUpdate', 'mesh',
                                   'loc', 'loc_', 'b1Map', 'b1Map_')},
    # no TPU in the port (`is_cuda` stays)
    'models.mobjs.Pulse.is_tpu': {'JAX only'},
    'models.mobjs.SpinArray.is_tpu': {'JAX only'},
}


def _default(v):
    r"""A parameter's default, dtypes by name (``torch.float32`` and
    ``jnp.float32`` are both ``'float32'``)."""
    if isinstance(v, torch.dtype):
        return str(v).removeprefix('torch.')
    if isinstance(v, type) and hasattr(v, 'dtype'):
        return np.dtype(v).name
    return v


def _sig_diffs(t, j):
    r"""The differences of two callables' parameters: names on one side
    only, kinds, defaults and the order of the shared names."""
    import inspect
    tp, jp = (inspect.signature(f).parameters for f in (t, j))
    out = {f'port only: {n}' for n in tp if n not in jp}
    out |= {f'JAX only: {n}' for n in jp if n not in tp}
    for n in set(tp) & set(jp):
        if tp[n].kind != jp[n].kind:
            out.add(f'kind: {n}')
        a, b = _default(tp[n].default), _default(jp[n].default)
        if type(a) is not type(b) or (a != b and a == a):  # NaN = NaN
            out.add(f'default: {n}')
    if [n for n in tp if n in jp] != [n for n in jp if n in tp]:
        out.add('order')
    return out


def _public_callables():
    r"""``(name, port object, JAX object or None)`` for every callable in
    ``__all__`` of each module of the port that has a counterpart in the
    JAX package (private modules and the port-only ``kernels`` and
    ``interop`` aside; a name a package re-exports is held where it is
    defined), and for each public method and property of the classes
    among them."""
    import importlib
    import inspect
    import pkgutil
    import mrphy_tpu_torch as tm
    for info in pkgutil.walk_packages(tm.__path__, 'mrphy_tpu_torch.'):
        rel = info.name.removeprefix('mrphy_tpu_torch.')
        if rel.split('.')[0] in ('kernels', 'interop') or any(
                p.startswith('_') for p in rel.split('.')):
            continue
        tmod = importlib.import_module(info.name)
        jmod = importlib.import_module(f'mrphy_tpu.{rel}')
        for n in getattr(tmod, '__all__', ()):
            t, j = getattr(tmod, n), getattr(jmod, n, None)
            if not callable(t) or getattr(t, '__module__',
                                          info.name) != info.name:
                continue
            yield f'{rel}.{n}', t, j
            if inspect.isclass(t) and j is not None:
                for m in sorted(set(vars(t)) | set(vars(j))):
                    if m.startswith('_'):
                        continue
                    tm_, jm_ = getattr(t, m, None), getattr(j, m, None)
                    if tm_ is None or jm_ is None or callable(tm_):
                        yield f'{rel}.{n}.{m}', tm_, jm_


def test_public_signatures_match_jax():
    r"""Every public function, class and method of the port takes the JAX
    package's parameters (names, kinds, defaults, order), less the
    deliberate differences of SIG_DIFFS, each of which must still hold."""
    seen, bad = set(), {}
    for name, t, j in _public_callables():
        if t is None or j is None:
            diffs = {'port only' if j is None else 'JAX only'}
        else:
            try:
                diffs = _sig_diffs(t, j) - SIG_DIFFS_EVERYWHERE
            except (TypeError, ValueError):      # no signature: attributes
                continue
        if diffs != SIG_DIFFS.get(name, set()):
            bad[name] = sorted(diffs)
        seen.add(name)
    assert not bad, bad
    assert set(SIG_DIFFS) <= seen, set(SIG_DIFFS) - seen
    assert {'ops.slowsims.blochsim', 'ops.slowsims.blochsim_mc',
            'ops.slowsims.freeprec', 'utils.girf.apply_girf',
            'utils.interp.interp1d_apply', 'models.mobjs.SpinCube'} <= seen


@pytest.mark.parametrize('call', ['blochsim', 'blochsim_mc', 'freeprec'])
def test_slowsims_take_mesh_none(call):
    r"""The autodiff oracles take ``mesh=None`` as JAX's do and refuse a
    mesh with the message of every other entry point."""
    from mrphy_tpu_torch.ops import slowsims
    M = torch.tensor([[0.0, 0.0, 1.0]], dtype=torch.float64)
    B = torch.full((1, 3, 3), 0.01, dtype=torch.float64)
    args = {'blochsim': ((M, B), {}),
            'blochsim_mc': ((M, 0.1 * M, B),
                            dict(T1a=1.0, T2a=0.1, T1b=1.0, T2b=0.01,
                                 kab=1.0, kba=10.0)),
            'freeprec': ((M, 0.01), dict(T1=1.0, T2=0.1))}[call]
    fn = getattr(slowsims, call)
    out = fn(*args[0], **args[1])
    out2 = fn(*args[0], **args[1], mesh=None)
    for a, b in zip(out if isinstance(out, tuple) else (out,),
                    out2 if isinstance(out2, tuple) else (out2,)):
        assert torch.equal(a, b)
    with pytest.raises(NotImplementedError, match='mesh'):
        fn(*args[0], **args[1], mesh=object())


def test_apply_girf_axis_dim_and_interp_precision_have_no_effect():
    r"""``apply_girf(axis_dim=)`` and ``interp1d_apply(precision=)`` are
    accepted, as JAX's, and change nothing."""
    from mrphy_tpu_torch.utils import apply_girf, interp1d_apply
    rng = np.random.default_rng(0)
    gr = torch.as_tensor(rng.standard_normal((2, 3, 16)))
    h = torch.as_tensor([0.7, 0.2, 0.1], dtype=torch.float64)
    assert torch.equal(apply_girf(gr, h, axis_dim=1), apply_girf(gr, h))
    C = torch.as_tensor(rng.standard_normal((5, 16)))
    assert torch.equal(interp1d_apply(C, gr, -1, precision='highest'),
                       interp1d_apply(C, gr))


def test_epg_and_mrf_names():
    r"""``epg.__all__`` and ``mrf.__all__`` are the names the slices so far
    port, each a name of the JAX module."""
    from mrphy_tpu.ops import epg as jepg, mrf as jmrf
    from mrphy_tpu_torch.ops import epg as tepg, mrf as tmrf
    ported = {tepg: {'epg_state', 'epg_rf', 'epg_grad', 'epg_relax',
                     'epg_diffusion', 'epg_spgr', 'epg_cpmg', 'ir_prep',
                     'rf_spoil_phases', 'epgx_state', 'epgx_rf',
                     'epgx_relax', 'epgx_spgr', 'epgx_cpmg', 'mt_lineshape',
                     'epgx_mt_relax', 'epgx_mt_rf', 'epgx_mt_spgr'},
              tmrf: {'Basis', 'MatchResult', 'pair_rotate', 'svd_basis',
                     'compress', 'dict_match', 'dict_match_compressed',
                     'match_refine'}}
    for mod, jmod in ((tepg, jepg), (tmrf, jmrf)):
        assert set(mod.__all__) == ported[mod]
        assert ported[mod] <= set(jmod.__all__)
        assert all(callable(getattr(mod, n)) for n in mod.__all__)
