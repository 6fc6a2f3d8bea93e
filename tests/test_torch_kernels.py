r"""The Bloch forward kernels of :mod:`mrphy_tpu_torch.kernels`: their
plain PyTorch versions against the TPU kernels they replace (JAX Pallas in
interpret mode, chunk-end states ``chk`` compared chunk by chunk), the
``chk`` contract, the CPU dispatch, and the build's error path.

The kernels themselves on the card: ``tests/test_torch_cuda.py``.

Tolerance: 2e-6 in float32 against Pallas interpret (the TPU kernels'
polynomial sincos vs the library sin/cos, ~1e-7 per step over ≤ 96
steps at rotation angles ≲ 1.5 rad), the bar ``tests/test_pallas.py``
uses for Pallas against XLA.
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
    torch.testing.assert_close(bloch.rfgr_fwd(*rargs),
                               bloch.rfgr_fwd_torch(*rargs), rtol=0, atol=0)
    bargs = (b['mi'], b['beff'], b['E'], b['e1_1'], b['g2pd'])
    torch.testing.assert_close(bloch.beff_fwd(*bargs),
                               bloch.beff_fwd_torch(*bargs), rtol=0, atol=0)
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
    assert names == {'rfgr_fwd.cu', 'beff_fwd.cu'}
    assert '--use_fast_math' not in _build.NVCC_FLAGS
    assert 'arch=compute_90a,code=sm_90a' in _build.NVCC_FLAGS
