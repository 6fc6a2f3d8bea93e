r"""The port's object model (:mod:`mrphy_tpu_torch.models.mobjs`) against
the JAX package's, on state carried across with
:mod:`mrphy_tpu_torch.interop` (numpy dicts from ``asdict``).

Tolerance: 1e-10 in float64 (the XLA engine and the port's plain path
compute the same arithmetic; they differ by rounding only). The
``Examples`` in float32 are compared against float64 instead: two float32
engines each drift ~2.5e-5 from the float64 result over the 512-step demo
pulse (a fixed relative rounding of a spin's field adds up coherently),
so their mutual distance says nothing about either.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mrphy_tpu.models import mobjs as jm
from mrphy_tpu_torch import interop
from mrphy_tpu_torch.models import mobjs as tm

F64 = jnp.float64


def _masked_cube8(seed=0):
    rng = np.random.default_rng(seed)
    mask = rng.random((1, 8, 8, 8)) < 0.6
    cube = jm.SpinCube((1, 8, 8, 8), jnp.asarray([[20., 22., 18.]], F64),
                       mask=mask, ofst=jnp.asarray([[0.5, -1., 2.]], F64),
                       T1_=jnp.asarray(rng.random((1, int(mask.sum()))) + 0.5,
                                       F64),
                       T2_=jnp.asarray([[0.05]], F64), dtype=F64)
    cube.df_ = jnp.asarray((rng.random((1, cube.nM)) - 0.5) * 100, F64)
    cube.M_ = jnp.asarray(rng.random((1, cube.nM, 3)) - 0.5, F64)
    nT = 40
    t = np.arange(nT)
    rf = 0.1 * np.stack([np.cos(t / 7), np.sin(t / 5)])[None]
    gr = np.stack([np.ones(nT), np.sin(t / 9), np.cos(t / 11)])[None]
    pulse = jm.Pulse(jnp.asarray(rf, F64), jnp.asarray(gr, F64), dtype=F64)
    return cube, pulse


def _port(cube, pulse, embed=True):
    tc = interop.spincube_from_numpy(cube.asdict(doEmbed=embed),
                                     dtype=torch.float64)
    tp = interop.pulse_from_numpy(pulse.asdict(), dtype=torch.float64)
    return tc, tp


@pytest.mark.parametrize('embed', [True, False], ids=['grid', 'compact'])
def test_interop_masked_cube_state(embed):
    cube, pulse = _masked_cube8()
    tc, tp = _port(cube, pulse, embed)
    assert tc.shape == cube.shape and tc.nM == cube.nM
    assert np.array_equal(tc.mask, cube.mask)
    for k in ('loc_', 'df_', 'T1_', 'T2_', 'gam_', 'M_'):
        np.testing.assert_allclose(getattr(tc, k).numpy(),
                                   np.asarray(getattr(cube, k)), atol=1e-12,
                                   err_msg=k)
    for k in ('rf', 'gr', 'dt', 'gmax', 'smax', 'rfmax'):
        np.testing.assert_array_equal(getattr(tp, k).numpy(),
                                      np.asarray(getattr(pulse, k)))


def test_embed_extract_vs_jax():
    cube, pulse = _masked_cube8()
    tc, _ = _port(cube, pulse)
    np.testing.assert_array_equal(tc.M.numpy(), np.asarray(cube.M))
    np.testing.assert_array_equal(tc.T1.numpy(), np.asarray(cube.T1))
    assert np.isnan(tc.M.numpy()).sum() == 3 * (512 - cube.nM)
    np.testing.assert_array_equal(tc.extract(tc.M).numpy(),
                                  np.asarray(cube.M_))
    crds = [0, [1, 2], [3], [4, 5]]
    np.testing.assert_array_equal(tc.crds_(crds)[1], cube.crds_(crds)[1])
    np.testing.assert_array_equal(tc.mask_(mask=cube.mask),
                                  cube.mask_(mask=cube.mask))


@pytest.mark.parametrize('doFuse', [True, False])
def test_masked_cube_applypulse_vs_jax(doFuse):
    cube, pulse = _masked_cube8()
    tc, tp = _port(cube, pulse)
    ref = cube.applypulse(pulse, doEmbed=True, doFuse=doFuse)
    out = tc.applypulse(tp, doEmbed=True, doFuse=doFuse)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-10)
    ref_fp = cube.freeprec(2e-3)
    np.testing.assert_allclose(tc.freeprec(2e-3).numpy(), np.asarray(ref_fp),
                               atol=1e-12)


def test_examples_vs_jax_f64():
    jc, jp = jm.Examples.spincube(F64), jm.Examples.pulse(F64)
    tc, tp = tm.Examples.spincube(torch.float64), tm.Examples.pulse(
        torch.float64)
    np.testing.assert_allclose(tc.loc_.numpy(), np.asarray(jc.loc_),
                               atol=1e-14)
    np.testing.assert_allclose(tc.df_.numpy(), np.asarray(jc.df_),
                               atol=1e-10)
    np.testing.assert_allclose(tp.rf.numpy(), np.asarray(jp.rf), atol=1e-12)
    np.testing.assert_allclose(tp.gr.numpy(), np.asarray(jp.gr), atol=1e-12)
    ref = np.asarray(jc.applypulse(jp, doEmbed=True))
    for doFuse in (True, False):
        out = tc.applypulse(tp, doEmbed=True, doFuse=doFuse).numpy()
        np.testing.assert_allclose(out, ref, atol=1e-10)
    # the interop-built objects are the same objects
    ic, ip = _port(jc, jp)
    np.testing.assert_allclose(ic.applypulse(ip).numpy(),
                               np.asarray(jc.applypulse(jp)), atol=1e-10)
    # float32 examples: within f32 accumulation of the float64 result
    out32 = tm.Examples.spincube().applypulse(tm.Examples.pulse())
    assert out32.dtype == torch.float32
    np.testing.assert_allclose(out32.numpy(), np.asarray(jc.applypulse(jp)),
                               atol=1e-4)


def test_spinbolus_vs_jax():
    jb = jm.Examples.spinbolus(F64)
    jc, jp = jm.Examples.spincube(F64), jm.Examples.pulse(F64)
    tb = interop.spinbolus_from_numpy(jb.asdict(), dtype=torch.float64)
    tp = interop.pulse_from_numpy(jp.asdict(), dtype=torch.float64)
    np.testing.assert_array_equal(tb.vel_.numpy(), np.asarray(jb.vel_))
    ref = jb.applypulse(jp, loc_=jc.loc_, df_=jc.df_)
    out = tb.applypulse(tp, loc_=torch.as_tensor(np.asarray(jc.loc_)),
                        df_=torch.as_tensor(np.asarray(jc.df_)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-10)
    with pytest.raises(ValueError, match='fused'):
        tb.applypulse(tp, loc_=torch.zeros(1, 15, 3), doFuse=False)


def test_spinarray_b1_and_pulse2beff_vs_jax():
    rng = np.random.default_rng(3)
    ja = jm.Examples.spinarray(F64)
    jc, jp = jm.Examples.spincube(F64), jm.Examples.pulse(F64)
    ta = interop.spinarray_from_numpy(ja.asdict(), dtype=torch.float64)
    tp = interop.pulse_from_numpy(jp.asdict(), dtype=torch.float64)
    b1 = rng.random((1, 15, 2)) - 0.5
    loc = np.asarray(jc.loc_)
    kw_j = dict(loc_=jc.loc_, b1Map_=jnp.asarray(b1, F64), df_=jc.df_)
    kw_t = dict(loc_=torch.as_tensor(loc), b1Map_=torch.as_tensor(b1),
                df_=torch.as_tensor(np.asarray(jc.df_)))
    np.testing.assert_allclose(ta.applypulse(tp, **kw_t).numpy(),
                               np.asarray(ja.applypulse(jp, **kw_j)),
                               atol=1e-10)
    np.testing.assert_allclose(
        ta.pulse2beff(tp, doEmbed=True, **kw_t).numpy(),
        np.asarray(ja.pulse2beff(jp, doEmbed=True, **kw_j)), atol=1e-12)


def test_object_semantics():
    cube = tm.Examples.spincube()
    assert cube.device == torch.device('cpu') and not cube.is_cuda
    assert cube.dtype == torch.float32 and cube.nM == 15
    assert cube.Δf_ is cube.df_ and cube.γ_ is cube.gam_
    c64 = cube.to(dtype=torch.float64)
    assert c64.M_.dtype == torch.float64 and cube.to() is cube
    np.testing.assert_allclose(c64.loc_.numpy(), cube.loc_.numpy())
    cube.T1 = torch.full((1, 3, 3, 3), 2.0)
    assert cube.T1_.shape == (1, 15) and float(cube.T1_.max()) == 2.0
    with pytest.raises(AttributeError, match='read-only'):
        cube.loc_ = cube.loc_
    with pytest.raises(ValueError, match='need loc xor loc_'):
        cube.spinarray.applypulse(tm.Examples.pulse())
    M_ = cube.applypulse(tm.Examples.pulse(), doUpdate=True)
    torch.testing.assert_close(cube.M_, M_, rtol=0, atol=0)
    p = tm.Pulse(gr=torch.ones(1, 3, 8))
    assert p.rf.shape == (1, 2, 8) and p.dt.shape == (1,)
    assert p.gmax.shape == (1, 3) and p.rfmax.shape == (1,)
    with pytest.raises(ValueError):
        tm.Pulse()
    with pytest.raises(TypeError, match='both'):
        tm.SpinArray((1, 2), gam=1.0, γ=1.0)
    with pytest.raises(TypeError, match='both'):
        cube.spinarray.freeprec(1e-3, df_=0.0, Δf_=0.0)
    d = tm.Examples.spincube().asdict()
    assert d['M'].shape == (1, 3, 3, 3, 3) and 'Δf' in d
