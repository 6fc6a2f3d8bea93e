r"""The port's design path (:mod:`mrphy_tpu_torch.design`) and the
utilities it calls, against the JAX package on the CPU, float64.

Inputs are made with numpy from a seed (or by the packages' ``Examples``)
and handed to both packages. Tolerances: 1e-12 for the utilities (the
same formulas, rounding only), 1e-9 for the design loss and its gradient
(the loss runs a Bloch simulation), 1e-8 for the losses of a 10-iteration
design.

The design problem is that of ``tests/test_design.py``: the ``Examples``
cube and pulse driven to ``[0, 0, -1]``, ``rfmax=12`` (above the demo
pulse's |rf| = 10, where the tan reparametrization is interior). The
trajectories are held at the default slew limit ``smax=12e3``; at
``test_design.py``'s 5e6 only the first loss and gradient are. At 5e6 an
iteration lets the gradient grow to thousands of G/cm (rotations of
~10³ rad per step), and the iterates depend chaotically on rounding: the
port's first loss and gradient agree with JAX's at ~1e-13, yet after one
Adam step the 10-iteration losses differ by 2e-6 and after three by
O(1). JAX against itself does the same: its ``'reconstruct'`` and
``'history'`` adjoints, or its own run from an rf scaled by 1 + 2⁻⁵²,
differ by 1e-6 after one step and O(1) after three. At 12e3 the port's
and JAX's trajectories agree to ~1e-12 over 10 iterations for every
optimizer.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mrphy_tpu import dt0, utils as ju
from mrphy_tpu.design import joint as jj
from mrphy_tpu.models import mobjs as jm
from mrphy_tpu_torch import interop, utils as tu
from mrphy_tpu_torch.design import joint as tj
from mrphy_tpu_torch.models import mobjs as tm

F64 = jnp.float64
CFG = dict(niter=10, lr=0.01, rfmax=12.0, smax=12e3, dt=float(dt0))


def _t(x):
    return torch.tensor(np.asarray(x), dtype=torch.float64)


def _jax(fn, *args):
    r"""``jax.jit(fn)(*args)`` compiled by XLA at its lowest optimisation
    level: each reference is small and runs once, so compiling it is
    nearly all of its cost."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={'xla_backend_optimization_level': 0})(*args)


def _jax_loss_grad(params, cfg, *args):
    r"""JAX's design loss and its gradient w.r.t. the design variables
    (``_loss_fn`` with ``doRelax``), compiled by :func:`_jax`."""
    return _jax(lambda p, *a: jax.value_and_grad(jj._loss_fn, has_aux=True)(
        p, cfg, *a, True), params, *args)


def _close(x, y, rtol=1e-12, err_msg=''):
    y = np.asarray(y)
    np.testing.assert_allclose(np.asarray(x), y, rtol=rtol,
                               atol=rtol * max(1.0, np.abs(y).max()),
                               err_msg=err_msg)


# --------------------------------------------------------------------------
# utilities
# --------------------------------------------------------------------------

def test_rf_and_slew_utils_vs_jax():
    rng = np.random.default_rng(0)
    rf = (rng.random((2, 2, 16, 3)) - 0.5) * 0.4
    rfmax = np.asarray([[0.2, 0.25, 0.3], [0.22, 0.3, 0.35]])
    for rm in (0.3, rfmax):
        trho_j, theta_j = ju.rf2trho_theta(jnp.asarray(rf), jnp.asarray(rm))
        trho_t, theta_t = tu.rf2trho_theta(_t(rf), _t(rm))
        _close(trho_t, trho_j)
        _close(theta_t, theta_j)
        _close(tu.trho_theta2rf(trho_t, theta_t, _t(rm)),
               ju.trho_theta2rf(trho_j, theta_j, jnp.asarray(rm)))
        lrho_j, _ = ju.rf2lrho_theta(jnp.asarray(rf), jnp.asarray(rm))
        lrho_t, _ = tu.rf2lrho_theta(_t(rf), _t(rm))
        _close(lrho_t, lrho_j)
        _close(tu.lrho_theta2rf(lrho_t, theta_t, _t(rm)),
               ju.lrho_theta2rf(lrho_j, theta_j, jnp.asarray(rm)))
        _close(tu.rfclamp(_t(rf), _t(rm)),
               ju.rfclamp(jnp.asarray(rf), jnp.asarray(rm)))
    c = tu.rf_r2c(_t(rf))
    assert c.is_complex() and c.shape == (2, 1, 16, 3)
    _close(c.numpy(), np.asarray(ju.rf_r2c(jnp.asarray(rf))))
    _close(tu.rf_c2r(c), rf)
    s = (rng.random((2, 3, 16)) - 0.5) * 2e4
    for smax in (12e3, rng.random((2, 3)) * 1e4 + 5e3):
        ts_j = ju.s2ts(jnp.asarray(np.clip(s, -0.99 * np.min(smax),
                                           0.99 * np.min(smax))),
                       jnp.asarray(smax))
        ts_t = tu.s2ts(_t(np.clip(s, -0.99 * np.min(smax),
                                  0.99 * np.min(smax))), _t(smax))
        _close(ts_t, ts_j)
        _close(tu.ts2s(ts_t, _t(smax)), ju.ts2s(ts_j, jnp.asarray(smax)))
        _close(tu.sclamp(_t(s), _t(smax)),
               ju.sclamp(jnp.asarray(s), jnp.asarray(smax)))


def test_hardware_models_vs_jax():
    r"""GIRF convolution, SAR VOPs (and their compression), PNS."""
    rng = np.random.default_rng(1)
    gr = rng.normal(size=(2, 3, 40))
    h = ju.exp_decay_girf(12, 4e-6, delay_samples=2, amps=(0.05, 0.02),
                          taus=(2e-5, 1e-4))
    np.testing.assert_array_equal(
        tu.exp_decay_girf(12, 4e-6, delay_samples=2, amps=(0.05, 0.02),
                          taus=(2e-5, 1e-4)), h)
    for girf in (h, rng.random((3, 7))):
        _close(tu.apply_girf(_t(gr), girf),
               ju.apply_girf(jnp.asarray(gr), jnp.asarray(girf)))
    A = rng.normal(size=(20, 3, 3)) + 1j * rng.normal(size=(20, 3, 3))
    Q = A @ np.conj(np.swapaxes(A, -1, -2))               # Hermitian PSD
    Qr_j, Qi_j, idx_j = ju.vop_compress(Q, 0.1)
    Qr_t, Qi_t, idx_t = tu.vop_compress(Q, 0.1)
    np.testing.assert_array_equal(idx_t, idx_j)
    _close(Qr_t, Qr_j)
    _close(Qi_t, Qi_j)
    rf = rng.normal(size=(2, 2, 30, 3)) * 0.1
    for Qi in (None, Qi_j):
        _close(tu.sar_vops(_t(rf), _t(Qr_j),
                           None if Qi is None else _t(Qi)),
               ju.sar_vops(jnp.asarray(rf), jnp.asarray(Qr_j),
                           None if Qi is None else jnp.asarray(Qi)))
    _close(tu.sar_vops(_t(rf[..., 0]), _t(Qr_j[:, :1, :1])),
           ju.sar_vops(jnp.asarray(rf[..., 0]), jnp.asarray(Qr_j[:, :1, :1])))
    _close(tu.pns_kernel(4e-6), ju.pns_kernel(4e-6))
    g = np.cumsum(rng.normal(size=(2, 3, 300)), -1) * 0.05
    kw = dict(smin=(5000.0, 6000.0, 7000.0), chronaxie=3e-4)
    _close(tu.pns_predict(_t(g), 4e-6, **kw),
           ju.pns_predict(jnp.asarray(g), 4e-6, **kw))
    _close(tu.pns_max(_t(g), 4e-6), ju.pns_max(jnp.asarray(g), 4e-6))


@pytest.mark.parametrize('kind', ['linear', 'cubic', 'nearest', 'previous',
                                  'next', 'quadratic'])
def test_interp_matrix_vs_jax(kind):
    from mrphy_tpu.utils import interp as jinterp
    from mrphy_tpu_torch.utils import interp as tinterp
    t_o = np.cumsum(np.random.default_rng(2).random(12) + 0.1)
    t_n = np.linspace(t_o[0], t_o[-1], 29)
    C = tinterp.interp_matrix(t_o, t_n, kind)
    _close(C, jinterp.interp_matrix(t_o, t_n, kind))
    y = np.random.default_rng(3).normal(size=(2, 12, 3))
    _close(tinterp.interp1d_apply(C, _t(y), axis=1),
           jinterp.interp1d_apply(C, jnp.asarray(y), axis=1))
    with pytest.raises(ValueError, match='extrapolate'):
        tinterp.interp_matrix(t_o, t_n + 1.0, kind)


@pytest.mark.parametrize('kind', ['linear', 'cubic'])
def test_pulse_interpT_vs_jax(kind):
    jp = jm.Examples.pulse(F64)
    tp = tm.Examples.pulse(torch.float64, device='cpu')
    for dt in (2 * dt0, 3e-6):
        a = jp.interpT(jnp.asarray(dt), kind=kind)
        b = tp.interpT(dt, kind=kind)
        assert b.rf.shape == a.rf.shape and b.gr.shape == a.gr.shape
        _close(b.rf, a.rf)
        _close(b.gr, a.gr)
        assert float(b.dt[0]) == float(a.dt[0])
    # refining doubles nT exactly, in float32 too (the dwell times are
    # compared in the pulse's dtype)
    p32 = tm.Examples.pulse(torch.float32, device='cpu')
    coarse = p32.interpT(2 * dt0, kind=kind)
    assert coarse.rf.shape[2] == 256
    assert coarse.interpT(dt0, kind=kind).rf.shape[2] == 512
    same = p32.interpT(dt0)
    assert same is not p32 and torch.equal(same.rf, p32.rf)


# --------------------------------------------------------------------------
# the design loop
# --------------------------------------------------------------------------

def _problem():
    jc, jp = jm.Examples.spincube(F64), jm.Examples.pulse(F64)
    Mtgt = np.tile([0., 0., -1.], (1, jc.nM, 1))
    tc = tm.Examples.spincube(torch.float64, device='cpu')
    tp = tm.Examples.pulse(torch.float64, device='cpu')
    return (jc, jp, jnp.asarray(Mtgt)), (tc, tp, _t(Mtgt))


def _jax_args(jc, Mtgt):
    return (jc.M_, jc.loc_, Mtgt, jc.T1_, jc.T2_, jc.gam_, jc.df_, None,
            None, None, None, None)


@pytest.fixture(scope='module')
def jax_adam():
    r"""JAX's 10-iteration Adam design through its per-iteration jit (one
    compile), with the state after iteration 5 as numpy."""
    (jc, jp, Mtgt), _ = _problem()
    cfg = jj.DesignConfig(**CFG)
    params = jj.init_params(jp.rf, jp.gr, cfg)
    opt_state = jj.make_optimizer(cfg).init(params)
    losses, at5 = [], None
    for it in range(cfg.niter):
        if it == 5:
            at5 = jax.tree.map(np.asarray, (params, opt_state))
        params, opt_state, loss, _ = jj._design_step_jit(
            params, opt_state, cfg, *_jax_args(jc, Mtgt), doRelax=True)
        losses.append(float(loss))
    return np.asarray(losses), at5


@pytest.fixture(scope='module')
def port_adam():
    _, (tc, tp, Mtgt) = _problem()
    return tj.design_pulse(tc, tp, Mtgt, cfg=tj.DesignConfig(**CFG))


def test_design_adam_losses_vs_jax(jax_adam, port_adam):
    pulse, losses = port_adam
    assert losses.shape == (10,) and losses.dtype == torch.float64
    np.testing.assert_allclose(losses.numpy(), jax_adam[0], rtol=1e-8)
    assert float(losses[-1]) < 0.5 * float(losses[0])


@pytest.mark.parametrize('optimizer', ['adamw', 'sgd', 'momentum'])
def test_design_losses_vs_jax(optimizer):
    (jc, jp, jM), (tc, tp, tM) = _problem()
    kw = dict(CFG, optimizer=optimizer)
    _, lj = jj.design_pulse(jc, jp, jM, cfg=jj.DesignConfig(**kw))
    _, lt = tj.design_pulse(tc, tp, tM, cfg=tj.DesignConfig(**kw))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-8)


def test_design_first_step_at_smax_5e6_vs_jax():
    r"""At ``tests/test_design.py``'s slew limit 5e6: the first loss and
    the gradient w.r.t. every design variable, through ``design_step``,
    against JAX's ``_loss_fn`` at rtol 1e-9."""
    (jc, jp, jM), (tc, tp, tM) = _problem()
    kw = dict(CFG, smax=5e6)
    jcfg, tcfg = jj.DesignConfig(**kw), tj.DesignConfig(**kw)
    pj = jj.init_params(jp.rf, jp.gr, jcfg)
    (lj, _), gj = _jax_loss_grad(pj, jcfg, *_jax_args(jc, jM))
    params = tj.init_params(tp.rf, tp.gr, tcfg)
    opt = tj.make_optimizer(tcfg, params)
    args = (tc.M_, tc.loc_, tM, tc.T1_, tc.T2_, tc.gam_, tc.df_, None,
            None, None, None, None, True)
    loss, _ = tj.design_step(params, opt, tcfg, *args)
    _close(loss, lj, rtol=1e-9)
    for k in params:
        _close(params[k].grad, gj[k], rtol=1e-9, err_msg=k)


def test_design_limits_hold(port_adam):
    pulse, _ = port_adam
    assert pulse.rf.shape == (1, 2, 512) and pulse.dtype == torch.float64
    assert float(torch.linalg.vector_norm(pulse.rf, dim=1).max()) <= \
        CFG['rfmax'] + 1e-4
    s = tu.g2s(pulse.gr, CFG['dt'])
    assert float(s.abs().max()) <= CFG['smax'] * (1 + 1e-4)
    assert float(pulse.smax.max()) == CFG['smax']


def test_lbfgs_reduces_the_loss(port_adam):
    r"""torch's L-BFGS (strong Wolfe line search, restarted after a step
    that moved nothing) takes other steps than optax's: held to the
    behaviour ``tests/test_design.py`` asks of optax's."""
    _, (tc, tp, Mtgt) = _problem()
    pulse, losses = tj.design_pulse(
        tc, tp, Mtgt, cfg=tj.DesignConfig(**dict(CFG, optimizer='lbfgs')))
    assert float(losses[-1]) < float(losses[0])
    assert float(losses[-1]) <= 1.5 * float(port_adam[1][-1])
    assert float(torch.linalg.vector_norm(pulse.rf, dim=1).max()) <= \
        CFG['rfmax'] + 1e-4


def test_make_optimizer_names():
    params = {'x': torch.zeros(3, requires_grad=True)}
    kinds = {'adam': torch.optim.Adam, 'adamw': torch.optim.AdamW,
             'sgd': torch.optim.SGD, 'momentum': torch.optim.SGD,
             'lbfgs': torch.optim.LBFGS}
    for name, kind in kinds.items():
        opt = tj.make_optimizer(tj.DesignConfig(optimizer=name), params)
        assert type(opt) is kind
    adamw = tj.make_optimizer(tj.DesignConfig(optimizer='adamw'), params)
    assert adamw.defaults['weight_decay'] == 1e-4
    with pytest.raises(ValueError, match='nadam'):
        tj.make_optimizer(tj.DesignConfig(optimizer='nadam'), params)


def test_interop_continues_a_jax_design(jax_adam):
    r"""5 JAX iterations, carried across with :mod:`interop`, then 5 in
    the port: the losses of JAX's 10."""
    losses_j, (params5, opt5) = jax_adam
    _, (tc, _, Mtgt) = _problem()
    cfg = tj.DesignConfig(**CFG)
    params = interop.design_params_from_numpy(params5, dtype=torch.float64,
                                              device='cpu')
    assert all(p.is_leaf and p.requires_grad for p in params.values())
    opt = tj.make_optimizer(cfg, params)
    opt.state.update(interop.adam_state_from_numpy(opt5, params))
    args = (tc.M_, tc.loc_, Mtgt, tc.T1_, tc.T2_, tc.gam_, tc.df_, None,
            None, None, None, None, True)
    losses = [float(tj.design_step(params, opt, cfg, *args)[0])
              for _ in range(5)]
    np.testing.assert_allclose(losses, losses_j[5:], rtol=1e-8)
    with pytest.raises(ValueError, match='Adam'):
        interop.adam_state_from_numpy((), params)


def test_loss_terms_vs_jax():
    r"""Every term of the design loss (MLS fidelity with weights, RF
    power, gmax hinge², SAR VOP hinge², PNS hinge², through a GIRF, with
    a 2-coil B1 map) and its gradient against JAX's ``_loss_fn``."""
    rng = np.random.default_rng(4)
    nM, nT, nC = 8, 32, 2
    M0 = np.tile([0., 0., 1.], (1, nM, 1))
    loc = rng.uniform(-2, 2, (1, nM, 3))
    rf = rng.normal(size=(1, 2, nT, nC)) * 0.05
    gr = np.arange(nT) * np.asarray([0.04, -0.03, 0.02])[None, :, None]
    b1 = 0.5 + 0.5 * rng.random((1, nM, 2, nC))
    Mtgt = rng.normal(size=(1, nM, 3))
    w = rng.random((1, nM))
    girf = ju.exp_decay_girf(6, 4e-6, amps=(0.05,), taus=(2e-5,))
    A = rng.normal(size=(3, nC, nC)) + 1j * rng.normal(size=(3, nC, nC))
    Qr, Qi, _ = ju.vop_compress(A @ np.conj(np.swapaxes(A, -1, -2)), 0.1)
    kw = dict(niter=1, loss='mls', rfmax=(0.25, 0.3), smax=12e3,
              dt=float(dt0), lam_pow=0.3, lam_gmax=2.0, gmax=0.05,
              lam_sar=0.5, sar_limit=1e-4, lam_pns=1e-4, pns_limit=10.0)
    jcfg, tcfg = jj.DesignConfig(**kw), tj.DesignConfig(**kw)
    fields = (M0, loc, Mtgt, np.asarray([[1.]]), np.asarray([[0.05]]),
              np.asarray([[4257.6]]), rng.normal(size=(1, nM)) * 20, b1, w,
              girf, Qr, Qi)
    pj = jj.init_params(jnp.asarray(rf), jnp.asarray(gr), jcfg)
    (lj, _), gj = _jax_loss_grad(pj, jcfg, *(jnp.asarray(f)
                                             for f in fields))
    pt = tj.init_params(_t(rf), _t(gr), tcfg)
    lt, _ = tj._loss_fn(pt, tcfg, *(_t(f) for f in fields), True)
    lt.backward()
    _close(lt.detach(), lj, rtol=1e-9)
    for k in pt:
        _close(pt[k].grad, gj[k], rtol=1e-9, err_msg=k)
    # every penalty is active here, and each moves the loss
    for lam in ('lam_pow', 'lam_gmax', 'lam_sar', 'lam_pns'):
        off = dataclasses.replace(tcfg, **{lam: 0.0})
        with torch.no_grad():
            assert float(tj._loss_fn(pt, off, *(_t(f) for f in fields),
                                     True)[0]) < float(lt), lam


def test_design_multiscale_and_refusals():
    _, (tc, tp, Mtgt) = _problem()
    cfg = tj.DesignConfig(lr=0.01, rfmax=12.0, smax=12e3)
    p2, losses = tj.design_multiscale(tc, tp, Mtgt, dts=[2 * dt0, dt0],
                                      niters=[4, 6], cfg=cfg)
    assert [tuple(x.shape) for x in losses] == [(4,), (6,)]
    assert p2.rf.shape[2] == tp.rf.shape[2]
    assert bool(torch.isfinite(torch.cat(losses)).all())
    assert float(losses[1].min()) < float(losses[0][0])
    with pytest.raises(NotImplementedError, match='checkpoint'):
        tj.design_pulse(tc, tp, Mtgt, cfg=cfg, checkpoint=object())
    with pytest.raises(NotImplementedError, match='mesh'):
        tj.design_pulse(tc, tp, Mtgt, cfg=cfg, mesh=object())
    with pytest.raises(ValueError, match='uniform'):
        bad = tm.Pulse(tp.rf.expand(2, -1, -1), tp.gr.expand(2, -1, -1),
                       dt=[dt0, 2 * dt0])
        tj.design_multiscale(tc, bad, Mtgt, dts=[dt0], niters=[1], cfg=cfg)
