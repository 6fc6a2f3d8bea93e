r"""Parity of the PyTorch port's engines (:mod:`mrphy_tpu_torch.ops`) with
the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: 1e-10 in float64 against JAX's XLA engine (the same
arithmetic, rounding only); 2e-6 in float32 against JAX's Pallas kernels
in interpret mode (as ``tests/test_pallas.py`` runs them) — the port uses
the library sin/cos where the TPU kernels use a polynomial, ~1e-7 per
step; gradients against ``jax.grad`` of the reconstruction adjoint at
rtol 1e-7 (one case) and 1e-9 (every gradient of both engines, relative
to each gradient's largest value) in float64.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mrphy_tpu.ops import beffective as jbeff
from mrphy_tpu.ops import sims as jsims
from mrphy_tpu.ops import slowsims as jslow
from mrphy_tpu_torch.ops import beffective as tbeff
from mrphy_tpu_torch.ops import sims as tsims
from mrphy_tpu_torch.ops import slowsims as tslow

F64 = np.float64


def _mk(N=1, nS=96, nT=24, nC=1, seed=0, Nd=None):
    r"""Random engine inputs (numpy, float64): fields of physical size,
    per-spin T1/T2, a per-batch dt."""
    rng = np.random.default_rng(seed)
    Nd = (nS,) if Nd is None else Nd
    sh = (N,) + Nd
    return dict(
        Mi=rng.random(sh + (3,)) - 0.5,
        loc=(rng.random(sh + (3,)) * 2 - 1) * 4,
        df=(rng.random(sh) - 0.5) * 200,
        b1=rng.random(sh + (2, nC)) - 0.5,
        vel=(rng.random(sh + (3,)) - 0.5) * 50,
        rf=(rng.random((N, 2, nT, nC)) - 0.5) * 0.3,
        gr=(rng.random((N, 3, nT)) - 0.5) * 4,
        T1=rng.random(sh) + 0.5,
        T2=rng.random(sh) * 0.05 + 0.02,
        dt=np.full((N,), 4e-6) * (1 + np.arange(N)),
    )


def _kw(a, cfg, to):
    kw = {}
    if 'relax' in cfg:
        kw.update(T1=to(a['T1']), T2=to(a['T2']))
    if 'df' in cfg:
        kw['df'] = to(a['df'])
    if 'b1' in cfg:
        kw['b1Map'] = to(a['b1'])
    if 'vel' in cfg:
        kw['vel'] = to(a['vel'])
    kw['dt'] = to(a['dt'])
    return kw


def _jax(fn, *args):
    r"""``jax.jit(fn)(*args)`` compiled by XLA at its lowest optimisation
    level: each reference is small and runs once, so compiling it is
    nearly all of its cost."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={'xla_backend_optimization_level': 0})(*args)


def _j(dtype=F64):
    return lambda x: jnp.asarray(x, dtype)


def _t(dtype=torch.float64):
    return lambda x: torch.tensor(np.asarray(x), dtype=dtype)


RFGR_CASES = [
    dict(cfg=()),
    dict(cfg=('relax',)),
    dict(cfg=('relax', 'df')),
    dict(cfg=('relax', 'df', 'b1'), nC=2),
    dict(cfg=('relax', 'df', 'vel')),
    dict(cfg=('relax', 'df', 'b1'), N=2, Nd=(6, 8)),
]


@pytest.mark.parametrize('case', RFGR_CASES,
                         ids=lambda c: '+'.join(c['cfg']) or 'bare')
def test_blochsim_rfgr_f64_vs_jax_xla(case):
    a = _mk(N=case.get('N', 1), nC=case.get('nC', 1), Nd=case.get('Nd'))
    rf = a['rf'] if case.get('nC', 1) > 1 else a['rf'][..., 0]
    j, t = _j(), _t()
    ref = _jax(lambda *xs: jsims.blochsim_rfgr(
        *xs, backend='xla', **_kw(a, case['cfg'], j)),
        j(a['Mi']), j(rf), j(a['gr']), j(a['loc']))
    out = tsims.blochsim_rfgr(t(a['Mi']), t(rf), t(a['gr']), t(a['loc']),
                              backend='torch', **_kw(a, case['cfg'], t))
    assert out.shape == ref.shape and out.dtype == torch.float64
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-10)


@pytest.mark.parametrize('cfg', [(), ('relax',)], ids=['bare', 'relax'])
def test_blochsim_f64_vs_jax_xla(cfg):
    a = _mk(N=2, Nd=(5, 7))
    j, t = _j(), _t()
    beff = np.asarray(_jax(lambda rf, gr, loc, df, b1: jbeff.rfgr2beff(
        rf, gr, loc, df=df, b1Map=b1), *(j(a[k]) for k in
                                         ('rf', 'gr', 'loc', 'df', 'b1'))))
    ref = _jax(lambda m, b: jsims.blochsim(m, b, backend='xla',
                                           **_kw(a, cfg, j)),
               j(a['Mi']), j(beff))
    out = tsims.blochsim(t(a['Mi']), t(beff), backend='torch',
                         **_kw(a, cfg, t))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-10)


def _f32_case():
    a = _mk(nS=300, nT=32, seed=3)
    T1, T2 = np.asarray([[1.]]), np.asarray([[4e-2]])
    return a, T1, T2


def test_blochsim_rfgr_f32_vs_jax_pallas_interpret():
    a, T1, T2 = _f32_case()
    j, t = _j(np.float32), _t(torch.float32)
    kw = dict(df=a['df'], b1Map=a['b1'])
    ref = _jax(lambda mi, rf, gr, loc, T1, T2, df, b1: jsims.blochsim_rfgr(
        mi, rf, gr, loc, T1=T1, T2=T2, df=df, b1Map=b1,
        _pallas_interpret=True), *(j(x) for x in (
            a['Mi'], a['rf'], a['gr'], a['loc'], T1, T2, a['df'], a['b1'])))
    out = tsims.blochsim_rfgr(t(a['Mi']), t(a['rf']), t(a['gr']),
                              t(a['loc']), T1=t(T1), T2=t(T2),
                              **{k: t(v) for k, v in kw.items()})
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=2e-6)


@pytest.mark.parametrize('store', ['float32', 'bfloat16'])
def test_blochsim_f32_vs_jax_pallas_interpret(store):
    a, T1, T2 = _f32_case()
    beff = np.asarray(_jax(lambda rf, gr, loc, df: jbeff.rfgr2beff(
        rf, gr, loc, df=df), *(jnp.asarray(a[k], np.float32)
                               for k in ('rf', 'gr', 'loc', 'df'))))
    jbf = jnp.asarray(beff, jnp.dtype(store))
    # both sides get the same stored values (bf16 → exact in float32)
    tbf = torch.as_tensor(np.asarray(jbf.astype(np.float32))).to(
        getattr(torch, store))
    j, t = _j(np.float32), _t(torch.float32)
    ref = _jax(lambda mi, bf, T1, T2: jsims.blochsim(
        mi, bf, T1=T1, T2=T2, _pallas_interpret=True),
        j(a['Mi']), jbf, j(T1), j(T2))
    out = tsims.blochsim(t(a['Mi']), tbf, T1=t(T1), T2=t(T2))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=2e-6)


def test_freeprec_vs_jax():
    a = _mk(N=2, Nd=(4, 5))
    j, t = _j(), _t()
    dur = np.asarray([1e-3, 3e-3])
    for kw in ({}, dict(T1=a['T1'], T2=a['T2'], df=a['df'])):
        names = tuple(kw)
        jkw = [j(kw[k]) for k in names]
        ref = _jax(lambda mi, d, *v: jsims.freeprec(
            mi, d, **dict(zip(names, v))), j(a['Mi']), j(dur), *jkw)
        out = tsims.freeprec(t(a['Mi']), t(dur),
                             **{k: t(v) for k, v in kw.items()})
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-12)
        refs = _jax(lambda mi, d, *v: jslow.freeprec(
            mi, d, **dict(zip(names, v))), j(a['Mi']), j(dur), *jkw)
        outs = tslow.freeprec(t(a['Mi']), t(dur),
                              **{k: t(v) for k, v in kw.items()})
        np.testing.assert_allclose(outs.numpy(), np.asarray(refs),
                                   atol=1e-12)


@pytest.mark.parametrize('kind', ['bare', 'b1', 'df+b0'])
def test_rfgr2beff_vs_jax(kind):
    a = _mk(N=2, Nd=(3, 4), nC=2)
    j, t = _j(), _t()
    kw = {}
    if kind == 'b1':
        kw['b1Map'] = a['b1']
    if kind == 'df+b0':
        kw.update(df=a['df'], gam=np.full((2,), 4257.6))
    rf = a['rf'] if kind != 'bare' else a['rf'][..., 0]
    names = tuple(kw)
    ref = _jax(lambda rf, gr, loc, *v: jbeff.rfgr2beff(
        rf, gr, loc, b0=3e4 if kind == 'df+b0' else None,
        **dict(zip(names, v))), j(rf), j(a['gr']), j(a['loc']),
        *(j(kw[k]) for k in names))
    out = tbeff.rfgr2beff(t(rf), t(a['gr']), t(a['loc']),
                          b0=3e4 if kind == 'df+b0' else None,
                          **{k: t(v) for k, v in kw.items()})
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-14,
                               atol=1e-12)


def test_beff2uphi_vs_jax():
    rng = np.random.default_rng(1)
    beff = rng.normal(size=(2, 7, 3))
    beff[0, 0] = 0.0                     # zero field: clamped norm
    g = 2 * np.pi * 4257.6 * 4e-6
    u_j, p_j = _jax(lambda b: jbeff.beff2uphi(b, g), jnp.asarray(beff))
    u_t, p_t = tbeff.beff2uphi(torch.as_tensor(beff), g)
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), atol=1e-14)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), atol=1e-14)


def test_slowsims_blochsim_vs_jax_and_engine():
    a = _mk(N=2, Nd=(4, 3), nT=16)
    j, t = _j(), _t()
    beff = np.asarray(_jax(lambda rf, gr, loc, df: jbeff.rfgr2beff(
        rf, gr, loc, df=df), *(j(a[k]) for k in ('rf', 'gr', 'loc', 'df'))))
    kw = dict(T1=a['T1'], T2=a['T2'], dt=a['dt'])
    ref = _jax(lambda mi, b, T1, T2, dt: jslow.blochsim(
        mi, b, T1=T1, T2=T2, dt=dt), j(a['Mi']), j(beff),
        *(j(kw[k]) for k in ('T1', 'T2', 'dt')))
    out = tslow.blochsim(t(a['Mi']), t(beff),
                         **{k: t(v) for k, v in kw.items()})
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-10)
    fast = tsims.blochsim(t(a['Mi']), t(beff),
                          **{k: t(v) for k, v in kw.items()})
    np.testing.assert_allclose(fast.numpy(), out.numpy(), atol=1e-10)


def test_rfgr_phi_bound_vs_jax():
    a = _mk(N=1, nS=50, nC=2)
    ref = jsims.rfgr_phi_bound(a['rf'], a['gr'], a['loc'], df=a['df'],
                               b1Map=a['b1'], vel=a['vel'])
    out = tsims.rfgr_phi_bound(torch.as_tensor(a['rf']),
                               torch.as_tensor(a['gr']),
                               torch.as_tensor(a['loc']),
                               df=torch.as_tensor(a['df']),
                               b1Map=torch.as_tensor(a['b1']),
                               vel=torch.as_tensor(a['vel']))
    np.testing.assert_allclose(float(out), float(ref), rtol=1e-6)


def test_grads_vs_jax_reconstruct_adjoint():
    r"""The default engine's gradient (the plain versions of rfgr_fwd +
    rfgr_bwd, the arithmetic of the kernels) against JAX's
    reconstruction adjoint, for rf, gr, Mi."""
    a = _mk(nS=64, nT=24, seed=7)
    W = np.random.default_rng(8).normal(size=a['Mi'].shape)
    cfg = ('relax', 'df', 'b1')
    j = _j()

    def jloss(rf, gr, mi):
        return jnp.sum(j(W) * jsims.blochsim_rfgr(
            mi, rf, gr, j(a['loc']), backend='xla', adjoint='reconstruct',
            **_kw(a, cfg, j)))

    gj = _jax(jax.grad(jloss, argnums=(0, 1, 2)), j(a['rf']), j(a['gr']),
              j(a['Mi']))
    rf, gr, mi = (torch.tensor(a[k], requires_grad=True)
                  for k in ('rf', 'gr', 'Mi'))
    loss = torch.sum(torch.as_tensor(W) * tsims.blochsim_rfgr(
        mi, rf, gr, torch.as_tensor(a['loc']), **_kw(a, cfg, _t())))
    gt = torch.autograd.grad(loss, (rf, gr, mi))
    for x, y in zip(gt, gj):
        y = np.asarray(y)
        np.testing.assert_allclose(x.numpy(), y, rtol=1e-7,
                                   atol=1e-7 * np.abs(y).max())


def test_zero_gradient_contract():
    r"""γ, dt, T1 and T2 get zero gradients, as in the JAX engine."""
    a = _mk(nS=16, nT=8)
    pars = {k: torch.tensor(v, requires_grad=True)
            for k, v in (('T1', a['T1']), ('T2', a['T2']),
                         ('dt', a['dt']), ('gam', np.asarray(4257.6)))}
    rf = torch.tensor(a['rf'], requires_grad=True)
    out = tsims.blochsim_rfgr(torch.as_tensor(a['Mi']), rf,
                              torch.as_tensor(a['gr']),
                              torch.as_tensor(a['loc']),
                              df=torch.as_tensor(a['df']), **pars)
    grads = torch.autograd.grad(out.sum(), [rf] + list(pars.values()),
                                allow_unused=True)
    assert grads[0].abs().max() > 0
    assert all(g is None or not g.any() for g in grads[1:])


def test_keyword_validation():
    a = _mk(nS=8, nT=4)
    args = [torch.as_tensor(a[k]) for k in ('Mi', 'rf', 'gr', 'loc')]
    with pytest.raises(ValueError, match="backend='cuda'"):
        tsims.blochsim_rfgr(*args, backend='cuda')
    with pytest.raises(ValueError, match="backend='cuda'"):
        tsims.blochsim(args[0], torch.zeros(1, 8, 4, 3), backend='cuda')
    with pytest.raises(NotImplementedError):
        tsims.blochsim_rfgr(*args, mesh=object())
    with pytest.raises(ValueError, match='adjoint'):
        tsims.blochsim_rfgr(*args, adjoint='bogus')
    with pytest.raises(ValueError, match="adjoint='reconstruct'"):
        tsims.blochsim_rfgr(*args, backend='cuda', adjoint='history')
    with pytest.raises(ValueError, match='T1 and T2'):
        tsims.blochsim_rfgr(*args, T1=1.0)
    with pytest.raises(TypeError):
        tsims.blochsim_rfgr(*args, gam=1.0, γ=1.0)
    # adjoint='history' and max_phi are accepted and change nothing
    np.testing.assert_array_equal(
        tsims.blochsim_rfgr(*args, adjoint='history', max_phi=0.1).numpy(),
        tsims.blochsim_rfgr(*args).numpy())


def test_utils_vs_jax():
    from mrphy_tpu import utils as ju
    from mrphy_tpu.utils import _shapes as jsh
    from mrphy_tpu_torch import utils as tu
    from mrphy_tpu_torch.utils import _shapes as tsh
    a = _mk(N=2, nT=16)
    g, dt = a['gr'], np.asarray([4e-6, 8e-6])
    j, t = _j(), _t()
    for isTx in (True, False):
        kj = _jax(lambda x, d: ju.g2k(x, isTx, d), j(g), j(dt))
        kt = tu.g2k(t(g), isTx, t(dt))
        np.testing.assert_allclose(kt.numpy(), np.asarray(kj), rtol=1e-13)
        np.testing.assert_allclose(
            tu.k2g(kt, isTx, t(dt)).numpy(),
            np.asarray(_jax(lambda x, d: ju.k2g(x, isTx, d), kj, j(dt))),
            rtol=1e-9, atol=1e-12)
    s = tu.g2s(t(g), t(dt))
    np.testing.assert_allclose(s.numpy(),
                               np.asarray(_jax(ju.g2s, j(g), j(dt))),
                               rtol=1e-13)
    np.testing.assert_allclose(tu.s2g(s, t(dt)).numpy(), g, atol=1e-12)
    with pytest.raises(ValueError, match='origin'):
        tu.k2g(t(g), True)
    assert tu.ctrsub((3, 4, 5)) == ju.ctrsub((3, 4, 5)) == (1, 2, 2)
    rng = np.random.default_rng(2)
    u = rng.normal(size=(2, 5, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    phi = rng.normal(size=(2, 5))
    for vi in (rng.normal(size=(2, 5, 3)), rng.normal(size=(2, 5, 3, 4))):
        np.testing.assert_allclose(
            tu.uφrot(t(u), t(phi), t(vi)).numpy(),
            np.asarray(_jax(ju.uphirot, j(u), j(phi), j(vi))), atol=1e-14)
    for n, bound in ((1000, 256), (97, 50), (360, 100)):
        assert tsh.largest_divisor_leq(n, bound) == \
            jsh.largest_divisor_leq(n, bound)
        assert tsh.largest_divisor_leq_pref(n, bound, 4) == \
            jsh.largest_divisor_leq_pref(n, bound, 4)
    assert tsh.rshape(t([1., 2.]), 3).shape == (2, 1, 1)
    with pytest.raises(ValueError):
        tsh.rshape(t(np.ones((2, 2))), 1)


def _grads_rfgr(a, case, adjoint, W):
    r"""Every gradient of ``Σ W·blochsim_rfgr`` through the port (float64)
    and through JAX's XLA engine with ``adjoint``."""
    names = ['Mi', 'rf', 'gr', 'loc'] + [k for k in ('df', 'b1', 'vel')
                                         if k in case['cfg']]
    rf = a['rf'] if case.get('nC', 1) > 1 else a['rf'][..., 0]
    vals = dict(a, rf=rf)
    kwname = {'df': 'df', 'b1': 'b1Map', 'vel': 'vel'}

    def split(xs, to):
        kw = _kw(a, case['cfg'], to)
        kw.update({kwname[n]: x for n, x in zip(names[4:], xs[4:])})
        return xs[:4], kw

    def jloss(*xs):
        pos, kw = split(xs, _j())
        return jnp.sum(jnp.asarray(W) * jsims.blochsim_rfgr(
            pos[0], pos[1], pos[2], pos[3], backend='xla',
            adjoint='reconstruct', **kw))

    gj = _jax(jax.grad(jloss, argnums=tuple(range(len(names)))),
              *(jnp.asarray(vals[n], F64) for n in names))
    xs = [torch.tensor(vals[n], requires_grad=True) for n in names]
    pos, kw = split(xs, _t())
    loss = torch.sum(torch.as_tensor(W) * tsims.blochsim_rfgr(
        *pos, adjoint=adjoint, **kw))
    return names, torch.autograd.grad(loss, xs), gj


@pytest.mark.parametrize('adjoint', ['reconstruct', 'history'])
@pytest.mark.parametrize('case', RFGR_CASES,
                         ids=lambda c: '+'.join(c['cfg']) or 'bare')
def test_rfgr_every_gradient_vs_jax_f64(case, adjoint, monkeypatch):
    r"""Mi, rf, gr, loc, df, b1Map and vel gradients of the port's
    ``adjoint='reconstruct'`` (the plain versions of rfgr_fwd + rfgr_bwd)
    and ``'history'`` (autograd through the plain loop) against JAX's
    XLA reconstruction adjoint, at rtol 1e-9 in float64. ``nT`` = 48 in
    chunks of 16 exercises the restarts from the chunk ends."""
    a = _mk(N=case.get('N', 1), nC=case.get('nC', 1), Nd=case.get('Nd'),
            nT=48)
    W = np.random.default_rng(8).normal(size=a['Mi'].shape)
    from mrphy_tpu_torch.kernels import bloch
    monkeypatch.setattr(bloch, 'TC_MAX', 16)
    names, gt, gj = _grads_rfgr(a, case, adjoint, W)
    for n, x, y in zip(names, gt, gj):
        y = np.asarray(y)
        np.testing.assert_allclose(x.numpy(), y, rtol=1e-9,
                                   atol=1e-9 * np.abs(y).max(), err_msg=n)


@pytest.mark.parametrize('adjoint', ['reconstruct', 'history'])
def test_blochsim_every_gradient_vs_jax_f64(adjoint):
    a = _mk(N=2, Nd=(5, 7), nT=40)
    j = _j()
    beff = np.asarray(_jax(lambda rf, gr, loc, df: jbeff.rfgr2beff(
        rf, gr, loc, df=df), *(j(a[k]) for k in ('rf', 'gr', 'loc', 'df'))))
    W = np.random.default_rng(9).normal(size=a['Mi'].shape)
    kw = dict(T1=a['T1'], T2=a['T2'], dt=a['dt'])
    gj = _jax(jax.grad(lambda m, b, w, T1, T2, dt: jnp.sum(w * jsims.blochsim(
        m, b, backend='xla', adjoint='reconstruct', T1=T1, T2=T2, dt=dt)),
        argnums=(0, 1)), j(a['Mi']), j(beff), j(W),
        *(j(kw[k]) for k in ('T1', 'T2', 'dt')))
    mi, bf = (torch.tensor(x, requires_grad=True) for x in (a['Mi'], beff))
    gt = torch.autograd.grad(torch.sum(torch.as_tensor(W) * tsims.blochsim(
        mi, bf, adjoint=adjoint, **{k: _t()(v) for k, v in kw.items()})),
        (mi, bf))
    for x, y in zip(gt, gj):
        y = np.asarray(y)
        np.testing.assert_allclose(x.numpy(), y, rtol=1e-9,
                                   atol=1e-9 * np.abs(y).max())


def _saved_elements(fn):
    r"""Elements of the tensors autograd saves while ``fn`` runs."""
    count = [0]

    def pack(x):
        count[0] += x.numel()
        return x

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        fn()
    return count[0]


def test_reconstruct_saves_chunk_ends_only():
    r"""``adjoint='reconstruct'`` keeps O(nM·nT/tc) for the backward: the
    chunk-end states and the inputs, not the O(nM·nT) history that
    autograd through the time loop keeps (``'history'``)."""
    nS, nT = 64, 512                                  # tc = 256, 2 chunks
    a = _mk(nS=nS, nT=nT, nC=2)
    t = _t()
    kw = _kw(a, ('relax', 'df', 'b1', 'vel'), t)
    counts = {}
    for adjoint in ('reconstruct', 'history'):
        xs = [t(a[k]).requires_grad_() for k in ('Mi', 'rf', 'gr', 'loc')]
        counts[adjoint] = _saved_elements(lambda: tsims.blochsim_rfgr(
            *xs, adjoint=adjoint, **kw))
    assert counts['history'] > 10 * nS * nT
    assert counts['reconstruct'] < nS * nT / 4, counts
    b = np.random.default_rng(2).normal(size=(1, nS, nT, 3))
    for adjoint in ('reconstruct', 'history'):
        mi, bf = t(a['Mi']).requires_grad_(), t(b).requires_grad_()
        counts[adjoint] = _saved_elements(lambda: tsims.blochsim(
            mi, bf, T1=t(a['T1']), T2=t(a['T2']), adjoint=adjoint))
    # the Beff input itself (3·nS·nT) is saved either way
    assert counts['history'] > 10 * nS * nT
    assert counts['reconstruct'] < 4 * nS * nT, counts
