r"""Parity of the port's two-pool Bloch–McConnell engine
(:mod:`mrphy_tpu_torch.ops.mc`, :mod:`mrphy_tpu_torch.kernels.mc`) and of
the pure-torch oracle functions of :mod:`mrphy_tpu_torch.ops.slowsims` /
:mod:`~mrphy_tpu_torch.ops.beffective` with the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances, all float64: 1e-13 for the propagators, 1e-12 for the
oracles and the A/B propagators, 1e-11 for the fused engine against
JAX's XLA backend (the same arithmetic, rounding only), rtol 1e-9 for
every gradient (relative to each gradient's largest value). Against the
JAX Pallas kernels in interpret mode, whose sin/cos is a polynomial
(~1e-8 per step where the port calls the library's): 1e-6 on the states
and 1e-5 on the adjoint's outputs, relative to each one's largest value.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mrphy_tpu import gamH
from mrphy_tpu.ops import beffective as jbeff
from mrphy_tpu.ops import mc as jmc
from mrphy_tpu.ops import slowsims as jslow
from mrphy_tpu_torch.kernels import bloch
from mrphy_tpu_torch.kernels import mc as kmc
from mrphy_tpu_torch.ops import beffective as tbeff
from mrphy_tpu_torch.ops import mc as tmc
from mrphy_tpu_torch.ops import slowsims as tslow

F64 = np.float64
PARS = dict(T1a=1.2, T2a=0.06, T1b=1.0, T2b=0.01, kab=3.0, kba=150.0,
            Ma0=1.0, Mb0=0.02, dfb=750.0)
PAR_NAMES = tuple(PARS)


def _j(x):
    return jnp.asarray(x, F64)


def _t(x):
    return torch.tensor(np.asarray(x), dtype=torch.float64)


def _jax(fn, *args):
    r"""``jax.jit(fn)(*args)`` compiled by XLA at its lowest optimisation
    level: each reference is small and runs once, so compiling it is
    nearly all of its cost."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={'xla_backend_optimization_level': 0})(*args)


def _mk(N=1, nS=24, nT=48, nC=2, seed=0):
    r"""Random fused-engine inputs (numpy, float64): fields of physical
    size, per-voxel tissue/exchange maps around ``PARS``."""
    rng = np.random.default_rng(seed)
    sh = (N, nS)
    per_voxel = {k: v * (1 + 0.2 * (rng.random(sh) - 0.5))
                 for k, v in PARS.items()}
    return dict(
        Mia=rng.random(sh + (3,)) - 0.5,
        Mib=(rng.random(sh + (3,)) - 0.5) * 0.04,
        loc=rng.random(sh + (3,)) * 2 - 1,
        df=(rng.random(sh) - 0.5) * 200,
        b1=rng.random(sh + (2, nC)) - 0.5,
        rf=(rng.random((N, 2, nT, nC)) - 0.5) * 0.1,
        gr=rng.normal(size=(N, 3, nT)),
        **per_voxel)


def _close(x, y, rtol, name=''):
    x, y = np.asarray(x), np.asarray(y)
    np.testing.assert_allclose(x, y, rtol=rtol,
                               atol=rtol * (np.abs(y).max() + 1e-300),
                               err_msg=name)


def test_mc_propagators_vs_jax():
    rng = np.random.default_rng(1)
    pars = [v * (1 + 0.5 * rng.random(16)) for v in PARS.values()][:8]
    pars[4] = np.concatenate([[0.0], pars[4][1:]])      # zero exchange
    ref = _jax(jslow.mc_propagators, *map(_j, pars), _j(2e-4))
    out = tslow.mc_propagators(*map(_t, pars), _t(2e-4))
    for name, o, r in zip(('X00', 'X01', 'X10', 'X11', 'Z00', 'Z01', 'Z10',
                           'Z11', 'ca', 'cb'), out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-13, err_msg=name)


def test_mc_propagators_grad_finite_at_zero_exchange():
    r"""The two-``where`` guard of ``_expm2``: at zero exchange with T2a ==
    T2b (q² = 0, a natural fitting init) the gradient stays finite (the
    port of ``tests/test_mc.py::test_grads_finite_at_degenerate_params``)."""
    kab = torch.tensor(0.0, dtype=torch.float64, requires_grad=True)
    T2a = torch.tensor(0.05, dtype=torch.float64, requires_grad=True)
    beff = torch.tensor([0.01, 0., 0.], dtype=torch.float64).expand(
        1, 1, 16, 3)
    Mao, _ = tslow.blochsim_mc(
        torch.tensor([[[0., 0., 1.]]], dtype=torch.float64),
        torch.tensor([[[0., 0., 0.2]]], dtype=torch.float64), beff,
        T1a=1.0, T2a=T2a, T1b=1.0, T2b=0.05, kab=kab, kba=0.0, Ma0=1.0,
        Mb0=0.2, dfb=0.0, gam=gamH, dt=1e-4)
    g = torch.autograd.grad(Mao[0, 0, 2], (kab, T2a))
    assert all(bool(torch.isfinite(x)) for x in g), g


def test_blochsim_mc_vs_jax():
    a = _mk(N=2, nS=12, nT=20, nC=1)
    beff = np.asarray(_jax(lambda rf, gr, loc, df: jbeff.rfgr2beff(
        rf, gr, loc, df=df), *(_j(a[k]) for k in ('rf', 'gr', 'loc', 'df'))))
    pars = {k: a[k] for k in PAR_NAMES}
    ref = _jax(lambda Mia, Mib, beff, *p: jslow.blochsim_mc(
        Mia, Mib, beff, gam=gamH, dt=4e-6, **dict(zip(PAR_NAMES, p))),
        _j(a['Mia']), _j(a['Mib']), _j(beff), *(_j(pars[k])
                                                for k in PAR_NAMES))
    out = tslow.blochsim_mc(_t(a['Mia']), _t(a['Mib']), _t(beff), γ=gamH,
                            dt=4e-6, **{k: _t(v) for k, v in pars.items()})
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-12)


MC_CASES = {'none': (), 'df': ('df',), 'df+b1': ('df', 'b1')}


def _kw(a, cfg, to, dt=4e-6):
    kw = {k: to(a[k]) for k in PAR_NAMES}
    if 'df' in cfg:
        kw['df'] = to(a['df'])
    if 'b1' in cfg:
        kw['b1Map'] = to(a['b1'])
    return dict(kw, gam=gamH, dt=dt)


@pytest.mark.parametrize('case', list(MC_CASES))
def test_blochsim_mc_rfgr_vs_jax_xla(case, monkeypatch):
    r"""The plain versions of ``mc_fwd`` against JAX's XLA backend; nT = 48
    in chunks of 16 (three chunks)."""
    monkeypatch.setattr(bloch, 'TC_MAX', 16)
    a = _mk()
    cfg = MC_CASES[case]
    rf = a['rf'] if 'b1' in cfg else a['rf'][..., 0]
    pos = ('Mia', 'Mib', 'rf', 'gr', 'loc')
    vals = dict(a, rf=rf)
    jkw = _kw(a, cfg, _j)
    arrays = [k for k, v in jkw.items() if isinstance(v, jax.Array)]
    ref = _jax(lambda *xs: jmc.blochsim_mc_rfgr(
        *xs[:5], backend='xla', **dict(jkw, **dict(zip(arrays, xs[5:])))),
        *(_j(vals[k]) for k in pos), *(jkw[k] for k in arrays))
    out = tmc.blochsim_mc_rfgr(*(_t(vals[k]) for k in pos),
                               **_kw(a, cfg, _t))
    for o, r in zip(out, ref):
        assert o.shape == r.shape and o.dtype == torch.float64
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-11)


GRAD_NAMES = ('Mia', 'Mib', 'rf', 'gr', 'loc', 'df', 'b1') + PAR_NAMES


def _grads(a, W, dt, names=GRAD_NAMES):
    r"""Every gradient of ``Σ Wa·Ma + Wb·Mb`` through the port (the plain
    ``mc_fwd`` + ``mc_bwd``) and through JAX's XLA backend."""
    kwname = {'df': 'df', 'b1': 'b1Map'}

    def split(xs, to):
        d = dict(zip(names, xs))
        kw = {kwname.get(k, k): d[k] for k in names[5:]}
        return [d[k] for k in names[:5]], dict(kw, gam=gamH, dt=to(dt))

    def jloss(*xs):
        pos, kw = split(xs, _j)
        Ma, Mb = jmc.blochsim_mc_rfgr(*pos, backend='xla', **kw)
        return jnp.sum(_j(W[0]) * Ma) + jnp.sum(_j(W[1]) * Mb)

    gj = _jax(jax.grad(jloss, argnums=tuple(range(len(names)))),
              *(_j(a[k]) for k in names))
    xs = [_t(a[k]).requires_grad_() for k in names]
    pos, kw = split(xs, _t)
    Ma, Mb = tmc.blochsim_mc_rfgr(*pos, **kw)
    loss = torch.sum(_t(W[0]) * Ma) + torch.sum(_t(W[1]) * Mb)
    return torch.autograd.grad(loss, xs), gj


def test_every_gradient_vs_jax(monkeypatch):
    r"""∂/∂ Mia, Mib, rf, gr, loc, df, b1Map and the nine tissue/exchange
    maps (the chain through ``mc_propagators``) at rtol 1e-9; nT = 48 in
    three chunks exercises the restarts and the chunk-start cotangents."""
    monkeypatch.setattr(bloch, 'TC_MAX', 16)
    a = _mk(nS=16)
    W = np.random.default_rng(8).normal(size=(2,) + a['Mia'].shape)
    gt, gj = _grads(a, W, 4e-6)
    for n, x, y in zip(GRAD_NAMES, gt, gj):
        assert bool(x.abs().max() > 0), n
        _close(x.numpy(), y, 1e-9, n)


def test_mt_bound_pool_gradients_vs_jax():
    r"""An MT bound pool, T2b = 10 µs at dt = 200 µs: the transverse mix
    X is ~1e-9, so a step cannot be inverted. The two-phase adjoint
    inverts nothing: every gradient is finite and meets JAX's. (∂/∂T2b
    here carries the closed-form exponential's cancellation, X11 =
    e^μ·(cosh q − sinh(q)/q·dev) with q ≈ 10, ~ε·e²⁰ relative in both
    packages: other draws can differ by a few 1e-9.)"""
    a = _mk(nS=8, nT=40, seed=4)
    a['T2b'] = np.full_like(a['T2b'], 1e-5)
    a['rf'] = a['rf'] * 0.1
    W = np.random.default_rng(9).normal(size=(2,) + a['Mia'].shape)
    gt, gj = _grads(a, W, 2e-4)
    for n, x, y in zip(GRAD_NAMES, gt, gj):
        assert bool(torch.isfinite(x).all()), n
        _close(x.numpy(), y, 1e-9, n)


def test_gamma_dt_get_zero_gradient():
    a = _mk(nS=6, nT=8, nC=1)
    gam = torch.tensor(gamH, dtype=torch.float64, requires_grad=True)
    dt = torch.tensor(4e-6, dtype=torch.float64, requires_grad=True)
    rf = _t(a['rf'][..., 0]).requires_grad_()
    Ma, Mb = tmc.blochsim_mc_rfgr(
        _t(a['Mia']), _t(a['Mib']), rf, _t(a['gr']), _t(a['loc']),
        df=_t(a['df']), gam=gam, dt=dt, **{k: _t(a[k]) for k in PAR_NAMES})
    g = torch.autograd.grad(Ma.sum() + Mb.sum(), (rf, gam, dt),
                            allow_unused=True)
    assert g[0].abs().max() > 0
    assert all(x is None or not x.any() for x in g[1:])


def _planes(S, nT, nC, seed=3):
    r"""Random planes for the kernels (numpy, float64): the layout of
    :mod:`mrphy_tpu_torch.kernels.mc`, ``S`` voxels."""
    rng = np.random.default_rng(seed)
    g2pd = np.full((1, S), 2 * np.pi * gamH * 4e-6)
    pr = _jax(jslow.mc_propagators,
              *(_j(v) for v in list(PARS.values())[:8]), _j(4e-6))
    return dict(
        mi6=rng.standard_normal((1, 6, S)) * 0.5,
        rf2=rng.standard_normal((1, 2 * nC, nT)) * 0.05,
        gr2=rng.standard_normal((1, 3, nT)),
        loc_p=g2pd[:, None] * rng.standard_normal((1, 3, S)),
        dfg=rng.standard_normal((1, S)) * 100 * 2 * np.pi * 4e-6,
        b1_p=g2pd[:, None] * (rng.standard_normal((1, 2 * nC, S)) * .3
                              + .5),
        sb=np.full((1, S), 750.0 * 2 * np.pi * 4e-6),
        Xp=np.stack([np.full((1, S), float(p)) for p in pr[:4]], 1),
        Zp=np.stack([np.full((1, S), float(p)) for p in pr[4:]], 1),
        g2pd=g2pd)


KEYS = ('rf2', 'gr2', 'loc_p', 'dfg', 'b1_p', 'sb', 'Xp', 'Zp', 'g2pd')


def test_kernels_vs_jax_pallas_interpret():
    r"""``mc_fwd_torch`` / ``mc_bwd_torch`` against the TPU kernels
    ``mc_fwd_planes`` / ``mc_bwd_planes`` run in interpret mode, on one
    128-lane tile × 2 steps in chunks of 1, 2 coils (interpret mode
    spends its time compiling the adjoint, unrolled by the chunk)."""
    from mrphy_tpu.ops import mc_pallas
    nT, nC, tc, L = 2, 2, 1, 128
    p = _planes(L, nT, nC)
    jp = {k: _j(v if k in ('rf2', 'gr2') else v.reshape(v.shape[:-1]
                                                          + (1, L)))
          for k, v in p.items()}
    out, chk = _jax(lambda *xs: mc_pallas.mc_fwd_planes(
        *xs, tc=tc, interpret=True), jp['mi6'], *(jp[k] for k in KEYS))
    tp = {k: _t(v) for k, v in p.items()}
    tchk = kmc.mc_fwd_torch(tp['mi6'], *(tp[k] for k in KEYS), tc=tc)
    ref = np.concatenate([np.asarray(chk)[..., 0, :],
                          np.asarray(out)[:, None, :, 0, :]], axis=1)
    _close(tchk.numpy(), ref, 1e-6, 'chk')
    g6 = np.random.default_rng(7).standard_normal((1, 6, L))
    jg = jax.tree_util.tree_map(np.asarray, _jax(
        lambda *xs: mc_pallas.mc_bwd_planes(*xs, tc=tc, interpret=True),
        chk, _j(g6.reshape(1, 6, 1, L)), *(jp[k] for k in KEYS)))
    g = torch.zeros_like(tchk)
    g[:, -1] = _t(g6)
    tg = kmc.mc_bwd_torch(tchk, g, *(tp[k] for k in KEYS), tc=tc)
    for name, x, y in zip(('dmi6', 'drf2', 'dgr2', 'dloc', 'ddfg', 'db1',
                           'dsb', 'dX', 'dZ'), tg, jg):
        y = y.reshape(x.shape)
        _close(x.numpy(), y, 1e-5, name)


def _saved_elements(fn):
    count = [0]

    def pack(x):
        count[0] += x.numel()
        return x

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        fn()
    return count[0]


def test_backward_saves_chunk_starts_only():
    r"""The two-phase adjoint keeps O(nM·nT/tc) for the backward: the chunk
    boundaries and the inputs, not the O(nM·nT) history that autograd
    through the oracle's time loop keeps."""
    nS, nT = 64, 1024                                 # tc = 256, 4 chunks
    a = _mk(nS=nS, nT=nT, nC=1)
    kw = _kw(a, ('df',), _t)
    xs = [_t(a[k]).requires_grad_() for k in ('Mia', 'Mib')]
    rf = _t(a['rf'][..., 0])
    n_fused = _saved_elements(lambda: tmc.blochsim_mc_rfgr(
        *xs, rf, _t(a['gr']), _t(a['loc']), **kw))
    assert n_fused < nS * nT / 4, n_fused
    beff = tbeff.rfgr2beff(rf[..., :64], _t(a['gr'])[..., :64],
                           _t(a['loc']))
    kw.pop('df')
    n_oracle = _saved_elements(lambda: tslow.blochsim_mc(*xs, beff, **kw))
    assert n_oracle > 10 * nS * 64, n_oracle


def test_keyword_validation():
    a = _mk(nS=4, nT=4, nC=1)
    pos = [_t(a[k]) for k in ('Mia', 'Mib', 'gr', 'loc')]
    args = pos[:2] + [_t(a['rf'][..., 0])] + pos[2:]
    kw = {k: _t(a[k]) for k in PAR_NAMES}
    with pytest.raises(ValueError, match="backend='cuda'"):
        tmc.blochsim_mc_rfgr(*args, backend='cuda', **kw)
    with pytest.raises(ValueError, match='backend'):
        tmc.blochsim_mc_rfgr(*args, backend='xla', **kw)
    with pytest.raises(NotImplementedError):
        tmc.blochsim_mc_rfgr(*args, mesh=object(), **kw)
    with pytest.raises(TypeError):
        tmc.blochsim_mc_rfgr(*args, gam=1.0, γ=1.0, **kw)
    with pytest.raises(ValueError, match='differ'):
        tmc.blochsim_mc_rfgr(args[0], args[1][:, :2], *args[2:], **kw)
    # max_phi and the Unicode aliases are accepted and change nothing
    ref = tmc.blochsim_mc_rfgr(*args, df=_t(a['df']), **kw)
    out = tmc.blochsim_mc_rfgr(*args, Δf=_t(a['df']), γ=gamH, max_phi=0.1,
                               backend='torch', **kw)
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o.numpy(), r.numpy())


# ---------------------------------------------------------------------------
# The pure-torch functions of ops/slowsims.py and ops/beffective.py
# ---------------------------------------------------------------------------

def _beff_case(seed=2):
    rng = np.random.default_rng(seed)
    N, Nd, nT = 2, (3, 4), 24
    return dict(M=rng.random((N,) + Nd + (3,)) - 0.5,
                beff=(rng.random((N,) + Nd + (nT, 3)) - 0.5) * 0.4,
                T1=rng.random((N,) + Nd) + 0.5,
                T2=rng.random((N,) + Nd) * 0.05 + 0.02,
                dt=np.asarray([4e-6, 8e-6]))


@pytest.mark.parametrize('fn', ['beff2ab', 'beff2ab_assoc'])
def test_beff2ab_vs_jax(fn):
    a = _beff_case()
    kw = dict(E1=np.exp(-a['dt'][:, None, None] / a['T1']),
              E2=np.exp(-a['dt'][:, None, None] / a['T2']), dt=a['dt'])
    beff = a['beff'][..., :23, :]    # nT 23: odd levels 23 and 3 in the tree
    A_j, B_j = _jax(lambda b, E1, E2, dt: getattr(jbeff, fn)(
        b, E1=E1, E2=E2, dt=dt), _j(beff), *(_j(kw[k]) for k in
                                             ('E1', 'E2', 'dt')))
    A_t, B_t = getattr(tbeff, fn)(_t(beff),
                                  **{k: _t(v) for k, v in kw.items()})
    np.testing.assert_allclose(A_t.numpy(), np.asarray(A_j), atol=1e-12)
    np.testing.assert_allclose(B_t.numpy(), np.asarray(B_j), atol=1e-12)


@pytest.mark.parametrize('fn', ['blochsim_segmented', 'blochsim_tparallel'])
def test_blochsim_variants_vs_jax(fn):
    a = _beff_case()
    kw = dict(T1=a['T1'], T2=a['T2'], dt=a['dt'])
    def jfn(m, beff, T1, T2, dt):
        return getattr(jslow, fn)(m, beff, T1=T1, T2=T2, dt=dt)

    jargs = [_j(a['beff'])] + [_j(kw[k]) for k in ('T1', 'T2', 'dt')]
    ref = _jax(jfn, _j(a['M']), *jargs)
    M = _t(a['M']).requires_grad_()
    out = getattr(tslow, fn)(M, _t(a['beff']),
                             **{k: _t(v) for k, v in kw.items()})
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=1e-12)
    # the gradient through the segments' recomputation, against JAX's
    W = np.random.default_rng(3).normal(size=a['M'].shape)
    gj = _jax(jax.grad(lambda m, w, *xs: jnp.sum(w * jfn(m, *xs))),
              _j(a['M']), _j(W), *jargs)
    gt = torch.autograd.grad(torch.sum(_t(W) * out), M)[0]
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=1e-12)


def test_blochsim_ab_vs_jax():
    rng = np.random.default_rng(4)
    M, A, B = (rng.normal(size=s) for s in ((2, 5, 3), (2, 5, 3, 3),
                                            (2, 5, 3)))
    np.testing.assert_allclose(
        tslow.blochsim_ab(_t(M), _t(A), _t(B)).numpy(),
        np.asarray(_jax(jslow.blochsim_ab, _j(M), _j(A), _j(B))),
        atol=1e-13)
