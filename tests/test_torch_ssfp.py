r"""Parity of the port's balanced-SSFP family (:mod:`mrphy_tpu_torch.ops.ssfp`:
``bssfp_train``, ``bssfp_steady`` and the plain versions of the
``bssfp_fwd``/``bssfp_fwd_chk``/``bssfp_bwd`` kernels) with the JAX package
on the CPU.

Inputs are made with numpy from a seed and handed to both packages, every
port tensor on the CPU, float64 unless stated. ``bssfp_train``'s two routes
are held to JAX's XLA scan: the plain route (a loop over TRs under torch
autograd) and the kernels' route, whose autograd Function runs the kernels'
plain versions on CPU tensors (``bssfp_fwd_chk`` forward, ``bssfp_bwd``
backward, the rows' gradients chained to the inputs by autograd of their
construction): echoes at 1e-10 of their largest value, gradients w.r.t.
flips, phis, T1, T2, df, M0, b1, tr and te at 1e-9 of each one's largest
value; a prepared ``Minit`` and a per-voxel 2-D train on the plain route
(the kernels do not take them). The written-out chunk adjoint
``bssfp_bwd_torch`` is held to torch autograd of the plain forward at 1e-9
over one, three and all TRs a chunk, with and without b1, at a constant and
a variable TR; one float32 case with every option on to JAX's Pallas
kernels in interpret mode (echoes at 3e-6, gradients at 2e-5);
``bssfp_steady`` and its gradients to JAX at 1e-12; the router's decisions
to JAX's.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mrphy_tpu.ops import routing as jrouting
from mrphy_tpu.ops import ssfp as jssfp
from mrphy_tpu.ops import ssfp_pallas
from mrphy_tpu_torch.kernels import ssfp as kssfp
from mrphy_tpu_torch.ops import routing
from mrphy_tpu_torch.ops import ssfp as tssfp
from test_torch_epg import _close
from test_torch_epgx import _jax

NA, NTR = 7, 12
ATOMS = ('T1', 'T2', 'df', 'M0', 'b1')


def _inputs(seed=0, nA=NA, nTR=NTR):
    r"""A flip and phase train, per-atom maps (df within ±80 Hz), a 4-6 ms
    tr train and 1-3 ms te train, and the loss weights."""
    rng = np.random.default_rng(seed)
    return dict(
        flips=rng.uniform(0.1, 1.2, nTR), phis=rng.uniform(-3, 3, nTR),
        T1=rng.uniform(0.3, 2.0, nA), T2=rng.uniform(0.03, 0.3, nA),
        df=rng.uniform(-80, 80, nA), M0=rng.uniform(0.7, 1.2, nA),
        b1=rng.uniform(0.8, 1.2, nA), tr=rng.uniform(0.004, 0.006, nTR),
        te=rng.uniform(0.001, 0.003, nTR), w=rng.standard_normal((nA, nTR,
                                                                  2)))


def _catalysed(seed=0, nA=NA):
    r"""``examples/bssfp_fit.py``'s train: an α/2 pulse at tr/2, then 200
    TRs of 35° at 5 ms (a variable-TR train of 201)."""
    inp = _inputs(seed, nA, 201)
    a = np.deg2rad(35.0)
    inp['flips'] = np.r_[a / 2, np.full(200, a)]
    inp['tr'] = np.r_[0.0025, np.full(200, 0.005)]
    return inp


# The parity cases: the inputs and which of them enter the call (a name, or
# a value). 'full': every option over (nTR,) tr and te trains and explicit
# phases; 'const': a scalar tr (te = tr/2), the linear phase cycle, swept
# over dphi; 'catalysed': examples/bssfp_fit.py's 201-TR train with b1;
# 'minit': a prepared initial state and a per-voxel 2-D train (the plain
# route only).
CASES = {
    'full': (_inputs, dict(flips='flips', phis='phis', tr='tr', te='te',
                           **{n: n for n in ATOMS})),
    'const': (_inputs, dict(flips='flips', tr=0.005, T1='T1', T2='T2',
                            df='df', M0='M0')),
    'catalysed': (_catalysed, dict(flips='flips', tr='tr', T1='T1', T2='T2',
                                   df='df', M0='M0', b1='b1')),
    'minit': (_inputs, dict(flips='flips2d', tr=0.005, T1='T1', T2='T2',
                            df='df', M0='M0', Minit='Minit')),
}
DPHIS = (np.pi, np.pi / 2, -0.3)


def _case(name):
    r"""``(inp, base, diff)``: the inputs, the call's arguments (numpy) and
    the names differentiated."""
    make, spec = CASES[name]
    inp = make(1)
    rng = np.random.default_rng(7)
    inp['flips2d'] = inp['flips'] * rng.uniform(0.8, 1.2, (NA, 1))
    inp['Minit'] = rng.uniform(-0.5, 0.5, (NA, 3))
    base = {k: inp[v] if isinstance(v, str) else v for k, v in spec.items()}
    diff = [k for k, v in spec.items() if isinstance(v, str)
            and k != 'Minit']
    return inp, base, diff


@functools.cache
def _ref(name):
    r"""JAX's echoes and gradients w.r.t. the differentiated inputs, per
    dphi of DPHIS for 'const', from one compiled call of its XLA scan."""
    inp, base, diff = _case(name)
    w = jnp.asarray(inp['w'])

    def loss(dphi, *xs):
        kw = dict(base, **dict(zip(diff, xs)))
        out = jssfp.bssfp_train(kw.pop('flips'), dphi=dphi, **kw)
        return jnp.sum(w * out), out

    f = jax.value_and_grad(loss, argnums=tuple(range(1, len(diff) + 1)),
                           has_aux=True)
    xs = [jnp.asarray(base[n], jnp.float64) for n in diff]
    lowered = jax.jit(f).lower(jnp.float64(np.pi), *xs).compile(
        compiler_options={'xla_backend_optimization_level': 0,
                          'xla_cpu_use_fusion_emitters': False})
    out = []
    for dphi in (DPHIS if name == 'const' else DPHIS[:1]):
        (_, o), g = lowered(jnp.float64(dphi), *xs)
        out.append(jax.tree_util.tree_map(np.asarray, (o, g)))
    return out


def _port(route_, base, diff, w, dphi=np.pi):
    r"""The port's echoes and gradients on ``route_`` ('plain' or
    'kernels')."""
    xs = {n: torch.tensor(base[n], dtype=torch.float64, requires_grad=True)
          for n in diff}
    kw = dict({k: (torch.as_tensor(v) if isinstance(v, np.ndarray) else v)
               for k, v in base.items()}, **xs)
    fn = tssfp._bssfp_scan if route_ == 'plain' else tssfp._bssfp_kernels
    out = fn(kw.pop('flips'), dphi=dphi, **kw)
    grads = torch.autograd.grad((torch.as_tensor(w) * out).sum(),
                                list(xs.values()))
    return out.detach(), grads


@pytest.mark.parametrize('name,route_', [
    ('full', 'plain'), ('full', 'kernels'), ('const', 'plain'),
    ('const', 'kernels'), ('catalysed', 'plain'), ('catalysed', 'kernels'),
    ('minit', 'plain')])
def test_bssfp_train_vs_jax(name, route_):
    r"""Echoes and the gradients w.r.t. every input of the call against
    ``jax.value_and_grad`` of JAX's XLA scan, on both routes: every option
    over (nTR,) tr and te trains; a constant TR over a dphi sweep; the
    α/2-catalysed 201-TR train with b1; a prepared Minit and a 2-D train
    (the plain route)."""
    inp, base, diff = _case(name)
    for dphi, (out_j, grads_j) in zip(DPHIS, _ref(name)):
        out, grads = _port(route_, base, diff, inp['w'], dphi)
        assert out.shape == out_j.shape
        _close(out, out_j, 1e-10)
        for n, g, gj in zip(diff, grads, grads_j):
            assert g.shape == gj.shape, n
            assert bool(torch.isfinite(g).all()), n
            _close(g, gj, 1e-9)


def test_bssfp_train_all_scalar_and_routes():
    r"""An all-scalar call returns an unbatched ``(nTR, 2)`` train on both
    routes; ``bssfp_train`` on CPU tensors takes the plain route under
    ``'auto'``, refuses ``backend='cuda'`` and a mesh."""
    inp = _inputs(2)
    fl = torch.as_tensor(inp['flips'])
    kw = dict(T1=1.0, T2=0.1, tr=0.005, df=12.0)
    a = tssfp._bssfp_scan(fl, **kw)
    b = tssfp._bssfp_kernels(fl, **kw)
    assert a.shape == b.shape == (NTR, 2)
    _close(b, a, 1e-12)
    assert torch.equal(tssfp.bssfp_train(fl, **kw), a)
    with pytest.raises(ValueError, match='CUDA tensors'):
        tssfp.bssfp_train(fl, **kw, backend='cuda')
    with pytest.raises(NotImplementedError, match='mesh'):
        tssfp.bssfp_train(fl, **kw, mesh=object())


def _rows(seed, b1, vartr, nTR=12):
    inp = _inputs(seed, nTR=nTR)
    kw = {n: torch.as_tensor(inp[n]) for n in ATOMS[:4]}
    kw['tr'] = torch.as_tensor(inp['tr']) if vartr else 0.005
    if b1:
        kw['b1'] = torch.as_tensor(inp['b1'])
    return tssfp._bssfp_rows(torch.as_tensor(inp['flips']),
                             phis=torch.as_tensor(inp['phis']), **kw)[:3]


@pytest.mark.parametrize('vartr', [False, True], ids=['const', 'vartr'])
@pytest.mark.parametrize('b1', [False, True], ids=['nob1', 'b1'])
@pytest.mark.parametrize('tc', [1, 3, 12])
def test_bssfp_bwd_torch_vs_autograd(tc, b1, vartr):
    r"""The written-out chunk adjoint (``dcoef``, ``dpk``) against torch
    autograd of the plain forward over chunks of one TR, three and all
    twelve, with and without b1, at a constant and a variable TR; the
    checkpointing forward's echoes equal the plain forward's."""
    nTR = 12
    coef, pk, cfg = _rows(3, b1, vartr, nTR)
    assert cfg == kssfp.BssfpCfg(has_b1=b1, vartr=vartr)
    assert coef.shape == (cfg.nC, nTR) and pk.shape == (cfg.nP, NA)
    coef, pk = (x.detach().requires_grad_() for x in (coef, pk))
    rng = np.random.default_rng(9)
    gr, gi = (torch.as_tensor(rng.standard_normal((nTR, NA)))
              for _ in range(2))
    er, ei = kssfp.bssfp_fwd_torch(coef, pk, cfg)
    grads_a = torch.autograd.grad((gr * er).sum() + (gi * ei).sum(),
                                  (coef, pk))
    coef, pk = coef.detach(), pk.detach()
    er2, ei2, chk = kssfp.bssfp_fwd_chk_torch(coef, pk, cfg, tc=tc)
    assert chk.shape == (nTR // tc, 3, NA)
    assert torch.equal(er2, er.detach()) and torch.equal(ei2, ei.detach())
    grads = kssfp.bssfp_bwd_torch(coef, pk, cfg, chk, gr, gi, tc=tc)
    if b1:
        # the angle's gradient goes to the flip row and to db1
        assert not bool(grads[0][:5].any())
    else:
        assert not bool(grads[1][-1].any())
    for x, xa in zip(grads, grads_a):
        np.testing.assert_allclose(x, xa, rtol=1e-9,
                                   atol=1e-9 * float(xa.abs().max()))


def test_bssfp_plain_versions_vs_pallas_interpret(monkeypatch):
    r"""Float32, 100 atoms × 16 TRs with every option on (explicit phases,
    (nTR,) tr and te, per-atom T1, T2, df, M0 and b1), against JAX's Pallas
    kernels in interpret mode (``_bssfp_fwd_chk_kernel`` and
    ``_bssfp_bwd_kernel`` under ``jax.value_and_grad``, one atom tile, one
    chunk): echoes at 3e-6, the gradients w.r.t. every input at 2e-5 of
    each one's largest value. The Pallas kernels repeat their TR loop's
    body eight times by hand (``_UNROLL``, for Mosaic); at 16 TRs that
    leaves every TR's arithmetic as it is, and interpreted it only makes
    the traced program eight times the size, so it is traced once a TR."""
    monkeypatch.setattr(ssfp_pallas, '_UNROLL', 1)
    nA, nTR = 100, 16
    inp = _inputs(4, nA=nA, nTR=nTR)
    f32 = np.float32
    names = ('flips', 'phis', 'tr', 'te') + ATOMS
    w = inp['w'].astype(f32)

    def jloss(*a):
        d = dict(zip(names, a))
        out = ssfp_pallas.bssfp_train_pallas(d.pop('flips'), **d, tile=128,
                                             interpret=True)
        return jnp.sum(w * out), out

    (_, ref), gref = _jax(jax.value_and_grad(
        jloss, argnums=tuple(range(len(names))), has_aux=True),
        *(jnp.asarray(inp[n], f32) for n in names))
    ta = {n: torch.tensor(inp[n], dtype=torch.float32, requires_grad=True)
          for n in names}
    kw = dict(ta)
    out = tssfp._bssfp_kernels(kw.pop('flips'), **kw)
    grads = torch.autograd.grad((torch.as_tensor(w) * out).sum(),
                                list(ta.values()))
    assert out.dtype == torch.float32 and out.shape == ref.shape
    _close(out.detach(), ref, 3e-6)
    for g, gj in zip(grads, gref):
        _close(g, gj, 2e-5)


def test_bssfp_steady_vs_jax():
    r"""``bssfp_steady`` and its gradients w.r.t. alpha, T1, T2, df, M0, tr
    and te against JAX at 1e-12, over a batch across the banding profile
    (df ±1.5/tr) at dphi π and π/2; the on-resonance mid-band closed form
    at te 0."""
    rng = np.random.default_rng(11)
    n = 9
    args = dict(alpha=rng.uniform(0.2, 1.0, n), T1=rng.uniform(0.3, 2.0, n),
                T2=rng.uniform(0.03, 0.3, n),
                df=np.linspace(-300.0, 300.0, n), M0=rng.uniform(0.7, 1.2, n),
                tr=np.float64(0.005), te=np.float64(0.002))
    names = tuple(args)
    w = rng.standard_normal((n, 2))

    def jloss(dphi, *xs):
        d = dict(zip(names, xs))
        out = jssfp.bssfp_steady(d.pop('alpha'), dphi=dphi, **d)
        return jnp.sum(w * out), out

    f = jax.value_and_grad(jloss, argnums=tuple(range(1, 8)), has_aux=True)
    for dphi in (np.pi, np.pi / 2):
        (_, ref), gref = _jax(f, jnp.float64(dphi),
                              *(jnp.asarray(args[k]) for k in names))
        xs = {k: torch.tensor(v, requires_grad=True) for k, v in args.items()}
        d = dict(xs)
        out = tssfp.bssfp_steady(d.pop('alpha'), dphi=dphi, **d)
        grads = torch.autograd.grad((torch.as_tensor(w) * out).sum(),
                                    list(xs.values()))
        _close(out.detach(), ref, 1e-12)
        for g, gj in zip(grads, gref):
            _close(g, gj, 1e-12)
    # the mid-band amplitude on resonance at te = 0
    a, T1, T2, tr = 0.6, 1.0, 0.08, 0.005
    E1, E2 = np.exp(-tr / T1), np.exp(-tr / T2)
    s = tssfp.bssfp_steady(torch.tensor(a, dtype=torch.float64), T1=T1, T2=T2,
                           tr=tr, te=0.0)
    ref = np.sin(a) * (1 - E1) / (1 - (E1 - E2) * np.cos(a) - E1 * E2)
    np.testing.assert_allclose(float(torch.linalg.vector_norm(s)), ref,
                               rtol=1e-12)


def test_route_matches_jax_decisions(monkeypatch):
    r"""``route('bssfp_train', ...)`` against JAX's ``_decide_bssfp_train``:
    a shared train takes the kernels (JAX's native adjoint) at a scalar or
    (nTR,) tr; a 2-D train or a prepared Minit takes the plain route on the
    card under ``'auto'`` (JAX's XLA fallback) and raises under
    ``'cuda'``."""
    inp = _inputs(5)
    fl, fl2 = inp['flips'], inp['flips'] * np.ones((NA, 1))
    kw = dict(T1=inp['T1'], T2=inp['T2'], df=inp['df'])
    cases = [(dict(flips=fl, tr=0.005), 'cuda-native-adjoint'),
             (dict(flips=fl, tr=inp['tr'], b1=inp['b1']),
              'cuda-native-adjoint'),
             (dict(flips=fl2, tr=0.005), 'torch-fallback'),
             (dict(flips=fl, tr=0.005, Minit=np.zeros((NA, 3))),
              'torch-fallback')]
    jmap = {'pallas-native-adjoint': 'cuda-native-adjoint',
            'xla-fallback': 'torch-fallback'}
    monkeypatch.setattr(routing, '_on_cuda', lambda kw: True)
    for c, path in cases:
        j = jrouting.route('bssfp_train', backend='pallas', **kw, **c)
        assert jmap[j['path']] == path
        r = routing.route('bssfp_train', backend='auto', **kw, **c)
        assert r['path'] == path and r['fused'] == path.startswith('cuda')
        if path == 'torch-fallback':
            with pytest.raises(ValueError, match="backend='cuda'"):
                routing.route('bssfp_train', backend='cuda', **kw, **c)
        else:
            assert 'bssfp_fwd_chk + bssfp_bwd' in r['reason']
    assert routing.route('bssfp_train', backend='torch', flips=fl, tr=0.005,
                         **kw)['path'] == 'torch'
    # a 1M-voxel, 200-TR fit in float32: chunks of 100 TRs
    assert kssfp.chunk(200, 1 << 20, 4) == 100


def test_wrappers_refuse():
    r"""The kernels' arguments are checked before any launch: ``pk``'s
    rows, the dtypes, mixed devices, a chunk that divides the train, the
    checkpoints' count; the rows refuse a 2-D train and trains of another
    length."""
    coef, pk, cfg = _rows(6, True, True)
    with pytest.raises(ValueError, match=r'pk must be \(5, nA\)'):
        kssfp._sizes('bssfp_fwd', coef, pk[:4], cfg)
    with pytest.raises(TypeError, match='float64'):
        kssfp._sizes('bssfp_fwd', coef.float(), pk, cfg)
    with pytest.raises(TypeError, match='float32 or float64'):
        kssfp._sizes('bssfp_fwd', coef.half(), pk.half(), cfg)
    with pytest.raises(ValueError, match='is on meta'):
        kssfp._sizes('bssfp_fwd', coef.to('meta'), pk, cfg)
    with pytest.raises(ValueError, match='must divide'):
        kssfp.bssfp_fwd_chk(coef, pk, cfg, tc=5)
    chk = kssfp.bssfp_fwd_chk(coef, pk, cfg, tc=3)[2]
    g = torch.zeros((NTR, NA), dtype=torch.float64)
    with pytest.raises(ValueError, match='chk holds'):
        kssfp.bssfp_bwd(coef, pk, cfg, chk, g, g, tc=4)
    inp = _inputs(6)
    fl = torch.as_tensor(inp['flips'])
    with pytest.raises(ValueError, match='shared'):
        tssfp._bssfp_rows(fl.expand(NA, NTR), T1=1.0, T2=0.1, tr=0.005)
    with pytest.raises(ValueError, match=r'tr must be a scalar or a \(12,\)'):
        tssfp._bssfp_rows(fl, T1=1.0, T2=0.1, tr=torch.full((5,), 0.005))
    with pytest.raises(ValueError, match=r'phis must be a \(12,\)'):
        tssfp._bssfp_rows(fl, T1=1.0, T2=0.1, tr=0.005, phis=fl[:5])
