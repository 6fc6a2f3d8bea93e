r"""Parity of the port's EPG-X(MT) bound-pool train (:func:`mrphy_tpu_torch.
ops.epg.epgx_mt_spgr`, its primitives ``mt_lineshape``, ``epgx_mt_relax``,
``epgx_mt_rf``, the plain versions of the ``xmt_fwd``/``xmt_fwd_chk``/
``xmt_bwd`` kernels, ``kernels.epgx.xmt_spgr`` and
:func:`mrphy_tpu_torch.ops.routing.route`) with the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both packages, every
port tensor on the CPU, float64 unless stated. The primitives (the three
lineshapes over per-voxel T2b, ``epgx_mt_relax`` with per-atom maps,
``epgx_mt_rf`` with a per-atom saturation) are held to JAX's at 1e-12. The
plain route is held to JAX's XLA scan on two cases that between them take a
scalar and a 1-D batch, a ``(nTR,)`` and a batched ``wt``, b1, kshift 1 and
−1, a truncated and the default K, a scalar and a ``(nTR,)`` tr, and atoms
with and without detailed balance: signals at 1e-10 of their largest value,
gradients w.r.t. flips, phis, T1a, T2a, T1b, kab, kba, tr, wt, M0a, M0b and
b1 at rtol 1e-9 (and 1e-9 of each one's largest value). The kernels' route
(their plain versions under the autograd Function) meets JAX at the same
bars and the plain route at 1e-12; ``xmt_spgr``'s per-atom ``wscale`` meets
the plain route's batched ``wt[None]·wscale[:, None]`` at 1e-12, gradients
too. The written-out chunk adjoint ``xmt_bwd_torch`` meets torch autograd of
the plain forward at 1e-9 over one, three and all TRs a chunk, with and
without b1 and ``wscale``. One float32 case meets JAX's Pallas kernels in
interpret mode (outputs at 3e-6, gradients at 2e-5). Every JAX reference is
compiled at XLA's lowest optimisation level by ``test_torch_epgx._jax``.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mrphy_tpu.ops import epg as jepg
from mrphy_tpu.ops import routing as jrouting
from mrphy_tpu_torch.kernels import epgx as kepgx
from mrphy_tpu_torch.ops import epg as tepg
from mrphy_tpu_torch.ops import routing
from mrphy_tpu_torch.ops.routing import route
from test_torch_epg import _close
from test_torch_epgx import _jax, _tt

NA, NTR, K = 6, 12, 8
NAMES = ('flips', 'phis', 'T1a', 'T2a', 'T1b', 'kab', 'kba', 'tr', 'wt',
         'M0a', 'M0b', 'b1')
MAPS = ('T1a', 'T2a', 'T1b', 'kab', 'kba', 'M0a', 'M0b')


def _inputs(seed=0, nA=NA, nTR=NTR):
    r"""A flip and phase train, a per-TR saturation train ``wt`` (0-1.5),
    per-atom qMT maps (atoms 4 and 5 without detailed balance: kab 8, kba
    3, M0a 1, M0b 0.4), b1, a per-atom saturation scale ``wscale``, a 25-35
    ms tr train, per-voxel T2b (8-14 µs) with saturation offsets (1-20
    kHz), and the loss weights."""
    rng = np.random.default_rng(seed)
    inp = dict(
        flips=rng.uniform(0.1, 1.2, nTR), phis=rng.uniform(-3, 3, nTR),
        wt=rng.uniform(0.0, 1.5, nTR), T1a=rng.uniform(0.6, 2.0, nA),
        T2a=rng.uniform(0.03, 0.1, nA), T1b=rng.uniform(0.5, 1.5, nA),
        kab=rng.uniform(0.5, 5.0, nA), kba=rng.uniform(5.0, 40.0, nA),
        M0a=rng.uniform(0.8, 1.0, nA), M0b=rng.uniform(0.05, 0.25, nA),
        b1=rng.uniform(0.8, 1.2, nA), wscale=rng.uniform(0.5, 1.5, nA),
        trs=rng.uniform(0.025, 0.035, nTR), T2b=rng.uniform(8e-6, 14e-6, nA),
        delta=rng.uniform(1e3, 2e4, nA), w=rng.standard_normal((nA, nTR, 2)))
    if nA >= 6:
        inp['kab'][4:6], inp['kba'][4:6] = 8.0, 3.0
        inp['M0a'][4:6], inp['M0b'][4:6] = 1.0, 0.4
    inp['wt2'] = inp['wt'][None] * inp['wscale'][:, None]
    return inp


# (id, keywords of epgx_mt_spgr beyond the per-atom maps, kshift, K, the
# kernels take it). JAX compiles every reference of this file in one call.
CASES = [
    ('b1_truncated_K', dict(wt='wt', tr=0.03, b1='b1'), 1, K, True),
    ('kshift-1_batched_wt_tr_train_default_K', dict(wt='wt2', tr='trs'), -1,
     None, False),
]
SCALAR = dict(T1a=1.1, T2a=0.06, T1b=1.0, kab=2.0, kba=20.0, tr=0.03,
              M0a=0.9, M0b=0.1, K=K)


def _case(inp, kw):
    base = dict(flips=inp['flips'], phis=inp['phis'],
                **{n: inp[n] for n in MAPS})
    base.update({k: (inp[v] if isinstance(v, str) else v)
                 for k, v in kw.items()})
    return base, [n for n in NAMES if n in base]


def _mt_loss(base, diff, w, kshift, Kc):
    def loss(*a):
        d = dict(base, **dict(zip(diff, a)))
        out = jepg.epgx_mt_spgr(d.pop('flips'), d.pop('phis'), **d,
                                kshift=kshift, K=Kc)
        return jnp.sum(jnp.asarray(w) * out), out
    return jax.value_and_grad(loss, argnums=tuple(range(len(diff))),
                              has_aux=True)


def _state():
    r"""A random EPG-X(MT) state `(NA, 2, 3, K, 2)` (pool b's F rows 0)."""
    s = np.random.default_rng(2).standard_normal((NA, 2, 3, K, 2))
    s[:, 1, :2] = 0.0
    return s


@functools.cache
def _refs():
    r"""Every JAX reference of this file, from one compiled call: per case
    ``(signals, gradients)``, the scalar train, the three lineshapes and
    the primitives."""
    inp = _inputs()
    fns, args = [], []
    for _, kw, kshift, Kc, _ in CASES:
        base, diff = _case(inp, kw)
        fns.append(_mt_loss(base, diff, inp['w'], kshift, Kc))
        args.append([jnp.asarray(base[n], jnp.float64) for n in diff])
    rel = {k: jnp.asarray(inp[k]) for k in MAPS}

    def every(args, flips, phis, s0, delta, T2b):
        return dict(
            cases=[f(*a) for f, a in zip(fns, args)],
            scalar=jepg.epgx_mt_spgr(flips, phis, wt=0.4, **SCALAR),
            shapes={k: jepg.mt_lineshape(delta, T2b, kind=k) for k in
                    ('superlorentzian', 'gaussian', 'lorentzian')},
            shape_grid=jepg.mt_lineshape(delta[:3, None], T2b[None, :]),
            relax=jepg.epgx_mt_relax(s0, 0.027, **rel),
            rf=jepg.epgx_mt_rf(s0, flips[:NA], phis[:NA], inp['wt2'][:, 0]))

    res = _jax(every, args, jnp.asarray(inp['flips']),
               jnp.asarray(inp['phis']), jnp.asarray(_state()),
               jnp.asarray(inp['delta']), jnp.asarray(inp['T2b']))
    return jax.tree_util.tree_map(np.asarray, res)


def _port(fn, base, diff, w, kshift, Kc):
    ta = {n: torch.tensor(np.asarray(base[n], np.float64), requires_grad=True)
          for n in diff}
    kw = _tt(dict(base, **ta))
    out = fn(kw.pop('flips'), kw.pop('phis'), **kw, kshift=kshift, K=Kc)
    grads = torch.autograd.grad((torch.as_tensor(w) * out).sum(),
                                [ta[n] for n in diff])
    return out.detach(), grads


def test_primitives_vs_jax():
    r"""``mt_lineshape`` (super-Lorentzian, Gaussian and Lorentzian over
    per-voxel T2b, and an offset × T2b grid), ``epgx_mt_relax`` with
    per-atom maps and ``epgx_mt_rf`` with a per-atom saturation against
    JAX's at 1e-12; pool b's F rows stay zero."""
    ref, inp = _refs(), _inputs()
    delta, T2b = torch.as_tensor(inp['delta']), torch.as_tensor(inp['T2b'])
    for kind, r in ref['shapes'].items():
        _close(tepg.mt_lineshape(delta, T2b, kind=kind), r, 1e-12)
    _close(tepg.mt_lineshape(delta[:3, None], T2b[None, :]),
           ref['shape_grid'], 1e-12)
    with pytest.raises(ValueError, match='lineshape'):
        tepg.mt_lineshape(delta, T2b, kind='voigt')
    s0 = torch.as_tensor(_state())
    out = tepg.epgx_mt_relax(s0, 0.027, **{k: torch.as_tensor(inp[k])
                                           for k in MAPS})
    _close(out, ref['relax'], 1e-12)
    assert not bool(out[:, 1, :2].any())
    out = tepg.epgx_mt_rf(s0, torch.as_tensor(inp['flips'][:NA]),
                          torch.as_tensor(inp['phis'][:NA]),
                          torch.as_tensor(inp['wt2'][:, 0]))
    _close(out, ref['rf'], 1e-12)
    assert not bool(out[:, 1, :2].any())


@pytest.mark.parametrize('route_', ['plain', 'kernels'])
@pytest.mark.parametrize('ci', range(len(CASES)), ids=[c[0] for c in CASES])
def test_epgx_mt_spgr_vs_jax(ci, route_):
    r"""Signals and the gradients w.r.t. every differentiable input against
    ``jax.value_and_grad`` of JAX's XLA scan; the kernels' route on the
    case the kernels take (a shared wt train, a scalar tr), there also held
    to the plain route at 1e-12."""
    _, kw, kshift, Kc, kernels = CASES[ci]
    if route_ == 'kernels' and not kernels:
        # a batched wt: the kernels' rows refuse it (a per-atom saturation
        # goes through wscale), the (nTR,) tr train beside it
        # notwithstanding
        inp = _inputs()
        base, _ = _case(inp, kw)
        kwt = _tt(base)
        with pytest.raises(ValueError, match='wscale'):
            tepg._xmt_rows(kwt.pop('flips'), kwt.pop('phis'), **kwt)
        return
    inp = _inputs()
    base, diff = _case(inp, kw)
    (_, out_j), grads_j = _refs()['cases'][ci]
    fn = tepg._xmt_scan if route_ == 'plain' else tepg._xmt_kernels
    out, grads = _port(fn, base, diff, inp['w'], kshift, Kc)
    _close(out, out_j, 1e-10)
    for n, g, gj in zip(diff, grads, grads_j):
        assert bool(torch.isfinite(g).all()), n
        np.testing.assert_allclose(g, gj, rtol=1e-9,
                                   atol=1e-9 * float(np.abs(gj).max()),
                                   err_msg=n)
    if route_ == 'kernels':
        out_p, grads_p = _port(tepg._xmt_scan, base, diff, inp['w'], kshift,
                               Kc)
        _close(out, out_p, 1e-12)
        for g, gp in zip(grads, grads_p):
            _close(g, gp, 1e-12)


def test_epgx_mt_spgr_scalar_batch_vs_jax():
    r"""Scalar tissue gives an unbatched ``(nTR, 2)`` train on both routes
    and through the dispatcher, as JAX's; ``mesh=`` and ``kshift=0``
    raise."""
    ref, inp = _refs(), _inputs()
    fl, ph = torch.as_tensor(inp['flips']), torch.as_tensor(inp['phis'])
    for out in (tepg.epgx_mt_spgr(fl, ph, wt=0.4, **SCALAR),
                tepg._xmt_scan(fl, ph, wt=0.4, **SCALAR),
                tepg._xmt_kernels(fl, ph, wt=0.4, **SCALAR)):
        assert out.shape == (NTR, 2)
        _close(out, ref['scalar'], 1e-10)
    with pytest.raises(NotImplementedError, match='mesh'):
        tepg.epgx_mt_spgr(fl, ph, **SCALAR, mesh=object())
    with pytest.raises(ValueError, match='kshift'):
        tepg.epgx_mt_spgr(fl, ph, **SCALAR, kshift=0)


def test_xmt_spgr_wscale_is_batched_wt():
    r"""``xmt_spgr(wt, wscale)`` (the kernels' plain versions) against the
    plain route's batched ``wt[None]·wscale[:, None]`` at 1e-12, signals
    and the gradients w.r.t. every input, ``wt`` and ``wscale`` among
    them; ``(nAtoms, nTR, 2)`` for a single atom too."""
    inp = _inputs(1)
    names = NAMES + ('wscale',)
    base = dict({n: inp[n] for n in names if n not in ('tr', 'wt')},
                tr=np.float64(0.03), wt=inp['wt'])
    w = torch.as_tensor(inp['w'])
    ta = {n: torch.tensor(base[n], requires_grad=True) for n in names}
    out = kepgx.xmt_spgr(**ta, K=K)
    ga = torch.autograd.grad((w * out).sum(), list(ta.values()))
    tb = {n: torch.tensor(base[n], requires_grad=True) for n in names}
    kw = dict(tb)
    wsc = kw.pop('wscale')
    kw['wt'] = kw['wt'][None] * wsc[:, None]
    out2 = tepg._xmt_scan(**kw, K=K)
    gb = torch.autograd.grad((w * out2).sum(), list(tb.values()))
    _close(out.detach(), out2.detach(), 1e-12)
    for n, x, y in zip(names, ga, gb):
        _close(x, y, 1e-12)
    one = kepgx.xmt_spgr(ta['flips'].detach(), T1a=1.0, T2a=0.06, T1b=1.0,
                         kab=2.0, kba=20.0, tr=0.03, wt=0.5, wscale=1.2, K=K)
    assert one.shape == (1, NTR, 2)


@pytest.mark.parametrize('kshift,tc,b1,wscale', [
    (1, 1, True, True), (-1, 3, False, True), (2, NTR, True, False)],
    ids=['kshift1_tc1_b1_wscale', 'kshift-1_tc3_wscale', 'kshift2_tcnTR_b1'])
def test_xmt_bwd_torch_vs_autograd(kshift, tc, b1, wscale):
    r"""The written-out chunk adjoint against torch autograd of the plain
    forward, on the rows the kernels take, over one, three and all TRs a
    chunk; under b1 its rows 0-3 are zero (the angle's gradient goes to
    the flip row and to db1); the checkpointed forward equals the plain
    one bit for bit."""
    inp = _inputs(3)
    kw = _tt({n: inp[n] for n in MAPS})
    coef, pk, cfg, _ = tepg._xmt_rows(
        torch.as_tensor(inp['flips']), torch.as_tensor(inp['phis']), **kw,
        tr=0.03, wt=torch.as_tensor(inp['wt']),
        wscale=torch.as_tensor(inp['wscale']) if wscale else None,
        b1=torch.as_tensor(inp['b1']) if b1 else None, kshift=kshift, K=K)
    assert coef.shape == (10, NTR) and pk.shape == (11, NA)
    coef, pk = coef.detach().requires_grad_(), pk.detach().requires_grad_()
    g = torch.as_tensor(inp['w'])
    sig = kepgx.xmt_fwd_torch(coef, pk, cfg)
    dcoef_a, dpk_a = torch.autograd.grad((g * sig).sum(), (coef, pk))
    coef, pk = coef.detach(), pk.detach()
    sig2, chk = kepgx.xmt_fwd_chk_torch(coef, pk, cfg, tc=tc)
    assert chk.shape == (NTR // tc, 8, K, NA)
    assert torch.equal(sig2, sig.detach())
    dcoef, dpk = kepgx.xmt_bwd_torch(coef, pk, cfg, chk, g, tc=tc)
    assert dcoef.shape == (10, NTR) and dpk.shape == (11, NA)
    if b1:
        assert not bool(dcoef[:4].any())
    np.testing.assert_allclose(dcoef, dcoef_a, rtol=1e-9,
                               atol=1e-9 * float(dcoef_a.abs().max()))
    np.testing.assert_allclose(dpk, dpk_a, rtol=1e-9,
                               atol=1e-9 * float(dpk_a.abs().max()))


def test_xmt_plain_versions_vs_pallas_interpret(monkeypatch):
    r"""Float32, 24 atoms × 16 TRs, K 8, with every option on (rf-spoiled
    phases, a wt train, per-atom b1, wscale, M0a and M0b, atoms without
    detailed balance), against JAX's Pallas kernels in interpret mode
    (``_mt_fwd_chk_kernel`` and ``_mt_bwd_kernel`` under
    ``jax.value_and_grad``, one atom tile, one chunk): signals at 3e-6, the
    gradients w.r.t. every input at 2e-5 of each one's largest value. The
    Pallas kernels repeat their TR loop's body by hand (``_UNROLL``, for
    Mosaic); interpreted that only multiplies the traced program, so it is
    traced once a TR."""
    from mrphy_tpu.ops import epg_pallas
    monkeypatch.setattr(epg_pallas, '_UNROLL', 1)
    nA, nTR = 24, 16
    inp = _inputs(4, nA=nA, nTR=nTR)
    f32 = np.float32
    names = ('flips', 'phis', 'wt', 'T1a', 'T2a', 'T1b', 'kab', 'kba',
             'M0a', 'M0b', 'b1', 'wscale')
    w = inp['w'].astype(f32)

    def jloss(*a):
        d = dict(zip(names, a))
        out = epg_pallas.epgx_mt_spgr_pallas(
            d.pop('flips'), d.pop('phis'), **d, tr=0.03, K=K, tile=128,
            interpret=True)
        return jnp.sum(w * out), out

    (_, ref), gref = _jax(jax.value_and_grad(
        jloss, argnums=tuple(range(len(names))), has_aux=True),
        *(jnp.asarray(inp[n], f32) for n in names))
    ta = {n: torch.tensor(inp[n], dtype=torch.float32, requires_grad=True)
          for n in names}
    out = kepgx.xmt_spgr(**ta, tr=0.03, K=K)
    grads = torch.autograd.grad((torch.as_tensor(w) * out).sum(),
                                list(ta.values()))
    assert out.dtype == torch.float32 and out.shape == ref.shape
    _close(out.detach(), ref, 3e-6)
    for n, g, gj in zip(names, grads, gref):
        assert g.dtype == torch.float32, n
        _close(g, gj, 2e-5)


@pytest.mark.parametrize('route_', ['plain', 'kernels'])
def test_saturation_off_decoupled_is_single_pool(route_):
    r"""wt ≡ 0 and no exchange: pool a is the single-pool train
    (:func:`mrphy_tpu_torch.ops.epg.epg_spgr` at te = 0), to rounding."""
    inp = _inputs(5)
    fl, ph = torch.as_tensor(inp['flips']), torch.as_tensor(inp['phis'])
    T1, T2 = torch.as_tensor(inp['T1a']), torch.as_tensor(inp['T2a'])
    fn = tepg._xmt_scan if route_ == 'plain' else tepg._xmt_kernels
    out = fn(fl, ph, T1a=T1, T2a=T2, T1b=0.5, kab=0.0, kba=0.0, M0b=0.1,
             tr=0.03, wt=0.0, K=K)
    ref = tepg.epg_spgr(fl, ph, T1=T1, T2=T2, tr=0.03, te=0.0, K=K)
    _close(out, ref, 1e-13)


class TestRouting:
    r"""``tests/test_routing.py``'s ``epgx_mt_spgr`` row in the port's path
    names; a ``(nTR,)`` tr train takes the variable-TR kernels
    (``xmt_v_*``) under ``'auto'`` and ``'cuda'``."""

    RNG = np.random.default_rng(0)
    FL = RNG.uniform(0.2, 1.2, 32)
    IV = RNG.uniform(0.02, 0.04, 32)
    A = RNG.uniform(0.5, 2.0, 100)

    def test_epgx_mt_spgr(self, monkeypatch):
        kw = dict(T1a=self.A, T2a=self.A * 0.1, T1b=1.0, kab=5.0, kba=20.0,
                  wt=np.zeros(32))
        for extra in ({'tr': 0.01}, {'tr': 0.01, 'b1': self.A},
                      {'tr': 0.01, 'wscale': self.A}):
            r = route('epgx_mt_spgr', backend='cuda', flips=self.FL, **kw,
                      **extra)
            assert r['path'] == 'cuda-native-adjoint' and r['fused'], extra
            assert r['reason'].startswith('xmt_fwd, and xmt_fwd_chk + '
                                          'xmt_bwd')
            assert 'nTR=32, K=33, nA=100' in r['reason']
            rj = jrouting.route('epgx_mt_spgr', backend='pallas',
                                flips=self.FL, **kw, **extra)
            assert rj['path'] == 'pallas-native-adjoint'
        # the qMT dictionary: the chunk fitted to the scratch (tc 20 at
        # 65,536 x 400, K 48, 8 planes)
        big = np.zeros(65536)
        r = route('epgx_mt_spgr', backend='cuda', flips=np.zeros(400),
                  T1a=1.1, T2a=0.06, T1b=1.0, kab=big, kba=20.0, tr=0.03,
                  wt=np.zeros(400), K=48)
        assert 'nA=65536' in r['reason'] and 'tc=20' in r['reason']
        monkeypatch.setattr(routing, '_on_cuda', lambda kw: True)
        # a batched wt: the plain route under 'auto', refused under 'cuda'
        bw = dict(kw, wt=np.zeros((100, 32)), tr=0.01)
        r = route('epgx_mt_spgr', backend='auto', flips=self.FL, **bw)
        assert r['path'] == 'torch-fallback' and 'wscale' in r['reason']
        assert jrouting.route('epgx_mt_spgr', backend='pallas',
                              flips=self.FL, **bw)['path'] == 'xla-fallback'
        with pytest.raises(ValueError, match='wscale'):
            route('epgx_mt_spgr', backend='cuda', flips=self.FL, **bw)
        # a (nTR,) tr train: the variable-TR kernels
        for backend in ('auto', 'cuda'):
            r = route('epgx_mt_spgr', backend=backend, flips=self.FL, **kw,
                      tr=self.IV)
            assert r['path'] == 'cuda-native-adjoint' and r['fused']
            assert r['reason'].startswith('xmt_v_fwd, and xmt_v_fwd_chk + '
                                          'xmt_v_bwd')
        # per-voxel 2-D trains
        fl2 = np.broadcast_to(self.FL, (4, 32))
        r = route('epgx_mt_spgr', backend='auto', flips=fl2, **kw, tr=0.01)
        assert r['path'] == 'torch-fallback' and not r['fused']
        with pytest.raises(ValueError, match='per-voxel trains'):
            route('epgx_mt_spgr', backend='cuda', flips=fl2, **kw, tr=0.01)
        assert route('epgx_mt_spgr', backend='torch', flips=self.FL, **kw,
                     tr=0.01)['path'] == 'torch'

    def test_cpu_tensors(self):
        r"""``'auto'`` on CPU tensors takes the plain route; ``'cuda'``
        refuses CPU tensors."""
        fl = torch.as_tensor(self.FL)
        kw = dict(T1a=1.0, T2a=0.06, T1b=1.0, kab=2.0, kba=20.0, tr=0.03,
                  wt=0.3)
        assert route('epgx_mt_spgr', flips=fl, **kw)['path'] == 'torch'
        with pytest.raises(ValueError, match='CUDA tensors'):
            tepg.epgx_mt_spgr(fl, **kw, backend='cuda')
