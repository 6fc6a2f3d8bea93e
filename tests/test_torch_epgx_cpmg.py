r"""Parity of the port's two-pool EPG-X CPMG train (:func:`mrphy_tpu_torch.
ops.epg.epgx_cpmg`, the plain versions of the ``xcpmg_fwd``/
``xcpmg_fwd_chk``/``xcpmg_bwd`` kernels and
:func:`mrphy_tpu_torch.ops.routing.route`) with the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both packages, every
port tensor on the CPU, float64 unless stated. Both of the port's routes
are held to JAX's XLA scan: the plain route (a loop over echoes under torch
autograd) and the kernels' route, whose autograd Function runs the plain
versions of the kernels on CPU tensors (``xcpmg_fwd_chk`` forward,
``xcpmg_bwd`` backward). Echoes at 1e-10 of their largest value, gradients
w.r.t. every differentiable input (flips, T1a, T2a, T1b, T2b, kab, kba,
esp, M0a, M0b, dfb, phi_ex, b1) at 1e-9 of each gradient's largest value,
finite on the real axis (dfb = 0) and without exchange (kab = kba = 0),
where the train is also the sum of two single-pool trains. The kernels'
closed-form excitation leaves Z = 0 where JAX's XLA route leaves cos(π/2)·M0
≈ 6e-17·M0: inside these bars. The written-out chunk adjoint
``xcpmg_bwd_torch`` is held to torch autograd of the plain forward at 1e-9,
over one, several and all echoes a chunk; one float32 case with every
option on to JAX's Pallas kernels in interpret mode (echoes at the JAX
suite's 3e-6, ``tests/test_epg_pallas.py``, gradients at 2e-5); the
routing rows are ``tests/test_routing.py``'s ``epgx_cpmg`` row in the
port's path names; and ``examples/mwf_fit.py``'s first loss and gradient
at 6 voxels in float64.
"""

import functools
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mrphy_tpu.ops import epg as jepg
from mrphy_tpu_torch.kernels import epg as kepg
from mrphy_tpu_torch.kernels import epgx as kepgx
from mrphy_tpu_torch.ops import epg as tepg
from mrphy_tpu_torch.ops import routing
from mrphy_tpu_torch.ops.routing import route
from test_torch_epg import _close
from test_torch_epgx import _jax

NA, NE = 8, 8
NAMES = ('flips', 'T1a', 'T2a', 'T1b', 'T2b', 'kab', 'kba', 'esp', 'M0a',
         'M0b', 'dfb', 'phi_ex', 'b1')
MAPS = ('T1a', 'T2a', 'T1b', 'T2b', 'kab', 'kba')


def _inputs(seed=0, nA=NA, nE=NE):
    r"""Atoms 0-3 random, 4-5 on the real axis (dfb = 0), 6-7 without
    exchange (kab = kba = 0, dfb = 0); refocusing flips 100-180°."""
    rng = np.random.default_rng(seed)
    inp = dict(
        flips=rng.uniform(1.75, 3.14, nE), T1a=rng.uniform(0.5, 2.0, nA),
        T2a=rng.uniform(0.05, 0.3, nA), T1b=rng.uniform(0.2, 0.6, nA),
        T2b=rng.uniform(0.005, 0.03, nA), kab=rng.uniform(1.0, 10.0, nA),
        kba=rng.uniform(5.0, 40.0, nA), M0a=rng.uniform(0.7, 1.0, nA),
        M0b=rng.uniform(0.05, 0.3, nA), dfb=rng.uniform(-20, 20, nA),
        phi_ex=rng.uniform(0.0, 6.0, nA), b1=rng.uniform(0.8, 1.2, nA),
        esps=rng.uniform(0.008, 0.012, nE), w=rng.standard_normal((nA, nE,
                                                                   2)))
    inp['dfb'][4:] = 0.0
    inp['kab'][6:] = inp['kba'][6:] = 0.0
    return inp


# (id, keywords of epgx_cpmg beyond flips and MAPS: a string names an
# input). JAX compiles one gradient of its XLA scan w.r.t. every input and
# evaluates it on both cases, the defaults' at DEFAULTS (b1 = 1 scales the
# flips exactly as no b1 does); the other references come from one more
# compiled call (_refs).
CASES = [
    ('defaults', dict(esp=0.01)),
    ('b1_dfb_M0a_M0b_phi_ex', dict(esp=0.012, M0a='M0a', M0b='M0b',
                                   dfb='dfb', phi_ex='phi_ex', b1='b1')),
]

# examples/mwf_fit.py's problem at 6 voxels (its protocol: 32 echoes at esp
# 10 ms, T1a 1 s, T1b 0.4 s, kba 3 /s, kab by detailed balance, a b1 map
# scaling the π train, noise 0.2% of the largest first echo), float64.
MWF = dict(nv=6, ne=32, esp=0.01, T1a=1.0, T1b=0.4, kba=3.0, noise=0.2)
DEFAULTS = dict(M0a=1.0, M0b=0.1, dfb=0.0, phi_ex=math.pi / 2, b1=1.0)


def _case(inp, kw):
    base = dict(flips=inp['flips'], **{n: inp[n] for n in MAPS})
    base.update({k: (inp[v] if isinstance(v, str) else v)
                 for k, v in kw.items()})
    return base, [n for n in NAMES if n in base]


def _xcpmg_loss(w):
    r"""``jax.value_and_grad`` of Σ w·echoes w.r.t. every input of NAMES."""
    def loss(*a):
        d = dict(zip(NAMES, a))
        out = jepg.epgx_cpmg(d.pop('flips'), **d)
        return jnp.sum(jnp.asarray(w) * out), out
    return jax.value_and_grad(loss, argnums=tuple(range(len(NAMES))),
                              has_aux=True)


def _batched(inp):
    r"""A (2, 3) batch of maps with per-voxel `(2, 3, nE)` flips and an
    ``(nE,)`` esp train."""
    T2a = np.concatenate([inp['T2a'][:5], [0.07]]).reshape(2, 3)
    kab = np.concatenate([inp['kab'][:5], [4.0]]).reshape(2, 3)
    fl = np.random.default_rng(7).uniform(1.75, 3.14, (2, 3, NE))
    return dict(T1a=1.0, T2a=T2a, T1b=0.4, T2b=0.015, kab=kab, kba=20.0,
                M0b=0.15, esp=inp['esps']), fl


def mwf_arrays(nv=MWF['nv'], ne=MWF['ne']):
    r"""``examples/mwf_fit.py``'s draws from numpy default_rng(0) in its
    order (MWF, T2a, T2b, b1, then the noise): ``(mwf, T2a, T2b, b1,
    noise (nv, ne, 2))``."""
    rng = np.random.default_rng(0)
    mwf = rng.uniform(0.05, 0.30, nv)
    T2a = rng.uniform(0.060, 0.095, nv)
    T2b = rng.uniform(0.010, 0.022, nv)
    b1 = rng.uniform(0.82, 1.0, nv)
    return mwf, T2a, T2b, b1, rng.standard_normal((nv, ne, 2))


def _mwf_jax():
    r"""The example's first loss and its gradient w.r.t. the log pools, on
    JAX's XLA route (its per-voxel `(nv, ne)` π·b1 train)."""
    c = MWF
    mwf, T2a, T2b, b1, noise = (jnp.asarray(x) for x in mwf_arrays())
    flips = jnp.pi * b1[:, None] * jnp.ones((c['nv'], c['ne']))

    def train(p):
        return jepg.epgx_cpmg(
            flips, T1a=c['T1a'], T2a=p['T2a'], T1b=c['T1b'], T2b=p['T2b'],
            kab=c['kba'] * p['M0b'] / p['M0a'], kba=c['kba'], esp=c['esp'],
            M0a=p['M0a'], M0b=p['M0b'])

    ech = train(dict(M0a=1.0 - mwf, M0b=mwf, T2a=T2a, T2b=T2b))
    sigma = c['noise'] / 100 * jnp.max(jnp.abs(ech[:, 0]))
    ech = ech + sigma * noise
    logp0 = {k: jnp.log(jnp.full(c['nv'], v)) for k, v in
             dict(M0a=0.85, M0b=0.15, T2a=0.070, T2b=0.018).items()}

    def loss(logp):
        return jnp.mean((train({k: jnp.exp(v) for k, v in logp.items()})
                         - ech) ** 2)

    return jax.value_and_grad(loss)(logp0)


@functools.cache
def _refs():
    r"""Every XLA reference of this file: per case ``((loss, echoes),
    gradients of the case's inputs)``, from one compiled gradient; the
    batched train and the MWF example's first loss and gradient, from one
    more compiled call."""
    inp = _inputs()
    args = []
    for _, kw in CASES:
        base, _ = _case(inp, kw)
        args.append([jnp.broadcast_to(jnp.asarray(
            base.get(n, DEFAULTS.get(n)), jnp.float64),
            (NE,) if n == 'flips' else () if n == 'esp' else (NA,))
            for n in NAMES])
    vg = jax.jit(_xcpmg_loss(inp['w'])).lower(*args[0]).compile(
        compiler_options={'xla_backend_optimization_level': 0,
                          'xla_cpu_use_fusion_emitters': False})
    cases = []
    for (_, kw), a in zip(CASES, args):
        (_, out), grads = vg(*a)
        diff = _case(inp, kw)[1]
        cases.append((out, [g for n, g in zip(NAMES, grads) if n in diff]))
    bmaps, bfl = (jax.tree_util.tree_map(jnp.asarray, x)
                  for x in _batched(inp))
    rest = _jax(lambda: dict(batched=jepg.epgx_cpmg(bfl, **bmaps),
                             mwf=_mwf_jax()))
    return jax.tree_util.tree_map(np.asarray, dict(cases=cases, **rest))


def _tt(d):
    return {n: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
            for n, v in d.items()}


def _port(route_, base, diff, w):
    ta = {n: torch.tensor(np.asarray(base[n], np.float64), requires_grad=True)
          for n in diff}
    kw = _tt(dict(base, **ta))
    fn = tepg._xcpmg_scan if route_ == 'plain' else tepg._xcpmg_kernels
    out = fn(kw.pop('flips'), **kw)
    grads = torch.autograd.grad((torch.as_tensor(w) * out).sum(),
                                [ta[n] for n in diff])
    return out.detach(), grads


@pytest.mark.parametrize('route_', ['plain', 'kernels'])
@pytest.mark.parametrize('ci', range(len(CASES)), ids=[c[0] for c in CASES])
def test_epgx_cpmg_vs_jax(ci, route_):
    r"""Echoes and the gradients w.r.t. every differentiable input of the
    case against ``jax.value_and_grad`` of JAX's XLA scan, on both routes;
    finite on the real axis and without exchange."""
    inp = _inputs()
    base, diff = _case(inp, CASES[ci][1])
    out_j, grads_j = _refs()['cases'][ci]
    out, grads = _port(route_, base, diff, inp['w'])
    assert out.shape == (NA, NE, 2)
    _close(out, out_j, 1e-10)
    for n, g, gj in zip(diff, grads, grads_j):
        assert bool(torch.isfinite(g).all()), n
        _close(g, gj, 1e-9)


@pytest.mark.parametrize('route_', ['plain', 'kernels'])
def test_no_exchange_is_two_single_pool_trains(route_):
    r"""kab = kba = 0 (dfb = 0): the echoes are pool a's and pool b's
    single-pool trains (:func:`mrphy_tpu_torch.ops.epg.epg_cpmg`, the same
    excitation phase and b1) weighted by M0a and M0b, to rounding."""
    inp = _inputs(1)
    t = {k: torch.as_tensor(v) for k, v in inp.items()}
    fl = t['flips']
    fn = tepg._xcpmg_scan if route_ == 'plain' else tepg._xcpmg_kernels
    out = fn(fl, T1a=t['T1a'], T2a=t['T2a'], T1b=t['T1b'], T2b=t['T2b'],
             kab=0.0, kba=0.0, esp=0.011, M0a=t['M0a'], M0b=t['M0b'],
             phi_ex=t['phi_ex'], b1=t['b1'])
    ref = sum(tepg.epg_cpmg(fl, T1=t[f'T1{p}'], T2=t[f'T2{p}'], esp=0.011,
                            M0=t[f'M0{p}'], phi_ex=t['phi_ex'], b1=t['b1'])
              for p in 'ab')
    _close(out, ref, 1e-13)


def test_esp_train_2d_flips_batched_maps_vs_jax():
    r"""The plain route on what the kernels do not take: a (2, 3) batch of
    maps with per-voxel `(2, 3, nE)` flips and an ``(nE,)`` esp train,
    against JAX's XLA scan; ``backend='auto'`` takes it on CPU tensors."""
    maps, fl = _batched(_inputs())
    out = tepg.epgx_cpmg(torch.as_tensor(fl), **_tt(maps))
    assert out.shape == (2, 3, NE, 2)
    _close(out, _refs()['batched'], 1e-10)


@pytest.mark.parametrize('tc,b1', [(1, True), (3, True), (NE + 4, True),
                                   (1, False), (3, False), (NE + 4, False)],
                         ids=['tc1_b1', 'tc3_b1', 'tc_nE_b1', 'tc1', 'tc3',
                              'tc_nE'])
def test_xcpmg_bwd_torch_vs_autograd(tc, b1):
    r"""The written-out chunk adjoint (``_xcpmg_bwd_kernel``'s order)
    against torch autograd of the plain forward, on the rows the kernels
    take (12 echoes: chunks of one echo, of three, and one chunk of all),
    with and without b1."""
    nE = NE + 4
    inp = _inputs(3, nE=nE)
    base, _ = _case(inp, dict(esp=0.01, M0a='M0a', M0b='M0b', dfb='dfb',
                              phi_ex='phi_ex', **({'b1': 'b1'} if b1
                                                  else {})))
    kw = _tt(base)
    coef, pk, cfg, _ = tepg._xcpmg_rows(kw.pop('flips'), **kw)
    assert cfg == kepgx.XcpmgCfg(K=nE + 1, has_b1=b1)
    coef, pk = coef.detach().requires_grad_(), pk.detach().requires_grad_()
    rng = np.random.default_rng(9)
    gr, gi = (torch.as_tensor(rng.standard_normal((nE, NA)))
              for _ in range(2))
    er, ei = kepgx.xcpmg_fwd_torch(coef, pk, cfg)
    dcoef_a, dpk_a = torch.autograd.grad((gr * er).sum() + (gi * ei).sum(),
                                         (coef, pk))
    er2, ei2, chk = kepgx.xcpmg_fwd_chk_torch(coef.detach(), pk.detach(),
                                              cfg, tc=tc)
    assert chk.shape == (nE // tc, 12, nE + 1, NA)
    assert torch.equal(er2, er.detach()) and torch.equal(ei2, ei.detach())
    dcoef, dpk = kepgx.xcpmg_bwd_torch(coef.detach(), pk.detach(), cfg, chk,
                                       gr, gi, tc=tc)
    assert dcoef.shape == (5, nE) and dpk.shape == (19, NA)
    if b1:
        # the angle's gradient goes to the flip row and to db1
        assert not bool(dcoef[:4].any())
    for x, y in ((dcoef, dcoef_a), (dpk, dpk_a)):
        np.testing.assert_allclose(x, y, rtol=1e-9,
                                   atol=1e-9 * float(y.abs().max()))


def test_xcpmg_plain_versions_vs_pallas_interpret():
    r"""Float32, one tiny case with every option on (per-atom b1, dfb, M0a,
    M0b, phi_ex; no detailed balance), against JAX's Pallas kernels in
    interpret mode: echoes at the JAX suite's 3e-6, the gradients (through
    the in-kernel adjoint ``_xcpmg_bwd_kernel``) w.r.t. every input at 2e-5
    of each one's largest value."""
    from mrphy_tpu.ops import epg_pallas
    nA, nE = 100, 5
    inp = _inputs(4, nA=nA, nE=nE)
    f32 = np.float32
    names = ('flips', 'T1a', 'T2a', 'T1b', 'T2b', 'kab', 'kba', 'M0a', 'M0b',
             'dfb', 'phi_ex', 'b1')
    w = inp['w'].astype(f32)

    def jloss(*a):
        d = dict(zip(names, a))
        out = epg_pallas.epgx_cpmg_pallas(d.pop('flips'), **d, esp=0.01,
                                          tile=128, interpret=True)
        return jnp.sum(w * out), out

    (_, ref), gref = _jax(jax.value_and_grad(
        jloss, argnums=tuple(range(len(names))), has_aux=True),
        *(jnp.asarray(inp[n], f32) for n in names))
    ta = {n: torch.tensor(inp[n], dtype=torch.float32, requires_grad=True)
          for n in names}
    kw = dict(ta)
    out = tepg._xcpmg_kernels(kw.pop('flips'), **kw, esp=0.01)
    grads = torch.autograd.grad((torch.as_tensor(w) * out).sum(),
                                list(ta.values()))
    assert out.dtype == torch.float32 and out.shape == ref.shape
    _close(out.detach(), ref, 3e-6)
    for g, gj in zip(grads, gref):
        _close(g, gj, 2e-5)


def test_mwf_example_first_loss_and_gradient_vs_jax():
    r"""``examples/mwf_fit.py`` at 6 voxels in float64 through the kernels'
    route (a shared ``(nE,)`` π train with the b1 map as ``b1=``, as on the
    card): the first loss and its gradient w.r.t. the log pools against
    JAX's (the example's per-voxel π·b1 train on the XLA route) at 1e-10."""
    c = MWF
    loss_j, grad_j = _refs()['mwf']
    mwf, T2a, T2b, b1, noise = (torch.as_tensor(x) for x in mwf_arrays())
    flips = math.pi * torch.ones(c['ne'], dtype=torch.float64)

    def train(p):
        return tepg._xcpmg_kernels(
            flips, T1a=c['T1a'], T2a=p['T2a'], T1b=c['T1b'], T2b=p['T2b'],
            kab=c['kba'] * p['M0b'] / p['M0a'], kba=c['kba'], esp=c['esp'],
            M0a=p['M0a'], M0b=p['M0b'], b1=b1)

    ech = train(dict(M0a=1 - mwf, M0b=mwf, T2a=T2a, T2b=T2b))
    ech = ech + c['noise'] / 100 * ech[:, 0].abs().max() * noise
    logp = {k: torch.full((c['nv'],), math.log(v), dtype=torch.float64,
                          requires_grad=True)
            for k, v in dict(M0a=0.85, M0b=0.15, T2a=0.070,
                             T2b=0.018).items()}
    loss = torch.mean((train({k: torch.exp(v) for k, v in logp.items()})
                       - ech) ** 2)
    grads = torch.autograd.grad(loss, list(logp.values()))
    np.testing.assert_allclose(float(loss.detach()), float(loss_j),
                               rtol=1e-10)
    for k, g in zip(logp, grads):
        _close(g, grad_j[k], 1e-10)


class TestRouting:
    r"""``tests/test_routing.py``'s ``epgx_cpmg`` row in the port's path
    names."""

    RNG = np.random.default_rng(0)
    FL = RNG.uniform(1.5, np.pi, 32)
    FL2D = RNG.uniform(1.5, np.pi, (4, 32))
    ESPS = RNG.uniform(0.008, 0.012, 32)
    A = RNG.uniform(0.05, 0.3, 100)
    KW = dict(T1a=1.0, T2a=A, T1b=0.4, T2b=0.015, kab=0.3, kba=3.0)

    def test_epgx_cpmg(self, monkeypatch):
        for extra in ({'esp': 0.01}, {'esp': 0.01, 'b1': self.A}):
            r = route('epgx_cpmg', backend='cuda', flips=self.FL,
                      **self.KW, **extra)
            assert r['path'] == 'cuda-native-adjoint' and r['fused'], extra
            assert 'nE=32, K=33, nA=100' in r['reason']
        # the whole-brain map: its adjoint's chunk would be one echo (32
        # checkpoints of 1.66 GB in float32); the fit's 262,144-voxel
        # blocks take tc 4
        for nA, tc in ((1 << 20, 1), (1 << 18, 4)):
            r = route('epgx_cpmg', backend='cuda', flips=self.FL,
                      **dict(self.KW, T2a=np.zeros(nA)), esp=0.01)
            assert f'nA={nA}; the adjoint chunk tc={tc} ' in r['reason']
            assert kepg.pick_tc(32, 33, nA, 4, kepgx.PLANES) == tc
        # an (nE,) esp train on the card: the echo-spacing kernels under
        # 'auto' and 'cuda' alike; 'torch' runs the plain route
        monkeypatch.setattr(routing, '_on_cuda', lambda kw: True)
        for backend in ('auto', 'cuda'):
            r = route('epgx_cpmg', backend=backend, flips=self.FL, **self.KW,
                      esp=self.ESPS)
            assert r['path'] == 'cuda-native-adjoint' and r['fused']
            assert r['reason'].startswith(
                'xcpmg_v_fwd, and xcpmg_v_fwd_chk + xcpmg_v_bwd under a '
                'gradient (nE=32, K=33, nA=100, variable esp (per-step '
                'propagators); the adjoint chunk tc=32 '), r['reason']
        assert route('epgx_cpmg', backend='torch', flips=self.FL, **self.KW,
                     esp=self.ESPS)['path'] == 'torch'
        # per-voxel 2-D trains: the plain route under 'auto' on the card,
        # refused under 'cuda'
        r = route('epgx_cpmg', backend='auto', flips=self.FL2D, **self.KW,
                  esp=0.01)
        assert r['path'] == 'torch-fallback' and not r['fused']
        with pytest.raises(ValueError, match='per-voxel trains'):
            route('epgx_cpmg', backend='cuda', flips=self.FL2D, **self.KW,
                  esp=0.01)

    def test_backends(self):
        kw = dict(flips=self.FL, **self.KW, esp=0.01)
        assert route('epgx_cpmg', backend='torch', **kw)['path'] == 'torch'
        assert route('epgx_cpmg', **kw)['path'] == 'torch'
        fl = torch.as_tensor(self.FL)
        with pytest.raises(ValueError, match='CUDA tensors'):
            tepg.epgx_cpmg(fl, **self.KW, esp=0.01, backend='cuda')
        with pytest.raises(ValueError, match='CUDA tensors'):
            tepg.epgx_cpmg(fl, **self.KW, esp=torch.as_tensor(self.ESPS),
                           backend='cuda')
        with pytest.raises(NotImplementedError, match='mesh'):
            route('epgx_cpmg', mesh=object(), **kw)
        with pytest.raises(NotImplementedError, match='mesh'):
            tepg.epgx_cpmg(fl, **self.KW, esp=0.01, mesh=object())

    def test_kernel_wrappers_refuse(self):
        r"""The kernels' arguments are checked before any launch: ``pk``'s
        rows, ``K`` ≥ 2, a chunk that divides the train; an ``(nE,)`` esp
        gives the echo-spacing kernels' pair ``(pk (5, nA), pkt (nE, 14,
        nA))``, the planes at half of each spacing."""
        coef, pk, cfg, _ = tepg._xcpmg_rows(torch.as_tensor(self.FL[:6]),
                                            **self.KW, esp=0.01)
        with pytest.raises(ValueError, match=r'pk must be \(19, nA\)'):
            kepgx._xcpmg_sizes('xcpmg_fwd', coef, pk[:17], cfg)
        with pytest.raises(ValueError, match='K >= 2'):
            kepgx._xcpmg_sizes('xcpmg_fwd', coef, pk, cfg._replace(K=1))
        with pytest.raises(ValueError, match='must divide'):
            kepgx.xcpmg_fwd_chk(coef, pk, cfg, tc=4)
        esps = torch.as_tensor(self.ESPS[:6])
        coef_v, (pk5, pkt), cfg_v, _ = tepg._xcpmg_rows(
            torch.as_tensor(self.FL[:6]), **self.KW, esp=esps)
        assert cfg_v == cfg and torch.equal(coef_v, coef)
        assert pk5.shape == (5, 100) and torch.equal(pk5, pk[14:])
        kw = {n: torch.broadcast_to(torch.as_tensor(v, dtype=torch.float64),
                                    (100,))
              for n, v in self.KW.items()}
        zero = torch.zeros(100, dtype=torch.float64)
        assert torch.equal(pkt, tepg._x_step_entries(
            *kw.values(), pk[16], pk[17], zero, esps / 2))
