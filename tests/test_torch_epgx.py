r"""Parity of the port's two-pool EPG-X SPGR train (:func:`mrphy_tpu_torch.
ops.epg.epgx_spgr`, its primitives, the plain versions of the
``xspgr_fwd``/``xspgr_fwd_chk``/``xspgr_bwd`` kernels and
:func:`mrphy_tpu_torch.ops.routing.route`) with the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both packages, every
port tensor on the CPU, float64 unless stated. The primitives (``_expm2c``
with its gradient at q → 0 and on the real axis, ``_z_recovery``,
``epgx_state``, ``epgx_rf``, ``epgx_relax``) are held to JAX's at 1e-12.
Both of the port's routes are held to JAX's XLA scan: the plain route (a
loop over TRs under torch autograd) and the kernels' route, whose autograd
Function runs the plain versions of the kernels on CPU tensors
(``xspgr_fwd_chk`` forward, ``xspgr_bwd`` backward): signals at 1e-10 of
their largest value, gradients w.r.t. every differentiable input at 1e-9
of each gradient's largest value (and ∂/∂dfb of the atoms without
exchange, which vanishes, at 1e-12 of its largest). The written-out chunk
adjoint ``xspgr_bwd_torch`` is held to torch autograd of the plain forward
at 1e-9, over several chunks; one float32 case with every option on to
JAX's Pallas kernels in interpret mode (signals at the JAX suite's 3e-6,
``tests/test_epg_pallas.py``, gradients at 2e-5); the routing rows are
``tests/test_routing.py``'s ``epgx_spgr`` row in the port's path names.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mrphy_tpu.ops import epg as jepg
from mrphy_tpu.ops import slowsims as jslow
from mrphy_tpu_torch.kernels import epg as kepg
from mrphy_tpu_torch.kernels import epgx as kepgx
from mrphy_tpu_torch.ops import epg as tepg
from mrphy_tpu_torch.ops import routing
from mrphy_tpu_torch.ops.routing import route
from test_torch_epg import _close

NA, NTR, K = 5, 12, 8
NAMES = ('flips', 'phis', 'T1a', 'T2a', 'T1b', 'T2b', 'kab', 'kba', 'tr',
         'M0a', 'M0b', 'dfb', 'b1')


def _jax(fn, *args):
    r"""``jax.jit(fn)(*args)`` compiled as ``test_torch_epg._jax`` compiles
    it (XLA's lowest optimisation level), with XLA:CPU's fusion emitters
    off as well: the two-pool gradient scans and the interpreted Pallas
    adjoint then compile in under half the time, and compiling is nearly
    all of their cost."""
    return jax.jit(fn).lower(*args).compile(compiler_options={
        'xla_backend_optimization_level': 0,
        'xla_cpu_use_fusion_emitters': False})(*args)


def _inputs(seed=0, nA=NA, nTR=NTR):
    rng = np.random.default_rng(seed)
    return dict(
        flips=rng.uniform(0.1, 1.2, nTR), phis=rng.uniform(-3, 3, nTR),
        T1a=rng.uniform(0.4, 2.2, nA), T2a=rng.uniform(0.04, 0.12, nA),
        T1b=rng.uniform(0.3, 1.2, nA), T2b=rng.uniform(0.005, 0.03, nA),
        kab=rng.uniform(1.0, 15.0, nA), kba=rng.uniform(5.0, 40.0, nA),
        M0a=rng.uniform(0.8, 1.2, nA), M0b=rng.uniform(0.05, 0.3, nA),
        dfb=rng.uniform(-20, 20, nA), b1=rng.uniform(0.8, 1.2, nA),
        trs=rng.uniform(0.008, 0.016, nTR), w=rng.standard_normal((nA, nTR,
                                                                   2)))


def _atoms(seed=0):
    r"""The parity cases' atoms, every map per atom: atoms 0-4 random
    (per-atom dfb, b1, M0a, M0b, exchange rates), 5-6 without exchange (kab
    = kba = 0), 7-8 on the real axis (dfb = 0), 9-10 without detailed
    balance (kab 8, kba 3, M0a 1, M0b 0.4: kab·M0a ≠ kba·M0b)."""
    inp = _inputs(seed, nA=NATOMS)
    inp['kab'][5:7] = inp['kba'][5:7] = 0.0
    inp['dfb'][7:9] = 0.0
    inp['kab'][9:], inp['kba'][9:] = 8.0, 3.0
    inp['M0a'][9:], inp['M0b'][9:] = 1.0, 0.4
    return inp


# (id, keywords of epgx_spgr beyond the per-atom maps of _atoms, kshift, K).
# JAX compiles every reference of this file in one call (_refs).
NATOMS = 11
CASES = [
    ('rf_spoiled_b1_truncated_K', dict(tr=0.012, b1='b1'), 1, K),
    ('kshift-1_default_K', dict(tr=0.01), -1, None),
]
SCALAR = dict(T1a=0.9, T2a=0.08, T1b=1.0, T2b=0.02, kab=6.0, kba=40.0,
              tr=0.012, M0b=0.15, K=K)
MAPS = ('T1a', 'T2a', 'T1b', 'T2b', 'kab', 'kba', 'M0a', 'M0b', 'dfb')


def _case(inp, kw):
    base = dict(flips=inp['flips'], phis=inp['phis'],
                **{n: inp[n] for n in MAPS})
    base.update({k: (inp[v] if isinstance(v, str) else v)
                 for k, v in kw.items()})
    return base, [n for n in NAMES if n in base]


def _xspgr_loss(base, diff, w, kshift, Kc):
    def loss(*a):
        d = dict(base, **dict(zip(diff, a)))
        out = jepg.epgx_spgr(d.pop('flips'), d.pop('phis'), **d,
                             kshift=kshift, K=Kc)
        return jnp.sum(jnp.asarray(w) * out), out
    return jax.value_and_grad(loss, argnums=tuple(range(len(diff))),
                              has_aux=True)


def _prim_args(seed=1, n=6):
    r"""``_expm2c``'s arguments at ``n`` random points, then at q → 0 (a
    = d, b·c = 0) and on the real axis (zero imaginary parts)."""
    rng = np.random.default_rng(seed)
    ar, b, c, dr = (rng.uniform(-1, 0, n), rng.uniform(0, 0.3, n),
                    rng.uniform(0, 0.3, n), rng.uniform(-1, 0, n))
    ai, di = rng.uniform(-0.5, 0.5, n), rng.uniform(-0.5, 0.5, n)
    # q → 0: equal diagonals, one off-diagonal zero, |q|² ~ 1e-14
    ar[0], dr[0], ai[0], di[0], b[0], c[0] = -0.3, -0.3, 0.0, 0.0, 1e-7, 1e-7
    ar[1], dr[1], ai[1], di[1], b[1], c[1] = -0.2, -0.2, 0.1, 0.1, 0.2, 0.0
    ai[2:4], di[2:4] = 0.0, 0.0                      # the real axis
    return ar, ai, b, c, dr, di


def _state_and_cot():
    r"""A random two-pool state `(NA, 2, 3, K, 2)` for the primitives and a
    cotangent of ``_expm2c``'s four entries."""
    rng = np.random.default_rng(2)
    return (rng.standard_normal((NA, 2, 3, K, 2)),
            rng.standard_normal((4, 2, len(_prim_args()[0]))))


@functools.cache
def _refs():
    r"""Every JAX reference of this file, from one compiled call: per case
    ``(signals, gradients)``, the scalar train, the batched train (a (2,
    3) batch of maps, per-voxel 2-D flips and a ``(nTR,)`` tr train), and
    the primitives."""
    inp, atoms = _inputs(), _atoms()
    fns, args = [], []
    for _, kw, kshift, Kc in CASES:
        base, diff = _case(atoms, kw)
        fns.append(_xspgr_loss(base, diff, atoms['w'], kshift, Kc))
        args.append([jnp.asarray(base[n], jnp.float64) for n in diff])
    pa = [jnp.asarray(x) for x in _prim_args()]
    s0, co = (jnp.asarray(x) for x in _state_and_cot())
    al, ph = jnp.asarray(inp['flips'][:NA]), jnp.asarray(inp['phis'][:NA])
    rel = {k: jnp.asarray(inp[k]) for k in MAPS}
    bmaps, bfl = (jax.tree_util.tree_map(jnp.asarray, x)
                  for x in _batched(inp))

    def expm2c_vjp(*a):
        def f(*a):
            return jnp.stack([jnp.stack(e) for e in jepg._expm2c(*a)])
        out, vjp = jax.vjp(f, *a)
        return out, vjp(co)

    def every(args, flips, phis, trs):
        Z = jslow._expm2((-1 / rel['T1a'] - rel['kab']) * 0.01,
                         rel['kba'] * 0.01, rel['kab'] * 0.01,
                         (-1 / rel['T1b'] - rel['kba']) * 0.01)
        return dict(
            cases=[f(*a) for f, a in zip(fns, args)],
            scalar=jepg.epgx_spgr(flips, phis, **SCALAR),
            batched=jepg.epgx_spgr(bfl, phis, **bmaps, tr=trs, K=K),
            expm2c=expm2c_vjp(*pa),
            zrec=jepg._z_recovery(*Z, rel['T1a'], rel['T1b'], rel['kab'],
                                  rel['kba'], rel['M0a'], rel['M0b']),
            state=jepg.epgx_state(K, (NA,), M0a=rel['M0a'], M0b=rel['M0b'],
                                  dtype=jnp.float64),
            rf=jepg.epgx_rf(s0, al, ph, 0.7),
            relax=jepg.epgx_relax(s0, 0.013, **rel))

    res = _jax(every, args, jnp.asarray(inp['flips']),
               jnp.asarray(inp['phis']), jnp.asarray(inp['trs']))
    return jax.tree_util.tree_map(np.asarray, res)


def _batched(inp):
    r"""A (2, 3) batch: ``(maps, flips)``, (T1a, kab) and kba = kab/0.15
    from the inputs' first values, per-voxel `(2, 3, nTR)` flips."""
    T1 = np.concatenate([inp['T1a'], inp['T1a'][:1] * 1.5]).reshape(2, 3)
    kab = np.concatenate([inp['kab'], inp['kab'][:1] * 0.5]).reshape(2, 3)
    fl = np.random.default_rng(7).uniform(0.1, 1.2, (2, 3, NTR))
    return dict(T1a=T1, T2a=0.08, T1b=1.0, T2b=0.02, kab=kab,
                kba=kab / 0.15, M0b=0.15), fl


def _tt(d):
    return {n: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
            for n, v in d.items()}


def _port(route_, base, diff, w, kshift, Kc):
    ta = {n: torch.tensor(np.asarray(base[n], np.float64), requires_grad=True)
          for n in diff}
    kw = _tt(dict(base, **ta))
    fn = tepg._xspgr_scan if route_ == 'plain' else tepg._xspgr_kernels
    out = fn(kw.pop('flips'), kw.pop('phis'), **kw, kshift=kshift, K=Kc)
    grads = torch.autograd.grad((torch.as_tensor(w) * out).sum(),
                                [ta[n] for n in diff])
    return out.detach(), grads


def test_primitives_vs_jax():
    r"""``_expm2c`` (values and the VJP, at random points, at q → 0 and on
    the real axis), ``_z_recovery`` without detailed balance,
    ``epgx_state``, ``epgx_rf`` with pool b's flip scaled, and
    ``epgx_relax`` with per-atom maps, against JAX's at 1e-12; the real
    ``_expm2`` the port shares with the two-pool engine is JAX's term for
    term."""
    ref = _refs()
    inp = _inputs()
    pa = [torch.tensor(x, requires_grad=True) for x in _prim_args()]
    out = torch.stack([torch.stack(e) for e in tepg._expm2c(*pa)])
    s0, co = (torch.as_tensor(x) for x in _state_and_cot())
    grads = torch.autograd.grad(out, pa, co)
    eo, eg = ref['expm2c']
    _close(out.detach(), eo, 1e-12)
    for g, gj in zip(grads, eg):
        assert bool(torch.isfinite(g).all())
        _close(g, gj, 1e-12)
    rel = {k: torch.as_tensor(inp[k]) for k in ('T1a', 'T2a', 'T1b', 'T2b',
                                                'kab', 'kba', 'M0a', 'M0b',
                                                'dfb')}
    Z = tepg._expm2((-1 / rel['T1a'] - rel['kab']) * 0.01,
                    rel['kba'] * 0.01, rel['kab'] * 0.01,
                    (-1 / rel['T1b'] - rel['kba']) * 0.01)
    for x, xj in zip(tepg._z_recovery(*Z, rel['T1a'], rel['T1b'], rel['kab'],
                                      rel['kba'], rel['M0a'], rel['M0b']),
                     ref['zrec']):
        _close(x, xj, 1e-12)
    st = tepg.epgx_state(K, (NA,), M0a=rel['M0a'], M0b=rel['M0b'],
                         dtype=torch.float64)
    assert torch.equal(st, torch.tensor(ref['state']))
    _close(tepg.epgx_rf(s0, torch.as_tensor(inp['flips'][:NA]),
                        torch.as_tensor(inp['phis'][:NA]), 0.7),
           ref['rf'], 1e-12)
    _close(tepg.epgx_relax(s0, 0.013, **rel), ref['relax'], 1e-12)


@pytest.mark.parametrize('route_', ['plain', 'kernels'])
@pytest.mark.parametrize('ci', range(len(CASES)), ids=[c[0] for c in CASES])
def test_epgx_spgr_vs_jax(ci, route_):
    r"""Signals and the gradients w.r.t. every differentiable input (flips,
    phis, T1a, T2a, T1b, T2b, kab, kba, tr, M0a, M0b, dfb, b1, per atom)
    against ``jax.value_and_grad`` of JAX's XLA scan, on both routes;
    finite on the real axis (dfb = 0) and without exchange (kab = kba = 0,
    where ∂/∂dfb vanishes: an isolated pool's gradient-spoiled train does
    not depend on its off-resonance)."""
    _, kw, kshift, Kc = CASES[ci]
    atoms = _atoms()
    base, diff = _case(atoms, kw)
    (_, out_j), grads_j = _refs()['cases'][ci]
    out, grads = _port(route_, base, diff, atoms['w'], kshift, Kc)
    _close(out, out_j, 1e-10)
    for n, g, gj in zip(diff, grads, grads_j):
        assert bool(torch.isfinite(g).all()), n
        _close(g, gj, 1e-9)
    assert float(grads[diff.index('dfb')][5:7].abs().max()) <= 1e-12 * float(
        grads[diff.index('dfb')].abs().max())


def test_epgx_spgr_scalar_and_batched_vs_jax():
    r"""Scalar tissue gives an unbatched ``(nTR, 2)`` train on both routes,
    as JAX's; on the plain route, a (2, 3) batch of maps with per-voxel 2-D
    flips and a ``(nTR,)`` tr train against JAX's XLA scan."""
    ref, inp = _refs(), _inputs()
    fl, ph = torch.as_tensor(inp['flips']), torch.as_tensor(inp['phis'])
    for out in (tepg.epgx_spgr(fl, ph, **SCALAR),
                tepg._xspgr_kernels(fl, ph, **SCALAR)):
        assert out.shape == (NTR, 2)
        _close(out, ref['scalar'], 1e-10)
    maps, fl2 = _batched(inp)
    out = tepg.epgx_spgr(torch.as_tensor(fl2), ph, **_tt(maps),
                         tr=torch.as_tensor(inp['trs']), K=K)
    assert out.shape == (2, 3, NTR, 2)
    _close(out, ref['batched'], 1e-10)


@pytest.mark.parametrize('kshift,tc,b1', [(1, 4, True), (-1, 3, False),
                                          (2, 2, True)],
                         ids=['kshift1_tc4_b1', 'kshift-1_tc3',
                              'kshift2_tc2_b1'])
def test_xspgr_bwd_torch_vs_autograd(kshift, tc, b1):
    r"""The written-out chunk adjoint against torch autograd of the plain
    forward, over several chunks, on the rows the kernels take."""
    inp = _inputs(3)
    base, _ = _case(inp, dict(kab='kab', kba='kba', tr=0.012, M0a='M0a',
                              M0b='M0b', dfb='dfb',
                              **({'b1': 'b1'} if b1 else {})))
    kw = _tt(base)
    coef, par, cfg, _ = tepg._xspgr_rows(kw.pop('flips'), kw.pop('phis'),
                                         **kw, kshift=kshift, K=K)
    coef, par = coef.detach().requires_grad_(), par.detach().requires_grad_()
    g = torch.as_tensor(inp['w'])
    sig = kepgx.xspgr_fwd_torch(coef, par, cfg)
    dcoef_a, dpar_a = torch.autograd.grad((g * sig).sum(), (coef, par))
    sig2, chk = kepgx.xspgr_fwd_chk_torch(coef.detach(), par.detach(), cfg,
                                          tc=tc)
    assert chk.shape == (NTR // tc, 12, K, NA)
    assert torch.equal(sig2, sig.detach())
    dcoef, dpar = kepgx.xspgr_bwd_torch(coef.detach(), par.detach(), cfg,
                                        chk, g, tc=tc)
    assert dcoef.shape == (9, NTR) and dpar.shape == (17, NA)
    np.testing.assert_allclose(dcoef, dcoef_a, rtol=1e-9,
                               atol=1e-9 * float(dcoef_a.abs().max()))
    np.testing.assert_allclose(dpar, dpar_a, rtol=1e-9,
                               atol=1e-9 * float(dpar_a.abs().max()))


def test_xspgr_plain_versions_vs_pallas_interpret():
    r"""Float32, one tiny case with every option on (rf-spoiled phases,
    per-atom b1, dfb, M0a and M0b, no detailed balance, truncated K),
    against JAX's Pallas kernels in interpret mode: signals at the JAX suite's
    3e-6, the gradients (through the in-kernel adjoint
    ``_xspgr_bwd_kernel``) w.r.t. every input at 2e-5 of each one's largest
    value."""
    from mrphy_tpu.ops import epg_pallas
    nA, nTR, Kp = 100, 5, 6
    inp = _inputs(4, nA=nA, nTR=nTR)
    f32 = np.float32
    names = ('flips', 'phis', 'T1a', 'T2a', 'T1b', 'T2b', 'kab', 'kba',
             'M0a', 'M0b', 'dfb', 'b1')
    w = inp['w'].astype(f32)

    def jloss(*a):
        d = dict(zip(names, a))
        out = epg_pallas.epgx_spgr_pallas(
            d.pop('flips'), d.pop('phis'), **d, tr=0.012, K=Kp, tile=128,
            interpret=True)
        return jnp.sum(w * out), out

    (_, ref), gref = _jax(jax.value_and_grad(
        jloss, argnums=tuple(range(len(names))), has_aux=True),
        *(jnp.asarray(inp[n], f32) for n in names))
    ta = {n: torch.tensor(inp[n], dtype=torch.float32, requires_grad=True)
          for n in names}
    kw = dict(ta)
    out = tepg._xspgr_kernels(kw.pop('flips'), kw.pop('phis'), **kw,
                              tr=0.012, K=Kp)
    grads = torch.autograd.grad((torch.as_tensor(w) * out).sum(),
                                list(ta.values()))
    assert out.dtype == torch.float32 and out.shape == ref.shape
    _close(out.detach(), ref, 3e-6)
    for g, gj in zip(grads, gref):
        _close(g, gj, 2e-5)


@pytest.mark.parametrize('route_', ['plain', 'kernels'])
def test_decoupled_limit_is_single_pool(route_):
    r"""kab = kba = 0 and M0b = 0: pool a is the single-pool train
    (:func:`mrphy_tpu_torch.ops.epg.epg_spgr` at te = 0), to rounding."""
    inp = _inputs(5)
    fl, ph = torch.as_tensor(inp['flips']), torch.as_tensor(inp['phis'])
    T1, T2 = torch.as_tensor(inp['T1a']), torch.as_tensor(inp['T2a'])
    fn = tepg._xspgr_scan if route_ == 'plain' else tepg._xspgr_kernels
    out = fn(fl, ph, T1a=T1, T2a=T2, T1b=0.3, T2b=0.01, kab=0.0, kba=0.0,
             M0b=0.0, tr=0.012, K=K)
    ref = tepg.epg_spgr(fl, ph, T1=T1, T2=T2, tr=0.012, te=0.0, K=K)
    _close(out, ref, 1e-13)


class TestRouting:
    r"""``tests/test_routing.py``'s ``epgx_spgr`` row in the port's path
    names."""

    RNG = np.random.default_rng(0)
    FL = RNG.uniform(0.2, 1.2, 32)
    FL2D = RNG.uniform(0.2, 1.2, (4, 32))
    IV = RNG.uniform(0.008, 0.016, 32)
    A = RNG.uniform(0.5, 2.0, 100)

    def test_epgx_spgr(self, monkeypatch):
        kw = dict(backend='cuda', T1a=self.A, T2a=self.A * 0.1, T1b=1.0,
                  T2b=0.02, kab=5.0, kba=20.0)
        for extra in ({'tr': 0.01}, {'tr': 0.01, 'b1': self.A}):
            r = route('epgx_spgr', flips=self.FL, **kw, **extra)
            assert r['path'] == 'cuda-native-adjoint' and r['fused'], extra
            assert 'nTR=32, K=33, nA=100' in r['reason']
        # the canonical exchange-MRF dictionary: no budget gate, the chunk
        # fitted to the scratch (pick_tc 10 at K 48) and capped at the 4
        # states the adjoint's lane route keeps in shared memory
        big = np.zeros(65536)
        r = route('epgx_spgr', backend='cuda', flips=np.zeros(400), T1a=big,
                  T2a=0.08, T1b=1.0, T2b=0.02, kab=big, kba=30.0, tr=0.012,
                  K=48)
        assert r['path'] == 'cuda-native-adjoint' and 'tc=4' in r['reason']
        # a (nTR,) tr train: the variable-TR kernels, the chunk fitted to
        # the scratch (pick_tc 25 at bench_mrf's 65,536 x 400 train, K 24;
        # 32 at 100 atoms) and capped at the lane route's 4 states
        for backend in ('cuda', 'auto'):
            monkeypatch.setattr(routing, '_on_cuda', lambda kw: True)
            r = route('epgx_spgr', flips=self.FL, **dict(kw, backend=backend),
                      tr=self.IV)
            assert r['path'] == 'cuda-native-adjoint' and r['fused']
            assert r['reason'].startswith('xspgr_v_fwd, and xspgr_v_fwd_chk '
                                          '+ xspgr_v_bwd')
            assert 'variable tr' in r['reason'] and 'tc=4' in r['reason']
        r = route('epgx_spgr', backend='cuda', flips=np.zeros(400), T1a=big,
                  T2a=0.08, T1b=1.0, T2b=0.02, kab=big, kba=30.0,
                  tr=np.full(400, 0.012), K=24)
        assert 'nTR=400, K=24, nA=65536, variable tr' in r['reason']
        assert 'tc=4' in r['reason']
        with pytest.raises(ValueError, match='CUDA tensors'):
            tepg.epgx_spgr(torch.as_tensor(self.FL), T1a=1.0, T2a=0.08,
                           T1b=1.0, T2b=0.02, kab=5.0, kba=20.0,
                           tr=torch.as_tensor(self.IV), backend='cuda')
        assert route('epgx_spgr', flips=self.FL, **dict(
            kw, backend='torch'), tr=self.IV)['path'] == 'torch'
        # per-voxel 2-D trains: the plain route under 'auto' on the card,
        # refused under 'cuda'
        with pytest.raises(ValueError, match='per-voxel trains'):
            route('epgx_spgr', flips=self.FL2D, **kw, tr=0.01)
        r = route('epgx_spgr', flips=self.FL2D, **dict(kw, backend='auto'),
                  tr=0.01)
        assert r['path'] == 'torch-fallback' and not r['fused']

    def test_backends(self):
        kw = dict(flips=self.FL, T1a=self.A, T2a=0.08, T1b=1.0, T2b=0.02,
                  kab=5.0, kba=20.0, tr=0.01)
        assert route('epgx_spgr', backend='torch', **kw)['path'] == 'torch'
        assert route('epgx_spgr', **kw)['path'] == 'torch'
        with pytest.raises(ValueError, match='CUDA tensors'):
            tepg.epgx_spgr(torch.as_tensor(self.FL), T1a=1.0, T2a=0.08,
                           T1b=1.0, T2b=0.02, kab=5.0, kba=20.0, tr=0.01,
                           backend='cuda')
        with pytest.raises(NotImplementedError, match='mesh'):
            route('epgx_spgr', mesh=object(), **kw)
        with pytest.raises(NotImplementedError, match='mesh'):
            tepg.epgx_spgr(self.FL, T1a=1.0, T2a=0.08, T1b=1.0, T2b=0.02,
                           kab=5.0, kba=20.0, tr=0.01, mesh=object())

    def test_chunk_and_launch_rules(self):
        r"""The adjoint's chunk at the full-width two-pool dictionary (65,536
        atoms × 400 TRs, K 48, float32) is 10, the single-pool one still 25;
        the state of 32 threads stays in shared memory up to K 151 (float32)
        and 75 (float64)."""
        assert kepg.pick_tc(400, 48, 65536, 4, planes=12) == 10
        assert kepg.pick_tc(400, 48, 65536, 4) == 25
        assert kepg.launch_cfg(48, 4, 12) == (32, True)
        assert kepg.launch_cfg(151, 4, 12) == (32, True)
        assert kepg.launch_cfg(152, 4, 12) == (128, False)
        assert kepg.launch_cfg(75, 8, 12) == (32, True)
        assert kepg.launch_cfg(76, 8, 12) == (128, False)
        # the one-pool and EPG-X(MT) kernels' blocks, beside the adjoints'
        # own chooser (kernels.epg.adjoint_cfg)
        assert kepg.launch_cfg(33, 4) == (128, True)
        assert kepg.launch_cfg(401, 4) == (128, False)
        assert kepg.launch_cfg(48, 4, 8) == (128, True)
