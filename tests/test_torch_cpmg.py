r"""Parity of the port's CPMG echo train (:func:`mrphy_tpu_torch.ops.epg.
epg_cpmg`, the plain versions of the ``cpmg_fwd``/``cpmg_fwd_chk``/
``cpmg_bwd`` kernels and :func:`mrphy_tpu_torch.ops.routing.route`) with
the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both packages, every
port tensor on the CPU, float64 unless stated. Both of the port's routes
are held to JAX's XLA scan: the plain route (a loop over echoes under torch
autograd) and the kernels' route, whose autograd Function runs the plain
versions of the kernels on CPU tensors (``cpmg_fwd_chk`` forward,
``cpmg_bwd`` backward). Tolerances: echoes at 1e-10 of their largest value,
gradients w.r.t. every differentiable input at 1e-9 of each gradient's
largest value. The written-out chunk adjoint ``cpmg_bwd_torch`` is held to
torch autograd of the plain forward at 1e-9, over several chunks; one
float32 case with every option on to JAX's Pallas kernel in interpret mode
(echoes at the JAX suite's 3e-6, ``tests/test_epg_pallas.py``, gradients
at 2e-5); the routing rows are ``tests/test_routing.py``'s ``epg_cpmg`` row
in the port's path names.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mrphy_tpu.ops import epg as jepg
from mrphy_tpu_torch.kernels import epg as kepg
from mrphy_tpu_torch.ops import epg as tepg
from mrphy_tpu_torch.ops import routing
from mrphy_tpu_torch.ops.routing import route
from test_torch_epg import _close, _jax

NA, NE = 5, 10
NAMES = ('flips', 'T1', 'T2', 'esp', 'M0', 'alpha_ex', 'phi_ex', 'b1', 'D',
         'dk')


def _inputs(seed=0, nA=NA, nE=NE):
    rng = np.random.default_rng(seed)
    return dict(
        flips=rng.uniform(2.0, 3.1, nE), T1=rng.uniform(0.3, 2.0, nA),
        T2=rng.uniform(0.02, 0.2, nA), esps=rng.uniform(0.008, 0.012, nE),
        M0=rng.uniform(0.8, 1.2, nA), alpha_ex=rng.uniform(1.2, 1.7, nA),
        phi_ex=rng.uniform(0.0, 6.0, nA), b1=rng.uniform(0.8, 1.2, nA),
        D=rng.uniform(1e-5, 3e-5, nA), w=rng.standard_normal((nA, nE, 2)))


# (id, keywords of epg_cpmg beyond flips/T1/T2: a string names an input).
# JAX compiles every reference of this file in one call (_refs).
CASES = [
    ('const_esp_b1_diffusion_excitation',
     dict(esp=0.01, M0='M0', alpha_ex='alpha_ex', phi_ex='phi_ex', b1='b1',
          D='D', dk=450.0)),
    ('esp_train_b1_diffusion_excitation',
     dict(esp='esps', M0='M0', alpha_ex='alpha_ex', phi_ex='phi_ex',
          b1='b1', D='D', dk=300.0)),
    ('esp_train', dict(esp='esps')),
]
SCALAR = dict(T1=0.9, T2=0.06, esp=0.011)


def _case(inp, kw):
    base = dict(flips=inp['flips'], T1=inp['T1'], T2=inp['T2'])
    base.update({k: (inp[v] if isinstance(v, str) else v)
                 for k, v in kw.items()})
    return base, [n for n in NAMES if n in base]


def _cpmg_loss(base, diff, w):
    def loss(*a):
        d = dict(base, **dict(zip(diff, a)))
        out = jepg.epg_cpmg(d.pop('flips'), **d)
        return jnp.sum(jnp.asarray(w) * out), out
    return jax.value_and_grad(loss, argnums=tuple(range(len(diff))),
                              has_aux=True)


@functools.cache
def _refs():
    r"""Every JAX reference of this file, from one compiled call: per case
    ``(echoes, gradients)``, the scalar train, the batched one."""
    inp = _inputs()
    fns, args = [], []
    for _, kw in CASES:
        base, diff = _case(inp, kw)
        fns.append(_cpmg_loss(base, diff, inp['w']))
        args.append([jnp.asarray(base[n], jnp.float64) for n in diff])

    def every(args, flips, T1, T2):
        return ([f(*a) for f, a in zip(fns, args)],
                jepg.epg_cpmg(flips, **SCALAR),
                jepg.epg_cpmg(flips, T1=T1, T2=T2, esp=0.012,
                              M0=T1 / 2))

    res, scalar, batched = _jax(every, args, jnp.asarray(inp['flips']),
                                *_batched(inp))
    out = [(np.asarray(o), [np.asarray(g) for g in gs]) for (_, o), gs in res]
    return dict(cases=out, scalar=np.asarray(scalar),
                batched=np.asarray(batched))


def _batched(inp):
    r"""A (2, 3) batch of tissue (from the inputs' first six values)."""
    T1 = np.concatenate([inp['T1'], inp['T1'][:1] * 1.5]).reshape(2, 3)
    T2 = np.concatenate([inp['T2'], inp['T2'][:1] * 0.5]).reshape(2, 3)
    return jnp.asarray(T1), jnp.asarray(T2)


def _port(route_, base, diff, w):
    ta = {n: torch.tensor(np.asarray(base[n], np.float64), requires_grad=True)
          for n in diff}
    kw = {n: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
          for n, v in dict(base, **ta).items()}
    fn = tepg._cpmg_scan if route_ == 'plain' else tepg._cpmg_kernels
    out = fn(kw.pop('flips'), **kw)
    grads = torch.autograd.grad((torch.as_tensor(w) * out).sum(),
                                [ta[n] for n in diff])
    return out.detach(), grads


@pytest.mark.parametrize('route_', ['plain', 'kernels'])
@pytest.mark.parametrize('ci', range(len(CASES)), ids=[c[0] for c in CASES])
def test_epg_cpmg_vs_jax(ci, route_):
    r"""Echoes and the gradients w.r.t. every differentiable input (flips,
    T1, T2, esp, M0, alpha_ex, phi_ex, b1, D, dk) against
    ``jax.value_and_grad`` of JAX's XLA scan, on both routes."""
    _, kw = CASES[ci]
    inp = _inputs()
    base, diff = _case(inp, kw)
    out_j, grads_j = _refs()['cases'][ci]
    out, grads = _port(route_, base, diff, inp['w'])
    _close(out, out_j, 1e-10)
    for g, gj in zip(grads, grads_j):
        _close(g, gj, 1e-9)


def test_epg_cpmg_scalar_and_batched_calls_vs_jax():
    r"""Scalar tissue gives an unbatched ``(nE, 2)`` train and a (2, 3)
    batch a ``(2, 3, nE, 2)`` one, on both routes, as JAX's; the entry
    point takes the plain route on CPU tensors."""
    inp = _inputs()
    fl = torch.as_tensor(inp['flips'])
    for out in (tepg.epg_cpmg(fl, **SCALAR), tepg._cpmg_kernels(fl, **SCALAR)):
        assert out.shape == (NE, 2)
        _close(out, _refs()['scalar'], 1e-10)
    T1, T2 = (torch.tensor(np.asarray(x)) for x in _batched(inp))
    for fn in (tepg.epg_cpmg, tepg._cpmg_kernels):
        out = fn(fl, T1=T1, T2=T2, esp=0.012, M0=T1 / 2)
        assert out.shape == (2, 3, NE, 2)
        _close(out, _refs()['batched'], 1e-10)


@pytest.mark.parametrize('kw,tc', [
    (dict(esp=0.01), 2),
    (dict(esp='esps', b1='b1', D='D', dk=450.0, M0='M0',
          alpha_ex='alpha_ex', phi_ex='phi_ex'), 5),
    (dict(esp=0.012, D='D', dk=300.0), 1)],
    ids=['const_esp_tc2', 'esp_train_every_option_tc5',
         'diffusion_tc1'])
def test_cpmg_bwd_torch_vs_autograd(kw, tc):
    r"""The written-out chunk adjoint against torch autograd of the plain
    forward, over several chunks, on the rows the kernels take."""
    inp = _inputs(3)
    base, _ = _case(inp, kw)
    kwt = {n: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
           for n, v in base.items()}
    coef, par, dq, cdiff, cfg, _ = tepg._cpmg_rows(kwt.pop('flips'), **kwt)
    coef, par, dq = (x.detach().requires_grad_() for x in (coef, par, dq))
    er, ei = kepg.cpmg_fwd_torch(coef, par, dq, cdiff, cfg)
    w = torch.as_tensor(inp['w'])
    gr, gi = w[..., 0].T.contiguous(), w[..., 1].T.contiguous()
    grads = torch.autograd.grad((gr * er + gi * ei).sum(), (coef, par, dq),
                                allow_unused=True)
    er2, ei2, chk = kepg.cpmg_fwd_chk_torch(coef.detach(), par.detach(),
                                            dq.detach(), cdiff, cfg, tc=tc)
    assert chk.shape == (NE // tc, 6, NE + 1, NA)
    assert torch.equal(er2, er.detach()) and torch.equal(ei2, ei.detach())
    dcoef, dpar = kepg.cpmg_bwd_torch(coef.detach(), par.detach(),
                                      dq.detach(), cdiff, cfg, chk, gr, gi,
                                      tc=tc)
    assert dcoef.shape == (cfg.nC, NE) and dpar.shape == (8, NA)
    ddq = grads[2] if grads[2] is not None else torch.zeros_like(dq)
    for x, ref in ((dcoef, grads[0]), (dpar[:7], grads[1]), (dpar[7:], ddq)):
        np.testing.assert_allclose(x, ref, rtol=1e-9,
                                   atol=1e-9 * max(float(ref.abs().max()),
                                                   1e-300))


def test_cpmg_plain_versions_vs_pallas_interpret():
    r"""Float32, one tiny case with every option on (b1, an esp train,
    diffusion, per-voxel excitation and M0), against JAX's Pallas kernels
    in interpret mode: echoes at the JAX suite's 3e-6, the gradients
    (through the in-kernel adjoint ``_cpmg_bwd_kernel``) w.r.t. every
    input at 2e-5 of each one's largest value."""
    from mrphy_tpu.ops import epg_pallas
    nA, nE = 100, 5
    inp = _inputs(4, nA=nA, nE=nE)
    f32 = np.float32
    names = ('flips', 'T1', 'T2', 'esps', 'M0', 'alpha_ex', 'phi_ex', 'b1',
             'D')
    w = inp['w'].astype(f32)

    def jloss(*a):
        d = dict(zip(names, a))
        out = epg_pallas.epg_cpmg_pallas(
            d.pop('flips'), esp=d.pop('esps'), **d, dk=450.0, tile=128,
            interpret=True)
        return jnp.sum(w * out), out

    (_, ref), gref = _jax(jax.value_and_grad(
        jloss, argnums=tuple(range(len(names))), has_aux=True),
        *(jnp.asarray(inp[n], f32) for n in names))
    ta = {n: torch.tensor(inp[n], dtype=torch.float32, requires_grad=True)
          for n in names}
    out = tepg._cpmg_kernels(ta['flips'], esp=ta['esps'], dk=450.0,
                             **{n: ta[n] for n in names[1:] if n != 'esps'})
    grads = torch.autograd.grad((torch.as_tensor(w) * out).sum(),
                                list(ta.values()))
    assert out.dtype == torch.float32 and out.shape == ref.shape
    _close(out.detach(), ref, 3e-6)
    for g, gj in zip(grads, gref):
        _close(g, gj, 2e-5)


@pytest.mark.parametrize('route_', ['plain', 'kernels'])
def test_perfect_180_closed_form(route_):
    r"""All-180° refocusing after a 90° excitation: ``|echo n| =
    M0·exp(−Σ_{m≤n} esp_m/T2)`` exactly, for a constant spacing and an esp
    train."""
    inp = _inputs(5)
    fl = torch.full((NE,), np.pi, dtype=torch.float64)
    fn = tepg._cpmg_scan if route_ == 'plain' else tepg._cpmg_kernels
    T2, M0 = torch.as_tensor(inp['T2']), torch.as_tensor(inp['M0'])
    for esp in (0.01, torch.as_tensor(inp['esps'])):
        out = fn(fl, T1=torch.as_tensor(inp['T1']), T2=T2, esp=esp, M0=M0)
        espn = torch.broadcast_to(torch.as_tensor(esp, dtype=torch.float64),
                                  (NE,))
        ana = M0[:, None] * torch.exp(-torch.cumsum(espn, 0) / T2[:, None])
        _close(torch.linalg.vector_norm(out, dim=-1), ana, 1e-12)


class TestRouting:
    r"""``tests/test_routing.py``'s ``epg_cpmg`` row in the port's path
    names."""

    RNG = np.random.default_rng(0)
    FL = RNG.uniform(0.2, 1.2, 32)
    FL2D = RNG.uniform(0.2, 1.2, (4, 32))
    IV = RNG.uniform(0.008, 0.016, 32)
    A = RNG.uniform(0.5, 2.0, 100)

    def test_epg_cpmg(self, monkeypatch):
        kw = dict(backend='cuda', T1=self.A, T2=self.A)
        # constant and variable spacing, diffusion, b1: all the kernels,
        # forward and adjoint
        for extra in ({'esp': 0.01}, {'esp': self.IV},
                      {'esp': 0.01, 'D': self.A * 1e-3},
                      {'esp': self.IV, 'D': self.A * 1e-3, 'b1': self.A}):
            r = route('epg_cpmg', flips=self.FL, **kw, **extra)
            assert r['path'] == 'cuda-native-adjoint' and r['fused'], extra
            assert 'nE=32, nA=100' in r['reason']
            assert ('variable esp' in r['reason']) == (
                np.ndim(extra['esp']) == 1)
            assert ('diffusion' in r['reason']) == ('D' in extra)
        # per-voxel 2-D trains: the plain route under 'auto' on the card
        # (tensors taken as CUDA ones), refused under 'cuda'
        with pytest.raises(ValueError, match='per-voxel trains'):
            route('epg_cpmg', flips=self.FL2D, **kw, esp=0.01)
        monkeypatch.setattr(routing, '_on_cuda', lambda kw: True)
        r = route('epg_cpmg', flips=self.FL2D, T1=self.A, T2=self.A,
                  esp=0.01)
        assert r['path'] == 'torch-fallback' and not r['fused']
        # 1M voxels x 32 echoes: no budget gate, the chunk shortened
        r = route('epg_cpmg', backend='cuda', flips=np.zeros(32),
                  T1=np.zeros(1 << 20), T2=0.1, esp=0.01)
        assert r['path'] == 'cuda-native-adjoint' and 'tc=2' in r['reason']

    def test_backends(self):
        kw = dict(T1=self.A, T2=self.A, esp=0.01)
        assert route('epg_cpmg', backend='torch', flips=self.FL,
                     **kw)['path'] == 'torch'
        assert route('epg_cpmg', flips=self.FL, **kw)['path'] == 'torch'
        with pytest.raises(ValueError, match='CUDA tensors'):
            tepg.epg_cpmg(torch.as_tensor(self.FL), T1=1.0, T2=0.1,
                          esp=0.01, backend='cuda')
        with pytest.raises(ValueError, match='per-voxel trains'):
            tepg.epg_cpmg(torch.as_tensor(self.FL2D), T1=1.0, T2=0.1,
                          esp=0.01, backend='cuda')
        with pytest.raises(NotImplementedError, match='mesh'):
            route('epg_cpmg', mesh=object(), flips=self.FL, **kw)
        with pytest.raises(NotImplementedError, match='mesh'):
            tepg.epg_cpmg(self.FL, T1=1.0, T2=0.1, esp=0.01, mesh=object())


def test_epg_cpmg_2d_trains_vs_jax():
    r"""A per-voxel 2-D refocusing train (a slice profile's) under
    ``'auto'`` takes the plain route, as JAX's ``'xla-fallback'``: echoes
    and the gradients w.r.t. the flips and T2 against JAX's XLA scan."""
    inp = _inputs(6)
    fl2 = np.random.default_rng(7).uniform(2.0, 3.1, (NA, NE))
    kw = dict(T1=inp['T1'], esp=0.01, D=inp['D'], dk=400.0)

    def loss(fl, T2):
        out = jepg.epg_cpmg(fl, T2=T2, **kw)
        return jnp.sum(jnp.asarray(inp['w']) * out), out

    (_, ref), (gf_j, gT2_j) = _jax(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True), jnp.asarray(fl2),
        jnp.asarray(inp['T2']))
    fl, T2 = (torch.tensor(x, requires_grad=True) for x in (fl2, inp['T2']))
    out = tepg.epg_cpmg(fl, T2=T2, **{k: torch.as_tensor(v) if isinstance(
        v, np.ndarray) else v for k, v in kw.items()})
    gf, gT2 = torch.autograd.grad((torch.as_tensor(inp['w']) * out).sum(),
                                  (fl, T2))
    _close(out.detach(), ref, 1e-10)
    _close(gf, gf_j, 1e-9)
    _close(gT2, gT2_j, 1e-9)
