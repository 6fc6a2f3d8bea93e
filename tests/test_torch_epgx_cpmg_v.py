r"""Parity of the port's two-pool EPG-X CPMG train over an echo-spacing train
(:func:`mrphy_tpu_torch.ops.epg.epgx_cpmg` with a ``(nE,)`` ``esp``, its
per-echo propagator planes and the plain versions of the ``xcpmg_v_fwd``/
``xcpmg_v_fwd_chk``/``xcpmg_v_bwd`` kernels) with the JAX package on the
CPU.

Inputs are made with numpy from a seed and handed to both packages, every
port tensor on the CPU, float64 unless stated; the inputs, cases and JAX
helpers are ``tests/test_torch_epgx_cpmg.py``'s. Both of the port's routes
are held to JAX's XLA scan over the same esp train: the plain route (a loop
over echoes under torch autograd) and the kernels' route, whose autograd
Function runs the plain versions of the echo-spacing kernels on CPU tensors
(``xcpmg_v_fwd_chk`` forward, ``xcpmg_v_bwd`` backward, the planes'
gradients chained to the rates and to every element of the train by
autograd of their construction): echoes at 1e-10 of their largest value,
gradients w.r.t. all 13 inputs (flips, T1a, T2a, T1b, T2b, kab, kba, every
element of the esp train, M0a, M0b, dfb, phi_ex, b1) at 1e-9 of each
gradient's largest value. The written-out chunk adjoint
``xcpmg_v_bwd_torch`` is held to torch autograd of the plain forward at
1e-9 over one, several and all echoes a chunk, with and without b1; a
constant train to the scalar-esp kernels' plain versions at 1e-12; one
float32 case with every option on to JAX's Pallas kernels in interpret
mode (echoes at 3e-6, gradients at 2e-5, the bars of the scalar-esp case).
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mrphy_tpu.ops import epg_pallas
from mrphy_tpu_torch.kernels import epgx as kepgx
from mrphy_tpu_torch.ops import epg as tepg
from test_torch_epg import _close
from test_torch_epgx import _jax
from test_torch_epgx_cpmg import (MAPS, NAMES, _case, _inputs, _port, _tt,
                                  _xcpmg_loss)

NA, NE = 24, 6
# every option on: per-atom M0a, M0b, dfb, phi_ex and b1 over the esp train
FULL = dict(esp='esps', M0a='M0a', M0b='M0b', dfb='dfb', phi_ex='phi_ex',
            b1='b1')


def _vinputs(seed=0, nA=NA, nE=NE):
    r"""``tests/test_torch_epgx_cpmg.py``'s inputs at ``nA`` atoms: atoms
    4-5 on the real axis (dfb = 0), 6-7 without exchange, the rest random
    (dfb ∈ [−20, 20] Hz); an esp train of 8-18 ms."""
    inp = _inputs(seed, nA=nA, nE=nE)
    rng = np.random.default_rng(seed + 100)
    inp['dfb'][8:] = rng.uniform(-20, 20, nA - 8)
    inp['esps'] = rng.uniform(0.008, 0.018, nE)
    return inp


@functools.cache
def _ref():
    r"""JAX's echoes and gradients w.r.t. every input over the esp train,
    from one compiled call of its XLA scan."""
    inp = _vinputs()
    base, diff = _case(inp, FULL)
    assert diff == list(NAMES)
    (_, out), grads = _jax(_xcpmg_loss(inp['w']),
                           *(jnp.asarray(base[n], jnp.float64)
                             for n in NAMES))
    return jax.tree_util.tree_map(np.asarray, (out, grads))


@pytest.mark.parametrize('route_', ['plain', 'kernels'])
def test_epgx_cpmg_esp_train_vs_jax(route_):
    r"""Echoes and the gradients w.r.t. all 13 inputs, each element of the
    esp train among them, against ``jax.value_and_grad`` of JAX's XLA scan
    over the same train, on both routes."""
    inp = _vinputs()
    base, diff = _case(inp, FULL)
    out_j, grads_j = _ref()
    out, grads = _port(route_, base, diff, inp['w'])
    assert out.shape == (NA, NE, 2)
    assert grads[diff.index('esp')].shape == (NE,)
    _close(out, out_j, 1e-10)
    for n, g, gj in zip(diff, grads, grads_j):
        assert bool(torch.isfinite(g).all()), n
        _close(g, gj, 1e-9)


def _v_rows(seed, b1, nE=12, esp=None):
    r"""The echo-spacing kernels' arguments ``(coef, pk, pkt, cfg)`` at
    ``NA`` atoms with every per-atom map (and b1) over the seed's esp train
    or ``esp``."""
    inp = _vinputs(seed, nE=nE)
    full = dict(FULL) if b1 else {k: v for k, v in FULL.items() if k != 'b1'}
    kw = _tt(_case(inp, full)[0])
    if esp is not None:
        kw['esp'] = esp
    coef, pk, cfg, _ = tepg._xcpmg_rows(kw.pop('flips'), **kw)
    return coef, *pk, cfg


@pytest.mark.parametrize('tc,b1', [(1, True), (3, True), (12, True),
                                   (1, False), (3, False), (12, False)],
                         ids=['tc1_b1', 'tc3_b1', 'tc_nE_b1', 'tc1', 'tc3',
                              'tc_nE'])
def test_xcpmg_v_bwd_torch_vs_autograd(tc, b1):
    r"""The written-out chunk adjoint over an esp train (``dcoef``, ``dpk``
    = the initial state's and b1's, and every echo's ``dpkt``, both halves
    added) against torch autograd of the plain forward, over chunks of one
    echo, three and all twelve, with and without b1; the checkpointing
    forward's echoes equal the plain forward's."""
    nE = 12
    coef, pk, pkt, cfg = _v_rows(3, b1, nE)
    assert cfg == kepgx.XcpmgCfg(K=nE + 1, has_b1=b1)
    assert pk.shape == (5, NA) and pkt.shape == (nE, 14, NA)
    coef, pk, pkt = (x.detach().requires_grad_() for x in (coef, pk, pkt))
    rng = np.random.default_rng(9)
    gr, gi = (torch.as_tensor(rng.standard_normal((nE, NA)))
              for _ in range(2))
    er, ei = kepgx.xcpmg_v_fwd_torch(coef, pk, pkt, cfg)
    grads_a = torch.autograd.grad((gr * er).sum() + (gi * ei).sum(),
                                  (coef, pk, pkt))
    coef, pk, pkt = (x.detach() for x in (coef, pk, pkt))
    er2, ei2, chk = kepgx.xcpmg_v_fwd_chk_torch(coef, pk, pkt, cfg, tc=tc)
    assert chk.shape == (nE // tc, 12, nE + 1, NA)
    assert torch.equal(er2, er.detach()) and torch.equal(ei2, ei.detach())
    grads = kepgx.xcpmg_v_bwd_torch(coef, pk, pkt, cfg, chk, gr, gi, tc=tc)
    assert [tuple(x.shape) for x in grads] == [(5, nE), (5, NA),
                                               (nE, 14, NA)]
    if b1:
        # the angle's gradient goes to the flip row and to db1
        assert not bool(grads[0][:4].any())
    for x, xa in zip(grads, grads_a):
        np.testing.assert_allclose(x, xa, rtol=1e-9,
                                   atol=1e-9 * float(xa.abs().max()))


def test_constant_train_matches_scalar_esp():
    r"""Over a constant esp train the echo-spacing kernels' plain versions
    (through :func:`~mrphy_tpu_torch.ops.epg._xcpmg_kernels`) give the
    scalar-esp ones' echoes at 1e-12, and their gradients w.r.t. every
    other input at 1e-12 and, summed over the train, w.r.t. esp."""
    inp = _vinputs(6)
    base, diff = _case(inp, FULL)
    out, grads = [], []
    for esp in (0.011, np.full(NE, 0.011)):
        o, g = _port('kernels', dict(base, esp=esp), diff, inp['w'])
        out.append(o)
        grads.append(g)
    _close(out[1], out[0], 1e-12)
    for n, g, gv in zip(diff, *grads):
        _close(gv.sum() if n == 'esp' else gv, g, 1e-12)


def test_xcpmg_v_plain_versions_vs_pallas_interpret():
    r"""Float32, 100 atoms × 5 echoes with every option on (per-atom b1,
    dfb, M0a, M0b, phi_ex; an esp train), against JAX's Pallas kernels in
    interpret mode (``_xcpmg_v_kernel``, ``_xcv_fwd_chk_kernel``,
    ``_xcv_bwd_kernel``): echoes at 3e-6, the gradients w.r.t. every input,
    each element of the esp train among them, at 2e-5 of each one's largest
    value."""
    nA, nE = 100, 5
    inp = _vinputs(4, nA=nA, nE=nE)
    f32 = np.float32
    names = ('flips',) + MAPS + ('esps', 'M0a', 'M0b', 'dfb', 'phi_ex', 'b1')
    w = inp['w'].astype(f32)

    def jloss(*a):
        d = dict(zip(names, a))
        d['esp'] = d.pop('esps')
        out = epg_pallas.epgx_cpmg_pallas(d.pop('flips'), **d, tile=128,
                                          interpret=True)
        return jnp.sum(w * out), out

    (_, ref), gref = _jax(jax.value_and_grad(
        jloss, argnums=tuple(range(len(names))), has_aux=True),
        *(jnp.asarray(inp[n], f32) for n in names))
    ta = {n: torch.tensor(inp[n], dtype=torch.float32, requires_grad=True)
          for n in names}
    kw = dict(ta)
    kw['esp'] = kw.pop('esps')
    out = tepg._xcpmg_kernels(kw.pop('flips'), **kw)
    grads = torch.autograd.grad((torch.as_tensor(w) * out).sum(),
                                list(ta.values()))
    assert out.dtype == torch.float32 and out.shape == ref.shape
    _close(out.detach(), ref, 3e-6)
    for g, gj in zip(grads, gref):
        _close(g, gj, 2e-5)


def test_xcpmg_v_wrappers_refuse():
    r"""The echo-spacing kernels' arguments are checked before any launch:
    ``pk``'s five rows, the planes' shape, a chunk that divides the
    train; ``epgx_cpmg`` refuses an esp train of another length."""
    coef, pk, pkt, cfg = _v_rows(5, True, 6)
    with pytest.raises(ValueError, match=r'pk must be \(5, nA\)'):
        kepgx._xcpmg_sizes('xcpmg_v_fwd', coef, pk[:4], cfg, pkt)
    with pytest.raises(ValueError, match='pkt'):
        kepgx._xcpmg_sizes('xcpmg_v_fwd', coef, pk, cfg, pkt[1:])
    with pytest.raises(ValueError, match='must divide'):
        kepgx.xcpmg_v_fwd_chk(coef, pk, pkt, cfg, tc=4)
    inp = _vinputs(5)
    with pytest.raises(ValueError, match=r'esp must be a scalar or a \(6,\)'):
        tepg._xcpmg_rows(torch.as_tensor(inp['flips']),
                         **_tt({n: inp[n] for n in MAPS}),
                         esp=torch.full((5,), 0.01, dtype=torch.float64))
