r"""Parity of the port's EPG-X(MT) bound-pool train over a variable-TR train
(:func:`mrphy_tpu_torch.ops.epg.epgx_mt_spgr` and
``kernels.epgx.xmt_spgr`` with a ``(nTR,)`` ``tr``, the per-TR propagator
planes ``ops.epg._mt_step_entries``, the plain versions of the
``xmt_v_fwd``/``xmt_v_fwd_chk``/``xmt_v_bwd`` kernels and
:func:`mrphy_tpu_torch.ops.routing.route`) with the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both packages, every
port tensor on the CPU, float64 unless stated; the inputs, cases' helpers
and JAX loss are ``tests/test_torch_epgx_mt.py``'s (atoms 4 and 5 without
detailed balance). The per-TR planes ``pkt (nTR, 7, nA)`` are held to JAX's
``_mt_step_entries`` at 1e-12, over a train with a repeated interval. The
kernels' route, whose autograd Function runs the plain versions of the
variable-TR kernels on CPU tensors (``xmt_v_fwd_chk`` forward,
``xmt_v_bwd`` backward, the planes' gradients chained to the rates and to
every element of the train by autograd of their construction), is held to
JAX's XLA scan over the same train: signals at 1e-10 of their largest
value, gradients w.r.t. flips, phis, T1a, T2a, T1b, kab, kba, tr, wt, M0a,
M0b and b1 at rtol 1e-9 (and 1e-9 of each one's largest value); and to the
port's plain route at 1e-12. ``xmt_spgr``'s per-atom ``wscale`` over a tr
train meets the plain route's batched ``wt[None]·wscale[:, None]`` at
1e-12, gradients too. The written-out chunk adjoint ``xmt_v_bwd_torch``
(``dcoef``, ``dpk``, ``dpkt``) meets torch autograd of the plain forward at
1e-9 over one, three and all TRs a chunk, with and without b1 and
``wscale``; a constant train meets the scalar-tr kernels' route at 1e-12;
one float32 case meets JAX's Pallas kernels K34–K36 in interpret mode
(outputs at 3e-6, gradients at 2e-5). Every JAX reference is compiled at
XLA's lowest optimisation level by ``test_torch_epgx._jax``.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mrphy_tpu.ops import epg_pallas
from mrphy_tpu.ops import routing as jrouting
from mrphy_tpu_torch.kernels import epgx as kepgx
from mrphy_tpu_torch.ops import epg as tepg
from mrphy_tpu_torch.ops import routing
from mrphy_tpu_torch.ops.routing import route
from test_torch_epg import _close
from test_torch_epgx import _jax, _tt
from test_torch_epgx_mt import (K, MAPS, NA, NTR, _case, _inputs, _mt_loss,
                                _port)

# (id, keywords of epgx_mt_spgr beyond the per-atom maps, kshift, K): a
# shared wt train and a (nTR,) tr train in both. JAX compiles every
# reference of this file but the Pallas one in one call.
CASES = [
    ('b1_truncated_K', dict(wt='wt', tr='trs', b1='b1'), 1, K),
    ('kshift-1_default_K', dict(wt='wt', tr='trs'), -1, None),
]


def _trs(inp):
    r"""The seed's tr train with one interval repeated (TR 7 takes TR 3's)."""
    trs = inp['trs'].copy()
    trs[7] = trs[3]
    return trs


@functools.cache
def _refs():
    r"""Every JAX reference of this file but the Pallas one, from one
    compiled call: per case ``(signals, gradients)``, and the planes of the
    atoms' train."""
    inp = _inputs()
    inp['trs'] = _trs(inp)
    fns, args = [], []
    for _, kw, kshift, Kc in CASES:
        base, diff = _case(inp, kw)
        fns.append(_mt_loss(base, diff, inp['w'], kshift, Kc))
        args.append([jnp.asarray(base[n], jnp.float64) for n in diff])

    def every(args, maps, trs):
        return dict(cases=[f(*a) for f, a in zip(fns, args)],
                    pkt=epg_pallas._mt_step_entries(*maps, trs))

    res = _jax(every, args, [jnp.asarray(inp[n]) for n in MAPS],
               jnp.asarray(inp['trs']))
    return jax.tree_util.tree_map(np.asarray, res)


def test_step_entries_vs_jax():
    r"""The per-TR planes of a tr train with a repeated interval, at atoms
    with and without detailed balance, against JAX's ``_mt_step_entries``
    at 1e-12; the repeated interval's planes are equal."""
    inp = _inputs()
    trs = torch.as_tensor(_trs(inp))
    pkt = tepg._mt_step_entries(*(torch.as_tensor(inp[n]) for n in MAPS),
                                trs)
    assert pkt.shape == (NTR, 7, NA)
    _close(pkt, _refs()['pkt'], 1e-12)
    assert torch.equal(pkt[7], pkt[3])


@pytest.mark.parametrize('ci', range(len(CASES)), ids=[c[0] for c in CASES])
def test_epgx_mt_spgr_tr_train_vs_jax(ci):
    r"""The kernels' route over a tr train: signals and the gradients w.r.t.
    every differentiable input (each element of the tr and wt trains among
    them) against ``jax.value_and_grad`` of JAX's XLA scan, and against the
    port's plain route at 1e-12."""
    _, kw, kshift, Kc = CASES[ci]
    inp = _inputs()
    inp['trs'] = _trs(inp)
    base, diff = _case(inp, kw)
    (_, out_j), grads_j = _refs()['cases'][ci]
    out, grads = _port(tepg._xmt_kernels, base, diff, inp['w'], kshift, Kc)
    assert 'tr' in diff and grads[diff.index('tr')].shape == (NTR,)
    _close(out, out_j, 1e-10)
    for n, g, gj in zip(diff, grads, grads_j):
        assert bool(torch.isfinite(g).all()), n
        np.testing.assert_allclose(g, gj, rtol=1e-9,
                                   atol=1e-9 * float(np.abs(gj).max()),
                                   err_msg=n)
    out_p, grads_p = _port(tepg._xmt_scan, base, diff, inp['w'], kshift, Kc)
    _close(out, out_p, 1e-12)
    for g, gp in zip(grads, grads_p):
        _close(g, gp, 1e-12)


def test_xmt_spgr_wscale_tr_train_is_batched_wt():
    r"""``xmt_spgr(wt, wscale, tr=trs)`` (the variable-TR kernels' plain
    versions) against the plain route's batched ``wt[None]·wscale[:, None]``
    over the same train at 1e-12, signals and the gradients w.r.t. every
    input, ``wt``, ``wscale`` and every element of ``tr`` among them; a tr
    of another length than the flips raises."""
    inp = _inputs(1)
    names = ('flips', 'phis', 'T1a', 'T2a', 'T1b', 'kab', 'kba', 'wt', 'M0a',
             'M0b', 'b1', 'wscale', 'trs')
    w = torch.as_tensor(inp['w'])

    def run(fn):
        ta = {n: torch.tensor(inp[n], requires_grad=True) for n in names}
        kw = dict(ta)
        kw['tr'] = kw.pop('trs')
        if fn is tepg._xmt_scan:
            kw['wt'] = kw['wt'][None] * kw.pop('wscale')[:, None]
        out = fn(**kw, K=K)
        return out.detach(), torch.autograd.grad((w * out).sum(),
                                                 list(ta.values()))

    (out, ga), (out2, gb) = run(kepgx.xmt_spgr), run(tepg._xmt_scan)
    _close(out, out2, 1e-12)
    for n, x, y in zip(names, ga, gb):
        assert x.shape == y.shape, n
        _close(x, y, 1e-12)
    with pytest.raises(ValueError, match=f'a \\({NTR},\\) train'):
        kepgx.xmt_spgr(torch.as_tensor(inp['flips']), T1a=1.0, T2a=0.06,
                       T1b=1.0, kab=2.0, kba=20.0,
                       tr=torch.full((NTR + 1,), 0.03), K=K)


@pytest.mark.parametrize('kshift,tc,b1,wscale', [
    (1, 1, True, True), (-1, 3, False, True), (2, NTR, True, False),
    (1, 4, False, False)],
    ids=['kshift1_tc1_b1_wscale', 'kshift-1_tc3_wscale', 'kshift2_tcnTR_b1',
         'kshift1_tc4'])
def test_xmt_v_bwd_torch_vs_autograd(kshift, tc, b1, wscale):
    r"""The written-out chunk adjoint of the variable-TR train (``dcoef``,
    ``dpk = [dM0a, dM0b, db1, dwscale]`` and every TR's ``dpkt``) against
    torch autograd of the plain forward, on the rows the kernels take, over
    one, three and all TRs a chunk; the checkpointed forward equals the
    plain one bit for bit."""
    inp = _inputs(3)
    kw = _tt({n: inp[n] for n in MAPS})
    coef, (pk, pkt), cfg, _ = tepg._xmt_rows(
        torch.as_tensor(inp['flips']), torch.as_tensor(inp['phis']), **kw,
        tr=torch.as_tensor(inp['trs']), wt=torch.as_tensor(inp['wt']),
        wscale=torch.as_tensor(inp['wscale']) if wscale else None,
        b1=torch.as_tensor(inp['b1']) if b1 else None, kshift=kshift, K=K)
    assert coef.shape == (10, NTR) and pk.shape == (4, NA)
    assert pkt.shape == (NTR, 7, NA)
    coef, pk, pkt = (x.detach().requires_grad_() for x in (coef, pk, pkt))
    g = torch.as_tensor(inp['w'])
    sig = kepgx.xmt_v_fwd_torch(coef, pk, pkt, cfg)
    grads_a = torch.autograd.grad((g * sig).sum(), (coef, pk, pkt))
    coef, pk, pkt = (x.detach() for x in (coef, pk, pkt))
    sig2, chk = kepgx.xmt_v_fwd_chk_torch(coef, pk, pkt, cfg, tc=tc)
    assert chk.shape == (NTR // tc, 8, K, NA)
    assert torch.equal(sig2, sig.detach())
    grads = kepgx.xmt_v_bwd_torch(coef, pk, pkt, cfg, chk, g, tc=tc)
    assert [tuple(x.shape) for x in grads] == [(10, NTR), (4, NA),
                                               (NTR, 7, NA)]
    if b1:
        assert not bool(grads[0][:4].any())
    for x, xa in zip(grads, grads_a):
        np.testing.assert_allclose(x, xa, rtol=1e-9,
                                   atol=1e-9 * float(xa.abs().max()))


def test_constant_train_matches_scalar_tr_route():
    r"""Over a constant tr train the variable-TR kernels' route gives the
    scalar-tr kernels' echoes at 1e-12, their gradients w.r.t. the maps,
    b1, wt and wscale at 1e-12 and, summed over the train, w.r.t. tr."""
    inp = _inputs(6)
    names = ('T1a', 'kab', 'kba', 'M0b', 'b1', 'wt', 'wscale')
    out, grads = [], []
    for tr in (0.03, np.full(NTR, 0.03)):
        ta = {n: torch.tensor(inp[n], requires_grad=True) for n in names}
        ta['tr'] = torch.tensor(tr, dtype=torch.float64, requires_grad=True)
        sig = kepgx.xmt_spgr(torch.as_tensor(inp['flips']),
                             torch.as_tensor(inp['phis']), T2a=0.06,
                             T1b=1.0, **ta, K=K)
        out.append(sig.detach())
        grads.append(torch.autograd.grad((torch.as_tensor(inp['w'])
                                          * sig).sum(), list(ta.values())))
    _close(out[1], out[0], 1e-12)
    for n, g, gv in zip(names + ('tr',), *grads):
        _close(gv.sum() if n == 'tr' else gv, g, 1e-12)


def test_xmt_v_plain_versions_vs_pallas_interpret(monkeypatch):
    r"""Float32, 24 atoms × 16 TRs, K 8, with every option on (rf-spoiled
    phases, a wt train, a tr train, per-atom b1, wscale, M0a and M0b, atoms
    without detailed balance), against JAX's Pallas kernels in interpret
    mode (``_mtv_fwd_chk_kernel`` and ``_mtv_bwd_kernel`` under
    ``jax.value_and_grad``, with autograd of ``_mt_step_entries``; one atom
    tile, one chunk): signals at 3e-6, the gradients w.r.t. every input,
    each element of the tr train among them, at 2e-5 of each one's largest
    value. The Pallas kernels repeat their TR loop's body by hand
    (``_UNROLL``, for Mosaic); interpreted that only multiplies the traced
    program, so it is traced once a TR."""
    monkeypatch.setattr(epg_pallas, '_UNROLL', 1)
    nA, nTR = 24, 16
    inp = _inputs(4, nA=nA, nTR=nTR)
    f32 = np.float32
    names = ('flips', 'phis', 'wt', 'T1a', 'T2a', 'T1b', 'kab', 'kba', 'trs',
             'M0a', 'M0b', 'b1', 'wscale')
    w = inp['w'].astype(f32)

    def jloss(*a):
        d = dict(zip(names, a))
        d['tr'] = d.pop('trs')
        out = epg_pallas.epgx_mt_spgr_pallas(
            d.pop('flips'), d.pop('phis'), **d, K=K, tile=128,
            interpret=True)
        return jnp.sum(w * out), out

    (_, ref), gref = _jax(jax.value_and_grad(
        jloss, argnums=tuple(range(len(names))), has_aux=True),
        *(jnp.asarray(inp[n], f32) for n in names))
    ta = {n: torch.tensor(inp[n], dtype=torch.float32, requires_grad=True)
          for n in names}
    kw = dict(ta)
    kw['tr'] = kw.pop('trs')
    out = kepgx.xmt_spgr(**kw, K=K)
    grads = torch.autograd.grad((torch.as_tensor(w) * out).sum(),
                                list(ta.values()))
    assert out.dtype == torch.float32 and out.shape == ref.shape
    _close(out.detach(), ref, 3e-6)
    for n, g, gj in zip(names, grads, gref):
        assert g.dtype == torch.float32, n
        _close(g, gj, 2e-5)


def test_routing_tr_train(monkeypatch):
    r"""A ``(nTR,)`` tr train takes the variable-TR kernels (``xmt_v_*``)
    under ``'cuda'`` and, on CUDA tensors, ``'auto'``, where JAX's router
    takes its Pallas kernels; with a batched wt beside it the plain route
    under ``'auto'`` and :class:`ValueError` under ``'cuda'``."""
    rng = np.random.default_rng(0)
    fl, trs, A = (rng.uniform(0.2, 1.2, 32), rng.uniform(0.02, 0.04, 32),
                  rng.uniform(0.5, 2.0, 100))
    kw = dict(T1a=A, T2a=A * 0.1, T1b=1.0, kab=5.0, kba=20.0, tr=trs,
              wt=np.zeros(32))
    monkeypatch.setattr(routing, '_on_cuda', lambda kw: True)
    for backend in ('auto', 'cuda'):
        r = route('epgx_mt_spgr', backend=backend, flips=fl, **kw)
        assert r['path'] == 'cuda-native-adjoint' and r['fused']
        assert r['reason'].startswith('xmt_v_fwd, and xmt_v_fwd_chk + '
                                      'xmt_v_bwd')
        assert 'nTR=32, K=33, nA=100, variable tr' in r['reason']
    assert jrouting.route('epgx_mt_spgr', backend='pallas', flips=fl,
                          **kw)['path'] == 'pallas-native-adjoint'
    bw = dict(kw, wt=np.zeros((100, 32)))
    r = route('epgx_mt_spgr', backend='auto', flips=fl, **bw)
    assert r['path'] == 'torch-fallback' and 'wscale' in r['reason']
    with pytest.raises(ValueError, match='wscale'):
        route('epgx_mt_spgr', backend='cuda', flips=fl, **bw)
