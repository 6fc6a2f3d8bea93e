r"""Parity of the port's two-pool EPG-X SPGR train over a variable-TR train
(:func:`mrphy_tpu_torch.ops.epg.epgx_spgr` with a ``(nTR,)`` ``tr``, its
per-step propagator planes and the plain versions of the ``xspgr_v_fwd``/
``xspgr_v_fwd_chk``/``xspgr_v_bwd`` kernels) with the JAX package on the
CPU.

Inputs are made with numpy from a seed and handed to both packages, every
port tensor on the CPU, float64 unless stated; the atoms, cases and JAX
helpers are ``tests/test_torch_epgx.py``'s. The per-step planes ``pkt
(nTR, 14, nA)`` are held to JAX's ``_x_step_entries`` at 1e-12. Both of
the port's routes are held to JAX's XLA scan with the same tr train: the
plain route (a loop over TRs under torch autograd) and the kernels' route,
whose autograd Function runs the plain versions of the variable-TR kernels
on CPU tensors (``xspgr_v_fwd_chk`` forward, ``xspgr_v_bwd`` backward, the
planes' gradients chained to the rates and to every element of the train
by autograd of their construction): signals at 1e-10 of their largest
value, gradients w.r.t. every differentiable input at 1e-9 of each
gradient's largest value. The written-out chunk adjoint
``xspgr_v_bwd_torch`` is held to torch autograd of the plain forward at
1e-9, over several chunks; a constant train to the fixed-TR route at 1e-12;
one float32 case with every option on to JAX's Pallas kernels in
interpret mode (signals at 3e-6, gradients at 2e-5, the bars of
``tests/test_torch_epgx.py``'s fixed-TR case).
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
from test_torch_epgx import (K, MAPS, NA, NTR, _atoms, _case, _inputs, _jax,
                             _port, _tt, _xspgr_loss)

# (id, keywords of epgx_spgr beyond the per-atom maps of _atoms, kshift, K):
# rf-spoiled phases and per-atom dfb, M0a and M0b in both; atoms without
# exchange, on the real axis and without detailed balance among the maps.
CASES = [
    ('rf_spoiled_b1_truncated_K', dict(tr='trs', b1='b1'), 1, K),
    ('kshift-1_default_K', dict(tr='trs'), -1, None),
]


@functools.cache
def _refs():
    r"""Every JAX reference of this file but the Pallas one, from one
    compiled call: per case ``(signals, gradients)``, and the planes of the
    atoms' train."""
    atoms = _atoms()
    fns, args = [], []
    for _, kw, kshift, Kc in CASES:
        base, diff = _case(atoms, kw)
        fns.append(_xspgr_loss(base, diff, atoms['w'], kshift, Kc))
        args.append([jnp.asarray(base[n], jnp.float64) for n in diff])

    def every(args, pars, trs):
        return dict(cases=[f(*a) for f, a in zip(fns, args)],
                    pkt=epg_pallas._x_step_entries(*pars, trs))

    res = _jax(every, args, [jnp.asarray(atoms[n]) for n in MAPS],
               jnp.asarray(atoms['trs']))
    return jax.tree_util.tree_map(np.asarray, res)


def test_step_entries_vs_jax():
    r"""The per-step planes of a tr train at every atom of the cases
    (without exchange, on the real axis, without detailed balance among
    them) against JAX's ``_x_step_entries`` at 1e-12."""
    atoms = _atoms()
    pkt = tepg._x_step_entries(*(torch.as_tensor(atoms[n]) for n in MAPS),
                               torch.as_tensor(atoms['trs']))
    assert pkt.shape == (NTR, 14, len(atoms['T1a']))
    _close(pkt, _refs()['pkt'], 1e-12)


@pytest.mark.parametrize('route_', ['plain', 'kernels'])
@pytest.mark.parametrize('ci', range(len(CASES)), ids=[c[0] for c in CASES])
def test_epgx_spgr_tr_train_vs_jax(ci, route_):
    r"""Signals and the gradients w.r.t. every differentiable input (flips,
    phis, T1a, T2a, T1b, T2b, kab, kba, every element of the tr train, M0a,
    M0b, dfb, b1, per atom) against ``jax.value_and_grad`` of JAX's XLA scan
    over the same train, on both routes; finite on the real axis (dfb = 0)
    and without exchange (kab = kba = 0)."""
    _, kw, kshift, Kc = CASES[ci]
    atoms = _atoms()
    base, diff = _case(atoms, kw)
    (_, out_j), grads_j = _refs()['cases'][ci]
    out, grads = _port(route_, base, diff, atoms['w'], kshift, Kc)
    assert 'tr' in diff and grads[diff.index('tr')].shape == (NTR,)
    _close(out, out_j, 1e-10)
    for n, g, gj in zip(diff, grads, grads_j):
        assert bool(torch.isfinite(g).all()), n
        _close(g, gj, 1e-9)


def _v_rows(seed, kshift, b1, tr=None):
    r"""The variable-TR kernels' arguments ``(coef, pk, pkt, cfg)`` of an
    rf-spoiled train at ``NA`` atoms with per-atom rates, M0a, M0b and dfb
    (and b1), over the seed's tr train or ``tr``."""
    inp = _inputs(seed)
    base, _ = _case(inp, dict(kab='kab', kba='kba', tr='trs', M0a='M0a',
                              M0b='M0b', dfb='dfb',
                              **({'b1': 'b1'} if b1 else {})))
    kw = _tt(base)
    if tr is not None:
        kw['tr'] = tr
    coef, par, cfg, _ = tepg._xspgr_rows(kw.pop('flips'), kw.pop('phis'),
                                         **kw, kshift=kshift, K=K)
    return coef, *par, cfg


@pytest.mark.parametrize('kshift,tc,b1', [(1, 4, True), (-1, 3, False),
                                          (2, 2, True)],
                         ids=['kshift1_tc4_b1', 'kshift-1_tc3',
                              'kshift2_tc2_b1'])
def test_xspgr_v_bwd_torch_vs_autograd(kshift, tc, b1):
    r"""The written-out chunk adjoint of the variable-TR train (``dcoef``,
    ``dpk`` and every step's ``dpkt``) against torch autograd of the plain
    forward, over several chunks; the checkpointing forward's echoes equal
    the plain forward's."""
    coef, pk, pkt, cfg = _v_rows(3, kshift, b1)
    coef, pk, pkt = (x.detach().requires_grad_() for x in (coef, pk, pkt))
    g = torch.as_tensor(_inputs(3)['w'])
    sig = kepgx.xspgr_v_fwd_torch(coef, pk, pkt, cfg)
    grads_a = torch.autograd.grad((g * sig).sum(), (coef, pk, pkt))
    coef, pk, pkt = (x.detach() for x in (coef, pk, pkt))
    sig2, chk = kepgx.xspgr_v_fwd_chk_torch(coef, pk, pkt, cfg, tc=tc)
    assert chk.shape == (NTR // tc, 12, K, NA)
    assert torch.equal(sig2, sig.detach())
    grads = kepgx.xspgr_v_bwd_torch(coef, pk, pkt, cfg, chk, g, tc=tc)
    assert [tuple(x.shape) for x in grads] == [(9, NTR), (3, NA),
                                               (NTR, 14, NA)]
    for x, xa in zip(grads, grads_a):
        np.testing.assert_allclose(x, xa, rtol=1e-9,
                                   atol=1e-9 * float(xa.abs().max()))


def test_constant_train_matches_fixed_tr_route():
    r"""Over a constant tr train the variable-TR kernels' plain versions
    give the fixed-TR ones' echoes at 1e-12, and the kernels' route the
    fixed-TR route's gradients w.r.t. the maps at 1e-12 and, summed over
    the train, w.r.t. tr."""
    inp = _inputs(6)
    names = ('T1a', 'kab', 'kba', 'M0b', 'dfb', 'b1')
    out, grads = [], []
    for tr in (0.012, np.full(NTR, 0.012)):
        ta = {n: torch.tensor(inp[n], requires_grad=True)
              for n in names + ('tr',) if n != 'tr'}
        ta['tr'] = torch.tensor(tr, dtype=torch.float64, requires_grad=True)
        sig = tepg._xspgr_kernels(torch.as_tensor(inp['flips']),
                                  torch.as_tensor(inp['phis']), T2a=0.08,
                                  T1b=1.0, T2b=0.02, **ta, K=K)
        out.append(sig.detach())
        grads.append(torch.autograd.grad((torch.as_tensor(inp['w'])
                                          * sig).sum(), list(ta.values())))
    _close(out[1], out[0], 1e-12)
    for n, g, gv in zip(names + ('tr',), *grads):
        _close(gv.sum() if n == 'tr' else gv, g, 1e-12)


def test_xspgr_v_plain_versions_vs_pallas_interpret():
    r"""Float32, one tiny case with every option on (rf-spoiled phases,
    per-atom b1, dfb, M0a and M0b, no detailed balance, truncated K, a tr
    train), against JAX's Pallas kernels in interpret mode: signals at
    3e-6, the gradients (through the in-kernel adjoint ``_xv_bwd_kernel``
    and autograd of the planes) w.r.t. every input, each element of the tr
    train among them, at 2e-5 of each one's largest value."""
    nA, nTR, Kp = 100, 5, 6
    inp = _inputs(4, nA=nA, nTR=nTR)
    f32 = np.float32
    names = ('flips', 'phis', 'T1a', 'T2a', 'T1b', 'T2b', 'kab', 'kba',
             'trs', 'M0a', 'M0b', 'dfb', 'b1')
    w = inp['w'].astype(f32)

    def jloss(*a):
        d = dict(zip(names, a))
        d['tr'] = d.pop('trs')
        out = epg_pallas.epgx_spgr_pallas(
            d.pop('flips'), d.pop('phis'), **d, K=Kp, tile=128,
            interpret=True)
        return jnp.sum(w * out), out

    (_, ref), gref = _jax(jax.value_and_grad(
        jloss, argnums=tuple(range(len(names))), has_aux=True),
        *(jnp.asarray(inp[n], f32) for n in names))
    ta = {n: torch.tensor(inp[n], dtype=torch.float32, requires_grad=True)
          for n in names}
    kw = dict(ta)
    kw['tr'] = kw.pop('trs')
    out = tepg._xspgr_kernels(kw.pop('flips'), kw.pop('phis'), **kw, K=Kp)
    grads = torch.autograd.grad((torch.as_tensor(w) * out).sum(),
                                list(ta.values()))
    assert out.dtype == torch.float32 and out.shape == ref.shape
    _close(out.detach(), ref, 3e-6)
    for g, gj in zip(grads, gref):
        _close(g, gj, 2e-5)
