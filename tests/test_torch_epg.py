r"""Parity of the port's single-pool SPGR EPG train
(:func:`mrphy_tpu_torch.ops.epg.epg_spgr`, the plain versions of the
``spgr_fwd``/``spgr_fwd_chk``/``spgr_bwd`` kernels and
:func:`mrphy_tpu_torch.ops.routing.route`) with the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both packages, every
port tensor on the CPU, float64 unless stated. Both of the port's routes
are held to JAX's XLA scan: the plain route (a loop over TRs under torch
autograd) and the kernels' route, whose autograd Function runs the plain
versions of the kernels on CPU tensors (``spgr_fwd_chk`` forward,
``spgr_bwd`` backward). Tolerances: signals at 1e-10 of their largest
value, gradients w.r.t. every differentiable input at 1e-9 of each
gradient's largest value. The kernels' plain versions on their own, and
the routing, are in ``tests/test_torch_epg_kernels.py``.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mrphy_tpu.ops import epg as jepg
from mrphy_tpu_torch.ops import epg as tepg
from mrphy_tpu_torch.ops.routing import route

NA, NTR, K = 5, 12, 8
NAMES = ('flips', 'phis', 'T1', 'T2', 'tr', 'te', 'M0', 'zinit', 'b1', 'D',
         'dk')


def _jax(fn, *args):
    r"""``jax.jit(fn)(*args)`` compiled by XLA at its lowest optimisation
    level: each reference is small and runs once, so compiling it is
    nearly all of its cost."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={'xla_backend_optimization_level': 0})(*args)


def _close(x, ref, rel):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(x), ref, rtol=0,
                               atol=rel * np.abs(ref).max())


def _inputs(seed=0, nA=NA, nTR=NTR):
    rng = np.random.default_rng(seed)
    return dict(
        flips=rng.uniform(0.2, 1.2, nTR), phis=rng.uniform(-3, 3, nTR),
        T1=rng.uniform(0.3, 2.0, nA), T2=rng.uniform(0.02, 0.2, nA),
        trs=rng.uniform(0.008, 0.016, nTR), tes=rng.uniform(0.001, 0.004, nTR),
        M0=rng.uniform(0.8, 1.2, nA), zinit=rng.uniform(-1, 1, nA),
        b1=rng.uniform(0.8, 1.2, nA), D=rng.uniform(1e-5, 3e-5, nA),
        w=rng.standard_normal((nA, nTR, 2)))


# Constant and variable TR/TE, zinit, b1, spoiler diffusion, kshift −1
# and 2, the default K: (id, keywords of epg_spgr beyond flips/phis/T1/T2/
# M0/zinit, kshift, K). JAX compiles every reference of this file in one
# call (_refs).
CASES = [
    ('const_tr_b1_diffusion_kshift-1',
     dict(tr=0.01, te=0.003, b1='b1', D='D', dk=500.0), -1, K),
    ('var_tr_te_b1_diffusion_kshift2_default_K',
     dict(tr='trs', te='tes', b1='b1', D='D', dk=400.0), 2, None),
]
SCALAR = dict(T1=0.8, T2=0.07, tr=0.01, te=0.002, K=K)


def _case(inp, kw):
    base = dict(flips=inp['flips'], phis=inp['phis'], T1=inp['T1'],
                T2=inp['T2'], tr=0.0, te=0.0, M0=inp['M0'],
                zinit=inp['zinit'], b1=None, D=None, dk=0.0)
    base.update({k: (inp[v] if isinstance(v, str) else v)
                 for k, v in kw.items()})
    diff = [n for n in NAMES if base[n] is not None
            and (n != 'dk' or base['D'] is not None)]
    return base, diff


def _spgr_loss(base, diff, w, kshift, Kc):
    def loss(*a):
        d = dict(base, **dict(zip(diff, a)))
        out = jepg.epg_spgr(d['flips'], d['phis'], T1=d['T1'], T2=d['T2'],
                            tr=d['tr'], te=d['te'], M0=d['M0'],
                            zinit=d['zinit'], b1=d['b1'], D=d['D'],
                            dk=d['dk'], kshift=kshift, K=Kc)
        return jnp.sum(jnp.asarray(w) * out), out
    return jax.value_and_grad(loss, argnums=tuple(range(len(diff))),
                              has_aux=True)


def _fl2():
    return np.random.default_rng(2).uniform(0.2, 1.2, (NA, NTR))


def _ir2d_loss(inp):
    r"""A per-voxel 2-D flip train under IR prep, variable TR and
    diffusion: value and gradient w.r.t. the flips and T1 (also through
    the prep)."""
    def loss(fl, T1):
        out = jepg.epg_spgr(fl, inp['phis'], T1=T1, T2=inp['T2'],
                            tr=inp['trs'], te=0.002,
                            zinit=jepg.ir_prep(0.018, T1), D=inp['D'],
                            dk=400.0, K=K)
        return jnp.sum(jnp.asarray(inp['w']) * out), out
    return jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)


@functools.cache
def _refs():
    r"""Every JAX reference of this file, from one compiled call: per case
    ``(signals, gradients)``, the 2-D train's, and the scalar train."""
    inp = _inputs()
    fns, args = [], []
    for _, kw, kshift, Kc in CASES:
        base, diff = _case(inp, kw)
        fns.append(_spgr_loss(base, diff, inp['w'], kshift, Kc))
        args.append([jnp.asarray(base[n], jnp.float64) for n in diff])
    fns.append(_ir2d_loss(inp))
    args.append([jnp.asarray(_fl2()), jnp.asarray(inp['T1'])])

    def every(args, flips, phis):
        return ([f(*a) for f, a in zip(fns, args)],
                jepg.epg_spgr(flips, phis, **SCALAR))

    res, scalar = _jax(every, args, jnp.asarray(inp['flips']),
                       jnp.asarray(inp['phis']))
    out = [(np.asarray(o), [np.asarray(g) for g in gs]) for (_, o), gs in res]
    return dict(cases=out[:-1], ir2d=out[-1], scalar=np.asarray(scalar))


def _torch_kw(d, kshift, K):
    r"""``epg_spgr`` keywords from the case dict ``d`` (numpy arrays as
    CPU tensors)."""
    return {n: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
            for n, v in dict(d, kshift=kshift, K=K).items()}


def _port(route_, base, diff, w, kshift, Kc):
    ta = {n: torch.tensor(np.asarray(base[n], np.float64), requires_grad=True)
          for n in diff}
    kw = _torch_kw(dict(base, **ta), kshift, Kc)
    if route_ == 'plain':
        out = tepg._spgr_scan(**kw)
    else:
        out = tepg._spgr_kernels(**kw)
    grads = torch.autograd.grad((torch.as_tensor(w) * out).sum(),
                                [ta[n] for n in diff])
    return out.detach(), grads


@pytest.mark.parametrize('route_', ['plain', 'kernels'])
@pytest.mark.parametrize('ci', range(len(CASES)), ids=[c[0] for c in CASES])
def test_epg_spgr_vs_jax(ci, route_):
    r"""Signals and the gradients w.r.t. every differentiable input
    against ``jax.value_and_grad`` of JAX's XLA scan, on both routes."""
    _, kw, kshift, Kc = CASES[ci]
    inp = _inputs()
    base, diff = _case(inp, kw)
    out_j, grads_j = _refs()['cases'][ci]
    out, grads = _port(route_, base, diff, inp['w'], kshift, Kc)
    _close(out, out_j, 1e-10)
    for g, gj in zip(grads, grads_j):
        _close(g, gj, 1e-9)


def test_epg_spgr_ir_prep_and_2d_trains_vs_jax():
    r"""A per-voxel 2-D flip train (the plain route under ``'auto'``, as
    JAX's ``'xla-fallback'``; ``'cuda'`` refuses it) under IR prep,
    variable TR and diffusion,
    with the gradients w.r.t. T1 (through the prep) and the flips; and
    scalar tissue, whose train comes back unbatched on both routes (JAX's
    ``_unbatch`` rule, pinned by ``tests/test_epg.py``)."""
    inp = _inputs()
    out_j, (gf_j, gT1_j) = _refs()['ir2d']
    fl, T1 = (torch.tensor(x, requires_grad=True) for x in (_fl2(),
                                                             inp['T1']))
    kw = dict(T1=T1, T2=torch.as_tensor(inp['T2']),
              tr=torch.as_tensor(inp['trs']), te=0.002,
              zinit=tepg.ir_prep(0.018, T1), D=torch.as_tensor(inp['D']),
              dk=400.0, K=K)
    for call in (route, tepg.epg_spgr):
        with pytest.raises(ValueError, match='per-voxel trains'):
            call(*(('epg_spgr',) if call is route else ()), flips=fl,
                 phis=torch.as_tensor(inp['phis']), **kw, backend='cuda')
    out = tepg.epg_spgr(fl, torch.as_tensor(inp['phis']), **kw)
    gf, gT1 = torch.autograd.grad((torch.as_tensor(inp['w']) * out).sum(),
                                  (fl, T1))
    _close(out.detach(), out_j, 1e-10)
    _close(gf, gf_j, 1e-9)
    _close(gT1, gT1_j, 1e-9)

    # scalar tissue: an unbatched (nTR, 2) train on both routes, as JAX's
    ref = _refs()['scalar']
    args = (torch.as_tensor(inp['flips']), torch.as_tensor(inp['phis']))
    for out in (tepg.epg_spgr(*args, **SCALAR),
                tepg._spgr_kernels(*args, **SCALAR)):
        assert out.shape == ref.shape == (NTR, 2)
        _close(out, ref, 1e-10)
