r"""Parity of the port's k-space acquisition operator
(:mod:`mrphy_tpu_torch.ops.signal`, ``SpinArray``/``SpinCube.acquire``
and the plain versions of the signal kernels) with the JAX package on the
CPU.

Inputs are made with numpy from a seed and handed to both packages, every
port tensor on ``device='cpu'``. Tolerances: 1e-12 of the largest value in
float64 against JAX's XLA route (the same arithmetic; the port forms the
phase in cycles and reduces it by half cycles where JAX multiplies it out
in radians, ~|ψ|·ε apart); gradients against ``jax.grad`` of the XLA route
at 1e-9 of each gradient's largest value; the plain planes functions
against JAX's Pallas kernels in interpret mode (float32) at the JAX suite's
own bars, 2e-5 of the largest value + 1e-6 for ``U``/``V``/``XR``/``XS``
and 2e-4 relative for the phase-chain cotangents: the port takes the
library sin/cos where the TPU kernels take minimax polynomials (~1e-7),
and sums in another order.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mrphy_tpu import dt0 as jdt0
from mrphy_tpu.models import mobjs as jm
from mrphy_tpu.ops import signal as jsig
from mrphy_tpu.ops import signal_pallas as jpl
from mrphy_tpu.utils import g2k as jg2k
from mrphy_tpu_torch.kernels import signal as ks
from mrphy_tpu_torch.models import mobjs as tm
from mrphy_tpu_torch.ops import signal as tsig

DT = 4e-5   # a long dwell, so that 24 samples accrue O(1) rad of phase


def _compile0(fn, *args):
    r"""``jax.jit(fn)`` compiled for ``args``' shapes by XLA at its lowest
    optimisation level: each reference is small and runs once or a few
    times, so compiling it is nearly all of its cost."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={'xla_backend_optimization_level': 0})


def _jax(fn, *args):
    return _compile0(fn, *args)(*args)


def _problem(N=1, nM=12, nT=24, nC=2, seed=0, dtype=np.float64):
    r"""Numpy inputs of the JAX suite's signal problem."""
    rng = np.random.default_rng(seed)
    a = dict(loc=rng.uniform(-2, 2, (N, nM, 3)),
             M=rng.standard_normal((N, nM, 3)),
             gr=rng.uniform(-2, 2, (N, 3, nT)),
             df=rng.uniform(-200, 200, (N, nM)),
             T2s=rng.uniform(5e-4, 5e-3, (N, nM)),
             sens=rng.standard_normal((N, nM, 2, nC)))
    a['k'] = np.asarray(_jax(lambda g: jg2k(g, False, dt=DT),
                             jnp.asarray(a['gr'])))
    return {k: v.astype(dtype) for k, v in a.items()}


def _t(x):
    return None if x is None else torch.as_tensor(np.asarray(x))


def _close(x, ref, rel):
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(np.asarray(x), ref, rtol=0, atol=rel * scale)


# the optional-argument cases: (name, N, broadcast the leading one, keys):
# the defaults (one uniform coil, no Δf, no decay); a batch with all of
# sens/Δf/T2s, Δf by its alias; N = 2 with every input but M broadcast
CASES = [('defaults', 1, False, ()),
         ('batched', 3, False, ('sens', 'Δf', 'T2s')),
         ('broadcast', 2, True, ('sens', 'df', 'T2s'))]


@pytest.mark.parametrize('name,N,bcast,keys', CASES,
                         ids=[c[0] for c in CASES])
def test_signal_and_adjoint_vs_jax(name, N, bcast, keys):
    a = _problem(N=N, nC=1 if name == 'defaults' else 2, seed=len(name))
    lead = (lambda x: x[:1]) if bcast else (lambda x: x)
    kw = {k: lead(a['df' if k == 'Δf' else k]) for k in keys}
    pos = (lead(a['loc']), lead(a['k']))
    names = tuple(kw)
    jkw = [jnp.asarray(kw[k]) for k in names]
    ref = _jax(lambda M, loc, k, *v: jsig.signal(
        M, loc, k, dt=DT, **dict(zip(names, v))), jnp.asarray(a['M']),
        *map(jnp.asarray, pos), *jkw)
    out = tsig.signal(_t(a['M']), *map(_t, pos), dt=DT,
                      **{k: _t(v) for k, v in kw.items()})
    assert out.shape == ref.shape
    _close(out, ref, 1e-12)
    s = np.random.default_rng(9).standard_normal(ref.shape)
    ref = _jax(lambda s, loc, k, *v: jsig.signal_adjoint(
        s, loc, k, dt=DT, **dict(zip(names, v))), jnp.asarray(s),
        *map(jnp.asarray, pos), *jkw)
    out = tsig.signal_adjoint(_t(s), *map(_t, pos), dt=DT,
                              **{k: _t(v) for k, v in kw.items()})
    assert out.shape == ref.shape
    _close(out, ref, 1e-12)


def test_chunking_and_dot_product_identity():
    r"""Chunk sizes (one spin, non-dividing, more than nM; the default is
    nM) give the same signal and back-projection, and ``<A m, s> = <m, Aᴴ
    s>``."""
    a = _problem(N=2, nM=13, nC=3, seed=4)
    args = (_t(a['loc']), _t(a['k']))
    kw = dict(sens=_t(a['sens']), df=_t(a['df']), T2s=_t(a['T2s']), dt=DT)
    M = _t(a['M'])
    s = tsig.signal(M, *args, **kw)
    ct = torch.as_tensor(np.random.default_rng(6).standard_normal(s.shape))
    m = tsig.signal_adjoint(ct, *args, **kw)
    for chunk in (1, 5, 64):
        torch.testing.assert_close(tsig.signal(M, *args, chunk=chunk, **kw),
                                   s, rtol=0, atol=1e-13)
        torch.testing.assert_close(tsig.signal_adjoint(
            ct, *args, chunk=chunk, **kw), m, rtol=0, atol=1e-13)
    lhs, rhs = float((s * ct).sum()), float((M[..., :2] * m).sum())
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)


def test_gradients_vs_jax():
    r"""Every gradient of ``Σ W·signal`` — w.r.t. ``M``, ``loc_``,
    ``ktraj``, ``sens``, ``df``, ``T2s`` — against ``jax.grad`` of the XLA
    route; Mz's is exactly 0."""
    a = _problem(N=2, nM=12, nT=24, nC=2, seed=7)
    W = np.random.default_rng(8).standard_normal((2, 2, 24, 2))
    names = ('M', 'loc', 'k', 'sens', 'df', 'T2s')

    def jloss(M, loc, k, sens, df, T2s):
        return jnp.sum(jnp.asarray(W) * jsig.signal(
            M, loc, k, sens=sens, df=df, T2s=T2s, dt=DT))

    ref = _jax(jax.grad(jloss, argnums=tuple(range(6))),
               *(jnp.asarray(a[n]) for n in names))
    xs = [_t(a[n]).requires_grad_() for n in names]
    s = tsig.signal(xs[0], xs[1], xs[2], sens=xs[3], df=xs[4], T2s=xs[5],
                    dt=DT)
    out = torch.autograd.grad((_t(W) * s).sum(), xs)
    for n, g, r in zip(names, out, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=1e-9 * np.abs(r).max(), err_msg=n)
    assert float(out[0][..., 2].abs().max()) == 0.0


def test_backward_saves_inputs_only():
    r"""The gradient keeps O(inputs) for the backward (the VJP planes
    function recomputes the factors), not the O(nM·nT) factor matrices
    that autograd through the chunk loop would keep."""
    nM, nT = 300, 2000
    a = _problem(nM=nM, nT=nT, nC=2, seed=3)
    n_in = sum(a[n].size for n in ('M', 'loc', 'k', 'sens', 'df', 'T2s'))
    count = [0]

    def pack(x):
        count[0] += x.numel()
        return x

    xs = [_t(a[n]).requires_grad_() for n in ('M', 'loc', 'k')]
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        tsig.signal(*xs, sens=_t(a['sens']), df=_t(a['df']),
                    T2s=_t(a['T2s']), dt=DT)
    assert 0 < count[0] <= 2 * n_in and count[0] < nM * nT / 50, count[0]


def test_planes_vs_pallas_interpret():
    r"""The three plain planes functions against the TPU kernels
    (``signal_*_planes``, Pallas interpret mode), float32, one batch."""
    a = _problem(nM=72, nT=97, nC=3, seed=20, dtype=np.float32)
    nC = 3
    w = a['M'][0, :, 0][None] * a['sens'][0, :, 0].T      # any (nC, nM)
    w2 = np.concatenate([w, a['sens'][0, :, 1].T], 0)
    g2 = np.random.default_rng(1).standard_normal(
        (2 * nC, 97)).astype(np.float32)
    loc, k, df, T2s = a['loc'][0], a['k'][0], a['df'][0], a['T2s'][0]
    jargs = tuple(jnp.asarray(x) for x in (loc, k, df, T2s))
    planes = (_t(loc.T[None].copy()), _t(df[None]), _t(1 / T2s[None]),
              _t(k[None]))

    def tol(ref, scale):
        return 2e-5 * scale + 1e-6

    U, V = _jax(lambda *xs: jpl.signal_fwd_planes(*xs, DT, interpret=True),
                jnp.asarray(w2), *jargs)
    tU, tV = ks.sig_fwd_torch(_t(w2[None]), *planes, DT)
    for x, r in ((tU[0], U), (tV[0], V)):
        r = np.asarray(r)
        np.testing.assert_allclose(x.numpy(), r, rtol=0,
                                   atol=tol(r, np.abs(r).max()))
    XR, XS = _jax(lambda *xs: jpl.signal_adj_planes(*xs, DT,
                                                    interpret=True),
                  jnp.asarray(g2), *jargs)
    tXR, tXS = ks.sig_adj_torch(_t(g2[None]), *planes, DT)
    for x, r in ((tXR[0].T, XR), (tXS[0].T, XS)):
        r = np.asarray(r)
        np.testing.assert_allclose(x.numpy(), r, rtol=0,
                                   atol=tol(r, np.abs(r).max()))
    ref = _jax(lambda *xs: jpl.signal_vjp_planes(*xs, DT, interpret=True),
               jnp.asarray(g2), jnp.asarray(w2), *jargs)
    out = ks.sig_vjp_torch(_t(g2[None]), _t(w2[None]), *planes, DT)
    out = (out[0][0].T, out[1][0].T, out[2][0].T, out[3][0], out[4][0],
           out[5][0])
    for i, (name, x, r) in enumerate(zip(
            ('XR', 'XS', 'dloc', 'dk', 'ddf', 'di2'), out, ref)):
        r = np.asarray(r)
        if i < 2:
            np.testing.assert_allclose(x.numpy(), r, rtol=0,
                                       atol=tol(r, np.abs(r).max()))
        else:
            rel = np.abs(x.numpy() - r).max() / np.abs(r).max()
            assert rel < 2e-4, (name, rel)


def _cube(seed=5):
    r"""A small masked cube in both packages, float64, with a transverse
    magnetization to read."""
    rng = np.random.default_rng(seed)
    mask = rng.random((1, 6, 5, 4)) < 0.7
    kw = dict(mask=mask, ofst=np.asarray([[0.3, -0.2, 0.5]]))
    fov = np.asarray([[12., 10., 8.]])
    jc = jm.SpinCube((1, 6, 5, 4), jnp.asarray(fov), dtype=jnp.float64,
                     **{k: jnp.asarray(v) if k == 'ofst' else v
                        for k, v in kw.items()})
    tc = tm.SpinCube((1, 6, 5, 4), fov, dtype=torch.float64, device='cpu',
                     **kw)
    M_ = rng.standard_normal((1, jc.nM, 3))
    df_ = rng.uniform(-50, 50, (1, jc.nM))
    jc.M_, jc.df_ = jnp.asarray(M_), jnp.asarray(df_)
    tc.M_, tc.df_ = _t(M_), _t(df_)
    return jc, tc, rng


def test_acquire_vs_jax():
    jc, tc, rng = _cube()
    gr = rng.uniform(-1, 1, (1, 3, 40))
    sens = rng.standard_normal((1, jc.nM, 2, 3))
    T2s = rng.uniform(5e-3, 5e-2, (1, jc.nM))
    ref = _jax(lambda gr, sens, T2s: jc.acquire(gr, sens_=sens, T2s_=T2s,
                                                dt=DT),
               *map(jnp.asarray, (gr, sens, T2s)))
    out = tc.acquire(_t(gr), sens_=_t(sens), T2s_=_t(T2s), dt=DT)
    _close(out, ref, 1e-12)
    # the array's own entry, at given locations and off-resonance
    ref = _jax(lambda gr, loc, df, sens, T2s: jc.spinarray.acquire(
        gr, loc_=loc, df_=df, sens_=sens, T2s_=T2s, dt=DT),
        jnp.asarray(gr), jc.loc_, jc.df_, jnp.asarray(sens),
        jnp.asarray(T2s))
    out = tc.spinarray.acquire(_t(gr), loc_=tc.loc_, Δf_=tc.df_,
                               sens_=_t(sens), T2s_=_t(T2s), dt=DT)
    _close(out, ref, 1e-12)
    with pytest.raises(AssertionError, match='full-grid'):
        tc.acquire(_t(gr), backend='nufft')      # the NUFFT needs a full mask
    with pytest.raises(NotImplementedError, match='mesh'):
        tc.acquire(_t(gr), mesh=object())
    with pytest.raises(NotImplementedError, match='mesh'):
        tsig.signal_adjoint(out, tc.loc_, _t(gr), mesh=object())


def _cg(A, AH, s, iters, vdot):
    r"""CG on the normal equations ``AᴴA x = Aᴴ s`` from 0 (the loop of
    ``benchmarks/suite.py`` ``bench_recon``)."""
    b = AH(s)
    x, r = 0 * b, b
    p, rs = r, vdot(r, r)
    for _ in range(iters):
        Ap = AH(A(p))
        al = rs / vdot(p, Ap)
        x, r = x + al * p, r - al * Ap
        rs2 = vdot(r, r)
        p, rs = r + (rs2 / rs) * p, rs2
    return x


def test_cg_sense_vs_jax():
    r"""CG-SENSE through ``signal``/``signal_adjoint``: a 16×16 grid, 4
    coils, a spiral-out readout with an off-resonance map, 10 iterations,
    float64 — the image against the same loop in JAX at 1e-9."""
    from mrphy_tpu_torch.utils import spiral2d
    rng = np.random.default_rng(11)
    n, nc, fov = 16, 4, 24.0
    ax = (np.arange(n) - n // 2) / n * fov
    yy, xx = np.meshgrid(ax, ax, indexing='ij')
    loc = np.stack([xx, yy, 0 * xx], -1).reshape(1, n * n, 3)
    sens = rng.standard_normal((1, n * n, 2, nc))
    df = (20 * xx / fov).reshape(1, n * n)
    x_true = rng.standard_normal((n * n, 2))
    gr, _ = spiral2d(fov, 23, direction='out')
    k = np.cumsum(gr, axis=2) * 4257.6 * jdt0
    z = np.zeros((n * n, 1))

    def ops(lib, sig, T):
        def A(x):
            return sig.signal(lib.concatenate([x, T(z)], -1)[None], T(loc),
                              T(k), sens=T(sens), df=T(df))

        def AH(s):
            return sig.signal_adjoint(s, T(loc), T(k), sens=T(sens),
                                      df=T(df))[0]
        return A, AH

    A, AH = ops(jnp, jsig, jnp.asarray)
    A = _compile0(A, jnp.asarray(x_true))
    s0 = A(jnp.asarray(x_true))
    AH = _compile0(AH, s0)
    ref = _cg(A, AH, s0, 10, jnp.vdot)
    A, AH = ops(torch, tsig, _t)
    out = _cg(A, AH, A(_t(x_true)), 10,
              lambda a, b: (a * b).sum())
    _close(out, ref, 1e-9)
