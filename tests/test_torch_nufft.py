r"""Parity of the port's gridding NUFFT (:mod:`mrphy_tpu_torch.ops.nufft`,
``SpinCube.acquire(backend='nufft')`` and the plain versions of the
``nufft_sample``/``nufft_spread``/``nufft_dk`` kernels) with the JAX package
on the CPU.

Inputs are made with numpy from a seed and handed to both packages, every
port tensor on the CPU, float64 unless stated. Tolerances: 1e-12 of the
largest value against JAX's gather route (the same taps and weights; the
grid stage is an FFT here and DFT matrix products there, ~1e-15 apart);
gradients against ``jax.grad`` of the gather route at 1e-9 of each
gradient's largest value; the Toeplitz operator and the Pipe–Menon weights
at 1e-10; the plain planes functions against JAX's Pallas kernels in
interpret mode (float32) at the JAX suite's own bars, 1e-5 for the sample
and spread stages and 1e-4 for the trajectory cotangent. Trajectories are
drawn from a continuous distribution, so no sample sits on a tap edge
(|δ| = W/2), where JAX's autodiff gives NaN.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mrphy_tpu.models import mobjs as jm
from mrphy_tpu.ops import nufft as jnf
from mrphy_tpu.ops import nufft_pallas as jnp3
from mrphy_tpu_torch import interop
from mrphy_tpu_torch.kernels import nufft as knf
from mrphy_tpu_torch.models import mobjs as tm
from mrphy_tpu_torch.ops import nufft as tnf

F64 = jnp.float64


def _t(x):
    return None if x is None else torch.as_tensor(np.asarray(x))


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


def _ktraj(rng, im_size, fov, nT):
    r"""Uniform k within the grid Nyquist box, `(d, nT)`."""
    return np.stack([rng.uniform(-0.95 * n / (2 * f), 0.95 * n / (2 * f),
                                 nT) for n, f in zip(im_size, fov)])


def _plans(im_size, fov, width, **kw):
    return (jnf.nufft_plan(im_size, fov, width=width, dtype=F64,
                           interp='gather', **kw),
            tnf.nufft_plan(im_size, fov, width=width, dtype=torch.float64,
                           device='cpu', **kw))


# the JAX suite's shapes (tests/test_nufft.py CASES): 1-D, anisotropic 2-D
# and anisotropic 3-D, one kernel width each; the 2-D one also with Δf/T2*
# segmentation (the acquire test below segments a 2-D NUFFT too)
CASES = [((32,), (24.0,), 4, False), ((16, 12), (24.0, 18.0), 5, False),
         ((16, 12), (24.0, 18.0), 5, True),
         ((8, 6, 10), (16.0, 12.0, 20.0), 6, False)]


@pytest.mark.parametrize('im_size,fov,width,seg', CASES,
                         ids=[f'{len(c[0])}d_w{c[2]}' + ('_df_t2s' if c[3]
                                                         else '')
                              for c in CASES])
def test_nufft_and_adjoint_vs_jax(im_size, fov, width, seg):
    r"""Forward and adjoint against JAX's gather route, bare and (2-D)
    through Δf/T2* time segmentation (nseg 4); the port's plain route
    chunked the same."""
    rng = np.random.default_rng(7)
    img = rng.standard_normal(im_size + (2,))
    k = _ktraj(rng, im_size, fov, 257)
    y = rng.standard_normal((257, 2))
    jp, tp = _plans(im_size, fov, width)
    kw = {}
    if seg:
        kw = dict(df=rng.uniform(-50, 50, im_size),
                  T2s=rng.uniform(0.01, 0.05, im_size), dt=1e-5, nseg=4)
    maps = {a: kw.pop(a) for a in ('df', 'T2s') if a in kw}

    def ref(img, k, y, maps):
        return (jnf.nufft(jp, img, k, **kw, **maps),
                jnf.nufft_adjoint(jp, y, k, **kw, **maps))

    rs, ra = _jax(ref, *map(jnp.asarray, (img, k, y)),
                  {a: jnp.asarray(v) for a, v in maps.items()})
    kw.update({a: _t(v) for a, v in maps.items()})
    img, k, y = _t(img), _t(k), _t(y)
    out = tnf.nufft(tp, img, k, **kw)
    assert out.shape == rs.shape
    _close(out, rs, 1e-12)
    _close(tnf.nufft(tp, img, k, chunk=50, **kw), rs, 1e-12)
    out = tnf.nufft_adjoint(tp, y, k, **kw)
    assert out.shape == ra.shape
    _close(out, ra, 1e-12)


@pytest.mark.parametrize('seg', [False, True], ids=['bare', 'df_t2s'])
def test_adjoint_identity_and_batch(seg):
    r"""``⟨Ax, y⟩ = ⟨x, Aᴴy⟩`` in the port (2-D, W 4), and a batch of three
    images with their own trajectories equals three single calls."""
    rng = np.random.default_rng(43)
    im_size, fov = (12, 10), (24.0, 20.0)
    tp = _plans(im_size, fov, 4)[1]
    img = _t(rng.standard_normal((3,) + im_size + (2,)))
    k = _t(np.stack([_ktraj(rng, im_size, fov, 100) for _ in range(3)]))
    y = _t(rng.standard_normal((3, 100, 2)))
    kw = {}
    if seg:
        kw = dict(df=_t(rng.uniform(-80, 80, im_size)),
                  T2s=_t(rng.uniform(0.01, 0.05, im_size)), dt=1e-5, nseg=6)
    s = tnf.nufft(tp, img, k, **kw)
    xh = tnf.nufft_adjoint(tp, y, k, **kw)
    lhs, rhs = (s * y).sum(), (img * xh).sum()
    assert abs(float(lhs - rhs)) < 1e-12 * abs(float(lhs))
    for n in range(3):
        torch.testing.assert_close(tnf.nufft(tp, img[n], k[n], **kw), s[n],
                                   rtol=0, atol=1e-13)
        torch.testing.assert_close(tnf.nufft_adjoint(tp, y[n], k[n], **kw),
                                   xh[n], rtol=0, atol=1e-13)


def test_planes_vs_pallas_interpret():
    r"""The plain versions of the three kernels against JAX's Pallas
    kernels (``sample3d``, ``scatter3d``, ``dk3d``, interpret mode,
    float32) on the JAX suite's shape (12, 10, 14), nT 333."""
    rng = np.random.default_rng(61)
    im_size, fov = (12, 10, 14), (18.0, 15.0, 21.0)
    f32 = np.float32
    k = _ktraj(rng, im_size, fov, 333).astype(f32)
    jp = jnf.nufft_plan(im_size, fov, width=4, dtype=jnp.float32,
                        interp='pallas')
    tp = tnf.nufft_plan(im_size, fov, width=4, device='cpu')
    G = jp.grid_size
    br, bi = (rng.standard_normal(G).astype(f32) for _ in range(2))
    s = rng.standard_normal((333, 2)).astype(f32)
    grid = _t(np.stack([br, bi], -1).reshape(1, -1, 2))
    kk, ss = _t(k[None]), _t(s[None])
    refs = _jax(lambda br, bi, k, s: (
        jnp3.sample3d(jp, br, bi, k, interpret=True),
        jnp3.scatter3d(jp, s, k, interpret=True),
        jnp3.dk3d(jp, br, bi, k, s, interpret=True)),
        *map(jnp.asarray, (br, bi, k, s)))
    _close(knf.nufft_sample_torch(grid, kk, tp.geom)[0], refs[0], 1e-5)
    _close(knf.nufft_spread_torch(ss, kk, tp.geom)[0].T, refs[1], 1e-5)
    _close(knf.nufft_dk_torch(grid, kk, ss, tp.geom)[0], refs[2], 1e-4)


def test_gradients_vs_jax():
    r"""∂Σ nufft²/∂(img, ktraj) and ∂Σ (nufft_adjoint − tgt)²/∂(s, ktraj)
    through the port's autograd Functions against ``jax.grad`` of the
    gather route, anisotropic 3-D, W 4 (the gradients through Δf
    segmentation ride the same Functions: ``chip_smoke.py`` phase 15b)."""
    rng = np.random.default_rng(31)
    im_size, fov = (6, 4, 8), (12.0, 8.0, 16.0)
    img = rng.standard_normal(im_size + (2,))
    k = _ktraj(rng, im_size, fov, 97)
    y = rng.standard_normal((97, 2))
    tgt = rng.standard_normal(im_size + (2,))
    jp, tp = _plans(im_size, fov, 4)

    def jfwd(x, kk):
        return jnp.sum(jnf.nufft(jp, x, kk) ** 2)

    def jadj(s, kk):
        return jnp.sum((jnf.nufft_adjoint(jp, s, kk) - tgt) ** 2)

    refs = _jax(lambda x, s, kk: (
        jax.grad(jfwd, argnums=(0, 1))(x, kk),
        jax.grad(jadj, argnums=(0, 1))(s, kk)), *map(jnp.asarray, (img, y, k)))
    for ref, tloss, x in (
            (refs[0], lambda x, kk: (tnf.nufft(tp, x, kk) ** 2).sum(), img),
            (refs[1], lambda s, kk: ((tnf.nufft_adjoint(tp, s, kk) - _t(tgt))
                                     ** 2).sum(), y)):
        xs = (_t(x).requires_grad_(), _t(k).requires_grad_())
        out = torch.autograd.grad(tloss(*xs), xs)
        for g, r in zip(out, ref):
            _close(g, r, 1e-9)


@pytest.mark.parametrize('im_size,fov,weighted', [
    ((12, 10), (24.0, 20.0), True), ((6, 4, 8), (12.0, 8.0, 16.0), False)],
    ids=['2d_weighted', '3d'])
def test_toeplitz_vs_jax(im_size, fov, weighted):
    rng = np.random.default_rng(17)
    img = rng.standard_normal(im_size + (2,))
    k = _ktraj(rng, im_size, fov, 201)
    w = rng.uniform(0.2, 1.0, 201) if weighted else None
    jp, tp = _plans(im_size, fov, 4)

    def ref(k, w, img):
        jt = jnf.toeplitz_kernel(jp, k, weights=w, chunk=64)
        return jt, jnf.toeplitz_apply(jp, jt, img)

    jt, jx = _jax(ref, jnp.asarray(k), None if w is None else jnp.asarray(w),
                  jnp.asarray(img))
    tt = tnf.toeplitz_kernel(tp, _t(k), weights=_t(w), chunk=64)
    _close(tt, jt, 1e-10)
    _close(tnf.toeplitz_apply(tp, tt, _t(img)), jx, 1e-10)


def test_dcf_pipe_menon_vs_jax():
    r"""Pipe–Menon weights (40 iterations) on the radial case of
    tests/test_nufft.py, 48 uniform spokes × 65 samples on a 16² grid,
    against JAX's; normalized, the DC gain is 1."""
    im_size, fov = (16, 16), 24.0
    kmax = im_size[0] / (2 * fov)
    th = np.pi * np.arange(48) / 48
    r = kmax * np.linspace(-1, 1, 65)
    k = np.stack([(np.cos(th)[:, None] * r).reshape(-1),
                  (np.sin(th)[:, None] * r).reshape(-1)])
    jp, tp = _plans(im_size, (fov, fov), 4)
    ref = jnf.dcf_pipe_menon(jp, jnp.asarray(k), iters=40, normalize=False)
    w = tnf.dcf_pipe_menon(tp, _t(k), iters=40, normalize=False)
    _close(w, ref, 1e-10)
    w = tnf.dcf_pipe_menon(tp, _t(k), iters=40)
    ones = torch.zeros(im_size + (2,), dtype=torch.float64)
    ones[..., 0] = 1
    y = tnf.nufft_adjoint(tp, w[:, None] * tnf.nufft(tp, ones, _t(k)), _t(k))
    assert abs(float(y[..., 0].mean()) - 1) < 1e-12


def _cubes(rng, n=12, fov=24.0):
    r"""The 12×12×1 cube of tests/test_nufft.py's acquire test in both
    packages, float64: ``ofst`` on all three axes, random M and Δf."""
    kw = dict(ofst=np.asarray([[1.5, -2.0, 3.0]]))
    fovs = np.asarray([[fov, fov, 1.0]])
    jc = jm.SpinCube((1, n, n, 1), jnp.asarray(fovs, F64),
                     ofst=jnp.asarray(kw['ofst'], F64),
                     T1=jnp.asarray(1.0, F64), T2=jnp.asarray(0.08, F64),
                     dtype=F64)
    tc = tm.SpinCube((1, n, n, 1), fovs, T1=1.0, T2=0.08,
                     dtype=torch.float64, device='cpu', **kw)
    M = rng.standard_normal((1, n * n, 3))
    object.__setattr__(jc._spinarray, 'M_', jnp.asarray(M, F64))
    tc.M_ = _t(M)
    return jc, tc


def test_acquire_nufft_vs_jax_and_exact():
    r"""``SpinCube.acquire(backend='nufft')`` — 3 coils, Δf, T2*, a
    singleton z axis dropped from the plan, ``ofst`` as the exact sample
    phase — against JAX's at 1e-12 (2 time segments: JAX compiles each
    one), and against the port's exact ``acquire`` at the JAX suite's bars
    (1e-3 with 16 segments, 5e-5 bare)."""
    from mrphy_tpu_torch import dt0
    rng = np.random.default_rng(53)
    jc, tc = _cubes(rng)
    nM = jc.nM
    df = rng.uniform(-40, 40, (1, nM))
    T2s = rng.uniform(0.02, 0.06, (1, nM))
    sens = rng.standard_normal((1, nM, 2, 3))
    gr = rng.uniform(-0.4, 0.4, (1, 3, 300))
    gr[:, 2] = 0.0                                 # in-plane readout
    jc.df_, tc.df_ = jnp.asarray(df), _t(df)
    kw = dict(backend='nufft', width=6, nseg=2)
    ref = _jax(lambda g, s, t2: jc.acquire(g, sens_=s, T2s_=t2, dt=dt0,
                                           **kw),
               *map(jnp.asarray, (gr, sens, T2s)))
    out = tc.acquire(_t(gr), sens_=_t(sens), T2s_=_t(T2s), dt=dt0, **kw)
    assert out.shape == (1, 3, 300, 2)
    _close(out, ref, 1e-12)
    out = tc.acquire(_t(gr), sens_=_t(sens), T2s_=_t(T2s), dt=dt0,
                     backend='nufft', width=6, nseg=16)
    s0 = tc.acquire(_t(gr), sens_=_t(sens), T2s_=_t(T2s), dt=dt0)
    assert float((out - s0).norm() / s0.norm()) < 1e-3
    tc.df_ = 0.0                                   # bare: no Δf, no T2*
    out = tc.acquire(_t(gr), sens_=_t(sens), dt=dt0, backend='nufft',
                     width=6)
    s0 = tc.acquire(_t(gr), sens_=_t(sens), dt=dt0)
    assert float((out - s0).norm() / s0.norm()) < 5e-5


def test_plan_from_numpy_and_refusals():
    r"""``interop.nufftplan_from_numpy`` of a JAX plan equals the port's
    own plan; the plan's assertions are JAX's; ``mesh=`` raises."""
    jp = jnf.nufft_plan((16, 12), (24.0, 18.0), width=5, osf=1.5, dtype=F64)
    tp = tnf.nufft_plan((16, 12), (24.0, 18.0), width=5, osf=1.5,
                        dtype=torch.float64, device='cpu')
    d = {a: getattr(jp, a) for a in ('im_size', 'grid_size', 'fov', 'width',
                                     'beta', 'deapod')}
    fp = interop.nufftplan_from_numpy(d, device='cpu')
    assert fp.geom == tp.geom and fp.deapod.dtype == torch.float64
    torch.testing.assert_close(fp.deapod, tp.deapod, rtol=0, atol=1e-15)
    with pytest.raises(AssertionError):
        tnf.nufft_plan((8, 8, 8), (16.0,) * 3, interp='matmul', device='cpu')
    with pytest.raises(AssertionError):
        tnf.nufft_plan((8, 8), (16.0,) * 2, interp='pallas', device='cpu')
    with pytest.raises(AssertionError, match='raise osf'):
        tnf.nufft_plan((8,), (16.0,), osf=1.25, width=6, device='cpu')
    k = torch.zeros((2, 5), dtype=torch.float64)
    with pytest.raises(NotImplementedError, match='mesh'):
        tnf.nufft(tp, torch.zeros((16, 12, 2), dtype=torch.float64), k,
                  mesh=object())


def test_plan_defaults_to_the_card():
    r"""Without ``device=`` the plan goes to the CUDA card, and raises
    where there is none."""
    if torch.cuda.is_available():
        assert tnf.nufft_plan((8, 8), (16.0, 16.0)).deapod.is_cuda
    else:
        with pytest.raises(RuntimeError, match='CUDA'):
            tnf.nufft_plan((8, 8), (16.0, 16.0))
