r"""Parity of the port's receive-array utilities
(:mod:`mrphy_tpu_torch.utils.coils`) and trajectory generators
(:mod:`mrphy_tpu_torch.utils.traj`) with the JAX package on the CPU.

The host-numpy parts (SVD compression, whitening, ESPIRiT, every
trajectory generator) are the same numpy code on both sides: held to
1e-12. The torch parts (``apply_ccmat``, ``adaptive_maps``,
``gfactor_sense``) meet JAX at float64 rounding (1e-12 of the largest
value). Random numbers differ by design (a ``torch.Generator`` against a
``jax.random`` key): ``add_noise``'s coloring is held to JAX on the same
numpy noise, its statistics and the pseudo-replica g-factor by
distribution.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mrphy_tpu.utils import coils as jc
from mrphy_tpu.utils import traj as jt
from mrphy_tpu_torch.utils import coils as tc
from mrphy_tpu_torch.utils import traj as tt


def _close(x, ref, rel=1e-12):
    x = x.numpy() if torch.is_tensor(x) else np.asarray(x)
    ref = np.asarray(ref)
    assert x.shape == ref.shape, (x.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max(initial=0.0)))
    np.testing.assert_allclose(x, ref, rtol=0, atol=rel * scale)



def _jax(fn, *args):
    r"""``jax.jit(fn)(*args)`` compiled by XLA at its lowest optimisation
    level: each reference is small and runs once, so compiling it is
    nearly all of its cost."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={'xla_backend_optimization_level': 0})(*args)

def _psi(rng, nC):
    A = rng.standard_normal((nC, nC)) + 1j * rng.standard_normal((nC, nC))
    P = A @ A.conj().T + nC * np.eye(nC)
    return np.stack([P.real, P.imag], 0)


def test_compress_whiten_and_apply_vs_jax():
    rng = np.random.default_rng(0)
    sens = rng.standard_normal((1, 48, 2, 6))
    W, energy = tc.coil_compress(sens, 4)
    Wj, ej = jc.coil_compress(sens, 4)
    np.testing.assert_array_equal(W, Wj)
    np.testing.assert_array_equal(energy, ej)
    Psi = _psi(rng, 6)
    np.testing.assert_array_equal(tc.noise_whiten_mat(Psi),
                                  jc.noise_whiten_mat(Psi))
    s = rng.standard_normal((2, 6, 30, 2))
    for x, axis in ((sens, -1), (s, 1)):
        _close(tc.apply_ccmat(torch.as_tensor(x), W, axis=axis),
               _jax(lambda v: jc.apply_ccmat(v, W, axis=axis),
                    jnp.asarray(x)))


def test_compression_commutes_with_acquisition():
    from mrphy_tpu_torch.ops import signal as tsig
    rng = np.random.default_rng(1)
    nM, nT, nC = 48, 40, 6
    t = torch.as_tensor
    sens = rng.standard_normal((1, nM, 2, nC))
    M, loc = rng.standard_normal((1, nM, 3)), rng.uniform(-2, 2, (1, nM, 3))
    k = np.cumsum(rng.uniform(-2, 2, (1, 3, nT)), -1) * 4257.6 * 4e-5
    W, _ = tc.coil_compress(sens, 4)
    kw = dict(df=t(rng.uniform(-50, 50, (1, nM))), dt=4e-5)
    a = tc.apply_ccmat(tsig.signal(t(M), t(loc), t(k), sens=t(sens), **kw),
                       W, axis=1)
    b = tsig.signal(t(M), t(loc), t(k), sens=tc.apply_ccmat(t(sens), W),
                    **kw)
    torch.testing.assert_close(a, b, rtol=0, atol=1e-12)


def test_add_noise_coloring_and_statistics(monkeypatch):
    r"""On the same numpy noise the port colors as JAX does; the port's
    own draws have the requested std and, colored, covariance 2·Psi."""
    rng = np.random.default_rng(3)
    nC = 4
    Psi = _psi(rng, nC)
    s = rng.standard_normal((1, nC, 50, 2))
    n = rng.standard_normal(s.shape)
    with monkeypatch.context() as m:
        m.setattr(jax.random, 'normal',
                  lambda key, shape, dtype: jnp.asarray(n, dtype))
        m.setattr(torch, 'randn', lambda shape, generator, dtype, device:
                  torch.as_tensor(n, dtype=dtype, device=device))
        ref = jc.add_noise(jax.random.key(0), jnp.asarray(s), 0.7, Psi=Psi)
        out = tc.add_noise(None, torch.as_tensor(s), 0.7, Psi=Psi)
    _close(out, ref)
    gen = torch.Generator().manual_seed(0)
    z = torch.zeros((1, nC, 100_000, 2), dtype=torch.float64)
    out = tc.add_noise(gen, z, 1.0, Psi=Psi).numpy()
    nc = (out[0, ..., 0] + 1j * out[0, ..., 1]).T        # (nS, nC)
    emp = nc.T @ nc.conj() / nc.shape[0]
    Pc = Psi[0] + 1j * Psi[1]
    np.testing.assert_allclose(emp, 2 * Pc, atol=0.15 * np.abs(Pc).max())
    white = tc.add_noise(gen, torch.zeros(2, 3, 1000, 2), 0.5)
    assert white.dtype == torch.float32
    assert abs(float(white.std()) / 0.5 - 1) < 0.05


def _coil_images(n=16, nc=3, seed=7):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[-1:1:n * 1j, -1:1:n * 1j]
    obj = np.exp(-(x ** 2 + y ** 2) / 0.35) * np.exp(1j * (0.7 * x))
    S = np.stack([np.exp(-((x - 1.2 * np.cos(a)) ** 2
                           + (y - 1.2 * np.sin(a)) ** 2) / 2.0)
                  * np.exp(0.5j * (x * np.sin(a) - y * np.cos(a)))
                  for a in 2 * np.pi * np.arange(nc) / nc])
    imgs = S * obj[None] + 0.003 * (rng.standard_normal(S.shape)
                                    + 1j * rng.standard_normal(S.shape))
    return np.stack([imgs.real, imgs.imag], -1), S


def test_adaptive_and_espirit_maps_vs_jax():
    imgs, S = _coil_images()
    _close(tc.adaptive_maps(torch.as_tensor(imgs), block=5, iters=40),
           _jax(lambda im: jc.adaptive_maps(im, block=5, iters=40),
                jnp.asarray(imgs)))
    ksp = np.fft.fftshift(np.fft.fftn(np.fft.ifftshift(
        imgs[..., 0] + 1j * imgs[..., 1], axes=(1, 2)), axes=(1, 2)),
        axes=(1, 2))[:, 2:14, 2:14]
    calib = np.stack([ksp.real, ksp.imag], -1)
    maps, lam = tc.espirit_maps(calib, (16, 16), kernel=4, crop=0.5)
    mj, lj = jc.espirit_maps(calib, (16, 16), kernel=4, crop=0.5)
    _close(maps, mj)
    _close(lam, lj)


def test_gfactor_sense_vs_jax():
    r"""R = 3 along the second axis, a pixel with no support, maps
    whitened by a coil covariance."""
    rng = np.random.default_rng(3)
    z = rng.standard_normal((6, 6, 4)) + 1j * rng.standard_normal((6, 6, 4))
    z[1, 2] = 0
    maps = np.stack([z.real, z.imag], -2)
    Psi = _psi(rng, 4)
    g = tc.gfactor_sense(torch.as_tensor(maps), 3, axis=1, Psi=Psi)
    _close(g, _jax(lambda m: jc.gfactor_sense(m, 3, axis=1, Psi=Psi),
                   jnp.asarray(maps)))
    assert float(g[1, 2]) == 0.0


def test_gfactor_replica_matches_analytic():
    r"""The pseudo-replica g-factor of an explicit least-squares SENSE
    solve against the analytic map (the JAX suite's check, the port's own
    random numbers)."""
    rng = np.random.default_rng(4)
    L, nC, R = 8, 3, 2
    z = rng.standard_normal((L, nC)) + 1j * rng.standard_normal((L, nC))
    F = np.exp(-2j * np.pi * np.outer(np.arange(L), np.arange(L)) / L)
    A = np.concatenate([F * z[:, c][None, :] for c in range(nC)], 0)
    keep = np.concatenate([c * L + np.arange(0, L, R) for c in range(nC)])
    P_full, P_acc = np.linalg.pinv(A), np.linalg.pinv(A[keep])

    def mk(P, rows=None):
        def recon(noise):
            zn = noise.numpy()
            zc = zn[..., 0] + 1j * zn[..., 1]
            x = P @ (zc if rows is None else zc[rows])
            return np.stack([x.real, x.imag], -1)
        return recon

    g = tc.gfactor_replica(mk(P_acc, keep), mk(P_full), (nC * L, 2), R,
                           n=800, generator=torch.Generator().manual_seed(7),
                           dtype=torch.float64, device='cpu').mean(-1)
    ga = tc.gfactor_sense(torch.as_tensor(np.stack([z.real, z.imag], -2)),
                          R).numpy()
    np.testing.assert_allclose(g, ga, rtol=0.15)
    sd = tc.replica_std(mk(P_full), (nC * L, 2), n=800, device='cpu')
    assert sd.shape == (L, 2) and np.all(sd > 0)


FOV, N, GMAX, SMAX = 24.0, 32, 4.0, 15e3


@pytest.mark.parametrize('gen,kw', [
    ('spiral2d', dict(direction='out')), ('spiral2d', dict(nshots=4)),
    ('epi', dict(nshots=2, flyback=True)), ('epi', {}),
    ('radial', dict(nspokes=9)), ('radial3d', dict(nspokes=7)),
    ('rosette', dict(npetals=4))])
def test_trajectories_vs_jax(gen, kw):
    lim = dict(gmax=GMAX, smax=SMAX)
    gr, k = getattr(tt, gen)(FOV, N, **lim, **kw)
    grj, kj = getattr(jt, gen)(FOV, N, **lim, **kw)
    _close(gr, grj)
    _close(k, kj)
    tt.traj_check(gr, **lim)


def test_lobes_mintime_and_traj_check_vs_jax():
    for area in (1e-4, -5e-4, 0.0):
        _close(tt.trapezoid(area, gmax=GMAX, smax=SMAX),
               jt.trapezoid(area, gmax=GMAX, smax=SMAX))
    _close(tt.rewinder(1.3, smax=SMAX), jt.rewinder(1.3, smax=SMAX))
    th = np.linspace(0, 4 * np.pi, 400)
    path = 0.05 * th * np.stack([np.cos(th), np.sin(th)])
    _close(tt.mintime_gradient(path, gmax=GMAX, smax=SMAX),
           jt.mintime_gradient(path, gmax=GMAX, smax=SMAX))
    bad = np.zeros((1, 3, 10))
    bad[0, 0, 5] = 1.0                            # a slew far past smax
    for check in (tt.traj_check, jt.traj_check):
        with pytest.raises(AssertionError):
            check(bad, gmax=GMAX, smax=SMAX)
        with pytest.raises(AssertionError):
            check(np.full((1, 3, 4), 2 * GMAX), gmax=GMAX, smax=1e12)
