r"""Parity of the port's MRF matching (:mod:`mrphy_tpu_torch.ops.mrf`:
compression, dictionary matching, refinement; the plain version of the
``match`` kernel) with the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both packages, every
port tensor on the CPU, float64 unless stated. The dictionary is an
``epg_spgr`` train (its parity is ``tests/test_torch_epg.py``) handed to
both packages as numpy. JAX's references are compiled at XLA's lowest
optimisation level. SVD signs are free, so compression and compressed
matching run on JAX's basis carried across
(``interop.basis_from_numpy``), and the port's own ``svd_basis`` is held
to JAX's by its projector ``B·Bᵀ``, its
compressed rotation ``B·J_c·Bᵀ`` and its spectrum. Tolerances: 1e-12 for
``pair_rotate``, ``compress`` and the matches' scores and ``m0`` (indices
equal), 1e-10 for the basis, rtol 1e-8 for 5 Adam steps of
``match_refine`` against optax's; the plain matched filter against JAX's
Pallas kernel in interpret mode (float32) at the JAX suite's rtol 1e-5.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mrphy_tpu.ops import epg as jepg
from mrphy_tpu.ops import mrf as jmrf
from mrphy_tpu_torch import interop
from mrphy_tpu_torch.kernels import mrf as kmrf
from mrphy_tpu_torch.ops import epg as tepg
from mrphy_tpu_torch.ops import mrf as tmrf

NTR, TR = 24, 0.012


def _t(x):
    return torch.tensor(np.asarray(x))    # a copy: JAX's arrays are read-only


def _jax(fn, *args):
    r"""``jax.jit(fn)(*args)`` compiled by XLA at its lowest optimisation
    level (a jit inside ``fn``, such as ``match_refine``'s, is compiled as
    part of it): each reference is small and runs once, so compiling it is
    nearly all of its cost."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={'xla_backend_optimization_level': 0})(*args)


def _close(x, ref, rel):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(x), ref, rtol=0,
                               atol=rel * np.abs(ref).max())


def _flips():
    t = np.arange(NTR)
    return np.deg2rad(10 + 50 * np.abs(np.sin(np.pi * t / 40)))


@functools.cache
def _dict():
    r"""A pair dictionary on a (T1, T2) grid with T2 < T1, float64, from
    the port's plain ``epg_spgr`` (held to JAX's in
    ``tests/test_torch_epg.py``): ``(D (nA, NTR, 2), T1 (nA,), T2
    (nA,))``."""
    T1g, T2g = np.meshgrid(np.geomspace(0.3, 2.5, 8),
                           np.geomspace(0.03, 0.3, 6), indexing='ij')
    keep = T2g < T1g
    T1a, T2a = T1g[keep], T2g[keep]
    D = tepg.epg_spgr(_t(_flips()), tepg.rf_spoil_phases(
        NTR, dtype=torch.float64), T1=_t(T1a), T2=_t(T2a), tr=TR, te=TR / 2,
        K=8)
    return D.numpy(), T1a, T2a


@functools.cache
def _jax_basis(pair, **kw):
    r"""JAX's ``svd_basis`` of the pair dictionary or of the real one."""
    return jmrf.svd_basis(jnp.asarray(_dict()[0] if pair else _real_case()[0]),
                          **kw)


def _scale_pair(d, c, phi):
    r"""x = c·e^{iφ}·d in re/im pairs (c, φ per probe)."""
    c, phi = np.asarray(c)[:, None], np.asarray(phi)[:, None]
    return np.stack([c * (np.cos(phi) * d[..., 0] - np.sin(phi) * d[..., 1]),
                     c * (np.sin(phi) * d[..., 0] + np.cos(phi) * d[..., 1])],
                    -1)


def _pair_probes(D, n, seed):
    rng = np.random.default_rng(seed)
    ks = rng.integers(0, D.shape[0], n)
    X = _scale_pair(D[ks], rng.uniform(0.5, 2.0, n),
                    rng.uniform(-np.pi, np.pi, n))
    return X + 0.01 * rng.standard_normal(X.shape)


def _real_case():
    rng = np.random.default_rng(2)
    D = rng.standard_normal((37, 50))
    ks = rng.integers(0, 37, 9)
    return D, rng.uniform(0.5, 2.0, (9, 1)) * D[ks] + \
        0.05 * rng.standard_normal((9, 50))


def _result_close(res, ref):
    np.testing.assert_array_equal(res.idx.numpy(), np.asarray(ref.idx))
    assert res.idx.dtype == torch.int32
    _close(res.score, ref.score, 1e-12)
    _close(res.m0, ref.m0, 1e-12)


def test_pair_rotate_and_compress_vs_jax():
    r"""``pair_rotate`` and ``compress`` (dictionary and probes, pair and
    real) on JAX's basis."""
    x = np.random.default_rng(0).standard_normal((5, 7, 2))
    _close(tmrf.pair_rotate(_t(x)), jmrf.pair_rotate(jnp.asarray(x)), 1e-12)
    D, _, _ = _dict()
    X = _pair_probes(D, 6, 1).reshape(2, 3, NTR, 2)
    Dr, Xr = _real_case()
    for d, probes, jb in ((D, X, _jax_basis(True, rank=8)),
                          (Dr, Xr, _jax_basis(False, rank=5))):
        tb = interop.basis_from_numpy(jb, device='cpu')
        assert (tb.jc is None) == (jb.jc is None)
        for v in (d, probes):
            out = tmrf.compress(_t(v), tb)
            ref = jmrf.compress(jnp.asarray(v), jb)
            assert tuple(out.shape) == ref.shape
            _close(out, ref, 1e-12)


@pytest.mark.parametrize('kw', [dict(rank=8), dict(energy=0.9999)],
                         ids=['rank8', 'energy'])
def test_svd_basis_vs_jax(kw):
    r"""The port's basis spans JAX's subspace, with the same compressed
    rotation, spectrum and (energy-chosen) rank. The spectrum is compared
    as the Gram's eigenvalues ``s²``: below the dictionary's numerical rank
    ``s`` is the square root of rounding noise."""
    D, _, _ = _dict()
    jb = _jax_basis(True, **kw)
    tb = tmrf.svd_basis(_t(D), **kw)
    B, Bj = tb.B.numpy(), np.asarray(jb.B)
    assert B.shape == Bj.shape and tb.tail == tuple(jb.tail)
    _close(B @ B.T, Bj @ Bj.T, 1e-10)
    _close(B @ tb.jc.numpy() @ B.T, Bj @ np.asarray(jb.jc) @ Bj.T, 1e-10)
    _close(tb.s ** 2, np.asarray(jb.s) ** 2, 1e-10)
    Dr, _ = _real_case()
    jr, tr_ = _jax_basis(False, rank=5), tmrf.svd_basis(_t(Dr), rank=5)
    assert tr_.jc is None
    _close(tr_.B.numpy() @ tr_.B.numpy().T,
           np.asarray(jr.B) @ np.asarray(jr.B).T, 1e-10)


@pytest.mark.parametrize('pair', [True, False], ids=['pair', 'real'])
def test_dict_match_vs_jax(pair):
    r"""``dict_match`` against JAX's XLA matcher; the port's probe chunks
    do not divide the probe count."""
    if pair:
        D, _, _ = _dict()
        X = _pair_probes(D, 10, 3).reshape(2, 5, NTR, 2)
    else:
        D, X = _real_case()
    ref = _jax(jmrf.dict_match, jnp.asarray(D), jnp.asarray(X))
    res = tmrf.dict_match(_t(D), _t(X), chunk_probes=4)
    assert tuple(res.idx.shape) == ref.idx.shape
    _result_close(res, ref)


def test_dict_match_compressed_vs_jax():
    r"""``dict_match_compressed`` on JAX's basis, with raw and with
    compressed probes."""
    D, _, _ = _dict()
    jb = _jax_basis(True, rank=8)
    tb = interop.basis_from_numpy(jb, device='cpu')
    X = _pair_probes(D, 7, 4)
    ref = _jax(lambda d, x: jmrf.dict_match_compressed(
        jmrf.compress(d, jb), x, jb), jnp.asarray(D), jnp.asarray(X))
    Dc = tmrf.compress(_t(D), tb)
    for probes in (_t(X), tmrf.compress(_t(X), tb)):
        _result_close(tmrf.dict_match_compressed(Dc, probes, tb), ref)


def test_match_refine_vs_optax():
    r"""5 Adam steps through the SPGR train against optax's run: the
    batched mode through the kernels' autograd Function (its plain
    versions here), the per-voxel mode through the plain route."""
    rng = np.random.default_rng(5)
    nV = 3
    fl = _flips()
    T1t, T2t = rng.uniform(0.4, 2.0, nV), rng.uniform(0.04, 0.3, nV)
    X = _scale_pair(np.asarray(tepg.epg_spgr(
        _t(fl), None, T1=_t(T1t), T2=_t(T2t), tr=TR, te=TR / 2, K=8)),
        np.ones(nV), rng.uniform(-3, 3, nV))
    p0 = np.log(np.stack([T1t * rng.uniform(0.8, 1.2, nV),
                          T2t * rng.uniform(0.8, 1.2, nV)], -1))

    def jsig(P):
        return jepg.epg_spgr(jnp.asarray(fl), None, T1=jnp.exp(P[:, 0]),
                             T2=jnp.exp(P[:, 1]), tr=TR, te=TR / 2, K=8)

    pj, sj = _jax(lambda p, x: jmrf.match_refine(jsig, p, x, iters=5,
                                                 lr=0.02, batched=True),
                  jnp.asarray(p0), jnp.asarray(X))

    def sig_b(P):
        return tepg._spgr_kernels(_t(fl), T1=torch.exp(P[:, 0]),
                                  T2=torch.exp(P[:, 1]), tr=TR, te=TR / 2,
                                  K=8)

    def sig_1(p):
        return tepg.epg_spgr(_t(fl), None, T1=torch.exp(p[0]),
                             T2=torch.exp(p[1]), tr=TR, te=TR / 2, K=8)

    for fn, batched in ((sig_b, True), (sig_1, False)):
        p, s = tmrf.match_refine(fn, _t(p0), _t(X), iters=5, lr=0.02,
                                 batched=batched)
        np.testing.assert_allclose(p.numpy(), np.asarray(pj), rtol=1e-8)
        np.testing.assert_allclose(s.numpy(), np.asarray(sj), rtol=1e-8)
    assert not np.allclose(np.asarray(pj), p0)     # the steps moved


def test_match_plain_vs_pallas_interpret():
    r"""The ``match`` kernel's plain version against JAX's fused matcher
    in interpret mode, float32, pair and real atoms, on a ragged number of
    atoms and voxels."""
    from mrphy_tpu.ops import mrf_pallas
    rng = np.random.default_rng(6)
    nA, nV, r = 45, 150, 8
    f32 = np.float32
    D = rng.standard_normal((nA, r)).astype(f32)
    D /= np.linalg.norm(D, axis=1, keepdims=True)
    Dim = rng.standard_normal((nA, r)).astype(f32)
    X = rng.standard_normal((nV, r)).astype(f32)
    for pair in (True, False):
        ij, bj = mrf_pallas.match_core(jnp.asarray(D), jnp.asarray(Dim),
                                       jnp.asarray(X), pairlike=pair,
                                       interpret=True)
        it, bt = kmrf.match_torch(_t(D), _t(Dim) if pair else None, _t(X),
                                  pairlike=pair, chunk=64)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=1e-5)
