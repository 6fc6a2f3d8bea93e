r"""The arithmetic of the float32 route of the k-space signal kernels
``sig_fwd``/``sig_adj`` (``mrphy_tpu_torch/kernels/csrc/sig_mma.cuh``),
emulated on the CPU: the split of each operand into two TF32 parts, the
three-pass product with float32 sums, the magic-number rounding that gives
the half-cycle integer and its parity, and the sin/cos polynomials of the
reduced argument.

The emulation runs on the plain version's factors
(``kernels.signal._factors``): ``cvt.rna.tf32`` is round to nearest, ties
away from zero, to 10 mantissa bits by integer operations on the float32
bit pattern; a pass of k-values sums its exact TF32 products
(float64 here; the tensor cores' own accumulation is not modelled) and is
then added to float32 sums, as the kernel folds each pass. The kernels
themselves run only on the card (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from mrphy_tpu_torch.kernels import signal as ks

# chip_smoke.SIG_BAR[float32]: the bar between two float32 routes of the
# operator on max|Δ| / max|plain|
SIG_BAR = 2e-5
MAGIC = np.float32(1.5 * 2 ** 23)
FAST_LIMIT = float.fromhex('0x1.ffcp20')   # sig_mma.cuh kFastLimit
# sig_mma.cuh sincospi_reduced: sin(πt)/t and cos(πt) in t², highest first
SIN_POLY = [np.float32(float.fromhex(h)) for h in (
    '-0x1.2d9bb6p-1', '0x1.465ec6p+1', '-0x1.4abbbap+2', '0x1.921fb6p+1')]
COS_POLY = [np.float32(float.fromhex(h)) for h in (
    '0x1.d9c364p-3', '-0x1.55c57cp+0', '0x1.03c1dcp+2', '-0x1.3bd3ccp+2',
    '0x1p+0')]


def tf32(x):
    r"""``cvt.rna.tf32.f32``: float32 → float32 with the 13 low mantissa
    bits rounded off, ties away from zero."""
    u = np.asarray(x, dtype=np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(np.asarray(x, np.float32) - hi)


def three_pass(a, b, passes=3, kt=128):
    r"""``a (R, K) @ b (K, N)`` as the kernel forms it: per pass of ``kt``
    k-values (the kernels' 128 up to 32 rows, ``Tiles<RB>::KT``)
    ``Alo·Bhi + Ahi·Blo + Ahi·Bhi`` (``passes`` 1: ``Ahi·Bhi`` alone),
    folded into float32 sums."""
    (ah, al), (bh, bl) = split(a), split(b)
    out = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], kt):
        s = slice(k0, k0 + kt)
        terms = [(ah, bh)] if passes == 1 else [(al, bh), (ah, bl), (ah, bh)]
        acc = sum(x[:, s].astype(np.float64) @ y[s].astype(np.float64)
                  for x, y in terms)
        out = out + acc.astype(np.float32)
    return out


@pytest.fixture(scope='module')
def factors():
    r"""The plain version's float32 factors ``C, S (nM, nT)`` of 4096
    spins × 256 samples with Δf and T2*, and 8 coils' rows."""
    rng = np.random.default_rng(20)
    nM, nT, dt = 4096, 256, 4e-6

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32)

    pos = f32(rng.uniform(-12, 12, (1, 3, nM)))
    k = f32(np.cumsum(rng.uniform(-2, 2, (1, 3, nT)), -1) * 4257.6 * dt)
    df = f32(rng.uniform(-100, 100, (1, nM)))
    it2 = f32(1 / rng.uniform(5e-3, 5e-2, (1, nM)))
    tt = ks._tt(nT, dt, pos)
    C, S = ks._factors(pos, df, it2, k, tt, 0, nM)
    rows = rng.standard_normal((16, nM)).astype(np.float32)
    srows = rng.standard_normal((16, nT)).astype(np.float32)
    return C[0].numpy(), S[0].numpy(), rows, srows


def _err(x, ref):
    return float(np.abs(x - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize('passes,within', [(3, True), (1, False)],
                         ids=['three-pass', 'one-pass'])
def test_split_product_vs_float64(factors, passes, within):
    r"""(a) The three-pass product (U = w2·C, V = w2·S over the spins; XR
    = s2·Cᵀ, XS = s2·Sᵀ over the samples) is within SIG_BAR/4 of the
    float64 product of the same float32 operands; (b) one TF32 pass misses
    SIG_BAR, which is why the kernels take three."""
    C, S, rows, srows = factors
    errs = []
    for F in (C, S):
        errs.append(_err(three_pass(rows, F, passes),
                         rows.astype(np.float64) @ F.astype(np.float64)))
        errs.append(_err(three_pass(srows, F.T, passes),
                         srows.astype(np.float64) @ F.T.astype(np.float64)))
    if within:
        assert max(errs) <= SIG_BAR / 4, errs
    else:
        assert min(errs) > SIG_BAR, errs


def test_identity_rows_return_the_factors(factors):
    r"""(c) Identity signal rows return the float32 factors within
    (2⁻²² + 2⁻²⁴)·|C| elementwise: the split of B and the float32 sum."""
    C, S, _, _ = factors
    eye = np.eye(C.shape[1], dtype=np.float32)
    for F in (C, S):
        out = three_pass(eye, F.T)
        bound = (2.0 ** -22 + 2.0 ** -24) * np.abs(F.T.astype(np.float64))
        assert np.all(np.abs(out.astype(np.float64) - F.T) <= bound)


def test_magic_rounding_gives_round_and_parity():
    r"""(d) ``y = 2φ + 1.5·2²³`` in float32 rounds 2φ as ``torch.round``
    does (ties to even) up to the kernels' guard: ``j = y − 1.5·2²³`` and
    the low bit of y's pattern is j's parity, on φ uniform over the guard's
    range, on every tie 2φ = n + ½ near 0 and near the limit, and on
    quarter-cycle steps."""
    rng = np.random.default_rng(4)
    lim = FAST_LIMIT
    n = np.concatenate([np.arange(-300, 300),
                        np.arange(2 ** 22 - 300, int(2 * lim) - 1),
                        -np.arange(2 ** 22 - 300, int(2 * lim) - 1)])
    phi = np.concatenate([
        rng.uniform(-lim, lim, 200_000), (n + 0.5) / 2, n / 2, n / 4,
        rng.uniform(-2, 2, 10_000), [0.0, -0.0, lim, -lim]]).astype(np.float32)
    assert np.abs(phi).max() <= lim
    y = (phi + phi) + MAGIC                    # float32, as the FMA forms it
    j = y - MAGIC
    parity = y.view(np.uint32) & 1
    t = torch.as_tensor(phi)
    j_ref = torch.round(t + t)
    assert np.array_equal(j, j_ref.numpy())
    assert np.array_equal(parity, torch.remainder(j_ref, 2).numpy()
                          .astype(np.uint32))


def _fma(a, b, c):
    return (np.float64(a) * b + c).astype(np.float32)


def test_reduced_sincospi_polynomials():
    r"""(e) The kernels' sin(πa), cos(πa) on |a| ≤ 1/2 (``sig_mma.cuh``
    ``sincospi_reduced``: a = q/2 + t by the magic number, the float32
    minimax polynomials in t², FMAs emulated by exact float64 products)
    within 8.5e-8 of float64 sin and cos (past |a| = 1/4 each is the other's
    polynomial of t): with the split's 2⁻²²,
    under the 4e-7 bar of ``chip_smoke.phase_sincos_accuracy``."""
    a = np.concatenate([np.linspace(-0.5, 0.5, 400_001),
                        [0.25, -0.25, 0.5, -0.5]]).astype(np.float32)
    q = (_fma(a, 2, MAGIC) - MAGIC).astype(np.float32)
    t = _fma(q, -0.5, a)
    u = (t * t).astype(np.float32)
    ps, pc = SIN_POLY[0], COS_POLY[0]
    for cf in SIN_POLY[1:]:
        ps = _fma(ps, u, cf)
    for cf in COS_POLY[1:]:
        pc = _fma(pc, u, cf)
    s0 = (ps * t).astype(np.float32)
    c0 = pc
    quarter = q != 0
    s = np.where(quarter, c0, s0) * np.where(q < 0, -1, 1)
    c = np.where(quarter, s0, c0) * np.where(q > 0, -1, 1)
    x = np.pi * a.astype(np.float64)
    assert np.abs(s - np.sin(x)).max() <= 8.5e-8
    assert np.abs(c - np.cos(x)).max() <= 8.5e-8


def test_exact_sign_past_the_guard():
    r"""(f) Past the guard, ``rint`` and the 64-bit parity (the kernels'
    exact route, ``factor<kExact=true>``) still give ``torch.round``'s j,
    its parity and r = φ − j/2 bit for bit, on φ from 2²¹ to 2²⁵ cycles
    and every tie between; the magic number does not (2φ + 1.5·2²³ leaves
    the range where float32 keeps the units), which is why the kernels
    check the bound of |φ| before each pass."""
    rng = np.random.default_rng(5)
    n = np.arange(2 ** 22, 2 ** 22 + 2000)
    phi = np.concatenate([
        rng.uniform(2 ** 21, 2 ** 25, 100_000), (n + 0.5) / 2, n / 2,
        [FAST_LIMIT]]).astype(np.float32)
    phi = np.concatenate([phi, -phi])
    j = np.rint(phi + phi)                     # rintf: ties to even
    parity = j.astype(np.int64) & 1
    a = (np.float64(phi) * -2 + j).astype(np.float32)   # the exact FMA
    t = torch.as_tensor(phi)
    j_ref = torch.round(t + t)
    assert np.array_equal(j, j_ref.numpy())
    assert np.array_equal(parity, torch.remainder(j_ref, 2).numpy()
                          .astype(np.int64))
    assert np.array_equal(a, (-2 * (t - 0.5 * j_ref)).numpy())
    y = (phi + phi) + MAGIC
    assert not np.array_equal(y - MAGIC, j)
