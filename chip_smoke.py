#!/usr/bin/env python3
r"""Drive the PyTorch/CUDA port (``mrphy_tpu_torch``) once on one NVIDIA GPU.

Usage: ``python3 chip_smoke.py`` from the root of a checkout (one card).

Phases, each of which raises on failure (no fallback, nothing caught):

1. The card and toolchain (``nvidia-smi`` name and power limit, torch and
   CUDA versions, ``nvcc``), then the kernel build from the checkout's
   ``mrphy_tpu_torch/kernels/csrc`` sources (one ``nvcc`` per source, all
   at once; registers and spills of the adjoint kernels printed).
2. ``rfgr_fwd`` against its plain PyTorch version on the card, on the
   arguments ``sims.blochsim_rfgr`` gives it: 1,048,576 spins × 1000 steps
   with relaxation, Δf and single-coil B1 in float32; a 2-coil B1 case, a
   flow (``vel``) case and a 16-coil B1 case at 65,536 spins; the float64
   instance at 262,144 spins. Max |Δ| of the final state and of all chunk-end states, and the
   times of both (CUDA events, one warm-up, median of 5).
3. ``beff_fwd`` against its plain version on a 64³ cube (262,144 spins) ×
   1000 steps: float32, bfloat16-stored Beff (both sides fed the same
   bf16 values) and float64.
5. ``rfgr_bwd`` against its plain version on the cases of phase 2 and
   on the planes of the full-width design (phase 8b: 64³ × 1000, float32,
   no B1, the rf rows built from γ2πdt·∂L/∂b), fed the same chunk ends
   and a cotangent drawn from a seed: per-spin outputs at ``BAR``,
   waveform rows (sums over spins, in another order) at ``ROW_BAR`` of
   their largest value; times of both on the timed cases. Then forward + adjoint through the public entry
   (``torch.autograd.grad`` of Σ Mo² w.r.t. rf and gr through
   ``sims.blochsim_rfgr``) at 1M spins × 1000 steps in float32: the rate
   in spin-steps per second.
6. ``beff_bwd`` against its plain version on the phase-3 cases: ``dmi`` at
   ``BAR``, ``dbeff`` at ``BAR`` (one bf16 rounding of its largest value
   when Beff is bf16); times of both.
4. The forward path through the user's entry points:
   ``Examples.spincube()``
   ``.to(device='cuda').applypulse(Examples.pulse(), doEmbed=True)``
   against the JAX package's results (literals below: float64 at 1e-10,
   float32 within the cross-engine bound of :func:`route_bar`), then a 64³
   ``SpinCube`` (FOV 24 cm, Δf map, T1/T2) with a 1000-step pulse through
   ``doFuse=True`` (``rfgr_fwd``) and ``doFuse=False`` (``rfgr2beff`` →
   ``beff_fwd``), which must agree (float64 at 1e-10, float32 within
   :func:`route_bar`).
7. Gradients through the entry points: on the 64³ cube × 1000 steps, the
   gradient of Σ W·M w.r.t. rf and gr through ``applypulse(doFuse=True)``
   (``rfgr_fwd`` + ``rfgr_bwd``) and ``doFuse=False`` (``rfgr2beff`` →
   ``beff_fwd`` + ``beff_bwd``) must agree (float64 at 1e-9 of the
   largest gradient, float32 within :func:`route_bar` of it); the
   ``Examples`` gradient in float64 against a JAX literal at 1e-9 of the
   largest gradient.
8. Design: (a) ``design_pulse`` with Adam on the ``Examples`` problem,
   10 losses against the JAX package's (float64 at rtol 1e-8, float32
   within :func:`loss_bar`), and at the slew limit 5e6 the first loss and
   the gradient of every design variable (``design_step``) against JAX's
   in float64 at 1e-9; (b) ``design_multiscale`` on the 3-D
   tailored-excitation problem at full width (64³ cube, FOV 24 cm, a
   6 cm ball flipped to [0, 1, 0], 1000 steps, dwell 8 µs then 4 µs,
   10 + 20 Adam iterations, float32): finite losses, progress in the
   fine stage, the RF and slew limits, one ``rfgr_fwd`` and one
   ``rfgr_bwd`` launch per iteration at least, and seconds per iteration
   at 500 and at 1000 steps.

Launch counts are zeroed right before the forward path (phase 4) and read
after it (``rfgr_fwd``, ``beff_fwd`` must have launched), and zeroed again
before the gradient and design path (phases 7–8) and read after it (all
four kernels must have launched). The comparisons with the plain versions
(phases 2, 3, 5, 6) run before and are not counted.

The line before the last is one JSON object with each kernel's launches
on those paths, error and times; the last line is the contract line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import functools
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# Bars on max |kernel − plain| on the same inputs: ~1000 steps of 1-ulp
# differences in float32; float64 rounding over the same steps. (The
# kernels are built without FMA contraction and follow the plain version's
# order of operations, so on the card they agree bit for bit.)
BAR = {torch.float32: 5e-5, torch.float64: 1e-10}
# The adjoints' waveform rows are sums over spins that the kernel takes in
# another order than torch.sum: max|Δ| / max|row|. 2e-3 in float32 is the
# bar tests/test_pallas.py sets between two float32 reductions.
ROW_BAR = {torch.float32: 2e-3, torch.float64: 1e-10}
EPS32 = 2.0 ** -23


def route_bar(nT: int, phi_max: float) -> float:
    r"""Bar between two float32 runs that round the field differently
    (JAX vs this port; the fused engine's pre-scaled γ2πdt·loc vs
    ``rfgr2beff``'s Gauss): a fixed relative rounding of a spin's field
    is a coherent phase error of up to nT·φmax·ε per run."""
    return 2 * nT * phi_max * EPS32


def loss_bar(nT: int, phi_max: float) -> float:
    r"""Absolute bar between two float32 design runs' losses. The loss is
    a mean over spins of |M − Mtgt|² with |M − Mtgt| ≤ 2, so a change δM
    of each component moves it by at most 2·2·√3·|δM|; δM is the
    coherent rounding bound of :func:`route_bar`."""
    return 4 * 3 ** 0.5 * route_bar(nT, phi_max)


# mrphy_tpu (JAX, XLA engine on the CPU):
# Examples.spincube(dtype).applypulse(Examples.pulse(dtype)), the 15
# compact spins, in float32 and in float64.
GOLDEN_EXAMPLES_F32 = [
    [0.012481569312512875, 0.9274728298187256, 0.29617491364479065],
    [-0.6770499348640442, 0.6733916997909546, -0.1432766169309616],
    [0.48316481709480286, 0.45116978883743286, -0.7033340930938721],
    [0.012481569312512875, 0.9274728298187256, 0.29617491364479065],
    [-0.6770499348640442, 0.6733916997909546, -0.1432766169309616],
    [0.48316481709480286, 0.45116978883743286, -0.7033340930938721],
    [0.012481569312512875, 0.9274728298187256, 0.29617491364479065],
    [-0.6770493388175964, 0.6733919382095337, -0.14327852427959442],
    [0.483163446187973, 0.45117291808128357, -0.7033329606056213],
    [0.012481569312512875, 0.9274728298187256, 0.29617491364479065],
    [-0.677049994468689, 0.6733915209770203, -0.14327725768089294],
    [0.48316505551338196, 0.451168417930603, -0.7033360004425049],
    [0.012481569312512875, 0.9274728298187256, 0.29617491364479065],
    [-0.677049994468689, 0.6733915209770203, -0.14327725768089294],
    [0.48316505551338196, 0.451168417930603, -0.7033360004425049]]
GOLDEN_EXAMPLES_F64 = [
    [0.01248169542821917, 0.9274601200520557, 0.29619728051473304],
    [-0.6770620087112199, 0.6733916049205777, -0.14326299331106387],
    [0.48316038942034084, 0.45119413972591527, -0.7033316746589952],
    [0.01248169542821917, 0.9274601200520557, 0.29619728051473304],
    [-0.6770620087112199, 0.6733916049205777, -0.14326299331106387],
    [0.48316038942034084, 0.45119413972591527, -0.7033316746589952],
    [0.012481695428218231, 0.9274601200520548, 0.29619728051472966],
    [-0.6770620087112212, 0.673391604920575, -0.14326299331106226],
    [0.4831603894203401, 0.4511941397259045, -0.7033316746589943],
    [0.012481695428217712, 0.9274601200520582, 0.2961972805147318],
    [-0.6770620087112185, 0.6733916049205781, -0.14326299331106504],
    [0.48316038942034034, 0.4511941397259162, -0.7033316746589889],
    [0.012481695428217712, 0.9274601200520582, 0.2961972805147318],
    [-0.6770620087112185, 0.6733916049205781, -0.14326299331106504],
    [0.48316038942034034, 0.4511941397259162, -0.7033316746589889]]

# mrphy_tpu (JAX, XLA reconstruction adjoint on the CPU), float64:
# ∂/∂rf and ∂/∂gr of Σ W·M for Examples.spincube().applypulse(
# Examples.pulse()), W[0, m, c] = cos(1 + m + 3c), at the steps
# GOLDEN_GRAD_STEPS (all rows), and the largest |gradient| of each.
GOLDEN_GRAD_STEPS = list(range(0, 512, 37))
GOLDEN_GRAD_RF = [
    [-0.24263539364961867, -0.2423378404432988, -0.16264518792818317,
     0.05817908925096946, 0.10880519307968733, 0.16253701502167786,
     0.2361387599690643, 0.2156659388405105, 0.10495624184163271,
     0.01358793262617506, -0.03322269731169909, 0.06297285815119458,
     -0.02390090585693233, -0.1353970702146849],
    [-0.03220237493279838, 0.05220856624752226, -0.030409966629517726,
     -0.10834203008728187, -0.11055506035643432, -0.1373275238793171,
     -0.06519376089104671, 0.10537424691278552, 0.05966239753119258,
     0.11348475004231559, 0.10813588386235047, 0.13438793445758068,
     0.15092437494212674, 0.06624972728821132]]
GOLDEN_GRAD_GR = [
    [0.04268592374207343, 0.030292812379929562, -0.05002052415096073,
     -0.026270911850207912, 0.027214570977572156,
     -0.0004959280131831187, 0.006628481307330385,
     -0.002025333315749794, 0.001421794752194186,
     -0.017077432632249978, 0.052569551222962016,
     0.060107096731374376, 0.007410702054978152, 0.04218052383367682],
    [-0.0215587107420778, -0.015299516149845855, 0.02526308245907341,
     0.013268237860601079, -0.013744836991706269,
     0.000250470591891917, -0.0033477432051712136,
     0.0010229033667948594, -0.0007180836001676183,
     0.008625031346647646, -0.026550479626604326,
     -0.030357349645465992, -0.003742807183097982,
     -0.021303456328467946],
    [-0.06106489765505625, 0.03619006286330892, 0.17751479120705801,
     0.24049792705995218, 0.161506889552203, 0.0032975735718630142,
     -0.06504725209408785, -0.011311255290978215, -0.2188605902842084,
     -0.25761191182891513, -0.258213438292606, -0.2368316880313012,
     -0.20171175453170234, -0.15914264375636478]]
GOLDEN_GRAD_MAX = {'rf': 0.265202218900637,
                   'gr': 0.26230061810034283}

# mrphy_tpu design_pulse (Adam) on Examples.spincube(dtype) /
# Examples.pulse(dtype), Mtgt_ = [0, 0, -1], DesignConfig(**DESIGN_CFG):
# the 10 losses in float64 and in float32. The slew limit is the default
# 12e3: at 5e6 the iterates depend chaotically on rounding (JAX against
# itself through its two adjoints diverges as the port and JAX do:
# tests/test_torch_design.py), so no two engines can agree on them.
DESIGN_CFG = dict(niter=10, lr=0.01, rfmax=12.0, smax=12e3)
GOLDEN_DESIGN_F64 = [
    1.4850310537611076, 2.024545884285759, 0.8403280193497337,
    1.0449401613861549, 0.5652990441708416, 0.6380508132798998,
    0.8744066747899043, 0.6986530579667809, 0.30483736666757444,
    0.25966044617057343]
GOLDEN_DESIGN_F32 = [
    1.485018253326416, 2.024538516998291, 0.8403303027153015,
    1.0449427366256714, 0.5653014779090881, 0.6380435228347778,
    0.874403715133667, 0.6986517310142517, 0.30483540892601013,
    0.2596569061279297]

# mrphy_tpu (JAX, XLA on the CPU), float64, the same problem at the slew
# limit of tests/test_design.py (DesignConfig(**DESIGN_CFG, smax=5e6)):
# the first loss and its gradient w.r.t. the design variables at
# init_params, at the steps GOLDEN_GRAD_STEPS (all rows), and the largest
# |gradient| of each.
GOLDEN_5E6_LOSS = 1.5704550605860592
GOLDEN_5E6_GRAD = {
    'theta': [[-0.7512633926611534, -0.7342087506513352,
               -0.42828719019751726, -0.06944339249823922,
               0.01305790261006406, -0.31720092169761227,
               -0.7513447996108776, -0.004469575497409657,
               -0.16657279295316643, -0.46371686103504595,
               -0.6314361199500765, -0.6668496604702524,
               -0.5965924518651268, -0.4187275548164445]],
    'trho': [[-0.05890838147525706, -0.0718881142619933,
              -0.0789412774906163, -0.07319076521411416,
              -0.05873570876294548, -0.04892467352072929,
              -0.05677565057635243, -0.04981408741769081,
              -0.0653111736635776, -0.07166298627614225,
              -0.07573349451346394, -0.0779293231942146,
              -0.07795207677870877, -0.07549105303948783]],
    'ts': [[1.5296167685818147e-13, 1.1211981548370837e-13,
            7.15318516189556e-14, 3.033372926062349e-14,
            -1.7716252108752073e-14, -6.706920485398112e-14,
            -1.1711600581829462e-13, -1.5831757929932797e-13,
            -1.324947262434288e-13, -1.0378656205315727e-13,
            -8.023558307148488e-14, -5.821189844124663e-14,
            -3.789962555855369e-14, -1.7197030698350413e-14],
           [1.5296167685818147e-13, 1.1211981548370837e-13,
            7.15318516189556e-14, 3.033372926062349e-14,
            -1.7716252108752073e-14, -6.706920485398112e-14,
            -1.1711600581829462e-13, -1.5831757929932797e-13,
            -1.324947262434288e-13, -1.0378656205315727e-13,
            -8.023558307148488e-14, -5.821189844124663e-14,
            -3.789962555855369e-14, -1.7197030698350413e-14],
           [-22.169046238779682, -46.72756598382513, -67.64665406316071,
            -88.27181879752115, -108.37907881020487, -128.18790333723646,
            -148.25949158779477, -166.19439932935308, -141.98087004081256,
            -117.30245509040708, -92.71199355594831, -68.25348251840427,
            -43.94108740242227, -19.7626251923429]]}
GOLDEN_5E6_GRAD_MAX = {'theta': 0.8798214289078093,
                       'trho': 0.08740483804940714,
                       'ts': 166.24889983037752}

KERNELS = {
    'rfgr_fwd': dict(source='mrphy_tpu_torch/kernels/csrc/rfgr_fwd.cu',
                     replaces='mrphy_tpu/ops/pallas_kernels.py:547'),
    'beff_fwd': dict(source='mrphy_tpu_torch/kernels/csrc/beff_fwd.cu',
                     replaces='mrphy_tpu/ops/pallas_kernels.py:928'),
    'rfgr_bwd': dict(source='mrphy_tpu_torch/kernels/csrc/rfgr_bwd.cu',
                     replaces='mrphy_tpu/ops/pallas_kernels.py:665'),
    'beff_bwd': dict(source='mrphy_tpu_torch/kernels/csrc/beff_bwd.cu',
                     replaces='mrphy_tpu/ops/pallas_kernels.py:979'),
}


def device() -> torch.device:
    return torch.device('cuda', 0)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def time_ms(fn, reps: int = 5) -> float:
    r"""Median of ``reps`` CUDA-event timings of ``fn()`` after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def max_err(a, b) -> float:
    check(bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all()),
          'non-finite values')
    return float((a.double() - b.double()).abs().max())


def waveforms(nT, dtype, dev, nC=1):
    r"""The bench pulse: 0.25 G rotating RF, gr = (1, 1, 10·atan(t −
    nT/2)/π) G/cm; with ``nC`` coils, coil c is phase-shifted by c·π/4."""
    t = torch.arange(nT, dtype=torch.float64, device=dev).reshape(1, 1, nT)
    rf = [0.25 * torch.cat([torch.cos(t / nT * 2 * np.pi + c * np.pi / 4),
                            torch.sin(t / nT * 2 * np.pi + c * np.pi / 4)],
                           1) for c in range(nC)]
    rf = torch.stack(rf, -1) if nC > 1 else rf[0]
    one = torch.ones_like(t)
    gr = torch.cat([one, one, 10 * torch.atan(t - nT // 2) / np.pi], 1)
    return rf.to(dtype), gr.to(dtype)


def rfgr_case(nS, nT, dtype, dev, *, nC=1, vel=False, seed=0):
    r"""``blochsim_rfgr`` inputs of the bench configuration, from
    ``seed``: relaxation, Δf, B1 (ones for one coil, random for more)."""
    from mrphy_tpu_torch import T1G, T2G
    rng = np.random.default_rng(seed)

    def arr(x):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    Mi = arr(rng.random((1, nS, 3)) - 0.5)
    loc = arr(rng.random((1, nS, 3)) * 2 - 1)
    df = arr(rng.random((1, nS)) * 200 - 100)
    if nC == 1:
        b1 = arr(np.stack([np.ones((1, nS)), np.zeros((1, nS))], -1))
    else:
        b1 = arr(rng.random((1, nS, 2, nC)) - 0.5)
    rf, gr = waveforms(nT, dtype, dev, nC)
    kw = dict(T1=arr([[T1G]]), T2=arr([[T2G]]), df=df, b1Map=b1)
    if vel:
        kw['vel'] = arr((rng.random((1, nS, 3)) - 0.5) * 100)   # cm/s
    return (Mi, rf, gr, loc), kw


def compare(name, run_kernel, run_plain, dtype, label, timed):
    r"""Kernel vs plain on the same arguments; returns the row."""
    k, p = run_kernel(), run_plain()
    torch.cuda.synchronize()
    fin = (k[:, -1], p[:, -1]) if name == 'rfgr_fwd' else (k[-1], p[-1])
    e_final, e_chk = max_err(*fin), max_err(k, p)
    row = dict(case=label, dtype=str(dtype).replace('torch.', ''),
               max_abs_err_final=e_final, max_abs_err_chk=e_chk,
               bar=BAR[dtype])
    if timed:
        row['ms'] = time_ms(run_kernel)
        row['plain_ms'] = time_ms(run_plain)
    print(f'{name} {label}: ' + json.dumps(row), flush=True)
    check(e_chk <= BAR[dtype], f'{name} {label}: |kernel - plain| = {e_chk} '
          f'> {BAR[dtype]}')
    return row


# The fused engine's cases (phases 2 and 5): label, spins, dtype,
# rfgr_case keywords, timed.
RFGR_CASES = (
    ('1M x 1000, relax+df+b1', 1 << 20, torch.float32, {}, True),
    ('64k x 1000, 2-coil b1', 1 << 16, torch.float32, dict(nC=2), False),
    ('64k x 1000, vel', 1 << 16, torch.float32, dict(vel=True), False),
    ('64k x 1000, 16-coil b1', 1 << 16, torch.float32, dict(nC=16), False),
    ('256k x 1000, relax+df+b1', 1 << 18, torch.float64, {}, True))


def phase_rfgr(dev):
    from mrphy_tpu_torch.kernels import bloch
    from mrphy_tpu_torch.ops import sims
    rows = []
    for label, nS, dtype, kw, timed in RFGR_CASES:
        pos, kws = rfgr_case(nS, 1000, dtype, dev, **kw)
        args = sims.rfgr_planes(*pos, **kws)
        rows.append(compare('rfgr_fwd', lambda: bloch.rfgr_fwd(*args),
                            lambda: bloch.rfgr_fwd_torch(*args), dtype,
                            label, timed))
        del args
    return rows


CUBE = 64   # the cubes' side: 64³ = 262,144 spins


def cube64(dtype, dev):
    r"""A 64³ cube, FOV 24 cm, gray-matter T1/T2, a linear Δf map of
    ±100 Hz, and the 1000-step bench pulse."""
    from mrphy_tpu_torch.models.mobjs import Pulse, SpinCube
    cube = SpinCube((1, CUBE, CUBE, CUBE), [[24., 24., 24.]], device=dev,
                    dtype=dtype)
    cube.df_ = cube.loc_.sum(-1) / 36 * 100                     # Hz
    rf, gr = waveforms(1000, dtype, dev)
    return cube, Pulse(rf, gr, device=dev, dtype=dtype)


# The streaming engine's cases (phases 3 and 6): label, compute dtype,
# Beff's storage dtype (None: the compute dtype).
BEFF_CASES = (('64^3 x 1000', torch.float32, None),
              ('64^3 x 1000, bf16 Beff', torch.float32, torch.bfloat16),
              ('64^3 x 1000', torch.float64, None))


def beff_args(dtype, store, dev):
    r"""``beff_fwd``'s arguments for the 64³ cube and bench pulse, Beff
    stored in ``store``."""
    from mrphy_tpu_torch.ops import sims
    cube, pulse = cube64(dtype, dev)
    beff = cube.pulse2beff(pulse)
    if store is not None:
        beff = beff.to(store)
    return sims.beff_planes(cube.M_, beff, T1=cube.T1_, T2=cube.T2_,
                            gam=cube.gam_, dt=pulse.dt)


def phase_beff(dev):
    from mrphy_tpu_torch.kernels import bloch
    rows = []
    for label, dtype, store in BEFF_CASES:
        args = beff_args(dtype, store, dev)
        rows.append(compare('beff_fwd', lambda: bloch.beff_fwd(*args),
                            lambda: bloch.beff_fwd_torch(*args), dtype,
                            label, timed=True))
        del args
    return rows


def cotangent(x, seed):
    r"""A standard-normal cotangent of ``x``'s shape, from ``seed``."""
    gen = torch.Generator(device=x.device).manual_seed(seed)
    return torch.randn(x.shape, generator=gen, dtype=x.dtype,
                       device=x.device)


def row_err(a, b) -> float:
    r"""max|a − b| / max|b|."""
    return max_err(a, b) / max(float(b.abs().max()), 1e-30)


RFGR_BWD_OUT = ('dmi', 'drf2', 'dgr2', 'dloc', 'ddfg', 'db1', 'dvel')


def design_planes(dev):
    r"""``rfgr_fwd``'s arguments as the full-width design (phase 8b)
    gives them: the 64³ ball problem (relaxation, Δf, no B1) and its
    1000-step pulse, float32."""
    from mrphy_tpu_torch.ops import sims
    cube, pulse, _ = ball_problem(dev)
    return sims.rfgr_planes(cube.M_, pulse.rf, pulse.gr, cube.loc_,
                            T1=cube.T1_, T2=cube.T2_, df=cube.df_,
                            gam=cube.gam_, dt=pulse.dt)


def phase_rfgr_bwd(dev):
    r"""``rfgr_bwd`` against its plain version on phase 2's cases and on
    the full-width design's planes."""
    from mrphy_tpu_torch.kernels import bloch
    from mrphy_tpu_torch.ops import sims

    def planes(nS, dtype, kw):
        pos, kws = rfgr_case(nS, 1000, dtype, dev, **kw)
        return sims.rfgr_planes(*pos, **kws)

    cases = [(label, dtype, timed, functools.partial(planes, nS, dtype, kw))
             for label, nS, dtype, kw, timed in RFGR_CASES]
    cases.append(('64^3 x 1000, design planes (no b1)', torch.float32, True,
                  functools.partial(design_planes, dev)))
    rows = []
    for seed, (label, dtype, timed, make) in enumerate(cases):
        args = make()
        chk = bloch.rfgr_fwd(*args)
        g = cotangent(chk, seed)

        def run_kernel():
            return bloch.rfgr_bwd(chk, g, *args[1:])

        def run_plain():
            return bloch.rfgr_bwd_torch(chk, g, *args[1:])

        k, p = run_kernel(), run_plain()
        torch.cuda.synchronize()
        errs = {n: (row_err(a, b) if n in ('drf2', 'dgr2') else
                    max_err(a, b))
                for n, a, b in zip(RFGR_BWD_OUT, k, p) if b is not None}
        del k, p
        row = dict(case=label, dtype=str(dtype).replace('torch.', ''),
                   err=errs, bar=BAR[dtype], row_bar=ROW_BAR[dtype])
        if timed:
            row['ms'] = time_ms(run_kernel)
            row['plain_ms'] = time_ms(run_plain)
        print(f'rfgr_bwd {label}: ' + json.dumps(row), flush=True)
        for n, e in errs.items():
            bar = ROW_BAR[dtype] if n in ('drf2', 'dgr2') else BAR[dtype]
            check(e <= bar, f'rfgr_bwd {label} {n}: {e} > {bar}')
        row['max_abs_err'] = max(e for n, e in errs.items()
                                 if n not in ('drf2', 'dgr2'))
        row['max_row_rel_err'] = max(errs['drf2'], errs['dgr2'])
        rows.append(row)
        del args, chk, g
    return rows


def phase_fwd_adjoint(dev):
    r"""Forward + adjoint through ``sims.blochsim_rfgr`` at the bench
    configuration, 1M spins × 1000 steps, float32: host clock around
    calls that end in a synchronize, one warm-up, median of 5."""
    from mrphy_tpu_torch.ops import sims
    nS, nT = 1 << 20, 1000
    (Mi, rf, gr, loc), kws = rfgr_case(nS, nT, torch.float32, dev)

    def step():
        r, g = rf.clone().requires_grad_(), gr.clone().requires_grad_()
        Mo = sims.blochsim_rfgr(Mi, r, g, loc, **kws)
        return torch.autograd.grad((Mo * Mo).sum(), (r, g))

    grf, ggr = step()
    torch.cuda.synchronize()
    check(bool(torch.isfinite(grf).all()) and bool(torch.isfinite(ggr).all())
          and float(grf.abs().max()) > 0, 'forward+adjoint gradients')
    torch.cuda.reset_peak_memory_stats(dev)
    ts = []
    for _ in range(5):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    s = statistics.median(ts)
    out = dict(case='1M x 1000 f32, relax+df+b1', s=s,
               spin_steps_per_s=nS * nT / s,
               peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    print('forward+adjoint: ' + json.dumps(out), flush=True)
    return out


def phase_beff_bwd(dev):
    r"""``beff_bwd`` against its plain version on phase 3's cases."""
    from mrphy_tpu_torch.kernels import bloch
    rows = []
    for seed, (label, dtype, store) in enumerate(BEFF_CASES):
        args = beff_args(dtype, store, dev)
        chk = bloch.beff_fwd(*args)
        g = cotangent(chk, 10 + seed)

        def run_kernel():
            return bloch.beff_bwd(chk, g, *args[1:])

        def run_plain():
            return bloch.beff_bwd_torch(chk, g, *args[1:])

        (kmi, kb), (pmi, pb) = run_kernel(), run_plain()
        torch.cuda.synchronize()
        e_mi, e_b = max_err(kmi, pmi), max_err(kb, pb)
        # a bf16 dBeff: one bf16 rounding (2⁻⁸ relative) of the largest
        b_bar = (BAR[dtype] if store is None else
                 2.0 ** -8 * float(pb.float().abs().max()))
        del kmi, kb, pmi, pb
        row = dict(case=label, dtype=str(dtype).replace('torch.', ''),
                   max_abs_err_dmi=e_mi, max_abs_err_dbeff=e_b,
                   bar=BAR[dtype], dbeff_bar=b_bar,
                   ms=time_ms(run_kernel), plain_ms=time_ms(run_plain))
        print(f'beff_bwd {label}: ' + json.dumps(row), flush=True)
        check(e_mi <= BAR[dtype], f'beff_bwd {label} dmi: {e_mi}')
        check(e_b <= b_bar, f'beff_bwd {label} dbeff: {e_b} > {b_bar}')
        row['max_abs_err'] = max(e_mi, e_b)
        rows.append(row)
        del args, chk, g
    return rows


def phase_gradients(dev):
    r"""Gradients through the entry points: the two ``applypulse`` routes
    on the 64³ cube, and the ``Examples`` gradient against JAX."""
    from mrphy_tpu_torch.models.mobjs import Examples, Pulse
    out, bars = {}, {}
    for dtype in (torch.float32, torch.float64):
        cube, pulse = cube64(dtype, dev)
        W = cotangent(cube.M_, 20)
        grads = []
        for fuse in (True, False):
            rf = pulse.rf.clone().requires_grad_()
            gr = pulse.gr.clone().requires_grad_()
            M = cube.applypulse(Pulse(rf, gr, dt=pulse.dt), doFuse=fuse)
            grads.append(torch.autograd.grad((W * M).sum(), (rf, gr)))
            del M
        torch.cuda.synchronize()
        tag = str(dtype)[6:]
        # float32: the two routes round each spin's field differently, a
        # coherent drift of up to route_bar (relative) in the state and,
        # swept back by the adjoint, in each spin's contribution to the
        # gradient; float64: rounding only
        bar = (route_bar(1000, phi_max(cube, pulse))
               if dtype == torch.float32 else 1e-9)
        for name, a, b in zip(('rf', 'gr'), *grads):
            check(bool(torch.isfinite(a).all()), f'{name} grad finite')
            key = f'cube64_{tag}_grad_{name}_fused_vs_unfused'
            out[key], bars[key] = row_err(a, b), bar
        del grads
    cube = Examples.spincube(torch.float64).to(device=dev)
    pulse = Examples.pulse(torch.float64)
    rf = pulse.rf.to(dev).requires_grad_()
    gr = pulse.gr.to(dev).requires_grad_()
    m = torch.arange(cube.nM, dtype=torch.float64, device=dev)
    c = torch.arange(3, dtype=torch.float64, device=dev)
    W = torch.cos(1 + m[None, :, None] + 3 * c[None, None, :])
    M = cube.applypulse(Pulse(rf, gr, dt=pulse.dt))
    grf, ggr = torch.autograd.grad((W * M).sum(), (rf, gr))
    steps = torch.tensor(GOLDEN_GRAD_STEPS, device=dev)
    for name, g, gold in (('rf', grf, GOLDEN_GRAD_RF),
                          ('gr', ggr, GOLDEN_GRAD_GR)):
        gold = torch.tensor(gold, dtype=torch.float64)
        key = f'examples_f64_grad_{name}_vs_jax'
        out[key] = (max_err(g[0][:, steps].cpu(), gold)
                    / GOLDEN_GRAD_MAX[name])
        bars[key] = 1e-9
        out[f'examples_f64_grad_{name}_max_rel'] = abs(
            float(g.abs().max()) / GOLDEN_GRAD_MAX[name] - 1)
    print('gradients: ' + json.dumps(dict(measured=out, bars=bars)),
          flush=True)
    for key, bar in bars.items():
        check(out[key] <= bar, f'{key}: {out[key]} > {bar}')
    check(out['examples_f64_grad_rf_max_rel'] <= 1e-9 and
          out['examples_f64_grad_gr_max_rel'] <= 1e-9, 'max |grad|')
    return out


def ball_problem(dev):
    r"""The 3-D tailored excitation of ``examples/design_3d.py``: a 64³
    cube, FOV 24 cm, gray-matter T1/T2; a central ball of radius 6 cm
    flipped to [0, 1, 0], the rest kept at [0, 0, 1]; a 1000-step pulse
    (rf 0.05 G at a slow phase ramp, gr random 0.2 G/cm from seed 0),
    float32."""
    from mrphy_tpu_torch import T1G, T2G, dt0
    from mrphy_tpu_torch.models.mobjs import Pulse, SpinCube
    cube = SpinCube((1, CUBE, CUBE, CUBE), [[24., 24., 24.]], T1_=[[T1G]],
                    T2_=[[T2G]], device=dev)
    ball = torch.linalg.vector_norm(cube.loc_, dim=-1) < 6.0
    Mtgt = torch.tensor([0., 0., 1.], device=dev).repeat(1, cube.nM, 1)
    Mtgt[ball] = torch.tensor([0., 1., 0.], device=dev)
    nT = 1000
    t = torch.arange(nT, dtype=torch.float32).reshape(1, 1, nT)
    rf = 0.05 * torch.cat([torch.cos(t / 40), torch.sin(t / 40)], 1)
    gr = torch.as_tensor(np.random.default_rng(0).normal(size=(1, 3, nT))
                         * 0.2, dtype=torch.float32)
    return cube, Pulse(rf, gr, dt=dt0, device=dev), Mtgt


def phase_design(dev):
    r"""(a) the ``Examples`` design against JAX; (b) the full-width
    multi-scale design."""
    from mrphy_tpu_torch import dt0
    from mrphy_tpu_torch.design import (DesignConfig, design_multiscale,
                                        design_pulse, design_step,
                                        init_params, make_optimizer)
    from mrphy_tpu_torch.kernels import bloch
    from mrphy_tpu_torch.models.mobjs import Examples
    from mrphy_tpu_torch.utils import g2s
    out, bars = {}, {}
    for dtype, golden in ((torch.float64, GOLDEN_DESIGN_F64),
                          (torch.float32, GOLDEN_DESIGN_F32)):
        cube = Examples.spincube(dtype).to(device=dev)
        pulse = Examples.pulse(dtype)
        Mtgt = torch.tensor([0., 0., -1.], dtype=dtype,
                            device=dev).repeat(1, cube.nM, 1)
        _, losses = design_pulse(cube, pulse, Mtgt, cfg=DesignConfig(
            dt=dt0, **DESIGN_CFG))
        gold = torch.tensor(golden, dtype=torch.float64)
        key = f'examples_design_{str(dtype)[6:]}_vs_jax'
        if dtype == torch.float64:
            out[key] = float(((losses.cpu() - gold) / gold).abs().max())
            bars[key] = 1e-8
        else:
            out[key] = max_err(losses.cpu(), gold)
            bars[key] = loss_bar(512, phi_max(cube, pulse.to(device=dev)))
    # the slew limit 5e6, float64: the first loss and gradient
    cube = Examples.spincube(torch.float64).to(device=dev)
    pulse = Examples.pulse(torch.float64).to(device=dev)
    Mtgt = torch.tensor([0., 0., -1.], dtype=torch.float64,
                        device=dev).repeat(1, cube.nM, 1)
    cfg = DesignConfig(dt=dt0, **dict(DESIGN_CFG, smax=5e6))
    params = init_params(pulse.rf, pulse.gr, cfg)
    loss, _ = design_step(params, make_optimizer(cfg, params), cfg, cube.M_,
                          cube.loc_, Mtgt, cube.T1_, cube.T2_, cube.gam_,
                          cube.df_, None, None, None, None, None, True)
    out['examples_design_5e6_f64_loss_vs_jax'] = abs(
        float(loss) / GOLDEN_5E6_LOSS - 1)
    bars['examples_design_5e6_f64_loss_vs_jax'] = 1e-9
    steps = torch.tensor(GOLDEN_GRAD_STEPS, device=dev)
    for name, gold in GOLDEN_5E6_GRAD.items():
        g = params[name].grad[0][..., steps].cpu()
        key = f'examples_design_5e6_f64_grad_{name}_vs_jax'
        out[key] = (max_err(g, torch.tensor(gold, dtype=torch.float64))
                    / GOLDEN_5E6_GRAD_MAX[name])
        bars[key] = 1e-9
    print('design vs jax: ' + json.dumps(dict(measured=out, bars=bars)),
          flush=True)
    for key, bar in bars.items():
        check(out[key] <= bar, f'{key}: {out[key]} > {bar}')

    cube, pulse, Mtgt = ball_problem(dev)
    cfg = DesignConfig(lr=0.02, rfmax=0.25, smax=12e3)
    dts, niters = [2 * dt0, dt0], [10, 20]
    n0 = dict(bloch.LAUNCHES)
    t0 = time.perf_counter()
    p2, losses = design_multiscale(cube, pulse, Mtgt, dts=dts,
                                   niters=niters, cfg=cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd = bloch.LAUNCHES['rfgr_fwd'] - n0['rfgr_fwd']
    bwd = bloch.LAUNCHES['rfgr_bwd'] - n0['rfgr_bwd']
    # seconds per iteration of each stage on its own
    per_iter = {}
    for dt_s, ni in zip(dts, niters):
        p_s = pulse.interpT(dt_s)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        design_pulse(cube, p_s, Mtgt, cfg=DesignConfig(
            lr=0.02, rfmax=0.25, smax=12e3, dt=dt_s, niter=ni))
        torch.cuda.synchronize()
        per_iter[p_s.rf.shape[2]] = (time.perf_counter() - t1) / ni
    rfn = torch.linalg.vector_norm(p2.rf, dim=1)
    slew = g2s(p2.gr, dt0).abs()
    fine = losses[1].cpu()
    res = dict(nT=p2.rf.shape[2], wall_s=wall,
               s_per_iter={str(k): v for k, v in per_iter.items()},
               losses_coarse=[float(x) for x in losses[0]],
               losses_fine=[float(x) for x in fine],
               max_rf=float(rfn.max()), max_slew=float(slew.max()),
               rfgr_fwd_launches=fwd, rfgr_bwd_launches=bwd)
    print('design 64^3: ' + json.dumps(res), flush=True)
    check(res['nT'] == 1000, 'fine stage nT')
    check(all(np.isfinite(res['losses_coarse'] + res['losses_fine'])),
          'design losses finite')
    check(float(fine.min()) < float(fine[0]), 'fine stage made no progress')
    check(res['max_rf'] <= 0.25 + 1e-4, f'rf limit: {res["max_rf"]}')
    check(res['max_slew'] <= 12e3 * (1 + 1e-4), f'slew: {res["max_slew"]}')
    check(fwd >= sum(niters) and bwd >= sum(niters),
          f'launches per iteration: fwd {fwd}, bwd {bwd}')
    out.update(per_iter_s=res['s_per_iter'])
    return out


def phi_max(cube, pulse) -> float:
    r"""Bound on the per-step rotation angle of ``pulse`` on ``cube``."""
    from mrphy_tpu_torch.ops import sims
    return float(sims.rfgr_phi_bound(pulse.rf, pulse.gr, cube.loc_,
                                     df=cube.df_, gam=cube.gam_,
                                     dt=pulse.dt))


def phase_main_path(dev):
    r"""The forward path through the entry points; returns the measured
    errors."""
    from mrphy_tpu_torch.models.mobjs import Examples
    out, bars = {}, {}
    for dtype, golden in ((torch.float32, GOLDEN_EXAMPLES_F32),
                          (torch.float64, GOLDEN_EXAMPLES_F64)):
        cube = Examples.spincube(dtype).to(device=dev)
        pulse = Examples.pulse(dtype)
        M = cube.applypulse(pulse, doEmbed=True)
        torch.cuda.synchronize()
        check(tuple(M.shape) == (1, 3, 3, 3, 3), f'embedded shape {M.shape}')
        check(int(torch.isnan(M).sum()) == 3 * (27 - cube.nM),
              'NaN fill outside the mask')
        key = f'examples_{str(dtype)[6:]}_vs_jax'
        out[key] = max_err(cube.extract(M)[0].cpu(),
                           torch.tensor(golden, dtype=torch.float64))
        bars[key] = (route_bar(512, phi_max(cube, pulse))
                     if dtype == torch.float32 else BAR[dtype])

    for dtype in (torch.float32, torch.float64):
        cube, pulse = cube64(dtype, dev)
        t0 = time.perf_counter()
        M_fused = cube.applypulse(pulse, doFuse=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        M_beff = cube.applypulse(pulse, doFuse=False)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        check(tuple(M_fused.shape) == (1, CUBE ** 3, 3), 'cube64 output shape')
        tag = str(dtype)[6:]
        out[f'cube64_{tag}_fused_s'] = t1 - t0
        out[f'cube64_{tag}_unfused_s'] = t2 - t1
        key = f'cube64_{tag}_fused_vs_unfused'
        out[key] = max_err(M_fused, M_beff)
        bars[key] = (route_bar(1000, phi_max(cube, pulse))
                     if dtype == torch.float32 else BAR[dtype])
        del M_fused, M_beff
    print('main path: ' + json.dumps(dict(measured=out, bars=bars)),
          flush=True)
    for key, bar in bars.items():
        check(out[key] <= bar, f'{key}: {out[key]} > {bar}')
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False',
              file=sys.stderr)
        return 1
    from mrphy_tpu_torch.kernels import _build, bloch

    dev = device()
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f'torch {torch.__version__}, CUDA {torch.version.cuda}, '
          f'device {torch.cuda.get_device_name(0)}, '
          f'capability {torch.cuda.get_device_capability(0)}')
    nvcc = subprocess.run([_build.nvcc_path(), '--version'],
                          capture_output=True, text=True, check=True).stdout
    print('nvcc: ' + next(ln for ln in nvcc.splitlines() if 'release' in ln))
    _, info = _build.library()
    ptxas = info.pop('ptxas').splitlines()
    print(f'kernel build: {json.dumps(info)}', flush=True)
    # registers and spills of every kernel instance: the lines after each
    # "Compiling entry function"
    for i, ln in enumerate(ptxas):
        if 'Compiling entry function' in ln:
            used = [x.split(':', 1)[-1].strip() for x in ptxas[i + 1:i + 4]
                    if 'spill' in x or 'Used' in x]
            print(f"ptxas {ln.split(chr(39))[1]}: {'; '.join(used)}")

    # float32 matrix products and convolutions in full float32 (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    rfgr_rows = phase_rfgr(dev)
    beff_rows = phase_beff(dev)
    rfgr_bwd_rows = phase_rfgr_bwd(dev)
    phase_fwd_adjoint(dev)
    beff_bwd_rows = phase_beff_bwd(dev)

    # the forward path, then the gradient and design path: each with the
    # launch counts zeroed just before it and read just after
    launches = {k: 0 for k in bloch.LAUNCHES}
    for path, run, needs in (
            ('forward', phase_main_path, ('rfgr_fwd', 'beff_fwd')),
            ('gradient+design', lambda d: (phase_gradients(d),
                                           phase_design(d)),
             tuple(bloch.LAUNCHES))):
        for k in bloch.LAUNCHES:
            bloch.LAUNCHES[k] = 0
        run(dev)
        counts = dict(bloch.LAUNCHES)
        print(f'launches on the {path} path: {json.dumps(counts)}',
              flush=True)
        for k in needs:
            check(counts[k] > 0, f'kernel {k} was not launched on the '
                  f'{path} path')
        for k, n in counts.items():
            launches[k] += n

    kernels = []
    for name, rows in (('rfgr_fwd', rfgr_rows), ('beff_fwd', beff_rows),
                       ('rfgr_bwd', rfgr_bwd_rows),
                       ('beff_bwd', beff_bwd_rows)):
        head = rows[0]   # the float32 timed case at the main-path shape
        err = 'max_abs_err_chk' if name.endswith('fwd') else 'max_abs_err'
        f32 = [r for r in rows if r['dtype'] == 'float32']
        kernels.append(dict(
            name=name, route='cuda', **KERNELS[name],
            launches=launches[name],
            max_abs_err=max(r[err] for r in f32),
            ms=head['ms'], plain_ms=head['plain_ms']))
        if name == 'rfgr_bwd':   # the rows: max|Δ| / max|row|
            kernels[-1]['max_row_rel_err'] = max(
                r['max_row_rel_err'] for r in f32)
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
