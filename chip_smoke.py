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
   instance at 262,144 spins. Max |Δ| of the final state and of all
   chunk-end states, and the times of both (CUDA events, one warm-up,
   median of 5).
3. ``beff_fwd`` against its plain version on a 64³ cube (262,144 spins) ×
   1000 steps: float32, bfloat16-stored Beff (both sides fed the same
   bf16 values) and float64.
5. ``rfgr_bwd`` against its plain version on the cases of phase 2 and
   on the planes of the full-width design (phase 8b: 64³ × 1000, float32,
   no B1, the rf rows built from γ2πdt·∂L/∂b), fed the same chunk ends
   and a cotangent drawn from a seed: per-spin outputs at ``BAR``,
   waveform rows (sums over spins, in another order) at ``ROW_BAR`` of
   their largest value; times of both on the timed cases (the plain
   version's: median of 3). Then forward +
   adjoint through the public entry (``torch.autograd.grad`` of Σ Mo²
   w.r.t. rf and gr through
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

9. ``mc_fwd`` against its plain version on the arguments
   ``mc.blochsim_mc_rfgr`` gives it: the whole-brain CEST configuration
   of ``benchmarks/suite.py`` ``bench_cest`` (524,288 voxels × 2000
   steps, Δf and a 1-coil B1 map, float32, timed); at 65,536 voxels a
   2-coil B1 case with a gradient, a case with neither Δf nor B1, an MT
   bound pool (T2b 10 µs at dt 200 µs: the transverse mix X ≈ 2e-9) and
   the float64 instance. ``BAR`` on every chunk-start state and the final
   state.
10. ``mc_bwd`` against its plain version on the same cases, fed the same
    chunk starts and a seeded cotangent: per-voxel outputs at ``BAR``,
    waveform rows at ``ROW_BAR``; timed on the full-width case (the
    plain version: median of 3).
11. The two-pool path through ``mc.blochsim_mc_rfgr``: (a) the
    ``examples/cest_fit.py`` problem in float64 against the JAX
    package's results (literals below): the Z-spectra at 1e-10, the fit
    loss's gradient w.r.t. log kab, the B0 offsets, the rf and T2b at
    1e-9 of each one's largest value, and 10 Adam iterations
    (``design.make_optimizer``, lr 0.05) against optax's losses at rtol
    1e-8; (b) the ``examples/cest_zspectrum.py`` problem (41 offsets,
    2 s of 5 mG CW saturation, 10,000 steps) against the streaming
    oracle ``slowsims.blochsim_mc``, float64 at 1e-10 and float32 at the
    example's bar, with its physics (MTR_asym(δb) > 0.02, Z(0) < 0.5);
    (c) at the full ``bench_cest`` width, the forward's and one fit
    step's (∂ΣMa/∂kab) time and peak memory.

Launch counts are zeroed right before the forward path (phase 4) and read
after it (``rfgr_fwd``, ``beff_fwd`` must have launched), zeroed again
before the gradient and design path (phases 7–8) and read after it (all
four Bloch kernels must have launched), and again before the two-pool
path (phase 11; ``mc_fwd`` and ``mc_bwd`` must have launched). The
comparisons with the plain versions (phases 2, 3, 5, 6, 9, 10) run
before and are not counted.

The line before the last is one JSON object with each kernel's launches
on those paths, error, times and bound: ``bound_ms`` is the larger of the
bytes of its timed float32 case (inputs read once, outputs written once)
over 3.35 TB/s and the arithmetic of its plain version on the same
inputs (:func:`count_ops`) over 67 TFLOP/s; ``library_ms`` is null, as no
single PyTorch call computes a Bloch simulation. The last line is the
contract line ``{"ok": true, "device": {"platform": "gpu", "kind": ...,
"count": ...}}``.
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

# The CEST fit of examples/cest_fit.py (lines 79-115): 48 voxels × 25
# saturation offsets × 2 powers, 1 s of CW saturation at a 500 µs dwell
# (2000 steps), an amide-like solute pool; the fitted maps are log kab and
# the B0 offset (in units of df_scale Hz); Adam at lr 0.05. Float64 here.
CEST_FIT = dict(nV=48, nF=25, b1=(0.002, 0.006), nT=2000, dt=5e-4,
                T1a=1.4, T2a=0.08, T1b=1.0, T2b=0.01, Ma0=1.0, Mb0=0.015,
                dfb=750.0, seed=11, lr=0.05, niter=10, df_scale=20.0)
# the voxels of the fit whose Z-spectra are held to JAX, and the steps of
# the rf gradient
CEST_Z_VOXELS = [0, 23, 47]
CEST_RF_STEPS = list(range(0, 2000, 97))


def cest_fit_arrays():
    r"""The cest_fit problem's numpy float64 inputs, from its seed: the
    true kab and B0 maps, the offsets (Hz) and the rf (nP, 2, nT)."""
    c = CEST_FIT
    rng = np.random.default_rng(c['seed'])
    kab_true = rng.uniform(0.8, 4.0, c['nV'])
    df0_true = rng.uniform(-30.0, 30.0, c['nV'])
    offsets = np.linspace(-1.6 * c['dfb'], 1.6 * c['dfb'], c['nF'])
    rf = np.zeros((len(c['b1']), 2, c['nT']))
    rf[:, 0] = np.asarray(c['b1'])[:, None]
    return kab_true, df0_true, offsets, rf


# mrphy_tpu (JAX, XLA backend on the CPU), float64, on the CEST_FIT problem
# (tests/make_cest_goldens.py prints these): the Z-spectra of the true
# maps at CEST_Z_VOXELS (powers × voxels × offsets); the gradient of the
# fit loss at the initial maps (kab 1, B0 offset 0) w.r.t. log kab, the
# B0 offsets, the rf (at CEST_RF_STEPS) and T2b, with the largest |value|
# of each; the losses of 10 Adam iterations (optax.adam(0.05)).
GOLDEN_CEST_Z = [[[0.9994904872548358, 0.9993921451693482,
                   0.9992625814149978, 0.9990864377508308,
                   0.9988382394608755, 0.9984724358063496,
                   0.9979008726086338, 0.9969343153847366,
                   0.9951037801346669, 0.9909687242545958, 0.978167390283608,
                   0.8943837171569451, 0.28054096747350554,
                   0.949307788692307, 0.9835604349881995, 0.9912896453179187,
                   0.9937605595862647, 0.9937799186684657, 0.989087175269776,
                   0.9265262933104067, 0.9781159589701643,
                   0.9953734923044417, 0.9979007567241437,
                   0.9987252242360333, 0.9991082669463611],
                  [0.9994853193052704, 0.9993857033092511,
                   0.9992538947655343, 0.9990743380606579, 0.998820815648654,
                   0.9984463312321131, 0.9978597746309705,
                   0.9968652943140556, 0.9949771604657854,
                   0.9907046454505548, 0.9774973563464365,
                   0.8926417491724239, 0.21872831053113406,
                   0.9424663967372056, 0.9809680740680375, 0.989527115326013,
                   0.9920935726445371, 0.9916665712871188,
                   0.9852058029651108, 0.9280209384156852,
                   0.9724121481772755, 0.9940886997146797,
                   0.9974578847014288, 0.9985248543676688,
                   0.9990020399824765],
                  [0.9995198637526391, 0.9994289422785398,
                   0.9993115178903208, 0.9991536324443175,
                   0.9989340651752694, 0.9986157719223593, 0.998129077856376,
                   0.9973299530257445, 0.9958798412920834,
                   0.9928195094630607, 0.9844758661031592,
                   0.9454034220350026, 0.0977471096558282,
                   0.9125770716038941, 0.9789864837605953,
                   0.9902765284693523, 0.9937867899578262,
                   0.9946640003352246, 0.99274023600446, 0.9718996677827435,
                   0.9512596092132569, 0.9939277274154857,
                   0.9976000477609428, 0.9986135752802136,
                   0.999051440114414]],
                 [[0.9954272934270165, 0.9945476554605388,
                   0.9933902234910803, 0.9918193381794613,
                   0.9896110425957346, 0.9863674034336408,
                   0.9813254361968041, 0.9728711383445119,
                   0.9571044876712308, 0.9226344273864305,
                   0.8252581952558103, 0.4288617606627832,
                   0.03322570447529757, 0.6486019827123499,
                   0.8645468535373398, 0.9252658653954825,
                   0.9458682080837336, 0.9464651716553626,
                   0.9117621219235204, 0.6715404298583183,
                   0.8493935280073764, 0.9606163028911355,
                   0.9815152867977202, 0.9886589322830381,
                   0.9920324367521947],
                  [0.9953810168484022, 0.994490046172822, 0.9933126489838159,
                   0.9917114889619683, 0.9894561493598578,
                   0.9861362419735257, 0.9809636994734025,
                   0.9722697730899464, 0.956022165271199, 0.9204714631275479,
                   0.8204332927454862, 0.42271987591063004,
                   0.025688863155012336, 0.6132979892357125,
                   0.8451631453487292, 0.9109314225203987,
                   0.9319587662716119, 0.9288686311135852, 0.88085366113719,
                   0.618843653166515, 0.8054871249018901, 0.949619824276343,
                   0.9776150556001655, 0.9868775148161696,
                   0.9910839713177905],
                  [0.9956903072122295, 0.9948766899344023,
                   0.9938272070718019, 0.9924182535120036, 0.990462946161751,
                   0.9876368787869968, 0.9833348069856197,
                   0.9763210592006113, 0.963750732462139, 0.9378722609035312,
                   0.8715707741822669, 0.629165347380931,
                   0.011781920977235513, 0.48870852712326374,
                   0.8310077345162981, 0.9170180864122869,
                   0.9460481522355366, 0.9537264896064268,
                   0.9393466173311801, 0.8253644360306464,
                   0.7660544374822065, 0.9500889860957181,
                   0.9790421102091752, 0.9877027337680465,
                   0.9915365002035806]]]
GOLDEN_CEST_GRAD = {'T2b': 0.02571205155158604,
                    'dfs': [3.477669254174708e-05, -5.2863870111639564e-05,
                            3.270348072453445e-06, -1.8860231110291077e-05,
                            4.565636753961528e-05, 4.502976029976083e-05,
                            -3.499089002463244e-05, -9.110731584437894e-06,
                            1.7653526295699806e-05, 1.816543637806161e-05,
                            4.269826442577373e-05, 3.367194924983139e-05,
                            4.790164631740319e-05, -3.614230330721492e-05,
                            3.3623978996933146e-06, 3.6861255067129607e-05,
                            -2.622940603092722e-05, 3.128042876764503e-05,
                            4.314855515709172e-05, -1.1285680089136514e-05,
                            -4.1690491555299756e-05, 4.884633427151657e-05,
                            -3.311182010731114e-05, 3.1950381704468926e-05,
                            4.2341149068874825e-05, 4.901375415503076e-05,
                            2.143048524159305e-05, -2.496465946380039e-05,
                            -9.094017885554599e-07, -3.646290506604907e-05,
                            2.9178469279917566e-05, 1.9132608178166125e-05,
                            2.4410267700514816e-05, -4.9978602895500134e-05,
                            -4.722015752901514e-05, 1.6294665336653688e-05,
                            5.569348564639016e-06, 1.915049227305603e-05,
                            -2.691378932487092e-05, 4.7579775133492074e-05,
                            4.289188945293286e-05, 9.805332910193274e-06,
                            2.6483510667789736e-05, -3.727894657745372e-05,
                            -2.6434384198049007e-05, -6.001303033953335e-06,
                            -1.756509889827426e-05,
                            -1.8853086581241072e-05],
                    'logk': [-5.328807234442984e-06, -1.8937430708679085e-05,
                             -1.579536156503244e-05, 6.108895760357389e-07,
                             -7.590104168067739e-06, -2.049551349821292e-05,
                             -3.607455806056758e-06, -3.3369189575232527e-06,
                             -1.984972406500078e-05, -1.6405581219885422e-05,
                             -1.3774350081887689e-05,
                             -1.5633711630975408e-05,
                             -1.8774891065703096e-05,
                             -1.1335424719931888e-05, -3.385179074470684e-06,
                             -1.9240036756129446e-05,
                             -1.8313106517786676e-05,
                             -1.5452069340693408e-05,
                             -1.9775521224427886e-05,
                             -1.5266537614129436e-05, -2.300347460436083e-05,
                             -1.0078577560536519e-05,
                             -1.7212042199437216e-05, -1.499749601565356e-05,
                             -1.3376087296867077e-05, -1.808729792032022e-05,
                             -7.852800806119564e-06, -1.9842463775772293e-05,
                             -1.9244215868058347e-05, -6.364383824834912e-06,
                             -1.4452481846339721e-05, -8.999070868245215e-06,
                             -2.118481298335447e-06, -2.3259214375097435e-05,
                             -1.680142930537657e-05, -4.264515596802727e-06,
                             -1.6889728488627536e-05, -6.536839075639534e-06,
                             -2.0984191116632246e-05,
                             -1.0320120807924285e-05,
                             -1.8135538676516552e-06, -5.953910953866837e-06,
                             -1.1511255776311359e-05,
                             -1.6166875680875994e-05, -2.098612240626941e-05,
                             -1.741225453653171e-05, -1.0974205330928242e-05,
                             1.2413355119387959e-06],
                    'rf': [[[-0.00016259537863419686, 0.00019945978503323425,
                             0.00015502270226032156, 7.172296067143696e-05,
                             1.019276163428619e-05, -1.9548243507061933e-05,
                             -1.1941131753235991e-05,
                             -1.7553291555609404e-05, 2.280992803498101e-05,
                             -2.680544522954034e-06, -7.759814856540045e-06,
                             2.429460476670066e-05, -8.516610060416008e-05,
                             9.367146328731773e-05, -0.00011515220320268439,
                             -1.3792136981743986e-05, 0.00011339405710120544,
                             -0.00036074511213640107, 0.0008159936697842343,
                             -0.0003681800822758699, 0.0006449467362475119],
                            [-0.00011740985162803209, -5.863190994973906e-05,
                             5.026294722192278e-06, 2.2152128999287076e-05,
                             1.6220369940071656e-05, 6.238040903766837e-06,
                             -5.812441420730503e-08, -1.0862027079072702e-06,
                             -1.2836678854700156e-06, -5.161812224773235e-07,
                             -3.6849345045724296e-08, 3.178595693937339e-07,
                             1.6050927477864457e-06, 3.0104938192636525e-06,
                             3.722155714987031e-06, -2.2781756717886825e-06,
                             -1.600713413855098e-05, -2.6710533986967213e-05,
                             -1.3014333989020511e-05, 7.312691337189747e-05,
                             0.00016177430058052016]],
                           [[-0.002160482533068374, -0.00018695420454129926,
                             -0.00033227530639186065,
                             -0.00039897598834829327, -0.0003607544623965804,
                             -0.0002806508742017394, -0.00023322128015451784,
                             -0.00028292049025708263, -0.0002868194555788926,
                             -0.00029075745929742013, -0.0002979661545691705,
                             -0.0003165176054254981, -0.0003455059865060683,
                             -0.0003675714781528854, -0.00034366046816672644,
                             -0.00041736306658535607, -0.0006272951683572451,
                             -0.0008200422717935532, -0.0008387824114889605,
                             -0.00044563039775541533,
                             -0.0002744846482548378],
                            [-5.845765749281436e-05, -0.0004931231119751215,
                             -0.00025954007050573444,
                             -0.00015076354622026267, -8.745156560486958e-05,
                             -3.537297545009358e-05, -8.987492402126894e-06,
                             -9.117319623804904e-07, -5.207285524138932e-06,
                             -2.86612044892538e-06, 2.2983665467147662e-08,
                             3.774470653491157e-06, 1.0046420159660168e-05,
                             2.120402369926679e-05, 6.0560407741123576e-05,
                             6.006722102572348e-05, 0.00013025252064893637,
                             0.00023445649815621777, 0.0004165642591635526,
                             0.0007566526349456785,
                             2.819014634413905e-05]]]}
GOLDEN_CEST_GRAD_MAX = {'T2b': 0.02571205155158604,
                        'dfs': 5.2863870111639564e-05,
                        'logk': 2.3259214375097435e-05,
                        'rf': 0.007344751886470307}
GOLDEN_CEST_LOSSES = [0.0024998442007579105, 0.0023951144315448353,
                      0.002279837277084646, 0.002154762554925357,
                      0.0020294508272892422, 0.001897198727172933,
                      0.0017618166585854874, 0.0016240224592752141,
                      0.0014853437784068126, 0.0013468288963452662]


KERNELS = {
    'rfgr_fwd': dict(source='mrphy_tpu_torch/kernels/csrc/rfgr_fwd.cu',
                     replaces='mrphy_tpu/ops/pallas_kernels.py:547'),
    'beff_fwd': dict(source='mrphy_tpu_torch/kernels/csrc/beff_fwd.cu',
                     replaces='mrphy_tpu/ops/pallas_kernels.py:928'),
    'rfgr_bwd': dict(source='mrphy_tpu_torch/kernels/csrc/rfgr_bwd.cu',
                     replaces='mrphy_tpu/ops/pallas_kernels.py:665'),
    'beff_bwd': dict(source='mrphy_tpu_torch/kernels/csrc/beff_bwd.cu',
                     replaces='mrphy_tpu/ops/pallas_kernels.py:979'),
    'mc_fwd': dict(source='mrphy_tpu_torch/kernels/csrc/mc_fwd.cu',
                   replaces='mrphy_tpu/ops/mc_pallas.py:250'),
    'mc_bwd': dict(source='mrphy_tpu_torch/kernels/csrc/mc_bwd.cu',
                   replaces='mrphy_tpu/ops/mc_pallas.py:583'),
}

# The H100 SXM's published peaks (NVIDIA's data sheet, at 700 W): HBM
# bytes per second and float32 operations per second outside the tensor
# cores. No kernel here uses the tensor cores.
HBM_BPS = 3.35e12
F32_OPS = 67e12


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


def compare(name, run_kernel, run_plain, dtype, label, timed, inputs,
            plain_reps=5):
    r"""Kernel vs plain on the same arguments ``inputs``; returns the
    row (with the bound of a timed float32 case)."""
    k, p = run_kernel(), run_plain()
    torch.cuda.synchronize()
    fin = ((k[:, -1], p[:, -1]) if name in ('rfgr_fwd', 'mc_fwd')
           else (k[-1], p[-1]))
    e_final, e_chk = max_err(*fin), max_err(k, p)
    row = dict(case=label, dtype=str(dtype).replace('torch.', ''),
               max_abs_err_final=e_final, max_abs_err_chk=e_chk,
               bar=BAR[dtype])
    if timed:
        row['ms'] = time_ms(run_kernel)
        row['plain_ms'] = time_ms(run_plain, reps=plain_reps)
        if dtype == torch.float32:
            row.update(bound(run_plain, inputs, k))
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
                            label, timed, args))
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
                            label, True, args))
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

# The arithmetic of the plain versions, one operation per element of each
# result (a sum: per element of its input). Indexing, stacking and copies
# are not counted; nor are the kernels' own extra instructions (sincos's
# range reduction and polynomials count as one operation each for sin and
# cos): a lower bound on the card's work.
_ARITH = {'add', 'sub', 'mul', 'div', 'neg', 'rsqrt', 'sin', 'cos',
          'clamp_min', 'reciprocal', 'sum', 'exp', 'expm1'}


def count_ops(fn) -> int:
    r"""The operations of ``_ARITH`` that ``fn()`` performs."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__
            if name in _ARITH:
                Count.n += (args[0].numel() if name == 'sum'
                            else out.numel())
            return out

    with Count():
        fn()
    return Count.n


def nbytes(*xs) -> int:
    r"""Bytes of the tensors among ``xs`` (nested in tuples too)."""
    n = 0
    for x in xs:
        if isinstance(x, (tuple, list)):
            n += nbytes(*x)
        elif isinstance(x, torch.Tensor):
            n += x.numel() * x.element_size()
    return n


def bound(run_plain, inputs, outputs) -> dict:
    r"""The least time the card could take for one call of a kernel: the
    larger of its bytes (each input read once, each output written once)
    over HBM_BPS and the operations of its plain version on the same
    inputs (:func:`count_ops`) over F32_OPS."""
    ops, nb = count_ops(run_plain), nbytes(inputs, outputs)
    t_b, t_o = nb / HBM_BPS * 1e3, ops / F32_OPS * 1e3
    return dict(bound_ms=max(t_b, t_o),
                bound_by='bytes' if t_b >= t_o else 'operations',
                bytes=nb, ops=ops)


def design_planes(dev):
    r"""``rfgr_fwd``'s arguments as the full-width design (phase 8b)
    gives them: the 64³ ball problem (relaxation, Δf, no B1) and its
    1000-step pulse, float32."""
    from mrphy_tpu_torch.ops import sims
    cube, pulse, _ = ball_problem(dev)
    return sims.rfgr_planes(cube.M_, pulse.rf, pulse.gr, cube.loc_,
                            T1=cube.T1_, T2=cube.T2_, df=cube.df_,
                            gam=cube.gam_, dt=pulse.dt)


def compare_adjoint(name, cases, fwd, bwd, bwd_plain, outs, seed0):
    r"""An adjoint kernel against its plain version on ``cases`` (label,
    dtype, timed, make: the forward's arguments): both fed the forward
    kernel's checkpoints and a cotangent drawn from a seed. Per-voxel
    outputs at ``BAR``, the waveform rows ``drf2``/``dgr2`` (sums over
    voxels, in another order) at ``ROW_BAR`` of their largest value; the
    times and the bound of the timed float32 cases. Returns the rows."""
    rows = []
    for seed, (label, dtype, timed, make) in enumerate(cases, seed0):
        args = make()
        chk = fwd(*args)
        g = cotangent(chk, seed)

        def run_kernel():
            return bwd(chk, g, *args[1:])

        def run_plain():
            return bwd_plain(chk, g, *args[1:])

        k, p = run_kernel(), run_plain()
        torch.cuda.synchronize()
        errs = {n: (row_err(a, b) if n in ('drf2', 'dgr2') else
                    max_err(a, b))
                for n, a, b in zip(outs, k, p) if b is not None}
        del k
        row = dict(case=label, dtype=str(dtype).replace('torch.', ''),
                   err=errs, bar=BAR[dtype], row_bar=ROW_BAR[dtype])
        if timed:
            row['ms'] = time_ms(run_kernel)
            row['plain_ms'] = time_ms(run_plain, reps=3)
            if dtype == torch.float32:
                row.update(bound(run_plain, (chk, g, args[1:]), p))
        del p
        print(f'{name} {label}: ' + json.dumps(row), flush=True)
        for n, e in errs.items():
            bar = ROW_BAR[dtype] if n in ('drf2', 'dgr2') else BAR[dtype]
            check(e <= bar, f'{name} {label} {n}: {e} > {bar}')
        row['max_abs_err'] = max(e for n, e in errs.items()
                                 if n not in ('drf2', 'dgr2'))
        row['max_row_rel_err'] = max(errs['drf2'], errs['dgr2'])
        rows.append(row)
        del args, chk, g
    return rows


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
    return compare_adjoint('rfgr_bwd', cases, bloch.rfgr_fwd, bloch.rfgr_bwd,
                           bloch.rfgr_bwd_torch, RFGR_BWD_OUT, 0)


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
        if dtype == torch.float32:
            row.update(bound(run_plain, (chk, g, args[1:]), run_plain()))
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


# ---------------------------------------------------------------------------
# The two-pool Bloch–McConnell engine (phases 9-11)
# ---------------------------------------------------------------------------

CEST_NS, CEST_NT = 1 << 19, 2000   # bench_cest: 524,288 voxels × 2000 steps


def cest_case(nS, dtype, dev, *, nC=1, b1=True, df=True, T2b=0.01,
              gr=False, seed=0):
    r"""``blochsim_mc_rfgr`` inputs of the whole-brain CEST configuration
    of ``benchmarks/suite.py`` ``bench_cest`` (lines 719-733), from
    ``seed``: equilibrium pools, Δf ∈ [−300, 300] Hz, a B1 map, kab ∈
    [0.5, 5], kba = 50·kab, 5 mG CW rf at dt 2e-4. Options for the other
    kernel cases: ``nC`` coils (coil c phase-shifted by c·π/4, each at
    5 mG / nC), no B1 or Δf, another T2b, and ``gr`` a random 0.05 G/cm
    gradient over ±12 cm locations."""
    rng = np.random.default_rng(seed)

    def arr(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

    nT = CEST_NT
    Mia = arr(np.tile([0., 0., 1.], (1, nS, 1)))
    kab = rng.uniform(0.5, 5.0, (1, nS))
    kw = dict(T1a=1.2, T2a=0.06, T1b=1.0, T2b=T2b, kab=arr(kab),
              kba=arr(kab * 50.0), Ma0=1.0, Mb0=0.02, dfb=750.0, dt=2e-4)
    if df:
        kw['df'] = arr(rng.uniform(-300, 300, (1, nS)))
    if b1:
        kw['b1Map'] = arr(np.stack([0.7 + rng.random((1, nS, nC)) * .6,
                                    rng.random((1, nS, nC)) * .1 - .05], 2))
    ph = np.arange(nC) * np.pi / 4
    rf = np.broadcast_to(0.005 / nC * np.stack([np.cos(ph), np.sin(ph)])
                         [None, :, None, :], (1, 2, nT, nC))
    rf = rf[..., 0] if nC == 1 else rf
    loc, g = np.zeros((1, nS, 3)), np.zeros((1, 3, nT))
    if gr:
        loc = rng.uniform(-12, 12, (1, nS, 3))
        g = rng.normal(size=(1, 3, nT)) * 0.05
    return (Mia, 0.02 * Mia, arr(rf), arr(g), arr(loc)), kw


# The kernels' cases (phases 9, 10): label, voxels, dtype, cest_case
# keywords, timed.
MC_CASES = (
    ('512k x 2000, df+b1 (bench_cest)', CEST_NS, torch.float32, {}, True),
    ('64k x 2000, 2-coil b1, gr', 1 << 16, torch.float32,
     dict(nC=2, gr=True), False),
    ('64k x 2000, no df, no b1', 1 << 16, torch.float32,
     dict(b1=False, df=False), False),
    ('64k x 2000, MT bound pool (T2b 10 us)', 1 << 16, torch.float32,
     dict(T2b=1e-5), False),
    ('64k x 2000, df+b1, gr', 1 << 16, torch.float64, dict(gr=True), False))


def mc_args(nS, dtype, dev, kw):
    from mrphy_tpu_torch.ops import mc
    pos, kws = cest_case(nS, dtype, dev, **kw)
    return mc.mc_planes(*pos, **kws)


def phase_mc_fwd(dev):
    r"""``mc_fwd`` against its plain version on MC_CASES."""
    from mrphy_tpu_torch.kernels import mc as kmc
    rows = []
    for label, nS, dtype, kw, timed in MC_CASES:
        args = mc_args(nS, dtype, dev, kw)
        rows.append(compare('mc_fwd', lambda: kmc.mc_fwd(*args),
                            lambda: kmc.mc_fwd_torch(*args), dtype, label,
                            timed, args, plain_reps=3))
        del args
    return rows


MC_BWD_OUT = ('dmi', 'drf2', 'dgr2', 'dloc', 'ddfg', 'db1', 'dsb', 'dX',
              'dZ')


def phase_mc_bwd(dev):
    r"""``mc_bwd`` against its plain version on MC_CASES."""
    from mrphy_tpu_torch.kernels import mc as kmc
    cases = [(label, dtype, timed,
              functools.partial(mc_args, nS, dtype, dev, kw))
             for label, nS, dtype, kw, timed in MC_CASES]
    return compare_adjoint('mc_bwd', cases, kmc.mc_fwd, kmc.mc_bwd,
                           kmc.mc_bwd_torch, MC_BWD_OUT, 30)


def cest_fit_problem(dev):
    r"""The cest_fit problem in float64 on ``dev``: ``(zspectra, Zdata,
    rf, T2b)``, ``zspectra(kab_v, df0_v, rf, T2b)`` → `(nP, nV, nF)`."""
    from mrphy_tpu_torch.ops import mc
    c = CEST_FIT
    kab_true, df0_true, offsets, rf = (
        torch.as_tensor(x, dtype=torch.float64, device=dev)
        for x in cest_fit_arrays())
    nV, nF, nT = c['nV'], c['nF'], c['nT']
    nP, nM = rf.shape[0], nV * nF
    z = torch.zeros((), dtype=torch.float64, device=dev)
    gr, loc = z.expand(nP, 3, nT), z.expand(nP, nM, 3)
    Mia = torch.tensor([0., 0., c['Ma0']], dtype=torch.float64,
                       device=dev).expand(nP, nM, 3)
    Mib = Mia * (c['Mb0'] / c['Ma0'])
    off_pair = offsets.repeat(nV)

    def zspectra(kab_v, df0_v, rf, T2b):
        kab = kab_v.repeat_interleave(nF)[None]
        df = (df0_v.repeat_interleave(nF) - off_pair)[None]
        Ma, _ = mc.blochsim_mc_rfgr(
            Mia, Mib, rf, gr, loc, T1a=c['T1a'], T2a=c['T2a'],
            T1b=c['T1b'], T2b=T2b, kab=kab, kba=kab * (c['Ma0'] / c['Mb0']),
            Ma0=c['Ma0'], Mb0=c['Mb0'], dfb=c['dfb'], df=df, dt=c['dt'])
        return Ma[:, :, 2].reshape(nP, nV, nF) / c['Ma0']

    T2b = torch.tensor(c['T2b'], dtype=torch.float64, device=dev)
    return zspectra, zspectra(kab_true, df0_true, rf, T2b), rf, T2b


def phase_mc_path(dev):
    r"""Phase 11: ``blochsim_mc_rfgr`` through the entry point: (a) the
    cest_fit problem against JAX in float64, (b) the fused engine against
    the streaming oracle on the cest_zspectrum problem, (c) the
    full-width forward and fit step."""
    from mrphy_tpu_torch import gamH
    from mrphy_tpu_torch.design import DesignConfig, make_optimizer
    from mrphy_tpu_torch.ops import mc, slowsims
    out, bars = {}, {}
    # (a) the CEST fit against JAX, float64
    c = CEST_FIT
    zspectra, Zdata, rf, T2b = cest_fit_problem(dev)
    gold = torch.tensor(GOLDEN_CEST_Z, dtype=torch.float64)
    out['cest_fit_Z_vs_jax'] = max_err(Zdata[:, CEST_Z_VOXELS].cpu(), gold)
    bars['cest_fit_Z_vs_jax'] = 1e-10

    def loss(logk, dfs, rf, T2b):
        Z = zspectra(torch.exp(logk), c['df_scale'] * dfs, rf, T2b)
        return torch.mean((Z - Zdata) ** 2)

    xs = {'logk': torch.zeros(c['nV'], dtype=torch.float64, device=dev),
          'dfs': torch.zeros(c['nV'], dtype=torch.float64, device=dev),
          'rf': rf.clone(), 'T2b': T2b.clone()}
    for x in xs.values():
        x.requires_grad_()
    grads = dict(zip(xs, torch.autograd.grad(loss(**xs), list(xs.values()))))
    grads['rf'] = grads['rf'][..., CEST_RF_STEPS]
    for name, g in grads.items():
        key = f'cest_fit_grad_{name}_vs_jax'
        out[key] = (max_err(g.cpu(), torch.tensor(
            GOLDEN_CEST_GRAD[name], dtype=torch.float64))
            / GOLDEN_CEST_GRAD_MAX[name])
        bars[key] = 1e-9
    params = {k: torch.zeros(c['nV'], dtype=torch.float64, device=dev,
                             requires_grad=True) for k in ('logk', 'dfs')}
    opt = make_optimizer(DesignConfig(lr=c['lr']), params)
    losses = []
    for _ in range(c['niter']):
        opt.zero_grad()
        val = loss(params['logk'], params['dfs'], rf, T2b)
        val.backward()
        opt.step()
        losses.append(float(val.detach()))
    gold = torch.tensor(GOLDEN_CEST_LOSSES, dtype=torch.float64)
    out['cest_fit_adam_losses_vs_jax'] = float(
        ((torch.tensor(losses, dtype=torch.float64) - gold) / gold)
        .abs().max())
    bars['cest_fit_adam_losses_vs_jax'] = 1e-8
    out['cest_fit_losses'] = losses

    # (b) the Z-spectrum of examples/cest_zspectrum.py: 41 offsets, 2 s of
    # 5 mG CW saturation at dt 2e-4, fused engine against the oracle
    offs = np.linspace(-1.6 * 750, 1.6 * 750, 41)
    nT = 10000
    kw = dict(T1a=1.2, T2a=0.06, T1b=1.0, T2b=0.01, kab=1.0, kba=50.0,
              Ma0=1.0, Mb0=0.02, dfb=750.0, gam=gamH, dt=2e-4)
    ip, im = np.argmin(abs(offs - 750)), np.argmin(abs(offs + 750))
    i0 = np.argmin(abs(offs))
    for dtype in (torch.float64, torch.float32):
        def arr(x):
            return torch.as_tensor(x, dtype=dtype, device=dev)

        beff = np.zeros((1, 41, nT, 3))
        beff[0, :, :, 0] = 0.005
        beff[0, :, :, 2] = (-offs / gamH)[:, None]
        Ma = arr(np.tile([0., 0., 1.], (1, 41, 1)))
        Zo = slowsims.blochsim_mc(Ma, 0.02 * Ma, arr(beff), **kw)[0][0, :, 2]
        rfz = arr(np.broadcast_to(np.asarray([0.005, 0.])[None, :, None],
                                  (1, 2, nT)))
        Zf = mc.blochsim_mc_rfgr(Ma, 0.02 * Ma, rfz, arr(np.zeros((1, 3, nT))),
                                 arr(np.zeros((1, 41, 3))),
                                 df=arr(-offs[None]), **kw)[0][0, :, 2]
        tag = str(dtype)[6:]
        key = f'zspectrum_{tag}_fused_vs_oracle'
        out[key] = max_err(Zf, Zo)
        # float32: examples/cest_zspectrum.py's bar, a linear accumulation
        # of ~2e-7 of rounding per step
        bars[key] = 1e-10 if dtype == torch.float64 else max(1e-5, 2e-7 * nT)
        out[f'zspectrum_{tag}_mtr_asym'] = float(Zf[im] - Zf[ip])
        out[f'zspectrum_{tag}_Z0'] = float(Zf[i0])
        check(out[f'zspectrum_{tag}_mtr_asym'] > 0.02, 'no CEST effect')
        check(out[f'zspectrum_{tag}_Z0'] < 0.5, 'no direct saturation')

    # (c) full width: 512k voxels × 2000 steps, float32
    pos, kws = cest_case(CEST_NS, torch.float32, dev)
    kab = kws.pop('kab')

    def fwd():
        return mc.blochsim_mc_rfgr(*pos, kab=kab, **kws)

    def fit_step():
        k = kab.clone().requires_grad_()
        Ma, _ = mc.blochsim_mc_rfgr(*pos, kab=k, **kws)
        return torch.autograd.grad(Ma.sum(), k)[0]

    Ma, Mb = fwd()
    gk = fit_step()
    torch.cuda.synchronize()
    check(tuple(Ma.shape) == (1, CEST_NS, 3) and bool(
        torch.isfinite(Ma).all()) and bool(torch.isfinite(Mb).all()),
        'full-width forward')
    check(bool(torch.isfinite(gk).all()) and float(gk.abs().max()) > 0,
          'full-width fit-step gradient')
    del Ma, Mb, gk
    times = {}
    for name, fn in (('fwd', fwd), ('fit_step', fit_step)):
        torch.cuda.reset_peak_memory_stats(dev)
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        times[name] = (statistics.median(ts) * 1e3,
                       torch.cuda.max_memory_allocated(dev) / 1e9)
    out.update(fwd_ms=times['fwd'][0], fit_step_ms=times['fit_step'][0],
               fwd_voxel_steps_per_s=CEST_NS * CEST_NT / times['fwd'][0] * 1e3,
               fwd_peak_mem_gb=times['fwd'][1],
               fit_step_peak_mem_gb=times['fit_step'][1])
    print('mc path: ' + json.dumps(dict(measured=out, bars=bars)),
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
    from mrphy_tpu_torch.kernels import mc as kmc

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
    mc_fwd_rows = phase_mc_fwd(dev)
    mc_bwd_rows = phase_mc_bwd(dev)

    # the forward path, the gradient and design path, and the two-pool
    # path: each with the launch counts zeroed just before it and read
    # just after
    counters = {**{k: bloch.LAUNCHES for k in bloch.LAUNCHES},
                **{k: kmc.LAUNCHES for k in kmc.LAUNCHES}}
    launches = {k: 0 for k in counters}
    for path, run, needs in (
            ('forward', phase_main_path, ('rfgr_fwd', 'beff_fwd')),
            ('gradient+design', lambda d: (phase_gradients(d),
                                           phase_design(d)),
             tuple(bloch.LAUNCHES)),
            ('two-pool', phase_mc_path, tuple(kmc.LAUNCHES))):
        for k, table in counters.items():
            table[k] = 0
        run(dev)
        counts = {k: table[k] for k, table in counters.items()}
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
                       ('beff_bwd', beff_bwd_rows),
                       ('mc_fwd', mc_fwd_rows), ('mc_bwd', mc_bwd_rows)):
        head = rows[0]   # the float32 timed case at the main path's shape
        err = 'max_abs_err_chk' if name.endswith('fwd') else 'max_abs_err'
        f32 = [r for r in rows if r['dtype'] == 'float32']
        kernels.append(dict(
            name=name, route='cuda', **KERNELS[name],
            launches=launches[name],
            max_abs_err=max(r[err] for r in f32),
            ms=head['ms'], plain_ms=head['plain_ms'],
            bound_ms=head['bound_ms'], bound_by=head['bound_by'],
            # no single PyTorch call computes a Bloch simulation
            library_ms=None))
        if name.endswith('bwd') and name != 'beff_bwd':
            # the rows: max|Δ| / max|row|
            kernels[-1]['max_row_rel_err'] = max(
                r['max_row_rel_err'] for r in f32)
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
