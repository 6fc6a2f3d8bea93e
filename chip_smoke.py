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

12. The k-space signal kernels ``sig_fwd``, ``sig_adj`` and ``sig_vjp``
    against their plain versions on the arguments ``ops.signal`` gives
    them: the configuration of ``benchmarks/suite.py`` ``bench_signal``
    (262,144 spins × 16,384 samples × 8 coils, Δf ∈ ±100 Hz, T2* ∈ [5, 50]
    ms, float32, timed; the plain versions' reductions run on cuBLAS, the
    counterpart of the JAX package's default XLA route); at 16,384 spins ×
    4,096 samples one coil without maps, 32 coils (one row block of the
    tensor-core kernels, four coil groups of sig_vjp), 64 coils (two row
    blocks), neither Δf nor T2*, N = 3 with broadcast inputs, ragged sizes
    (16381 × 4093) with per-batch inputs, and the float64 instance.
    ``SIG_BAR`` on the linear outputs, ``SIG_CHAIN_BAR`` on the
    phase-chain cotangents. Each row names its route (``sig_fwd``/
    ``sig_adj``: split-TF32 ``mma.sync`` in float32, FP64 ``mma.sync`` in
    float64; ``sig_vjp``: CUDA cores); at bench_signal a second launch of
    ``sig_fwd`` and ``sig_adj`` must give the same bits, and their bound
    counts the coil sums at the tensor cores' TF32 rate (``tc_bound``; the
    bound with every operation at the float32 rate stays beside it). One
    more case scales k on half of the samples by 3·10⁵ (|φ| to ~2²⁵
    cycles), so that one launch of the float32 kernels takes the fast sign
    and the exact one.
13. The acquisition path through the entry points: (a) the
    ``examples/recon_sense.py`` problem (32×32, 4 coils, spiral-out, Δf
    ±40 Hz, CG-SENSE 40 iterations) in float64 against the JAX package's
    results (literals below: the signal at 1e-10 and ∂Σs²/∂ktraj at 1e-9
    of their largest value, the image at 1e-9) and its image bound (1%)
    in both types; (b) a 64³ ``SpinCube`` excited (``applypulse``) then
    read (``acquire``, 8 coils, T2*, 16,384 samples), and a 4,096-spin
    cube's ``acquire`` against the Bloch simulator stepped through the
    readout (float64, 1e-10); (c) CG-SENSE at ``bench_recon`` width
    (128×128, 8 coils, ~29k samples, 10 iterations, float32): image error
    and seconds per iteration; (d) ``signal``, ``signal_adjoint`` and
    ∂Σs²/∂(ktraj, M) at ``bench_signal`` width: times, spin-samples per
    second and peak memory.
14. The gridding NUFFT kernels ``nufft_sample``, ``nufft_spread`` and
    ``nufft_dk`` against their plain versions on the arguments
    ``ops.nufft`` gives them (``NUFFT_CASES``): the full-width 3-D case,
    ``examples/recon3d.py``'s plan at n = 128 (192³ grid, W 4) on its
    koosh-ball trajectory at 8192 spokes (2,285,568 samples), float32,
    timed with both versions and with the library yardstick
    (``torch.sparse.mm`` of the interpolation matrix for the sample, of its
    transpose for the spread, built once); the same nT drawn uniform at
    random (the spread's contention at the centre of k-space, timed);
    ``bench_nufft3d`` (96³, osf 1.25, 32k samples) and ``bench_nufft`` (128²,
    W 5, 32k samples), timed; a 1-D case, a W 7 case (the kernels'
    run-time-width instance), a batch with per-entry trajectories, a
    float64 batch with a shared trajectory and the float64 recon3d plan. max|Δ|/max|plain| at ``NUFFT_BAR`` for the sample and
    the trajectory cotangent; the spread (binned, deterministic) sums by
    bin, subproblem and sample, another order than ``index_add_``'s, held
    at :func:`atomic_bar` of the most taps that meet at one point, its
    grid from a second launch equal bit for bit on every case and, on the
    float64 batch, under ``torch.use_deterministic_algorithms(True)``; the
    timed cases also time its binning (``bin_ms``) and read its peak.
15. The gridding path through the entry points: (a) the
    ``examples/recon3d.py`` problem in float64 (32³, 1200 spokes, data
    from the exact operator ``signal`` plus 1% noise, |k|² density
    weights, gridding, 12 CG iterations on the exact Toeplitz kernel)
    against the JAX package's results (literals below, at 1e-9 of their
    largest values; the CG image after 4 iterations at 1e-9 and after
    12 at ``RECON3D_CG_BAR``, as the iteration amplifies rounding), and
    ``dcf_pipe_menon`` of its trajectory (``nufft_spread`` then
    ``nufft_sample``, 30 iterations) against JAX's weights at 1e-9;
    against the exact operator (K7, K9) at the plan's measured accuracy,
    with the example's asserts; (b) the
    ``examples/recon_sense.py --op nufft`` problem in float64 (W 5, Δf
    through 12 segments, 4 coils on the batch axis) against JAX literals:
    the signal, ∂Σs²/∂ktraj (``nufft_dk``) and the 40-iteration CG-SENSE
    image; (c) the 64³ cube excited (``applypulse``) then read through
    ``acquire(backend='nufft', width=6, nseg=16)`` with 8 coils against
    the exact ``acquire`` at the JAX test's 1e-3, times of both; (d) at the
    full-width 3-D case, ``nufft``, ``nufft_adjoint``, ∂Σ|s|²/∂ktraj and a
    CG iteration ``nufft_adjoint(nufft(·))``: times, samples per second,
    peak memory, and the plan against the exact operator on a 16,384-
    sample subset; (e) CG-SENSE at ``bench_recon`` width through the NUFFT
    (data from the exact operator): seconds per iteration, and the image
    error held at 1e-2 (the exact route's is 2.49e-3).

16. The SPGR / MRF-FISP EPG kernels ``spgr_fwd``, ``spgr_fwd_chk`` and
    ``spgr_bwd`` against their plain versions on the arguments
    ``ops.epg.epg_spgr`` gives them (``EPG_CASES``): the configuration of
    ``benchmarks/suite.py`` ``bench_mrf_fisp`` (65,536 atoms × 400 TRs, K
    48, rf-spoiled phases, IR prep, variable TR, float32), without and with
    spoiler diffusion, timed; the trains phase 18 gives the kernels (the
    ``bench_mrf_pipeline`` dictionary, 62,325 atoms × 400 TRs at K 48 with
    constant TR, and its refinement's 4096 atoms at K 16); constant TR with
    b1, kshift −1 and 2, the default K (the state in device memory, on the
    adjoint's one-thread route), a ragged atom count and float64 cases, all
    at the entry point's chunk (``adjoint_tc``: 5 TRs at bench_mrf_fisp,
    the adjoint on its lane route, whose G, M, S each row reports), and
    ``spgr_fwd_chk`` timed also at ``pick_tc``'s chunk (25 there); where
    ``spgr_fwd_chk`` takes its lane route (``forward_cfg`` at 6 planes: 8
    lanes an atom at K 48 and 16, all but the default-K cases), also on one
    thread per atom, bit for bit, both timed. Per-atom
    outputs (echoes, checkpoints, per-atom gradient rows) at ``EPG_BAR`` of
    their largest value, the adjoint's per-TR rows (sums over atoms) at
    ``EPG_ROW_BAR``; then the forward and the full gradient (w.r.t. T1, T2,
    tr, and D) through ``epg_spgr`` at full width, timed.
17. The matched filter ``match`` against its plain version at
    ``bench_mrf_pipeline`` width (62,325 compressed atoms and their
    rotation, 1,048,576 compressed probes, rank 16, float32), timed beside
    the library yardstick (one ``torch.matmul`` per probe chunk against
    the stacked atoms, ``amax``/``argmax``, TF32 off), and on real, ragged
    and float64 cases: ``best`` at ``MATCH_BAR`` of the largest score,
    ``idx`` equal wherever the two atoms' scores differ by more than that
    (the count of such near-tie flips printed).
18. The MRF path through the entry points: (a) ``bench_mrf_pipeline``:
    the ``epg_spgr`` dictionary, ``svd_basis`` (rank 16), ``compress`` and
    ``dict_match_compressed`` over 1M synthetic voxels, timed (voxels per
    second), the matched T1/T2 error, and ``match_refine(batched=True)``
    of 4096 voxels (50 Adam steps), timed, with its error; (b) the
    ``examples/mrf_dictionary.py`` SPGR problem in float64 against the
    JAX package's results (literals below, from
    ``tests/make_mrf_goldens.py``): the dictionary at 1e-10, the basis
    rank and the matched atoms equal, ``m0`` at 1e-10, the 250-step
    refinement's parameters and score at rtol 1e-8.
19. The CPMG echo-train kernels ``cpmg_fwd``, ``cpmg_fwd_chk`` and
    ``cpmg_bwd`` against their plain versions on the arguments
    ``ops.epg.epg_cpmg`` gives them (``CPMG_CASES``): the full-width T2
    map of phase 20 (1,048,576 voxels × 32 echoes, K 33, b1, float32) and
    ``bench_mrf``'s CPMG dictionary train (65,536 atoms × 32 echoes,
    flips 120–180°), timed; an esp train with diffusion, a per-voxel
    excitation (slice profile) with M0, b1, a ragged atom count, a long
    train whose state lives in device memory (K 401) and float64 cases.
    Per-atom outputs (echoes, checkpoints, the eight per-atom gradient
    rows) at ``EPG_BAR`` of their largest value, the per-echo rows at
    ``EPG_ROW_BAR``; the plain adjoint is written out (no autograd graph
    at full width). ``cpmg_fwd_chk`` takes its lane route
    (``cpmg_fwd_lanes.cu``) where ``kernels.epg.forward_cfg`` at 6 planes
    gives it, ``cpmg_bwd`` its own where ``adjoint_cfg`` does, at the
    entry point's chunk (tc 4 at the T2 map); each row names its route, and
    each lane case is also run on one thread per atom: the forward's
    echoes and checkpoints bit for bit, the adjoint's per-atom outputs at
    ``EPG_BAR`` and its rows at ``EPG_ROW_BAR`` (another summation
    order).
20. The T2-mapping path through ``epg_cpmg``: (a) at full width
    (``T2MAP``), the forward timed in voxels per second, the gradient of
    the echo magnitudes' squared error w.r.t. T2, M0 and b1 timed, and 50
    Adam steps of the (log T2, M0, b1) fit: s per step, voxels per second
    per gradient step, peak memory, the median relative T2 error (bar
    0.1); (b) the ``examples/dwi_adc_fit.py`` problem in float64 through
    the shared train (the float64 kernels) against the JAX package's
    results (literals below, from ``tests/make_cpmg_goldens.py``): the
    target magnitudes at 1e-10, the first loss at 1e-10 and its gradient
    at 1e-9, the 400 Adam steps' losses and fitted parameters at rtol
    1e-8 (on an H100 the port met JAX at 4.5e-13 and 3.3e-16: these 400
    steps do not amplify the rounding, so 1e-8 leaves room for a change of
    summation order without hiding a wrong gradient).
21. The two-pool EPG-X kernels ``xspgr_fwd``, ``xspgr_fwd_chk`` and
    ``xspgr_bwd`` against their plain versions on the arguments
    ``ops.epg.epgx_spgr`` gives them (``XSPGR_CASES``): ``bench_mrf``'s
    two-pool dictionary (65,536 atoms × 400 TRs, K 48, tr 12 ms, float32),
    timed, with its bound; float64, per-atom b1, per-atom dfb, kshift −1
    with per-atom M0b, kshift 2 at K 37 and 9 at K 24 (past the 8 lanes of
    the forward's lane route), no detailed balance, a ragged atom count,
    the default K with the state in device memory, and the segments phase
    22a gives the kernels (its dictionary's two, 65,536 atoms × 200 TRs at
    K 48, and its refinement's first step, 4096 grid atoms in one chunk).
    ``xspgr_fwd_chk`` takes its lane route (``xspgr_fwd_lanes.cu``) or one
    thread per atom (the default K) as ``kernels.epg.forward_cfg`` gives,
    its rows naming the route (``forward``). Per-atom outputs (echoes,
    checkpoints, the 17 per-atom gradient rows) at ``EPG_BAR`` of their
    largest value (bit for bit expected; the rows that differ are named),
    the adjoint's per-TR rows at ``XSPGR_ROW_BAR`` (5e-7 in float32, 1e-15
    in float64).
22. The exchange-MRF path through ``epgx_spgr``: (a) at full width
    (``XMRF_PIPE``: ``examples/mrfx_exchange.py``'s pool and flips, two
    200-TR segments at a scalar tr, a 256 × 256 (T1a, kab) dictionary of
    65,536 atoms, 1,048,576 probe voxels), the dictionary timed in atoms
    per second, the rank-16 compression and match in voxels per second
    with the matched maps' median errors (bars 1.5 grid steps on T1a and
    3 on kab; 1.5 on both axes for 4096 of the probes matched again in
    float64, since float32 does not resolve the kab grid), 50 Adam steps of
    ``match_refine(batched=True)`` on 4096 voxels
    (s per step; both median errors must fall), peak memory and the
    example's exchange-sensitivity check (> 2%); (b) the
    ``examples/mrfx_exchange.py`` problem at a scalar tr in float64 through
    the float64 kernels against the JAX package's results (literals below,
    from ``tests/make_epgx_goldens.py``): the dictionary at 1e-10, the rank
    and matched atom equal, the kab separation at 1e-10, the first loss and
    its gradient at 1e-9, the 250 Adam steps' losses at 1e-8 of the first
    and the fitted (T1a, kab) at rtol 1e-8.
23. The variable-TR EPG-X kernels ``xspgr_v_fwd``, ``xspgr_v_fwd_chk`` and
    ``xspgr_v_bwd`` against their plain versions on the arguments
    ``ops.epg.epgx_spgr`` gives them over a ``(nTR,)`` tr train
    (``XSPGR_V_CASES``: ``coef``, ``pk`` and the per-step propagator planes
    ``pkt``): ``bench_mrf``'s variable-TR two-pool train (65,536 atoms ×
    400 TRs, K 24, tr 12 ms + 6 ms·U(0, 1), float32), timed, with its
    bound; the trains phase 24a gives the kernels (its dictionary's two
    segments, 65,536 × 200 at K 48 over the example's tr train and its
    reverse, and its refinement's first step, 4096 grid atoms in one
    chunk); float64 with b1, dfb, M0b and rf-spoiled phases, kshift −1
    with M0b, no detailed balance, a ragged atom count, the default K with
    the state in device memory (float32 and float64), and a constant train,
    whose echoes must also equal ``xspgr_fwd``'s at the same scalar tr;
    routes as phase 21's.
    Per-atom outputs (echoes, checkpoints, ``dpar`` = [dM0a, dM0b, db1] and
    the per-step entry gradients ``dpkt``) at ``EPG_BAR`` (bit for bit
    expected; the rows that differ are named), the per-TR rows at
    ``XSPGR_ROW_BAR``; then the full-width train through ``epgx_spgr``, the
    forward and the gradient of Σ signals² w.r.t. (T1a, kab), timed, with
    the gradient's peak memory.
24. The exchange-MRF path through ``epgx_spgr`` over
    ``examples/mrfx_exchange.py``'s variable-TR schedule (12–18 ms, the
    second segment on the train reversed): (a) phase 22a's pipeline at the
    same full width and bars (``xspgr_v_fwd`` for the dictionary and the
    probes, ``xspgr_v_fwd_chk`` + ``xspgr_v_bwd`` for the refinement); (b)
    the example's problem at its own schedule in float64 through the
    float64 kernels against the JAX package's results (literals below, from
    ``tests/make_epgxv_goldens.py``), at phase 22b's bars.
25. The two-pool EPG-X CPMG kernels ``xcpmg_fwd``, ``xcpmg_fwd_chk`` and
    ``xcpmg_bwd`` against their plain versions on the arguments
    ``ops.epg.epgx_cpmg`` gives them (``XCPMG_CASES``): the whole-brain MWF
    map's forward (1,048,576 voxels × 32 echoes, K 33, the π train scaled
    by a b1 map, float32; ``xcpmg_fwd`` only, as the path runs it), the
    fit's 262,144-voxel block (tc 4) and ``bench_mrf``'s EPG-X CPMG
    dictionary uncut (65,536 atoms × 32 echoes, flips 120–180°), timed with
    their bounds; the accuracy fit's 4096 voxels; float64 with dfb, phi_ex,
    M0b and b1 at tc 1 and 3, no exchange (kab = kba = 0) at tc = nE,
    ragged atom counts, and K 161 (float32) and 81 (float64) with the state
    in device memory. The chunk is the entry point's (``adjoint_tc``: 4
    echoes at the block, the adjoint on its lane route) where none is
    named; each adjoint row reports its route (float64 at K 33, tc = nE and
    K 161/81 keep one thread per atom), each ``xcpmg_fwd_chk`` row its
    forward's (``xcpmg_fwd_lanes.cu`` where ``kernels.epg.forward_cfg``
    takes the lanes, float64 K 33 among them; one thread per atom at K
    161/81). Per-atom outputs (echoes,
    checkpoints, the 19 per-atom gradient rows) at ``EPG_BAR`` (bit for
    bit expected; the rows that differ are named), the per-echo rows at
    ``XCPMG_ROW_BAR``.
26. The myelin-water path through ``epgx_cpmg`` (``examples/mwf_fit.py``'s
    protocol, ``MWF``): (a) at whole-brain width (``MWF_MAP``, 1,048,576
    voxels, float32, ``backend='auto'`` on CUDA tensors) the forward at the
    truth, timed in voxels per second; 10 Adam steps of the fit of the log
    pools over the noisy map, each over four 262,144-voxel blocks: s per
    step, voxel-echoes per second, peak memory, the loss must fall; the
    example's 800 iterations on the map's first 4096 voxels: median |MWF
    error| < 0.01 and < 0.5 × the naive baseline's; (b) the example at its
    defaults (24 voxels, 800 iterations) in float64 through the float64
    kernels against the JAX package's results (literals below, from
    ``tests/make_mwf_goldens.py``): the noiseless echoes, the first loss
    and its gradient at 1e-10, the losses and fitted MWF at 100× JAX's own
    response to a 1-ulp change of the data (``MWF_EX_ULP``), and the
    example's asserts.
27. The echo-spacing EPG-X CPMG kernels ``xcpmg_v_fwd``,
    ``xcpmg_v_fwd_chk`` and ``xcpmg_v_bwd`` against their plain versions
    on the arguments ``ops.epg.epgx_cpmg`` gives them over a ``(nE,)`` esp
    train (``XCPMG_V_CASES``: ``coef``, ``pk`` and the per-echo planes
    ``pkt``, trains of 8–18 ms): the whole-brain map's forward (1,048,576 ×
    32, K 33, b1; ``xcpmg_v_fwd`` only, as the path runs it), the fit's
    262,144-voxel block and ``bench_mrf``'s EPG-X CPMG dictionary (65,536 ×
    32), timed with their bounds; float64 with dfb, phi_ex, M0b and b1 at
    tc 1 and 3 (ragged), no exchange, K 161 with the state in device
    memory, and a constant 10 ms train, whose echoes must also equal
    ``xcpmg_fwd``'s at the scalar esp; chunks and routes as phase 25's.
    Per-atom outputs (echoes,
    checkpoints, ``dpar`` = [d cos φ_ex, d sin φ_ex, dM0a, dM0b, db1] and
    the per-echo entry gradients ``dpkt``) at ``EPG_BAR`` (bit for bit
    expected), the per-echo rows at ``XCPMG_ROW_BAR``.
28. The myelin-water path over an echo-spacing train (``MWF_V``: echoes
    1–16 at 6 ms, 17–32 at 14 ms): (a) phase 26a's map and fit at the same
    width through ``epgx_cpmg`` (``xcpmg_v_fwd``; ``xcpmg_v_fwd_chk`` +
    ``xcpmg_v_bwd`` per block); (b) 24 voxels of the example's tissue in
    float64 through the float64 kernels against the JAX package's results
    (literals below, from ``tests/make_xcpmgv_goldens.py``): the echoes at
    1e-10, the gradient of a weighted echo sum w.r.t. the esp train and
    the log pools at 1e-9; (c) after the launch counts of (a) and (b) are
    read, the forward's parts timed apart: the kernels' arguments, the
    per-echo planes among them, and ``xcpmg_v_fwd`` alone.
29. The balanced-SSFP kernels ``bssfp_fwd``, ``bssfp_fwd_chk`` and
    ``bssfp_bwd`` against their plain versions on the arguments
    ``ops.ssfp.bssfp_train`` gives them (``BSSFP_CASES``: ``coef`` and
    ``pk``): ``bench_bssfp_fit``'s shape (1,048,576 voxels × 200 TRs at tr
    4–6 ms, float32; all three timed with their bounds) and ``bench_mrf``'s
    bSSFP dictionary (65,536 × 400, tr 10–13 ms, df ±80 Hz; ``bssfp_fwd``,
    timed); a constant tr with per-atom b1, the α/2-catalysed 201-TR train
    over three chunks, a ragged atom count with b1, tr and te trains and
    explicit phases at tc 1, and float64 instances of the b1 and
    catalysed cases. Per-atom outputs (echoes, checkpoints, ``dpk``) at
    ``EPG_BAR`` (bit for bit expected), the per-TR rows at
    ``BSSFP_ROW_BAR``.
30. The balanced-SSFP path through ``bssfp_train``: (a) ``BSSFP_FIT``, the
    direct bSSFP fit at ``bench_bssfp_fit``'s width: the forward at the
    truth in voxels per second, the first step's gradients on 16,384
    voxels against the plain route at 1e-5, 5 Adam steps of
    ``examples/bssfp_fit.py``'s parameters (s per step, voxel-TRs per
    second, peak memory; the loss must fall); (b) ``examples/bssfp_fit.py``
    at its defaults in float64 through the float64 kernels against the JAX
    package's results (literals below, from
    ``tests/make_bssfp_goldens.py``): the data, the first loss and its
    gradient at 1e-10, the 400 Adam steps' losses and fitted maps at 100×
    JAX's own response to a 1-ulp change of the data (``BSSFP_EX_BAR``),
    and the example's asserts; (c) ``examples/mrf_dictionary.py --seq
    bssfp`` in float64 (the constant-TR kernels; ``match``; the refinement
    through ``bssfp_fwd_chk`` + ``bssfp_bwd``) against JAX's results: the
    dictionary and m0 at 1e-10, the rank and matched atoms equal, the
    refined parameters and score at rtol 1e-8 and the fit as the example
    prints it; ``bssfp_steady`` against the last echo of a 6000-TR train
    over ``examples/bssfp_banding.py``'s tissue at 33 df (1e-10); (d)
    after the launch counts are read, 30a's forward split into the
    kernels' arguments, ``bssfp_fwd`` alone and the echoes' layout.
31. The EPG-X(MT) kernels ``xmt_fwd``, ``xmt_fwd_chk`` and ``xmt_bwd``
    against their plain versions on the arguments ``kernels.epgx.xmt_spgr``
    gives them (``XMT_CASES``: ``coef`` with the wt train, ``pk`` with the
    per-atom ``wscale``): phase 32a's qMT dictionary (65,536 atoms × 400
    TRs, K 48, float32; all three timed with their bounds); 16,384 × 200
    with b1, with kshift −1 and without detailed balance; wt ≡ 0 without
    exchange, whose echoes must also equal ``spgr_fwd``'s (pool a alone);
    the default K 401 with the state in device memory; a ragged atom count
    over three chunks of 67 TRs; float64 with b1 and ``wscale``. Per-atom
    outputs (echoes, checkpoints, ``dpk``) at ``EPG_BAR`` (bit for bit
    expected), the per-TR rows at ``XMT_ROW_BAR``. The chunk is the entry
    point's (``kernels.epg.adjoint_tc`` at 8 planes: tc 5 at the
    dictionary), ``xmt_bwd`` on its lane route (``xmt_bwd_lanes.cu``)
    where ``adjoint_cfg`` gives it (one thread per atom at K 401, at the
    ragged case's tc 67 past S); each row names its route, and each lane
    case also runs on one thread per atom (per-atom outputs at ``EPG_BAR``,
    rows at ``EPG_ROW_BAR``: another summation order).
32. The qMT path: (a) ``QMT_DICT``, a 64 F × 32 kba × 32 T2b dictionary
    at ``examples/qmt_fit.py``'s pool over 400 TRs with a cycling
    saturation power, through ``xmt_spgr`` (``xmt_fwd``) in atoms per
    second and against the plain route on 4096 atoms; ``svd_basis``,
    ``compress`` and ``match`` of 1M probes drawn from the atoms with a
    random phase and noise (the fractions within one grid step per axis);
    the protocol gradient w.r.t. the flips, the wt train and the per-atom
    (F, kba, T2b) at full width (``xmt_fwd_chk`` + ``xmt_bwd``; ms, peak
    memory; against the plain route on 4096 atoms); 50 Adam steps of
    ``match_refine(batched=True)`` on 4096 probes (the median errors of F,
    kba and T2b); (b) ``examples/qmt_fit.py`` at its defaults in float64
    against the JAX package's results (literals below, from
    ``tests/make_qmt_goldens.py``): the data, the first loss and its
    gradient w.r.t. the log maps at 1e-10 on the plain route (the
    example's batched wt) and on the kernels' rank-1 form (a constant wt
    train per power, ``wscale`` the lineshape); the 600 Adam steps through
    the kernels: the losses and fitted maps at 100× JAX's own response to a
    1-ulp change of the data (``QMT_EX_ULP``) and the example's asserts.
33. The variable-TR EPG-X(MT) kernels ``xmt_v_fwd``, ``xmt_v_fwd_chk`` and
    ``xmt_v_bwd`` against their plain versions on the arguments
    ``xmt_spgr`` gives them over a ``(nTR,)`` tr train (``XMT_V_CASES``:
    ``pk`` = [M0a, M0b, b1, wscale] and the per-TR planes ``pkt``): phase
    34a's fingerprinting dictionary (65,536 × 400, K 48, float32; all three
    timed with their bounds); the refinement's 4096 atoms in one chunk;
    16,384 × 200 with b1, kshift −1, without detailed balance, and wt ≡ 0
    without exchange (also against ``spgr_fwd`` over the train); a constant
    30 ms train, also against the scalar-tr kernels ``xmt_fwd``,
    ``xmt_fwd_chk`` and ``xmt_bwd``; the default K 401 with the state in
    device memory; a ragged atom count over three chunks; float64 with b1
    and ``wscale``. Per-atom outputs (echoes, checkpoints, ``dpk``, ``dpkt``)
    at ``EPG_BAR``, the per-TR rows at ``XMT_ROW_BAR``; chunks, routes and
    the one-thread check as phase 31's.
34. The qMT fingerprinting path over a variable-TR train: (a) phase 32a's
    path (``QMT_DICT``) over ``QMT_V``'s train tr_t = 12 ms + 6 ms·u_t
    through the variable-TR kernels: the dictionary in atoms per second,
    1M probes matched, 50 refinement steps and the protocol gradient w.r.t.
    the flips, the wt train, the tr train and the per-atom (F, kba, T2b)
    at full width and, in float64 on 4096 atoms, against the plain route;
    (b) ``examples/qmt_fit.py``'s problem over the train 30 ms + 5
    ms·sin(2πt/37) in float64 against the JAX package's results (literals
    below, from ``tests/make_qmtv_goldens.py``): the echoes, the data, the
    first loss and its gradient w.r.t. the log maps and the tr train at
    1e-10, 20 Adam steps' losses at 1e-9; (c) after the launch counts are
    read, 34a's dictionary split into the rows, the per-TR planes and
    ``xmt_v_fwd``, and the memory the planes keep for the backward with and
    without ``torch.utils.checkpoint``.

Launch counts are zeroed right before the forward path (phase 4) and read
after it (``rfgr_fwd``, ``beff_fwd`` must have launched), zeroed again
before the gradient and design path (phases 7–8) and read after it (all
four Bloch kernels must have launched), again before the two-pool path
(phase 11; ``mc_fwd`` and ``mc_bwd`` must have launched), and again before
the acquisition path (phase 13; ``sig_fwd``, ``sig_adj``, ``sig_vjp`` and
``rfgr_fwd`` must have launched), and again before the gridding path
(phase 15; ``nufft_sample``, ``nufft_spread`` and ``nufft_dk`` must have
launched), and again before the MRF path (phase 18; ``spgr_fwd``,
``spgr_fwd_chk``, ``spgr_bwd`` and ``match`` must have launched), and
again before the T2-mapping path (phase 20; ``cpmg_fwd``, ``cpmg_fwd_chk``
and ``cpmg_bwd`` must have launched), and again before the exchange-MRF
path (phase 22; ``xspgr_fwd``, ``xspgr_fwd_chk``, ``xspgr_bwd`` and
``match`` must have launched), and again before the exchange-MRF path at
variable TR (phase 24; ``xspgr_v_fwd``, ``xspgr_v_fwd_chk``,
``xspgr_v_bwd`` and ``match`` must have launched), and again before the
myelin-water path (phase 26; ``xcpmg_fwd``, ``xcpmg_fwd_chk`` and
``xcpmg_bwd`` must have launched), and again before the myelin-water path
over an esp train (phase 28; ``xcpmg_v_fwd``, ``xcpmg_v_fwd_chk`` and
``xcpmg_v_bwd`` must have launched), and again before the balanced-SSFP
path (phase 30; ``bssfp_fwd``, ``bssfp_fwd_chk``, ``bssfp_bwd`` and
``match`` must have launched), and again before the qMT path (phase 32a;
``xmt_fwd``, ``xmt_fwd_chk``, ``xmt_bwd`` and ``match`` must have
launched, each its exact count), and again before the qMT path over a tr
train (phase 34a; ``xmt_v_fwd``, ``xmt_v_fwd_chk``, ``xmt_v_bwd`` and
``match``, each its exact count, and ``xmt_*`` none). Phases 30b–c, 32b and
34b, the float64 examples, run in windows of their own, checked and left
out of the ``kernels`` line. The comparisons with the plain versions
(phases 2, 3, 5, 6, 9, 10, 12, 14, 16, 17, 19, 21, 23, 25, 27, 29, 31, 33)
run before and are not counted.

The line before the last is one JSON object with each kernel's launches
on those paths, error, times and bound: ``bound_ms`` is the larger of the
bytes of its timed float32 case (inputs read once, outputs written once)
over 3.35 TB/s and the arithmetic of its plain version on the same
inputs (:func:`count_ops`) over 67 TFLOP/s; ``library_ms`` is null, as no
single PyTorch call computes a Bloch simulation, the off-resonance- and
decay-weighted non-uniform encoding, the NUFFT's trajectory cotangent,
an EPG train or a bSSFP train; for the NUFFT's sample and spread it is the
time of ``torch.sparse.mm`` of the interpolation matrix (cuSPARSE), for the
matched filter that of one ``torch.matmul`` per probe chunk against the
stacked atoms, then ``amax``/``argmax``; the port calls neither. The
NUFFT rows add ``sector_ms``, the gather's 32-byte-sector traffic over
3.35 TB/s. The last line is the contract line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count":
...}}``.
"""

import contextlib
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
    'sig_fwd': dict(source='mrphy_tpu_torch/kernels/csrc/sig_fwd.cu',
                    replaces='mrphy_tpu/ops/signal_pallas.py:311'),
    'sig_vjp': dict(source='mrphy_tpu_torch/kernels/csrc/sig_vjp.cu',
                    replaces='mrphy_tpu/ops/signal_pallas.py:369'),
    'sig_adj': dict(source='mrphy_tpu_torch/kernels/csrc/sig_adj.cu',
                    replaces='mrphy_tpu/ops/signal_pallas.py:414'),
    'nufft_sample': dict(
        source='mrphy_tpu_torch/kernels/csrc/nufft_sample.cu',
        replaces='mrphy_tpu/ops/nufft_pallas.py:223'),
    'nufft_spread': dict(
        source='mrphy_tpu_torch/kernels/csrc/nufft_spread.cu',
        replaces='mrphy_tpu/ops/nufft_pallas.py:291'),
    'nufft_dk': dict(source='mrphy_tpu_torch/kernels/csrc/nufft_dk.cu',
                     replaces='mrphy_tpu/ops/nufft_pallas.py:392'),
    'spgr_fwd': dict(source='mrphy_tpu_torch/kernels/csrc/spgr_fwd.cu',
                     replaces='mrphy_tpu/ops/epg_pallas.py:1644'),
    'spgr_fwd_chk': dict(
        source='mrphy_tpu_torch/kernels/csrc/spgr_fwd_lanes.cu',
        replaces='mrphy_tpu/ops/epg_pallas.py:1558'),
    'spgr_bwd': dict(
        source='mrphy_tpu_torch/kernels/csrc/spgr_bwd_lanes.cu',
        replaces='mrphy_tpu/ops/epg_pallas.py:1593'),
    'match': dict(source='mrphy_tpu_torch/kernels/csrc/match.cu',
                  replaces='mrphy_tpu/ops/mrf_pallas.py:142'),
    'cpmg_fwd': dict(source='mrphy_tpu_torch/kernels/csrc/cpmg_fwd.cu',
                     replaces='mrphy_tpu/ops/epg_pallas.py:2003'),
    'cpmg_fwd_chk': dict(
        source='mrphy_tpu_torch/kernels/csrc/cpmg_fwd_lanes.cu',
        replaces='mrphy_tpu/ops/epg_pallas.py:2029'),
    'cpmg_bwd': dict(
        source='mrphy_tpu_torch/kernels/csrc/cpmg_bwd_lanes.cu',
        replaces='mrphy_tpu/ops/epg_pallas.py:2063'),
    'xspgr_fwd': dict(source='mrphy_tpu_torch/kernels/csrc/xspgr_fwd.cu',
                      replaces='mrphy_tpu/ops/epg_pallas.py:2512'),
    'xspgr_fwd_chk': dict(
        source='mrphy_tpu_torch/kernels/csrc/xspgr_fwd_lanes.cu',
        replaces='mrphy_tpu/ops/epg_pallas.py:2535'),
    'xspgr_bwd': dict(
        source='mrphy_tpu_torch/kernels/csrc/xspgr_bwd_lanes.cu',
        replaces='mrphy_tpu/ops/epg_pallas.py:2567'),
    'xspgr_v_fwd': dict(source='mrphy_tpu_torch/kernels/csrc/xspgr_fwd.cu',
                        replaces='mrphy_tpu/ops/epg_pallas.py:2877'),
    'xspgr_v_fwd_chk': dict(
        source='mrphy_tpu_torch/kernels/csrc/xspgr_fwd_lanes.cu',
        replaces='mrphy_tpu/ops/epg_pallas.py:2902'),
    'xspgr_v_bwd': dict(
        source='mrphy_tpu_torch/kernels/csrc/xspgr_bwd_lanes.cu',
        replaces='mrphy_tpu/ops/epg_pallas.py:2937'),
    'xcpmg_fwd': dict(source='mrphy_tpu_torch/kernels/csrc/xcpmg_fwd.cu',
                      replaces='mrphy_tpu/ops/epg_pallas.py:3233'),
    'xcpmg_fwd_chk': dict(
        source='mrphy_tpu_torch/kernels/csrc/xcpmg_fwd_lanes.cu',
        replaces='mrphy_tpu/ops/epg_pallas.py:3256'),
    'xcpmg_bwd': dict(
        source='mrphy_tpu_torch/kernels/csrc/xcpmg_bwd_lanes.cu',
        replaces='mrphy_tpu/ops/epg_pallas.py:3287'),
    'xcpmg_v_fwd': dict(source='mrphy_tpu_torch/kernels/csrc/xcpmg_fwd.cu',
                        replaces='mrphy_tpu/ops/epg_pallas.py:3561'),
    'xcpmg_v_fwd_chk': dict(
        source='mrphy_tpu_torch/kernels/csrc/xcpmg_fwd_lanes.cu',
        replaces='mrphy_tpu/ops/epg_pallas.py:3586'),
    'xcpmg_v_bwd': dict(
        source='mrphy_tpu_torch/kernels/csrc/xcpmg_bwd_lanes.cu',
        replaces='mrphy_tpu/ops/epg_pallas.py:3620'),
    'bssfp_fwd': dict(source='mrphy_tpu_torch/kernels/csrc/bssfp_fwd.cu',
                      replaces='mrphy_tpu/ops/ssfp_pallas.py:227'),
    'bssfp_fwd_chk': dict(
        source='mrphy_tpu_torch/kernels/csrc/bssfp_fwd.cu',
        replaces='mrphy_tpu/ops/ssfp_pallas.py:581'),
    'bssfp_bwd': dict(source='mrphy_tpu_torch/kernels/csrc/bssfp_bwd.cu',
                      replaces='mrphy_tpu/ops/ssfp_pallas.py:619'),
    'xmt_fwd': dict(source='mrphy_tpu_torch/kernels/csrc/xmt_fwd.cu',
                    replaces='mrphy_tpu/ops/epg_pallas.py:3976'),
    'xmt_fwd_chk': dict(source='mrphy_tpu_torch/kernels/csrc/xmt_fwd.cu',
                        replaces='mrphy_tpu/ops/epg_pallas.py:3999'),
    'xmt_bwd': dict(source='mrphy_tpu_torch/kernels/csrc/xmt_bwd_lanes.cu',
                    replaces='mrphy_tpu/ops/epg_pallas.py:4031'),
    'xmt_v_fwd': dict(source='mrphy_tpu_torch/kernels/csrc/xmt_fwd.cu',
                      replaces='mrphy_tpu/ops/epg_pallas.py:4337'),
    'xmt_v_fwd_chk': dict(source='mrphy_tpu_torch/kernels/csrc/xmt_fwd.cu',
                          replaces='mrphy_tpu/ops/epg_pallas.py:4362'),
    'xmt_v_bwd': dict(
        source='mrphy_tpu_torch/kernels/csrc/xmt_bwd_lanes.cu',
        replaces='mrphy_tpu/ops/epg_pallas.py:4397'),
}

# The H100 SXM's published peaks (NVIDIA's data sheet, at 700 W): HBM
# bytes per second, float32 operations per second outside the tensor
# cores, and the tensor cores' dense TF32 rate, at which sig_fwd and
# sig_adj run their coil sums (`tc_bound`).
HBM_BPS = 3.35e12
F32_OPS = 67e12
TF32_OPS = 495e12          # dense TF32 tensor-core rate


def device() -> torch.device:
    return torch.device('cuda', 0)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def time_ms(fn, reps: int = 5, warm: bool = True) -> float:
    r"""Median of ``reps`` CUDA-event timings of ``fn()`` after one
    warm-up call (none with ``warm`` False: the caller ran ``fn`` just
    before)."""
    if warm:
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
# result (a sum: per element of its input); a matrix product counts 2·m·n·k
# (a multiply and an add per term; ``addmm``/``baddbmm`` one more add per
# element); ``index_add_`` one add per element of its source. Indexing,
# stacking, copies, comparisons and selects are not counted (a plain
# version with branches evaluates each on its own elements, as the NUFFT's
# I₀ does, so that only the branch taken counts); nor are the kernels' own
# extra instructions (sincos's range reduction and polynomials count as
# one operation each for sin and cos): a lower bound on the card's work.
_ARITH = {'add', 'sub', 'rsub', 'mul', 'div', 'neg', 'rsqrt', 'sqrt', 'sin',
          'cos', 'clamp_min', 'reciprocal', 'sum', 'exp', 'expm1', 'round',
          'floor', 'remainder'}
_MATMUL = {'mm', 'bmm', 'addmm', 'baddbmm', 'matmul', 'mv'}


def count_ops(fn) -> int:
    r"""The operations of ``_ARITH`` and ``_MATMUL`` that ``fn()``
    performs."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__
            if name in _ARITH:
                Count.n += (args[0].numel() if name == 'sum'
                            else out.numel())
            elif name in _MATMUL:
                a = args[1] if name in ('addmm', 'baddbmm') else args[0]
                Count.n += 2 * out.numel() * a.shape[-1] + (
                    out.numel() if name in ('addmm', 'baddbmm') else 0)
            elif name == 'dot':
                Count.n += 2 * args[0].numel()
            elif name == 'index_add':
                Count.n += args[3].numel()
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


# ---------------------------------------------------------------------------
# The k-space acquisition operator (phases 12-13)
# ---------------------------------------------------------------------------

# benchmarks/suite.py bench_signal (lines 274-340): one readout of a 3-D
# volume, 64³ = 262,144 spins × 16,384 samples × 8 coils
SIG_NM, SIG_NT, SIG_NC = 64 ** 3, 16_384, 8
# Bars on max|kernel − plain| / max|plain|. 2e-5 on the linear outputs (U,
# V, XR, XS) in float32: the bar tests/test_signal.py sets between two
# float32 routes of this operator (the kernels take sincospi where the
# plain versions take sin/cos of a rounded radian, and sum in another
# order); 2e-4 on the phase-chain cotangents (dloc, dk, ddf, di2), whose
# terms cancel more (tests/test_signal.py:272); float64: rounding only.
SIG_BAR = {torch.float32: 2e-5, torch.float64: 1e-12}
SIG_CHAIN_BAR = {torch.float32: 2e-4, torch.float64: 1e-10}


def signal_case(nM, nT, dtype, dev, *, nC=8, N=1, bcast=True, sens=True,
                df=True, t2=True, far=False, seed=0):
    r"""``signal`` inputs of the bench_signal configuration, from ``seed``:
    M standard normal, locations uniform over ±12 cm, readout gradients
    uniform in ±2 G/cm at dt0 (the Rx k-space their γ·dt cumsum, |k| up to
    ~2.5 cycle/cm), ``nC`` standard-normal receive maps, Δf ∈ ±100 Hz, T2*
    ∈ [5, 50] ms. With ``bcast`` every input but M has a batch of 1. With
    ``far`` the k-space of the second half of the samples is scaled by
    3·10⁵ (|φ| up to ~2²⁵ cycles: past the float32 kernels' fast sign,
    which holds to |φ| < 2²¹)."""
    from mrphy_tpu_torch import dt0, gamH
    rng = np.random.default_rng(seed)
    Nb = 1 if bcast else N

    def arr(x):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    M = arr(rng.standard_normal((N, nM, 3)))
    loc = arr(rng.uniform(-12, 12, (Nb, nM, 3)))
    k = np.cumsum(rng.uniform(-2, 2, (Nb, 3, nT)), axis=2) * gamH * dt0
    if far:
        k[..., nT // 2:] *= 3e5
    k = arr(k)
    kw = {}
    if sens:
        kw['sens'] = arr(rng.standard_normal((Nb, nM, 2, nC)))
    if df:
        kw['df'] = arr(rng.uniform(-100, 100, (Nb, nM)))
    if t2:
        kw['T2s'] = arr(rng.uniform(5e-3, 5e-2, (Nb, nM)))
    return (M, loc, k), kw


# The kernels' cases (phase 12): label, spins, samples, dtype, signal_case
# keywords, timed.
SIG_CASES = (
    ('262k x 16k x 8 coils, df+T2* (bench_signal)', SIG_NM, SIG_NT,
     torch.float32, {}, True),
    ('16k x 4k, 1 coil, no sens', 1 << 14, 4096, torch.float32,
     dict(nC=1, sens=False), False),
    ('16k x 4k x 32 coils', 1 << 14, 4096, torch.float32, dict(nC=32), False),
    ('16k x 4k x 64 coils', 1 << 14, 4096, torch.float32, dict(nC=64), False),
    ('16k x 4k x 8 coils, no df/T2*', 1 << 14, 4096, torch.float32,
     dict(df=False, t2=False), False),
    ('N=3 x 16k x 4k x 4 coils, inputs broadcast', 1 << 14, 4096,
     torch.float32, dict(nC=4, N=3), False),
    ('16381 x 4093 x 3 coils, ragged, N=2 per-batch inputs', 16381, 4093,
     torch.float32, dict(nC=3, N=2, bcast=False), False),
    ('16k x 4k x 8 coils, df+T2*, k x 3e5 on half the samples (|phi| to '
     '~2^25)', 1 << 14, 4096, torch.float32, dict(far=True), False),
    ('16k x 4k x 8 coils, df+T2*', 1 << 14, 4096, torch.float64, {}, False))

# The design each kernel's source holds for each dtype, as phase 12's rows
# name it.
SIG_ROUTE = {**{(n, torch.float32): 'split-TF32 mma.sync, 3 passes'
                for n in ('sig_fwd', 'sig_adj')},
             **{(n, torch.float64): 'FP64 mma.sync'
                for n in ('sig_fwd', 'sig_adj')},
             **{('sig_vjp', d): 'CUDA cores'
                for d in (torch.float32, torch.float64)}}
SIG_OUT = {'sig_fwd': ('U', 'V'), 'sig_adj': ('XR', 'XS'),
           'sig_vjp': ('XR', 'XS', 'dloc', 'dk', 'ddf', 'di2')}


def phase_signal_kernels(dev):
    r"""Phase 12: ``sig_fwd``, ``sig_adj`` and ``sig_vjp`` against their
    plain versions on the arguments ``ops.signal`` gives them, on
    SIG_CASES; the adjoints fed seeded signal / cotangent rows. Returns
    each kernel's rows."""
    from mrphy_tpu_torch import dt0
    from mrphy_tpu_torch.kernels import signal as ks
    from mrphy_tpu_torch.ops import signal as sig
    rows = {name: [] for name in SIG_OUT}
    for seed, (label, nM, nT, dtype, kw, timed) in enumerate(SIG_CASES, 40):
        pos, kws = signal_case(nM, nT, dtype, dev, **kw)
        w2, *sp = sig.signal_planes(*pos, **kws)
        del pos, kws
        g2 = cotangent(torch.empty((w2.shape[0], w2.shape[1], nT),
                                   dtype=dtype, device=dev), seed)
        runs = {'sig_fwd': (lambda: ks.sig_fwd(w2, *sp, dt0),
                            lambda: ks.sig_fwd_torch(w2, *sp, dt0),
                            (w2, sp)),
                'sig_adj': (lambda: ks.sig_adj(g2, *sp, dt0),
                            lambda: ks.sig_adj_torch(g2, *sp, dt0),
                            (g2, sp)),
                'sig_vjp': (lambda: ks.sig_vjp(g2, w2, *sp, dt0),
                            lambda: ks.sig_vjp_torch(g2, w2, *sp, dt0),
                            (g2, w2, sp))}
        for name, (run_kernel, run_plain, inputs) in runs.items():
            k, p = run_kernel(), run_plain()
            torch.cuda.synchronize()
            errs, abs_errs = {}, {}
            for n, a, b in zip(SIG_OUT[name], k, p):
                check((a is None) == (b is None), f'{name} {n}: None')
                if b is not None:
                    check(a.shape == b.shape, f'{name} {n} shape')
                    abs_errs[n] = max_err(a, b)
                    errs[n] = row_err(a, b)
            lin = [n for n in errs if n in ('U', 'V', 'XR', 'XS')]
            row = dict(case=label, dtype=str(dtype).replace('torch.', ''),
                       rel_err=errs, bar=SIG_BAR[dtype],
                       chain_bar=SIG_CHAIN_BAR[dtype],
                       max_abs_err=max(abs_errs[n] for n in lin),
                       max_rel_err=max(errs[n] for n in lin))
            row['route'] = SIG_ROUTE[name, dtype]
            if timed and name != 'sig_vjp':
                # a second launch on the same inputs: the same bits
                row['repeat_bitwise'] = all(
                    torch.equal(a, b) for a, b in zip(k, run_kernel()))
                check(row['repeat_bitwise'], f'{name} {label}: a second '
                      'launch differs')
            del k
            if timed:
                row['ms'] = time_ms(run_kernel)
                row['plain_ms'] = time_ms(run_plain, reps=3)
                if dtype == torch.float32:
                    row.update(bound(run_plain, inputs, p))
                    if name != 'sig_vjp':
                        row.update(tc_bound(row, inputs[0], nM, nT))
                    row['bound_share'] = row['bound_ms'] / row['ms']
            del p
            print(f'{name} {label}: ' + json.dumps(row), flush=True)
            for n, e in errs.items():
                bar = (SIG_BAR if n in lin else SIG_CHAIN_BAR)[dtype]
                check(e <= bar, f'{name} {label} {n}: {e} > {bar}')
            rows[name].append(row)
        del w2, sp, g2
    return rows


def tc_bound(row, rows, nM, nT) -> dict:
    r"""The bound of ``sig_fwd``/``sig_adj``, whose coil sums run on the
    tensor cores: the larger of the bytes over HBM_BPS, the factor
    operations (the plain version's operations less its two products,
    2·MACs) over F32_OPS and the three TF32 passes of both products, 3 · 2
    · MACs, over TF32_OPS; ``rows`` `(N, 2nC, ·)` gives the products' MACs,
    2 · N · 2nC · nM · nT. The bound of :func:`bound`, all operations at
    F32_OPS, is kept as ``cuda_core_bound_ms``; ``floor_by`` names the
    larger time."""
    macs = 2 * rows.shape[0] * rows.shape[1] * nM * nT
    times = {'bytes': row['bytes'] / HBM_BPS * 1e3,
             'factors': (row['ops'] - 2 * macs) / F32_OPS * 1e3,
             'tensor cores': 3 * 2 * macs / TF32_OPS * 1e3}
    by = max(times, key=times.get)
    return dict(cuda_core_bound_ms=row['bound_ms'],
                cuda_core_bound_by=row['bound_by'], bound_ms=times[by],
                bound_by='bytes' if by == 'bytes' else 'operations',
                floor_by=by)


def phase_sincos_accuracy(dev):
    r"""The factors' accuracy in float32 against float64: ``sig_adj`` with
    identity signal rows (64 coils, 128 samples) returns the factor matrix
    itself, ``XR[t, m] = C[m, t]``, ``XS[t, m] = S[m, t]`` (no Δf, no
    decay). 65,536 spins over ±12 cm and k up to ±4 cycle/cm put |φ| up to
    ~150 cycles. Both the kernel (sincospi of the exact reduced argument)
    and the plain version (sin/cos of the rounded radian −2πr) are held to
    cos/sin(−2πφ) in float64 at the same float32 phase φ (which both form
    bit for bit): the error of the reduction and sin/cos alone, under
    4e-7, the bar of tests/test_signal.py's sweep of the TPU kernels'
    polynomial sincos."""
    from mrphy_tpu_torch import dt0
    from mrphy_tpu_torch.kernels import signal as ks
    rng = np.random.default_rng(3)
    nM, nT = 1 << 16, 128

    def arr(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    pos = arr(rng.uniform(-12, 12, (1, 3, nM)))
    k = arr(rng.uniform(-4, 4, (1, 3, nT)))
    eye = torch.eye(nT, dtype=torch.float32, device=dev)[None]
    x, y, z = (pos[0, i, :, None] for i in range(3))
    phi = x * k[0, 0] + y * k[0, 1] + z * k[0, 2]     # the kernels' order
    ref = torch.exp(-2j * np.pi * phi.double())       # (nM, nT), float64
    out = {'max_abs_phase_cycles': float(phi.abs().max())}
    for name, run in (('kernel', ks.sig_adj), ('plain', ks.sig_adj_torch)):
        XR, XS = run(eye, pos, None, None, k, dt0)
        out[name] = max(max_err(XR[0].T, ref.real), max_err(XS[0].T, ref.imag))
    print('sincos vs float64: ' + json.dumps(out), flush=True)
    for name in ('kernel', 'plain'):
        check(out[name] <= 4e-7, f'sincos {name}: {out[name]} > 4e-7')
    return out


# examples/recon_sense.py's default problem: a 32×32 ellipse phantom with
# a smooth phase, 4 smooth coils, FOV 24 cm, the corner-covering spiral-out
# (spiral2d(24, 46, direction='out'), 3358 samples at dt0), a linear
# off-resonance map of ±40 Hz, CG-SENSE with λ = 1e-6, 40 iterations.
RECON = dict(n=32, nc=4, fov=24.0, df=40.0, iters=40, lam=1e-6)
RECON_STEPS = [0, 97, 1000, 2345, 3357]
# benchmarks/suite.py bench_recon (lines 343-406): a 128×128 grid, 8
# random coils, a random image, the corner-covering spiral-out
# (spiral2d(24, 182, direction='out'), ~29k samples), 10 CG iterations.
RECON_BENCH = dict(n=128, nc=8, fov=24.0, iters=10)
RECON_PIXELS = [0, 100, 300, 528, 777, 1023]


def recon_phantom(n):
    r"""examples/recon_sense.py's ellipse phantom with a smooth phase,
    `(n·n, 2)` re/im."""
    y, x = np.mgrid[-1:1:n * 1j, -1:1:n * 1j]
    mag = np.zeros((n, n))
    mag[(x / 0.82) ** 2 + (y / 0.92) ** 2 < 1] = 1.0
    mag[((x - 0.22) / 0.31) ** 2 + ((y + 0.1) / 0.41) ** 2 < 1] = 0.35
    mag[((x + 0.22) / 0.27) ** 2 + ((y + 0.1) / 0.41) ** 2 < 1] = 0.65
    mag[(x / 0.08) ** 2 + ((y - 0.55) / 0.11) ** 2 < 1] = 1.4
    ph = 0.8 * x + 0.5 * y * y
    return np.stack([mag * np.cos(ph), mag * np.sin(ph)], -1).reshape(-1, 2)


def recon_coil_maps(n, nc):
    r"""examples/recon_sense.py's smooth complex coil maps, `(n·n, 2,
    nc)`."""
    y, x = np.mgrid[-1:1:n * 1j, -1:1:n * 1j]
    maps = []
    for c in range(nc):
        a = 2 * np.pi * c / nc
        m = np.exp(-((x - 1.3 * np.cos(a)) ** 2
                     + (y - 1.3 * np.sin(a)) ** 2) / 2.4)
        p = 0.5 * (x * np.sin(a) - y * np.cos(a))
        maps.append(np.stack([m * np.cos(p), m * np.sin(p)], -1))
    return np.stack(maps, -1).reshape(n * n, 2, nc)


def recon_arrays():
    r"""The RECON problem's numpy float64 inputs: ``loc_ (1, nM, 3)``,
    ``x_true (nM, 2)``, ``sens (1, nM, 2, nc)``, ``df (1, nM)`` and the
    readout k-space ``k (1, 3, nT)``."""
    from mrphy_tpu_torch import dt0, gamH
    from mrphy_tpu_torch.utils import spiral2d
    n, nc, fov = RECON['n'], RECON['nc'], RECON['fov']
    ax = (np.arange(n) - n // 2) / n * fov
    yy, xx = np.meshgrid(ax, ax, indexing='ij')
    loc = np.stack([xx, yy, np.zeros_like(xx)], -1).reshape(1, n * n, 3)
    df = RECON['df'] * (xx / fov * 2).reshape(1, n * n)
    gr, _ = spiral2d(fov, int(np.ceil(1.42 * n)), direction='out')
    k = gamH * dt0 * np.cumsum(gr, axis=2)
    return (loc, recon_phantom(n), recon_coil_maps(n, nc)[None], df, k)


def recon_ops(loc, sens, df, k):
    r"""The encoding operator ``A`` `(nM, 2)` → `(1, nc, nT, 2)` and its
    adjoint ``AH`` through ``ops.signal``, as examples/recon_sense.py
    builds them."""
    from mrphy_tpu_torch.ops import signal as sig
    nM = loc.shape[1]

    def A(x):
        M = torch.cat([x, x.new_zeros((nM, 1))], -1)[None]
        return sig.signal(M, loc, k, sens=sens, df=df)

    def AH(s):
        return sig.signal_adjoint(s, loc, k, sens=sens, df=df).sum(0)
    return A, AH


def cg_sense(A, AH, s, iters, lam=0.0):
    r"""CG on ``(AᴴA + λI) x = Aᴴ s`` from 0 — examples/recon_sense.py's
    loop: frozen once the squared residual falls below 1e-12 of the
    first. Returns the image and the residual norm."""
    b = AH(s)
    x, r = torch.zeros_like(b), b
    p, rs = r, (r * r).sum()
    rs0 = rs
    for _ in range(iters):
        live = rs > 1e-12 * rs0
        Ap = AH(A(p)) + lam * p
        alpha = torch.where(live, rs / (p * Ap).sum(), 0.0)
        x, r = x + alpha * p, r - alpha * Ap
        rs_new = (r * r).sum()
        p = torch.where(live, r + (rs_new / rs.clamp_min(1e-30)) * p, p)
        rs = rs_new
    return x, rs.sqrt()


# mrphy_tpu (JAX, XLA route on the CPU), float64, on the RECON problem
# (tests/make_signal_goldens.py prints these): the acquired signal at
# RECON_STEPS (coils × steps × re/im) and its largest |value|; ∂Σs²/∂ktraj
# at RECON_STEPS (xyz × steps) and its largest |value|; the CG-SENSE image
# at RECON_PIXELS (pixels × re/im).
GOLDEN_RECON = {'s': [[[200.0855127666203, 48.22895363791878],
                       [-47.93238088949127, -11.177458947786883],
                       [-0.09850685288263417, -0.6438096509719307],
                       [-0.2599206984482687, -0.7993127485715334],
                       [1.1489161614022065, 1.4183908736058588]],
                      [[203.01053597551712, 23.014316238928348],
                       [-37.73486437053407, -31.366963379509386],
                       [3.2898607787728604, -0.8451125466466379],
                       [0.9671011397818277, -1.897388911074458],
                       [0.9882666170371979, 0.6659516131415915]],
                      [[210.71426490751088, -8.939009858379757],
                       [-38.96157288346173, -10.533006643157377],
                       [1.2881102371587545, 2.2382305879613806],
                       [1.0602772715725581, -0.3395006514451492],
                       [0.9213754328204242, 0.6774692108369067]],
                      [[222.60900723436075, 27.43410079361201],
                       [-38.49792237001747, -20.955910348190724],
                       [-0.6815442941947942, 2.811575637748219],
                       [1.2729337463829695, 0.15824171361590622],
                       [1.2753503838472742, 0.8059613307013015]]],
                's_max': 222.9117747137282,
                'dk': [[3377764.14008886,
                        -144097.94315115572,
                        -717.2627120669621,
                        -249.11007333565829,
                        -40.55885628922101],
                       [-450.4080280629042,
                        -20750.040824967793,
                        -988.9737971278294,
                        -195.1520595112691,
                        -70.84780143872372],
                       [0.0, 0.0, 0.0, 0.0, 0.0]],
                'dk_max': 4982576.092562888,
                'x': [[4.262738328908971e-06, 6.569162886131879e-07],
                      [-4.4103617542229206e-06, 8.969526882938293e-07],
                      [0.6472060813082426, -0.06017833727807889],
                      [0.6497743401653377, 0.01711094059085578],
                      [0.9829119508438173, -0.18406340431415452],
                      [1.5147011125872427e-06, 2.737670233832806e-06]]}


def excite_acquire_oracle(cube, gr, sens, T2s, dt):
    r"""The signal of ``cube``'s magnetization over readout ``gr`` by the
    Bloch simulator: ``slowsims.blochsim_1step`` stepped through the
    readout with the gradient (and Δf) as Bz and T2* as T2, the spins'
    transverse magnetization coil-combined after every step (the oracle of
    tests/test_signal.py)."""
    from mrphy_tpu_torch import gamH, pi
    from mrphy_tpu_torch.ops import slowsims
    M, loc, df = cube.M_, cube.loc_, cube.df_
    E2 = torch.exp(-dt / T2s)
    g2pd = 2 * pi * gamH * dt
    mxy = []
    for t in range(gr.shape[2]):
        bz = (loc * gr[:, None, :, t]).sum(-1) + df / gamH
        b = torch.cat([torch.zeros_like(loc[..., :2]), bz[..., None]], -1)
        M, _ = slowsims.blochsim_1step(M, M, b, 1.0, 0.0, E2, g2pd)
        mxy.append(M[0, :, :2])
    mr, mi = torch.stack(mxy).unbind(-1)              # (nT, nM)
    sr, si = sens[0, :, 0], sens[0, :, 1]             # (nM, nC)
    return torch.stack([(mr @ sr - mi @ si).T, (mi @ sr + mr @ si).T],
                       -1)[None]                      # (1, nC, nT, 2)


def phase_signal_path(dev):
    r"""Phase 13: the acquisition path through the entry points: (a) the
    recon_sense problem against JAX in float64 and its image bound in
    float32; (b) excite then acquire on the 64³ cube, and against the Bloch
    oracle on a 4096-spin cube; (c) CG-SENSE at bench_recon width; (d)
    bench_signal width through ``signal``: times and peak memory."""
    from mrphy_tpu_torch import dt0, gamH
    from mrphy_tpu_torch.models.mobjs import SpinCube
    from mrphy_tpu_torch.ops import signal as sig
    from mrphy_tpu_torch.utils import spiral2d
    out, bars = {}, {}

    # (a) the recon_sense problem, float64 against JAX, float32 image bound
    for dtype in (torch.float64, torch.float32):
        loc, x_true, sens, df, k = (torch.as_tensor(a, dtype=dtype,
                                                    device=dev)
                                    for a in recon_arrays())
        A, AH = recon_ops(loc, sens, df, k)
        s = A(x_true)
        x, res = cg_sense(A, AH, s, RECON['iters'], RECON['lam'])
        tag = 'f64' if dtype == torch.float64 else 'f32'
        key = f'recon_{tag}_image_err'
        out[key] = float(torch.linalg.vector_norm(x - x_true)
                         / torch.linalg.vector_norm(x_true))
        bars[key] = 0.01          # examples/recon_sense.py's own bound
        if dtype != torch.float64:
            continue
        out['recon_f64_residual'] = float(res)
        steps = torch.tensor(RECON_STEPS, device=dev)
        out['recon_f64_signal_vs_jax'] = (max_err(
            s[0][:, steps].cpu(), torch.tensor(
            GOLDEN_RECON['s'], dtype=torch.float64))
            / GOLDEN_RECON['s_max'])
        bars['recon_f64_signal_vs_jax'] = 1e-10
        kk = k.clone().requires_grad_()
        M = torch.cat([x_true, x_true.new_zeros((x_true.shape[0], 1))],
                      -1)[None]
        dk, = torch.autograd.grad((sig.signal(M, loc, kk, sens=sens, df=df)
                                   ** 2).sum(), kk)
        out['recon_f64_dk_vs_jax'] = (max_err(
            dk[0][:, steps].cpu(), torch.tensor(
            GOLDEN_RECON['dk'], dtype=torch.float64))
            / GOLDEN_RECON['dk_max'])
        bars['recon_f64_dk_vs_jax'] = 1e-9
        px = torch.tensor(RECON_PIXELS, device=dev)
        out['recon_f64_image_vs_jax'] = max_err(
            x[px].cpu(), torch.tensor(
            GOLDEN_RECON['x'], dtype=torch.float64))
        bars['recon_f64_image_vs_jax'] = 1e-9

    # (b) excite then acquire: the 64³ cube at full width (float32, timed)
    cube, pulse = cube64(torch.float32, dev)
    rng = np.random.default_rng(12)
    gr = torch.as_tensor(rng.uniform(-2, 2, (1, 3, SIG_NT)),
                         dtype=torch.float32, device=dev)
    sens = torch.as_tensor(rng.standard_normal((1, cube.nM, 2, SIG_NC)),
                           dtype=torch.float32, device=dev)
    T2s = torch.as_tensor(rng.uniform(5e-3, 5e-2, (1, cube.nM)),
                          dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cube.applypulse(pulse, doUpdate=True)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    s = cube.acquire(gr, sens_=sens, T2s_=T2s)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    check(tuple(s.shape) == (1, SIG_NC, SIG_NT, 2)
          and bool(torch.isfinite(s).all()), 'excite-acquire signal')
    out.update(cube64_excite_s=t1 - t0, cube64_acquire_s=t2 - t1)
    del cube, s, sens, T2s
    # ... and against the Bloch oracle on a 16³ = 4096-spin cube over 24
    # cm (every 4th voxel of the 64³ grid) × 2048 samples, float64
    mask = np.zeros((1, CUBE, CUBE, CUBE), dtype=bool)
    mask[0, ::4, ::4, ::4] = True
    cube = SpinCube((1, CUBE, CUBE, CUBE), [[24., 24., 24.]], mask=mask,
                    device=dev, dtype=torch.float64)
    cube.df_ = cube.loc_.sum(-1) / 36 * 100
    rf, grp = waveforms(1000, torch.float64, dev)
    from mrphy_tpu_torch.models.mobjs import Pulse
    cube.applypulse(Pulse(rf, grp, dt=dt0), doUpdate=True)
    nT = 2048
    gr64 = gr[:, :, :nT].double()
    sens = torch.as_tensor(rng.standard_normal((1, cube.nM, 2, SIG_NC)),
                           device=dev)
    T2s = torch.as_tensor(rng.uniform(5e-3, 5e-2, (1, cube.nM)), device=dev)
    s = cube.acquire(gr64, sens_=sens, T2s_=T2s)
    s_or = excite_acquire_oracle(cube, gr64, sens, T2s, dt0)
    out['cube_4096_acquire_vs_oracle'] = row_err(s, s_or)
    bars['cube_4096_acquire_vs_oracle'] = 1e-10
    del cube, s, s_or

    # (c) CG-SENSE at bench_recon width, float32
    n, nc, fov, iters = (RECON_BENCH[k] for k in ('n', 'nc', 'fov', 'iters'))
    rng = np.random.default_rng(0)
    ax = np.linspace(-fov / 2, fov / 2, n, endpoint=False) + fov / (2 * n)
    yy, xx = np.meshgrid(ax, ax, indexing='ij')

    def arr(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    loc = arr(np.stack([xx, yy, np.zeros_like(xx)], -1).reshape(1, n * n, 3))
    sens = arr(rng.standard_normal((1, n * n, 2, nc)))
    x_true = arr(rng.standard_normal((n * n, 2)))
    grs, _ = spiral2d(fov, int(np.ceil(1.42 * n)), direction='out')
    k = arr(gamH * dt0 * np.cumsum(grs, axis=2))
    A, AH = recon_ops(loc, sens, None, k)
    s = A(x_true)
    cg_sense(A, AH, s, 1)                                 # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, _ = cg_sense(A, AH, s, iters)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    err = float(torch.linalg.vector_norm(x - x_true)
                / torch.linalg.vector_norm(x_true))
    check(np.isfinite(err) and err < 1, f'bench_recon CG made no progress: '
          f'{err}')
    out.update(bench_recon_nT=int(k.shape[-1]), bench_recon_image_err=err,
               bench_recon_s_per_iter=wall / iters)

    # (d) bench_signal width through signal: forward, adjoint and the
    # trajectory-optimization gradient ∂Σs²/∂(ktraj, M)
    pos, kws = signal_case(SIG_NM, SIG_NT, torch.float32, dev)
    M, loc, k = pos
    s = sig.signal(M, loc, k, **kws)

    def fwd():
        return sig.signal(M, loc, k, **kws)

    def adj():
        return sig.signal_adjoint(s, loc, k, **kws)

    def grad():
        kk, MM = k.clone().requires_grad_(), M.clone().requires_grad_()
        return torch.autograd.grad((sig.signal(MM, loc, kk, **kws) ** 2)
                                   .sum(), (kk, MM))

    gk, gM = grad()
    check(bool(torch.isfinite(gk).all()) and bool(torch.isfinite(gM).all())
          and float(gk.abs().max()) > 0, 'bench_signal gradient')
    del gk, gM
    for name, fn in (('fwd', fwd), ('adj', adj), ('grad_kM', grad)):
        torch.cuda.reset_peak_memory_stats(dev)
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        ms = statistics.median(ts) * 1e3
        out[f'bench_signal_{name}_ms'] = ms
        out[f'bench_signal_{name}_spin_samples_per_s'] = (
            SIG_NM * SIG_NT / ms * 1e3)
        out[f'bench_signal_{name}_peak_mem_gb'] = (
            torch.cuda.max_memory_allocated(dev) / 1e9)
    print('acquisition path: ' + json.dumps(dict(measured=out, bars=bars)),
          flush=True)
    for key, bar in bars.items():
        check(out[key] <= bar, f'{key}: {out[key]} > {bar}')
    return out


# ==========================================================================
# The gridding NUFFT (phases 14-15)
# ==========================================================================

# The full-width 3-D case: examples/recon3d.py's plan at n = 128 (FOV 24
# cm, osf 1.5, W 4: a 192³ grid) and its golden-angle koosh-ball
# trajectory at 8192 spokes, 2,285,568 samples (~0.32 × Nyquist).
NUFFT3D = dict(n=128, fov=24.0, osf=1.5, width=4, spokes=8192)
# Sample-stage bars on max|kernel − plain| / max|plain| (the kernels follow
# their plain versions' operations: on the card they may agree bit for
# bit); the spread's, whose sums run in the bins' order, is atomic_bar().
NUFFT_BAR = {torch.float32: 5e-5, torch.float64: 1e-10}
EPS = {torch.float32: 2.0 ** -23, torch.float64: 2.0 ** -52}
# The W 4, osf 1.5 plan against the exact operator (relative 2-norm of the
# samples, and of the adjoint's image): 6.9e-4 / 9.4e-4 on the recon3d
# phantom at 32³ and 7.1e-4 / 1.04e-3 at 64³ (4096 / 1024 radial samples),
# 2.5e-3 / 1.2e-3 on a standard-normal 32³ image (float64, the plain route
# on a CPU). The bar on the phantoms of phase 15.
NUFFT_PLAN_ACC = 3e-3


def atomic_bar(dtype, m_max: int) -> float:
    r"""Bar on max|spread − index_add_| / max|grid| (the binned spread
    sums by bin, subproblem and sample; ``index_add_`` on the card by
    atomics): two sums of the same
    m terms in two orders differ by ~ε·√m of the partial sums' size
    (random-walk rounding, each order ε·√(m/2)), four standard deviations
    at the grid point where the most samples meet (``m_max`` taps)."""
    return 4 * EPS[dtype] * max(m_max, 1) ** 0.5


@contextlib.contextmanager
def deterministic_algorithms():
    r"""``torch.use_deterministic_algorithms(True)`` for the block, then the
    mode as it was."""
    was = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn)


def radial3d_k(n, fov, spokes):
    r"""examples/recon3d.py's trajectory: ``utils.radial3d`` spokes laid
    end to end, `(3, nspokes·nT)` numpy float64, "cycle/cm"."""
    from mrphy_tpu_torch.utils import radial3d
    _, k = radial3d(fov, n, nspokes=spokes)
    return k.transpose(1, 0, 2).reshape(3, -1)


def sector_bytes(nT, width, d, elem) -> float:
    r"""32-byte-sector traffic of a gather of nT samples' taps: W^(d−1)
    rows of W contiguous re/im points per sample, a row starting at any
    point offset within its sector (each sector counted once per row)."""
    e2 = 2 * elem
    offs = range(0, 32, e2) if e2 < 32 else [0]
    per_row = sum(-(-(o + width * e2) // 32) for o in offs) / len(offs)
    return nT * width ** (d - 1) * per_row * 32


# The kernels' cases (phase 14): label, image size, FOV, osf, W,
# trajectory ('radial' | 'uniform'), its spokes or samples, dtype, N, Nk,
# timed ('full': kernel and plain version, 'kernel': the kernel only).
NUFFT_CASES = (
    ('128^3 osf 1.5 W4, radial3d 8192 spokes (recon3d at n=128)',
     (128,) * 3, 24.0, 1.5, 4, 'radial', 8192, torch.float32, 1, 1, 'full'),
    ('128^3 osf 1.5 W4, 2,285,568 uniform random samples',
     (128,) * 3, 24.0, 1.5, 4, 'uniform', 2_285_568, torch.float32, 1, 1,
     'kernel'),
    ('96^3 osf 1.25 W4, 32k uniform (bench_nufft3d)', (96,) * 3, 24.0,
     1.25, 4, 'uniform', 32_768, torch.float32, 1, 1, 'kernel'),
    ('128^2 osf 2 W5, 32k uniform (bench_nufft)', (128, 128), 25.6, 2.0, 5,
     'uniform', 32_768, torch.float32, 1, 1, 'kernel'),
    ('256 (1-D) osf 2 W6, 4096 uniform', (256,), 24.0, 2.0, 6, 'uniform',
     4096, torch.float32, 1, 1, None),
    ('40^3 osf 2 W7 (the run-time-width instance), 8192 uniform', (40,) * 3,
     24.0, 2.0, 7, 'uniform', 8192, torch.float32, 1, 1, None),
    ('N=4 x 64^2 osf 2 W4, per-entry k, 8192 uniform', (64, 64), 24.0, 2.0,
     4, 'uniform', 8192, torch.float32, 4, 4, None),
    ('N=3 x 48x40 osf 2 W5, broadcast k, 4096 uniform', (48, 40), (24.0,
     20.0), 2.0, 5, 'uniform', 4096, torch.float64, 3, 1, None),
    ('32^3 osf 1.5 W4, radial3d 1200 spokes (recon3d)', (32,) * 3, 24.0,
     1.5, 4, 'radial', 1200, torch.float64, 1, 1, None))

NUFFT_KERNELS = ('nufft_sample', 'nufft_spread', 'nufft_dk')


def nufft_case(im_size, fov, osf, width, traj, nT, dtype, dev, N, Nk,
               seed):
    r"""The kernels' arguments as ``ops.nufft`` gives them: the plan, the
    spectrum of a standard-normal image through the grid stage
    (``_to_grid``), the trajectory `(Nk, d, nT)` (``traj`` 'radial':
    ``nT`` spokes of ``radial3d``; 'uniform': ``nT`` samples in the Nyquist
    box), and standard-normal samples / cotangents `(N, nT, 2)`."""
    from mrphy_tpu_torch.ops import nufft as nf
    rng = np.random.default_rng(seed)
    d = len(im_size)
    fov = (fov,) * d if np.isscalar(fov) else fov
    plan = nf.nufft_plan(im_size, fov, osf=osf, width=width, dtype=dtype,
                         device=dev)
    if traj == 'radial':
        k = radial3d_k(im_size[0], fov[0], nT)[None]
    else:
        k = np.stack([rng.uniform(-n / (2 * f), n / (2 * f), (Nk, nT))
                      for n, f in zip(im_size, fov)], 1)

    def arr(x):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    k = arr(k)
    img = arr(rng.standard_normal((N,) + im_size + (2,)))
    grid = nf._to_grid(plan, img).contiguous()
    s = arr(rng.standard_normal((N, k.shape[-1], 2)))
    g = arr(rng.standard_normal((N, k.shape[-1], 2)))
    return plan, grid, k, s, g


def interp_matrices(fi, fw, nG):
    r"""The interpolation matrix A `(nT, ΠG)` of taps ``fi``/weights ``fw``
    (one batch entry) as CSR, and Aᵀ `(ΠG, nT)` as CSR, int32 indices:
    the operands of the library yardstick ``torch.sparse.mm``."""
    nT, P = fi.shape
    dev = fi.device
    col = fi.reshape(-1)
    crow = torch.arange(0, nT * P + 1, P, device=dev, dtype=torch.int32)
    A = torch.sparse_csr_tensor(crow, col.int(), fw.reshape(-1),
                                size=(nT, nG))
    order = torch.argsort(col, stable=True)
    counts = torch.bincount(col, minlength=nG)
    crow_t = torch.zeros(nG + 1, dtype=torch.int64, device=dev)
    crow_t[1:] = torch.cumsum(counts, 0)
    AT = torch.sparse_csr_tensor(crow_t.int(), (order // P).int(),
                                 fw.reshape(-1)[order], size=(nG, nT))
    return A, AT


def phase_nufft_kernels(dev):
    r"""Phase 14: ``nufft_sample``, ``nufft_spread`` and ``nufft_dk``
    against their plain versions on NUFFT_CASES; the timed full-width case
    with the library yardstick (``torch.sparse.mm`` of the interpolation
    matrix and of its transpose, built once) and the 32-byte-sector
    traffic estimate beside the bound. Returns each kernel's rows."""
    from mrphy_tpu_torch.kernels import nufft as knf
    rows = {name: [] for name in NUFFT_KERNELS}
    for seed, (label, im_size, fov, osf, W, traj, nT, dtype, N, Nk,
               timed) in enumerate(NUFFT_CASES, 60):
        plan, grid, k, s, g = nufft_case(im_size, fov, osf, W, traj, nT,
                                         dtype, dev, N, Nk, seed)
        geom, nG = plan.geom, int(np.prod(plan.grid_size))
        fi, _, _ = knf.taps(k[:1], geom)
        m_max = int(torch.bincount(fi.reshape(-1), minlength=nG).max())
        del fi
        runs = {'nufft_sample': (lambda: knf.nufft_sample(grid, k, geom),
                                 lambda: knf.nufft_sample_torch(grid, k,
                                                                geom),
                                 (grid, k)),
                'nufft_spread': (lambda: knf.nufft_spread(s, k, geom),
                                 lambda: knf.nufft_spread_torch(s, k, geom),
                                 (s, k)),
                'nufft_dk': (lambda: knf.nufft_dk(grid, k, g, geom),
                             lambda: knf.nufft_dk_torch(grid, k, g, geom),
                             (grid, k, g))}
        for name, (run_kernel, run_plain, inputs) in runs.items():
            kout, pout = run_kernel(), run_plain()
            torch.cuda.synchronize()
            check(kout.shape == pout.shape, f'{name} {label}: shape')
            err = row_err(kout, pout)
            bar = (atomic_bar(dtype, m_max) if name == 'nufft_spread'
                   else NUFFT_BAR[dtype])
            row = dict(case=label, dtype=str(dtype).replace('torch.', ''),
                       nT=int(k.shape[-1]), N=N, max_rel_err=err, bar=bar,
                       max_abs_err=max_err(kout, pout),
                       bit_identical=bool(torch.equal(kout, pout)))
            if name == 'nufft_spread':
                row['max_taps_at_one_point'] = m_max
                # deterministic: a second launch gives the same grid, and
                # so does one under torch.use_deterministic_algorithms
                row['repeat_bit_identical'] = bool(torch.equal(
                    kout, run_kernel()))
                check(row['repeat_bit_identical'],
                      f'nufft_spread {label}: two launches differ')
                if dtype == torch.float64 and N > 1:
                    n0 = knf.LAUNCHES['nufft_spread']
                    with deterministic_algorithms():
                        det = run_kernel()
                    row['deterministic_mode_bit_identical'] = bool(
                        torch.equal(kout, det)) and (
                        knf.LAUNCHES['nufft_spread'] == n0 + 1)
                    check(row['deterministic_mode_bit_identical'],
                          f'nufft_spread {label}: under deterministic '
                          'algorithms')
                    del det
            if timed:
                row['ms'] = time_ms(run_kernel)
                row['samples_per_s'] = N * k.shape[-1] / row['ms'] * 1e3
            if timed and name == 'nufft_spread':
                # the binning alone (inside every launch), and what one
                # launch allocates at its peak (grid, plan, partial tiles)
                row['bin_ms'] = time_ms(lambda: knf.bin_plan(k, geom))
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated(dev)
                torch.cuda.reset_peak_memory_stats(dev)
                run_kernel()
                torch.cuda.synchronize()
                row['peak_mem_gb'] = (torch.cuda.max_memory_allocated(dev)
                                      - base) / 1e9
            if timed == 'full':
                row['plain_ms'] = time_ms(run_plain, reps=3)
                row.update(bound(run_plain, inputs, pout))
                sb = sector_bytes(N * k.shape[-1], W, len(im_size),
                                  grid.element_size())
                row.update(sector_bytes=sb, sector_ms=sb / HBM_BPS * 1e3)
            del kout, pout
            rows[name].append(row)
        if timed == 'full':
            # the library yardstick: one torch.sparse.mm of the
            # interpolation matrix (its build not timed); none for dk
            fi, fw, _ = knf.taps(k[0:1], geom)
            A, AT = interp_matrices(fi[0], fw[0], nG)
            del fi, fw
            for name, run, ref in (
                    ('nufft_sample', lambda: torch.sparse.mm(A, grid[0]),
                     lambda: knf.nufft_sample(grid, k, geom)[0]),
                    ('nufft_spread', lambda: torch.sparse.mm(AT, s[0]),
                     lambda: knf.nufft_spread(s, k, geom)[0])):
                row = rows[name][-1]
                row['library_ms'] = time_ms(run)
                row['library_rel_err'] = row_err(run(), ref())
            rows['nufft_dk'][-1]['library_ms'] = None
            del A, AT
        for name in NUFFT_KERNELS:
            print(f'{name} {label}: ' + json.dumps(rows[name][-1]),
                  flush=True)
            r = rows[name][-1]
            check(r['max_rel_err'] <= r['bar'], f"{name} {label}: "
                  f"{r['max_rel_err']} > {r['bar']}")
        del plan, grid, k, s, g
    return rows


# examples/recon3d.py at its defaults: a 32³ three-sphere phantom, FOV 24
# cm, 1200 golden-angle koosh-ball spokes (169,200 samples), data from
# the exact operator plus 1% complex noise (numpy default_rng(0)), the
# plan W 4 at osf 1.5, |k|² density weights calibrated to unit DC gain,
# and CG with the exact Toeplitz kernel (λ = 2e-4 of the PSF peak, 12
# iterations). Voxels where the JAX literals are held (flat indices).
RECON3D = dict(n=32, fov=24.0, spokes=1200, iters=12, noise=0.01, l2=2e-4,
               width=4, osf=1.5)
RECON3D_VOXELS = [0, 4681, 9362, 16912, 17424, 23405, 32767]
# Samples where its Pipe–Menon weights are held (0 and 84600 lie within
# 1e-3 cycle/cm of k = 0, where the spokes crowd).
RECON3D_SAMPLES = [0, 70, 5287, 84600, 120001, 169199]
# The Toeplitz CG of this problem amplifies rounding. JAX against itself
# (float64, CPU; tests/make_nufft_goldens.py prints it): a relative change
# of 1e-14 of the right-hand side moves iterate 4 by 3.6e-13, iterate 10
# by 3.7e-3 and iterate 12 by 1.4e-8 of the iterate's largest value; a
# 1-ulp change moves them by 9.3e-15, 5.3e-5 and 1.9e-10. The port's
# operators differ from JAX's by ~1e-14 (the gridding image), so iterate
# RECON3D_CG_EARLY is held to JAX at 1e-9 and iterate 12 at
# RECON3D_CG_BAR, about ten times the largest gap measured on the H100
# (1.1e-6).
RECON3D_CG_EARLY = 4
RECON3D_CG_BAR = 1e-5
# examples/recon_sense.py --op nufft on the RECON problem: the gridding
# plan W 5 at osf 2, Δf through 12 time segments (the example's --nseg).
RECON_NUFFT = dict(width=5, nseg=12)
# mrphy_tpu (JAX, gather route, eager, on the CPU), float64, on the RECON3D
# problem (tests/make_nufft_goldens.py prints these): the calibration
# image nufft_adjoint(w ⊙ nufft(𝟙)), the gridding image and the CG image
# after RECON3D_CG_EARLY iterations and after all, at RECON3D_VOXELS
# (voxels × re/im), each with its largest |value|; the Pipe–Menon weights
# dcf_pipe_menon(plan, ktraj) at RECON3D_SAMPLES and their largest value.
GOLDEN_RECON3D = {
    'cal': [[38495.043840248894, 6466.101988040318],
            [51312.38662780389, -2220.873337019489],
            [49928.41286739162, -2620.567820919223],
            [58450.85253139268, -1248.3980552944522],
            [51665.3539336957, -1548.700116859991],
            [49917.15185672466, 2617.420812833334],
            [38470.98917487, -6434.726837808256]],
    'cal_max': 72039.72546556692,
    'grid': [[-0.09337736890384546, -0.0021083242527327583],
             [0.22184913767988687, 0.043244121120498705],
             [0.1205257963745748, -0.18920475470601028],
             [2.6666448702480117, 0.02072324597170911],
             [0.17275791706497656, 0.15186676971662194],
             [0.2714224347461221, -0.2064771177403458],
             [-0.030565657487428798, -0.062244710853161404]],
    'grid_max': 2.6666448702480117,
    'cg_early': [[0.11741088002460362, -0.003621931134204669],
                 [0.05256258453161965, 0.002516449499459665],
                 [0.05180534584632296, -0.009973367331862333],
                 [1.148637463769864, -0.0005391086736985748],
                 [-0.040511631585280095, 0.009063146148615236],
                 [0.18915399331982918, -0.008554221079943976],
                 [0.013419740778441339, -0.00780886310673227]],
    'cg_early_max': 1.2866057655020091,
    'cg': [[0.3860272312413433, -0.02478344431618137],
           [0.022526325074024432, 0.006524000576616652],
           [0.010900153286812951, -0.04465834879239547],
           [1.2537989068543811, 0.008547498450711805],
           [0.05415108929185047, 0.02364508862449015],
           [0.10463400141309771, -0.04295675566901607],
           [0.03345376998686379, -0.03740236484415513]],
    'cg_max': 1.4990024731953542,
    'dcf': [1.8503607364420027e-09, 3.8004536150497965e-06,
            4.000202617960359e-06, 1.7692297243049936e-09,
            4.7935466888611275e-08, 1.4368501155121533e-06],
    'dcf_max': 1.850796140557777e-05}
# ... and on the RECON problem through the gridding NUFFT (recon_sense.py
# --op nufft): the signal at RECON_STEPS (coils × steps × re/im) and its
# largest |value|; ∂Σs²/∂ktraj of the plan-ordered (ky, kx) trajectory at
# RECON_STEPS (axes × steps) and its largest |value|; the 40-iteration
# CG-SENSE image at RECON_PIXELS (pixels × re/im).
GOLDEN_RECON_NUFFT = {
    's': [[[200.08870466292473, 48.23042891344485],
           [-47.82230837449346, -11.16476834012077],
           [-0.10006349174158366, -0.6390523576229266],
           [-0.2557261993842279, -0.7983227955545611],
           [1.1489977340949504, 1.4184125436222716]],
          [[203.01330280716408, 23.014660892987816],
           [-37.633044427772646, -31.382105040183497],
           [3.284012690703591, -0.8434382456843785],
           [0.9661873795007454, -1.899025685404892],
           [0.9883648933989078, 0.6660078124963589]],
          [[210.71758502978926, -8.93940918204309],
           [-38.79100162722489, -10.499845471540084],
           [1.2902915985386756, 2.231581287081692],
           [1.0598947027115335, -0.3429701060426986],
           [0.9213469593217426, 0.6775390080916232]],
          [[222.6122022751093, 27.434330856708023],
           [-38.42491774574913, -20.87319218752907],
           [-0.6778529166389022, 2.8112544075217336],
           [1.2749767231881592, 0.15556928415152843],
           [1.2753949293249875, 0.8059234418879601]]],
    's_max': 222.90892589138457,
    'dk': [[-553.7594922707649,
            -19689.684916230362,
            -983.3223265205471,
            -197.17885911107322,
            -70.76752851506745],
           [3377411.9264205126,
            -143928.74874676592,
            -711.4091505834011,
            -247.42838683062087,
            -40.28550761808722]],
    'dk_max': 4978634.721526625,
    'x': [[-9.75369411941461e-05, 0.00020017434205267198],
          [-0.00048236588967879207, 0.00020228572109085943],
          [0.6469664751453379, -0.06010295860619674],
          [0.6504978039149689, 0.017542170029195527],
          [0.9840952781198627, -0.184026951144503],
          [-0.0002487469120646824, -0.00022490536371426312]]}


def recon3d_arrays():
    r"""The RECON3D problem's numpy float64 inputs: the phantom ``img0``
    `(n, n, n, 2)`, the trajectory ``kt`` `(3, nT)`, the grid locations
    ``loc_`` `(1, n³, 3)` and the noise draw ``z`` `(nT, 2)`."""
    n, fov = RECON3D['n'], RECON3D['fov']
    ax = (np.arange(n) - n // 2) / n * fov
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing='ij')
    ph = np.zeros((n, n, n))
    for (cx, cy, cz, r, a) in ((0, 0, 0, 0.36 * fov, 1.0),
                               (0.12 * fov, 0, 0.08 * fov, 0.10 * fov,
                                -0.45),
                               (-0.14 * fov, -0.1 * fov, -0.06 * fov,
                                0.07 * fov, 0.6)):
        ph += a * ((X - cx) ** 2 + (Y - cy) ** 2 + (Z - cz) ** 2 < r * r)
    img0 = np.stack([ph, 0 * ph], -1)
    kt = radial3d_k(n, fov, RECON3D['spokes'])
    loc_ = np.stack([X, Y, Z], -1).reshape(1, -1, 3)
    z = np.random.default_rng(0).standard_normal((kt.shape[1], 2))
    return img0, kt, loc_, z


def recon3d_run(nf, sig, img0, kt, loc_, z):
    r"""examples/recon3d.py's pipeline on tensors through the port's
    ``ops.nufft`` (``nf``) and ``ops.signal`` (``sig``): returns the
    calibration image ``nufft_adjoint(w ⊙ nufft(𝟙))``, the gridding image,
    the CG image after RECON3D_CG_EARLY iterations and after all of them,
    and the plan."""
    n, fov = RECON3D['n'], RECON3D['fov']
    M = torch.cat([img0.reshape(1, -1, 2), img0.new_zeros((1, n ** 3, 1))],
                  -1)
    s = sig.signal(M, loc_, kt[None])[0, 0]                # (nT, 2)
    s = s + RECON3D['noise'] * float(s.abs().max()) * z
    plan = nf.nufft_plan((n,) * 3, (fov,) * 3, width=RECON3D['width'],
                         osf=RECON3D['osf'], dtype=img0.dtype,
                         device=img0.device)
    w = (kt * kt).sum(0)
    w = torch.where(w == 0, w[w > 0].min(), w)
    ones = torch.stack([torch.ones_like(img0[..., 0]),
                        torch.zeros_like(img0[..., 0])], -1)
    cal = nf.nufft_adjoint(plan, w[:, None] * nf.nufft(plan, ones, kt), kt)
    w = w / cal[..., 0].mean()
    grid_rec = nf.nufft_adjoint(plan, w[:, None] * s, kt)
    that = nf.toeplitz_kernel(plan, kt)
    b = nf.nufft_adjoint(plan, s, kt)
    lam = RECON3D['l2'] * float(that.abs().max())
    x, r = torch.zeros_like(b), b
    p, rs = r, (r * r).sum()
    for it in range(1, RECON3D['iters'] + 1):
        Ap = nf.toeplitz_apply(plan, that, p) + lam * p
        al = rs / (p * Ap).sum().clamp_min(1e-30)
        x, r = x + al * p, r - al * Ap
        rs2 = (r * r).sum()
        p = r + (rs2 / rs.clamp_min(1e-30)) * p
        rs = rs2
        if it == RECON3D_CG_EARLY:
            x_early = x
    return cal, grid_rec, x_early, x, plan


def recon_nufft_ops(nf, sens, df, k, n, fov):
    r"""examples/recon_sense.py --op nufft's operators on an n×n grid over
    ``fov``: ``A`` `(n², 2)` → `(1, nc, nT, 2)` (each coil's image through
    ``nufft``, with Δf segmentation unless ``df`` is None; the coils ride
    the batch axis) and its adjoint ``AH``; grid axis 0 is y, so the
    plan's trajectory is ``k[:, (1, 0)]``. Returns ``(A, AH, k2)``."""
    from mrphy_tpu_torch import dt0
    nc = sens.shape[-1]
    plan = nf.nufft_plan((n, n), (fov, fov), width=RECON_NUFFT['width'],
                         dtype=sens.dtype, device=sens.device)
    nkw = {} if df is None else dict(df=df.reshape(n, n), dt=dt0,
                                     nseg=RECON_NUFFT['nseg'])
    k2 = k[:, (1, 0), :].contiguous()                      # (1, 2, nT)
    sg = sens[0].reshape(n, n, 2, nc).movedim(-1, 0)       # (nc, n, n, 2)

    def A(x, kk=k2):
        xg = x.reshape(1, n, n, 2)
        w = torch.stack([sg[..., 0] * xg[..., 0] - sg[..., 1] * xg[..., 1],
                         sg[..., 0] * xg[..., 1] + sg[..., 1] * xg[..., 0]],
                        -1)
        return nf.nufft(plan, w, kk, **nkw)[None]

    def AH(s):
        xg = nf.nufft_adjoint(plan, s[0], k2, **nkw)       # (nc, n, n, 2)
        xr = sg[..., 0] * xg[..., 0] + sg[..., 1] * xg[..., 1]
        xi = sg[..., 0] * xg[..., 1] - sg[..., 1] * xg[..., 0]
        return torch.stack([xr, xi], -1).sum(0).reshape(n * n, 2)
    return A, AH, k2


def gridding_accuracy(nf, sig, plan, img, k, loc):
    r"""The plan against the exact operator on the same image and
    trajectory: ``‖nufft − signal‖/‖signal‖`` (K10 vs K7) and
    ``‖nufft_adjoint − signal_adjoint‖/‖signal_adjoint‖`` (K11 vs K9) of
    the forward's samples."""
    nM = loc.shape[1]
    M = torch.cat([img.reshape(1, nM, 2), img.new_zeros((1, nM, 1))], -1)
    k3 = k[None]
    s_ex = sig.signal(M, loc, k3)[0, 0]
    s_nf = nf.nufft(plan, img, k)
    x_ex = sig.signal_adjoint(s_ex[None, None], loc, k3)[0]
    x_nf = nf.nufft_adjoint(plan, s_ex, k).reshape(nM, 2)
    return (float(torch.linalg.vector_norm(s_nf - s_ex)
                  / torch.linalg.vector_norm(s_ex)),
            float(torch.linalg.vector_norm(x_nf - x_ex)
                  / torch.linalg.vector_norm(x_ex)))


def phase_nufft_path(dev):
    r"""Phase 15: the gridding path through the entry points: (a) the
    recon3d problem in float64 against JAX literals and the exact
    operator, with the example's own asserts; (b) the recon_sense --op
    nufft problem in float64 against JAX literals; (c) excite, then
    acquire through the NUFFT against the exact acquire; (d) the
    full-width 3-D case's nufft, adjoint, trajectory gradient and CG
    iteration, and its accuracy against the exact operator on a subset;
    (e) CG-SENSE at bench_recon width through the NUFFT."""
    from mrphy_tpu_torch import dt0, gamH
    from mrphy_tpu_torch.ops import nufft as nf
    from mrphy_tpu_torch.ops import signal as sig
    from mrphy_tpu_torch.utils import spiral2d
    out, bars = {}, {}
    f64 = torch.float64

    def arr(x, dtype=f64):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    # (a) the recon3d problem, float64
    img0, kt, loc_, z = (arr(a) for a in recon3d_arrays())
    cal, grid_rec, cg_early, cg_rec, plan = recon3d_run(nf, sig, img0, kt,
                                                        loc_, z)
    vox = torch.tensor(RECON3D_VOXELS, device=dev)
    for key, x, bar in (('cal', cal, 1e-9), ('grid', grid_rec, 1e-9),
                        ('cg_early', cg_early, 1e-9),
                        ('cg', cg_rec, RECON3D_CG_BAR)):
        ref = GOLDEN_RECON3D[key]
        out[f'recon3d_{key}_vs_jax'] = max_err(
            x.reshape(-1, 2)[vox].cpu(), torch.tensor(ref, dtype=f64)) / (
            GOLDEN_RECON3D[f'{key}_max'])
        bars[f'recon3d_{key}_vs_jax'] = bar

    def nrmse(x):
        return float(torch.linalg.vector_norm(x[..., 0] - img0[..., 0])
                     / torch.linalg.vector_norm(img0[..., 0]))

    out.update(recon3d_nT=int(kt.shape[1]), recon3d_nrmse_grid=nrmse(
        grid_rec), recon3d_nrmse_cg=nrmse(cg_rec))
    check(out['recon3d_nrmse_cg'] < out['recon3d_nrmse_grid'],
          'recon3d: CG does not beat gridding')
    bars['recon3d_nrmse_cg'] = 0.35               # the example's own bound
    fwd_err, adj_err = gridding_accuracy(nf, sig, plan, img0, kt, loc_)
    out.update(recon3d_nufft_vs_exact=fwd_err,
               recon3d_adjoint_vs_exact=adj_err)
    bars.update(recon3d_nufft_vs_exact=NUFFT_PLAN_ACC,
                recon3d_adjoint_vs_exact=NUFFT_PLAN_ACC)
    # Pipe–Menon weights of the recon3d trajectory (30 iterations of
    # nufft_spread then nufft_sample)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wd = nf.dcf_pipe_menon(plan, kt)
    torch.cuda.synchronize()
    out['recon3d_dcf_s'] = time.perf_counter() - t0
    smp = torch.tensor(RECON3D_SAMPLES, device=dev)
    out['recon3d_dcf_vs_jax'] = max_err(
        wd[smp].cpu(), torch.tensor(GOLDEN_RECON3D['dcf'], dtype=f64)) / (
        GOLDEN_RECON3D['dcf_max'])
    out['recon3d_dcf_max_vs_jax'] = abs(
        float(wd.abs().max()) / GOLDEN_RECON3D['dcf_max'] - 1)
    bars.update(recon3d_dcf_vs_jax=1e-9, recon3d_dcf_max_vs_jax=1e-9)
    del img0, kt, loc_, z, cal, grid_rec, cg_early, cg_rec, plan, wd

    # (b) examples/recon_sense.py --op nufft, float64
    loc, x_true, sens, df, k = (arr(a) for a in recon_arrays())
    A_ex, _ = recon_ops(loc, sens, df, k)
    s_acq = A_ex(x_true)                          # acquired exactly (K7)
    A, AH, k2 = recon_nufft_ops(nf, sens, df, k, RECON['n'], RECON['fov'])
    steps = torch.tensor(RECON_STEPS, device=dev)
    sn = A(x_true)
    out['recon_nufft_signal_vs_jax'] = max_err(
        sn[0][:, steps].cpu(), torch.tensor(GOLDEN_RECON_NUFFT['s'],
                                            dtype=f64)) / (
        GOLDEN_RECON_NUFFT['s_max'])
    kk = k2.clone().requires_grad_()
    dk, = torch.autograd.grad((A(x_true, kk) ** 2).sum(), kk)
    out['recon_nufft_dk_vs_jax'] = max_err(
        dk[0][:, steps].cpu(), torch.tensor(GOLDEN_RECON_NUFFT['dk'],
                                            dtype=f64)) / (
        GOLDEN_RECON_NUFFT['dk_max'])
    x, _ = cg_sense(A, AH, s_acq, RECON['iters'], RECON['lam'])
    px = torch.tensor(RECON_PIXELS, device=dev)
    out['recon_nufft_image_vs_jax'] = max_err(
        x[px].cpu(), torch.tensor(GOLDEN_RECON_NUFFT['x'], dtype=f64))
    out['recon_nufft_image_err'] = float(torch.linalg.vector_norm(
        x - x_true) / torch.linalg.vector_norm(x_true))
    bars.update(recon_nufft_signal_vs_jax=1e-9, recon_nufft_dk_vs_jax=1e-9,
                recon_nufft_image_vs_jax=1e-9,
                recon_nufft_image_err=0.02)       # the example's --op bound
    del loc, x_true, sens, df, k, s_acq, sn, dk, x

    # (c) excite (K1), then acquire through the NUFFT against the exact
    # acquire (K7): the 64³ cube of phase 13b, 8 coils, 16,384 samples of
    # a random readout at dt 1 µs, T2* ∈ [20, 100] ms and the cube's Δf
    # map scaled to ±10 Hz, so that 16 segments stay in the hat model's
    # valid regime (bench_nufft's note; the bar is the JAX test's)
    cube, pulse = cube64(torch.float32, dev)
    rng = np.random.default_rng(12)
    gr = arr(rng.uniform(-2, 2, (1, 3, SIG_NT)), torch.float32)
    sens = arr(rng.standard_normal((1, cube.nM, 2, SIG_NC)), torch.float32)
    T2s = arr(rng.uniform(2e-2, 1e-1, (1, cube.nM)), torch.float32)
    cube.applypulse(pulse, doUpdate=True)
    cube.df_ = cube.df_ * 0.1
    kw = dict(sens_=sens, T2s_=T2s, dt=1e-6)
    ts = {}
    for name, extra in (('exact', {}), ('nufft', dict(
            backend='nufft', width=6, nseg=16))):
        cube.acquire(gr, **kw, **extra)                   # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts[name] = cube.acquire(gr, **kw, **extra)
        torch.cuda.synchronize()
        out[f'cube64_acquire_{name}_s'] = time.perf_counter() - t0
    out['cube64_acquire_nufft_vs_exact'] = float(
        torch.linalg.vector_norm(ts['nufft'] - ts['exact'])
        / torch.linalg.vector_norm(ts['exact']))
    bars['cube64_acquire_nufft_vs_exact'] = 1e-3  # tests/test_nufft.py's
    del cube, ts, sens, T2s

    # (d) the full-width 3-D case, float32: a 128³ three-sphere phantom
    # through nufft, nufft_adjoint, ∂Σ|s|²/∂ktraj and a CG iteration
    n, fov = NUFFT3D['n'], NUFFT3D['fov']
    kt = arr(radial3d_k(n, fov, NUFFT3D['spokes']), torch.float32)
    nT = kt.shape[1]
    plan = nf.nufft_plan((n,) * 3, (fov,) * 3, osf=NUFFT3D['osf'],
                         width=NUFFT3D['width'], device=dev)
    ax = (torch.arange(n, device=dev) - n // 2) / n * fov
    X, Y, Z = torch.meshgrid(ax, ax, ax, indexing='ij')
    img = torch.stack([((X ** 2 + Y ** 2 + Z ** 2) < (0.36 * fov) ** 2)
                       .float() - 0.45 * (((X - 0.12 * fov) ** 2 + Y ** 2
                                          + (Z - 0.08 * fov) ** 2)
                                         < (0.1 * fov) ** 2).float(),
                       torch.zeros_like(X)], -1)
    s = nf.nufft(plan, img, kt)

    def grad_k():
        kk = kt.clone().requires_grad_()
        return torch.autograd.grad((nf.nufft(plan, img, kk) ** 2).sum(),
                                   kk)[0]

    def cg_iter():
        return nf.nufft_adjoint(plan, nf.nufft(plan, img, kt), kt)

    gk = grad_k()
    check(bool(torch.isfinite(gk).all()) and float(gk.abs().max()) > 0,
          'full-width trajectory gradient')
    del gk
    for name, fn in (('fwd', lambda: nf.nufft(plan, img, kt)),
                     ('adj', lambda: nf.nufft_adjoint(plan, s, kt)),
                     ('grad_k', grad_k), ('cg_iter', cg_iter)):
        fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        tms = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            tms.append(time.perf_counter() - t0)
        ms = statistics.median(tms) * 1e3
        out[f'nufft3d_{name}_ms'] = ms
        out[f'nufft3d_{name}_samples_per_s'] = nT / ms * 1e3
        out[f'nufft3d_{name}_peak_mem_gb'] = (
            torch.cuda.max_memory_allocated(dev) / 1e9)
    # the plan against the exact operator (K7, K9) on a 16,384-sample
    # subset: 2.1M spins × 16k samples
    loc = torch.stack([X, Y, Z], -1).reshape(1, -1, 3)
    sub = kt[:, ::max(1, nT // 16384)][:, :16384].contiguous()
    fwd_err, adj_err = gridding_accuracy(nf, sig, plan, img, sub, loc)
    out.update(nufft3d_nT=nT, nufft3d_nufft_vs_exact=fwd_err,
               nufft3d_adjoint_vs_exact=adj_err)
    bars.update(nufft3d_nufft_vs_exact=NUFFT_PLAN_ACC,
                nufft3d_adjoint_vs_exact=NUFFT_PLAN_ACC)
    del kt, plan, img, s, loc, X, Y, Z, sub

    # (e) CG-SENSE at bench_recon width through the NUFFT (phase 13c's
    # problem: 128×128, 8 random coils, the corner-covering spiral-out,
    # 10 iterations, float32; data from the exact operator), with the
    # voxels on the plan's grid x_j = fov·(j − n//2)/n (bench_recon's own
    # grid sits half a voxel off it)
    n, nc, fov, iters = (RECON_BENCH[k] for k in ('n', 'nc', 'fov', 'iters'))
    rng = np.random.default_rng(0)
    ax = (np.arange(n) - n // 2) / n * fov
    yy, xx = np.meshgrid(ax, ax, indexing='ij')
    loc = arr(np.stack([xx, yy, np.zeros_like(xx)], -1).reshape(1, n * n, 3),
              torch.float32)
    sens = arr(rng.standard_normal((1, n * n, 2, nc)), torch.float32)
    x_true = arr(rng.standard_normal((n * n, 2)), torch.float32)
    grs, _ = spiral2d(fov, int(np.ceil(1.42 * n)), direction='out')
    k = arr(gamH * dt0 * np.cumsum(grs, axis=2), torch.float32)
    A_ex, _ = recon_ops(loc, sens, None, k)
    s = A_ex(x_true)
    A, AH, _ = recon_nufft_ops(nf, sens, None, k, n, fov)
    cg_sense(A, AH, s, 1)                                 # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, _ = cg_sense(A, AH, s, iters)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    err = float(torch.linalg.vector_norm(x - x_true)
                / torch.linalg.vector_norm(x_true))
    out.update(bench_recon_nufft_image_err=err,
               bench_recon_nufft_s_per_iter=wall / iters)
    # the exact route's image error on this problem is 2.49e-3 (phase 13c,
    # H100): through the W 5 plan at osf 2 it stays within a few times that
    bars['bench_recon_nufft_image_err'] = 1e-2
    print('gridding path: ' + json.dumps(dict(measured=out, bars=bars)),
          flush=True)
    for key, bar in bars.items():
        check(out[key] <= bar, f'{key}: {out[key]} > {bar}')
    return out


# ==========================================================================
# The MRF path (phases 16-18)
# ==========================================================================

# benchmarks/suite.py bench_mrf_fisp (lines 969-1027): the canonical
# MRF-FISP dictionary, 65,536 atoms × 400 TRs, K 48, rf-spoiled phases,
# inversion prep (TI 18 ms), variable TR (11.5-14.5 ms), TE 2 ms; with and
# without spoiler diffusion (D ∈ [0.4, 3.2]e-5 cm²/s, dk 500 rad/cm).
MRF_FISP = dict(nA=65536, nTR=400, K=48, te=2e-3, ti=0.018, dk=500.0)
# Bars on max|kernel − plain| / max|plain|. Per-atom outputs (echoes,
# checkpoints, the per-atom gradient rows): the kernels follow the plain
# versions' operations (bit for bit expected); the per-TR coefficient rows
# are sums over atoms that the kernel takes by warps, in another order.
EPG_BAR = {torch.float32: 1e-6, torch.float64: 1e-12}
EPG_ROW_BAR = {torch.float32: 1e-4, torch.float64: 1e-12}
# The SPGR kernels' cases (phase 16): label, atoms, TRs, K (None: the
# default nTR·|kshift| + 1), dtype, mrf_fisp_case keywords (or
# ``pipe=True``: mrf_pipe_case, the trains phase 18's MRF path gives the
# kernels), timed.
EPG_CASES = (
    ('bench_mrf_pipeline dictionary 62,325 x 400, K 48, const TR', 62325,
     400, 48, torch.float32, dict(pipe=True), False),
    ('bench_mrf_pipeline refinement 4096 x 400, K 16', 4096, 400, 16,
     torch.float32, dict(pipe=True), False),
    ('bench_mrf_fisp 64k x 400, K 48', 65536, 400, 48, torch.float32, {},
     True),
    ('bench_mrf_fisp + diffusion', 65536, 400, 48, torch.float32,
     dict(D=True), True),
    ('16k x 200, K 32, const TR, b1', 16384, 200, 32, torch.float32,
     dict(vartr=False, b1=True), False),
    ('16k x 200, K 32, kshift -1', 16384, 200, 32, torch.float32,
     dict(kshift=-1), False),
    ('16k x 100, K 24, kshift 2, diffusion', 16384, 100, 24, torch.float32,
     dict(kshift=2, D=True), False),
    ('2048 x 400, default K 401 (device-memory state)', 2048, 400, None,
     torch.float32, {}, False),
    ('ragged 1001 x 200, K 32, b1, diffusion', 1001, 200, 32, torch.float32,
     dict(b1=True, D=True), False),
    ('f64 8192 x 200, K 32, b1, diffusion', 8192, 200, 32, torch.float64,
     dict(b1=True, D=True), False),
    ('f64 1000 x 200, default K 201 (device-memory state)', 1000, 200, None,
     torch.float64, dict(vartr=False), False),
)
EPG_KERNELS = ('spgr_fwd', 'spgr_fwd_chk', 'spgr_bwd')


def mrf_fisp_case(nA, nTR, K, dtype, dev, *, vartr=True, D=False, b1=False,
                  kshift=1, seed=0):
    r"""``epg_spgr`` keywords of the bench_mrf_fisp train at ``nA`` atoms ×
    ``nTR`` TRs, from ``seed``: flips 10-70°, rf-spoiled phases, T1 ∈ [0.2,
    3] s, T2 ∈ [0.02, 0.4] s, IR prep; optionally constant TR (12 ms),
    diffusion, a b1 map ∈ [0.8, 1.2]."""
    from mrphy_tpu_torch.ops import epg
    rng = np.random.default_rng(seed)
    t = np.arange(nTR)

    def arr(x):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    T1 = arr(rng.uniform(0.2, 3.0, nA))
    kw = dict(flips=arr(np.deg2rad(10 + 60 * np.abs(np.sin(np.pi * t / 75)))),
              phis=epg.rf_spoil_phases(nTR, dtype=dtype, device=dev),
              T1=T1, T2=arr(rng.uniform(0.02, 0.4, nA)),
              tr=(arr(0.0115 + 0.003 * (0.5 + 0.5 * np.sin(2 * np.pi * t
                                                          / 37)))
                  if vartr else 0.012),
              te=MRF_FISP['te'], zinit=epg.ir_prep(MRF_FISP['ti'], T1),
              kshift=kshift, K=K)
    if D:
        kw.update(D=arr(rng.uniform(0.4e-5, 3.2e-5, nA)), dk=MRF_FISP['dk'])
    if b1:
        kw['b1'] = arr(rng.uniform(0.8, 1.2, nA))
    return kw


def mrf_pipe_case(nA, nTR, K, dtype, dev, *, seed=0):
    r"""``epg_spgr`` keywords of phase 18's trains at ``nA`` atoms: the
    bench_mrf_pipeline flips (no phase, no prep), tr 12 ms, te 3 ms, and
    its grid's atoms, all of them (the dictionary) or ``nA`` drawn from
    ``seed`` (the refinement's first step: matched grid atoms)."""
    flips, T1, T2 = mrf_pipe_grid(dev)
    check(flips.shape[0] == nTR and nA <= T1.shape[0],
          f'{nA} x {nTR} is not a bench_mrf_pipeline train')
    if nA < T1.shape[0]:
        sel = torch.as_tensor(np.random.default_rng(seed).choice(
            T1.shape[0], nA, replace=False), device=dev)
        T1, T2 = T1[sel], T2[sel]
    return dict(flips=flips.to(dtype), phis=None, T1=T1.to(dtype),
                T2=T2.to(dtype), **dict(MRF_SEQ, K=K))


def spgr_args(kw):
    r"""The kernels' arguments ``(coef, par, cdiff, cfg)`` for
    ``epg_spgr(**kw)`` (``ops.epg._spgr_rows``)."""
    from mrphy_tpu_torch.ops import epg
    coef, par, cdiff, cfg, _ = epg._spgr_rows(**kw)
    return coef.contiguous(), par.contiguous(), cdiff, cfg


def sliced_err(a, b) -> float:
    r""":func:`max_err` over slices of the leading axis of at most 2²⁸
    elements each (the full-width checkpoints hold 13 GB in float32)."""
    step = max(1, (1 << 28) // max(a[0].numel(), 1))
    return max(max_err(a[i:i + step], b[i:i + step])
               for i in range(0, a.shape[0], step))


def compare_epg(name, run_kernel, run_plain, inputs, names, meta, dtype,
                timed, row_bar):
    r"""An EPG kernel against its plain version on the same arguments, their
    outputs ``names`` compared slice by slice: the per-atom ones at
    EPG_BAR of their largest value (bit for bit expected; the ``dpar`` rows
    and the ``dpkt`` entries that differ are named), ``dcoef`` (per-step
    rows, sums over atoms that
    the kernel takes by warps) at ``row_bar``; with ``timed``, the times,
    the bound and ``library_ms`` (null: no single PyTorch call computes an
    EPG train). Returns the row (``meta`` first)."""
    kout, pout = run_kernel(), run_plain()
    torch.cuda.synchronize()
    if isinstance(kout, torch.Tensor):
        kout, pout = (kout,), (pout,)
    pairs = dict(zip(names, zip(kout, pout)))
    abs_errs = {k: sliced_err(a, b) for k, (a, b) in pairs.items()}
    errs = {k: e / max(float(pairs[k][1].abs().max()), 1e-30)
            for k, e in abs_errs.items()}
    atom = [k for k in pairs if k != 'dcoef']
    row = dict(case=meta.pop('case'), dtype=str(dtype).replace('torch.', ''),
               **meta, err=errs, bar=EPG_BAR[dtype], row_bar=row_bar[dtype],
               per_atom_bit_identical=all(torch.equal(*pairs[k])
                                          for k in atom),
               max_abs_err=max(abs_errs[k] for k in atom),
               max_rel_err=max(errs[k] for k in atom))
    if 'dcoef' in pairs:
        row['max_row_rel_err'] = errs['dcoef']
        a, b = pairs['dpar']
        row['dpar_rows_differing'] = [i for i in range(a.shape[0])
                                      if not torch.equal(a[i], b[i])]
    if 'dpkt' in pairs:
        # the per-step entry gradients (nTR, 14, nA): the entries that differ
        a, b = pairs['dpkt']
        row['dpkt_rows_differing'] = [i for i in range(a.shape[1])
                                      if not torch.equal(a[:, i], b[:, i])]
    del kout, pairs
    if timed:
        row['ms'] = time_ms(run_kernel)
        # the plain version ran once above: one more run, timed
        row['plain_ms'] = time_ms(run_plain, reps=1, warm=False)
        row.update(bound(run_plain, inputs, pout))
        row['library_ms'] = None
    del pout
    print(f'{name} {row["case"]}: ' + json.dumps(row), flush=True)
    for k, e in errs.items():
        bar = row_bar[dtype] if k == 'dcoef' else EPG_BAR[dtype]
        check(e <= bar, f'{name} {row["case"]} {k}: {e} > {bar}')
    return row


def phase_epg_kernels(dev):
    r"""Phase 16: ``spgr_fwd``, ``spgr_fwd_chk`` and ``spgr_bwd`` against
    their plain versions on EPG_CASES at the entry point's chunk
    (``kernels.epg.adjoint_tc``; the adjoint fed the kernel's checkpoints
    and a cotangent drawn from a seed, its route reported;
    ``spgr_fwd_chk``'s route too, and where it takes the lanes, its echoes
    and checkpoints against the one-thread route's, bit for bit, both
    timed); the timed
    full-width cases with their bounds, ``spgr_fwd_chk`` also at
    ``pick_tc``'s chunk (``ms_pick_tc``); then, at bench_mrf_fisp width,
    the forward and the full gradient through ``epg_spgr`` (w.r.t. T1, T2,
    tr, and D). Returns each kernel's rows."""
    from mrphy_tpu_torch.kernels import epg as kepg
    rows = {name: [] for name in EPG_KERNELS}
    for seed, (label, nA, nTR, K, dtype, kw, timed) in enumerate(EPG_CASES,
                                                                 160):
        kw = dict(kw)
        make = mrf_pipe_case if kw.pop('pipe', False) else mrf_fisp_case
        coef, par, cdiff, cfg = spgr_args(make(nA, nTR, K, dtype, dev,
                                               seed=seed, **kw))
        tc = kepg.adjoint_tc(nTR, cfg.K, nA, par.element_size())
        pick = kepg.pick_tc(nTR, cfg.K, nA, par.element_size())
        sig = kepg.spgr_fwd(coef, par, cdiff, cfg)
        _, chk = kepg.spgr_fwd_chk(coef, par, cdiff, cfg, tc=tc)
        g = cotangent(sig, seed)
        runs = {
            'spgr_fwd': (lambda: kepg.spgr_fwd(coef, par, cdiff, cfg),
                         lambda: kepg.spgr_fwd_torch(coef, par, cdiff, cfg),
                         (coef, par, cdiff)),
            'spgr_fwd_chk': (
                lambda: kepg.spgr_fwd_chk(coef, par, cdiff, cfg, tc=tc),
                lambda: kepg.spgr_fwd_chk_torch(coef, par, cdiff, cfg,
                                                tc=tc),
                (coef, par, cdiff)),
            'spgr_bwd': (
                lambda: kepg.spgr_bwd(coef, par, cdiff, cfg, chk, g, tc=tc),
                lambda: kepg.spgr_bwd_torch(coef, par, cdiff, cfg, chk, g,
                                            tc=tc),
                (coef, par, cdiff, chk, g))}
        names = {'spgr_fwd': ('sig',), 'spgr_fwd_chk': ('sig', 'chk'),
                 'spgr_bwd': ('dcoef', 'dpar')}
        fwd_route = forward_meta(cfg.K, par, 6)
        for name, (run_kernel, run_plain, inputs) in runs.items():
            meta = dict(case=label, nA=nA, nTR=nTR, K=cfg.K,
                        kshift=cfg.kshift, tc=tc, pick_tc=pick)
            if name == 'spgr_bwd':
                meta['adjoint'] = adjoint_meta(cfg.K, par, 6, tc)
            else:
                meta['threads_state'] = kepg.launch_cfg(cfg.K,
                                                        par.element_size())
            if name == 'spgr_fwd_chk':
                meta['forward'] = fwd_route
            rows[name].append(compare_epg(
                name, run_kernel, run_plain, inputs, names[name], meta,
                dtype, timed, EPG_ROW_BAR))
            if name == 'spgr_fwd_chk' and fwd_route['route'] == 'lanes':
                # K14's lanes against its one-thread route, bit for bit,
                # and both timed at the chunk
                row = rows[name][-1]
                thread_check(row, name, run_kernel, kepg, 'forward_cfg',
                             names[name], dtype)
                row['lanes_ms'] = row.get('ms') or time_ms(run_kernel)
                orig = kepg.forward_cfg
                kepg.forward_cfg = lambda *a: kepg.ForwardCfg('thread', 1, 0)
                try:
                    row['thread_ms'] = time_ms(run_kernel)
                finally:
                    kepg.forward_cfg = orig
                print(f'spgr_fwd_chk {label}: ' + json.dumps(dict(
                    forward=fwd_route, lanes_ms=row['lanes_ms'],
                    thread_ms=row['thread_ms'])), flush=True)
            if name == 'spgr_fwd_chk' and timed:
                # the chunk the one-thread route took (pick_tc's)
                rows[name][-1]['ms_pick_tc'] = time_ms(
                    lambda: kepg.spgr_fwd_chk(coef, par, cdiff, cfg,
                                              tc=pick))
                print(f'spgr_fwd_chk {label}: tc {tc} ' + json.dumps(dict(
                    ms=rows[name][-1]['ms'], pick_tc=pick,
                    ms_pick_tc=rows[name][-1]['ms_pick_tc'])), flush=True)
        del coef, par, cdiff, sig, chk, g
    out = {}
    for D in (False, True):
        out.update(epg_entry_timing(dev, D))
    print('bench_mrf_fisp through epg_spgr: ' + json.dumps(out), flush=True)
    return rows


def epg_entry_timing(dev, D):
    r"""bench_mrf_fisp through the entry point: the forward (``spgr_fwd``)
    and the gradient of Σ w·signals w.r.t. T1, T2, tr (and D)
    (``spgr_fwd_chk`` + ``spgr_bwd``), times and atoms per second."""
    from mrphy_tpu_torch.ops import epg
    c = MRF_FISP
    kw = mrf_fisp_case(c['nA'], c['nTR'], c['K'], torch.float32, dev, D=D,
                       seed=7)
    w = cotangent(torch.empty((c['nA'], c['nTR'], 2), device=dev), 8)
    names = ('T1', 'tr') + (('D',) if D else ())

    def grad():
        xs = {n: kw[n].clone().requires_grad_() for n in names}
        T2 = kw['T2'].clone().requires_grad_()
        k2 = dict(kw, T2=T2, **xs,
                  zinit=epg.ir_prep(c['ti'], xs['T1']))
        return torch.autograd.grad((w * epg.epg_spgr(**k2)).sum(),
                                   (*xs.values(), T2))

    gs = grad()
    check(all(bool(torch.isfinite(x).all()) and float(x.abs().max()) > 0
              for x in gs), f'epg_spgr gradient (D={D})')
    tag = 'diff_' if D else ''
    fwd = time_ms(lambda: epg.epg_spgr(**kw), reps=3)
    gms = time_ms(grad, reps=3)
    return {f'{tag}fwd_ms': fwd, f'{tag}fwd_atoms_per_s': c['nA'] / fwd * 1e3,
            f'{tag}grad_ms': gms}


# benchmarks/suite.py bench_mrf_pipeline (lines 823-907): the dictionary
# of a 256 × 256 log-spaced (T1 0.2-3 s, T2 0.02-0.5 s) grid's T2 < T1
# atoms (62,325), 400 TRs of FISP (flips 10-60°, no phase), tr 12 ms, te 3
# ms, K 48, a rank-16 pair basis, 1,048,576 synthetic voxels (random atoms,
# receive phase, noise 0.002; numpy default_rng(0) for the atoms and
# phases, the noise from a torch generator seeded 0 on the card), and
# continuous refinement of 4096 voxels (batched, 50 Adam steps, lr 0.02,
# the model at K 16).
MRF_PIPE = dict(ntr=400, ngrid=256, nV=1 << 20, rank=16, nref=4096,
                iters=50, lr=0.02, noise=0.002)
MRF_SEQ = dict(tr=12e-3, te=3e-3, K=48)
# Bars on the matched filter: best within MATCH_BAR of the largest score;
# idx equal wherever the two atoms' scores differ by more than that.
MATCH_BAR = {torch.float32: 1e-5, torch.float64: 1e-12}
# K40's cases (phase 17) besides the pipeline's: label, atoms, voxels,
# rank, pair, dtype.
MATCH_CASES = (
    ('real 20000 atoms x 50000 voxels, r 24', 20000, 50000, 24, False,
     torch.float32),
    ('ragged pair 3001 x 10007, r 10', 3001, 10007, 10, True, torch.float32),
    ('f64 pair 5000 x 20000, r 16', 5000, 20000, 16, True, torch.float64),
)


def mrf_pipe_grid(dev):
    r"""The bench_mrf_pipeline flips and atoms ``(flips, T1, T2)``."""
    n, g = MRF_PIPE['ntr'], MRF_PIPE['ngrid']
    flips = torch.tensor(np.deg2rad(10 + 50 * np.abs(np.sin(np.arange(n)
                                                            / 40.0))),
                         dtype=torch.float32, device=dev)
    T1g, T2g = np.meshgrid(np.exp(np.linspace(np.log(0.2), np.log(3.0), g)),
                           np.exp(np.linspace(np.log(0.02), np.log(0.5), g)),
                           indexing='ij')
    keep = T2g < T1g
    return (flips, torch.tensor(T1g[keep], dtype=torch.float32, device=dev),
            torch.tensor(T2g[keep], dtype=torch.float32, device=dev))


def mrf_pipe_probes(D, dev):
    r"""bench_mrf_pipeline's synthetic volume from the dictionary ``D (nA,
    nTR, 2)``: ``(X (nV, nTR, 2), ks (nV,))``, random atoms with a receive
    phase and noise."""
    rng = np.random.default_rng(0)
    nV = MRF_PIPE['nV']
    ks = torch.as_tensor(rng.integers(0, D.shape[0], nV), device=dev)
    ph = torch.as_tensor(rng.uniform(-np.pi, np.pi, nV), dtype=D.dtype,
                         device=dev)[:, None, None]
    X = D[ks]
    X = torch.cos(ph) * X + torch.sin(ph) * torch.stack(
        [-X[..., 1], X[..., 0]], -1)
    gen = torch.Generator(device=dev).manual_seed(0)
    X += MRF_PIPE['noise'] * torch.randn(X.shape, generator=gen,
                                         dtype=D.dtype, device=dev)
    return X, ks


def phase_match_kernel(dev):
    r"""Phase 17: ``match`` against its plain version at bench_mrf_pipeline
    width (the unit-norm compressed atoms and their rotation, the 1M
    compressed probes), timed beside the library yardstick, and on
    MATCH_CASES (random unit-norm atoms). Returns the rows."""
    from mrphy_tpu_torch.kernels import mrf as kmrf
    from mrphy_tpu_torch.ops import epg, mrf
    flips, T1, T2 = mrf_pipe_grid(dev)
    D = epg.epg_spgr(flips, None, T1=T1, T2=T2, **MRF_SEQ)
    basis = mrf.svd_basis(D, rank=MRF_PIPE['rank'])
    Dc = mrf.compress(D, basis)
    X, _ = mrf_pipe_probes(D, dev)
    Xc = mrf.compress(X, basis)
    del D, X
    nrm = torch.linalg.vector_norm(Dc, dim=1)
    Dn = (Dc / nrm[:, None]).contiguous()
    with kmrf.full_f32_matmul():
        Dim = torch.matmul(Dn, basis.jc.T).contiguous()
    cases = [('bench_mrf_pipeline 62k atoms x 1M voxels, r 16', Dn, Dim, Xc,
              True, True)]
    rng = np.random.default_rng(170)
    for label, nA, nV, r, pair, dtype in MATCH_CASES:
        A = torch.as_tensor(rng.standard_normal((nA, r)), dtype=dtype,
                            device=dev)
        A = A / torch.linalg.vector_norm(A, dim=1, keepdim=True)
        Ai = torch.as_tensor(rng.standard_normal((nA, r)), dtype=dtype,
                             device=dev) if pair else None
        Xr = torch.as_tensor(rng.standard_normal((nV, r)), dtype=dtype,
                             device=dev)
        cases.append((label, A, Ai, Xr, pair, False))
    rows = []
    for label, A, Ai, Xr, pair, timed in cases:
        chunk = mrf._pick_chunk(Xr.shape[0], A.shape[0])

        def run_kernel():
            return kmrf.match(A, Ai, Xr, pairlike=pair)

        def run_plain():
            return kmrf.match_torch(A, Ai, Xr, pairlike=pair, chunk=chunk)

        (ik, bk), (ip, bp) = run_kernel(), run_plain()
        torch.cuda.synchronize()
        dtype = Xr.dtype
        top = float(bp.abs().max())
        err = max_err(bk, bp) / top
        # where the indices differ, the two atoms' scores (float64) must
        # be within the bar: a near-tie, not a wrong winner
        flip = torch.nonzero(ik != ip).reshape(-1)

        def score(idx):
            x = Xr[flip].double()
            s = (A[idx[flip].long()].double() * x).sum(-1)
            if pair:
                s = s * s + ((Ai[idx[flip].long()].double() * x).sum(-1)
                             ** 2)
            return s

        gap = float((score(ik) - score(ip)).abs().max()) / top \
            if len(flip) else 0.0
        row = dict(case=label, dtype=str(dtype).replace('torch.', ''),
                   nA=A.shape[0], nV=Xr.shape[0], r=A.shape[1], pair=pair,
                   max_rel_err=err, max_abs_err=max_err(bk, bp),
                   bar=MATCH_BAR[dtype], flips=len(flip),
                   max_flip_score_gap=gap)
        if timed:
            row['ms'] = time_ms(run_kernel)
            row['plain_ms'] = time_ms(run_plain, reps=3)
            row.update(bound(run_plain, (A, Ai, Xr), (ip, bp)))
            # the library yardstick: one matrix product per probe chunk
            # against the stacked atoms, then amax/argmax (TF32 off)
            AA = torch.cat([A, Ai]).T.contiguous()

            def library():
                out = []
                with kmrf.full_f32_matmul():
                    for c0 in range(0, Xr.shape[0], chunk):
                        s = torch.matmul(Xr[c0:c0 + chunk], AA)
                        mag = s[:, :A.shape[0]].square() + \
                            s[:, A.shape[0]:].square()
                        out.append((mag.argmax(-1), mag.amax(-1)))
                return out

            row['library_ms'] = time_ms(library, reps=3)
            del AA
        print(f'match {label}: ' + json.dumps(row), flush=True)
        check(err <= MATCH_BAR[dtype], f'match {label}: {err} > bar')
        check(gap <= MATCH_BAR[dtype], f'match {label}: a flipped atom '
              f'scores {gap} below the best')
        rows.append(row)
    return rows


# examples/mrf_dictionary.py's SPGR problem (its defaults, float64 here):
# 150 TRs of MRF-FISP (flips 10-70° in smooth lobes, rf-spoiled phases,
# inversion at TI 18 ms, variable TR around 12 ms, te 6 ms), a 24 × 24
# log-spaced (T1, T2) grid with T2 < T1, an SVD basis at energy 1 − 1e-8,
# an off-grid probe (T1 830 ms, T2 67 ms) with receive phase 0.6 and the
# same probe unrotated, matched in the compressed space, then refined by
# 250 Adam steps (lr 0.02) from the matched atom.
MRF_EX = dict(ntr=150, nt1=24, nt2=24, tr=0.012, ti=0.018, T1=0.83,
              T2=0.067, ph=0.6, iters=250, lr=0.02, energy=1 - 1e-8)
# the dictionary entries held to JAX: (atom, TR)
MRF_EX_ENTRIES = [(0, 0), (0, 149), (17, 3), (40, 77), (123, 100),
                  (200, 12), (299, 149)]


def mrf_example_arrays():
    r"""The MRF_EX problem's numpy float64 inputs: ``(flips, phis, trs,
    T1 (nA,), T2 (nA,))``."""
    c = MRF_EX
    n, tr = c['ntr'], c['tr']
    t = np.arange(n)
    flips = np.deg2rad(10 + 60 * np.abs(np.sin(np.pi * t / 75))
                       * (0.6 + 0.4 * np.cos(np.pi * t / n)))
    phis = np.deg2rad(117.0) * (t * (t + 1) / 2)
    trs = tr + 0.25 * tr * (0.5 + 0.5 * np.sin(2 * np.pi * t / 37)
                            + 0.3 * np.sin(2 * np.pi * t / 101))
    T1g, T2g = np.meshgrid(np.geomspace(0.2, 3.0, c['nt1']),
                           np.geomspace(0.02, 0.4, c['nt2']), indexing='ij')
    keep = T2g < T1g
    return flips, phis, trs, T1g[keep], T2g[keep]


# mrphy_tpu (JAX, XLA route on the CPU), float64, on the MRF_EX problem
# (tests/make_mrf_goldens.py prints these): the dictionary at
# MRF_EX_ENTRIES (re, im) and its largest |value|, the basis rank, the
# matched atoms of the two probes and their m0, the refined parameters
# [log T1, log T2, df/100] and the final score.
GOLDEN_MRF = {
    'D': [
        [0.0, 0.10649765086310957],
        [-0.0003949424643994148, -0.08854732645740174],
        [0.0006270594347519299, 0.1317228532171491],
        [-0.0015349693850757553, -0.08142235777885308],
        [-0.0016184931024839778, -0.08194631798763242],
        [0.007869736098386775, 0.03681035547371676],
        [-0.001999985587298194, -0.04013607230395464]],
    'D_max': 0.29920466507947835, 'rank': 34, 'idx': [276, 276],
    'm0': [[0.829213549138688, 0.5645577589750173],
           [1.0031527638718278, -0.00225956420266835]],
    'p': [-0.18632959012429984, -2.7030627239494507, 0.0],
    'score': 0.9999999999999997}


def phase_mrf_path(dev):
    r"""Phase 18: the MRF path through the entry points. (a)
    bench_mrf_pipeline: ``epg_spgr`` dictionary (``spgr_fwd``),
    ``svd_basis``, ``compress``, ``dict_match_compressed`` over 1M voxels
    (``match``), timed end to end, with the matched maps' error; then
    ``match_refine(batched=True)`` of 4096 voxels (``spgr_fwd_chk`` +
    ``spgr_bwd`` per step), timed, with the refined map's error. (b) The
    examples/mrf_dictionary.py problem in float64 against JAX's literals:
    the dictionary at 1e-10 of its largest value, the basis rank and the
    matched atoms equal, m0 at 1e-10, the refined parameters and score at
    rtol 1e-8."""
    from mrphy_tpu_torch.ops import epg, mrf
    out, bars = {}, {}
    # (a) the pipeline at bench_mrf_pipeline width
    flips, T1, T2 = mrf_pipe_grid(dev)
    D = epg.epg_spgr(flips, None, T1=T1, T2=T2, **MRF_SEQ)
    X, ks = mrf_pipe_probes(D, dev)
    del D

    def pipeline():
        D = epg.epg_spgr(flips, None, T1=T1, T2=T2, **MRF_SEQ)
        basis = mrf.svd_basis(D, rank=MRF_PIPE['rank'])
        Dc = mrf.compress(D, basis)
        Xc = mrf.compress(X, basis)
        return mrf.dict_match_compressed(Dc, Xc, basis)

    res = pipeline()
    torch.cuda.synchronize()
    tms = []
    for _ in range(3):
        t0 = time.perf_counter()
        pipeline()
        torch.cuda.synchronize()
        tms.append(time.perf_counter() - t0)
    t = statistics.median(tms)
    idx = res.idx.long()
    check(bool(torch.isfinite(res.score).all()), 'pipeline scores finite')
    e1 = float(((T1[idx] - T1[ks]).abs() / T1[ks]).median())
    e2 = float(((T2[idx] - T2[ks]).abs() / T2[ks]).median())
    out.update(pipeline_ms=t * 1e3, voxels_per_s=MRF_PIPE['nV'] / t,
               atoms=int(T1.shape[0]), median_T1_relerr=e1,
               median_T2_relerr=e2,
               exact_atom_share=float((idx == ks).double().mean()))
    bars.update(median_T1_relerr=0.02, median_T2_relerr=0.02)
    nref = MRF_PIPE['nref']
    p0 = torch.log(torch.stack([T1[idx[:nref]], T2[idx[:nref]]], -1))

    def sig_b(P):
        return epg.epg_spgr(flips, None, T1=torch.exp(P[:, 0]),
                            T2=torch.exp(P[:, 1]), tr=MRF_SEQ['tr'],
                            te=MRF_SEQ['te'], K=16)

    def refine():
        return mrf.match_refine(sig_b, p0, X[:nref],
                                iters=MRF_PIPE['iters'], lr=MRF_PIPE['lr'],
                                batched=True)

    refine()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    P, score = refine()
    torch.cuda.synchronize()
    t_ref = time.perf_counter() - t0
    check(bool(torch.isfinite(P).all()), 'refined parameters finite')
    kk = ks[:nref]
    out.update(refine_s=t_ref, refine_voxels_per_s=nref / t_ref,
               refine_ms_per_step=t_ref / MRF_PIPE['iters'] * 1e3,
               refine_T1_relerr=float(((torch.exp(P[:, 0]) - T1[kk]).abs()
                                       / T1[kk]).median()),
               refine_T2_relerr=float(((torch.exp(P[:, 1]) - T2[kk]).abs()
                                       / T2[kk]).median()),
               refine_min_score=float(score.min()))
    bars.update(refine_T1_relerr=0.05, refine_T2_relerr=0.05)
    del X, ks, res, P, score
    # (b) examples/mrf_dictionary.py in float64 against JAX
    out.update(mrf_example(dev))
    bars.update(example_D=1e-10, example_m0=1e-10, example_p=1e-8,
                example_score=1e-8)
    print('MRF path: ' + json.dumps(dict(measured=out, bars=bars)),
          flush=True)
    for key, bar in bars.items():
        check(out[key] <= bar, f'{key}: {out[key]} > {bar}')
    return out


def mrf_example(dev):
    r"""The MRF_EX problem in float64 on the card against GOLDEN_MRF:
    errors relative to each quantity's largest value (parameters and
    score: relative to each value)."""
    from mrphy_tpu_torch.ops import epg, mrf
    c, gold = MRF_EX, GOLDEN_MRF
    flips, phis, trs, T1a, T2a = (torch.as_tensor(x, device=dev) for x in
                                  mrf_example_arrays())

    def signals(T1, T2):
        return epg.epg_spgr(flips, phis, T1=T1, T2=T2, tr=trs,
                            te=c['tr'] / 2, zinit=epg.ir_prep(c['ti'], T1))

    D = signals(T1a, T2a)
    basis = mrf.svd_basis(D, energy=c['energy'])
    Dc = mrf.compress(D, basis)
    probe0 = signals(torch.tensor(c['T1'], dtype=torch.float64, device=dev),
                     torch.tensor(c['T2'], dtype=torch.float64, device=dev))
    cp, sp = np.cos(c['ph']), np.sin(c['ph'])
    probe = torch.stack([cp * probe0[..., 0] - sp * probe0[..., 1],
                         sp * probe0[..., 0] + cp * probe0[..., 1]], -1)
    res = mrf.dict_match_compressed(Dc, torch.stack([probe, probe0]), basis)
    best = int(res.idx[0])
    check([int(i) for i in res.idx] == gold['idx'],
          f"example match {res.idx.tolist()} != JAX's {gold['idx']}")
    check(basis.B.shape[1] == gold['rank'],
          f"example rank {basis.B.shape[1]} != JAX's {gold['rank']}")
    ents = torch.stack([D[a, t] for a, t in MRF_EX_ENTRIES]).cpu().numpy()

    def sig(p):
        return signals(torch.exp(p[0]), torch.exp(p[1]))

    p0 = torch.tensor([[np.log(float(T1a[best])), np.log(float(T2a[best])),
                        0.0]], dtype=torch.float64, device=dev)
    p, score = mrf.match_refine(sig, p0, probe[None], iters=c['iters'],
                                lr=c['lr'])
    p, score = p[0].cpu().numpy(), float(score[0])
    gp = np.asarray(gold['p'])
    return dict(
        example_D=float(np.abs(ents - np.asarray(gold['D'])).max()
                        / gold['D_max']),
        example_D_max_vs_jax=abs(float(D.abs().max()) - gold['D_max']),
        example_m0=float(np.abs(res.m0.cpu().numpy()
                                - np.asarray(gold['m0'])).max()
                         / np.abs(gold['m0']).max()),
        example_p=float(np.max(np.abs(p - gp) / np.maximum(np.abs(gp),
                                                           1e-300))),
        example_score=abs(score - gold['score']) / gold['score'],
        example_T1_fit=float(np.exp(p[0])), example_T2_fit=float(np.exp(p[1])),
        example_idx=[int(i) for i in res.idx], example_rank=gold['rank'])


# ==========================================================================
# The T2-mapping path (phases 19-20)
# ==========================================================================

# The full-width T2-mapping problem: a whole-brain multi-echo spin-echo
# volume, 1,048,576 voxels × 32 echoes (K 33) at esp 10 ms, float32. The
# refocusing is a nominal 150° train (examples/dwi_adc_fit.py's), scaled
# per voxel by b1 ∈ [0.7, 1.15], so no flip passes 180° (around 180° the
# echo magnitudes are symmetric in b1, and at a 180° nominal the b1
# gradient vanishes at the start value 1). T1 1 s; T2 ∈ [20, 300] ms, M0 ∈
# [0.7, 1.2] and b1 from numpy default_rng(0). The fit: Adam (lr 0.05) on
# (log T2, M0, b1) of the echo magnitudes' squared error, from T2 100 ms,
# M0 1, b1 1.
T2MAP = dict(nV=1 << 20, nE=32, esp=0.01, flip=150.0, T1=1.0, T2=(0.02, 0.3),
             M0=(0.7, 1.2), b1=(0.7, 1.15), iters=50, lr=0.05, T2_0=0.1)
# The CPMG kernels' cases (phase 19): label, atoms, echoes, dtype,
# cpmg_case keywords, timed. ``t2map``: T2MAP's train and tissue; otherwise
# bench_mrf's CPMG dictionary train (benchmarks/suite.py:626-630: flips
# uniform(120°, 180°), esp 10 ms) with the options named. The chunk is the
# entry point's (kernels.epg.adjoint_tc: where the adjoint's lane route
# takes the shape, the largest divisor of the train within the states it
# keeps in shared memory, 4 at K 33 in float32), or with ``tc='pick'``
# pick_tc's own.
CPMG_CASES = (
    ('T2 map 1M x 32, K 33, b1 (full width)', 1 << 20, 32, torch.float32,
     dict(t2map=True), True),
    ('bench_mrf CPMG 64k x 32, flips 120-180', 65536, 32, torch.float32, {},
     True),
    ('64k x 32, esp train 8-12 ms, diffusion', 65536, 32, torch.float32,
     dict(varesp=True, D=True), False),
    ('64k x 32, slice profile: alpha_ex, phi_ex, M0', 65536, 32,
     torch.float32, dict(ex=True), False),
    ('64k x 32, b1', 65536, 32, torch.float32, dict(b1=True), False),
    ('ragged 1001 x 32, every option', 1001, 32, torch.float32,
     dict(b1=True, varesp=True, D=True, ex=True), False),
    ('64k x 32 at pick_tc 32 (beyond the 4 shared states: one thread per '
     'atom)', 65536, 32, torch.float32, dict(tc='pick'), False),
    ('2048 x 400, K 401 (device-memory state), diffusion', 2048, 400,
     torch.float32, dict(D=True), False),
    ('f64 65,536 x 32, every option', 65536, 32, torch.float64,
     dict(b1=True, varesp=True, D=True, ex=True), False),
    ('f64 1000 x 200, K 201 (device-memory state), b1', 1000, 200,
     torch.float64, dict(b1=True), False),
)
CPMG_KERNELS = ('cpmg_fwd', 'cpmg_fwd_chk', 'cpmg_bwd')


def t2map_truth(nV, dtype, dev, seed=0):
    r"""T2MAP's nominal train ``(nE,)`` and the tissue ``(T2, M0, b1)``,
    each ``(nV,)``, from ``seed``."""
    c = T2MAP
    rng = np.random.default_rng(seed)

    def arr(x):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    return (arr(np.full(c['nE'], np.deg2rad(c['flip']))),
            *(arr(rng.uniform(*c[k], nV)) for k in ('T2', 'M0', 'b1')))


def cpmg_case(nA, nE, dtype, dev, *, t2map=False, b1=False, varesp=False,
              D=False, ex=False, seed=0):
    r"""``(flips, keywords)`` of ``epg_cpmg`` at ``nA`` atoms × ``nE``
    echoes, from ``seed``: T2MAP's (``t2map``), else bench_mrf's CPMG train
    (flips uniform(120°, 180°), esp 10 ms, T1 ∈ [0.2, 3] s, T2 ∈ [0.02,
    0.4] s) with, as asked, an esp train of 8-12 ms, diffusion (D ∈ [0.5,
    3]·10⁻⁵ cm²/s, dk 450 rad/cm), a per-voxel excitation (``alpha_ex`` ∈
    [60°, 100°], ``phi_ex`` ∈ [0, 2π), ``M0`` ∈ [0.7, 1.2]) and b1 ∈ [0.7,
    1.15]."""
    if t2map:
        flips, T2, M0, b1v = t2map_truth(nA, dtype, dev, seed)
        return flips, dict(T1=T2MAP['T1'], T2=T2, esp=T2MAP['esp'], M0=M0,
                           b1=b1v)
    rng = np.random.default_rng(seed)

    def arr(x):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    flips = arr(np.deg2rad(rng.uniform(120, 180, nE)))
    kw = dict(T1=arr(rng.uniform(0.2, 3.0, nA)),
              T2=arr(rng.uniform(0.02, 0.4, nA)),
              esp=arr(rng.uniform(0.008, 0.012, nE)) if varesp else 0.01)
    if D:
        kw.update(D=arr(rng.uniform(0.5e-5, 3e-5, nA)), dk=450.0)
    if ex:
        kw.update(alpha_ex=arr(np.deg2rad(rng.uniform(60, 100, nA))),
                  phi_ex=arr(rng.uniform(0, 2 * np.pi, nA)),
                  M0=arr(rng.uniform(0.7, 1.2, nA)))
    if b1:
        kw['b1'] = arr(rng.uniform(0.7, 1.15, nA))
    return flips, kw


def adjoint_meta(K, par, planes, tc) -> dict:
    r"""The route K15/K18 (``planes`` 6), K21/K24/K27/K30 (12) or K33/K36
    (8) takes at chunk ``tc`` (``kernels.epg.adjoint_cfg``): the lanes per
    atom G, the order slots a lane M, the chunk states an atom keeps in
    shared memory S (the chunk's tc of them are used), or one thread per
    atom."""
    from mrphy_tpu_torch.kernels import epg as kepg
    return kepg.adjoint_cfg(K, par.element_size(), planes, tc)._asdict()


def forward_meta(K, par, planes=12) -> dict:
    r"""The route K20, K23, K26 or K29 (``planes`` 12) or K14, K17 (6)
    takes (``kernels.epg.forward_cfg``, by shape alone, for any chunk): the
    lanes per atom G and the order slots a lane M, or one thread per atom
    (``threads_state`` then says how)."""
    from mrphy_tpu_torch.kernels import epg as kepg
    return kepg.forward_cfg(K, par.element_size(), planes)._asdict()


def thread_check(row, name, run_kernel, mod, kind, names, dtype):
    r"""A lane case of kernel ``name`` against its one-thread route:
    ``run_kernel`` once as it is and once with ``mod.<kind>``
    (``forward_cfg`` or ``adjoint_cfg``) giving one thread per atom. A
    forward's outputs must agree bit for bit; an adjoint's per-atom
    outputs at EPG_BAR and its ``dcoef`` rows at EPG_ROW_BAR of their
    largest value (the sums over the orders and over a warp's atoms run in
    another order). The result goes into ``row`` and is printed."""
    from mrphy_tpu_torch.kernels import epg as kepg
    lanes = run_kernel()
    thread = (kepg.ForwardCfg('thread', 1, 0) if kind == 'forward_cfg'
              else kepg.AdjointCfg('thread', 1, 0, 0))
    orig = getattr(mod, kind)
    setattr(mod, kind, lambda *a: thread)
    try:
        one = run_kernel()
    finally:
        setattr(mod, kind, orig)
    torch.cuda.synchronize()
    pairs = dict(zip(names, zip(lanes, one)))
    if kind == 'forward_cfg':
        row['thread_bit_identical'] = all(torch.equal(a, b)
                                          for a, b in pairs.values())
        out = dict(thread_bit_identical=row['thread_bit_identical'])
        check(row['thread_bit_identical'],
              f'{name} {row["case"]}: lanes != one thread per atom')
    else:
        errs = {k: sliced_err(a, b) / max(float(b.abs().max()), 1e-30)
                for k, (a, b) in pairs.items()}
        row['thread_err'] = errs
        out = dict(thread_err=errs)
        for k, e in errs.items():
            bar = (EPG_ROW_BAR if k == 'dcoef' else EPG_BAR)[dtype]
            check(e <= bar, f'{name} {row["case"]} {k} lanes vs one '
                  f'thread: {e} > {bar}')
    print(f'{name} {row["case"]} against one thread per atom: '
          + json.dumps(out), flush=True)
    del lanes, one, pairs


def phase_cpmg_kernels(dev):
    r"""Phase 19: ``cpmg_fwd``, ``cpmg_fwd_chk`` and ``cpmg_bwd`` against
    their plain versions on CPMG_CASES, the arguments ``epg_cpmg`` gives
    them (``ops.epg._cpmg_rows``; the adjoint fed the kernel's checkpoints
    and a cotangent drawn from a seed, the plain adjoint written out, with
    no autograd graph); the timed cases with their bounds. Returns each
    kernel's rows."""
    from mrphy_tpu_torch.kernels import epg as kepg
    from mrphy_tpu_torch.ops import epg
    t0 = time.perf_counter()
    rows = {name: [] for name in CPMG_KERNELS}
    for seed, (label, nA, nE, dtype, kw, timed) in enumerate(CPMG_CASES,
                                                             190):
        kw = dict(kw)
        choose = kepg.pick_tc if kw.pop('tc', None) == 'pick' \
            else kepg.adjoint_tc
        flips, ckw = cpmg_case(nA, nE, dtype, dev, seed=seed, **kw)
        coef, par, dq, cdiff, cfg, _ = epg._cpmg_rows(flips, **ckw)
        args = (coef.contiguous(), par.contiguous(), dq.contiguous(), cdiff,
                cfg)
        tc = choose(nE, cfg.K, nA, par.element_size())
        chk = kepg.cpmg_fwd_chk(*args, tc=tc)[2]
        gr, gi = cotangent(torch.empty((2, nE, nA), dtype=dtype, device=dev),
                           seed)
        runs = {
            'cpmg_fwd': (lambda: kepg.cpmg_fwd(*args),
                         lambda: kepg.cpmg_fwd_torch(*args), args[:4]),
            'cpmg_fwd_chk': (lambda: kepg.cpmg_fwd_chk(*args, tc=tc),
                             lambda: kepg.cpmg_fwd_chk_torch(*args, tc=tc),
                             args[:4]),
            'cpmg_bwd': (
                lambda: kepg.cpmg_bwd(*args, chk, gr, gi, tc=tc),
                lambda: kepg.cpmg_bwd_torch(*args, chk, gr, gi, tc=tc),
                args[:4] + (chk, gr, gi))}
        names = {'cpmg_fwd': ('er', 'ei'), 'cpmg_fwd_chk': ('er', 'ei', 'chk'),
                 'cpmg_bwd': ('dcoef', 'dpar')}
        fwd_route = forward_meta(cfg.K, par, 6)
        adj_route = adjoint_meta(cfg.K, par, 6, tc)
        for name, (run_kernel, run_plain, inputs) in runs.items():
            meta = dict(case=label, nA=nA, nE=nE, K=cfg.K, tc=tc,
                        pick_tc=kepg.pick_tc(nE, cfg.K, nA,
                                             par.element_size()),
                        threads_state=kepg.launch_cfg(cfg.K,
                                                      par.element_size()),
                        adjoint=adj_route)
            if name == 'cpmg_fwd_chk':
                meta['forward'] = fwd_route
            rows[name].append(compare_epg(
                name, run_kernel, run_plain, inputs, names[name], meta,
                dtype, timed, EPG_ROW_BAR))
            if name == 'cpmg_fwd_chk' and fwd_route['route'] == 'lanes':
                thread_check(rows[name][-1], name, run_kernel, kepg,
                             'forward_cfg', names[name], dtype)
            if name == 'cpmg_bwd' and adj_route['route'] == 'lanes':
                thread_check(rows[name][-1], name, run_kernel, kepg,
                             'adjoint_cfg', names[name], dtype)
        del args, coef, par, dq, chk, gr, gi
    print(f'phase 19 took {time.perf_counter() - t0:.1f} s', flush=True)
    return rows


# examples/dwi_adc_fit.py's problem (its defaults, float64 here): 64 voxels,
# 16 echoes at esp 12 ms, 150° refocusing, crushers of 150, 450 and 900
# rad/cm per half-esp, T1 1.2 s, T2 ∈ [40, 150] ms and D ∈ [0.8, 3]·10⁻⁵
# cm²/s from numpy default_rng(0); the echo magnitudes' mean squared error
# fitted by 400 Adam steps (lr 0.03) on (log T2, log D) from T2 80 ms, D
# 1.5·10⁻⁵ cm²/s.
CPMG_EX = dict(nV=64, nE=16, esp=0.012, flip=150.0, dks=(150.0, 450.0, 900.0),
               T1=1.2, T2_0=0.08, D_0=1.5e-5, lr=0.03, iters=400, seed=0)
# the target magnitudes held to JAX: (crusher, voxel, echo)
CPMG_EX_ENTRIES = [(0, 0, 0), (0, 0, 15), (1, 17, 3), (2, 40, 8),
                   (2, 63, 15), (1, 5, 0)]
CPMG_EX_VOXELS = [0, 17, 40, 63]
CPMG_EX_LOSS_STEPS = [0, 1, 10, 100, 200, 399]


def cpmg_example_arrays():
    r"""CPMG_EX's true ``(T2, D)``, each ``(nV,)`` numpy float64."""
    c = CPMG_EX
    rng = np.random.default_rng(c['seed'])
    return rng.uniform(0.04, 0.15, c['nV']), rng.uniform(0.8e-5, 3.0e-5,
                                                         c['nV'])


# mrphy_tpu (JAX, XLA route on the CPU), float64, on the CPMG_EX problem
# (tests/make_cpmg_goldens.py prints these): the target magnitudes at
# CPMG_EX_ENTRIES and their largest value, the first loss, its gradient at
# CPMG_EX_VOXELS and each gradient's largest magnitude, the losses at
# CPMG_EX_LOSS_STEPS and the fitted (log T2, log D) at CPMG_EX_VOXELS.
GOLDEN_CPMG = {
    'target': [0.8355428975475192, 0.17738958798126095, 0.5841005784233358,
               0.22365425589005103, 0.07887585380146138, 0.8494513740236077],
    'target_max': 0.8589395062526837, 'loss0': 0.008893643864103505,
    'grad0': {
        'lt2': [-0.0006496251528362569, -0.00037130754278583383,
                -0.000526453489948111, -0.000562471842004976],
        'ld': [7.101789405370038e-05, 2.9621692243936134e-05,
                5.996111776093009e-05, 6.650274631722084e-05]},
    'p': {
        'lt2': [-2.206677041019813, -2.306987426807726,
                -2.2743059305113587, -2.2649371308254027],
        'ld': [-11.136455693719023, -10.874060287761319,
                -11.186874051947186, -11.252938838367182]},
    'grad0_max': {'lt2': 0.001236473408647605,
                  'ld': 0.0001497086162014868},
    'losses': [0.008893643864103505, 0.007619856155919824,
               0.0015684406047467591, 1.5911301766902777e-06,
               1.0723356411409576e-07, 4.731788613513388e-10]}


def phase_t2map_path(dev):
    r"""Phase 20: the T2-mapping path through ``epg_cpmg``. (a) At T2MAP's
    full width: the forward (``cpmg_fwd``), timed in voxels per second; the
    gradient of the magnitudes' squared error w.r.t. T2, M0 and b1
    (``cpmg_fwd_chk`` + ``cpmg_bwd``), timed; the Adam fit of (log T2, M0,
    b1): s per step, voxels per second per gradient step, peak memory and
    the median relative T2 error. (b) The CPMG_EX problem in float64
    against JAX's literals (:func:`cpmg_example`)."""
    from mrphy_tpu_torch.ops import epg
    t0 = time.perf_counter()
    c = T2MAP
    out, bars = {}, {}
    flips, T2t, M0t, b1t = t2map_truth(c['nV'], torch.float32, dev)

    def mag(T2, M0, b1):
        e = epg.epg_cpmg(flips, T1=c['T1'], T2=T2, esp=c['esp'], M0=M0,
                         b1=b1)
        return torch.linalg.vector_norm(e, dim=-1)

    target = mag(T2t, M0t, b1t)
    check(target.shape == (c['nV'], c['nE'])
          and bool(torch.isfinite(target).all()), 'T2 map echoes')

    def loss(lt2, M0, b1):
        return ((mag(torch.exp(lt2), M0, b1) - target) ** 2).sum()

    def start():
        one = torch.ones(c['nV'], device=dev)
        return [(one * np.log(c['T2_0'])).requires_grad_(),
                one.clone().requires_grad_(), one.clone().requires_grad_()]

    P = start()

    def grad():
        return torch.autograd.grad(loss(*P), P)

    gs = grad()
    check(all(bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
              for g in gs), 'T2 map gradient')
    fwd = time_ms(lambda: mag(T2t, M0t, b1t), reps=3)
    gms = time_ms(grad, reps=3)
    out.update(fwd_ms=fwd, fwd_voxels_per_s=c['nV'] / fwd * 1e3,
               grad_ms=gms, grad_voxels_per_s=c['nV'] / gms * 1e3)
    # the fit
    P = start()
    opt = torch.optim.Adam(P, lr=c['lr'])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    losses = []
    t1 = time.perf_counter()
    for _ in range(c['iters']):
        opt.zero_grad()
        val = loss(*P)
        val.backward()
        opt.step()
        losses.append(val.detach())
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t1) / c['iters']
    losses = [float(v) for v in losses]
    T2f = torch.exp(P[0].detach())
    out.update(
        fit_s_per_step=step_s, fit_voxels_per_s=c['nV'] / step_s,
        fit_peak_mem_GB=torch.cuda.max_memory_allocated(dev) / 1e9,
        fit_loss_first=losses[0], fit_loss_last=losses[-1],
        start_median_T2_relerr=float(((c['T2_0'] - T2t).abs() / T2t)
                                     .median()),
        median_T2_relerr=float(((T2f - T2t).abs() / T2t).median()),
        median_b1_relerr=float(((P[2].detach() - b1t).abs() / b1t)
                               .median()))
    check(all(np.isfinite(losses)) and losses[-1] < 0.1 * losses[0],
          f'T2 map fit: loss {losses[0]} -> {losses[-1]}')
    bars['median_T2_relerr'] = 0.1
    del target, P, gs, opt
    # (b) examples/dwi_adc_fit.py in float64 against JAX
    out.update(cpmg_example(dev))
    bars.update(example_target=1e-10, example_loss0=1e-10,
                example_grad0=1e-9, example_losses=1e-8, example_p=1e-8)
    print('T2-mapping path: ' + json.dumps(dict(measured=out, bars=bars)),
          flush=True)
    for key, bar in bars.items():
        check(out[key] <= bar, f'{key}: {out[key]} > {bar}')
    print(f'phase 20 took {time.perf_counter() - t0:.1f} s', flush=True)
    return out


def cpmg_example(dev):
    r"""The CPMG_EX problem in float64 on the card against GOLDEN_CPMG,
    through ``epg_cpmg`` with the shared ``(nE,)`` train (so the float64
    kernels run): the target magnitudes relative to their largest, the
    first loss relative to itself, its gradient relative to each one's
    largest, the losses along the fit and the fitted (log T2, log D)
    relative to each value."""
    from mrphy_tpu_torch.ops import epg
    c, gold = CPMG_EX, GOLDEN_CPMG
    f64 = dict(dtype=torch.float64, device=dev)
    T2t, Dt = (torch.as_tensor(x, **f64) for x in cpmg_example_arrays())
    flips = np.deg2rad(c['flip']) * torch.ones(c['nE'], **f64)

    def model(T2, D):
        return torch.stack([torch.hypot(*epg.epg_cpmg(
            flips, T1=c['T1'], T2=T2, esp=c['esp'], D=D, dk=dk).unbind(-1))
            for dk in c['dks']])

    target = model(T2t, Dt)

    def loss(p):
        return torch.mean((model(torch.exp(p['lt2']), torch.exp(p['ld']))
                           - target) ** 2)

    p = {'lt2': torch.full((c['nV'],), np.log(c['T2_0']), **f64),
         'ld': torch.full((c['nV'],), np.log(c['D_0']), **f64)}
    for x in p.values():
        x.requires_grad_()
    opt = torch.optim.Adam(list(p.values()), lr=c['lr'])
    losses = []
    for i in range(c['iters']):
        opt.zero_grad()
        val = loss(p)
        val.backward()
        if i == 0:
            g0 = {k: x.grad.clone() for k, x in p.items()}
        opt.step()
        losses.append(float(val.detach()))
    tgt = target.cpu().numpy()
    vox = CPMG_EX_VOXELS

    def rel(a, b):
        a, b = np.asarray(a), np.asarray(b)
        return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))

    return dict(
        example_target=float(np.max(np.abs(
            [tgt[e] for e in CPMG_EX_ENTRIES] - np.asarray(gold['target'])))
            / gold['target_max']),
        example_loss0=rel(losses[0], gold['loss0']),
        example_grad0=max(float(np.max(np.abs(g0[k][vox].cpu().numpy()
                                              - gold['grad0'][k])))
                          / gold['grad0_max'][k] for k in ('lt2', 'ld')),
        example_losses=rel([losses[i] for i in CPMG_EX_LOSS_STEPS],
                           gold['losses']),
        example_p=max(rel(p[k].detach()[vox].cpu().numpy(), gold['p'][k])
                      for k in ('lt2', 'ld')),
        example_T2_fit_maxrel=float(((torch.exp(p['lt2'].detach()) - T2t)
                                     .abs() / T2t).max()),
        example_D_fit_maxrel=float(((torch.exp(p['ld'].detach()) - Dt)
                                    .abs() / Dt).max()))


# ==========================================================================
# The exchange-MRF path (phases 21-22)
# ==========================================================================

# benchmarks/suite.py bench_mrf (lines 560-600): the two-pool (EPG-X)
# dictionary, 65,536 atoms × 400 TRs, K 48, tr 12 ms, its flip train (10-60°
# in smooth lobes plus 0.01 rad of noise, no phase), T1a ∈ [0.2, 3] s, T2a ∈
# [0.02, 0.5] s, T1b ∈ [0.2, 0.6] s, T2b ∈ [5, 30] ms, kab ∈ [1, 10] /s, kba
# ∈ [5, 40] /s, M0a 1 and M0b 0.1 (the defaults: no detailed balance); numpy
# default_rng drawn in bench_mrf's order.
XMRF = dict(nA=65536, nTR=400, K=48, tr=12e-3)
# Bars on the adjoint's per-TR rows (sums over atoms, by warps and then over
# warps in a fixed order, against torch.sum): max|Δ| / max|row|. Per-atom
# outputs at EPG_BAR (bit for bit expected).
XSPGR_ROW_BAR = {torch.float32: 5e-7, torch.float64: 1e-15}
# The EPG-X kernels' cases (phase 21): label, atoms, TRs, K (None: the
# default nTR·|kshift| + 1), dtype, xmrf_case keywords (or ``pipe=True``
# and a flip ``scale``: mrfx_pipe_case, the segments phase 22a's
# exchange-MRF path gives the kernels), timed.
XSPGR_CASES = (
    ('bench_mrf two-pool 64k x 400, K 48', 65536, 400, 48, torch.float32, {},
     True),
    ('f64 8192 x 200, K 32, b1, dfb, M0b, rf-spoiled', 8192, 200, 32,
     torch.float64, dict(b1=True, dfb=True, M0b=True, phis=True), False),
    ('16k x 200, K 32, b1', 16384, 200, 32, torch.float32, dict(b1=True),
     False),
    ('16k x 200, K 32, dfb -20..20 Hz, rf-spoiled', 16384, 200, 32,
     torch.float32, dict(dfb=True, phis=True), False),
    ('16k x 200, K 32, kshift -1, M0b', 16384, 200, 32, torch.float32,
     dict(kshift=-1, M0b=True), False),
    ('16k x 100, K 37, kshift 2 (K not a multiple of the lanes)', 16384, 100,
     37, torch.float32, dict(kshift=2), False),
    ('16k x 100, K 24, kshift 9 (a shift past the 8 lanes, in pieces)',
     16384, 100, 24, torch.float32, dict(kshift=9), False),
    ('16k x 200, K 32, no detailed balance (kab 8, kba 3, M0b 0.4)', 16384,
     200, 32, torch.float32, dict(ndb=True), False),
    ('ragged 1001 x 200, K 32, b1, dfb', 1001, 200, 32, torch.float32,
     dict(b1=True, dfb=True), False),
    ('2048 x 200, default K 201 (device-memory state)', 2048, 200, None,
     torch.float32, {}, False),
    ('f64 1000 x 100, default K 101 (device-memory state), b1', 1000, 100,
     None, torch.float64, dict(b1=True), False),
    ('exchange-MRF dictionary segment 65,536 x 200, K 48, 0.5x flips',
     65536, 200, 48, torch.float32, dict(pipe=True, scale=0.5), False),
    ('exchange-MRF dictionary segment 65,536 x 200, K 48, 1.6x flips',
     65536, 200, 48, torch.float32, dict(pipe=True, scale=1.6), False),
    ('exchange-MRF refinement 4096 x 200, K 48, 1.6x flips (tc = nTR)',
     4096, 200, 48, torch.float32, dict(pipe=True, scale=1.6), False),
)
XSPGR_KERNELS = ('xspgr_fwd', 'xspgr_fwd_chk', 'xspgr_bwd')


def xmrf_case(nA, nTR, K, dtype, dev, *, b1=False, dfb=False, M0b=False,
              phis=False, kshift=1, ndb=False, vartr=False, seed=0):
    r"""``epgx_spgr`` keywords of bench_mrf's two-pool train at ``nA`` atoms
    × ``nTR`` TRs from ``seed`` (the flips' noise and the maps drawn in
    bench_mrf's order) and, as asked: per-atom b1 ∈ [0.8, 1.2], dfb ∈ [−20,
    20] Hz, M0b ∈ [0.05, 0.3], rf-spoiled phases, ``kshift``, no detailed
    balance (kab 8, kba 3, M0b 0.4), or in place of tr 12 ms bench_mrf's
    variable-TR train ``12e-3 + 6e-3·U(0, 1)`` (drawn after the maps, as
    bench_mrf draws it)."""
    from mrphy_tpu_torch.ops import epg
    rng = np.random.default_rng(seed)

    def arr(x):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    t = np.arange(nTR)
    kw = dict(flips=arr(np.deg2rad(10 + 50 * np.abs(np.sin(t / 40.0)))
                        + 0.01 * rng.standard_normal(nTR)),
              phis=(epg.rf_spoil_phases(nTR, dtype=dtype, device=dev) if phis
                    else None),
              T1a=arr(rng.uniform(0.2, 3.0, nA)),
              T2a=arr(rng.uniform(0.02, 0.5, nA)),
              T1b=arr(rng.uniform(0.2, 0.6, nA)),
              T2b=arr(rng.uniform(0.005, 0.03, nA)),
              kab=arr(rng.uniform(1.0, 10.0, nA)),
              kba=arr(rng.uniform(5.0, 40.0, nA)), tr=XMRF['tr'],
              kshift=kshift, K=K)
    if vartr:
        kw['tr'] = arr(12e-3 + 6e-3 * rng.random(nTR))
    if b1:
        kw['b1'] = arr(rng.uniform(0.8, 1.2, nA))
    if dfb:
        kw['dfb'] = arr(rng.uniform(-20, 20, nA))
    if M0b:
        kw['M0b'] = arr(rng.uniform(0.05, 0.3, nA))
    if ndb:
        kw.update(kab=8.0, kba=3.0, M0a=1.0, M0b=0.4)
    return kw


def xspgr_args(kw):
    r"""The kernels' arguments ``(coef, par, cfg)`` for ``epgx_spgr(**kw)``
    (``ops.epg._xspgr_rows``)."""
    from mrphy_tpu_torch.ops import epg
    kw = dict(kw)
    coef, par, cfg, _ = epg._xspgr_rows(kw.pop('flips'), kw.pop('phis'),
                                        **kw)
    return coef.contiguous(), par.contiguous(), cfg


def phase_xspgr_kernels(dev):
    r"""Phase 21: ``xspgr_fwd``, ``xspgr_fwd_chk`` and ``xspgr_bwd`` against
    their plain versions on XSPGR_CASES, the arguments ``epgx_spgr`` gives
    them (among them the dictionary segments and the refinement step of
    phase 22a's path, at its chunk; the adjoint fed the kernel's
    checkpoints and a cotangent drawn from a seed, the plain adjoint
    written out, with no autograd graph); the
    timed full-width case with its bound. Per-atom outputs (echoes,
    checkpoints, the 17 per-atom gradient rows) at EPG_BAR of their largest
    value (bit for bit expected), the per-TR rows at XSPGR_ROW_BAR. Returns
    each kernel's rows."""
    from mrphy_tpu_torch.kernels import epg as kepg
    from mrphy_tpu_torch.kernels import epgx as kx
    t0 = time.perf_counter()
    rows = {name: [] for name in XSPGR_KERNELS}
    for seed, (label, nA, nTR, K, dtype, kw, timed) in enumerate(
            XSPGR_CASES, 210):
        kw = dict(kw)
        make = mrfx_pipe_case if kw.pop('pipe', False) else xmrf_case
        coef, par, cfg = xspgr_args(make(nA, nTR, K, dtype, dev, seed=seed,
                                         **kw))
        tc = kepg.adjoint_tc(nTR, cfg.K, nA, par.element_size(), kx.PLANES)
        chk = kx.xspgr_fwd_chk(coef, par, cfg, tc=tc)[1]
        g = cotangent(torch.empty((nA, nTR, 2), dtype=dtype, device=dev),
                      seed)
        runs = {
            'xspgr_fwd': (lambda: kx.xspgr_fwd(coef, par, cfg),
                          lambda: kx.xspgr_fwd_torch(coef, par, cfg),
                          (coef, par)),
            'xspgr_fwd_chk': (
                lambda: kx.xspgr_fwd_chk(coef, par, cfg, tc=tc),
                lambda: kx.xspgr_fwd_chk_torch(coef, par, cfg, tc=tc),
                (coef, par)),
            'xspgr_bwd': (
                lambda: kx.xspgr_bwd(coef, par, cfg, chk, g, tc=tc),
                lambda: kx.xspgr_bwd_torch(coef, par, cfg, chk, g, tc=tc),
                (coef, par, chk, g))}
        names = {'xspgr_fwd': ('sig',), 'xspgr_fwd_chk': ('sig', 'chk'),
                 'xspgr_bwd': ('dcoef', 'dpar')}
        for name, (run_kernel, run_plain, inputs) in runs.items():
            meta = dict(case=label, nA=nA, nTR=nTR, K=cfg.K,
                        kshift=cfg.kshift, tc=tc,
                        pick_tc=kepg.pick_tc(nTR, cfg.K, nA,
                                             par.element_size(), kx.PLANES),
                        threads_state=kepg.launch_cfg(
                            cfg.K, par.element_size(), kx.PLANES),
                        adjoint=adjoint_meta(cfg.K, par, kx.PLANES, tc))
            if name.endswith('_fwd_chk'):
                meta['forward'] = forward_meta(cfg.K, par)
            rows[name].append(compare_epg(
                name, run_kernel, run_plain, inputs, names[name], meta,
                dtype, timed, XSPGR_ROW_BAR))
        del coef, par, chk, g
    print(f'phase 21 took {time.perf_counter() - t0:.1f} s', flush=True)
    return rows


# The variable-TR EPG-X kernels' cases (phase 23): label, atoms, TRs, K
# (None: the default nTR·|kshift| + 1), dtype, xmrf_case keywords with a
# tr train (or ``pipe=True`` and a flip ``scale``: mrfx_pipe_case over the
# example's tr trains, the segments phase 24a's path gives the kernels; or
# ``const=True``: a constant train, whose echoes must also equal
# ``xspgr_fwd``'s at the same scalar tr), timed.
XMRF_V = dict(nA=65536, nTR=400, K=24)
XSPGR_V_CASES = (
    ('bench_mrf variable-TR two-pool 64k x 400, K 24', 65536, 400, 24,
     torch.float32, dict(vartr=True), True),
    ('exchange-MRF dictionary segment 65,536 x 200, K 48, 0.5x flips, trs',
     65536, 200, 48, torch.float32, dict(pipe=True, scale=0.5), False),
    ('exchange-MRF dictionary segment 65,536 x 200, K 48, 1.6x flips, '
     'trs reversed', 65536, 200, 48, torch.float32,
     dict(pipe=True, scale=1.6), False),
    ('exchange-MRF refinement 4096 x 200, K 48, 1.6x flips, trs reversed '
     '(tc = nTR)', 4096, 200, 48, torch.float32, dict(pipe=True, scale=1.6),
     False),
    ('f64 8192 x 200, K 32, b1, dfb, M0b, rf-spoiled', 8192, 200, 32,
     torch.float64, dict(b1=True, dfb=True, M0b=True, phis=True,
                         vartr=True), False),
    ('16k x 200, K 32, kshift -1, M0b', 16384, 200, 32, torch.float32,
     dict(kshift=-1, M0b=True, vartr=True), False),
    ('16k x 200, K 32, no detailed balance (kab 8, kba 3, M0b 0.4)', 16384,
     200, 32, torch.float32, dict(ndb=True, vartr=True), False),
    ('ragged 1001 x 200, K 32, b1, dfb', 1001, 200, 32, torch.float32,
     dict(b1=True, dfb=True, vartr=True), False),
    ('2048 x 200, default K 201 (device-memory state)', 2048, 200, None,
     torch.float32, dict(vartr=True), False),
    ('f64 1000 x 100, default K 101 (device-memory state), b1', 1000, 100,
     None, torch.float64, dict(b1=True, vartr=True), False),
    ('16k x 200, K 32, constant train (= xspgr_fwd at tr 12 ms)', 16384, 200,
     32, torch.float32, dict(const=True), False),
)
XSPGR_V_KERNELS = ('xspgr_v_fwd', 'xspgr_v_fwd_chk', 'xspgr_v_bwd')


def phase_xspgr_v_kernels(dev):
    r"""Phase 23: ``xspgr_v_fwd``, ``xspgr_v_fwd_chk`` and ``xspgr_v_bwd``
    against their plain versions on XSPGR_V_CASES, the arguments
    ``epgx_spgr`` gives them over a ``(nTR,)`` tr train (``coef``, ``pk``
    and the per-step planes ``pkt``; the adjoint fed the kernel's
    checkpoints and a cotangent drawn from a seed, the plain adjoint
    written out, with no autograd graph): the timed full-width case
    (``bench_mrf``'s variable-TR train) with its bound, the segments and the
    refinement step of phase 24a's path at its chunk, and the options.
    Per-atom outputs (echoes, checkpoints, ``dpar`` = [dM0a, dM0b, db1] and
    ``dpkt`` per atom and step) at EPG_BAR of their largest value (bit for
    bit expected; the rows that differ named), the per-TR rows at
    XSPGR_ROW_BAR; a constant train's echoes also against ``xspgr_fwd``'s
    at the scalar tr. Then ``epgx_spgr`` at the full-width case through the
    entry point: the forward and the gradient of Σ signals² w.r.t. (T1a,
    kab), timed, with the peak memory. Returns each kernel's rows."""
    from mrphy_tpu_torch.kernels import epg as kepg
    from mrphy_tpu_torch.kernels import epgx as kx
    from mrphy_tpu_torch.ops import epg
    t0 = time.perf_counter()
    rows = {name: [] for name in XSPGR_V_KERNELS}
    const = {}
    for seed, (label, nA, nTR, K, dtype, kw, timed) in enumerate(
            XSPGR_V_CASES, 230):
        kw, fixed = dict(kw), None
        if kw.pop('pipe', False):
            case = mrfx_pipe_case(nA, nTR, K, dtype, dev, seed=seed,
                                  vartr=True, **kw)
        elif kw.pop('const', False):
            case = xmrf_case(nA, nTR, K, dtype, dev, seed=seed, **kw)
            fixed = xspgr_args(case)                 # at the scalar tr
            case['tr'] = torch.full((nTR,), XMRF['tr'], dtype=dtype,
                                    device=dev)
        else:
            case = xmrf_case(nA, nTR, K, dtype, dev, seed=seed, **kw)
        coef, (pk, pkt), cfg, _ = epg._xspgr_rows(case.pop('flips'),
                                                  case.pop('phis'), **case)
        coef, pk, pkt = coef.contiguous(), pk.contiguous(), pkt.contiguous()
        tc = kepg.adjoint_tc(nTR, cfg.K, nA, pk.element_size(), kx.PLANES)
        chk = kx.xspgr_v_fwd_chk(coef, pk, pkt, cfg, tc=tc)[1]
        g = cotangent(torch.empty((nA, nTR, 2), dtype=dtype, device=dev),
                      seed)
        runs = {
            'xspgr_v_fwd': (lambda: kx.xspgr_v_fwd(coef, pk, pkt, cfg),
                            lambda: kx.xspgr_v_fwd_torch(coef, pk, pkt, cfg),
                            (coef, pk, pkt)),
            'xspgr_v_fwd_chk': (
                lambda: kx.xspgr_v_fwd_chk(coef, pk, pkt, cfg, tc=tc),
                lambda: kx.xspgr_v_fwd_chk_torch(coef, pk, pkt, cfg, tc=tc),
                (coef, pk, pkt)),
            'xspgr_v_bwd': (
                lambda: kx.xspgr_v_bwd(coef, pk, pkt, cfg, chk, g, tc=tc),
                lambda: kx.xspgr_v_bwd_torch(coef, pk, pkt, cfg, chk, g,
                                             tc=tc),
                (coef, pk, pkt, chk, g))}
        names = {'xspgr_v_fwd': ('sig',), 'xspgr_v_fwd_chk': ('sig', 'chk'),
                 'xspgr_v_bwd': ('dcoef', 'dpar', 'dpkt')}
        for name, (run_kernel, run_plain, inputs) in runs.items():
            meta = dict(case=label, nA=nA, nTR=nTR, K=cfg.K,
                        kshift=cfg.kshift, tc=tc,
                        pick_tc=kepg.pick_tc(nTR, cfg.K, nA,
                                             pk.element_size(), kx.PLANES),
                        threads_state=kepg.launch_cfg(
                            cfg.K, pk.element_size(), kx.PLANES),
                        adjoint=adjoint_meta(cfg.K, pk, kx.PLANES, tc))
            if name.endswith('_fwd_chk'):
                meta['forward'] = forward_meta(cfg.K, pk)
            rows[name].append(compare_epg(
                name, run_kernel, run_plain, inputs, names[name], meta,
                dtype, timed, XSPGR_ROW_BAR))
        if fixed is not None:
            # a constant train: the fixed-TR kernel at the same scalar tr
            sig = kx.xspgr_v_fwd(coef, pk, pkt, cfg)
            sig0 = kx.xspgr_fwd(*fixed)
            const = dict(case=label, bit_identical=torch.equal(sig, sig0),
                         err=sliced_err(sig, sig0)
                         / float(sig0.abs().max()))
            print('xspgr_v_fwd constant train vs xspgr_fwd: '
                  + json.dumps(const), flush=True)
            check(const['err'] <= EPG_BAR[dtype],
                  f"constant train vs xspgr_fwd: {const['err']}")
            del sig, sig0
        del coef, pk, pkt, chk, g, fixed
    check(bool(const), 'no constant-train case ran')
    out = xspgr_v_entry_timing(dev)
    print('bench_mrf variable-TR two-pool through epgx_spgr: '
          + json.dumps(out), flush=True)
    print(f'phase 23 took {time.perf_counter() - t0:.1f} s', flush=True)
    return rows


def xspgr_v_entry_timing(dev):
    r"""bench_mrf's variable-TR two-pool train (XMRF_V) through
    ``epgx_spgr``: the forward (``xspgr_v_fwd``), and the gradient of Σ
    signals² w.r.t. (T1a, kab) (``xspgr_v_fwd_chk`` + ``xspgr_v_bwd`` and
    autograd of the per-step planes) as bench_mrf's ``gxv``; times, atoms
    per second and the gradient's peak memory."""
    from mrphy_tpu_torch.ops import epg
    c = XMRF_V
    kw = xmrf_case(c['nA'], c['nTR'], c['K'], torch.float32, dev,
                   vartr=True)
    fl, ph = kw.pop('flips'), kw.pop('phis')

    def fwd():
        return epg.epgx_spgr(fl, ph, **kw)

    def grad():
        xs = {n: kw[n].clone().requires_grad_() for n in ('T1a', 'kab')}
        sig = epg.epgx_spgr(fl, ph, **dict(kw, **xs))
        return torch.autograd.grad((sig ** 2).sum(), list(xs.values()))

    fwd_ms = time_ms(fwd)
    gr = grad()
    check(all(bool(torch.isfinite(x).all()) for x in gr),
          'variable-TR gradient finite')
    del gr
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    grad_ms = time_ms(grad, reps=3)
    return dict(fwd_ms=fwd_ms, fwd_atoms_per_s=c['nA'] / (fwd_ms / 1e3),
                grad_ms=grad_ms, grad_atoms_per_s=c['nA'] / (grad_ms / 1e3),
                grad_peak_mem_GB=torch.cuda.max_memory_allocated(dev) / 1e9)


# The exchange-MRF path at full width (phase 22a): examples/mrfx_exchange.py's
# pool (T2a 80 ms, T1b 1 s, T2b 20 ms, M0a 1, M0b 0.15, kba = kab/M0b) and
# flip train (8-63° in smooth lobes), in two segments at 0.5× and 1.6× the
# train, each 200 TRs of rf-spoiled phases, at a scalar tr of 15 ms (phase
# 22a) or over the example's variable-TR schedule, 12-18 ms, reversed for
# the second segment (phase 24a, :func:`mrfx_trs`), K 48, float32; a
# 256 × 256 (T1a, kab) grid, T1a geometric 0.4-2.2 s, kab linear 1-15 /s:
# 65,536 atoms; a rank-16 pair basis; 1,048,576 probe voxels at 4096
# off-grid truths (T1a, kab uniform in log T1a and in kab inside the grid,
# numpy default_rng(0)), 256 voxels a truth, each with a receive phase and
# noise 1e-5 (a torch generator seeded 0 on the card); the probes of one
# voxel per truth (4096) also matched in float64; 50 Adam steps (lr 0.02)
# refine those 4096 voxels. The noise: at 1e-4 the maximum-likelihood kab
# of a voxel lies further from its truth than the grid's half step, so no
# refinement could lower the kab error.
XMRF_PIPE = dict(ntr=200, ngrid=256, tr=0.015, K=48, rank=16, nV=1 << 20,
                 ntruth=4096, noise=1e-5, iters=50, lr=0.02,
                 T1a=(0.4, 2.2), kab=(1.0, 15.0), scales=(0.5, 1.6))
XMRF_POOL = dict(T2a=0.08, T1b=1.0, T2b=0.02, M0a=1.0, M0b=0.15)


def mrfx_grid(dev):
    r"""XMRF_PIPE's (T1a, kab) grid: its axes ``(t1g, kg)`` (numpy) and its
    atoms ``(T1a, kab)`` (float32 on ``dev``, T1a-major)."""
    c = XMRF_PIPE
    t1g = np.geomspace(*c['T1a'], c['ngrid'])
    kg = np.linspace(*c['kab'], c['ngrid'])
    T1g, Kg = np.meshgrid(t1g, kg, indexing='ij')
    return (t1g, kg,
            torch.tensor(T1g.ravel(), dtype=torch.float32, device=dev),
            torch.tensor(Kg.ravel(), dtype=torch.float32, device=dev))


def mrfx_pipe_case(nA, nTR, K, dtype, dev, *, scale, vartr=False, seed=0):
    r"""``epgx_spgr`` keywords of one segment of phase 22a's path (the
    train at ``scale`` of the example's flips, as :func:`mrfx_gen` gives
    them; with ``vartr`` phase 24a's, over the example's tr train, reversed
    for the second segment) at the grid's atoms: all of them (the
    dictionary) or ``nA`` drawn from ``seed`` (the refinement's first step:
    matched grid atoms)."""
    c = XMRF_PIPE
    _, _, T1a, kab = mrfx_grid(dev)
    check(nTR == c['ntr'] and nA <= T1a.shape[0],
          f'{nA} x {nTR} is not an exchange-MRF segment')
    if nA < T1a.shape[0]:
        sel = torch.as_tensor(np.random.default_rng(seed).choice(
            T1a.shape[0], nA, replace=False), device=dev)
        T1a, kab = T1a[sel], kab[sel]
    flips, phis = mrfx_train(nTR, dtype, dev)
    T1a, kab = T1a.to(dtype), kab.to(dtype)
    tr = c['tr']
    if vartr:
        tr = mrfx_trs(nTR, dtype, dev)[list(c['scales']).index(scale)]
    return dict(XMRF_POOL, flips=flips * scale, phis=phis, T1a=T1a, kab=kab,
                kba=kab / XMRF_POOL['M0b'], tr=tr, K=K)


def mrfx_train(ntr, dtype, dev):
    r"""examples/mrfx_exchange.py's flip train and rf-spoiled phases."""
    from mrphy_tpu_torch.ops import epg
    t = np.arange(ntr)
    flips = torch.tensor(np.deg2rad(8 + 55 * np.abs(np.sin(np.pi * t / 60))),
                         dtype=dtype, device=dev)
    return flips, epg.rf_spoil_phases(ntr, dtype=dtype, device=dev)


def mrfx_trs(ntr, dtype, dev):
    r"""examples/mrfx_exchange.py's variable-TR schedule, one train per
    segment: ``trs = 0.012 + 0.006·(0.5 + 0.5·sin(2πt/41))`` s, then
    ``trs[::-1]``."""
    t = np.arange(ntr)
    trs = 0.012 + 0.006 * (0.5 + 0.5 * np.sin(2 * np.pi * t / 41))
    return (torch.tensor(trs, dtype=dtype, device=dev),
            torch.tensor(trs[::-1].copy(), dtype=dtype, device=dev))


def mrfx_gen(flips, phis, T1a, kab, *, tr, K, scales):
    r"""The exchange-MRF signal of (T1a, kab): the two flip-scale segments
    of ``epgx_spgr`` at the example's pool, concatenated along the TRs;
    ``tr`` a scalar, or one tr train per segment (:func:`mrfx_trs`)."""
    from mrphy_tpu_torch.ops import epg
    kw = dict(XMRF_POOL, T1a=T1a, kab=kab, kba=kab / XMRF_POOL['M0b'], K=K)
    trs = tr if isinstance(tr, tuple) else (tr,) * len(scales)
    return torch.cat([epg.epgx_spgr(flips * f, phis, tr=t, **kw)
                      for f, t in zip(scales, trs)], dim=-2)


def mrfx_pipeline(dev, vartr):
    r"""The exchange-MRF pipeline through the entry points (phases 22a and
    24a), at a scalar tr or, with ``vartr``, over the example's tr trains
    (:func:`mrfx_trs`; the variable-TR kernels ``xspgr_v_*`` in place of
    ``xspgr_*``). At XMRF_PIPE's full width: the ``epgx_spgr`` dictionary
    (``xspgr_fwd``), timed in atoms per second; ``svd_basis``, ``compress`` and
    ``dict_match_compressed`` of the 1M probe voxels (``match``), timed in
    voxels per second, with the matched maps' median errors (relative, and
    in grid steps: bars 1.5 on T1a and 3 on kab; float32 does not resolve
    the kab grid, so the probes of 4096 voxels are matched again in
    float64, bar 1.5 grid steps on both axes);
    ``match_refine(batched=True)`` of 4096 voxels (``xspgr_fwd_chk`` +
    ``xspgr_bwd`` per segment and step), s per step, with the refined
    medians (both must fall); peak memory; the
    example's exchange-sensitivity check (kab 1 against 15 moves the
    signal by more than 2%). Returns ``(measured, bars)``."""
    from mrphy_tpu_torch.ops import mrf
    c = XMRF_PIPE
    out, bars = {}, {}
    flips, phis = mrfx_train(c['ntr'], torch.float32, dev)

    def seq(dtype):
        return dict(tr=mrfx_trs(c['ntr'], dtype, dev) if vartr else c['tr'],
                    K=c['K'], scales=c['scales'])
    n = c['ngrid']
    t1g, kg, T1, Kab = mrfx_grid(dev)
    # exchange sensitivity: kab must move the signal
    one = torch.ones(1, device=dev)
    s_lo = mrfx_gen(flips, phis, one, one, **seq(torch.float32))
    s_hi = mrfx_gen(flips, phis, one, 15 * one, **seq(torch.float32))
    out['kab_separation'] = float((s_lo - s_hi).abs().max()
                                  / s_lo.abs().max())
    check(out['kab_separation'] > 0.02,
          f"kab separation {out['kab_separation']} <= 0.02")

    def dictionary():
        return mrfx_gen(flips, phis, T1, Kab, **seq(torch.float32))

    D = dictionary()
    torch.cuda.synchronize()
    check(D.shape == (n * n, 2 * c['ntr'], 2)
          and bool(torch.isfinite(D).all()), 'exchange-MRF dictionary')
    tms = []
    for _ in range(3):
        t1 = time.perf_counter()
        dictionary()
        torch.cuda.synchronize()
        tms.append(time.perf_counter() - t1)
    t_dict = statistics.median(tms)
    # the probes: 4096 off-grid truths, 256 voxels each
    rng = np.random.default_rng(0)
    nt, nV = c['ntruth'], c['nV']
    T1t = np.exp(rng.uniform(np.log(t1g[1]), np.log(t1g[-2]), nt))
    Kt = rng.uniform(kg[1], kg[-2], nt)
    ph = torch.as_tensor(rng.uniform(-np.pi, np.pi, nV), dtype=torch.float32,
                         device=dev)[:, None, None]
    truth = torch.arange(nV, device=dev) % nt
    S = mrfx_gen(flips, phis, torch.tensor(T1t, dtype=torch.float32,
                                           device=dev),
                 torch.tensor(Kt, dtype=torch.float32, device=dev),
                 **seq(torch.float32))
    X = S[truth]
    X = torch.cos(ph) * X + torch.sin(ph) * torch.stack(
        [-X[..., 1], X[..., 0]], -1)
    gen = torch.Generator(device=dev).manual_seed(0)
    X += c['noise'] * torch.randn(X.shape, generator=gen, dtype=X.dtype,
                                  device=dev)
    del S

    def match():
        basis = mrf.svd_basis(D, rank=c['rank'])
        return mrf.dict_match_compressed(mrf.compress(D, basis),
                                         mrf.compress(X, basis), basis)

    torch.cuda.reset_peak_memory_stats(dev)
    res = match()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res = match()
    torch.cuda.synchronize()
    t_match = time.perf_counter() - t1
    idx = res.idx.long().cpu().numpy()
    tt = truth.cpu().numpy()
    i1, ik = idx // n, idx % n
    step1 = np.abs(np.log(t1g[i1] / T1t[tt])) / np.log(t1g[1] / t1g[0])
    stepk = np.abs(kg[ik] - Kt[tt]) / (kg[1] - kg[0])
    out.update(
        atoms=n * n, dict_ms=t_dict * 1e3, dict_atoms_per_s=n * n / t_dict,
        match_ms=t_match * 1e3, match_voxels_per_s=nV / t_match,
        match_median_T1a_relerr=float(np.median(np.abs(t1g[i1] / T1t[tt]
                                                       - 1))),
        match_median_kab_relerr=float(np.median(np.abs(kg[ik] / Kt[tt] - 1))),
        match_median_T1a_steps=float(np.median(step1)),
        match_median_kab_steps=float(np.median(stepk)),
        match_p90_kab_steps=float(np.percentile(stepk, 90)))
    # float32 resolves T1a to the grid but not kab: one of the 255 kab
    # steps moves a normalized atom by ~1e-4, below what the float32
    # dictionary and scores hold apart (on the H100 the same probes match
    # kab to a median 1.76 steps in float32 and 0.30 in float64); the
    # float32 kab match is held to 3 steps, and the same probes of one
    # voxel per truth are matched in float64 (the float64 kernels) against
    # the float64 dictionary, and held to 1.5 grid steps on both axes
    sel = np.arange(nt)
    f64 = dict(dtype=torch.float64, device=dev)
    fl64, ph64 = mrfx_train(c['ntr'], torch.float64, dev)
    D64 = mrfx_gen(fl64, ph64, T1.to(**f64), Kab.to(**f64),
                   **seq(torch.float64))
    basis64 = mrf.svd_basis(D64, rank=c['rank'])
    res64 = mrf.dict_match_compressed(
        mrf.compress(D64, basis64), mrf.compress(X[sel].to(**f64), basis64),
        basis64)
    del D64
    j = res64.idx.long().cpu().numpy()
    out.update(
        match64_median_T1a_steps=float(np.median(
            np.abs(np.log(t1g[j // n] / T1t)) / np.log(t1g[1] / t1g[0]))),
        match64_median_kab_steps=float(np.median(
            np.abs(kg[j % n] - Kt) / (kg[1] - kg[0]))))
    bars.update(match_median_T1a_steps=1.5, match_median_kab_steps=3.0,
                match64_median_T1a_steps=1.5, match64_median_kab_steps=1.5)
    # refinement of one voxel of every truth, from its matched atom
    p0 = torch.log(torch.stack([T1[idx[sel]], Kab[idx[sel]]], -1))

    def sig_b(P):
        return mrfx_gen(flips, phis, torch.exp(P[:, 0]), torch.exp(P[:, 1]),
                        **seq(torch.float32))

    def refine(iters):
        return mrf.match_refine(sig_b, p0, X[sel], iters=iters, lr=c['lr'],
                                batched=True)

    refine(1)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    P, score = refine(c['iters'])
    torch.cuda.synchronize()
    t_ref = time.perf_counter() - t1
    check(bool(torch.isfinite(P).all()), 'refined parameters finite')
    P = torch.exp(P).cpu().numpy()
    out.update(
        refine_voxels=nt, refine_s=t_ref,
        refine_s_per_step=t_ref / c['iters'],
        refine_voxels_per_s_per_step=nt / (t_ref / c['iters']),
        refine_median_T1a_relerr=float(np.median(np.abs(P[:, 0] / T1t - 1))),
        refine_median_kab_relerr=float(np.median(np.abs(P[:, 1] / Kt - 1))),
        refine_start_median_T1a_relerr=float(np.median(np.abs(
            t1g[i1[sel]] / T1t - 1))),
        refine_start_median_kab_relerr=float(np.median(np.abs(
            kg[ik[sel]] / Kt - 1))),
        refine_min_score=float(score.min()),
        peak_mem_GB=torch.cuda.max_memory_allocated(dev) / 1e9)
    check(out['refine_median_T1a_relerr']
          < out['refine_start_median_T1a_relerr']
          and out['refine_median_kab_relerr']
          < out['refine_start_median_kab_relerr'],
          'refinement did not lower both medians: ' + json.dumps(out))
    del D, X, res, P, score
    return out, bars


def mrfx_path(dev, vartr, label, phase):
    r"""Phase 22 (at a scalar tr) or 24 (``vartr``): :func:`mrfx_pipeline`,
    then (b) the MRFX_EX problem in float64 against JAX's literals
    (:func:`mrfx_example`); prints the measurements and raises on a missed
    bar."""
    t0 = time.perf_counter()
    out, bars = mrfx_pipeline(dev, vartr)
    out.update(mrfx_example(dev, vartr))
    bars.update(example_D=1e-10, example_sep=1e-10, example_loss0=1e-9,
                example_grad0=1e-9, example_losses=1e-8, example_p=1e-8)
    print(f'{label}: ' + json.dumps(dict(measured=out, bars=bars)),
          flush=True)
    for key, bar in bars.items():
        check(out[key] <= bar, f'{key}: {out[key]} > {bar}')
    print(f'phase {phase} took {time.perf_counter() - t0:.1f} s', flush=True)
    return out


def phase_mrfx_path(dev):
    r"""Phase 22: the exchange-MRF path at a scalar tr (:func:`mrfx_path`)."""
    return mrfx_path(dev, False, 'exchange-MRF path', 22)


def phase_mrfx_v_path(dev):
    r"""Phase 24: the exchange-MRF path over the example's variable-TR
    schedule (:func:`mrfx_path`; ``xspgr_v_fwd``, ``xspgr_v_fwd_chk``,
    ``xspgr_v_bwd`` and ``match``), its example against
    GOLDEN_MRFXV."""
    return mrfx_path(dev, True, 'exchange-MRF path (variable TR)', 24)


# examples/mrfx_exchange.py's problem at its defaults, float64 here: 150 TRs
# a segment (two, at 0.5× and 1.6× the flip train) over its variable-TR
# schedule (phase 24b, :func:`mrfx_trs`) or, in phase 22b, at a scalar tr
# of 15 ms in its place; K 16, a 10 × 8 (T1a, kab) grid, an SVD basis at
# energy 1 − 1e-8, the off-grid probe (T1a 0.93 s, kab 11.3 /s) matched,
# then 250 Adam steps (lr 0.02) of (log T1a, log kab) from the matched atom
# on 1 − the real correlation.
MRFX_EX = dict(ntr=150, nt1=10, nk=8, K=16, tr=0.015, T1a=0.93, kab=11.3,
               iters=250, lr=0.02, energy=1 - 1e-8, scales=(0.5, 1.6))
# the dictionary entries held to JAX: (atom, TR of the concatenated train)
MRFX_EX_ENTRIES = [(0, 0), (0, 299), (17, 3), (40, 151), (63, 100),
                   (79, 299)]
MRFX_EX_LOSS_STEPS = [0, 1, 50, 100, 150, 200, 249]


def mrfx_example_arrays():
    r"""MRFX_EX's dictionary axes ``(T1a (nA,), kab (nA,))``, numpy
    float64, T1a-major as the example's meshgrid."""
    c = MRFX_EX
    T1g, Kg = np.meshgrid(np.geomspace(0.4, 2.2, c['nt1']),
                          np.linspace(1.0, 15.0, c['nk']), indexing='ij')
    return T1g.ravel(), Kg.ravel()


# mrphy_tpu (JAX, XLA route on the CPU), float64, on the MRFX_EX problem at
# a scalar tr of 15 ms (tests/make_epgx_goldens.py prints these): the
# dictionary at
# MRFX_EX_ENTRIES (re, im) and its largest |value|, the basis rank, the
# matched atom, the kab separation, the first loss and its gradient w.r.t.
# (log T1a, log kab), the losses at MRFX_EX_LOSS_STEPS and the fitted
# (T1a, kab).
GOLDEN_MRFX = {
    'D': [[0.0, -0.0802199448057441],
          [-0.006695382268347502, -0.028735070895882158],
          [-5.5868086038517835e-06, -0.1640720721573888],
          [1.0654452704522338e-17, -0.3355787123058885],
          [-0.010040901094602322, -0.04285965008561367],
          [-0.0012989589194463357, -0.006510328371891296]],
    'D_max': 0.4715652189210845, 'rank': 16, 'idx': 37,
    'sep': 0.025792724039857003, 'loss0': 0.00033162577368928137,
    'grad0': [-0.007797452379858386, 3.7780880782582227e-06],
    'losses': [0.00033162577368928137,
               0.00019427860960341548,
               2.1449078291269075e-08,
               3.233995404805512e-09,
               2.794076081613639e-11,
               7.771561172376096e-16,
               2.220446049250313e-16],
    'p': [0.9299999201121518, 11.29999474319172]}
# The same on the MRFX_EX problem over its variable-TR schedule
# (tests/make_epgxv_goldens.py prints these).
GOLDEN_MRFXV = {
    'D': [[0.0, -0.0802199448057441],
          [-0.005179044806084962, -0.029283777968519453],
          [-6.728989913555943e-06, -0.16407163889335516],
          [-3.3888353014035018e-18, -0.3355603211906728],
          [-0.008050898659181656, -0.046832549464469804],
          [-0.0009931243936187667, -0.0066249514317318]],
    'D_max': 0.4709377290977258, 'rank': 16, 'idx': 37,
    'sep': 0.02557251308115319, 'loss0': 0.00033167084118201906,
    'grad0': [-0.007797303887235232, 3.602824888059408e-06],
    'losses': [0.00033167084118201906,
               0.00019432053364309976,
               2.1235873171043806e-08,
               3.257835223813288e-09,
               2.8011259978200087e-11,
               3.3306690738754696e-16,
               2.220446049250313e-16],
    'p': [0.929999919311585, 11.299995321631117]}


def mrfx_example(dev, vartr=False):
    r"""The MRFX_EX problem in float64 on the card against GOLDEN_MRFX (at
    a scalar tr) or, with ``vartr``, GOLDEN_MRFXV (over the example's tr
    trains), through ``epgx_spgr`` with shared ``(nTR,)`` trains at scalar
    tissue (so the float64 kernels run): the dictionary entries relative to
    its
    largest value, the basis rank, the matched atom and the kab separation
    equal or at 1e-10, the first loss and its gradient at 1e-9, the losses
    along the fit at 1e-8 of the first (they fall to 1 − a correlation of
    1 to rounding, ~1e-16, where a relative bar would compare rounding),
    the fitted (T1a, kab) at rtol 1e-8."""
    from mrphy_tpu_torch.ops import mrf
    c, gold = MRFX_EX, (GOLDEN_MRFXV if vartr else GOLDEN_MRFX)
    f64 = dict(dtype=torch.float64, device=dev)
    flips, phis = mrfx_train(c['ntr'], torch.float64, dev)
    seq = dict(tr=mrfx_trs(c['ntr'], torch.float64, dev) if vartr
               else c['tr'], K=c['K'], scales=c['scales'])
    T1, Kab = (torch.as_tensor(x, **f64) for x in mrfx_example_arrays())

    def gen(t1a, kab):
        return mrfx_gen(flips, phis, t1a, kab, **seq)

    D = gen(T1, Kab)
    basis = mrf.svd_basis(D, energy=c['energy'])
    probe = gen(torch.tensor(c['T1a'], **f64), torch.tensor(c['kab'], **f64))
    res = mrf.dict_match_compressed(mrf.compress(D, basis), probe[None],
                                    basis)
    i = int(res.idx[0])
    s_lo = gen(torch.tensor(1.0, **f64), torch.tensor(1.0, **f64))
    s_hi = gen(torch.tensor(1.0, **f64), torch.tensor(15.0, **f64))
    sep = float((s_lo - s_hi).abs().max() / s_lo.abs().max())
    check(i == gold['idx'], f"example match {i} != JAX's {gold['idx']}")
    check(basis.B.shape[1] == gold['rank'],
          f"example rank {basis.B.shape[1]} != JAX's {gold['rank']}")
    pr = probe.reshape(-1)
    p = {'l1': torch.log(T1[i]).clone().requires_grad_(),
         'lk': torch.log(Kab[i]).clone().requires_grad_()}

    def loss():
        s = gen(torch.exp(p['l1']), torch.exp(p['lk'])).reshape(-1)
        return 1.0 - torch.sum(s * pr) / torch.sqrt(torch.sum(s * s)
                                                     * torch.sum(pr * pr))

    opt = torch.optim.Adam(list(p.values()), lr=c['lr'])
    losses = []
    for it in range(c['iters']):
        opt.zero_grad()
        val = loss()
        val.backward()
        if it == 0:
            g0 = [float(p[k].grad) for k in ('l1', 'lk')]
        opt.step()
        losses.append(float(val.detach()))
    ents = torch.stack([D[a, t] for a, t in MRFX_EX_ENTRIES]).cpu().numpy()
    fit = [float(torch.exp(p['l1'].detach())),
           float(torch.exp(p['lk'].detach()))]

    def rel(a, b):
        a, b = np.asarray(a), np.asarray(b)
        return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))

    return dict(
        example_D=float(np.abs(ents - np.asarray(gold['D'])).max()
                        / gold['D_max']),
        example_sep=rel(sep, gold['sep']),
        example_loss0=rel(losses[0], gold['loss0']),
        example_grad0=float(np.max(np.abs(np.asarray(g0)
                                          - gold['grad0']))
                            / np.abs(gold['grad0']).max()),
        example_losses=float(np.max(np.abs(
            np.asarray([losses[k] for k in MRFX_EX_LOSS_STEPS])
            - gold['losses'])) / gold['loss0']),
        example_p=rel(fit, gold['p']), example_idx=i,
        example_T1a_fit=fit[0], example_kab_fit=fit[1])


# ==========================================================================
# The myelin-water path (phases 25-26)
# ==========================================================================

# examples/mwf_fit.py's protocol: the standard 32-echo CPMG at esp 10 ms of
# MWF mapping, white-matter-like pools (MWF ∈ [0.05, 0.30], T2a ∈ [60, 95]
# ms, T2b ∈ [10, 22] ms, T1a 1 s, T1b 0.4 s, kba 3 /s and kab = kba·M0b/M0a
# by detailed balance, M0a = 1 − MWF, M0b = MWF), a b1 map ∈ [0.82, 1]
# scaling the π train, noise 0.2% of the largest first echo; the fit: Adam
# (lr 0.03) on log (M0a, M0b, T2a, T2b) from (0.85, 0.15, 70 ms, 18 ms).
MWF = dict(nE=32, esp=0.01, T1a=1.0, T1b=0.4, kba=3.0, noise=0.2, lr=0.03,
           start=dict(M0a=0.85, M0b=0.15, T2a=0.070, T2b=0.018))
# The whole-brain map (phase 26a): 1,048,576 voxels, float32; the fit steps
# over the map in four blocks of 262,144 voxels (the adjoint's chunk is then
# 4 echoes, 8 checkpoints of 415 MB; over the whole map at once it would be
# 1 echo, 32 checkpoints of 1.66 GB), 10 steps timed; the accuracy of the
# example's 800 iterations on the map's first 4096 voxels.
MWF_MAP = dict(nV=1 << 20, block=1 << 18, steps=10, nfit=4096, iters=800)
# Bars on the adjoint's per-echo rows (sums over atoms, by warps and then
# over warps in a fixed order; the plain versions sum in the same order, so
# bit for bit expected): max|Δ| / max|row|.
XCPMG_ROW_BAR = {torch.float32: 5e-7, torch.float64: 1e-15}
# The EPG-X CPMG kernels' cases (phase 25): label, atoms, echoes, dtype,
# xcpmg_case keywords, the chunk (None: the entry point's,
# kernels.epg.adjoint_tc), the kernels run, timed.
# ``mwf``: MWF_MAP's train and tissue; ``bench``: bench_mrf's EPG-X CPMG
# dictionary (benchmarks/suite.py:588-596, 624-634); otherwise bench_mrf's
# distributions with the options named.
XCPMG_KERNELS = ('xcpmg_fwd', 'xcpmg_fwd_chk', 'xcpmg_bwd')
XCPMG_V_KERNELS = ('xcpmg_v_fwd', 'xcpmg_v_fwd_chk', 'xcpmg_v_bwd')
XCPMG_CASES = (
    ('MWF map 1M x 32, K 33, b1 (full width)', 1 << 20, 32, torch.float32,
     dict(mwf=True), None, ('xcpmg_fwd',), True),
    ('MWF fit block 262,144 x 32, K 33, b1', 1 << 18, 32, torch.float32,
     dict(mwf=True), None, XCPMG_KERNELS, True),
    ('bench_mrf EPG-X CPMG 65,536 x 32, flips 120-180', 65536, 32,
     torch.float32, dict(bench=True), None, XCPMG_KERNELS, True),
    ('MWF fit accuracy 4096 x 32, K 33, b1', 4096, 32,
     torch.float32, dict(mwf=True), None, XCPMG_KERNELS, False),
    ('f64 4096 x 32, dfb, phi_ex, M0b, b1 (tc 1)', 4096, 32, torch.float64,
     dict(dfb=True, phi=True, M0b=True, b1=True), 1, XCPMG_KERNELS, False),
    ('f64 ragged 1001 x 24, dfb, phi_ex, M0b (tc 3)', 1001, 24,
     torch.float64, dict(dfb=True, phi=True, M0b=True), 3, XCPMG_KERNELS,
     False),
    ('ragged 1001 x 32, no exchange (kab = kba = 0), b1 (tc = nE)', 1001,
     32, torch.float32, dict(nox=True, b1=True), 32, XCPMG_KERNELS, False),
    ('f64 ragged 777 x 32, no exchange, dfb, phi_ex (tc = nE)', 777, 32,
     torch.float64, dict(nox=True, dfb=True, phi=True), 32, XCPMG_KERNELS,
     False),
    ('2048 x 160, K 161 (device-memory state), b1', 2048, 160,
     torch.float32, dict(b1=True), None, XCPMG_KERNELS, False),
    ('f64 1000 x 80, K 81 (device-memory state), dfb', 1000, 80,
     torch.float64, dict(dfb=True), None, XCPMG_KERNELS, False),
)


def mwf_truth(nV, seed=0):
    r"""``examples/mwf_fit.py``'s draws from numpy default_rng(``seed``) in
    its order: ``(mwf, T2a, T2b, b1, rng)``, each ``(nV,)`` float64, and the
    generator, whose next draw is the example's noise."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.05, 0.30, nV), rng.uniform(0.060, 0.095, nV),
            rng.uniform(0.010, 0.022, nV), rng.uniform(0.82, 1.0, nV), rng)


def mwf_pools(mwf, T2a, T2b):
    r"""The pools of an MWF truth: ``{M0a, M0b, T2a, T2b}``."""
    return dict(M0a=1.0 - mwf, M0b=mwf, T2a=T2a, T2b=T2b)


def mwf_train(flips, p, b1, esp=None, **kw):
    r"""The example's echo model through ``epgx_cpmg``: the shared π train
    ``flips`` with the b1 map as ``b1=``, the pools ``p``, at the example's
    echo spacing or ``esp`` (a scalar or a ``(nE,)`` train)."""
    from mrphy_tpu_torch.ops import epg
    c = MWF
    return epg.epgx_cpmg(
        flips, T1a=c['T1a'], T2a=p['T2a'], T1b=c['T1b'], T2b=p['T2b'],
        kab=c['kba'] * p['M0b'] / p['M0a'], kba=c['kba'],
        esp=c['esp'] if esp is None else esp, M0a=p['M0a'], M0b=p['M0b'],
        b1=b1, **kw)


def mwf_naive(ech):
    r"""The example's baseline on echoes ``(nV, nE, 2)`` (numpy): a
    log-linear fit of the late echoes' magnitudes, the first echo's excess
    over it taken as the MWF, clipped to [0, 1]."""
    nE = ech.shape[1]
    mag = np.hypot(ech[..., 0], ech[..., 1])
    te = MWF['esp'] * (1 + np.arange(nE))
    late = slice(nE // 2, None)
    A = np.stack([np.ones(nE)[late], -te[late]], -1)
    coef = np.linalg.lstsq(A, np.log(np.maximum(mag[:, late], 1e-9)).T,
                           rcond=None)[0]
    naive = 1 - np.exp(coef[0]) / np.maximum(mag[:, 0] * np.exp(
        te[0] * coef[1]), 1e-9)
    return np.clip(naive, 0, 1)


def xcpmg_case(nA, nE, dtype, dev, *, mwf=False, bench=False, b1=False,
               dfb=False, phi=False, M0b=False, nox=False, seed=0):
    r"""``(flips, keywords)`` of ``epgx_cpmg`` at ``nA`` atoms × ``nE``
    echoes: MWF_MAP's (``mwf``: the shared π train, the pools of
    :func:`mwf_truth` at seed 0 and its b1 map), bench_mrf's EPG-X CPMG
    dictionary (``bench``: drawn in bench_mrf's order from ``seed``, its
    400-TR flip train's noise, T1a ∈ [0.2, 3] s, T2a ∈ [0.02, 0.5] s, T1b ∈
    [0.2, 0.6] s, T2b ∈ [5, 30] ms, kab ∈ [1, 10] /s, kba ∈ [5, 40] /s, its
    variable-TR train, then flips ∈ [120°, 180°]; no b1, M0a 1, M0b 0.1,
    esp 10 ms), or bench_mrf's distributions with, as asked, per-atom b1 ∈
    [0.8, 1.2], dfb ∈ [−20, 20] Hz, phi_ex ∈ [0, 2π), M0b ∈ [0.05, 0.3] and
    no exchange (kab = kba = 0)."""
    def arr(x):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    if mwf:
        m, T2a, T2b, b1v, _ = mwf_truth(nA)
        p = {k: arr(v) for k, v in mwf_pools(m, T2a, T2b).items()}
        return arr(np.full(nE, np.pi)), dict(
            T1a=MWF['T1a'], T1b=MWF['T1b'], kba=MWF['kba'],
            kab=MWF['kba'] * p['M0b'] / p['M0a'], esp=MWF['esp'],
            b1=arr(b1v), **p)
    rng = np.random.default_rng(seed)
    if bench:
        rng.standard_normal(400)
    kw = {k: arr(rng.uniform(lo, hi, nA)) for k, (lo, hi) in (
        ('T1a', (0.2, 3.0)), ('T2a', (0.02, 0.5)), ('T1b', (0.2, 0.6)),
        ('T2b', (0.005, 0.03)), ('kab', (1.0, 10.0)), ('kba', (5.0, 40.0)))}
    if bench:
        rng.random(400)
    flips = arr(np.deg2rad(rng.uniform(120, 180, nE)))
    kw['esp'] = MWF['esp']
    if b1:
        kw['b1'] = arr(rng.uniform(0.8, 1.2, nA))
    if dfb:
        kw['dfb'] = arr(rng.uniform(-20, 20, nA))
    if phi:
        kw['phi_ex'] = arr(rng.uniform(0, 2 * np.pi, nA))
    if M0b:
        kw['M0b'] = arr(rng.uniform(0.05, 0.3, nA))
    if nox:
        kw['kab'] = kw['kba'] = 0.0
    return flips, kw


def mwf_map_fit(dev, esp=None):
    r"""The whole-brain map (MWF_MAP, float32, ``backend='auto'`` on CUDA
    tensors) at the example's echo spacing or ``esp`` (a ``(nE,)`` CUDA
    train): the forward at the truth, timed in voxels per second; the noisy
    echoes; 10 Adam steps of the fit, each over the map in four blocks (each
    block's loss and backward, then one optimizer step): s per step,
    voxel-echoes per second, peak memory, the loss must fall. Returns
    ``(measured, truth's MWF, noisy echoes, block_loss, start)``, the last
    two the fit's loss over a slice of voxels and its starting point."""
    c, m = MWF, MWF_MAP
    nV, nE, nb = m['nV'], c['nE'], m['block']
    mwf, T2a, T2b, b1n, _ = mwf_truth(nV)

    def arr(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    truth = {k: arr(v) for k, v in mwf_pools(mwf, T2a, T2b).items()}
    b1 = arr(b1n)
    flips = torch.full((nE,), np.pi, device=dev)
    out = {}
    with torch.no_grad():
        ech = mwf_train(flips, truth, b1, esp)
        check(ech.shape == (nV, nE, 2) and bool(torch.isfinite(ech).all()),
              'MWF map echoes')
        fwd = time_ms(lambda: mwf_train(flips, truth, b1, esp), reps=3)
        sigma = c['noise'] / 100 * float(ech[:, 0].abs().max())
        gen = torch.Generator(device=dev).manual_seed(0)
        ech = ech + sigma * torch.randn(ech.shape, generator=gen,
                                        device=dev)
    out.update(fwd_ms=fwd, fwd_voxels_per_s=nV / fwd * 1e3, noise=sigma)
    del truth

    def start(n):
        return {k: torch.full((n,), np.log(v), device=dev,
                              requires_grad=True)
                for k, v in c['start'].items()}

    def block_loss(logp, sl):
        # the example's loss per voxel (the mean over echoes of the squared
        # error), summed over the voxels: each voxel's gradient, and so
        # Adam's step against its eps, is the example's at every size
        p = {k: torch.exp(v[sl]) for k, v in logp.items()}
        return ((mwf_train(flips, p, b1[sl], esp) - ech[sl]) ** 2).mean(
            dim=(-2, -1)).sum()

    # the fit over the whole map, four blocks a step
    logp = start(nV)
    opt = torch.optim.Adam(list(logp.values()), lr=c['lr'])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    losses = []
    t1 = time.perf_counter()
    for _ in range(m['steps']):
        opt.zero_grad()
        total = 0.0
        for b0 in range(0, nV, nb):
            val = block_loss(logp, slice(b0, b0 + nb))
            val.backward()
            total = total + val.detach()
        opt.step()
        losses.append(total)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t1) / m['steps']
    losses = [float(v) / nV for v in losses]
    out.update(fit_s_per_step=step_s,
               fit_voxel_echoes_per_s=nV * nE / step_s,
               fit_peak_mem_GB=torch.cuda.max_memory_allocated(dev) / 1e9,
               fit_loss_first=losses[0], fit_loss_last=losses[-1])
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f'MWF map fit: loss {losses[0]} -> {losses[-1]}')
    return out, mwf, ech, block_loss, start


def phase_mwf_path(dev):
    r"""Phase 26: the myelin-water path through ``epgx_cpmg``. (a) The
    whole-brain map at the example's echo spacing (:func:`mwf_map_fit`:
    the forward, ``xcpmg_fwd``; the fit's steps, each block's loss and
    backward ``xcpmg_fwd_chk`` + ``xcpmg_bwd``); the example's 800
    iterations on the map's first 4096 voxels: the median |MWF error| must
    be < 0.01 and < 0.5 × the naive baseline's. (b) ``examples/mwf_fit.py``
    at its defaults in float64 against JAX's literals
    (:func:`mwf_example`)."""
    t0 = time.perf_counter()
    c, m = MWF, MWF_MAP
    out, mwf, ech, block_loss, start = mwf_map_fit(dev)
    bars = {}
    # the example's 800 iterations on the map's first 4096 voxels
    n = m['nfit']
    sl = slice(0, n)
    logp = start(n)
    opt = torch.optim.Adam(list(logp.values()), lr=c['lr'])
    t1 = time.perf_counter()
    for _ in range(m['iters']):
        opt.zero_grad()
        block_loss(logp, sl).backward()
        opt.step()
    torch.cuda.synchronize()
    p = {k: torch.exp(v.detach()).cpu().numpy() for k, v in logp.items()}
    err = np.abs(p['M0b'] / (p['M0a'] + p['M0b']) - mwf[:n])
    err_naive = np.abs(mwf_naive(ech[sl].double().cpu().numpy()) - mwf[:n])
    out.update(acc_s_per_iter=(time.perf_counter() - t1) / m['iters'],
               acc_median_mwf_err=float(np.median(err)),
               acc_max_mwf_err=float(err.max()),
               acc_naive_median_mwf_err=float(np.median(err_naive)))
    out['acc_err_over_naive'] = out['acc_median_mwf_err'] / \
        out['acc_naive_median_mwf_err']
    bars.update(acc_median_mwf_err=0.01, acc_err_over_naive=0.5)
    del ech
    # (b) examples/mwf_fit.py in float64 against JAX
    out.update(mwf_example(dev))
    bars.update(example_echoes=1e-10, example_loss0=1e-10,
                example_grad0=1e-10,
                example_losses=100 * MWF_EX_ULP['losses'],
                example_mwf=100 * MWF_EX_ULP['mwf'])
    print('myelin-water path: ' + json.dumps(dict(measured=out, bars=bars)),
          flush=True)
    for key, bar in bars.items():
        check(out[key] < bar, f'{key}: {out[key]} >= {bar}')
    print(f'phase 26 took {time.perf_counter() - t0:.1f} s', flush=True)
    return out


# examples/mwf_fit.py at its defaults (24 voxels, 32 echoes, 800 Adam
# iterations at lr 0.03 of the mean squared error over every echo), float64
# here; the entries of its noiseless echoes held to JAX: (voxel, echo).
MWF_EX = dict(nv=24, iters=800)
MWF_EX_ENTRIES = [(0, 0), (0, 31), (5, 3), (11, 17), (17, 8), (23, 31)]
MWF_EX_VOXELS = [0, 7, 15, 23]
MWF_EX_LOSS_STEPS = [0, 1, 10, 100, 799]
# mrphy_tpu (JAX, XLA route on the CPU), float64, on the MWF_EX problem
# (tests/make_mwf_goldens.py prints these): the noiseless echoes at
# MWF_EX_ENTRIES (re, im) and their largest |value|, the first loss, its
# gradient w.r.t. the log pools at MWF_EX_VOXELS and each one's largest
# magnitude, the losses at MWF_EX_LOSS_STEPS and the fitted MWF of every
# voxel.
GOLDEN_MWF = {
    'echoes': [[0.7640083591200676, 4.6782019575910614e-17],
               [0.014393050809154833, 1.811653049418993e-18],
               [0.4429078377339553, -2.7119229845656616e-17],
               [0.07435939738516126, 5.399946643077234e-18],
               [0.2229896346952883, 4.600605055281456e-18],
               [0.01301137388742497, -1.8181610722047801e-19]],
    'echoes_max': 0.8648051961186152, 'loss0': 0.0007522084447531925,
    'grad0': {
        'M0a': [3.9760241463996014e-05, 0.00023380693656455896,
                -0.00018503819358470434, -0.00013081044353006153],
        'M0b': [9.305332773495752e-06, 1.192316408988149e-05,
                -4.361489804250781e-06, -2.0444811520420162e-07],
        'T2a': [-5.891799098884925e-05, 0.00012395361958184977,
                -0.00015274183494979425, -0.0001458892249699948],
        'T2b': [4.987942616119418e-06, 1.738789470226819e-05,
                -1.2366668560564813e-05, -7.669605130078725e-06]},
    'grad0_max': {'M0a': 0.0007493251933081784,
                  'M0b': 1.777542782942475e-05,
                  'T2a': 0.0007054255543554798,
                  'T2b': 4.784756213392723e-05},
    'losses': [0.0007522084447531925,
               0.0004858059031638764,
               0.00013320423924667748,
               3.500244956827062e-06,
               2.7995490592263516e-06],
    'mwf': [0.21552096016928587, 0.09176704789057502, 0.061955549258770455,
            0.057399985567437306, 0.24646021323456876, 0.27740785680648283,
            0.18941064213200712, 0.23533461632968197, 0.19405858987959787,
            0.280946853752387, 0.2582437003885634, 0.04721838717002207,
            0.2626079373963655, 0.04775747132451438, 0.24242958613723026,
            0.10563249871958627, 0.26522558222324116, 0.17130036718645986,
            0.13115275889150513, 0.14704747120925832, 0.07023600531938855,
            0.07354054355370417, 0.22740231068316666, 0.20097960525699635]}


# The same script's ULP_RESPONSE: JAX's own losses and fitted MWF move by
# this much (largest relative change) when the 800 steps run on the noisy
# echoes moved one ulp. Adam's steps amplify rounding ~1e9-fold on this fit
# (its valleys are flat in the pools), so phase 26b holds the port's losses
# and MWF at 100× this response, not at 1e-8: the port rounds otherwise
# than XLA:CPU at every step (the card's float64 exp, sin and cos, torch's
# reduction order), not once; on an H100 it drifted by 1.31e-6 and 7.87e-6
# (6.7× and 8.7× the response; on the CPU through the plain versions 1.4e-7
# and 6.7e-7). A 0.1% change of the learning rate moves JAX's losses by
# 1.0e-2 and its MWF by 2.6e-4, past these bars; the first loss and
# gradient, which no step amplifies, stay at 1e-10.
MWF_EX_ULP = {'losses': 1.9633385278999042e-07, 'mwf': 9.027924918985892e-07}


def mwf_example(dev):
    r"""The MWF_EX problem in float64 on the card against GOLDEN_MWF,
    through ``epgx_cpmg`` with the shared π train and the b1 map (so the
    float64 kernels run: ``xcpmg_fwd`` for the echoes, ``xcpmg_fwd_chk`` +
    ``xcpmg_bwd`` per iteration): the noiseless echoes relative to their
    largest, the first loss relative to itself, its gradient relative to
    each one's largest, the losses along the fit and the fitted MWF relative
    to each value (at MWF_EX_ULP's bars); and the example's own asserts
    (median |MWF error| < 0.01 and < 0.5 × the naive baseline's)."""
    c, gold = MWF, GOLDEN_MWF
    f64 = dict(dtype=torch.float64, device=dev)
    mwf, T2a, T2b, b1n, rng = mwf_truth(MWF_EX['nv'])
    truth = {k: torch.as_tensor(v, **f64)
             for k, v in mwf_pools(mwf, T2a, T2b).items()}
    b1 = torch.as_tensor(b1n, **f64)
    flips = torch.full((c['nE'],), np.pi, **f64)
    with torch.no_grad():
        ech0 = mwf_train(flips, truth, b1)
    sigma = c['noise'] / 100 * float(ech0[:, 0].abs().max())
    ech = ech0 + sigma * torch.as_tensor(rng.standard_normal(ech0.shape),
                                         **f64)
    logp = {k: torch.full((MWF_EX['nv'],), np.log(v), **f64).requires_grad_()
            for k, v in c['start'].items()}

    def loss():
        p = {k: torch.exp(v) for k, v in logp.items()}
        return torch.mean((mwf_train(flips, p, b1) - ech) ** 2)

    opt = torch.optim.Adam(list(logp.values()), lr=c['lr'])
    losses = []
    for i in range(MWF_EX['iters']):
        opt.zero_grad()
        val = loss()
        val.backward()
        if i == 0:
            g0 = {k: x.grad.clone().cpu().numpy() for k, x in logp.items()}
        opt.step()
        losses.append(float(val.detach()))
    p = {k: torch.exp(v.detach()).cpu().numpy() for k, v in logp.items()}
    mwf_fit = p['M0b'] / (p['M0a'] + p['M0b'])
    err = np.abs(mwf_fit - mwf)
    err_naive = np.abs(mwf_naive(ech.cpu().numpy()) - mwf)
    check(np.median(err) < 0.01
          and np.median(err) < 0.5 * np.median(err_naive),
          f'example: median MWF error {np.median(err)}, naive '
          f'{np.median(err_naive)}')
    e0 = ech0.cpu().numpy()
    vox = MWF_EX_VOXELS

    def rel(a, b):
        a, b = np.asarray(a), np.asarray(b)
        return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))

    ents = np.asarray([e0[v, e] for v, e in MWF_EX_ENTRIES])
    return dict(
        example_echoes=float(np.max(np.abs(ents - gold['echoes'])))
        / gold['echoes_max'],
        example_loss0=rel(losses[0], gold['loss0']),
        example_grad0=max(float(np.max(np.abs(g0[k][vox]
                                              - gold['grad0'][k])))
                          / gold['grad0_max'][k] for k in c['start']),
        example_losses=rel([losses[i] for i in MWF_EX_LOSS_STEPS],
                           gold['losses']),
        example_mwf=rel(mwf_fit, gold['mwf']),
        example_median_mwf_err=float(np.median(err)),
        example_naive_median_mwf_err=float(np.median(err_naive)))



# ==========================================================================
# The myelin-water path over an echo-spacing train (phases 27-28)
# ==========================================================================

# Phase 28's train: MWF's 32 refocusing pulses, echoes 1-16 at 6 ms and
# 17-32 at 14 ms: the 320 ms of 32 × 10 ms, sampling the myelin pool's T2
# (10-22 ms) more densely early on.
MWF_V = dict(esps=(0.006,) * 16 + (0.014,) * 16)
# The echo-spacing kernels' cases (phase 27): label, atoms, echoes, dtype,
# xcpmg_case keywords (``const``: a constant 10 ms train, held also to
# ``xcpmg_fwd`` at the scalar esp), the chunk (None: the entry point's,
# kernels.epg.adjoint_tc), the kernels run, timed. Every other case runs
# over a train of 8-18 ms drawn from numpy default_rng(seed)
# (benchmarks/tpu_checks.py:529's distribution).
XCPMG_V_CASES = (
    ('MWF map 1M x 32, K 33, b1, esp 8-18 ms (full width)', 1 << 20, 32,
     torch.float32, dict(mwf=True), None, ('xcpmg_v_fwd',), True),
    ('MWF fit block 262,144 x 32, K 33, b1, esp 8-18 ms', 1 << 18, 32,
     torch.float32, dict(mwf=True), None, XCPMG_V_KERNELS, True),
    ('bench_mrf EPG-X CPMG 65,536 x 32, flips 120-180, esp 8-18 ms', 65536,
     32, torch.float32, dict(bench=True), None, XCPMG_V_KERNELS, True),
    ('f64 4096 x 32, dfb, phi_ex, M0b, b1 (tc 1)', 4096, 32, torch.float64,
     dict(dfb=True, phi=True, M0b=True, b1=True), 1, XCPMG_V_KERNELS, False),
    ('f64 ragged 1001 x 24, dfb, phi_ex, M0b, b1 (tc 3)', 1001, 24,
     torch.float64, dict(dfb=True, phi=True, M0b=True, b1=True), 3,
     XCPMG_V_KERNELS, False),
    ('ragged 1001 x 32, no exchange (kab = kba = 0), b1 (tc = nE)', 1001,
     32, torch.float32, dict(nox=True, b1=True), 32, XCPMG_V_KERNELS, False),
    ('2048 x 160, K 161 (device-memory state), b1', 2048, 160,
     torch.float32, dict(b1=True), None, XCPMG_V_KERNELS, False),
    ('16k x 32, constant 10 ms train (= xcpmg_fwd), b1', 16384, 32,
     torch.float32, dict(const=True, b1=True), None, XCPMG_V_KERNELS, False),
)


def phase_xcpmg_kernels(dev, varesp=False):
    r"""Phase 25: ``xcpmg_fwd``, ``xcpmg_fwd_chk`` and ``xcpmg_bwd`` against
    their plain versions on XCPMG_CASES; phase 27 (``varesp``):
    ``xcpmg_v_fwd``, ``xcpmg_v_fwd_chk`` and ``xcpmg_v_bwd`` on
    XCPMG_V_CASES. The arguments are those ``epgx_cpmg`` gives them
    (``ops.epg._xcpmg_rows``: ``coef`` and ``pk (19, nA)``; over an esp
    train ``pk (5, nA)`` and the per-echo planes ``pkt``); the adjoint is
    fed the kernel's checkpoints and a cotangent drawn from a seed, the
    plain adjoint written out, with no autograd graph, at the case's chunk
    or the entry point's (``kernels.epg.adjoint_tc``), each adjoint row
    with its route. The MWF map's
    forward at full width, the fit's block and ``bench_mrf``'s EPG-X CPMG
    dictionary are timed with their bounds (the planes read once). Per-atom
    outputs (echoes, checkpoints, the per-atom gradient rows ``dpar`` and,
    over a train, ``dpkt`` per atom and echo) at EPG_BAR of their largest
    value (bit for bit expected; the rows that differ are named), the
    per-echo rows at XCPMG_ROW_BAR; a constant train's echoes also against
    ``xcpmg_fwd``'s at the scalar esp. Returns each kernel's rows."""
    from mrphy_tpu_torch.kernels import epg as kepg
    from mrphy_tpu_torch.kernels import epgx as kx
    from mrphy_tpu_torch.ops import epg
    t0 = time.perf_counter()
    v = '_v' if varesp else ''
    cases, seed0 = (XCPMG_V_CASES, 270) if varesp else (XCPMG_CASES, 250)
    fwd, fwd_chk, bwd = (getattr(kx, f'xcpmg{v}_{n}')
                         for n in ('fwd', 'fwd_chk', 'bwd'))
    fwd_t, fwd_chk_t, bwd_t = (getattr(kx, f'xcpmg{v}_{n}_torch')
                               for n in ('fwd', 'fwd_chk', 'bwd'))
    rows = {f'xcpmg{v}_{n}': [] for n in ('fwd', 'fwd_chk', 'bwd')}
    const = {}
    for seed, (label, nA, nE, dtype, kw, tc, run, timed) in enumerate(
            cases, seed0):
        kw = dict(kw)
        is_const = kw.pop('const', False)
        flips, ckw = xcpmg_case(nA, nE, dtype, dev, seed=seed, **kw)
        fixed = None
        if is_const:
            fixed = epg._xcpmg_rows(flips, **ckw)[:3]    # at the scalar esp
            ckw['esp'] = torch.full((nE,), MWF['esp'], dtype=dtype,
                                    device=dev)
        elif varesp:
            ckw['esp'] = torch.as_tensor(np.random.default_rng(seed).uniform(
                0.008, 0.018, nE), dtype=dtype, device=dev)
        coef, pk, cfg, _ = epg._xcpmg_rows(flips, **ckw)
        coef = coef.contiguous()
        par = tuple(x.contiguous() for x in (pk if varesp else (pk,)))
        tc = tc or kepg.adjoint_tc(nE, cfg.K, nA, coef.element_size(),
                                   kx.PLANES)
        chk = gr = gi = None
        if f'xcpmg{v}_bwd' in run:
            chk = fwd_chk(coef, *par, cfg, tc=tc)[2]
            gr, gi = cotangent(torch.empty((2, nE, nA), dtype=dtype,
                                           device=dev), seed)
        runs = {
            f'xcpmg{v}_fwd': (lambda: fwd(coef, *par, cfg),
                              lambda: fwd_t(coef, *par, cfg),
                              (coef,) + par, ('er', 'ei')),
            f'xcpmg{v}_fwd_chk': (
                lambda: fwd_chk(coef, *par, cfg, tc=tc),
                lambda: fwd_chk_t(coef, *par, cfg, tc=tc),
                (coef,) + par, ('er', 'ei', 'chk')),
            f'xcpmg{v}_bwd': (
                lambda: bwd(coef, *par, cfg, chk, gr, gi, tc=tc),
                lambda: bwd_t(coef, *par, cfg, chk, gr, gi, tc=tc),
                (coef,) + par + (chk, gr, gi),
                ('dcoef', 'dpar') + (('dpkt',) if varesp else ()))}
        for name in run:
            run_kernel, run_plain, inputs, names = runs[name]
            meta = dict(case=label, nA=nA, nE=nE, K=cfg.K, tc=tc)
            if name.endswith('_bwd'):
                meta['adjoint'] = adjoint_meta(cfg.K, coef, kx.PLANES, tc)
            else:
                meta['threads_state'] = kepg.launch_cfg(
                    cfg.K, coef.element_size(), kx.PLANES)
            if name.endswith('_fwd_chk'):
                meta['forward'] = forward_meta(cfg.K, coef)
            rows[name].append(compare_epg(
                name, run_kernel, run_plain, inputs, names, meta, dtype,
                timed, XCPMG_ROW_BAR))
        if fixed is not None:
            # a constant train: the fixed-spacing kernel at the scalar esp
            er, ei = fwd(coef, *par, cfg)
            er0, ei0 = kx.xcpmg_fwd(*(x.contiguous() if i < 2 else x
                                      for i, x in enumerate(fixed)))
            const = dict(case=label, bit_identical=torch.equal(er, er0)
                         and torch.equal(ei, ei0),
                         err=max(max_err(er, er0), max_err(ei, ei0))
                         / float(er0.abs().max()))
            print('xcpmg_v_fwd constant train vs xcpmg_fwd: '
                  + json.dumps(const), flush=True)
            check(const['err'] <= EPG_BAR[dtype],
                  f"constant train vs xcpmg_fwd: {const['err']}")
            del er, ei, er0, ei0
        del coef, pk, par, chk, gr, gi, fixed
    check(bool(const) or not varesp, 'no constant-train case ran')
    print(f'phase {27 if varesp else 25} took '
          f'{time.perf_counter() - t0:.1f} s', flush=True)
    return rows


def phase_mwf_v_path(dev):
    r"""Phase 28: the myelin-water path over MWF_V's echo-spacing train
    through ``epgx_cpmg``, and nothing else, so that the launch counts read
    after it are the path's own. (a) The whole-brain map
    (:func:`mwf_map_fit` at the train: the forward, ``xcpmg_v_fwd``; the
    fit's steps, each block's loss and backward ``xcpmg_v_fwd_chk`` +
    ``xcpmg_v_bwd`` and autograd of the per-echo planes). (b) MWF_V_EX in
    float64 against JAX's literals (:func:`mwf_v_example`). Returns the
    measurements; :func:`phase_mwf_v_parts` splits the forward's time
    after the counts are read."""
    t0 = time.perf_counter()
    esps = torch.as_tensor(MWF_V['esps'], dtype=torch.float32, device=dev)
    out, _, ech, _, _ = mwf_map_fit(dev, esps)
    del ech
    # (b) the echo-spacing model in float64 against JAX
    out.update(mwf_v_example(dev))
    bars = dict(example_echoes=1e-10, example_grad_esp=1e-9,
                example_grad=1e-9)
    print('myelin-water path over an esp train: '
          + json.dumps(dict(measured=out, bars=bars)), flush=True)
    for key, bar in bars.items():
        check(out[key] < bar, f'{key}: {out[key]} >= {bar}')
    print(f'phase 28 took {time.perf_counter() - t0:.1f} s', flush=True)
    return out


def phase_mwf_v_parts(dev, fwd_ms):
    r"""Phase 28c, after phase 28's launch counts are read: the parts of
    that path's forward at the truth, timed apart against its whole
    (``fwd_ms``): the kernels' arguments (``ops.epg._xcpmg_rows``), among
    them the planes (``ops.epg._x_step_entries`` and its 14 passes over
    (nE, nA)), and the kernel ``xcpmg_v_fwd`` alone."""
    from mrphy_tpu_torch.kernels import epgx as kx
    from mrphy_tpu_torch.ops import epg
    c = MWF
    esps = torch.as_tensor(MWF_V['esps'], dtype=torch.float32, device=dev)
    nV = MWF_MAP['nV']
    mwf, T2a, T2b, b1n, _ = mwf_truth(nV)

    def arr(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    p = {k: arr(v) for k, v in mwf_pools(mwf, T2a, T2b).items()}
    flips = torch.full((c['nE'],), np.pi, device=dev)
    kw = dict(T1a=c['T1a'], T2a=p['T2a'], T1b=c['T1b'], T2b=p['T2b'],
              kab=c['kba'] * p['M0b'] / p['M0a'], kba=c['kba'], esp=esps,
              M0a=p['M0a'], M0b=p['M0b'], b1=arr(b1n))
    with torch.no_grad():
        coef, (pk, pkt), cfg, _ = epg._xcpmg_rows(flips, **kw)
        rates = [torch.broadcast_to(torch.as_tensor(
            kw[n], dtype=torch.float32, device=dev), (nV,))
            for n in ('T1a', 'T2a', 'T1b', 'T2b', 'kab', 'kba', 'M0a',
                      'M0b')] + [torch.zeros(nV, device=dev)]
        rows_ms = time_ms(lambda: epg._xcpmg_rows(flips, **kw), reps=3)
        planes_ms = time_ms(lambda: epg._x_step_entries(*rates, esps / 2),
                            reps=3)
        kernel_ms = time_ms(lambda: kx.xcpmg_v_fwd(coef, pk, pkt, cfg),
                            reps=3)
    out = dict(fwd_ms=fwd_ms, rows_ms=rows_ms, planes_ms=planes_ms,
               kernel_ms=kernel_ms, planes_share=planes_ms / fwd_ms,
               rows_share=rows_ms / fwd_ms, kernel_share=kernel_ms / fwd_ms)
    print('myelin-water path over an esp train, the forward\'s parts: '
          + json.dumps(out), flush=True)
    return out


# Phase 28b: 24 voxels of examples/mwf_fit.py's tissue (mwf_truth at seed 0)
# over MWF_V's train in float64, the loss Σ w·echoes with w from numpy
# default_rng(wseed); the echoes' entries (voxel, echo) and the voxels of
# the log pools' gradient held to JAX.
MWF_V_EX = dict(nv=24, wseed=1)
MWF_V_EX_ENTRIES = [(0, 0), (0, 31), (5, 3), (11, 16), (17, 8), (23, 31)]
MWF_V_EX_VOXELS = [0, 7, 15, 23]
# mrphy_tpu (JAX, XLA route on the CPU), float64, on the MWF_V_EX problem
# (tests/make_xcpmgv_goldens.py prints these): the noiseless echoes at
# MWF_V_EX_ENTRIES (re, im) and their largest |value|, the loss's gradient
# w.r.t. every element of the esp train and its largest magnitude, and
# w.r.t. the log pools at MWF_V_EX_VOXELS and each one's largest magnitude.
GOLDEN_MWF_V = {"echoes": [[0.8346288433943453, 5.1106277076947115e-17],
    [0.014284476826021167, 1.840385342398165e-18], [0.5658114780245291,
    -3.464469603971905e-17], [0.19741651474447153, -3.82534513659869e-18],
    [0.38449139954111533, 1.0463271349548499e-17], [0.01301121960759071,
    -1.5111507087848419e-19]], "echoes_max": 0.9123916756591574, "grad_esp":
    [229.73269700733897, 240.91100854431943, 198.5691906457505,
    130.63342694873285, 52.32322786091484, 65.82847731852924,
    19.85436567292973, 33.34641460980145, 28.985349549273106,
    19.282055185931558, -21.825482895748994, -40.00150930139186,
    -35.97456205544108, -53.754529930513634, -14.830342973684264,
    -4.853108803405071, 4.279676521604914, 1.624426223603718,
    -2.2843227021031884, -0.5045669210902055, 0.6804782795207966,
    0.5724874243416027, 6.530841731997833, 4.786155279794894,
    1.0040804543895023, 2.295688138309922, 3.2714291748796245,
    2.7298240048249034, -0.13089021734804807, -0.9915123536139517,
    -0.752885897950247, 0.663270444278621], "grad_esp_max":
    240.91100854431943, "grad": {"M0a": [0.14565312467188501,
    2.8598337584504168, 0.4021327293658066, -2.998278966152469], "M0b":
    [0.10038306283960223, 0.13498574421690718, 0.018308131870959667,
    -0.567847536418217], "T2a": [-0.23083389936832566, 1.685191088150359,
    -0.31437645934609965, 0.27387017397755214], "T2b": [0.05992536864984519,
    0.21105329706486617, 0.02189331798476696, -0.3646505255938459]},
    "grad_max": {"M0a": 3.740003986104475, "M0b": 0.567847536418217, "T2a":
    2.6461364013320825, "T2b": 0.4615971368902937}}


def mwf_v_example(dev):
    r"""The MWF_V_EX problem in float64 on the card against GOLDEN_MWF_V,
    through ``epgx_cpmg`` with the shared π train, the b1 map and the esp
    train (so the float64 echo-spacing kernels run: ``xcpmg_v_fwd_chk`` +
    ``xcpmg_v_bwd``): the noiseless echoes relative to their largest, the
    gradients w.r.t. the esp train and the log pools relative to each one's
    largest."""
    c, ex, gold = MWF, MWF_V_EX, GOLDEN_MWF_V
    f64 = dict(dtype=torch.float64, device=dev)
    mwf, T2a, T2b, b1n, _ = mwf_truth(ex['nv'])
    logp = {k: torch.log(torch.as_tensor(v, **f64)).requires_grad_()
            for k, v in mwf_pools(mwf, T2a, T2b).items()}
    esps = torch.as_tensor(MWF_V['esps'], **f64).requires_grad_()
    flips = torch.full((c['nE'],), np.pi, **f64)
    w = torch.as_tensor(np.random.default_rng(ex['wseed']).standard_normal(
        (ex['nv'], c['nE'], 2)), **f64)
    ech = mwf_train(flips, {k: torch.exp(v) for k, v in logp.items()},
                    torch.as_tensor(b1n, **f64), esps)
    gs = torch.autograd.grad((w * ech).sum(), [esps] + list(logp.values()))
    e = ech.detach().cpu().numpy()
    g_esp = gs[0].cpu().numpy()
    g = {k: x.cpu().numpy() for k, x in zip(logp, gs[1:])}
    ents = np.asarray([e[v, t] for v, t in MWF_V_EX_ENTRIES])
    vox = MWF_V_EX_VOXELS
    return dict(
        example_echoes=float(np.max(np.abs(ents - gold['echoes'])))
        / gold['echoes_max'],
        example_grad_esp=float(np.max(np.abs(g_esp - gold['grad_esp'])))
        / gold['grad_esp_max'],
        example_grad=max(float(np.max(np.abs(g[k][vox] - gold['grad'][k])))
                         / gold['grad_max'][k] for k in c['start']))


# ==========================================================================
# The balanced-SSFP family (phases 29-30)
# ==========================================================================

# benchmarks/suite.py bench_bssfp_fit (lines 914-966): whole-volume direct
# bSSFP mapping, 1,048,576 voxels × 200 variable TRs, float32: flips 10 +
# 50·|sin(πt/60)|°; from numpy default_rng(0) in this order tr 4-6 ms, then
# the truth's T1 0.3-2 s, T2 30-300 ms, df ±80 Hz and M0 0.7-1.2. The fit
# (30a) takes examples/bssfp_fit.py's parameters (log T1, log T2, df / 30
# Hz, M0) from (1 s, 100 ms, 0 Hz, 1) and its Adam (lr 0.05) on the mean
# squared error, 5 steps; the first step's gradients are held against the
# plain route on the first 16,384 voxels at 1e-5 of each one's largest.
BSSFP_FIT = dict(nV=1 << 20, nTR=200, steps=5, lr=0.05, df_scale=30.0,
                 start=dict(T1=1.0, T2=0.1, df=0.0, M0=1.0), nslice=16384,
                 grad_bar=1e-5)
# The per-TR rows of bssfp_bwd are sums over atoms that the plain version
# takes in the kernel's order (warp trees, then one torch.sum over the
# warps): bit for bit expected; the bar of the two-pool CPMG rows.
BSSFP_ROW_BAR = {torch.float32: 5e-7, torch.float64: 1e-15}
BSSFP_KERNELS = ('bssfp_fwd', 'bssfp_fwd_chk', 'bssfp_bwd')
# The kernels' cases (phase 29): label, atoms, TRs, dtype, bssfp_case
# keywords, the chunk (None: the adjoint's own, kernels/ssfp.chunk), the
# kernels run, timed.
BSSFP_CASES = (
    ('bench_bssfp_fit 1M x 200, tr 4-6 ms (full width)', 1 << 20, 200,
     torch.float32, dict(fit=True), None, BSSFP_KERNELS, True),
    ('bench_mrf bSSFP dictionary 65,536 x 400, tr 10-13 ms, df +-80 Hz',
     65536, 400, torch.float32, dict(mrf=True), None, ('bssfp_fwd',), True),
    ('65,536 x 200, constant tr 5 ms, b1', 65536, 200, torch.float32,
     dict(b1=True), None, BSSFP_KERNELS, False),
    ('4096 x 201, alpha/2-catalysed (tc 67)', 4096, 201, torch.float32,
     dict(cat=True), 67, BSSFP_KERNELS, False),
    ('ragged 1001 x 48, b1, tr and te trains, phases (tc 1)', 1001, 48,
     torch.float32, dict(b1=True, vartr=True, te=True, phis=True), 1,
     BSSFP_KERNELS, False),
    ('f64 65,536 x 200, constant tr 5 ms, b1', 65536, 200, torch.float64,
     dict(b1=True), None, BSSFP_KERNELS, False),
    ('f64 4096 x 201, alpha/2-catalysed (tc 67)', 4096, 201, torch.float64,
     dict(cat=True), 67, BSSFP_KERNELS, False),
)


def bssfp_fit_arrays(nV, dev):
    r"""BSSFP_FIT's train and truth (numpy default_rng(0), as
    bench_bssfp_fit draws them) as float32 tensors: ``(flips, trs, truth)``,
    ``truth`` the maps T1, T2, df, M0."""
    nTR = BSSFP_FIT['nTR']
    rng = np.random.default_rng(0)
    t = np.arange(nTR)
    flips = np.deg2rad(10 + 50 * np.abs(np.sin(np.pi * t / 60)))
    trs = 4e-3 + 2e-3 * rng.random(nTR)
    truth = dict(T1=rng.uniform(0.3, 2.0, nV), T2=rng.uniform(0.03, 0.3, nV),
                 df=rng.uniform(-80, 80, nV), M0=rng.uniform(0.7, 1.2, nV))

    def arr(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    return arr(flips), arr(trs), {k: arr(v) for k, v in truth.items()}


def bssfp_case(nA, nTR, dtype, dev, *, fit=False, mrf=False, cat=False,
               b1=False, vartr=False, te=False, phis=False, seed=0):
    r"""``bssfp_train`` arguments ``(flips, keywords)`` (CUDA tensors).
    ``fit``: BSSFP_FIT's train and truth; ``mrf``: bench_mrf's bSSFP
    dictionary (benchmarks/suite.py:560-575,636-646: flips 10 +
    50·|sin(t/40)|° + 0.01 rad noise, T1 0.2-3 s, T2 20-500 ms, df ±80 Hz,
    tr 10-13 ms); ``cat``: examples/bssfp_fit.py's α/2-catalysed 35° train
    at tr 5 ms and tissue; otherwise flips 0.1-1.2 rad, T1 0.3-2 s, T2
    30-300 ms, df ±80 Hz, M0 0.7-1.2 at tr 5 ms, and as asked per-atom b1
    (0.8-1.2), a tr train (4-6 ms), a te train (1-3 ms) and explicit
    phases; from numpy default_rng(seed)."""
    def arr(x):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    if fit:
        flips, trs, truth = bssfp_fit_arrays(nA, dev)
        return flips.to(dtype), dict({k: v.to(dtype) for k, v in
                                      truth.items()}, tr=trs.to(dtype))
    rng = np.random.default_rng(seed)
    if mrf:
        t = np.arange(nTR)
        flips = (np.deg2rad(10 + 50 * np.abs(np.sin(t / 40.0)))
                 + 0.01 * rng.standard_normal(nTR))
        kw = dict(T1=rng.uniform(0.2, 3.0, nA), T2=rng.uniform(0.02, 0.5, nA),
                  df=rng.uniform(-80, 80, nA),
                  tr=10e-3 + 3e-3 * rng.random(nTR))
        return arr(flips), {k: arr(v) for k, v in kw.items()}
    if cat:
        a = np.deg2rad(35.0)
        flips = np.r_[a / 2, np.full(nTR - 1, a)]
        kw = dict(T1=rng.uniform(0.6, 1.8, nA), T2=rng.uniform(0.04, 0.25, nA),
                  df=rng.uniform(-80, 80, nA), M0=rng.uniform(0.7, 1.2, nA),
                  tr=np.r_[2.5e-3, np.full(nTR - 1, 5e-3)])
        return arr(flips), {k: arr(v) for k, v in kw.items()}
    flips = rng.uniform(0.1, 1.2, nTR)
    kw = dict(T1=rng.uniform(0.3, 2.0, nA), T2=rng.uniform(0.03, 0.3, nA),
              df=rng.uniform(-80, 80, nA), M0=rng.uniform(0.7, 1.2, nA),
              tr=rng.uniform(4e-3, 6e-3, nTR) if vartr else 5e-3)
    if te:
        kw['te'] = rng.uniform(1e-3, 3e-3, nTR)
    if phis:
        kw['phis'] = rng.uniform(-3, 3, nTR)
    if b1:
        kw['b1'] = rng.uniform(0.8, 1.2, nA)
    return arr(flips), {k: arr(v) for k, v in kw.items()}


def phase_bssfp_kernels(dev):
    r"""Phase 29: ``bssfp_fwd``, ``bssfp_fwd_chk`` and ``bssfp_bwd`` against
    their plain versions on BSSFP_CASES, on the arguments ``bssfp_train``
    gives them (``ops.ssfp._bssfp_rows``: ``coef`` and ``pk``); the adjoint
    is fed the kernel's checkpoints and a cotangent drawn from a seed, the
    plain adjoint written out, with no autograd graph. bench_bssfp_fit's
    shape is timed with its bound, bench_mrf's bSSFP dictionary
    (``bssfp_fwd``) too. Per-atom outputs (echoes, checkpoints, ``dpk``) at
    EPG_BAR of their largest value (bit for bit expected; the ``dpk`` rows
    that differ are named), the per-TR rows at BSSFP_ROW_BAR. Returns each
    kernel's rows."""
    from mrphy_tpu_torch.kernels import ssfp as ks
    from mrphy_tpu_torch.ops import ssfp
    t0 = time.perf_counter()
    rows = {n: [] for n in BSSFP_KERNELS}
    for seed, (label, nA, nTR, dtype, kw, tc, run, timed) in enumerate(
            BSSFP_CASES, 290):
        flips, ckw = bssfp_case(nA, nTR, dtype, dev, seed=seed, **kw)
        coef, pk, cfg, _ = ssfp._bssfp_rows(flips, **ckw)
        coef, pk = coef.contiguous(), pk.contiguous()
        tc = tc or ks.chunk(nTR, nA, coef.element_size())
        chk = gr = gi = None
        if 'bssfp_bwd' in run:
            chk = ks.bssfp_fwd_chk(coef, pk, cfg, tc=tc)[2]
            gr, gi = cotangent(torch.empty((2, nTR, nA), dtype=dtype,
                                           device=dev), seed)
        runs = {
            'bssfp_fwd': (lambda: ks.bssfp_fwd(coef, pk, cfg),
                          lambda: ks.bssfp_fwd_torch(coef, pk, cfg),
                          (coef, pk), ('er', 'ei')),
            'bssfp_fwd_chk': (
                lambda: ks.bssfp_fwd_chk(coef, pk, cfg, tc=tc),
                lambda: ks.bssfp_fwd_chk_torch(coef, pk, cfg, tc=tc),
                (coef, pk), ('er', 'ei', 'chk')),
            'bssfp_bwd': (
                lambda: ks.bssfp_bwd(coef, pk, cfg, chk, gr, gi, tc=tc),
                lambda: ks.bssfp_bwd_torch(coef, pk, cfg, chk, gr, gi,
                                           tc=tc),
                (coef, pk, chk, gr, gi), ('dcoef', 'dpar'))}
        for name in run:
            run_kernel, run_plain, inputs, names = runs[name]
            meta = dict(case=label, nA=nA, nTR=nTR, tc=tc, vartr=cfg.vartr,
                        b1=cfg.has_b1)
            rows[name].append(compare_epg(
                name, run_kernel, run_plain, inputs, names, meta, dtype,
                timed, BSSFP_ROW_BAR))
        del coef, pk, chk, gr, gi, ckw, flips
    print(f'phase 29 took {time.perf_counter() - t0:.1f} s', flush=True)
    return rows


def phase_bssfp_path(dev):
    r"""Phase 30a: the balanced-SSFP path through ``ssfp.bssfp_train``, and
    nothing else, so that the launch counts read after it are the path's
    own: BSSFP_FIT at full width on CUDA tensors under ``backend='auto'``.
    The forward at the truth (``bssfp_fwd``), timed in voxels per second;
    the first fit step's gradients on BSSFP_FIT['nslice'] voxels against
    the plain route; the fit's steps (``bssfp_fwd_chk``, the loss,
    ``bssfp_bwd``, autograd of the rows, Adam on 4 × 1M parameters): s per
    step, voxel-TRs per second, peak memory, the loss must fall. The
    whole-volume forward and every fit step must each launch their kernels
    once (the counts read around them). Returns the measurements;
    :func:`phase_bssfp_parts` splits the forward's time after the counts
    are read, :func:`phase_bssfp_examples` runs 30b-c."""
    from mrphy_tpu_torch.kernels import ssfp as ks
    from mrphy_tpu_torch.ops import ssfp
    t0 = time.perf_counter()
    c = BSSFP_FIT
    nV, nTR = c['nV'], c['nTR']
    flips, trs, truth = bssfp_fit_arrays(nV, dev)

    def forward():
        return ssfp.bssfp_train(flips, tr=trs, **truth)

    with torch.no_grad():
        n0 = dict(ks.LAUNCHES)
        data = forward()
        fwd_launches = {k: ks.LAUNCHES[k] - n0[k] for k in ks.LAUNCHES}
        fwd_ms = time_ms(forward)
    check(fwd_launches == dict(bssfp_fwd=1, bssfp_fwd_chk=0, bssfp_bwd=0),
          f'bSSFP forward: launches {fwd_launches}')
    check(tuple(data.shape) == (nV, nTR, 2)
          and bool(torch.isfinite(data).all()), 'bSSFP forward finite')
    p = {k: torch.full((nV,), np.log(v) if k in ('T1', 'T2') else v,
                       dtype=torch.float32, device=dev).requires_grad_()
         for k, v in c['start'].items()}

    def model(sl=slice(None), backend='auto'):
        return ssfp.bssfp_train(
            flips, T1=torch.exp(p['T1'][sl]), T2=torch.exp(p['T2'][sl]),
            tr=trs, df=c['df_scale'] * p['df'][sl], M0=p['M0'][sl],
            backend=backend)

    # the first step's gradients on a slice: the kernels against the plain
    # route (autograd of its loop over TRs)
    sl = slice(0, c['nslice'])
    gk, gp = (torch.autograd.grad(torch.mean((model(sl, b) - data[sl]) ** 2),
                                  list(p.values()))
              for b in ('auto', 'torch'))
    grad_err = max(max_err(a[sl], b[sl]) / float(b[sl].abs().max())
                   for a, b in zip(gk, gp))
    del gk, gp
    opt = torch.optim.Adam(list(p.values()), lr=c['lr'])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    losses, step_s = [], []
    n0 = dict(ks.LAUNCHES)
    for _ in range(c['steps']):
        t1 = time.perf_counter()
        opt.zero_grad()
        loss = torch.mean((model() - data) ** 2)
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t1)
        losses.append(float(loss.detach()))
    peak = torch.cuda.max_memory_allocated(dev)
    fit_launches = {k: ks.LAUNCHES[k] - n0[k] for k in ks.LAUNCHES}
    check(fit_launches == dict(bssfp_fwd=0, bssfp_fwd_chk=c['steps'],
                               bssfp_bwd=c['steps']),
          f'bSSFP fit: launches over {c["steps"]} steps {fit_launches}')
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f'bSSFP fit: the loss did not fall: {losses}')
    s = statistics.median(step_s)
    out = dict(fwd_ms=fwd_ms, fwd_voxels_per_s=nV / fwd_ms * 1e3,
               step_s=s, steps_s=step_s, voxel_trs_per_s=nV * nTR / s,
               peak_gb=peak / 1e9, losses=losses, grad_slice_err=grad_err,
               fit_launches=fit_launches)
    print('bSSFP path: ' + json.dumps(dict(
        measured=out, bars=dict(grad_slice_err=c['grad_bar']))), flush=True)
    check(grad_err <= c['grad_bar'],
          f'grad_slice_err: {grad_err} > {c["grad_bar"]}')
    print(f'phase 30a took {time.perf_counter() - t0:.1f} s', flush=True)
    return out


def phase_bssfp_examples(dev):
    r"""Phases 30b-c, after 30a's launch counts are read: (b) BSSFP_EX in
    float64 against JAX's literals (:func:`bssfp_example`); (c)
    MRF_BSSFP_EX in float64 against JAX's literals and ``bssfp_steady``
    against a long train (:func:`mrf_bssfp_example`). Returns the
    measurements."""
    t0 = time.perf_counter()
    out = bssfp_example(dev)
    out.update(mrf_bssfp_example(dev))
    bars = dict(example_data=1e-10, example_loss0=1e-10, example_grad0=1e-10,
                example_losses=BSSFP_EX_BAR['losses'],
                example_maps=BSSFP_EX_BAR['maps'], mrf_D=1e-10, mrf_m0=1e-10,
                mrf_p=1e-8, mrf_score=1e-8, steady_vs_train=1e-10)
    print('bSSFP examples: ' + json.dumps(dict(measured=out, bars=bars)),
          flush=True)
    for key, bar in bars.items():
        check(out[key] <= bar, f'{key}: {out[key]} > {bar}')
    print(f'phases 30b-c took {time.perf_counter() - t0:.1f} s', flush=True)
    return out


def phase_bssfp_parts(dev, fwd_ms):
    r"""Phase 30d, after phase 30a's launch counts are read: the parts of
    30a's forward at the truth, timed apart against its whole
    (``fwd_ms``): the kernels' arguments (``ops.ssfp._bssfp_rows``), the
    kernel ``bssfp_fwd`` alone, and the layout of its ``(nTR, nA)`` echo
    planes as the public ``(nA, nTR, 2)``."""
    from mrphy_tpu_torch.kernels import ssfp as ks
    from mrphy_tpu_torch.ops import ssfp
    flips, trs, truth = bssfp_fit_arrays(BSSFP_FIT['nV'], dev)
    with torch.no_grad():
        coef, pk, cfg, _ = ssfp._bssfp_rows(flips, tr=trs, **truth)
        er, ei = ks.bssfp_fwd(coef, pk, cfg)
        rows_ms = time_ms(lambda: ssfp._bssfp_rows(flips, tr=trs, **truth))
        kernel_ms = time_ms(lambda: ks.bssfp_fwd(coef, pk, cfg))
        layout_ms = time_ms(lambda: torch.stack([er.T, ei.T], -1))
    out = dict(fwd_ms=fwd_ms, rows_ms=rows_ms, kernel_ms=kernel_ms,
               layout_ms=layout_ms, kernel_share=kernel_ms / fwd_ms,
               layout_share=layout_ms / fwd_ms)
    print('bSSFP path, the forward\'s parts: ' + json.dumps(out), flush=True)
    return out


# Phase 30b: examples/bssfp_fit.py at its defaults in float64: 512 voxels
# (numpy default_rng(5): T1 0.6-1.8 s, T2 40-250 ms, df ±0.4/tr, M0
# 0.7-1.2), the α/2-catalysed 35° train (201 TRs: tr/2, then 200 at tr 5
# ms), 4 phase-cycle increments 2π·c/4, the catalysation echo dropped, 400
# Adam steps (lr 0.05) on (log T1, log T2, df / 30 Hz, M0) from (1 s, 100
# ms, 0, 1). The data entries (cycle, voxel, TR) and the voxels whose
# gradient and fitted maps are held to JAX.
BSSFP_EX = dict(nv=512, ntr=200, ncycles=4, tr=5e-3, flip=35.0, iters=400,
                lr=0.05, df_scale=30.0)
BSSFP_EX_ENTRIES = [(0, 0, 0), (0, 511, 199), (1, 17, 3), (2, 100, 50),
                    (3, 257, 120), (3, 400, 199)]
BSSFP_EX_VOXELS = [0, 101, 257, 511]
BSSFP_EX_LOSS_STEPS = [0, 1, 10, 100, 399]
BSSFP_EX_MAPS = ('T1', 'T2', 'df', 'M0')


def bssfp_example_arrays():
    r"""The BSSFP_EX problem's numpy float64 inputs: ``(flips, trs, dphis,
    truth)``, ``truth`` the maps T1, T2, df, M0."""
    c = BSSFP_EX
    nv = c['nv']
    rng = np.random.default_rng(5)
    truth = dict(T1=rng.uniform(0.6, 1.8, nv), T2=rng.uniform(0.04, 0.25, nv),
                 df=rng.uniform(-0.4, 0.4, nv) / c['tr'],
                 M0=rng.uniform(0.7, 1.2, nv))
    a = np.deg2rad(c['flip'])
    flips = np.r_[a / 2, np.full(c['ntr'], a)]
    trs = np.r_[c['tr'] / 2, np.full(c['ntr'], c['tr'])]
    dphis = 2 * np.pi * np.arange(c['ncycles']) / c['ncycles']
    return flips, trs, dphis, truth


# mrphy_tpu (JAX, XLA route on the CPU), float64, on the BSSFP_EX problem
# (tests/make_bssfp_goldens.py prints these): the data at BSSFP_EX_ENTRIES
# (re, im) and its largest |value|, the first loss, its gradient w.r.t. the
# fit's parameters at BSSFP_EX_VOXELS and each one's largest magnitude, the
# losses at BSSFP_EX_LOSS_STEPS, and the fitted maps at BSSFP_EX_VOXELS.
GOLDEN_BSSFP_FIT = {'data': [[0.5195274895085231, 0.41248015821184647],
                             [0.18310122597783204, 0.0034868058405611115],
                             [0.3364374012448377, 0.06031665822175888],
                             [-0.004505058714732104, 0.17014300349700368],
                             [-0.06790268892839915, 0.0741669447245154],
                             [-0.20443871502749278, 0.21572553208648984]],
                    'data_max': 1.1427463486617202,
                    'loss0': 0.02701065684054294,
                    'grad0': {'T1': [-2.7136759959569293e-06,
                                     4.2060993794494414e-06,
                                     -3.84671467188785e-06,
                                     -4.050455696694835e-06],
                              'T2': [2.266850044355279e-05,
                                     4.295902113498588e-06,
                                     1.957640355417337e-05,
                                     2.7179606218317324e-05],
                              'df': [-3.474908241025219e-05,
                                     3.949315783865614e-05,
                                     -1.89991568530565e-05,
                                     -3.3497397453539794e-05],
                              'M0': [4.8675214011245016e-05,
                                     -2.258563003168992e-06,
                                     3.9200583179385795e-05,
                                     6.383276875922478e-05]},
                    'grad0_max': {'T1': 8.597453134365988e-06,
                                  'T2': 3.735073435263469e-05,
                                  'df': 6.0043460817272735e-05,
                                  'M0': 9.334195649181941e-05},
                    'losses': [0.02701065684054294, 0.0245879078367995,
                               0.015418310788331514, 7.475232705271159e-05,
                               8.587595976539992e-07],
                    'maps': {'T1': [1.5660035390586826, 1.5945576789402658,
                                    1.22890098200502, 0.8375684970631238],
                             'T2': [0.12030853311174468, 0.147896454888864,
                                    0.05980080073336688, 0.09446980036413762],
                             'df': [42.00175624199835, -12.808418378532972,
                                    3.7372067903448536, 59.837193727790265],
                             'M0': [0.8917990101618458, 1.1919537628498824,
                                    0.8521072381507631, 1.0192513446417504]}}
# The same script's ULP_RESPONSE: JAX's own losses and fitted maps move by
# this much (largest relative change) when the 400 steps run on the data
# moved one ulp. The fit converges (median map errors ~1e-8 of the truth),
# so the maps barely move; the last loss, ~1e-6 of the first, moves most.
# Phase 30b holds the port's at 100× the response, as 26b does. A 0.1%
# change of the learning rate (LR_RESPONSE) moves JAX's losses by 0.34 and
# its maps by 6.1e-10, past these bars.
BSSFP_EX_ULP = {'losses': 9.740554002074461e-07,
                'maps': 2.7836151429858714e-15}
BSSFP_EX_BAR = {k: 100 * v for k, v in BSSFP_EX_ULP.items()}


def bssfp_example(dev):
    r"""The BSSFP_EX problem in float64 on the card against
    GOLDEN_BSSFP_FIT, through ``bssfp_train`` over the 201-TR train per
    phase cycle (so the float64 kernels run: ``bssfp_fwd`` for the data,
    ``bssfp_fwd_chk`` + ``bssfp_bwd`` per cycle and iteration): the data
    relative to its largest, the first loss relative to itself, its
    gradient relative to each one's largest, the losses along the fit and
    the fitted maps relative to each value (at BSSFP_EX_BAR); and the
    example's own asserts (the loss falls 100-fold, median T1, T2 and M0
    errors < 5%, df < 1 Hz)."""
    from mrphy_tpu_torch.ops import ssfp
    c, gold = BSSFP_EX, GOLDEN_BSSFP_FIT
    f64 = dict(dtype=torch.float64, device=dev)
    flips, trs, dphis, truth = bssfp_example_arrays()
    flips, trs = torch.as_tensor(flips, **f64), torch.as_tensor(trs, **f64)

    def echoes(m):
        return torch.stack([ssfp.bssfp_train(flips, tr=trs, dphi=float(dp),
                                             **m)
                            for dp in dphis])[:, :, 1:, :]

    with torch.no_grad():
        data = echoes({k: torch.as_tensor(v, **f64)
                       for k, v in truth.items()})
    p = {k: torch.full((c['nv'],), np.log(v) if k in ('T1', 'T2') else v,
                       **f64).requires_grad_()
         for k, v in BSSFP_FIT['start'].items()}

    def maps():
        return dict(T1=torch.exp(p['T1']), T2=torch.exp(p['T2']),
                    df=c['df_scale'] * p['df'], M0=p['M0'])

    opt = torch.optim.Adam(list(p.values()), lr=c['lr'])
    losses = []
    for i in range(c['iters']):
        opt.zero_grad()
        loss = torch.mean((echoes(maps()) - data) ** 2)
        loss.backward()
        if i == 0:
            g0 = {k: x.grad.cpu().numpy().copy() for k, x in p.items()}
        opt.step()
        losses.append(float(loss.detach()))
    with torch.no_grad():
        fit = {k: v.cpu().numpy() for k, v in maps().items()}
    err = {k: float(np.median(np.abs(fit[k] - truth[k])
                              / (1.0 if k == 'df' else truth[k])))
           for k in BSSFP_EX_MAPS}
    check(losses[-1] < 1e-2 * losses[0] and err['T1'] < 0.05
          and err['T2'] < 0.05 and err['df'] < 1.0 and err['M0'] < 0.05,
          f'example: losses {losses[0]} -> {losses[-1]}, median errors '
          f'{err}')
    e = data.cpu().numpy()
    vox = BSSFP_EX_VOXELS

    def rel(a, b):
        a, b = np.asarray(a), np.asarray(b)
        return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))

    ents = np.asarray([e[cy, v, t] for cy, v, t in BSSFP_EX_ENTRIES])
    return dict(
        example_data=float(np.max(np.abs(ents - gold['data'])))
        / gold['data_max'],
        example_loss0=rel(losses[0], gold['loss0']),
        example_grad0=max(float(np.max(np.abs(g0[k][vox] - gold['grad0'][k])))
                          / gold['grad0_max'][k] for k in BSSFP_EX_MAPS),
        example_losses=rel([losses[i] for i in BSSFP_EX_LOSS_STEPS],
                           gold['losses']),
        example_maps=max(rel(fit[k][vox], gold['maps'][k])
                         for k in BSSFP_EX_MAPS),
        example_median_err=err)


# Phase 30c: examples/mrf_dictionary.py --seq bssfp at its defaults in
# float64: MRF_EX's 150-TR flip train at tr 12 ms (te tr/2, the alternating
# ±x cycle) over MRF_EX's (T1, T2) grid × 15 df from −40 to 40 Hz, the probe
# (T1 830 ms, T2 67 ms, df 13 Hz) with receive phase 0.6 and unrotated,
# matched in the compressed space, refined by 250 Adam steps (lr 0.02) on
# (log T1, log T2, df / 100 Hz) from the matched atom. The dictionary
# entries (atom, TR) held to JAX. BANDING: examples/bssfp_banding.py's
# tissue and sequence (tr 5 ms, 35°, T1 1 s, T2 80 ms, te tr/2) over 33 df
# across ±1.5/tr, the steady state against the last echo of a 6000-TR train
# (30 T1: the transient is below e^-30).
MRF_BSSFP_EX = dict(ndf=15, df_max=40.0, df=13.0)
MRF_BSSFP_ENTRIES = [(0, 0), (0, 149), (17, 3), (400, 77), (2345, 100),
                     (5014, 149)]
BANDING = dict(tr=5e-3, alpha=35.0, T1=1.0, T2=0.08, nf=33, ntr=6000)
# mrphy_tpu (JAX, XLA route on the CPU), float64, on the MRF_BSSFP_EX
# problem (tests/make_bssfp_goldens.py prints these): the dictionary at
# MRF_BSSFP_ENTRIES and its largest |value|, the basis rank, the matched
# atoms of the two probes and their m0, the refined parameters [log T1,
# log T2, df/100] and the final score, and the fit as the example prints
# it.
GOLDEN_MRF_BSSFP = {'D': [[-0.12838788892719052, 0.008077481311252755],
                          [-0.11486586544153689, 0.025063045392246845],
                          [-0.7141888821014934, 0.1663593704402763],
                          [-0.034420171555139795, 0.02129678487661311],
                          [-0.023210669867829523, 0.13753387613835605],
                          [0.008210350027596828, 0.07465931914936633]],
                    'D_max': 0.869861025434327,
                    'rank': 208,
                    'idx': [5271, 5271],
                    'm0': [[0.842987280899465, 0.5688917650099716],
                           [1.0169678791314944, -0.006459788636072748]],
                    'p': [-0.18632965133774165, -2.703062628217108,
                          0.1299999854861315],
                    'score': 0.9999999999999987,
                    'printed': 'T1=830 ms, T2=67.0 ms, df=13.00 Hz'}


def mrf_bssfp_example(dev):
    r"""The MRF_BSSFP_EX problem in float64 on the card against
    GOLDEN_MRF_BSSFP, through ``bssfp_train`` (``bssfp_fwd`` for the
    dictionary and the probe, ``bssfp_fwd_chk`` + ``bssfp_bwd`` per
    refinement step) and ``ops.mrf`` (``match``): errors relative to each
    quantity's largest value (parameters and score: relative to each
    value), the rank and the matched atoms equal; then BANDING's steady
    state (``bssfp_steady``) against the last echo of its train."""
    from mrphy_tpu_torch.ops import mrf, ssfp
    c, b, gold = MRF_EX, MRF_BSSFP_EX, GOLDEN_MRF_BSSFP
    f64 = dict(dtype=torch.float64, device=dev)
    flips, _, _, T1a, T2a = (torch.as_tensor(x, device=dev) for x in
                             mrf_example_arrays())
    nK = T1a.shape[0]
    T1d, T2d = T1a.repeat(b['ndf']), T2a.repeat(b['ndf'])
    dfd = torch.as_tensor(np.repeat(np.linspace(-b['df_max'], b['df_max'],
                                                b['ndf']), nK), **f64)

    def signals(T1, T2, df):
        return ssfp.bssfp_train(flips, T1=T1, T2=T2, tr=c['tr'], df=df)

    def one(x):
        return torch.tensor(x, **f64)

    with torch.no_grad():
        D = signals(T1d, T2d, dfd)
        probe0 = signals(one(c['T1']), one(c['T2']), one(b['df']))
    basis = mrf.svd_basis(D, energy=c['energy'])
    Dc = mrf.compress(D, basis)
    cp, sp = np.cos(c['ph']), np.sin(c['ph'])
    probe = torch.stack([cp * probe0[..., 0] - sp * probe0[..., 1],
                         sp * probe0[..., 0] + cp * probe0[..., 1]], -1)
    res = mrf.dict_match_compressed(Dc, torch.stack([probe, probe0]), basis)
    best = int(res.idx[0])
    check([int(i) for i in res.idx] == gold['idx'],
          f"bSSFP MRF match {res.idx.tolist()} != JAX's {gold['idx']}")
    check(basis.B.shape[1] == gold['rank'],
          f"bSSFP MRF rank {basis.B.shape[1]} != JAX's {gold['rank']}")
    ents = torch.stack([D[a, t] for a, t in MRF_BSSFP_ENTRIES]).cpu().numpy()

    def sig(q):
        return signals(torch.exp(q[0]), torch.exp(q[1]), 100.0 * q[2])

    p0 = torch.stack([torch.log(T1d[best]), torch.log(T2d[best]),
                      dfd[best] / 100.0])[None]
    p, score = mrf.match_refine(sig, p0, probe[None], iters=c['iters'],
                                lr=c['lr'])
    p, score = p[0].detach().cpu().numpy(), float(score[0])
    gp = np.asarray(gold['p'])
    printed = mrf_bssfp_printed(p)
    check(printed == gold['printed'],
          f"bSSFP MRF fit printed {printed!r} != JAX's {gold['printed']!r}")
    # the steady state against the last echo of a long train
    bd = BANDING
    dfb = torch.linspace(-1.5 / bd['tr'], 1.5 / bd['tr'], bd['nf'], **f64)
    a = one(np.deg2rad(bd['alpha']))
    with torch.no_grad():
        train = ssfp.bssfp_train(a.expand(bd['ntr']), T1=bd['T1'],
                                 T2=bd['T2'], tr=bd['tr'], df=dfb)
        st = ssfp.bssfp_steady(a, T1=bd['T1'], T2=bd['T2'], tr=bd['tr'],
                               df=dfb)
    return dict(
        mrf_D=float(np.abs(ents - np.asarray(gold['D'])).max()
                    / gold['D_max']),
        mrf_m0=float(np.abs(res.m0.cpu().numpy()
                            - np.asarray(gold['m0'])).max()
                     / np.abs(gold['m0']).max()),
        mrf_p=float(np.max(np.abs(p - gp) / np.maximum(np.abs(gp), 1e-300))),
        mrf_score=abs(score - gold['score']) / gold['score'],
        mrf_printed=printed, mrf_idx=[int(i) for i in res.idx],
        mrf_rank=int(basis.B.shape[1]),
        steady_vs_train=max_err(train[:, -1], st) / float(st.abs().max()))


def mrf_bssfp_printed(p) -> str:
    r"""The refined ``p = [log T1, log T2, df/100]`` as
    examples/mrf_dictionary.py prints it (without the relative errors)."""
    return (f'T1={np.exp(p[0]) * 1e3:.0f} ms, T2={np.exp(p[1]) * 1e3:.1f} '
            f'ms, df={100.0 * p[2]:.2f} Hz')


# ==========================================================================
# The EPG-X(MT) bound-pool train: qMT (phases 31-32)
# ==========================================================================

# examples/qmt_fit.py (lines 51-62): the pool (T1a 1.1 s, T1b 1.0 s, T2a 60
# ms, tr 30 ms), the saturation pulse of 15 ms each TR, its protocol
# (offsets 2-32 kHz × ω1rms 350 and 700 Hz) and its 10° flips, K 48.
QMT = dict(T1a=1.1, T1b=1.0, T2a=0.06, tr=0.03, tau=0.015, flip=10.0,
           offs=(2e3, 4e3, 8e3, 16e3, 32e3), w1rms=(350.0, 700.0), K=48)
# Phase 32a, the qMT dictionary path at the TPU kernel's dictionary shape
# (benchmarks/RESULTS.md:584-592: 65,536 atoms × 400 TRs, K 48): a 64 F
# (0.02-0.25) × 32 kba (5-40 /s) × 32 T2b (8-14 µs) grid, F-major, at QMT's
# pool with M0a = 1 − F, M0b = F, kab = kba·F/(1 − F); 400 TRs of
# bench_mrf's flips 10 + 50·|sin(t/40)|° with rf-spoiled phases; the
# saturation at Δ 4 kHz with ω1rms cycling 0, 350, 700 Hz in blocks of 50
# TRs: wt_t = π·(2π·ω1rms_t)²·τ_sat, wscale = mt_lineshape(4 kHz, T2b).
# The plain route's check on the first 4096 atoms (4 F × 32 × 32); a
# rank-16 basis; 1M probes drawn from the atoms (numpy default_rng(0)) with
# a random phase and noise of 5e-4 (1.4% of the mean |signal|; a torch
# generator seeded 0 on the card) matched by `match`, at least `within1` of
# them within one grid step in F and in kba (one offset does not resolve
# T2b: on the CPU, 8 F × 32 × 32 of this grid matched 4000 such probes
# within one step at 1.0 in F, 0.98 in kba, 0.17 in T2b); 50 Adam steps of
# match_refine(batched=True) on 4096 probes from their matched atoms, the
# median relative errors against the truth within `refine_bar` and T2b's
# lower than its matched atoms' (on the CPU, 64 probes of that grid went
# from 0, 0, 0.10 to 0.016, 0.023, 0.086 in F, kba, T2b); the
# protocol gradient (the neighbouring-kba separation of the dictionary
# w.r.t. the flips, the wt train and the per-atom F, kba, T2b) at full
# width in float32, and in float64 on the 4096 atoms against the plain
# route at grad_bar (in float32 the two routes' sums over the slice differ
# by ~1e-4 of the flips' row, as two float32 reductions do).
QMT_DICT = dict(nF=64, nk=32, nt=32, F=(0.02, 0.25), kba=(5.0, 40.0),
                T2b=(8e-6, 14e-6), ntr=400, delta=4e3,
                w1_cycle=(0.0, 350.0, 700.0), block=50, nslice=4096,
                rank=16, nV=1 << 20, noise=5e-4, nref=4096, iters=50,
                lr=0.02, grad_bar=1e-9, within1=dict(F=0.95, kba=0.9),
                refine_bar=dict(F=0.05, kba=0.1, T2b=0.2))
# The per-TR rows of xmt_bwd are sums over atoms that the plain version
# takes in the kernel's order (warp trees, then one torch.sum over the
# warps): bit for bit expected; the bar of the two-pool CPMG rows.
XMT_ROW_BAR = {torch.float32: 5e-7, torch.float64: 1e-15}
XMT_KERNELS = ('xmt_fwd', 'xmt_fwd_chk', 'xmt_bwd')
# The kernels' cases (phase 31): label, atoms, TRs, K (None: the default
# nTR·|kshift| + 1), dtype, xmt_case keywords, the chunk (None: the
# adjoint's own, kernels/epg.adjoint_tc at 8 planes), timed.
XMT_CASES = (
    ('qMT dictionary 65,536 x 400, K 48 (phase 32a)', 65536, 400, 48,
     torch.float32, dict(qmt=True), None, True),
    ('16k x 200, K 32, b1', 16384, 200, 32, torch.float32, dict(b1=True),
     None, False),
    ('16k x 200, K 32, kshift -1', 16384, 200, 32, torch.float32,
     dict(kshift=-1), None, False),
    ('16k x 200, K 32, no detailed balance (kab 8, kba 3, M0b 0.4)', 16384,
     200, 32, torch.float32, dict(ndb=True), None, False),
    ('16k x 200, K 32, wt = 0 and no exchange (= spgr_fwd at te 0)', 16384,
     200, 32, torch.float32, dict(decoupled=True), None, False),
    ('2048 x 400, default K 401 (device-memory state)', 2048, 400, None,
     torch.float32, {}, None, False),
    ('ragged 1001 x 201, K 32, b1 (three chunks of 67)', 1001, 201, 32,
     torch.float32, dict(b1=True), 67, False),
    ('f64 8192 x 200, K 32, b1, wscale', 8192, 200, 32, torch.float64,
     dict(b1=True), None, False),
)


def qmt_truth(nv, seed=0):
    r"""examples/qmt_fit.py's voxels, from numpy default_rng(``seed``) in its
    order: ``(F, kba, T2b, rng)`` (F 0.06-0.22, kba 8-25 /s, T2b 9-13 µs),
    ``rng`` left where the example draws its noise."""
    rng = np.random.default_rng(seed)
    F = rng.uniform(0.06, 0.22, nv)
    kba = rng.uniform(8.0, 25.0, nv)
    T2b = rng.uniform(9e-6, 13e-6, nv)
    return F, kba, T2b, rng


def qmt_train(nTR, dtype, dev):
    r"""QMT_DICT's train over ``nTR`` TRs: ``(flips, phis, wt)``, each
    ``(nTR,)``."""
    from mrphy_tpu_torch.ops import epg
    c = QMT_DICT
    t = np.arange(nTR)
    w1 = 2 * np.pi * np.asarray(c['w1_cycle'])[(t // c['block'])
                                               % len(c['w1_cycle'])]

    def arr(x):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    return (arr(np.deg2rad(10 + 50 * np.abs(np.sin(t / 40.0)))),
            epg.rf_spoil_phases(nTR, dtype=dtype, device=dev),
            arr(np.pi * w1 ** 2 * QMT['tau']))


def qmt_grid(dtype, dev):
    r"""QMT_DICT's grid: its axes (numpy) and its atoms ``(F, kba, T2b)``
    (F-major, then kba, then T2b)."""
    c = QMT_DICT
    axes = tuple(np.linspace(*c[k], c[n]) for k, n in
                 (('F', 'nF'), ('kba', 'nk'), ('T2b', 'nt')))
    mesh = np.meshgrid(*axes, indexing='ij')
    return axes, tuple(torch.as_tensor(m.ravel(), dtype=dtype, device=dev)
                       for m in mesh)


def qmt_kw(F, kba, T2b):
    r"""``xmt_spgr``'s tissue keywords at QMT's pool for the maps ``(F,
    kba, T2b)``: M0a = 1 − F, M0b = F, kab = kba·F/(1 − F), the saturation
    scale the super-Lorentzian at QMT_DICT's offset."""
    from mrphy_tpu_torch.ops import epg
    return dict(T1a=QMT['T1a'], T2a=QMT['T2a'], T1b=QMT['T1b'],
                kab=kba * F / (1 - F), kba=kba, tr=QMT['tr'], M0a=1 - F,
                M0b=F, wscale=epg.mt_lineshape(QMT_DICT['delta'], T2b),
                K=QMT['K'])


def xmt_case(nA, nTR, K, dtype, dev, *, qmt=False, b1=False, kshift=1,
             ndb=False, decoupled=False, seed=0):
    r"""``xmt_spgr`` keywords (CUDA tensors): with ``qmt`` QMT_DICT's
    dictionary (train and grid); otherwise ``nA`` atoms from ``seed`` at
    ``nTR`` TRs of bench_mrf's flips with rf-spoiled phases, QMT_DICT's
    saturation cycle, F ∈ [0.02, 0.25], kba ∈ [5, 40] /s, T2b ∈ [8, 14] µs,
    and, as asked, per-atom b1 ∈ [0.8, 1.2], ``kshift``, no detailed
    balance (kab 8, kba 3, M0a 1, M0b 0.4), or wt ≡ 0 without exchange."""
    rng = np.random.default_rng(seed)

    def arr(x):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    flips, phis, wt = qmt_train(nTR, dtype, dev)
    if qmt:
        F, kba, T2b = qmt_grid(dtype, dev)[1]
    else:
        F, kba, T2b = (arr(rng.uniform(*QMT_DICT[k], nA))
                       for k in ('F', 'kba', 'T2b'))
    kw = dict(qmt_kw(F, kba, T2b), flips=flips, phis=phis, wt=wt,
              kshift=kshift, K=K)
    if b1:
        kw['b1'] = arr(rng.uniform(0.8, 1.2, nA))
    if ndb:
        kw.update(kab=8.0, kba=3.0, M0a=1.0, M0b=0.4)
    if decoupled:
        kw.update(kab=0.0, kba=0.0, wt=torch.zeros_like(wt))
    return kw


def xmt_args(kw):
    r"""The kernels' arguments ``(coef, pk, cfg)`` for ``xmt_spgr(**kw)``
    (``ops.epg._xmt_rows``; over a tr train ``pk`` the pair ``(pk,
    pkt)``)."""
    from mrphy_tpu_torch.ops import epg
    kw = dict(kw)
    coef, pk, cfg, _ = epg._xmt_rows(kw.pop('flips'), kw.pop('phis'), **kw)
    if isinstance(pk, tuple):
        return coef.contiguous(), tuple(x.contiguous() for x in pk), cfg
    return coef.contiguous(), pk.contiguous(), cfg


def phase_xmt_kernels(dev):
    r"""Phase 31: ``xmt_fwd``, ``xmt_fwd_chk`` and ``xmt_bwd`` against their
    plain versions on XMT_CASES, on the arguments ``xmt_spgr`` gives them
    (``ops.epg._xmt_rows``: ``coef`` with the wt train, ``pk`` with
    ``wscale``); the adjoint fed the kernel's checkpoints and a cotangent
    drawn from a seed, the plain adjoint written out, with no autograd
    graph. The qMT dictionary of phase 32a is timed with its bound. Per-atom
    outputs (echoes, checkpoints, ``dpk``) at EPG_BAR of their largest value
    (bit for bit expected; the ``dpk`` rows that differ are named), the
    per-TR rows at XMT_ROW_BAR; the case with wt ≡ 0 and no exchange also
    against ``spgr_fwd`` (the single-pool train of pool a at te 0) at
    EPG_ROW_BAR. Returns each kernel's rows."""
    from mrphy_tpu_torch.kernels import epgx as kx
    from mrphy_tpu_torch.kernels.epg import adjoint_tc, launch_cfg
    from mrphy_tpu_torch.ops import epg
    t0 = time.perf_counter()
    rows = {name: [] for name in XMT_KERNELS}
    for seed, (label, nA, nTR, K, dtype, kw, tc, timed) in enumerate(
            XMT_CASES, 310):
        ckw = xmt_case(nA, nTR, K, dtype, dev, seed=seed, **kw)
        coef, pk, cfg = xmt_args(ckw)
        tc = tc or adjoint_tc(nTR, cfg.K, nA, pk.element_size(),
                              kx.PLANES_MT)
        adj_route = adjoint_meta(cfg.K, pk, kx.PLANES_MT, tc)
        chk = kx.xmt_fwd_chk(coef, pk, cfg, tc=tc)[1]
        g = cotangent(torch.empty((nA, nTR, 2), dtype=dtype, device=dev),
                      seed)
        runs = {
            'xmt_fwd': (lambda: kx.xmt_fwd(coef, pk, cfg),
                        lambda: kx.xmt_fwd_torch(coef, pk, cfg), (coef, pk)),
            'xmt_fwd_chk': (
                lambda: kx.xmt_fwd_chk(coef, pk, cfg, tc=tc),
                lambda: kx.xmt_fwd_chk_torch(coef, pk, cfg, tc=tc),
                (coef, pk)),
            'xmt_bwd': (
                lambda: kx.xmt_bwd(coef, pk, cfg, chk, g, tc=tc),
                lambda: kx.xmt_bwd_torch(coef, pk, cfg, chk, g, tc=tc),
                (coef, pk, chk, g))}
        names = {'xmt_fwd': ('sig',), 'xmt_fwd_chk': ('sig', 'chk'),
                 'xmt_bwd': ('dcoef', 'dpar')}
        for name, (run_kernel, run_plain, inputs) in runs.items():
            meta = dict(case=label, nA=nA, nTR=nTR, K=cfg.K,
                        kshift=cfg.kshift, tc=tc, b1=cfg.has_b1,
                        threads_state=launch_cfg(cfg.K, pk.element_size(),
                                                 kx.PLANES_MT))
            if name == 'xmt_bwd':
                meta['adjoint'] = adj_route
            rows[name].append(compare_epg(
                name, run_kernel, run_plain, inputs, names[name], meta,
                dtype, timed, XMT_ROW_BAR))
            if name == 'xmt_bwd' and adj_route['route'] == 'lanes':
                thread_check(rows[name][-1], name, run_kernel, kx,
                             'adjoint_cfg', names[name], dtype)
        if kw.get('decoupled'):
            # pool a alone: the single-pool SPGR train at te 0
            sig = kx.xmt_fwd(coef, pk, cfg)
            ref = epg.epg_spgr(ckw['flips'], ckw['phis'], T1=QMT['T1a'],
                               T2=QMT['T2a'], M0=ckw['M0a'], tr=QMT['tr'],
                               te=0.0, K=cfg.K)
            err = row_err(sig, ref)
            print(f'xmt_fwd {label} vs spgr_fwd: ' + json.dumps(dict(
                err=err, bar=EPG_ROW_BAR[dtype])), flush=True)
            check(err <= EPG_ROW_BAR[dtype],
                  f'xmt_fwd {label} vs spgr_fwd: {err}')
        del coef, pk, chk, g, ckw
    print(f'phase 31 took {time.perf_counter() - t0:.1f} s', flush=True)
    return rows


def qmt_separation(D):
    r"""The protocol loss of a qMT dictionary ``D (nF·nk·nt, nTR, 2)`` on
    QMT_DICT's grid: minus the mean squared difference of the atoms that
    neighbour in kba (the exchange rate, the weakest map)."""
    c = QMT_DICT
    D = D.reshape(-1, c['nk'], c['nt'], D.shape[-2], 2)
    return -torch.mean((D[:, 1:] - D[:, :-1]) ** 2)


def phase_qmt_path(dev, vartr=False):
    r"""Phase 32a (34a with ``vartr``): the qMT dictionary path through
    ``kernels.epgx.xmt_spgr`` and ``ops.mrf``, and nothing else, so that the
    launch counts read after it are the path's own, at QMT_DICT's full width
    in float32, at its scalar tr or, with ``vartr``, over QMT_V's
    fingerprinting train (the kernels ``xmt_v_*`` in place of ``xmt_*``,
    the bars of QMT_V): (1) the
    dictionary (``xmt_fwd``), timed in atoms per second, and against the
    plain route's batched ``wt[None]·wscale[:, None]`` (``epgx_mt_spgr``,
    ``backend='torch'``) on the first ``nslice`` atoms at EPG_ROW_BAR; (2)
    ``svd_basis``, ``compress`` and ``dict_match_compressed`` of 1M probes
    (``match``), timed in voxels per second, with the fractions matched
    within one grid step on each axis (at least ``within1`` in F and kba);
    (3) ``match_refine(batched=True)`` of ``nref`` probes from their
    matched atoms, 50 Adam steps of (log F, log kba, log T2b) through the
    kernels (``wscale`` the lineshape of the continuous T2b): s per step
    and the median relative errors against the truth (within
    ``refine_bar``, T2b's below the matched atoms'); (4) the protocol
    gradient (:func:`qmt_separation` w.r.t. the flips, the wt train, with
    ``vartr`` the tr train, and the per-atom F, kba, T2b; ``xmt_fwd_chk`` +
    ``xmt_bwd``) at full width, ms and peak memory, and on the slice in
    float64 against the plain route at ``grad_bar``. The window's launches
    must be exactly ``xmt_fwd`` 9 (the dictionary, its 6 timed calls, the
    refinement's first and last signals), ``xmt_fwd_chk`` and ``xmt_bwd`` 53
    (50 steps, the gradient twice, its slice) and ``match`` 2 (with
    ``vartr`` the same of ``xmt_v_*``, and no other kernel: ``xmt_*`` 0).
    Returns the measurements."""
    from mrphy_tpu_torch.kernels import epgx as kx
    from mrphy_tpu_torch.kernels import mrf as kmrf
    from mrphy_tpu_torch.ops import epg, mrf
    t0 = time.perf_counter()
    c = dict(QMT_DICT, **QMT_V) if vartr else QMT_DICT
    phase, v = ('34a', '_v') if vartr else ('32a', '')
    n0 = {**dict(kx.LAUNCHES), **dict(kmrf.LAUNCHES)}
    f32 = dict(dtype=torch.float32, device=dev)
    flips, phis, wt = qmt_train(c['ntr'], torch.float32, dev)
    trs = qmtv_dict_trs(c['ntr'], torch.float32, dev) if vartr else None
    F, kba, T2b = qmt_grid(torch.float32, dev)[1]
    nA, sl = F.shape[0], slice(0, c['nslice'])
    out, bars = {}, {}

    def tissue(F, kba, T2b, tr=trs):
        kw = qmt_kw(F, kba, T2b)
        if tr is not None:
            kw['tr'] = tr
        return kw

    def dictionary():
        with torch.no_grad():
            return kx.xmt_spgr(flips, phis, wt=wt, **tissue(F, kba, T2b))

    D = dictionary()
    torch.cuda.synchronize()
    check(D.shape == (nA, c['ntr'], 2) and bool(torch.isfinite(D).all()),
          'qMT dictionary finite')
    dict_ms = time_ms(dictionary)
    with torch.no_grad():
        kws = tissue(F[sl], kba[sl], T2b[sl])
        wsc = kws.pop('wscale')
        Dp = epg.epgx_mt_spgr(flips, phis, wt=wt[None] * wsc[:, None], **kws,
                              backend='torch')
    out.update(atoms=nA, dict_ms=dict_ms, dict_atoms_per_s=nA / dict_ms * 1e3,
               dict_vs_plain=row_err(D[sl], Dp))
    bars['dict_vs_plain'] = EPG_ROW_BAR[torch.float32]
    del Dp
    # the probes: random atoms, a random receive phase, noise
    rng = np.random.default_rng(0)
    nV = c['nV']
    truth = torch.as_tensor(rng.integers(0, nA, nV), device=dev)
    ph = torch.as_tensor(rng.uniform(-np.pi, np.pi, nV), **f32)[:, None, None]
    X = D[truth]
    X = torch.cos(ph) * X + torch.sin(ph) * torch.stack(
        [-X[..., 1], X[..., 0]], -1)
    gen = torch.Generator(device=dev).manual_seed(0)
    X += c['noise'] * torch.randn(X.shape, generator=gen, dtype=X.dtype,
                                  device=dev)
    del ph

    def match():
        basis = mrf.svd_basis(D, rank=c['rank'])
        return mrf.dict_match_compressed(mrf.compress(D, basis),
                                         mrf.compress(X, basis), basis)

    res = match()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res = match()
    torch.cuda.synchronize()
    t_match = time.perf_counter() - t1
    nk, nt = c['nk'], c['nt']
    idx, tt = res.idx.long(), truth

    def steps(i, j):
        return ((i // (nk * nt) - j // (nk * nt)).abs(),
                ((i // nt) % nk - (j // nt) % nk).abs(),
                (i % nt - j % nt).abs())

    sF, sk, st = steps(idx, tt)
    out.update(match_ms=t_match * 1e3, match_voxels_per_s=nV / t_match,
               match_exact=float((idx == tt).double().mean()),
               match_within1_F=float((sF <= 1).double().mean()),
               match_within1_kba=float((sk <= 1).double().mean()),
               match_within1_T2b=float((st <= 1).double().mean()))
    del res, D
    # refinement of nref probes from their matched atoms
    sel = torch.arange(c['nref'], device=dev)
    tr_, mi = tt[sel], idx[sel]
    P0 = torch.log(torch.stack([F[mi], kba[mi], T2b[mi]], -1))

    def sig_b(P):
        Fp, kp, tp = torch.exp(P).unbind(-1)
        return kx.xmt_spgr(flips, phis, wt=wt, **tissue(Fp, kp, tp))

    t1 = time.perf_counter()
    P, score = mrf.match_refine(sig_b, P0, X[sel], iters=c['iters'],
                                lr=c['lr'], batched=True)
    torch.cuda.synchronize()
    t_ref = time.perf_counter() - t1
    check(bool(torch.isfinite(P).all()), 'refined parameters finite')
    Pt = torch.stack([F[tr_], kba[tr_], T2b[tr_]], -1)
    rel = (torch.exp(P) / Pt - 1).abs().median(dim=0).values.tolist()
    rel0 = (torch.exp(P0) / Pt - 1).abs().median(dim=0).values.tolist()
    out.update(refine_voxels=c['nref'], refine_s=t_ref,
               refine_s_per_step=t_ref / c['iters'],
               refine_median_relerr=dict(zip(('F', 'kba', 'T2b'), rel)),
               refine_start_median_relerr=dict(zip(('F', 'kba', 'T2b'),
                                                   rel0)),
               refine_min_score=float(score.min()))
    del X, P, score
    # the protocol gradient at full width (float32), then on the slice in
    # float64 through the kernels against the plain route
    xs = dict(flips=flips, wt=wt, F=F, kba=kba, T2b=T2b)
    if vartr:
        xs['tr'] = trs

    def grad(sel=slice(None), backend=None, dtype=torch.float32):
        p = {k: v.detach().to(dtype).requires_grad_() for k, v in xs.items()}
        kw = tissue(p['F'][sel], p['kba'][sel], p['T2b'][sel], p.get('tr'))
        ph = phis.to(dtype)
        if backend is None:
            Dg = kx.xmt_spgr(p['flips'], ph, wt=p['wt'], **kw)
        else:
            wsc = kw.pop('wscale')
            Dg = epg.epgx_mt_spgr(p['flips'], ph, backend=backend,
                                  wt=p['wt'][None] * wsc[:, None], **kw)
        loss = qmt_separation(Dg)
        return torch.autograd.grad(loss, list(p.values()))

    grad()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t1 = time.perf_counter()
    g_full = grad()
    torch.cuda.synchronize()
    out.update(grad_ms=(time.perf_counter() - t1) * 1e3,
               grad_peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    check(all(bool(torch.isfinite(x).all()) for x in g_full),
          'qMT protocol gradient finite')
    del g_full
    gk = grad(sl, dtype=torch.float64)
    gp = grad(sl, 'torch', torch.float64)
    out['grad_slice_err'] = {k: row_err(a[:c['nslice']], b[:c['nslice']])
                             for k, a, b in zip(xs, gk, gp)}
    bars['grad_slice_err'] = c['grad_bar']
    del gk, gp
    out['peak_gb'] = torch.cuda.max_memory_allocated(dev) / 1e9
    launched = {k: v - n0[k] for k, v in {**dict(kx.LAUNCHES),
                                           **dict(kmrf.LAUNCHES)}.items()}
    want = dict(dict.fromkeys(launched, 0), match=2,
                **{f'xmt{v}_fwd': 9, f'xmt{v}_fwd_chk': c['iters'] + 3,
                   f'xmt{v}_bwd': c['iters'] + 3})
    out['launches'] = launched
    label = 'qMT fingerprinting path (variable TR)' if vartr else 'qMT path'
    print(f'{label}: ' + json.dumps(dict(
        measured=out, bars=dict(bars, match_within1_min=c['within1'],
                                refine_median_relerr=c['refine_bar']))),
        flush=True)
    check(launched == want, f'{label} launches {launched} != {want}')
    for key, bar in bars.items():
        v = out[key]
        worst = max(v.values()) if isinstance(v, dict) else v
        check(worst <= bar, f'{key}: {v} > {bar}')
    for k, lo in c['within1'].items():
        check(out[f'match_within1_{k}'] >= lo,
              f"match_within1_{k}: {out[f'match_within1_{k}']} < {lo}")
    for k, hi in c['refine_bar'].items():
        check(out['refine_median_relerr'][k] <= hi,
              f"refine_median_relerr {k}: {out['refine_median_relerr'][k]} "
              f'> {hi}')
    check(out['refine_median_relerr']['T2b']
          < out['refine_start_median_relerr']['T2b'],
          'the refinement did not lower the median T2b error')
    print(f'phase {phase} took {time.perf_counter() - t0:.1f} s', flush=True)
    return out


# Phase 32b: examples/qmt_fit.py at its defaults in float64 (QMT; 12
# voxels, 300 TRs, 600 Adam steps at lr 0.05 from F 0.12, kba 15 /s, T2b 11
# µs, noise 0.1% of the largest datum). Its losses are held at the steps
# QMT_EX_LOSS_STEPS.
QMT_EX = dict(nv=12, ntr=300, iters=600, lr=0.05, noise=0.1,
              start=dict(F=0.12, kba=15.0, T2b=11e-6))
QMT_EX_LOSS_STEPS = [0, 1, 10, 100, 300, 599]
# mrphy_tpu (JAX, XLA route on the CPU), float64, on the QMT_EX problem
# (tests/make_qmt_goldens.py prints these): the noiseless data of every
# voxel and measurement (offsets outer, powers inner) and its largest value,
# the first loss, its gradient w.r.t. the log maps and each one's largest
# magnitude, the losses at QMT_EX_LOSS_STEPS and the fitted maps.
GOLDEN_QMT = {'data': [[0.03201103070835223, 0.030821267630183953,
                       0.034078148716870434, 0.03084831124362479,
                       0.04194683398398291, 0.031771616675120254,
                       0.07329632166846001, 0.04823919841997028,
                       0.09865415173463639, 0.09471508244941194],
                      [0.06404085790815775, 0.06330310609851984,
                       0.06517452604688508, 0.06331944669840846,
                       0.06917349738833105, 0.0637561518804155,
                       0.08561862423931099, 0.07129968927068053,
                       0.10298352667059193, 0.09924172653996896],
                      [0.06150438168868532, 0.060414055418594,
                       0.06374995810561349, 0.060441323412627784,
                       0.07262363589276498, 0.061765450466038936,
                       0.09724069833619856, 0.08143522380243218,
                       0.10709925137396384, 0.10632311672398351],
                      [0.07437141521278799, 0.0737530520361003,
                       0.07565469970118155, 0.0737683654174305,
                       0.08098016963511072, 0.07450607086200985,
                       0.09863792595312193, 0.0866984498637786,
                       0.10730501787677768, 0.10656652632566772],
                      [0.02728045541070871, 0.02621342979731795,
                       0.02921411712538838, 0.02623792903150512,
                       0.03688141125385977, 0.027137116039419592,
                       0.06934295644008776, 0.04375347389075501,
                       0.09637953499899142, 0.09243754688655807],
                      [0.02835460819080614, 0.027410919061698298,
                       0.030040323336645084, 0.027432421986080254,
                       0.0367270819532929, 0.028195256593029,
                       0.06669611181924574, 0.042572557513834965,
                       0.09478173771392857, 0.09032617169580173],
                      [0.04133268155771116, 0.040431030966913896,
                       0.04296821689585658, 0.040451748324261454,
                       0.04944883304283002, 0.04121420052031562,
                       0.0767033991621051, 0.05526335672892448,
                       0.09913657617744799, 0.09589081287289183],
                      [0.03506804654780395, 0.03398943793550787,
                       0.03673583078837124, 0.034013305186144566,
                       0.0426843037669136, 0.03465535826230415,
                       0.06806212045222686, 0.04592154776514967,
                       0.09640233419014416, 0.09018381118484146],
                      [0.05210092611398953, 0.05122234908517416,
                       0.05328135518011646, 0.05124173667274165,
                       0.05712980991846388, 0.05163324240244804,
                       0.07346362533390391, 0.057924166554817455,
                       0.09784425418034969, 0.0904277503365744],
                      [0.035783085081074424, 0.035067687801721634,
                       0.03711526013969775, 0.035084178991359086,
                       0.042615506257861056, 0.0357130603844581,
                       0.0688875477051888, 0.047987734923324504,
                       0.09448059957203979, 0.09065785303429214],
                      [0.029186436050037616, 0.028101949138675777,
                       0.030993160504797182, 0.028126243189832336,
                       0.03777577192513835, 0.028883040307542563,
                       0.06696236581012807, 0.04262672697059656,
                       0.09576274251173887, 0.0904681062679774],
                      [0.06602220482959531, 0.06466740969546339,
                       0.06795737697698039, 0.0646977093112921,
                       0.07407662976785584, 0.06543864200382744,
                       0.09289355444543863, 0.07652476577145291,
                       0.10679541259868462, 0.10399596323081338]],
              'data_max': 0.10730501787677768,
              'loss0': 0.00020837397105142013,
              'grad0': {'F': [-6.447597686433486e-05, 6.0376194329907464e-05,
                            6.821902933606777e-05, 0.00011266214985175275,
                            -8.572827177446528e-05, -8.518295496243874e-05,
                            -2.8734681591905755e-05, -6.10199634523819e-05,
                            4.317140716821904e-06, -5.7335617761826644e-05,
                            -8.213073298304334e-05, 7.545067939710249e-05],
                       'kba': [-3.0163614410700237e-05, 2.940897094229546e-05,
                              2.8772630446903844e-05, 5.128678790083455e-05,
                              -3.9464603431033494e-05, -3.813224961958767e-05,
                              -1.2977274215529821e-05, -2.6306243441434463e-05,
                              5.392026400681456e-06, -2.4584909418642938e-05,
                              -3.6754609051960206e-05, 3.4308709548410726e-05],
                       'T2b': [1.4696802470691386e-05, -1.0339943231632967e-05,
                              -2.683156921851135e-05, -3.137606505421612e-05,
                              2.1458542433604883e-05, 2.4763587678702763e-05,
                              7.743259274600545e-06, 2.1398785798439045e-05,
                              1.0000138241152108e-05, 1.9652893926063412e-05,
                              2.4230920729512774e-05, -2.038258073974252e-05]},
              'grad0_max': {'F': 0.00011266214985175275,
                           'kba': 5.128678790083455e-05,
                           'T2b': 3.137606505421612e-05},
              'losses': [0.00020837397105142013, 0.00014640222868099145,
                        1.8790383758422048e-05, 3.001513447689706e-07,
                        5.367830464802762e-08, 1.2407832110917215e-08],
              'maps': {'F': [0.16284017345151905, 0.10253150870680305,
                           0.06802479562699212, 0.06518511122754891,
                           0.19070708878048265, 0.20557673777867427,
                           0.1558920022710023, 0.17708216194000923,
                           0.14583612269868804, 0.2106100286128142,
                           0.19074979860732622, 0.06510963247637294],
                      'kba': [22.21316701940129, 8.614129532345654,
                             19.662952047133782, 10.290167935219863,
                             22.44687004609265, 17.202191444537505,
                             13.312969824815035, 15.154318492184906,
                             8.566526758619947, 10.049020716039768,
                             19.285280999943037, 16.705919852895324],
                      'T2b': [1.1512350875145593e-05, 1.0491220128324018e-05,
                             1.3123351876220218e-05, 1.315425535044131e-05,
                             1.1746490054169508e-05, 1.1577326229596938e-05,
                             1.1687033809511165e-05, 1.0566209350566849e-05,
                             9.468551506568791e-06, 1.1955201997157558e-05,
                             1.111059424380593e-05, 1.0569595254154595e-05]}}
# The same script's ULP_RESPONSE: JAX's own losses and fitted maps move by
# this much (largest relative change) when the 600 steps run on the noisy
# data moved one ulp; phase 32b holds the port's at 100× it, as phase 26b.
# This fit contracts rounding instead of amplifying it (26b's grows ~1e9
# fold); a 0.1% change of the learning rate moves JAX's losses by 1.8e-3
# and its maps by 2.3e-4 (its LR_RESPONSE), far past these bars.
QMT_EX_ULP = {'losses': 5.868113371418988e-13, 'maps': 2.6454522646240966e-14}


def qmt_model(logp, flips, phis, route, tr=None):
    r"""examples/qmt_fit.py's model of the log maps ``logp`` (``F``,
    ``kba``, ``T2b``, each ``(nv,)``): the magnitude of the last TR's echo
    per voxel and (offset, power), ``(nv, 10)``, offsets outer; at QMT's tr,
    or over the train ``tr`` (``(nTR,)``) when given. ``route``
    ``'plain'``: ``epgx_mt_spgr`` per (offset, power) with the example's
    batched ``wt[:, None]`` (the router takes the plain route);
    ``'kernels'``: ``kernels.epgx.xmt_spgr`` once per power over the
    (offset, voxel) atoms, ``wt`` a constant train of π·ω1²·τ_sat and
    ``wscale = G(Δ, T2b)``."""
    from mrphy_tpu_torch.kernels import epgx as kx
    from mrphy_tpu_torch.ops import epg
    c = QMT
    F, kba, T2b = (torch.exp(logp[k]) for k in ('F', 'kba', 'T2b'))
    M0b, M0a = F, 1.0 - F
    kab = kba * M0b / M0a
    pool = dict(T1a=c['T1a'], T2a=c['T2a'], T1b=c['T1b'],
                tr=c['tr'] if tr is None else tr, K=c['K'])
    w1s = [2 * np.pi * w for w in c['w1rms']]
    if route == 'plain':
        outs = []
        for d in c['offs']:
            G = epg.mt_lineshape(d, T2b)
            for w1 in w1s:
                wt = np.pi * w1 ** 2 * G * c['tau']
                s = epg.epgx_mt_spgr(flips, phis, kab=kab, kba=kba,
                                     wt=wt[:, None], M0a=M0a, M0b=M0b,
                                     **pool)
                outs.append(torch.hypot(s[..., -1, 0], s[..., -1, 1]))
        return torch.stack(outs, -1)
    nO = len(c['offs'])
    offs = torch.as_tensor(c['offs'], dtype=F.dtype, device=F.device)
    G = epg.mt_lineshape(offs[:, None], T2b[None, :]).reshape(-1)
    atoms = dict(kab=kab.repeat(nO), kba=kba.repeat(nO), M0a=M0a.repeat(nO),
                 M0b=M0b.repeat(nO))
    outs = []
    for w1 in w1s:
        s = kx.xmt_spgr(flips, phis, wt=torch.full_like(
            flips, np.pi * w1 ** 2 * c['tau']), wscale=G, **atoms, **pool)
        outs.append(torch.hypot(s[:, -1, 0], s[:, -1, 1]).reshape(nO, -1))
    return torch.stack(outs, -1).permute(1, 0, 2).reshape(F.shape[0], -1)


def qmt_example(dev):
    r"""The QMT_EX problem in float64 on the card against GOLDEN_QMT: the
    noiseless data, the first loss and its gradient w.r.t. the log maps on
    both routes of :func:`qmt_model` (1e-10 of the largest datum, of the
    loss, of each gradient's largest), then the example's 600 Adam steps
    through the kernels' form (``xmt_fwd_chk`` + ``xmt_bwd`` per power and
    step): the losses along the fit and the fitted maps relative to each
    value, the median relative errors of the fitted maps against the truth
    and the launches it made. Returns the measurements; the bars are
    :func:`phase_qmt_example`'s."""
    from mrphy_tpu_torch.kernels import epgx as kx
    from mrphy_tpu_torch.ops import epg
    c, ex, gold = QMT, QMT_EX, GOLDEN_QMT
    f64 = dict(dtype=torch.float64, device=dev)
    nv, keys = ex['nv'], tuple(ex['start'])
    n0 = dict(kx.LAUNCHES)
    F, kba, T2b, rng = qmt_truth(nv)
    truth_n = dict(F=F, kba=kba, T2b=T2b)
    flips = torch.full((ex['ntr'],), np.deg2rad(c['flip']), **f64)
    phis = epg.rf_spoil_phases(ex['ntr'], **f64)
    truth = {k: torch.log(torch.as_tensor(truth_n[k], **f64)) for k in keys}
    with torch.no_grad():
        y0 = {r: qmt_model(truth, flips, phis, r)
              for r in ('kernels', 'plain')}
    sigma = ex['noise'] / 100 * float(y0['kernels'].max())
    y = y0['kernels'] + sigma * torch.as_tensor(
        rng.standard_normal(tuple(y0['kernels'].shape)), **f64)

    def start():
        return {k: torch.full((nv,), np.log(v), **f64).requires_grad_()
                for k, v in ex['start'].items()}

    def loss(logp, route):
        return torch.mean((qmt_model(logp, flips, phis, route) - y) ** 2)

    out = {}
    for r in ('kernels', 'plain'):
        logp = start()
        val = loss(logp, r)
        g = dict(zip(keys, torch.autograd.grad(val, list(logp.values()))))
        out[f'example_data_{r}'] = max_err(
            y0[r], torch.as_tensor(gold['data'], **f64)) / gold['data_max']
        out[f'example_loss0_{r}'] = abs(float(val.detach())
                                        - gold['loss0']) \
            / gold['loss0']
        out[f'example_grad0_{r}'] = max(
            max_err(g[k], torch.as_tensor(gold['grad0'][k], **f64))
            / gold['grad0_max'][k] for k in keys)
    logp = start()
    opt = torch.optim.Adam(list(logp.values()), lr=ex['lr'])
    losses = []
    for _ in range(ex['iters']):
        opt.zero_grad()
        val = loss(logp, 'kernels')
        val.backward()
        opt.step()
        losses.append(float(val.detach()))
    maps = {k: torch.exp(v.detach()).cpu().numpy() for k, v in logp.items()}
    med = {k: float(np.median(np.abs(maps[k] / truth_n[k] - 1)))
           for k in keys}

    def rel(a, b):
        a, b = np.asarray(a), np.asarray(b)
        return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))

    out.update(
        example_losses=rel([losses[i] for i in QMT_EX_LOSS_STEPS],
                           gold['losses']),
        example_maps=max(rel(maps[k], gold['maps'][k]) for k in keys),
        example_median_relerr=med,
        example_launches={k: kx.LAUNCHES[k] - n0[k] for k in XMT_KERNELS})
    return out


def phase_qmt_example(dev):
    r"""Phase 32b, in a launch window of its own after 32a's counts are
    read: :func:`qmt_example`, held to JAX at 1e-10 on the data, the first
    loss and its gradient, at 100× QMT_EX_ULP on the losses and maps, to
    the example's asserts (median relative error under 3% for F and T2b,
    under 15% for kba) and to its launches: exactly ``xmt_fwd`` 2 (the
    data) and ``xmt_fwd_chk``/``xmt_bwd`` 2 + 2·600. Returns the
    measurements."""
    t0 = time.perf_counter()
    out = qmt_example(dev)
    bars = dict(example_data_kernels=1e-10, example_data_plain=1e-10,
                example_loss0_kernels=1e-10, example_loss0_plain=1e-10,
                example_grad0_kernels=1e-10, example_grad0_plain=1e-10,
                example_losses=100 * QMT_EX_ULP['losses'],
                example_maps=100 * QMT_EX_ULP['maps'])
    med_bar = dict(F=0.03, kba=0.15, T2b=0.03)
    want = dict(xmt_fwd=2, xmt_fwd_chk=2 + 2 * QMT_EX['iters'],
                xmt_bwd=2 + 2 * QMT_EX['iters'])
    print('qMT example: ' + json.dumps(dict(
        measured=out, bars=dict(bars, example_median_relerr=med_bar,
                                example_launches=want))), flush=True)
    for key, bar in bars.items():
        check(out[key] <= bar, f'{key}: {out[key]} > {bar}')
    check(all(out['example_median_relerr'][k] < b for k, b in med_bar.items()),
          f"the example's asserts: {out['example_median_relerr']}")
    check(out['example_launches'] == want,
          f"qMT example launches {out['example_launches']} != {want}")
    print(f'phase 32b took {time.perf_counter() - t0:.1f} s', flush=True)
    return out


# ==========================================================================
# The EPG-X(MT) train over a variable-TR train: qMT fingerprinting (phases
# 33-34)
# ==========================================================================

# Phase 34b: examples/qmt_fit.py's pool and protocol (QMT; 12 voxels, 300
# TRs of 10° with rf-spoiled phases, 5 offsets × 2 powers, the noise at 0.1%
# of the largest datum) with its 30 ms TR replaced by the train tr_t = 30 ms
# + 5 ms·sin(2πt/37): the data, the first loss of the fit and its gradient
# w.r.t. the log maps and every element of the tr train, then 20 Adam steps
# (lr 0.05, from F 0.12, kba 15 /s, T2b 11 µs). The echoes of the 4 kHz,
# 700 Hz measurement are held at QMT_V_EX_ENTRIES (voxel, TR).
QMT_V_EX = dict(nv=12, ntr=300, iters=20, lr=0.05, noise=0.1, tr_amp=5e-3,
                tr_period=37.0, start=dict(F=0.12, kba=15.0, T2b=11e-6))
QMT_V_EX_ENTRIES = [(0, 0), (3, 37), (5, 101), (7, 150), (11, 299)]

# mrphy_tpu (JAX, XLA route on the CPU), float64, on the QMT_V_EX problem
# (tests/make_qmtv_goldens.py prints these): the echoes of the 4 kHz, 700 Hz
# measurement at QMT_V_EX_ENTRIES (re, im) and their largest |value|, the
# noiseless data of every voxel and measurement and its largest value, the
# first loss, its gradient w.r.t. the log maps and every element of the tr
# train with each one's largest magnitude, and the losses of the 20 steps.
GOLDEN_QMTV = {"echoes": [[0.0, -0.14553212920739073], [-0.0006625936027548311,
    -0.08202374696311193], [-0.00012617936452600774, -0.0270038191087922],
    [-0.0001832927167415887, -0.033391958606025354], [-0.0004107269963115932,
    -0.0638121294502617]], "echoes_max": 0.1631532013166606, "data":
    [[0.031435833454385984, 0.030315718652890976, 0.03338631569164834,
    0.030341163317058197, 0.040884745563765944, 0.031210309558937343,
    0.07187692207229765, 0.046975936188659105, 0.09765525035704277,
    0.09362875136076815], [0.06326372479754078, 0.0625599793461417,
    0.06434638050800381, 0.06257556065290691, 0.06818121255784715,
    0.06299207341477728, 0.08430207541379653, 0.07023235113642524,
    0.10186817880262482, 0.0980477291479322], [0.06059791349842605,
    0.059553548112025935, 0.0627549657926427, 0.059579643588352965,
    0.07136359442181633, 0.06084826181452147, 0.09590007320489023,
    0.08004397823263347, 0.10594217410317236, 0.10514796710770914],
    [0.07346324587064228, 0.07287063096080033, 0.07469481922876169,
    0.07288530066900833, 0.0798363207987883, 0.07359236296500474,
    0.09732325231455521, 0.08542306678061266, 0.10613993846096952,
    0.10538365575714301], [0.026800638638938383, 0.02579893183199831,
    0.02861820839247526, 0.025821926839227276, 0.03588957962902566,
    0.026666041164169492, 0.06794054013315431, 0.042519877803972025,
    0.09543347058618577, 0.09140335522554544], [0.027906672424243707,
    0.02702071046953269, 0.029490644198909576, 0.027040895961324876,
    0.035818820963621906, 0.027757047542369018, 0.06531207025998413,
    0.04143372169420249, 0.09386243615039752, 0.08930461896824242],
    [0.04074536529132078, 0.03989357647683229, 0.04229308831010256,
    0.03991313833205008, 0.04847150121657628, 0.04063338347418974,
    0.07533486402602631, 0.05408839876997748, 0.0981360613453385,
    0.09481404982150803], [0.03452967906075433, 0.033513841787463826,
    0.03610302882154798, 0.03353630903777159, 0.041754011309158304,
    0.03414087805506279, 0.06666116441404583, 0.04486075581620147,
    0.09541069269343425, 0.08905471205056337], [0.05145074932010596,
    0.050617036036905115, 0.05257222362774685, 0.05063542604743002,
    0.05624308433156111, 0.05100685664760036, 0.07216619248654056,
    0.05700414783840564, 0.09677455668586944, 0.08921510122564716],
    [0.03531128792759339, 0.03463786090906948, 0.03656631761545888,
    0.034653381978869045, 0.04177662493635331, 0.03524535896957607,
    0.06756507848670677, 0.04692970077072076, 0.09357191062417572,
    0.08965855130062816], [0.028697459507124774, 0.02767867795132949,
    0.030396996966504213, 0.027701493861957745, 0.03682727516516856,
    0.02841237479305554, 0.06555044218747531, 0.04148897796550145,
    0.09480605039665317, 0.0893935166709688], [0.06508391571017776,
    0.06378442005400974, 0.06694528437495106, 0.063813451259452,
    0.0728736272499571, 0.06452381459603558, 0.09150643397200495,
    0.07526392479513838, 0.10560880428366377, 0.10274945910503254]],
    "data_max": 0.10613993846096952, "loss0": 0.00020483826554126846, "grad0":
    {"F": [-6.354162791728153e-05, 5.9685642831805956e-05,
    6.683331375656428e-05, 0.00011094673623127034, -8.425924551886463e-05,
    -8.353834115475233e-05, -2.8065774236070905e-05, -5.986090446409172e-05,
    4.639159334287317e-06, -5.591333493723676e-05, -8.067191150945465e-05,
    7.395442448366903e-05], "T2b": [1.4544943214052201e-05,
    -1.026489348691595e-05, -2.6491056257909953e-05, -3.10241823150241e-05,
    2.119567439027437e-05, 2.4434897339454238e-05, 7.604249289779529e-06,
    2.116041440991813e-05, 9.865133603746625e-06, 1.9321097131630623e-05,
    2.3952912191021117e-05, -2.0091717909950042e-05], "kba":
    [-3.0130748437850047e-05, 2.9450110720460396e-05, 2.855987573696628e-05,
    5.11910080834409e-05, -3.9320200961864916e-05, -3.791231973439884e-05,
    -1.285444548592057e-05, -2.615536465640022e-05, 5.547540649480648e-06,
    -2.4310936026748707e-05, -3.6594184432656724e-05, 3.4085970017584814e-05],
    "tr": [3.841105174579935e-11, -2.6521455407192257e-11,
    1.1923658773063608e-11, 5.6161570530810147e-11, -1.3384271249979859e-11,
    3.063021882447493e-11, 8.720730648485083e-11, 5.010616376929755e-12,
    5.379300123270879e-11, 1.2477060168575248e-10, 2.9533309959195036e-11,
    8.27068869918378e-11, 1.687144895939652e-10, 6.106863543234876e-11,
    1.1691585883511722e-10, 2.1763626379822183e-10, 1.0014966015235327e-10,
    1.5489504896154133e-10, 2.681164276168401e-10, 1.4663815766250618e-10,
    1.9418109301270224e-10, 3.1582608388686095e-10, 2.0046414512481306e-10,
    2.3309163982742633e-10, 3.5856964582011355e-10, 2.6309455486617065e-10,
    2.726171765510147e-10, 3.986075775570256e-10, 3.3661708573935597e-10,
    3.1510687716623046e-10, 4.407481824156622e-10, 4.2095059902464793e-10,
    3.612171482008443e-10, 4.884697932487568e-10, 5.145692405349736e-10,
    4.104115391809132e-10, 5.438431273731896e-10, 6.182973361218754e-10,
    4.642009594508762e-10, 6.100183851638291e-10, 7.367574549564057e-10,
    5.268713717765256e-10, 6.916384619163997e-10, 8.770768156910145e-10,
    6.041165300814436e-10, 7.940569844889468e-10, 1.0473341072549482e-09,
    7.029924304251713e-10, 9.232231436222103e-10, 1.2548240056316159e-09,
    8.329481879337299e-10, 1.0847984565475226e-09, 1.5020803581469037e-09,
    1.004419472601961e-09, 1.2801125959041567e-09, 1.780464446789732e-09,
    1.2230335125726477e-09, 1.5006593308566578e-09, 2.0673310820218465e-09,
    1.4857220761931652e-09, 1.7297831789281996e-09, 2.336099151882243e-09,
    1.7884140938934559e-09, 1.956664378982196e-09, 2.5771331762689765e-09,
    2.136164490542037e-09, 2.1869069286856344e-09, 2.8073720237713975e-09,
    2.536259092457422e-09, 2.4316875568073014e-09, 3.0535941033241635e-09,
    2.988329415293882e-09, 2.6946287725242268e-09, 3.333761927903996e-09,
    3.49288929088458e-09, 2.9773112017061612e-09, 3.659657854451808e-09,
    4.0628944498951234e-09, 3.2875478498342206e-09, 4.045207152100383e-09,
    4.725192904763451e-09, 3.6400383295155315e-09, 4.510053894291111e-09,
    5.518539595042225e-09, 4.059694164495427e-09, 5.084792099922636e-09,
    6.492406372560982e-09, 4.594268969367092e-09, 5.8168284300616575e-09,
    7.697338656137767e-09, 5.3237343079150455e-09, 6.759957961403933e-09,
    9.150759751909297e-09, 6.334747172595518e-09, 7.930338426065466e-09,
    1.0785468915040793e-08, 7.655471004004248e-09, 9.257346101224622e-09,
    1.2439423605207925e-08, 9.23178287269381e-09, 1.0612267173748652e-08,
    1.3947393244630575e-08, 1.1009282745901506e-08, 1.192546726009397e-08,
    1.528175258236344e-08, 1.3001964465179145e-08, 1.3239095062375434e-08,
    1.6573857753052988e-08, 1.5244133191652153e-08, 1.4621069556826811e-08,
    1.79819927977875e-08, 1.7757604263947658e-08, 1.6104969648039098e-08,
    1.9604001031094677e-08, 2.0591000252026857e-08, 1.7712680281094013e-08,
    2.1498959447402273e-08, 2.3843877525459786e-08, 1.9471398199003784e-08,
    2.372320357678328e-08, 2.7668023396531355e-08, 2.1427852403423278e-08,
    2.6371193829326432e-08, 3.22851774814987e-08, 2.3719569626503964e-08,
    2.965163923186578e-08, 3.80152618436242e-08, 2.6718991011613973e-08,
    3.395229353982439e-08, 4.520923745638739e-08, 3.1088041425719954e-08,
    3.9709683487928556e-08, 5.3950455865656706e-08, 3.743182973563205e-08,
    4.69705108641126e-08, 6.367113447362211e-08, 4.5711440021859815e-08,
    5.50624795037956e-08, 7.322139809069088e-08, 5.5296048044093474e-08,
    6.305164629497915e-08, 8.168214543677656e-08, 6.577929345007358e-08,
    7.064218073992569e-08, 8.920601597804274e-08, 7.731634983151704e-08,
    7.825305566160349e-08, 9.677339376081751e-08, 9.021980497689025e-08,
    8.634164142500306e-08, 1.0526808287785966e-07, 1.0480320177304888e-07,
    9.512531595090034e-08, 1.1514770941235369e-07, 1.215018525736976e-07,
    1.0467966330662688e-07, 1.266258370454322e-07, 1.409139543449302e-07,
    1.1501377333019006e-07, 1.3989857838413606e-07, 1.6385762607758168e-07,
    1.262628069597717e-07, 1.5552732689377146e-07, 1.9166815726224683e-07,
    1.3943066184679847e-07, 1.7517042696292078e-07, 2.2657473250594314e-07,
    1.5768721536614827e-07, 2.0201957942936633e-07, 2.710230561677668e-07,
    1.8620458724132043e-07, 2.391189612545106e-07, 3.2504411162923435e-07,
    2.2823001739584132e-07, 2.855974686756649e-07, 3.839124325667335e-07,
    2.8134168949015456e-07, 3.357031188348798e-07, 4.402169841280168e-07,
    3.4056637441991554e-07, 3.84018166081233e-07, 4.901314044151356e-07,
    4.044027084051929e-07, 4.3056758346730087e-07, 5.368884022052929e-07,
    4.7496866547272686e-07, 4.788081380045729e-07, 5.867736286792123e-07,
    5.549674927496066e-07, 5.313431192641726e-07, 6.440699189203484e-07,
    6.469988957405124e-07, 5.890440322169558e-07, 7.10472188544538e-07,
    7.539292650279739e-07, 6.516921226764346e-07, 7.864050174115056e-07,
    8.789913536600331e-07, 7.185575898975911e-07, 8.72601594500167e-07,
    1.0266584187301362e-06, 7.903211207346481e-07, 9.73598828843987e-07,
    1.2061754499686325e-06, 8.763374606228107e-07, 1.1042394605686032e-06,
    1.4349908603514879e-06, 1.0048329174276542e-06, 1.2907403932466078e-06,
    1.730540363125253e-06, 1.21355312899819e-06, 1.5516606164940965e-06,
    2.0888365519956884e-06, 1.5142788063142126e-06, 1.872199088771035e-06,
    2.475379096855971e-06, 1.8809256213086967e-06, 2.2130011635819823e-06,
    2.85027095847157e-06, 2.287048467911095e-06, 2.551850909524992e-06,
    3.2067378439896694e-06, 2.7360957426331156e-06, 2.9012817505744143e-06,
    3.5754719417933722e-06, 3.2492082447756586e-06, 3.2844674813215563e-06,
    3.992021844517122e-06, 3.847781876256405e-06, 3.713970961885252e-06,
    4.474865584622218e-06, 4.550691561840194e-06, 4.190105282407901e-06,
    5.027152887656683e-06, 5.374910046816177e-06, 4.705117157208878e-06,
    5.645555846656861e-06, 6.336873725960328e-06, 5.249363896557062e-06,
    6.335437677280331e-06, 7.4675127009576605e-06, 5.834505140107462e-06,
    7.1502655483626605e-06, 8.858404447143857e-06, 6.574312395555107e-06,
    8.253918567989447e-06, 1.0688714181170027e-05, 7.757292736649092e-06,
    9.897050980144399e-06, 1.3123591463965137e-05, 9.688283080834538e-06,
    1.2219816691052223e-05, 1.6146691121069988e-05, 1.2414443952803488e-05,
    1.5106723043944432e-05, 1.9557996460126956e-05, 1.5773831137718707e-05,
    1.8350263568672085e-05, 2.3196899220758638e-05, 1.9702666006686906e-05,
    2.1921251075935513e-05, 2.7147282713265663e-05, 2.434539997512909e-05,
    2.597864038686308e-05, 3.166671994214775e-05, 2.9923921701719228e-05,
    3.067677047154777e-05, 3.695975301041365e-05, 3.662909842287691e-05,
    3.6044746464107014e-05, 4.306668004820393e-05, 4.458980026211267e-05,
    4.197726956661076e-05, 4.9895074537948156e-05, 5.388699377244294e-05,
    4.831280501283185e-05, 5.736055544491765e-05, 6.465756043537213e-05,
    5.4994754365866054e-05, 6.569712403856122e-05, 7.749705092973933e-05,
    6.253633461748724e-05, 7.612865511830628e-05, 9.423271811938363e-05,
    7.324317602769721e-05, 9.151704882981606e-05, 0.00011789534439909211,
    9.152809831354479e-05, 0.00011557250032257445, 0.00015080318833060277,
    0.00012085362981918041, 0.00014934999425333348, 0.0001923578061005019,
    0.00015774090926665003, 0.00018641834752714147, 0.00023381160255929906,
    0.00020147167603223084, 0.00022392106828874152, 0.00022145839228548958,
    0.0]}, "grad0_max": {"F": 0.00011094673623127034, "T2b":
    3.10241823150241e-05, "kba": 5.11910080834409e-05, "tr":
    0.00023381160255929906}, "losses": [0.00020483826554126846,
    0.00014370968200976263, 9.624192217755971e-05, 6.181487805002513e-05,
    3.905158517354976e-05, 2.5762129043247914e-05, 1.9333407212252687e-05,
    1.723016821864942e-05, 1.7327213866684574e-05, 1.804941412311984e-05,
    1.8406879065750933e-05, 1.795676161181085e-05, 1.6655325842803154e-05,
    1.4702614520597126e-05, 1.2437336241373702e-05, 1.0252104595200664e-05,
    8.480783726214836e-06, 7.304216374412835e-06, 6.733956704563564e-06,
    6.661426963790957e-06]}
# The same script's ULP_RESPONSE: JAX's own 20 losses move by at most
# 8.581110077173081e-15 (relative) when the steps run on the noisy data moved
# one ulp. The steps are held at 1e-9 relative, far above 100× that.
QMT_V_EX_LOSS_BAR = 1e-9


def qmtv_trs(ntr):
    r"""QMT_V_EX's tr train (numpy, s): QMT's tr + tr_amp·sin(2πt/period)."""
    t = np.arange(ntr)
    return QMT['tr'] + QMT_V_EX['tr_amp'] * np.sin(
        2 * np.pi * t / QMT_V_EX['tr_period'])


# Phase 34a, the qMT fingerprinting path: QMT_DICT's dictionary, probes,
# refinement and protocol gradient (phase 32a's path) over a variable-TR
# train tr_t = 12 ms + 6 ms·u_t, u_t from numpy default_rng(0).random(400)
# (bench_mrf's variable-TR rule, benchmarks/suite.py:603-605), the gradient
# w.r.t. that train among the protocol's. QMT_DICT's bars hold there: on
# the CPU, an 8 F × 32 × 32 cut of the grid (its lowest F) over this train
# matched 4000 probes within one grid step at 1.0 in F, 0.957 in kba, 0.096
# in T2b, and 50 Adam steps took 64 of them from 0, 0, 0.193 to 0.025,
# 0.032, 0.191 in F, kba, T2b (keys here would override QMT_DICT's).
QMT_V = dict(tr0=12e-3, tr_span=6e-3)
XMT_V_KERNELS = ('xmt_v_fwd', 'xmt_v_fwd_chk', 'xmt_v_bwd')
# The variable-TR kernels' cases (phase 33): label, atoms, TRs, K (None:
# the default nTR·|kshift| + 1), dtype, xmt_case keywords (``const``: a
# constant 30 ms train, also against the scalar-tr kernels at tr 30 ms),
# the chunk (None: the adjoint's own, kernels/epg.adjoint_tc at 8
# planes), timed. Every case runs over QMT_V's train (its first nTR TRs).
XMT_V_CASES = (
    ('qMT fingerprinting dictionary 65,536 x 400, K 48, tr train '
     '(phase 34a)', 65536, 400, 48, torch.float32, dict(qmt=True), None,
     True),
    ("qMT refinement's shape 4096 x 400, K 48, tr train, one chunk "
     '(tc = nTR)', 4096, 400, 48, torch.float32, {}, 400, False),
    ('16k x 200, K 32, b1', 16384, 200, 32, torch.float32, dict(b1=True),
     None, False),
    ('16k x 200, K 32, kshift -1', 16384, 200, 32, torch.float32,
     dict(kshift=-1), None, False),
    ('16k x 200, K 32, no detailed balance (kab 8, kba 3, M0b 0.4)', 16384,
     200, 32, torch.float32, dict(ndb=True), None, False),
    ('16k x 200, K 32, wt = 0 and no exchange (= spgr_fwd at te 0)', 16384,
     200, 32, torch.float32, dict(decoupled=True), None, False),
    ('16k x 200, K 32, constant 30 ms train (= xmt_fwd, xmt_fwd_chk, '
     'xmt_bwd at tr 30 ms)', 16384, 200, 32, torch.float32,
     dict(const=True), None, False),
    ('1024 x 400, default K 401 (device-memory state)', 1024, 400, None,
     torch.float32, {}, None, False),
    ('ragged 1001 x 201, K 32, b1 (three chunks of 67)', 1001, 201, 32,
     torch.float32, dict(b1=True), 67, False),
    ('f64 8192 x 200, K 32, b1, wscale', 8192, 200, 32, torch.float64,
     dict(b1=True), None, False),
)


def qmtv_dict_trs(nTR, dtype, dev):
    r"""QMT_V's fingerprinting train over its first ``nTR`` TRs, ``(nTR,)``
    (s)."""
    u = np.random.default_rng(0).random(QMT_DICT['ntr'])[:nTR]
    return torch.as_tensor(QMT_V['tr0'] + QMT_V['tr_span'] * u, dtype=dtype,
                           device=dev)


def phase_xmt_v_kernels(dev):
    r"""Phase 33: ``xmt_v_fwd``, ``xmt_v_fwd_chk`` and ``xmt_v_bwd`` against
    their plain versions on XMT_V_CASES, on the arguments ``xmt_spgr``
    gives them over a ``(nTR,)`` tr train (``ops.epg._xmt_rows``: ``coef``
    with the wt train, ``pk`` = [M0a, M0b, b1, wscale] and the per-TR planes
    ``pkt``); the adjoint fed the kernel's checkpoints and a cotangent drawn
    from a seed, the plain adjoint written out, with no autograd graph. The
    fingerprinting dictionary of phase 34a is timed with its bound.
    Per-atom outputs (echoes, checkpoints, ``dpk`` and ``dpkt`` per atom and
    TR) at EPG_BAR of their largest value (bit for bit expected; the rows
    that differ named), the per-TR rows at XMT_ROW_BAR; the case with wt ≡ 0
    and no exchange also against ``spgr_fwd`` over the same train at
    EPG_ROW_BAR; a constant train against the scalar-tr kernels (echoes,
    checkpoints, ``dcoef``, ``dpk``'s last four rows and ``dpkt`` summed
    over the train, newest TR first, against ``dpk``'s first seven) at
    XMT_ROW_BAR (bit for bit expected). Returns each kernel's rows."""
    from mrphy_tpu_torch.kernels import epgx as kx
    from mrphy_tpu_torch.kernels.epg import adjoint_tc, launch_cfg
    from mrphy_tpu_torch.ops import epg
    t0 = time.perf_counter()
    rows = {name: [] for name in XMT_V_KERNELS}
    const = {}
    for seed, (label, nA, nTR, K, dtype, kw, tc, timed) in enumerate(
            XMT_V_CASES, 330):
        kw = dict(kw)
        is_const = kw.pop('const', False)
        ckw = xmt_case(nA, nTR, K, dtype, dev, seed=seed, **kw)
        fixed = xmt_args(ckw) if is_const else None   # at tr 30 ms
        ckw['tr'] = (torch.full((nTR,), QMT['tr'], dtype=dtype, device=dev)
                     if is_const else qmtv_dict_trs(nTR, dtype, dev))
        coef, (pk, pkt), cfg = xmt_args(ckw)
        tc = tc or adjoint_tc(nTR, cfg.K, nA, pk.element_size(),
                              kx.PLANES_MT)
        adj_route = adjoint_meta(cfg.K, pk, kx.PLANES_MT, tc)
        chk = kx.xmt_v_fwd_chk(coef, pk, pkt, cfg, tc=tc)[1]
        g = cotangent(torch.empty((nA, nTR, 2), dtype=dtype, device=dev),
                      seed)
        runs = {
            'xmt_v_fwd': (lambda: kx.xmt_v_fwd(coef, pk, pkt, cfg),
                          lambda: kx.xmt_v_fwd_torch(coef, pk, pkt, cfg),
                          (coef, pk, pkt)),
            'xmt_v_fwd_chk': (
                lambda: kx.xmt_v_fwd_chk(coef, pk, pkt, cfg, tc=tc),
                lambda: kx.xmt_v_fwd_chk_torch(coef, pk, pkt, cfg, tc=tc),
                (coef, pk, pkt)),
            'xmt_v_bwd': (
                lambda: kx.xmt_v_bwd(coef, pk, pkt, cfg, chk, g, tc=tc),
                lambda: kx.xmt_v_bwd_torch(coef, pk, pkt, cfg, chk, g,
                                           tc=tc),
                (coef, pk, pkt, chk, g))}
        names = {'xmt_v_fwd': ('sig',), 'xmt_v_fwd_chk': ('sig', 'chk'),
                 'xmt_v_bwd': ('dcoef', 'dpar', 'dpkt')}
        for name, (run_kernel, run_plain, inputs) in runs.items():
            meta = dict(case=label, nA=nA, nTR=nTR, K=cfg.K,
                        kshift=cfg.kshift, tc=tc, b1=cfg.has_b1,
                        threads_state=launch_cfg(cfg.K, pk.element_size(),
                                                 kx.PLANES_MT))
            if name == 'xmt_v_bwd':
                meta['adjoint'] = adj_route
            rows[name].append(compare_epg(
                name, run_kernel, run_plain, inputs, names[name], meta,
                dtype, timed, XMT_ROW_BAR))
            if name == 'xmt_v_bwd' and adj_route['route'] == 'lanes':
                thread_check(rows[name][-1], name, run_kernel, kx,
                             'adjoint_cfg', names[name], dtype)
        if kw.get('decoupled'):
            # pool a alone: the single-pool SPGR train at te 0, same train
            sig = kx.xmt_v_fwd(coef, pk, pkt, cfg)
            ref = epg.epg_spgr(ckw['flips'], ckw['phis'], T1=QMT['T1a'],
                               T2=QMT['T2a'], M0=ckw['M0a'], tr=ckw['tr'],
                               te=0.0, K=cfg.K)
            err = row_err(sig, ref)
            print(f'xmt_v_fwd {label} vs spgr_fwd: ' + json.dumps(dict(
                err=err, bar=EPG_ROW_BAR[dtype])), flush=True)
            check(err <= EPG_ROW_BAR[dtype],
                  f'xmt_v_fwd {label} vs spgr_fwd: {err}')
        if fixed is not None:
            # a constant train: the scalar-tr kernels at the same tr
            f_coef, f_pk, f_cfg = fixed
            sig, chk_v = kx.xmt_v_fwd_chk(coef, pk, pkt, cfg, tc=tc)
            sig0, chk0 = kx.xmt_fwd_chk(f_coef, f_pk, f_cfg, tc=tc)
            dcoef, dpk, dpkt = kx.xmt_v_bwd(coef, pk, pkt, cfg, chk_v, g,
                                            tc=tc)
            dcoef0, dpk0 = kx.xmt_bwd(f_coef, f_pk, f_cfg, chk0, g, tc=tc)
            # dpkt summed over the train newest first, as xmt_bwd
            # accumulates its entry gradients
            acc = torch.zeros_like(dpkt[0])
            for t in reversed(range(nTR)):
                acc = acc + dpkt[t]
            errs = dict(sig=row_err(sig, sig0), chk=row_err(chk_v, chk0),
                        dcoef=row_err(dcoef, dcoef0),
                        dpk=row_err(dpk, dpk0[7:]),
                        dpkt_sum=row_err(acc, dpk0[:7]))
            const = dict(case=label, echoes_bit_identical=torch.equal(
                sig, sig0), err=errs, bar=XMT_ROW_BAR[dtype])
            print('xmt_v_* constant train vs xmt_*: ' + json.dumps(const),
                  flush=True)
            for k, e in errs.items():
                check(e <= XMT_ROW_BAR[dtype],
                      f'constant train vs xmt_* {k}: {e}')
            del sig, sig0, chk_v, chk0, dcoef, dcoef0, dpk, dpk0, dpkt, acc
        del coef, pk, pkt, chk, g, ckw, fixed
    check(bool(const), 'no constant-train case ran')
    print(f'phase 33 took {time.perf_counter() - t0:.1f} s', flush=True)
    return rows


def phase_qmtv_parts(dev, dict_ms):
    r"""Phase 34c, after phase 34a's launch counts are read: that path's
    dictionary (``dict_ms``, through ``xmt_spgr``) split into its parts,
    timed apart: the kernels' arguments (``ops.epg._xmt_rows``, the
    lineshape and the rows), among them the per-TR planes
    (``ops.epg._mt_step_entries``), and ``xmt_v_fwd`` alone; and the memory
    the planes keep for the backward under a gradient, built as the path
    builds them (under ``torch.utils.checkpoint``) and without it."""
    from mrphy_tpu_torch.kernels import epgx as kx
    from mrphy_tpu_torch.ops import epg
    c = QMT_DICT
    flips, phis, wt = qmt_train(c['ntr'], torch.float32, dev)
    trs = qmtv_dict_trs(c['ntr'], torch.float32, dev)
    F, kba, T2b = qmt_grid(torch.float32, dev)[1]

    def kw():
        return dict(qmt_kw(F, kba, T2b), tr=trs)

    def rates(kw):
        return [torch.broadcast_to(torch.as_tensor(
            kw[n], dtype=torch.float32, device=dev), F.shape)
            for n in ('T1a', 'T2a', 'T1b', 'kab', 'kba', 'M0a', 'M0b')]

    with torch.no_grad():
        coef, (pk, pkt), cfg, _ = epg._xmt_rows(flips, phis, wt=wt, **kw())
        r = rates(kw())
        rows_ms = time_ms(lambda: epg._xmt_rows(flips, phis, wt=wt, **kw()),
                          reps=3)
        planes_ms = time_ms(lambda: epg._mt_step_entries(*r, trs), reps=3)
        kernel_ms = time_ms(lambda: kx.xmt_v_fwd(coef, pk, pkt, cfg),
                            reps=3)
    del coef, pk, pkt, r
    # the memory kept for the backward by the planes: allocated after their
    # construction under a gradient of the rates and the train, the planes
    # themselves included
    kept = {}
    for how in ('checkpoint', 'autograd'):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        xs = [x.detach().clone().requires_grad_() for x in rates(kw())]
        tr_ = trs.detach().clone().requires_grad_()
        base += sum(x.numel() * x.element_size() for x in xs + [tr_])
        if how == 'checkpoint':
            out = torch.utils.checkpoint.checkpoint(
                epg._mt_step_entries, *xs, tr_, use_reentrant=False)
        else:
            out = epg._mt_step_entries(*xs, tr_)
        torch.cuda.synchronize()
        kept[how] = (torch.cuda.memory_allocated(dev) - base) / 1e9
        del out, xs, tr_
    res = dict(dict_ms=dict_ms, rows_ms=rows_ms, planes_ms=planes_ms,
               kernel_ms=kernel_ms, rows_share=rows_ms / dict_ms,
               planes_share=planes_ms / dict_ms,
               kernel_share=kernel_ms / dict_ms,
               planes_kept_gb_checkpoint=kept['checkpoint'],
               planes_kept_gb_autograd=kept['autograd'])
    print("qMT fingerprinting path, the dictionary's parts: "
          + json.dumps(res), flush=True)
    return res


def qmtv_example(dev):
    r"""The QMT_V_EX problem in float64 on the card against GOLDEN_QMTV,
    through the kernels' rank-1 form of :func:`qmt_model` over the tr train
    (``xmt_v_fwd``; under a gradient ``xmt_v_fwd_chk`` + ``xmt_v_bwd``):
    the echoes of the 4 kHz, 700 Hz measurement at QMT_V_EX_ENTRIES, the
    noiseless data, the first loss and its gradient w.r.t. the log maps and
    every element of the tr train (relative to the largest of each), then
    20 Adam steps' losses (relative to each) and the launches made. Returns
    the measurements; the bars are :func:`phase_qmtv_example`'s."""
    from mrphy_tpu_torch.kernels import epgx as kx
    from mrphy_tpu_torch.ops import epg
    c, ex, gold = QMT, QMT_V_EX, GOLDEN_QMTV
    f64 = dict(dtype=torch.float64, device=dev)
    nv, keys = ex['nv'], tuple(ex['start'])
    n0 = dict(kx.LAUNCHES)
    F, kba, T2b, rng = qmt_truth(nv)
    flips = torch.full((ex['ntr'],), np.deg2rad(c['flip']), **f64)
    phis = epg.rf_spoil_phases(ex['ntr'], **f64)
    trs = torch.as_tensor(qmtv_trs(ex['ntr']), **f64)
    truth = {k: torch.log(torch.as_tensor(v, **f64))
             for k, v in zip(keys, (F, kba, T2b))}
    out = {}
    with torch.no_grad():
        y0 = qmt_model(truth, flips, phis, 'kernels', tr=trs)
        # the 4 kHz, 700 Hz measurement's echoes (atoms offset-major)
        Ft, kt, tt = (torch.exp(truth[k]) for k in keys)
        s = kx.xmt_spgr(flips, phis, wt=torch.full_like(
            flips, np.pi * (2 * np.pi * c['w1rms'][1]) ** 2 * c['tau']),
            wscale=epg.mt_lineshape(torch.as_tensor(c['offs'][1], **f64),
                                    tt), T1a=c['T1a'],
            T2a=c['T2a'], T1b=c['T1b'], kab=kt * Ft / (1 - Ft), kba=kt,
            tr=trs, M0a=1 - Ft, M0b=Ft, K=c['K'])
    ent = torch.stack([s[v, t] for v, t in QMT_V_EX_ENTRIES])
    out['example_echoes'] = max_err(
        ent, torch.as_tensor(gold['echoes'], **f64)) / gold['echoes_max']
    out['example_data'] = max_err(
        y0, torch.as_tensor(gold['data'], **f64)) / gold['data_max']
    sigma = ex['noise'] / 100 * float(y0.max())
    y = y0 + sigma * torch.as_tensor(rng.standard_normal(tuple(y0.shape)),
                                     **f64)

    def start():
        return {k: torch.full((nv,), np.log(v), **f64).requires_grad_()
                for k, v in ex['start'].items()}

    def loss(logp, tr):
        return torch.mean((qmt_model(logp, flips, phis, 'kernels', tr=tr)
                           - y) ** 2)

    logp, tr_ = start(), trs.clone().requires_grad_()
    val = loss(logp, tr_)
    g = dict(zip(keys + ('tr',), torch.autograd.grad(
        val, list(logp.values()) + [tr_])))
    out['example_loss0'] = abs(float(val.detach()) - gold['loss0']) \
        / gold['loss0']
    out['example_grad0'] = {k: max_err(g[k], torch.as_tensor(
        gold['grad0'][k], **f64)) / gold['grad0_max'][k] for k in g}
    logp = start()
    opt = torch.optim.Adam(list(logp.values()), lr=ex['lr'])
    losses = []
    for _ in range(ex['iters']):
        opt.zero_grad()
        val = loss(logp, trs)
        val.backward()
        opt.step()
        losses.append(float(val.detach()))
    out['example_losses'] = max(abs(a - b) / abs(b)
                                for a, b in zip(losses, gold['losses']))
    out['example_launches'] = {k: kx.LAUNCHES[k] - n0[k]
                               for k in XMT_KERNELS + XMT_V_KERNELS}
    return out


def phase_qmtv_example(dev):
    r"""Phase 34b, in a launch window of its own after 34a's counts are
    read: :func:`qmtv_example`, held to JAX at 1e-10 on the echoes, the
    data, the first loss and its gradient (the tr train's among them), at
    QMT_V_EX_LOSS_BAR on the 20 steps' losses, and to its launches: exactly
    ``xmt_v_fwd`` 3 (the data per power, the echoes) and
    ``xmt_v_fwd_chk``/``xmt_v_bwd`` 2 + 2·20, and no scalar-tr kernel.
    Returns the measurements."""
    t0 = time.perf_counter()
    out = qmtv_example(dev)
    bars = dict(example_echoes=1e-10, example_data=1e-10,
                example_loss0=1e-10, example_grad0=1e-10,
                example_losses=QMT_V_EX_LOSS_BAR)
    want = dict(dict.fromkeys(XMT_KERNELS, 0), xmt_v_fwd=3,
                xmt_v_fwd_chk=2 + 2 * QMT_V_EX['iters'],
                xmt_v_bwd=2 + 2 * QMT_V_EX['iters'])
    print('qMT example over a tr train: ' + json.dumps(dict(
        measured=out, bars=dict(bars, example_launches=want))), flush=True)
    for key, bar in bars.items():
        v = out[key]
        worst = max(v.values()) if isinstance(v, dict) else v
        check(worst <= bar, f'{key}: {v} > {bar}')
    check(out['example_launches'] == want,
          f"qMT example (variable TR) launches {out['example_launches']} "
          f'!= {want}')
    print(f'phase 34b took {time.perf_counter() - t0:.1f} s', flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False',
              file=sys.stderr)
        return 1
    from mrphy_tpu_torch.kernels import _build, bloch
    from mrphy_tpu_torch.kernels import epg as kepg
    from mrphy_tpu_torch.kernels import epgx as kx
    from mrphy_tpu_torch.kernels import mc as kmc
    from mrphy_tpu_torch.kernels import mrf as kmrf
    from mrphy_tpu_torch.kernels import nufft as knf
    from mrphy_tpu_torch.kernels import signal as ksig
    from mrphy_tpu_torch.kernels import ssfp as kssfp

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
    sig_rows = phase_signal_kernels(dev)
    phase_sincos_accuracy(dev)
    nufft_rows = phase_nufft_kernels(dev)
    epg_rows = phase_epg_kernels(dev)
    match_rows = phase_match_kernel(dev)
    cpmg_rows = phase_cpmg_kernels(dev)
    xspgr_rows = phase_xspgr_kernels(dev)
    xspgr_v_rows = phase_xspgr_v_kernels(dev)
    xcpmg_rows = phase_xcpmg_kernels(dev)
    xcpmg_v_rows = phase_xcpmg_kernels(dev, varesp=True)
    bssfp_rows = phase_bssfp_kernels(dev)
    xmt_rows = phase_xmt_kernels(dev)
    xmt_v_rows = phase_xmt_v_kernels(dev)

    # the forward path, the gradient and design path, the two-pool path,
    # the acquisition path, the gridding path, the MRF path, the T2-mapping
    # path, the exchange-MRF paths at a scalar tr and over a variable-TR
    # train, the myelin-water paths at a scalar esp and over an esp train,
    # the balanced-SSFP path and the qMT paths at a scalar tr and over a
    # fingerprinting tr train: each with the launch counts zeroed just
    # before it and read just after
    counters = {**{k: bloch.LAUNCHES for k in bloch.LAUNCHES},
                **{k: kmc.LAUNCHES for k in kmc.LAUNCHES},
                **{k: ksig.LAUNCHES for k in ksig.LAUNCHES},
                **{k: knf.LAUNCHES for k in knf.LAUNCHES},
                **{k: kepg.LAUNCHES for k in kepg.LAUNCHES},
                **{k: kx.LAUNCHES for k in kx.LAUNCHES},
                **{k: kssfp.LAUNCHES for k in kssfp.LAUNCHES},
                **{k: kmrf.LAUNCHES for k in kmrf.LAUNCHES}}
    launches = {k: 0 for k in counters}
    results = {}

    def counted(path, run, needs):
        for k, table in counters.items():
            table[k] = 0
        results[path] = run(dev)
        counts = {k: table[k] for k, table in counters.items()}
        print(f'launches on the {path} path: {json.dumps(counts)}',
              flush=True)
        for k in needs:
            check(counts[k] > 0, f'kernel {k} was not launched on the '
                  f'{path} path')
        return counts

    for path, run, needs in (
            ('forward', phase_main_path, ('rfgr_fwd', 'beff_fwd')),
            ('gradient+design', lambda d: (phase_gradients(d),
                                           phase_design(d)),
             tuple(bloch.LAUNCHES)),
            ('two-pool', phase_mc_path, tuple(kmc.LAUNCHES)),
            ('acquisition', phase_signal_path,
             tuple(ksig.LAUNCHES) + ('rfgr_fwd',)),
            ('gridding', phase_nufft_path, tuple(knf.LAUNCHES)),
            ('mrf', phase_mrf_path, EPG_KERNELS + tuple(kmrf.LAUNCHES)),
            ('T2-mapping', phase_t2map_path, CPMG_KERNELS),
            ('exchange-MRF', phase_mrfx_path,
             XSPGR_KERNELS + tuple(kmrf.LAUNCHES)),
            ('exchange-MRF (variable TR)', phase_mrfx_v_path,
             XSPGR_V_KERNELS + tuple(kmrf.LAUNCHES)),
            ('myelin-water', phase_mwf_path, XCPMG_KERNELS),
            ('myelin-water (variable esp)', phase_mwf_v_path,
             XCPMG_V_KERNELS),
            ('balanced-SSFP', phase_bssfp_path, BSSFP_KERNELS),
            ('qMT', phase_qmt_path, XMT_KERNELS + tuple(kmrf.LAUNCHES)),
            ('qMT (variable TR)', lambda d: phase_qmt_path(d, vartr=True),
             XMT_V_KERNELS + tuple(kmrf.LAUNCHES))):
        for k, n in counted(path, run, needs).items():
            launches[k] += n
    # phases 30b-c, the float64 examples of the balanced-SSFP family, in
    # a window of their own whose counts stay out of the kernels line
    counted('balanced-SSFP examples', phase_bssfp_examples,
            BSSFP_KERNELS + tuple(kmrf.LAUNCHES))
    # phase 32b, examples/qmt_fit.py in float64, likewise in a window of
    # its own
    counted('qMT example', phase_qmt_example, XMT_KERNELS)
    # phase 34b, the same over a tr train, likewise
    counted('qMT example (variable TR)', phase_qmtv_example, XMT_V_KERNELS)
    # outside every counted window: phase 28's, 30a's and 34a's forwards,
    # split into their parts
    phase_mwf_v_parts(dev, results['myelin-water (variable esp)']['fwd_ms'])
    phase_bssfp_parts(dev, results['balanced-SSFP']['fwd_ms'])
    phase_qmtv_parts(dev, results['qMT (variable TR)']['dict_ms'])

    kernels = []
    for name, rows in (('rfgr_fwd', rfgr_rows), ('beff_fwd', beff_rows),
                       ('rfgr_bwd', rfgr_bwd_rows),
                       ('beff_bwd', beff_bwd_rows),
                       ('mc_fwd', mc_fwd_rows), ('mc_bwd', mc_bwd_rows),
                       ('sig_fwd', sig_rows['sig_fwd']),
                       ('sig_vjp', sig_rows['sig_vjp']),
                       ('sig_adj', sig_rows['sig_adj']),
                       *nufft_rows.items(), *epg_rows.items(),
                       ('match', match_rows), *cpmg_rows.items(),
                       *xspgr_rows.items(), *xspgr_v_rows.items(),
                       *xcpmg_rows.items(), *xcpmg_v_rows.items(),
                       *bssfp_rows.items(), *xmt_rows.items(),
                       *xmt_v_rows.items()):
        # the first timed case: float32 at the main path's shape
        head = next(r for r in rows if 'ms' in r)
        err = ('max_abs_err_chk' if name in ('rfgr_fwd', 'beff_fwd', 'mc_fwd')
               else 'max_abs_err')
        f32 = [r for r in rows if r['dtype'] == 'float32']
        kernels.append(dict(
            name=name, route='cuda', **KERNELS[name],
            launches=launches[name],
            max_abs_err=max(r[err] for r in f32),
            ms=head['ms'], plain_ms=head['plain_ms'],
            bound_ms=head['bound_ms'], bound_by=head['bound_by'],
            # no single PyTorch call computes a Bloch simulation, the
            # off-resonance- and decay-weighted non-uniform encoding, the
            # trajectory cotangent of the interpolation, an EPG train or a
            # bSSFP train;
            # the NUFFT's sample and spread are one sparse product each,
            # the matched filter one matrix product per probe chunk
            library_ms=head.get('library_ms')))
        if name in ('rfgr_bwd', 'mc_bwd', 'spgr_bwd', 'cpmg_bwd',
                    'xspgr_bwd', 'xspgr_v_bwd', 'xcpmg_bwd', 'xcpmg_v_bwd',
                    'bssfp_bwd', 'xmt_bwd', 'xmt_v_bwd'):
            # the rows: max|Δ| / max|row|
            kernels[-1]['max_row_rel_err'] = max(
                r['max_row_rel_err'] for r in f32)
        if name.startswith(('sig', 'nufft', 'spgr', 'cpmg', 'xspgr',
                            'xcpmg', 'bssfp', 'xmt')) or \
                name == 'match':
            # the linear outputs: max|Δ| / max|plain|
            kernels[-1]['max_rel_err'] = max(r['max_rel_err'] for r in f32)
        if name == 'match':
            # argmax flips between near-tied atoms, all runs
            kernels[-1]['flips'] = sum(r['flips'] for r in rows)
        if name.startswith('nufft'):
            # the gather's 32-byte-sector traffic over HBM_BPS, beside the
            # bound's inputs-once bytes
            kernels[-1]['sector_ms'] = head['sector_ms']
        if name in ('sig_fwd', 'sig_adj'):
            # the bound with the coil sums at F32_OPS, beside the tensor
            # cores' one
            kernels[-1]['cuda_core_bound_ms'] = head['cuda_core_bound_ms']
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
