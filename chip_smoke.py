#!/usr/bin/env python3
r"""Drive the PyTorch/CUDA port (``mrphy_tpu_torch``) once on one NVIDIA GPU.

Usage: ``python3 chip_smoke.py`` from the root of a checkout (one card).

Phases, each of which raises on failure (no fallback, nothing caught):

1. The card and toolchain (``nvidia-smi`` name and power limit, torch and
   CUDA versions, ``nvcc``), then the kernel build from the checkout's
   ``mrphy_tpu_torch/kernels/csrc`` sources.
2. ``rfgr_fwd`` against its plain PyTorch version on the card, on the
   arguments ``sims.blochsim_rfgr`` gives it: 1,048,576 spins × 1000 steps
   with relaxation, Δf and single-coil B1 in float32; a 2-coil B1 case and
   a flow (``vel``) case at 65,536 spins; the float64 instance at 262,144
   spins. Max |Δ| of the final state and of all chunk-end states, and the
   times of both (CUDA events, one warm-up, median of 5).
3. ``beff_fwd`` against its plain version on a 64³ cube (262,144 spins) ×
   1000 steps: float32, bfloat16-stored Beff (both sides fed the same
   bf16 values) and float64.
4. The main path through the user's entry points: ``Examples.spincube()``
   ``.to(device='cuda').applypulse(Examples.pulse(), doEmbed=True)``
   against the JAX package's results (literals below: float64 at 1e-10,
   float32 within the cross-engine bound of :func:`route_bar`), then a 64³
   ``SpinCube`` (FOV 24 cm, Δf map, T1/T2) with a 1000-step pulse through
   ``doFuse=True`` (``rfgr_fwd``) and ``doFuse=False`` (``rfgr2beff`` →
   ``beff_fwd``), which must agree (float64 at 1e-10, float32 within
   :func:`route_bar`). Launch counts are zeroed right before this phase
   and every kernel must have launched in it.

The line before the last is one JSON object with each kernel's launches,
error and times; the last line is the contract line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

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
EPS32 = 2.0 ** -23


def route_bar(nT: int, phi_max: float) -> float:
    r"""Bar between two float32 runs that round the field differently
    (JAX vs this port; the fused engine's pre-scaled γ2πdt·loc vs
    ``rfgr2beff``'s Gauss): a fixed relative rounding of a spin's field
    is a coherent phase error of up to nT·φmax·ε per run."""
    return 2 * nT * phi_max * EPS32


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

KERNELS = {
    'rfgr_fwd': dict(source='mrphy_tpu_torch/kernels/csrc/rfgr_fwd.cu',
                     replaces='mrphy_tpu/ops/pallas_kernels.py:547'),
    'beff_fwd': dict(source='mrphy_tpu_torch/kernels/csrc/beff_fwd.cu',
                     replaces='mrphy_tpu/ops/pallas_kernels.py:928'),
}


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


def phase_rfgr(dev):
    from mrphy_tpu_torch.kernels import bloch
    from mrphy_tpu_torch.ops import sims
    rows = []
    for label, nS, dtype, kw, timed in (
            ('1M x 1000, relax+df+b1', 1 << 20, torch.float32, {}, True),
            ('64k x 1000, 2-coil b1', 1 << 16, torch.float32, dict(nC=2),
             False),
            ('64k x 1000, vel', 1 << 16, torch.float32, dict(vel=True),
             False),
            ('256k x 1000, relax+df+b1', 1 << 18, torch.float64, {}, True)):
        pos, kws = rfgr_case(nS, 1000, dtype, dev, **kw)
        args = sims.rfgr_planes(*pos, **kws)
        rows.append(compare('rfgr_fwd', lambda: bloch.rfgr_fwd(*args),
                            lambda: bloch.rfgr_fwd_torch(*args), dtype,
                            label, timed))
        del args
    return rows


def cube64(dtype, dev):
    r"""A 64³ cube, FOV 24 cm, gray-matter T1/T2, a linear Δf map of
    ±100 Hz, and the 1000-step bench pulse."""
    from mrphy_tpu_torch.models.mobjs import Pulse, SpinCube
    cube = SpinCube((1, 64, 64, 64), [[24., 24., 24.]], device=dev,
                    dtype=dtype)
    cube.df_ = cube.loc_.sum(-1) / 36 * 100                     # Hz
    rf, gr = waveforms(1000, dtype, dev)
    return cube, Pulse(rf, gr, device=dev, dtype=dtype)


def phase_beff(dev):
    from mrphy_tpu_torch.kernels import bloch
    from mrphy_tpu_torch.ops import sims
    rows = []
    for label, dtype, store in (('64^3 x 1000', torch.float32, None),
                                ('64^3 x 1000, bf16 Beff', torch.float32,
                                 torch.bfloat16),
                                ('64^3 x 1000', torch.float64, None)):
        cube, pulse = cube64(dtype, dev)
        beff = cube.pulse2beff(pulse)
        if store is not None:
            beff = beff.to(store)
        args = sims.beff_planes(cube.M_, beff, T1=cube.T1_, T2=cube.T2_,
                                gam=cube.gam_, dt=pulse.dt)
        del beff
        rows.append(compare('beff_fwd', lambda: bloch.beff_fwd(*args),
                            lambda: bloch.beff_fwd_torch(*args), dtype,
                            label, timed=True))
        del args
    return rows


def phi_max(cube, pulse) -> float:
    r"""Bound on the per-step rotation angle of ``pulse`` on ``cube``."""
    from mrphy_tpu_torch.ops import sims
    return float(sims.rfgr_phi_bound(pulse.rf, pulse.gr, cube.loc_,
                                     df=cube.df_, gam=cube.gam_,
                                     dt=pulse.dt))


def phase_main_path(dev):
    r"""The entry points, each kernel launched through them; returns the
    measured errors and bars and the launch counts."""
    from mrphy_tpu_torch.kernels import bloch
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
        check(tuple(M_fused.shape) == (1, 64 ** 3, 3), 'cube64 output shape')
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
    return out, dict(bloch.LAUNCHES)


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False',
              file=sys.stderr)
        return 1
    from mrphy_tpu_torch.kernels import _build, bloch

    dev = torch.device('cuda', 0)
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
    print(f'kernel build: {json.dumps(info)}', flush=True)

    # float32 matrix products and convolutions in full float32 (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    rfgr_rows = phase_rfgr(dev)
    beff_rows = phase_beff(dev)

    for k in bloch.LAUNCHES:
        bloch.LAUNCHES[k] = 0
    _, launches = phase_main_path(dev)
    for k, n in launches.items():
        check(n > 0, f'kernel {k} was not launched on the main path')

    kernels = []
    for name, rows in (('rfgr_fwd', rfgr_rows), ('beff_fwd', beff_rows)):
        head = rows[0]   # the float32 timed case at the main-path shape
        kernels.append(dict(
            name=name, route='cuda', **KERNELS[name],
            launches=launches[name],
            max_abs_err=max(r['max_abs_err_chk'] for r in rows
                            if r['dtype'] == 'float32'),
            ms=head['ms'], plain_ms=head['plain_ms']))
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
