r"""Time the gridding NUFFT's spread K11 ``nufft_spread`` (and, beside it,
its gather twin K10 ``nufft_sample``) at the main paths' shapes, and the
path steps that run it, on one card, optionally against another checkout
of the repository in the same run.

Each side runs in a process of its own, which imports ``mrphy_tpu_torch``
and ``chip_smoke`` (for its case builders) from that side's root, builds
that side's kernels into its own ``build/kernels``, and then

- for each kernel case (``chip_smoke.NUFFT_CASES``' arguments: the recon3d
  plan at n = 128, a 192³ grid at W 4, on its 8192-spoke koosh ball and on
  the same 2,285,568 samples drawn uniform; ``bench_nufft3d``, 96³ at osf
  1.25 with 32k samples; ``bench_nufft``, 128² at W 5 with 32k samples),
  times the spread and the sample kernels (the median of ``--reps``
  CUDA-event timings after one warm-up call), with the memory one spread
  allocates at its peak; where the side has the binned spread, also its
  binning alone (``bin_ms``, inside every spread) and, at the recon3d
  plan, the spread at other subproblem sizes (``p_ms``, ``P_VARIANTS``);
- for each path case, times ``--steps`` steps through the entry points on
  the host's clock after one warm-up step, with the peak memory allocated
  over them: phase 15d's CG iteration at the recon3d plan (``nufft`` then
  ``nufft_adjoint`` of a 128³ image on the koosh ball) and its adjoint
  alone, phase 15a's Pipe–Menon weights of ``examples/recon3d.py``'s
  trajectory (``dcf_pipe_menon``, 30 spreads and samples, float64, 48³
  grid, 169,200 samples) and phase 15e's CG-SENSE iteration at
  ``bench_recon`` width through the NUFFT (128², 8 coils, W 5).

With ``--parent DIR`` the sides run in turns parent, change, change,
parent::

    git archive <commit> | tar -x -C build/parent
    python3 scripts/time_nufft.py --parent build/parent

It prints one JSON line per side and case, the card's name and power limit
(``nvidia-smi``), and last a JSON summary with each case's times and peaks;
with ``--out FILE`` it also writes the timed lines there. It fails without
a card.
"""

import json
import sys
import time
from pathlib import Path

import _sides

ROOT = Path(__file__).resolve().parents[1]

# Subproblem sizes also timed at the recon3d plan where the side has the
# binned spread (``kernels.nufft.SPREAD_P`` is the default).
P_VARIANTS = (256, 512, 2048)

# label, the index of its chip_smoke.NUFFT_CASES entry
CASES = (
    ('recon3d plan 192^3 W4, koosh ball 2,285,568', 0),
    ('recon3d plan, 2,285,568 uniform', 1),
    ('bench_nufft3d 96^3 osf 1.25 W4, 32k uniform', 2),
    ('bench_nufft 128^2 osf 2 W5, 32k uniform', 3),
)


def side(root: Path, reps: int, steps: int, only):
    r"""One side's timings, as JSON lines on stdout."""
    sys.path.insert(0, str(root))
    import torch
    import chip_smoke as cs
    from mrphy_tpu_torch.kernels import _build
    from mrphy_tpu_torch.kernels import nufft as knf
    if not torch.cuda.is_available():
        raise SystemExit('no CUDA device')
    dev = cs.device()
    _, info = _build.library()
    print(json.dumps(dict(root=str(root), build_s=info['build_s'])),
          flush=True)
    for label, ci in CASES:
        if only and 'nufft_spread' not in only:
            break
        (_, im_size, fov, osf, W, traj, nT, dtype, N, Nk,
         _) = cs.NUFFT_CASES[ci]
        plan, grid, k, s, _ = cs.nufft_case(im_size, fov, osf, W, traj, nT,
                                            dtype, dev, N, Nk, 60 + ci)
        geom = plan.geom
        row = dict(root=str(root), case=label, kernel='nufft_spread',
                   nT=int(k.shape[-1]), grid=list(plan.grid_size))
        row['sample_ms'] = cs.time_ms(lambda: knf.nufft_sample(grid, k, geom),
                                      reps=reps)
        if hasattr(knf, 'bin_plan'):
            row['bin_ms'] = cs.time_ms(lambda: knf.bin_plan(k, geom),
                                       reps=reps)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        row['ms'] = cs.time_ms(lambda: knf.nufft_spread(s, k, geom),
                               reps=reps)
        row['peak_gb'] = (torch.cuda.max_memory_allocated() - base) / 1e9
        if hasattr(knf, 'SPREAD_P') and ci < 2:
            # other subproblem sizes at the recon3d plan
            P0, row['p_ms'] = knf.SPREAD_P, {}
            for P in P_VARIANTS:
                knf.SPREAD_P = P
                row['p_ms'][P] = cs.time_ms(
                    lambda: knf.nufft_spread(s, k, geom), reps=reps)
            knf.SPREAD_P = P0
        print(json.dumps(row), flush=True)
        del plan, grid, k, s
        torch.cuda.empty_cache()
    for label, name, make in PATHS:
        if only and name not in only:
            continue
        run = make(cs, dev)
        run(1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run(steps)
        torch.cuda.synchronize()
        print(json.dumps(dict(
            root=str(root), case=label, kernel=name, steps=steps,
            ms=(time.perf_counter() - t0) / steps * 1e3,
            peak_gb=torch.cuda.max_memory_allocated() / 1e9)), flush=True)
        del run
        torch.cuda.empty_cache()


def nufft3d_step(adjoint_only):
    r"""Phase 15d at the recon3d plan, float32: a CG iteration's operator
    (``nufft`` then ``nufft_adjoint``) of a 128³ three-sphere phantom on
    the 8192-spoke koosh ball, or (``adjoint_only``) ``nufft_adjoint`` of
    its samples, one a step."""
    def make(cs, dev):
        import torch
        from mrphy_tpu_torch.ops import nufft as nf
        n, fov = cs.NUFFT3D['n'], cs.NUFFT3D['fov']
        kt = torch.as_tensor(cs.radial3d_k(n, fov, cs.NUFFT3D['spokes']),
                             dtype=torch.float32, device=dev)
        plan = nf.nufft_plan((n,) * 3, (fov,) * 3, osf=cs.NUFFT3D['osf'],
                             width=cs.NUFFT3D['width'], device=dev)
        ax = (torch.arange(n, device=dev) - n // 2) / n * fov
        X, Y, Z = torch.meshgrid(ax, ax, ax, indexing='ij')
        img = torch.stack([((X ** 2 + Y ** 2 + Z ** 2) < (0.36 * fov) ** 2)
                           .float(), torch.zeros_like(X)], -1)
        s = nf.nufft(plan, img, kt)

        def run(m):
            for _ in range(m):
                if adjoint_only:
                    nf.nufft_adjoint(plan, s, kt)
                else:
                    nf.nufft_adjoint(plan, nf.nufft(plan, img, kt), kt)
        return run
    return make


def dcf_step(cs, dev):
    r"""Phase 15a's ``dcf_pipe_menon`` of ``examples/recon3d.py``'s
    trajectory (32³ at osf 1.5, W 4, 1200 spokes, float64), one call a
    step."""
    import torch
    from mrphy_tpu_torch.ops import nufft as nf
    c = cs.RECON3D
    kt = torch.as_tensor(cs.radial3d_k(c['n'], c['fov'], c['spokes']),
                         dtype=torch.float64, device=dev)
    plan = nf.nufft_plan((c['n'],) * 3, (c['fov'],) * 3, osf=c['osf'],
                         width=c['width'], dtype=torch.float64, device=dev)

    def run(m):
        for _ in range(m):
            nf.dcf_pipe_menon(plan, kt)
    return run


def cg_sense_step(cs, dev):
    r"""Phase 15e's CG-SENSE at ``bench_recon`` width through the NUFFT
    (128², 8 coils, the corner-covering spiral-out, float32): ``n`` CG
    iterations a call."""
    import numpy as np
    import torch
    from mrphy_tpu_torch import dt0, gamH
    from mrphy_tpu_torch.ops import nufft as nf
    from mrphy_tpu_torch.utils import spiral2d
    n, nc, fov = (cs.RECON_BENCH[k] for k in ('n', 'nc', 'fov'))
    rng = np.random.default_rng(0)

    def arr(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    sens = arr(rng.standard_normal((1, n * n, 2, nc)))
    x_true = arr(rng.standard_normal((n * n, 2)))
    grs, _ = spiral2d(fov, int(np.ceil(1.42 * n)), direction='out')
    k = arr(gamH * dt0 * np.cumsum(grs, axis=2))
    A, AH, _ = cs.recon_nufft_ops(nf, sens, None, k, n, fov)
    s = A(x_true)

    def run(m):
        cs.cg_sense(A, AH, s, m)
    return run


# label, name (for --only), the maker of a function that runs n steps
PATHS = (
    ('15d CG iteration 192^3 koosh ball (nufft + nufft_adjoint)', 'cg_iter',
     nufft3d_step(False)),
    ('15d nufft_adjoint 192^3 koosh ball', 'adjoint', nufft3d_step(True)),
    ('15a dcf_pipe_menon recon3d 32^3, 1200 spokes, f64', 'dcf', dcf_step),
    ('15e CG-SENSE iteration 128^2, 8 coils, through the NUFFT', 'cg_sense',
     cg_sense_step),
)


def main() -> int:
    ap = _sides.parser(__doc__, 10, 'cases to time: nufft_spread, cg_iter, '
                       'adjoint, dcf, cg_sense')
    a = ap.parse_args()
    if a.side is not None:
        side(a.side.resolve(), a.reps, a.steps, a.only)
        return 0
    return _sides.drive(Path(__file__).resolve(), ROOT, a,
                        lists=('sample_ms', 'bin_ms'))


if __name__ == '__main__':
    sys.exit(main())
