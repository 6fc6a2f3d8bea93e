r"""Time the k-space signal kernels K7 ``sig_fwd`` and K9 ``sig_adj`` at the
acquisition path's shapes, and the path steps that run them, on one card,
optionally against another checkout of the repository in the same run.

Each side runs in a process of its own, which imports ``mrphy_tpu_torch``
and ``chip_smoke`` (for its case makers) from that side's root, builds
that side's kernels into its own ``build/kernels``, and then

- for each kernel case, in float32 (``--dtype float64`` for the float64
  instances), on the arguments ``ops.signal`` gives the kernels:
  ``bench_signal`` (262,144 spins × 16,384 samples × 8 coils, Δf and
  T2*), 16,384 × 4,096 at 1 coil without maps, at 8 and at 32 coils (Δf
  and T2*), and ``bench_recon``'s shape (128² spins × the ~29k-sample
  spiral × 8 coils, neither Δf nor T2*), times ``sig_fwd`` and ``sig_adj``
  (the median of ``--reps`` CUDA-event timings after one warm-up call)
  with the memory one call allocates at its peak;
- for each path case (float32 only), times ``--steps`` steps through the
  entry points on the host's clock after one warm-up step, with the peak
  memory allocated over them: phase 13c's CG-SENSE iteration at
  ``bench_recon`` width (one ``signal`` and one ``signal_adjoint``), and
  phase 13d's ``signal``, ``signal_adjoint`` and ∂Σs²/∂(ktraj, M)
  (``sig_fwd`` + ``sig_vjp``) at ``bench_signal`` width.

With ``--parent DIR`` the sides run in turns parent, change, change,
parent::

    git archive <commit> | tar -x -C build/parent
    python3 scripts/time_signal.py --parent build/parent
    python3 scripts/time_signal.py --parent build/parent --dtype float64 \
        --only sig_fwd sig_adj

It prints one JSON line per side and case, the card's name and power limit
(``nvidia-smi``), and last a JSON summary with each case's times, peaks
and the ratio of the change's best time to the parent's; with ``--out
FILE`` it also writes the timed lines there. It fails without a card.
"""

import json
import sys
import time
from pathlib import Path

import _sides

ROOT = Path(__file__).resolve().parents[1]

# label, spins, samples, chip_smoke.signal_case keywords
KERNEL_CASES = (
    ('bench_signal 262k x 16k x 8 coils, df+T2*', 64 ** 3, 16_384, {}),
    ('16k x 4k x 1 coil, no maps, df+T2*', 1 << 14, 4096,
     dict(nC=1, sens=False)),
    ('16k x 4k x 8 coils, df+T2*', 1 << 14, 4096, {}),
    ('16k x 4k x 32 coils, df+T2*', 1 << 14, 4096, dict(nC=32)),
)
RECON_LABEL = 'bench_recon 128^2 x spiral x 8 coils'


def recon_case(cs, dev, dtype=None):
    r"""Phase 13c's problem at ``bench_recon`` width (float32 unless
    ``dtype``): spin
    locations on the 128² grid, 8 random coils, a random image and the
    corner-covering spiral-out's k-space."""
    import numpy as np
    import torch
    from mrphy_tpu_torch import dt0, gamH
    from mrphy_tpu_torch.utils import spiral2d
    n, nc, fov = (cs.RECON_BENCH[k] for k in ('n', 'nc', 'fov'))
    rng = np.random.default_rng(0)
    ax = np.linspace(-fov / 2, fov / 2, n, endpoint=False) + fov / (2 * n)
    yy, xx = np.meshgrid(ax, ax, indexing='ij')

    def arr(x):
        return torch.as_tensor(x, dtype=dtype or torch.float32, device=dev)

    loc = arr(np.stack([xx, yy, np.zeros_like(xx)], -1).reshape(1, n * n, 3))
    sens = arr(rng.standard_normal((1, n * n, 2, nc)))
    x_true = arr(rng.standard_normal((n * n, 2)))
    grs, _ = spiral2d(fov, int(np.ceil(1.42 * n)), direction='out')
    k = arr(gamH * dt0 * np.cumsum(grs, axis=2))
    return loc, sens, x_true, k


def kernel_args(cs, dev, label, nM, nT, kw, dtype):
    r"""``(w2, pos, df, it2, k)`` and the signal rows ``s2`` of a case in
    ``dtype``, as ``ops.signal`` forms them."""
    import torch
    from mrphy_tpu_torch.ops import signal as sig
    if label == RECON_LABEL:
        loc, sens, x_true, k = recon_case(cs, dev, dtype)
        M = torch.cat([x_true, x_true.new_zeros((x_true.shape[0], 1))],
                      -1)[None]
        w2, *sp = sig.signal_planes(M, loc, k, sens=sens)
    else:
        pos, kws = cs.signal_case(nM, nT, dtype, dev, **kw)
        w2, *sp = sig.signal_planes(*pos, **kws)
    nT = sp[3].shape[-1]
    s2 = cs.cotangent(torch.empty((w2.shape[0], w2.shape[1], nT),
                                  dtype=dtype, device=dev), 40)
    return w2, sp, s2


def side(root: Path, reps: int, steps: int, only, dtype_name: str):
    r"""One side's timings, as JSON lines on stdout."""
    sys.path.insert(0, str(root))
    import torch
    import chip_smoke as cs
    from mrphy_tpu_torch import dt0
    from mrphy_tpu_torch.kernels import _build
    from mrphy_tpu_torch.kernels import signal as ks
    if not torch.cuda.is_available():
        raise SystemExit('no CUDA device')
    dev = cs.device()
    dtype = getattr(torch, dtype_name)
    torch.backends.cuda.matmul.allow_tf32 = False
    _, info = _build.library()
    print(json.dumps(dict(root=str(root), build_s=info['build_s'])),
          flush=True)
    cases = KERNEL_CASES + ((RECON_LABEL, None, None, {}),)
    for label, nM, nT, kw in cases:
        if only and not {'sig_fwd', 'sig_adj'} & set(only):
            break
        w2, sp, s2 = kernel_args(cs, dev, label, nM, nT, kw, dtype)
        runs = (('sig_fwd', lambda: ks.sig_fwd(w2, *sp, dt0)),
                ('sig_adj', lambda: ks.sig_adj(s2, *sp, dt0)))
        for name, run in runs:
            if only and name not in only:
                continue
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            row = dict(root=str(root), case=label, kernel=name,
                       nM=int(sp[0].shape[-1]), nT=int(sp[3].shape[-1]),
                       nC=int(w2.shape[1] // 2), dtype=dtype_name)
            row['ms'] = cs.time_ms(run, reps=reps)
            row['peak_gb'] = (torch.cuda.max_memory_allocated() - base) / 1e9
            print(json.dumps(row), flush=True)
        del w2, sp, s2
        torch.cuda.empty_cache()
    for label, name, make in PATHS:
        if dtype != torch.float32 or (only and name not in only):
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


def cg_step(cs, dev):
    r"""Phase 13c's CG-SENSE at ``bench_recon`` width (float32): ``n`` CG
    iterations a call, each one ``signal`` (K7) and one
    ``signal_adjoint`` (K9)."""
    loc, sens, x_true, k = recon_case(cs, dev)
    A, AH = cs.recon_ops(loc, sens, None, k)
    s = A(x_true)

    def run(m):
        cs.cg_sense(A, AH, s, m)
    return run


def signal_step(which):
    r"""Phase 13d at ``bench_signal`` width (float32, Δf and T2*, 8
    coils): ``signal`` (K7), ``signal_adjoint`` (K9) or the gradient
    ∂Σs²/∂(ktraj, M) (K7 + K8), one a step."""
    def make(cs, dev):
        import torch
        from mrphy_tpu_torch.ops import signal as sig
        pos, kws = cs.signal_case(cs.SIG_NM, cs.SIG_NT, torch.float32, dev)
        M, loc, k = pos
        s = sig.signal(M, loc, k, **kws)

        def one():
            if which == 'fwd':
                sig.signal(M, loc, k, **kws)
            elif which == 'adj':
                sig.signal_adjoint(s, loc, k, **kws)
            else:
                kk, MM = k.clone().requires_grad_(), M.clone().requires_grad_()
                torch.autograd.grad((sig.signal(MM, loc, kk, **kws) ** 2)
                                    .sum(), (kk, MM))

        def run(m):
            for _ in range(m):
                one()
        return run
    return make


# label, name (for --only), the maker of a function that runs n steps
PATHS = (
    ('13c CG-SENSE iteration 128^2, 8 coils (signal + signal_adjoint)',
     'cg_iter', cg_step),
    ('13d signal 262k x 16k x 8 coils', 'signal', signal_step('fwd')),
    ('13d signal_adjoint 262k x 16k x 8 coils', 'signal_adjoint',
     signal_step('adj')),
    ('13d grad_kM 262k x 16k x 8 coils (sig_fwd + sig_vjp)', 'grad_kM',
     signal_step('grad')),
)


def main() -> int:
    ap = _sides.parser(__doc__, 5, 'cases to time: sig_fwd, sig_adj, '
                       'cg_iter, signal, signal_adjoint, grad_kM')
    ap.add_argument('--dtype', choices=('float32', 'float64'),
                    default='float32', help='the kernel cases\' dtype; '
                    'float64 times no path case')
    a = ap.parse_args()
    if a.side is not None:
        side(a.side.resolve(), a.reps, a.steps, a.only, a.dtype)
        return 0
    return _sides.drive(Path(__file__).resolve(), ROOT, a,
                        extra=('--dtype', a.dtype),
                        case=lambda r: f"{r['kernel']}: {r['case']}")


if __name__ == '__main__':
    sys.exit(main())
