r"""Time the EPG adjoints K18 ``cpmg_bwd``, K21 ``xspgr_bwd`` and K24
``xspgr_v_bwd`` at the main paths' shapes, and the path steps that run
them, on one card, optionally against another checkout of the repository
in the same run.

Each side runs in a process of its own, which imports ``mrphy_tpu_torch``
and ``chip_smoke`` (for its case builders) from that side's root, builds
that side's kernels into its own ``build/kernels``, and then

- for each kernel case, makes the checkpoints with the forward kernel at
  the side's own chunk length (``kernels.epg.adjoint_tc`` where the side
  has it, else ``pick_tc``) and times the adjoint kernel alone: the median
  of ``--reps`` CUDA-event timings after one warm-up call, with the peak
  memory allocated;
- for each path case, times ``--steps`` steps through the entry points on
  the host's clock after one warm-up step, with the peak memory allocated
  over them: the T2 fit's Adam step at 1M voxels × 32 echoes
  (``chip_smoke`` phase 20a) and the exchange-MRF refinement step of 4096
  voxels (``ops.mrf.match_refine``, two 200-TR segments, K 48), at a
  scalar tr (phase 22a) and over the tr trains (24a).

With ``--parent DIR`` the sides run in turns parent, change, change,
parent::

    git archive <commit> | tar -x -C build/parent
    python3 scripts/time_adjoints.py --parent build/parent

It prints one JSON line per side and case, the card's name and power limit
(``nvidia-smi``), and last a JSON summary with each case's times and peaks;
with ``--out FILE`` it also writes the timed lines there. It fails without
a card.
"""

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# label, kernel, atoms, steps, K (None: the path's own), case keywords
CASES = (
    ('T2 map 1M x 32, K 33, b1', 'cpmg_bwd', 1 << 20, 32, None,
     dict(t2map=True)),
    ('bench_mrf CPMG 64k x 32', 'cpmg_bwd', 65536, 32, None, {}),
    ('bench_mrf two-pool 64k x 400, K 48', 'xspgr_bwd', 65536, 400, 48, {}),
    ('bench_mrf variable-TR two-pool 64k x 400, K 24', 'xspgr_v_bwd', 65536,
     400, 24, dict(vartr=True)),
)


def side(root: Path, reps: int, steps: int, only):
    r"""One side's timings, as JSON lines on stdout."""
    sys.path.insert(0, str(root))
    import torch
    import chip_smoke as cs
    from mrphy_tpu_torch.kernels import _build
    from mrphy_tpu_torch.kernels import epg as kepg
    from mrphy_tpu_torch.kernels import epgx as kx
    from mrphy_tpu_torch.ops import epg
    if not torch.cuda.is_available():
        raise SystemExit('no CUDA device')
    dev = cs.device()
    _, info = _build.library()
    print(json.dumps(dict(root=str(root), build_s=info['build_s'])),
          flush=True)
    chooser = getattr(kepg, 'adjoint_tc', kepg.pick_tc)
    for seed, (label, kernel, nA, nT, K, kw) in enumerate(CASES, 900):
        if only and kernel not in only:
            continue
        row = dict(root=str(root), case=label, kernel=kernel)
        if kernel == 'cpmg_bwd':
            flips, ckw = cs.cpmg_case(nA, nT, torch.float32, dev, seed=seed,
                                      **kw)
            coef, par, dq, cdiff, cfg, _ = epg._cpmg_rows(flips, **ckw)
            args = (coef.contiguous(), par.contiguous(), dq.contiguous(),
                    cdiff, cfg)
            tc = chooser(nT, cfg.K, nA, 4)
            chk = kepg.cpmg_fwd_chk(*args, tc=tc)[2]
            gr, gi = cs.cotangent(torch.empty((2, nT, nA), device=dev), seed)

            def run():
                return kepg.cpmg_bwd(*args, chk, gr, gi, tc=tc)
            planes = 6
        else:
            vartr = kernel == 'xspgr_v_bwd'
            case = cs.xmrf_case(nA, nT, K, torch.float32, dev, seed=seed,
                                **kw)
            coef, par, cfg, _ = epg._xspgr_rows(case.pop('flips'),
                                                case.pop('phis'), **case)
            coef = coef.contiguous()
            tc = chooser(nT, cfg.K, nA, 4, kx.PLANES)
            g = cs.cotangent(torch.empty((nA, nT, 2), device=dev), seed)
            if vartr:
                pk, pkt = par[0].contiguous(), par[1].contiguous()
                chk = kx.xspgr_v_fwd_chk(coef, pk, pkt, cfg, tc=tc)[1]

                def run():
                    return kx.xspgr_v_bwd(coef, pk, pkt, cfg, chk, g, tc=tc)
            else:
                par = par.contiguous()
                chk = kx.xspgr_fwd_chk(coef, par, cfg, tc=tc)[1]

                def run():
                    return kx.xspgr_bwd(coef, par, cfg, chk, g, tc=tc)
            planes = 12
        row.update(nA=nA, nT=nT, K=cfg.K, tc=tc,
                   pick_tc=kepg.pick_tc(nT, cfg.K, nA, 4, planes))
        if hasattr(kepg, 'adjoint_cfg'):
            row['route'] = kepg.adjoint_cfg(cfg.K, 4, planes, tc)._asdict()
        torch.cuda.synchronize()
        row['ms'] = cs.time_ms(run, reps=reps)
        row['peak_gb'] = torch.cuda.max_memory_allocated() / 1e9
        print(json.dumps(row), flush=True)
        del chk, run
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
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


def t2_fit_step(cs, dev):
    r"""Phase 20a's Adam step: (log T2, M0, b1) of T2MAP's 1M voxels × 32
    echoes against their magnitudes, from T2MAP's start."""
    import numpy as np
    import torch
    from mrphy_tpu_torch.ops import epg
    c = cs.T2MAP
    flips, T2t, M0t, b1t = cs.t2map_truth(c['nV'], torch.float32, dev)

    def mag(T2, M0, b1):
        e = epg.epg_cpmg(flips, T1=c['T1'], T2=T2, esp=c['esp'], M0=M0,
                         b1=b1)
        return torch.linalg.vector_norm(e, dim=-1)

    with torch.no_grad():
        target = mag(T2t, M0t, b1t)
    one = torch.ones(c['nV'], device=dev)
    P = [(one * np.log(c['T2_0'])).requires_grad_(),
         one.clone().requires_grad_(), one.clone().requires_grad_()]
    opt = torch.optim.Adam(P, lr=c['lr'])

    def run(n):
        for _ in range(n):
            opt.zero_grad()
            ((mag(torch.exp(P[0]), P[1], P[2]) - target) ** 2).sum(
            ).backward()
            opt.step()
    return run


def refine_step(vartr):
    r"""Phase 22a's (``vartr``: 24a's) refinement: ``match_refine`` of
    XMRF_PIPE's 4096 voxels over ``n`` steps, from 10% off the truths."""
    def make(cs, dev):
        import numpy as np
        import torch
        from mrphy_tpu_torch.ops import mrf
        c = cs.XMRF_PIPE
        flips, phis = cs.mrfx_train(c['ntr'], torch.float32, dev)
        seq = dict(tr=cs.mrfx_trs(c['ntr'], torch.float32, dev) if vartr
                   else c['tr'], K=c['K'], scales=c['scales'])
        rng = np.random.default_rng(0)
        nt = c['ntruth']
        T1t = torch.tensor(np.exp(rng.uniform(np.log(c['T1a'][0]),
                                              np.log(c['T1a'][1]), nt)),
                           dtype=torch.float32, device=dev)
        Kt = torch.tensor(rng.uniform(*c['kab'], nt), dtype=torch.float32,
                          device=dev)
        with torch.no_grad():
            X = cs.mrfx_gen(flips, phis, T1t, Kt, **seq)
        p0 = torch.log(torch.stack([1.1 * T1t, 0.9 * Kt], -1))

        def sig_b(P):
            return cs.mrfx_gen(flips, phis, torch.exp(P[:, 0]),
                               torch.exp(P[:, 1]), **seq)

        def run(n):
            return mrf.match_refine(sig_b, p0, X, iters=n, lr=c['lr'],
                                    batched=True)
        return run
    return make


# label, name (for --only), the maker of a function that runs n steps
PATHS = (
    ('20a T2-fit step 1M x 32', 't2_fit', t2_fit_step),
    ('22a exchange-MRF refinement step 4096 x 2 x 200', 'refine',
     refine_step(False)),
    ('24a exchange-MRF refinement step over the tr trains', 'refine_v',
     refine_step(True)),
)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--parent', type=Path, default=None)
    ap.add_argument('--side', type=Path, default=None)
    ap.add_argument('--reps', type=int, default=5)
    ap.add_argument('--steps', type=int, default=20)
    ap.add_argument('--only', nargs='*', default=None,
                    help='cases to time: cpmg_bwd, xspgr_bwd, xspgr_v_bwd, '
                         't2_fit, refine, refine_v')
    ap.add_argument('--out', type=Path, default=None)
    a = ap.parse_args()
    if a.side is not None:
        side(a.side.resolve(), a.reps, a.steps, a.only)
        return 0
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    order = [ROOT] if a.parent is None else [a.parent.resolve(), ROOT, ROOT,
                                              a.parent.resolve()]
    rows = []
    for root in order:
        cmd = [sys.executable, str(Path(__file__).resolve()), '--side',
               str(root), '--reps', str(a.reps), '--steps', str(a.steps)]
        if a.only:
            cmd += ['--only', *a.only]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              cwd=str(root), env=dict(os.environ))
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            print(f'side {root} failed ({proc.returncode})', flush=True)
            return 1
        for line in proc.stdout.splitlines():
            print(line, flush=True)
            if line.startswith('{') and '"ms"' in line:
                rows.append(json.loads(line))
    if a.out is not None:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text(''.join(json.dumps(r) + '\n' for r in rows))
    summary = {}
    for r in rows:
        key = 'change' if Path(r['root']) == ROOT else 'parent'
        case = summary.setdefault(r['case'], {})
        case.setdefault(key, []).append(r['ms'])
        case.setdefault(key + '_peak_gb', []).append(r['peak_gb'])
    for case, s in summary.items():
        if 'parent' in s and 'change' in s:
            s['ratio'] = min(s['change']) / min(s['parent'])
    print(json.dumps(dict(card=smi, cases=summary)), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
