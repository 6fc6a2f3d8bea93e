r"""Time the EPG adjoints K15 ``spgr_bwd``, K18 ``cpmg_bwd``, K21
``xspgr_bwd``, K24 ``xspgr_v_bwd``, K27 ``xcpmg_bwd`` and K30
``xcpmg_v_bwd`` at the main paths' shapes, and the path steps that run
them, on one card, optionally against another checkout of the repository
in the same run.

Each side runs in a process of its own, which imports ``mrphy_tpu_torch``
and ``chip_smoke`` (for its case builders) from that side's root, builds
that side's kernels into its own ``build/kernels``, and then

- for each kernel case, makes the checkpoints with the forward kernel at
  the side's own chunk length (``kernels.epg.adjoint_tc`` where the side
  has the adjoint's lane route, else ``pick_tc``), times that forward
  (``chk_ms``) and the adjoint kernel alone: the median of ``--reps``
  CUDA-event timings after one warm-up call, with the peak memory
  allocated;
- for each path case, times ``--steps`` steps through the entry points on
  the host's clock after one warm-up step, with the peak memory allocated
  over them: the T2 fit's Adam step at 1M voxels × 32 echoes
  (``chip_smoke`` phase 20a), the exchange-MRF refinement step of 4096
  voxels (``ops.mrf.match_refine``, two 200-TR segments, K 48) at a
  scalar tr (22a) and over the tr trains (24a), ``epg_spgr``'s gradient
  at bench_mrf_fisp width without and with diffusion (phase 16), the MRF
  refinement step of 4096 voxels at K 16 (18a, from 10% off grid atoms),
  and the MWF fit's Adam step over the 1M-voxel map in four blocks, at a
  scalar esp (26a) and over ``MWF_V``'s esp train (28a).

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
    ('bench_mrf_fisp 64k x 400, K 48', 'spgr_bwd', 65536, 400, 48, {}),
    ('bench_mrf_fisp + diffusion', 'spgr_bwd', 65536, 400, 48,
     dict(D=True)),
    ('MWF fit block 262,144 x 32, K 33, b1', 'xcpmg_bwd', 1 << 18, 32, None,
     dict(mwf=True)),
    ('bench_mrf EPG-X CPMG 64k x 32', 'xcpmg_bwd', 65536, 32, None,
     dict(bench=True)),
    ('MWF fit block over the esp train', 'xcpmg_v_bwd', 1 << 18, 32, None,
     dict(mwf=True)),
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
    for seed, (label, kernel, nA, nT, K, kw) in enumerate(CASES, 900):
        if only and kernel not in only:
            continue
        # the side's own chunk: adjoint_tc where the adjoint has its lane
        # route, pick_tc's otherwise (the entry points' before it)
        lanes = f'mrphy_{kernel}_lanes_f32' in _build._SIGNATURES
        chooser = kepg.adjoint_tc if lanes else kepg.pick_tc
        row = dict(root=str(root), case=label, kernel=kernel)
        if kernel == 'cpmg_bwd':
            flips, ckw = cs.cpmg_case(nA, nT, torch.float32, dev, seed=seed,
                                      **kw)
            coef, par, dq, cdiff, cfg, _ = epg._cpmg_rows(flips, **ckw)
            args = (coef.contiguous(), par.contiguous(), dq.contiguous(),
                    cdiff, cfg)
            tc = chooser(nT, cfg.K, nA, 4)

            def fwd():
                return kepg.cpmg_fwd_chk(*args, tc=tc)[2]
            chk = fwd()
            gr, gi = cs.cotangent(torch.empty((2, nT, nA), device=dev), seed)

            def run():
                return kepg.cpmg_bwd(*args, chk, gr, gi, tc=tc)
            planes = 6
        elif kernel == 'spgr_bwd':
            coef, par, cdiff, cfg = cs.spgr_args(cs.mrf_fisp_case(
                nA, nT, K, torch.float32, dev, seed=seed, **kw))
            tc = chooser(nT, cfg.K, nA, 4)

            def fwd():
                return kepg.spgr_fwd_chk(coef, par, cdiff, cfg, tc=tc)[1]
            chk = fwd()
            g = cs.cotangent(torch.empty((nA, nT, 2), device=dev), seed)

            def run():
                return kepg.spgr_bwd(coef, par, cdiff, cfg, chk, g, tc=tc)
            planes = 6
        elif kernel.startswith('xcpmg'):
            v = '_v' if kernel == 'xcpmg_v_bwd' else ''
            flips, ckw = cs.xcpmg_case(nA, nT, torch.float32, dev, seed=seed,
                                       **kw)
            if v:
                ckw['esp'] = torch.as_tensor(cs.MWF_V['esps'],
                                             dtype=torch.float32, device=dev)
            coef, pk, cfg, _ = epg._xcpmg_rows(flips, **ckw)
            coef = coef.contiguous()
            xp = tuple(x.contiguous() for x in (pk if v else (pk,)))
            tc = chooser(nT, cfg.K, nA, 4, kx.PLANES)
            fwd_chk = getattr(kx, f'xcpmg{v}_fwd_chk')
            bwd = getattr(kx, f'xcpmg{v}_bwd')

            def fwd():
                return fwd_chk(coef, *xp, cfg, tc=tc)[2]
            chk = fwd()
            gr, gi = cs.cotangent(torch.empty((2, nT, nA), device=dev), seed)

            def run():
                return bwd(coef, *xp, cfg, chk, gr, gi, tc=tc)
            planes = 12
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

                def fwd():
                    return kx.xspgr_v_fwd_chk(coef, pk, pkt, cfg, tc=tc)[1]
                chk = fwd()

                def run():
                    return kx.xspgr_v_bwd(coef, pk, pkt, cfg, chk, g, tc=tc)
            else:
                par = par.contiguous()

                def fwd():
                    return kx.xspgr_fwd_chk(coef, par, cfg, tc=tc)[1]
                chk = fwd()

                def run():
                    return kx.xspgr_bwd(coef, par, cfg, chk, g, tc=tc)
            planes = 12
        row.update(nA=nA, nT=nT, K=cfg.K, tc=tc,
                   pick_tc=kepg.pick_tc(nT, cfg.K, nA, 4, planes))
        if lanes:
            row['route'] = kepg.adjoint_cfg(cfg.K, 4, planes, tc)._asdict()
        row['chk_ms'] = cs.time_ms(fwd, reps=reps)
        # the adjoint's peak: its checkpoints resident, its own allocations
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        row['ms'] = cs.time_ms(run, reps=reps)
        row['peak_gb'] = torch.cuda.max_memory_allocated() / 1e9
        print(json.dumps(row), flush=True)
        del chk, run, fwd
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


def spgr_grad_step(D):
    r"""Phase 16's gradient through ``epg_spgr`` at bench_mrf_fisp width
    (``MRF_FISP``, float32, a TR train; ``D``: with spoiler diffusion):
    Σ w·signals w.r.t. T1, T2, tr (and D), one step a gradient."""
    def make(cs, dev):
        import torch
        from mrphy_tpu_torch.ops import epg
        c = cs.MRF_FISP
        kw = cs.mrf_fisp_case(c['nA'], c['nTR'], c['K'], torch.float32, dev,
                              D=D, seed=7)
        w = cs.cotangent(torch.empty((c['nA'], c['nTR'], 2), device=dev), 8)
        names = ('T1', 'T2', 'tr') + (('D',) if D else ())

        def run(n):
            for _ in range(n):
                xs = {k: kw[k].clone().requires_grad_() for k in names}
                k2 = dict(kw, **xs, zinit=epg.ir_prep(c['ti'], xs['T1']))
                torch.autograd.grad((w * epg.epg_spgr(**k2)).sum(),
                                    list(xs.values()))
        return run
    return make


def mrf_refine_step(cs, dev):
    r"""Phase 18a's refinement: ``match_refine`` (batched, Adam at
    ``MRF_PIPE``'s lr) of 4096 voxels over the bench_mrf_pipeline train at
    K 16, from 10% off 4096 grid atoms drawn from numpy default_rng(0)."""
    import numpy as np
    import torch
    from mrphy_tpu_torch.ops import epg, mrf
    flips, T1, T2 = cs.mrf_pipe_grid(dev)
    sel = torch.as_tensor(np.random.default_rng(0).choice(
        T1.shape[0], cs.MRF_PIPE['nref'], replace=False), device=dev)
    T1t, T2t = T1[sel], T2[sel]
    seq = dict(tr=cs.MRF_SEQ['tr'], te=cs.MRF_SEQ['te'], K=16)
    with torch.no_grad():
        X = epg.epg_spgr(flips, None, T1=T1t, T2=T2t, **seq)
    p0 = torch.log(torch.stack([1.1 * T1t, 0.9 * T2t], -1))

    def sig_b(P):
        return epg.epg_spgr(flips, None, T1=torch.exp(P[:, 0]),
                            T2=torch.exp(P[:, 1]), **seq)

    def run(n):
        return mrf.match_refine(sig_b, p0, X, iters=n,
                                lr=cs.MRF_PIPE['lr'], batched=True)
    return run


def mwf_fit_step(esp_train):
    r"""Phase 26a's Adam step (``esp_train``: 28a's, over ``MWF_V``'s esp
    train): the log pools of ``MWF_MAP``'s 1M voxels against the noisy
    echoes at the truth, four 262,144-voxel blocks a step (each block's
    loss and backward), from ``MWF``'s start."""
    def make(cs, dev):
        import numpy as np
        import torch
        c, m = cs.MWF, cs.MWF_MAP
        nV, nb = m['nV'], m['block']
        mwf, T2a, T2b, b1n, _ = cs.mwf_truth(nV)

        def arr(x):
            return torch.as_tensor(x, dtype=torch.float32, device=dev)

        truth = {k: arr(v) for k, v in cs.mwf_pools(mwf, T2a, T2b).items()}
        b1 = arr(b1n)
        flips = torch.full((c['nE'],), np.pi, device=dev)
        esp = arr(cs.MWF_V['esps']) if esp_train else None
        with torch.no_grad():
            ech = cs.mwf_train(flips, truth, b1, esp)
            sigma = c['noise'] / 100 * float(ech[:, 0].abs().max())
            gen = torch.Generator(device=dev).manual_seed(0)
            ech = ech + sigma * torch.randn(ech.shape, generator=gen,
                                            device=dev)
        logp = {k: torch.full((nV,), np.log(v), device=dev,
                              requires_grad=True)
                for k, v in c['start'].items()}
        opt = torch.optim.Adam(list(logp.values()), lr=c['lr'])

        def run(n):
            for _ in range(n):
                opt.zero_grad()
                for b0 in range(0, nV, nb):
                    sl = slice(b0, b0 + nb)
                    p = {k: torch.exp(v[sl]) for k, v in logp.items()}
                    ((cs.mwf_train(flips, p, b1[sl], esp) - ech[sl]) ** 2
                     ).mean(dim=(-2, -1)).sum().backward()
                opt.step()
        return run
    return make


# label, name (for --only), the maker of a function that runs n steps
PATHS = (
    ('20a T2-fit step 1M x 32', 't2_fit', t2_fit_step),
    ('22a exchange-MRF refinement step 4096 x 2 x 200', 'refine',
     refine_step(False)),
    ('24a exchange-MRF refinement step over the tr trains', 'refine_v',
     refine_step(True)),
    ('16 epg_spgr gradient 64k x 400, K 48', 'spgr_grad',
     spgr_grad_step(False)),
    ('16 epg_spgr gradient + diffusion', 'spgr_grad_d', spgr_grad_step(True)),
    ('18a MRF refinement step 4096 x 400, K 16', 'mrf_refine',
     mrf_refine_step),
    ('26a MWF fit step 1M x 32 (4 blocks)', 'mwf_fit', mwf_fit_step(False)),
    ('28a MWF fit step over the esp train', 'mwf_fit_v', mwf_fit_step(True)),
)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--parent', type=Path, default=None)
    ap.add_argument('--side', type=Path, default=None)
    ap.add_argument('--reps', type=int, default=5)
    ap.add_argument('--steps', type=int, default=20)
    ap.add_argument('--only', nargs='*', default=None,
                    help='cases to time: spgr_bwd, cpmg_bwd, xspgr_bwd, '
                         'xspgr_v_bwd, xcpmg_bwd, xcpmg_v_bwd, t2_fit, '
                         'refine, refine_v, spgr_grad, spgr_grad_d, '
                         'mrf_refine, mwf_fit, mwf_fit_v')
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
        if 'chk_ms' in r:
            case.setdefault(key + '_chk_ms', []).append(r['chk_ms'])
    for case, s in summary.items():
        if 'parent' in s and 'change' in s:
            s['ratio'] = min(s['change']) / min(s['parent'])
    print(json.dumps(dict(card=smi, cases=summary)), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
