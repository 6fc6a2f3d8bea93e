r"""Time the EPG adjoints K15 ``spgr_bwd``, K18 ``cpmg_bwd``, K21
``xspgr_bwd``, K24 ``xspgr_v_bwd``, K27 ``xcpmg_bwd``, K30
``xcpmg_v_bwd``, K33 ``xmt_bwd`` and K36 ``xmt_v_bwd``, the forwards that
write their checkpoints (among them K14 ``spgr_fwd_chk``, K17
``cpmg_fwd_chk``, the two-pool K20
``xspgr_fwd_chk``, K23 ``xspgr_v_fwd_chk``, K26 ``xcpmg_fwd_chk`` and K29
``xcpmg_v_fwd_chk``, and EPG-X(MT)'s K32 ``xmt_fwd_chk`` and K35
``xmt_v_fwd_chk``), at the main paths' shapes, and the path steps that run
them, on one card, optionally against another checkout of the repository
in the same run.

Each side runs in a process of its own, which imports ``mrphy_tpu_torch``
and ``chip_smoke`` (for its case builders) from that side's root, builds
that side's kernels into its own ``build/kernels``, and then

- for each kernel case, makes the checkpoints with the forward kernel at
  the side's own chunk length (``kernels.epg.adjoint_tc`` where the side
  has the adjoint's lane route, else ``pick_tc``), times that forward
  (``chk_ms``, with the route the forward takes, ``fwd_route``:
  ``kernels.epg.forward_cfg``'s lanes G and slots M where the side has
  that forward's lane entry point, else one thread per atom; a case may
  cap the slots, ``fwd_slots``, to time a wider group; where it takes the
  lanes, also the same
  forward forced onto one thread per atom, ``chk_thread_ms``; for
  EPG-X(MT), whose forward keeps one thread per atom, the forward at
  pick_tc's chunk too, ``chk_pick_ms``) and the adjoint kernel alone
  (where the side's adjoint takes its lane route on an EPG-X(MT) case,
  also forced onto one thread per atom at the same chunk, ``thread_ms``):
  the median of ``--reps`` CUDA-event timings after one warm-up call, with
  the peak memory allocated. A case may name its chunk (``tc``), which
  both sides then take: the T2 map at tc 2, K18 at the chunk of both. Beside the paths' kernel shapes, the two-pool train also
  runs at K 24 with a scalar tr, over a tr train at K 48 (an
  exchange-MRF segment, 65,536 × 200) and at the exchange-MRF
  refinement's 4096 atoms (scalar tr and tr train), the shapes on which
  the forwards' route was chosen; EPG-X(MT) at the qMT dictionary (65,536
  × 400, K 48) at its scalar tr and over ``QMT_V``'s train;
- for each path case, times ``--steps`` steps through the entry points on
  the host's clock after one warm-up step, with the peak memory allocated
  over them: the T2 fit's Adam step at 1M voxels × 32 echoes
  (``chip_smoke`` phase 20a), the exchange-MRF refinement step of 4096
  voxels (``ops.mrf.match_refine``, two 200-TR segments, K 48) at a
  scalar tr (22a) and over the tr trains (24a), ``epg_spgr``'s gradient
  at bench_mrf_fisp width without and with diffusion (phase 16), the MRF
  refinement step of 4096 voxels at K 16 (18a, from 10% off grid atoms),
  the MWF fit's Adam step over the 1M-voxel map in four blocks, at a
  scalar esp (26a) and over ``MWF_V``'s esp train (28a), and the qMT
  protocol gradient at the dictionary's full width at its scalar tr (32a)
  and over ``QMT_V``'s train (34a).

With ``--parent DIR`` the sides run in turns parent, change, change,
parent::

    git archive <commit> | tar -x -C build/parent
    python3 scripts/time_adjoints.py --parent build/parent

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

# label, kernel, atoms, steps, K (None: the path's own), case keywords
CASES = (
    ('T2 map 1M x 32, K 33, b1', 'cpmg_bwd', 1 << 20, 32, None,
     dict(t2map=True)),
    ('T2 map 1M x 32, K 33, b1, at tc 2', 'cpmg_bwd', 1 << 20, 32, None,
     dict(t2map=True, tc=2)),
    ('bench_mrf CPMG 64k x 32', 'cpmg_bwd', 65536, 32, None, {}),
    ('bench_mrf two-pool 64k x 400, K 48', 'xspgr_bwd', 65536, 400, 48, {}),
    ('bench_mrf variable-TR two-pool 64k x 400, K 24', 'xspgr_v_bwd', 65536,
     400, 24, dict(vartr=True)),
    ('bench_mrf two-pool at K 24, tr 12 ms', 'xspgr_bwd', 65536, 400, 24, {}),
    ('exchange-MRF segment over a tr train 64k x 200, K 48', 'xspgr_v_bwd',
     65536, 200, 48, dict(vartr=True)),
    ('exchange-MRF refinement 4096 x 200, K 48', 'xspgr_bwd', 4096, 200, 48,
     {}),
    ('exchange-MRF refinement over a tr train', 'xspgr_v_bwd', 4096, 200, 48,
     dict(vartr=True)),
    ('bench_mrf_fisp 64k x 400, K 48', 'spgr_bwd', 65536, 400, 48, {}),
    ('bench_mrf_fisp + diffusion', 'spgr_bwd', 65536, 400, 48,
     dict(D=True)),
    ('bench_mrf_fisp, K14 on 16 lanes of 3 slots', 'spgr_bwd', 65536, 400,
     48, dict(fwd_slots=3)),
    ('bench_mrf_fisp + diffusion, K14 on 16 lanes of 3 slots', 'spgr_bwd',
     65536, 400, 48, dict(D=True, fwd_slots=3)),
    ('MRF refinement 4096 x 400, K 16', 'spgr_bwd', 4096, 400, 16,
     dict(pipe=True)),
    ('MWF fit block 262,144 x 32, K 33, b1', 'xcpmg_bwd', 1 << 18, 32, None,
     dict(mwf=True)),
    ('bench_mrf EPG-X CPMG 64k x 32', 'xcpmg_bwd', 65536, 32, None,
     dict(bench=True)),
    ('MWF fit block over the esp train', 'xcpmg_v_bwd', 1 << 18, 32, None,
     dict(mwf=True)),
    ('qMT dictionary 64k x 400, K 48', 'xmt_bwd', 65536, 400, 48,
     dict(qmt=True)),
    ('qMT dictionary over the QMT_V train', 'xmt_v_bwd', 65536, 400, 48,
     dict(qmt=True)),
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
        kw = dict(kw)
        fixed_tc = kw.pop('tc', None)
        fwd_slots = kw.pop('fwd_slots', None)
        # the side's own chunk: adjoint_tc where the adjoint has its lane
        # route, pick_tc's otherwise (the entry points' before it), or the
        # case's
        lanes = f'mrphy_{kernel}_lanes_f32' in _build._SIGNATURES
        chooser = kepg.adjoint_tc if lanes else kepg.pick_tc
        if fixed_tc:
            def chooser(*a, tc=fixed_tc):
                return tc
        row = dict(root=str(root), case=label, kernel=kernel)
        fwd_mod, thread = kx, None
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
            planes, fwd_mod = 6, kepg
        elif kernel == 'spgr_bwd':
            make = cs.mrf_pipe_case if kw.pop('pipe', False) \
                else cs.mrf_fisp_case
            coef, par, cdiff, cfg = cs.spgr_args(make(
                nA, nT, K, torch.float32, dev, seed=seed, **kw))
            tc = chooser(nT, cfg.K, nA, 4)

            def fwd():
                return kepg.spgr_fwd_chk(coef, par, cdiff, cfg, tc=tc)[1]
            chk = fwd()
            g = cs.cotangent(torch.empty((nA, nT, 2), device=dev), seed)

            def run():
                return kepg.spgr_bwd(coef, par, cdiff, cfg, chk, g, tc=tc)
            planes, fwd_mod = 6, kepg
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
        elif kernel.startswith('xmt'):
            v = '_v' if kernel == 'xmt_v_bwd' else ''
            case = cs.xmt_case(nA, nT, K, torch.float32, dev, seed=seed, **kw)
            if v:
                case['tr'] = cs.qmtv_dict_trs(nT, torch.float32, dev)
            coef, pk, cfg = cs.xmt_args(case)
            xp = pk if v else (pk,)
            tc = chooser(nT, cfg.K, nA, 4, kx.PLANES_MT)
            fwd_chk = getattr(kx, f'xmt{v}_fwd_chk')
            bwd = getattr(kx, f'xmt{v}_bwd')

            def fwd(tc=tc):
                return fwd_chk(coef, *xp, cfg, tc=tc)[1]
            chk = fwd()
            g = cs.cotangent(torch.empty((nA, nT, 2), device=dev), seed)

            def run():
                return bwd(coef, *xp, cfg, chk, g, tc=tc)
            planes = kx.PLANES_MT
            # the one-thread forward at pick_tc's chunk (the chunk before
            # the lane route)
            pick = kepg.pick_tc(nT, cfg.K, nA, 4, planes)
            row['chk_pick_ms'] = cs.time_ms(lambda: fwd(pick), reps=reps)
            if lanes and kepg.adjoint_cfg(cfg.K, 4, planes,
                                          tc).route == 'lanes':
                thread = kepg.AdjointCfg('thread', 1, 0, 0)
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
        # the forward's route: the side's forward_cfg where the side has
        # the forward's lane entry point, else one thread per atom
        fwd_name = kernel.replace('_bwd', '_fwd_chk')
        slots = dict(getattr(kepg, 'FWD_SLOTS_MAX', {}))
        if f'mrphy_{fwd_name}_lanes_f32' in _build._SIGNATURES:
            if fwd_slots:
                # a cap on the slots for this case: a wider group
                kepg.FWD_SLOTS_MAX[(planes, 4)] = fwd_slots
                row['fwd_slots'] = fwd_slots
            row['fwd_route'] = kepg.forward_cfg(cfg.K, 4, planes)._asdict()
        elif planes in (6, 12):
            row['fwd_route'] = dict(route='thread', G=1, M=0)
        row['chk_ms'] = cs.time_ms(fwd, reps=reps)
        if row.get('fwd_route', {}).get('route') == 'lanes':
            # the same forward on one thread per atom, as the chooser's
            # yardstick
            lanes_cfg = fwd_mod.forward_cfg
            fwd_mod.forward_cfg = lambda *a: kepg.ForwardCfg('thread', 1, 0)
            try:
                row['chk_thread_ms'] = cs.time_ms(fwd, reps=reps)
            finally:
                fwd_mod.forward_cfg = lanes_cfg
        if thread is not None:
            # the adjoint on one thread per atom at the same chunk
            lanes_cfg = kx.adjoint_cfg
            kx.adjoint_cfg = lambda *a: thread
            try:
                row['thread_ms'] = cs.time_ms(run, reps=reps)
            finally:
                kx.adjoint_cfg = lanes_cfg
        if slots:
            kepg.FWD_SLOTS_MAX.update(slots)
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


def qmt_grad_step(vartr):
    r"""Phase 32a's (``vartr``: 34a's, over ``QMT_V``'s train) protocol
    gradient at the qMT dictionary's full width in float32: the
    neighbouring-kba separation (``chip_smoke.qmt_separation``) w.r.t. the
    flips, the wt train (the tr train) and the per-atom F, kba, T2b, one
    gradient a step."""
    def make(cs, dev):
        import torch
        from mrphy_tpu_torch.kernels import epgx as kx
        c = cs.QMT_DICT
        flips, phis, wt = cs.qmt_train(c['ntr'], torch.float32, dev)
        F, kba, T2b = cs.qmt_grid(torch.float32, dev)[1]
        xs = dict(flips=flips, wt=wt, F=F, kba=kba, T2b=T2b)
        if vartr:
            xs['tr'] = cs.qmtv_dict_trs(c['ntr'], torch.float32, dev)

        def run(n):
            for _ in range(n):
                p = {k: v.detach().requires_grad_() for k, v in xs.items()}
                kw = cs.qmt_kw(p['F'], p['kba'], p['T2b'])
                if vartr:
                    kw['tr'] = p['tr']
                D = kx.xmt_spgr(p['flips'], phis, wt=p['wt'], **kw)
                torch.autograd.grad(cs.qmt_separation(D), list(p.values()))
        return run
    return make


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
    ('32a qMT protocol gradient 64k x 400, K 48', 'qmt_grad',
     qmt_grad_step(False)),
    ('34a qMT protocol gradient over the QMT_V train', 'qmt_grad_v',
     qmt_grad_step(True)),
)


def main() -> int:
    ap = _sides.parser(__doc__, 20, 'cases to time: spgr_bwd, cpmg_bwd, '
                       'xspgr_bwd, xspgr_v_bwd, xcpmg_bwd, xcpmg_v_bwd, '
                       'xmt_bwd, xmt_v_bwd, t2_fit, refine, refine_v, '
                       'spgr_grad, spgr_grad_d, mrf_refine, mwf_fit, '
                       'mwf_fit_v, qmt_grad, qmt_grad_v')
    a = ap.parse_args()
    if a.side is not None:
        side(a.side.resolve(), a.reps, a.steps, a.only)
        return 0
    return _sides.drive(
        Path(__file__).resolve(), ROOT, a,
        lists=('chk_ms', 'chk_thread_ms', 'chk_pick_ms', 'thread_ms'),
        scalars=('fwd_route', 'tc'),
        ratios=(('ratio', 'ms'), ('chk_ratio', 'chk_ms')))


if __name__ == '__main__':
    sys.exit(main())
