r"""Build and load the CUDA kernels of :mod:`mrphy_tpu_torch.kernels`.

Every ``csrc/*.cu`` source is compiled by its own ``nvcc`` process, all
started together, and the objects are linked into ONE shared library with
a plain C interface, written to ``build/kernels/`` at the root of the
checkout under a name keyed by a hash of the sources (and the compile
flags), and loaded with :mod:`ctypes`. Nothing here runs at import time:
:func:`library` builds on its first call, which the kernel wrappers make
at their first CUDA launch. A build that fails raises
:class:`KernelBuildError` carrying nvcc's stderr.

The flags target Hopper (``sm_90a``) and deliberately leave out
``--use_fast_math``: the rotation angle reaches several radians per step
and the ``__sincosf`` intrinsic loses accuracy outside [−π, π].
``-fmad=false`` keeps nvcc from contracting products and sums into FMAs,
so each kernel rounds exactly as its plain PyTorch version does (see
``csrc/bloch_step.cuh``).
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

__all__ = ['KernelBuildError', 'library', 'nvcc_path', 'NVCC_FLAGS',
           'BUILD_DIR', 'CSRC_DIR']

CSRC_DIR = Path(__file__).resolve().parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'kernels'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-fmad=false', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_P, _I64, _D = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double

# C entry points and their argument types: every pointer and the stream
# are c_void_p, every size c_int64, the dwell time c_double; each returns
# a cudaError_t (0 = ok).
_SIGNATURES = {
    # mi, rf2, gr2, loc, dfg, b1, E, e1_1, g2pd, vel, tarr, chk,
    # N, nS, nT, nC, tc, stream
    'mrphy_rfgr_fwd_f32': (_P,) * 12 + (_I64,) * 5 + (_P,),
    'mrphy_rfgr_fwd_f64': (_P,) * 12 + (_I64,) * 5 + (_P,),
    # mi, beff, E, e1_1, g2pd, chk, B, nT, tc, stream
    'mrphy_beff_fwd_f32': (_P,) * 6 + (_I64,) * 3 + (_P,),
    'mrphy_beff_fwd_f32_bf16': (_P,) * 6 + (_I64,) * 3 + (_P,),
    'mrphy_beff_fwd_f64': (_P,) * 6 + (_I64,) * 3 + (_P,),
    # chk, g, rf2, gr2, loc, dfg, b1, E, e1_1, g2pd, vel, tarr,
    # dmi, dwf, dloc, ddfg, db1, dvel, N, nS, nT, nC, tc, stream
    'mrphy_rfgr_bwd_f32': (_P,) * 18 + (_I64,) * 5 + (_P,),
    'mrphy_rfgr_bwd_f64': (_P,) * 18 + (_I64,) * 5 + (_P,),
    # chk, g, beff, E, e1_1, g2pd, dmi, dbeff, B, nT, tc, stream
    'mrphy_beff_bwd_f32': (_P,) * 8 + (_I64,) * 3 + (_P,),
    'mrphy_beff_bwd_f32_bf16': (_P,) * 8 + (_I64,) * 3 + (_P,),
    'mrphy_beff_bwd_f64': (_P,) * 8 + (_I64,) * 3 + (_P,),
    # mi6, rf2, gr2, loc, dfg, b1, g2pd, sb, X, Z, chk, N, nS, nT, nC, tc,
    # stream
    'mrphy_mc_fwd_f32': (_P,) * 11 + (_I64,) * 5 + (_P,),
    'mrphy_mc_fwd_f64': (_P,) * 11 + (_I64,) * 5 + (_P,),
    # chk, g, rf2, gr2, loc, dfg, b1, g2pd, sb, X, Z, states, dmi, dwf,
    # dloc, ddfg, db1, dsb, dX, dZ, N, nS, nT, nC, tc, stream
    'mrphy_mc_bwd_f32': (_P,) * 20 + (_I64,) * 5 + (_P,),
    'mrphy_mc_bwd_f64': (_P,) * 20 + (_I64,) * 5 + (_P,),
    # w2, pos, df, it2, k, Upart, Vpart, pos_bs, df_bs, it2_bs, k_bs, N,
    # nM, nT, nC, nsplit, dt, stream
    'mrphy_sig_fwd_f32': (_P,) * 7 + (_I64,) * 9 + (_D, _P),
    'mrphy_sig_fwd_f64': (_P,) * 7 + (_I64,) * 9 + (_D, _P),
    # s2, pos, df, it2, k, XR, XS, pos_bs, df_bs, it2_bs, k_bs, N, nM, nT,
    # nC, dt, stream
    'mrphy_sig_adj_f32': (_P,) * 7 + (_I64,) * 8 + (_D, _P),
    'mrphy_sig_adj_f64': (_P,) * 7 + (_I64,) * 8 + (_D, _P),
    # g2, w2, pos, df, it2, k, XR, XS, dloc, ddf, di2, dk, pos_bs, df_bs,
    # it2_bs, k_bs, N, nM, nT, nC, nblk, dt, stream
    'mrphy_sig_vjp_f32': (_P,) * 12 + (_I64,) * 9 + (_D, _P),
    'mrphy_sig_vjp_f64': (_P,) * 12 + (_I64,) * 9 + (_D, _P),
    # grid, k, out, geo (17 host doubles), k_bs, N, nT, D, W, stream
    'mrphy_nufft_sample_f32': (_P,) * 4 + (_I64,) * 5 + (_P,),
    'mrphy_nufft_sample_f64': (_P,) * 4 + (_I64,) * 5 + (_P,),
    # s, k, grid, geo, k_bs, N, nT, D, W, stream
    'mrphy_nufft_spread_f32': (_P,) * 4 + (_I64,) * 5 + (_P,),
    'mrphy_nufft_spread_f64': (_P,) * 4 + (_I64,) * 5 + (_P,),
    # grid, k, cot, dk, geo, k_bs, N, nT, D, W, stream
    'mrphy_nufft_dk_f32': (_P,) * 5 + (_I64,) * 5 + (_P,),
    'mrphy_nufft_dk_f64': (_P,) * 5 + (_I64,) * 5 + (_P,),
    # coef, par, cdiff, sig, chk, gstate, nA, nTR, nC, K, kshift, flags, tc,
    # threads, stream
    'mrphy_spgr_fwd_f32': (_P,) * 6 + (_I64,) * 8 + (_P,),
    'mrphy_spgr_fwd_f64': (_P,) * 6 + (_I64,) * 8 + (_P,),
    'mrphy_spgr_fwd_chk_f32': (_P,) * 6 + (_I64,) * 8 + (_P,),
    'mrphy_spgr_fwd_chk_f64': (_P,) * 6 + (_I64,) * 8 + (_P,),
    # coef, par, cdiff, chk, g, scratch, hstate, dpar, dcf, nA, nTR, nC, K,
    # kshift, flags, tc, threads, stream
    'mrphy_spgr_bwd_f32': (_P,) * 9 + (_I64,) * 8 + (_P,),
    'mrphy_spgr_bwd_f64': (_P,) * 9 + (_I64,) * 8 + (_P,),
    # the lane route: coef, par, cdiff, chk, g, dpar, dcf, nA, nTR, nC, K,
    # kshift, flags, tc, G, M, stream
    'mrphy_spgr_bwd_lanes_f32': (_P,) * 7 + (_I64,) * 9 + (_P,),
    'mrphy_spgr_bwd_lanes_f64': (_P,) * 7 + (_I64,) * 9 + (_P,),
    # coef, par, dq, cdiff, er, ei, chk, gstate, nA, nE, nC, flags, tc,
    # threads, stream
    'mrphy_cpmg_fwd_f32': (_P,) * 8 + (_I64,) * 6 + (_P,),
    'mrphy_cpmg_fwd_f64': (_P,) * 8 + (_I64,) * 6 + (_P,),
    'mrphy_cpmg_fwd_chk_f32': (_P,) * 8 + (_I64,) * 6 + (_P,),
    'mrphy_cpmg_fwd_chk_f64': (_P,) * 8 + (_I64,) * 6 + (_P,),
    # coef, par, dq, cdiff, chk, gr, gi, scratch, hstate, dpar, dcf, nA, nE,
    # nC, flags, tc, threads, stream
    'mrphy_cpmg_bwd_f32': (_P,) * 11 + (_I64,) * 6 + (_P,),
    'mrphy_cpmg_bwd_f64': (_P,) * 11 + (_I64,) * 6 + (_P,),
    # the lane route: coef, par, dq, cdiff, chk, gr, gi, dpar, dcf, nA, nE,
    # nC, flags, tc, G, M, stream
    'mrphy_cpmg_bwd_lanes_f32': (_P,) * 9 + (_I64,) * 7 + (_P,),
    'mrphy_cpmg_bwd_lanes_f64': (_P,) * 9 + (_I64,) * 7 + (_P,),
    # coef, par, sig, chk, gstate, nA, nTR, K, kshift, flags, tc, threads,
    # stream
    'mrphy_xspgr_fwd_f32': (_P,) * 5 + (_I64,) * 7 + (_P,),
    'mrphy_xspgr_fwd_f64': (_P,) * 5 + (_I64,) * 7 + (_P,),
    'mrphy_xspgr_fwd_chk_f32': (_P,) * 5 + (_I64,) * 7 + (_P,),
    'mrphy_xspgr_fwd_chk_f64': (_P,) * 5 + (_I64,) * 7 + (_P,),
    # coef, par, chk, g, scratch, hstate, dpar, dcf, nA, nTR, K, kshift,
    # flags, tc, threads, stream
    'mrphy_xspgr_bwd_f32': (_P,) * 8 + (_I64,) * 7 + (_P,),
    'mrphy_xspgr_bwd_f64': (_P,) * 8 + (_I64,) * 7 + (_P,),
    # the lane route: coef, par, chk, g, dpar, dcf, nA, nTR, K, kshift,
    # flags, tc, G, M, stream
    'mrphy_xspgr_bwd_lanes_f32': (_P,) * 6 + (_I64,) * 8 + (_P,),
    'mrphy_xspgr_bwd_lanes_f64': (_P,) * 6 + (_I64,) * 8 + (_P,),
    # coef, pk, pkt, sig, chk, gstate, nA, nTR, K, kshift, flags, tc,
    # threads, stream
    'mrphy_xspgr_v_fwd_f32': (_P,) * 6 + (_I64,) * 7 + (_P,),
    'mrphy_xspgr_v_fwd_f64': (_P,) * 6 + (_I64,) * 7 + (_P,),
    'mrphy_xspgr_v_fwd_chk_f32': (_P,) * 6 + (_I64,) * 7 + (_P,),
    'mrphy_xspgr_v_fwd_chk_f64': (_P,) * 6 + (_I64,) * 7 + (_P,),
    # coef, pk, pkt, chk, g, scratch, hstate, dpar, dcf, dpkt, nA, nTR, K,
    # kshift, flags, tc, threads, stream
    'mrphy_xspgr_v_bwd_f32': (_P,) * 10 + (_I64,) * 7 + (_P,),
    'mrphy_xspgr_v_bwd_f64': (_P,) * 10 + (_I64,) * 7 + (_P,),
    # the lane route: coef, pk, pkt, chk, g, dpar, dcf, dpkt, nA, nTR, K,
    # kshift, flags, tc, G, M, stream
    'mrphy_xspgr_v_bwd_lanes_f32': (_P,) * 8 + (_I64,) * 8 + (_P,),
    'mrphy_xspgr_v_bwd_lanes_f64': (_P,) * 8 + (_I64,) * 8 + (_P,),
    # coef, pk, er, ei, chk, gstate, nA, nE, K, flags, tc, threads, stream
    'mrphy_xcpmg_fwd_f32': (_P,) * 6 + (_I64,) * 6 + (_P,),
    'mrphy_xcpmg_fwd_f64': (_P,) * 6 + (_I64,) * 6 + (_P,),
    'mrphy_xcpmg_fwd_chk_f32': (_P,) * 6 + (_I64,) * 6 + (_P,),
    'mrphy_xcpmg_fwd_chk_f64': (_P,) * 6 + (_I64,) * 6 + (_P,),
    # coef, pk, chk, gr, gi, scratch, hstate, dpar, dcf, nA, nE, K, flags,
    # tc, threads, stream
    'mrphy_xcpmg_bwd_f32': (_P,) * 9 + (_I64,) * 6 + (_P,),
    'mrphy_xcpmg_bwd_f64': (_P,) * 9 + (_I64,) * 6 + (_P,),
    # the lane route: coef, pk, chk, gr, gi, dpar, dcf, nA, nE, K, flags,
    # tc, G, M, stream
    'mrphy_xcpmg_bwd_lanes_f32': (_P,) * 7 + (_I64,) * 7 + (_P,),
    'mrphy_xcpmg_bwd_lanes_f64': (_P,) * 7 + (_I64,) * 7 + (_P,),
    # coef, pk, pkt, er, ei, chk, gstate, nA, nE, K, flags, tc, threads,
    # stream
    'mrphy_xcpmg_v_fwd_f32': (_P,) * 7 + (_I64,) * 6 + (_P,),
    'mrphy_xcpmg_v_fwd_f64': (_P,) * 7 + (_I64,) * 6 + (_P,),
    'mrphy_xcpmg_v_fwd_chk_f32': (_P,) * 7 + (_I64,) * 6 + (_P,),
    'mrphy_xcpmg_v_fwd_chk_f64': (_P,) * 7 + (_I64,) * 6 + (_P,),
    # coef, pk, pkt, chk, gr, gi, scratch, hstate, dpar, dcf, dpkt, nA, nE,
    # K, flags, tc, threads, stream
    'mrphy_xcpmg_v_bwd_f32': (_P,) * 11 + (_I64,) * 6 + (_P,),
    'mrphy_xcpmg_v_bwd_f64': (_P,) * 11 + (_I64,) * 6 + (_P,),
    # the lane route: coef, pk, pkt, chk, gr, gi, dpar, dcf, dpkt, nA, nE,
    # K, flags, tc, G, M, stream
    'mrphy_xcpmg_v_bwd_lanes_f32': (_P,) * 9 + (_I64,) * 7 + (_P,),
    'mrphy_xcpmg_v_bwd_lanes_f64': (_P,) * 9 + (_I64,) * 7 + (_P,),
    # coef, pk, sig, chk, gstate, nA, nTR, K, kshift, flags, tc, threads,
    # stream
    'mrphy_xmt_fwd_f32': (_P,) * 5 + (_I64,) * 7 + (_P,),
    'mrphy_xmt_fwd_f64': (_P,) * 5 + (_I64,) * 7 + (_P,),
    'mrphy_xmt_fwd_chk_f32': (_P,) * 5 + (_I64,) * 7 + (_P,),
    'mrphy_xmt_fwd_chk_f64': (_P,) * 5 + (_I64,) * 7 + (_P,),
    # coef, pk, chk, g, scratch, hstate, dpk, dcf, nA, nTR, K, kshift,
    # flags, tc, threads, stream
    'mrphy_xmt_bwd_f32': (_P,) * 8 + (_I64,) * 7 + (_P,),
    'mrphy_xmt_bwd_f64': (_P,) * 8 + (_I64,) * 7 + (_P,),
    # coef, pk, pkt, sig, chk, gstate, nA, nTR, K, kshift, flags, tc,
    # threads, stream
    'mrphy_xmt_v_fwd_f32': (_P,) * 6 + (_I64,) * 7 + (_P,),
    'mrphy_xmt_v_fwd_f64': (_P,) * 6 + (_I64,) * 7 + (_P,),
    'mrphy_xmt_v_fwd_chk_f32': (_P,) * 6 + (_I64,) * 7 + (_P,),
    'mrphy_xmt_v_fwd_chk_f64': (_P,) * 6 + (_I64,) * 7 + (_P,),
    # coef, pk, pkt, chk, g, scratch, hstate, dpk, dcf, dpkt, nA, nTR, K,
    # kshift, flags, tc, threads, stream
    'mrphy_xmt_v_bwd_f32': (_P,) * 10 + (_I64,) * 7 + (_P,),
    'mrphy_xmt_v_bwd_f64': (_P,) * 10 + (_I64,) * 7 + (_P,),
    # coef, pk, er, ei, chk, nA, nTR, flags, tc, stream
    'mrphy_bssfp_fwd_f32': (_P,) * 5 + (_I64,) * 4 + (_P,),
    'mrphy_bssfp_fwd_f64': (_P,) * 5 + (_I64,) * 4 + (_P,),
    'mrphy_bssfp_fwd_chk_f32': (_P,) * 5 + (_I64,) * 4 + (_P,),
    'mrphy_bssfp_fwd_chk_f64': (_P,) * 5 + (_I64,) * 4 + (_P,),
    # coef, pk, chk, gr, gi, scratch, dpk, dcf, nA, nTR, flags, tc, stream
    'mrphy_bssfp_bwd_f32': (_P,) * 8 + (_I64,) * 4 + (_P,),
    'mrphy_bssfp_bwd_f64': (_P,) * 8 + (_I64,) * 4 + (_P,),
    # dre, dim, x, idx, best, nA, nV, r, stream
    'mrphy_match_f32': (_P,) * 5 + (_I64,) * 3 + (_P,),
    'mrphy_match_f64': (_P,) * 5 + (_I64,) * 3 + (_P,),
}


class KernelBuildError(RuntimeError):
    r"""``nvcc`` is missing or refused the kernel sources."""


def nvcc_path() -> str:
    r"""The ``nvcc`` on ``PATH``, else the CUDA toolkit's default one."""
    found = shutil.which('nvcc')
    if found:
        return found
    default = Path('/usr/local/cuda/bin/nvcc')
    if default.exists():
        return str(default)
    raise KernelBuildError('nvcc not found on PATH or in /usr/local/cuda/bin')


def _sources():
    return sorted(CSRC_DIR.glob('*.cu'))


def _digest(sources) -> str:
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for src in sources + sorted(CSRC_DIR.glob('*.cuh')):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds) -> str:
    r"""Run the ``nvcc`` commands at once and wait for all of them; raise
    :class:`KernelBuildError` on the first that failed, else return their
    joined output."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    outs = [proc.communicate() for proc in procs]
    for cmd, proc, (_, err) in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise KernelBuildError(f'nvcc failed ({proc.returncode}): '
                                   f'{" ".join(cmd)}\n{err}')
    return ''.join(out + err for out, err in outs)


def _compile(sources, out: Path) -> str:
    r"""Compile every source in its own ``nvcc`` process, all at once,
    then link the objects into ``out``; returns nvcc's ``-Xptxas -v``
    report (registers, shared memory and spills of every kernel).

    On an H100 machine (8 cores, nvcc 12.9) the four Bloch sources built
    in 8.0–8.1 s this way, against 12.5–17.7 s in one ``nvcc`` call; with
    the two two-pool sources (20 instances in all) the six build in
    11.5 s; all 21 sources, the two-pool CPMG's ``xcpmg_fwd.cu`` and
    ``xcpmg_bwd.cu`` among them, in 26.1 s on 8 cores (the build stage of
    ``chip_smoke.py``), and all 23, with the EPG-X(MT) ``xmt_fwd.cu`` and
    ``xmt_bwd.cu``, in 26.5–30.1 s."""
    out.parent.mkdir(parents=True, exist_ok=True)
    # build in a private directory and rename at the end: a concurrent
    # build of the same sources never sees a half-written library
    tmp = Path(tempfile.mkdtemp(dir=out.parent))
    try:
        nvcc = nvcc_path()
        objs = [str(tmp / (src.stem + '.o')) for src in sources]
        report = _run_all([[nvcc, *NVCC_FLAGS, '-c', '-o', obj, str(src)]
                           for src, obj in zip(sources, objs)])
        lib = tmp / out.name
        report += _run_all([[nvcc, '-shared', '-o', str(lib), *objs]])
        os.replace(lib, out)
        return report
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


@functools.cache
def library():
    r"""The loaded kernel library, built first if its sources changed.

    Returns ``(lib, info)``: the :class:`ctypes.CDLL` with ``argtypes``
    and ``restype`` set on every entry point, and a dict with the
    library's ``path``, whether it was ``built`` in this call, the
    ``build_s`` seconds that took, and nvcc's ``ptxas`` report of the
    build ('' when the library was already built).
    """
    sources = _sources()
    path = BUILD_DIR / f'libmrphy_kernels_{_digest(sources)}.so'
    built, report, t0 = False, '', time.perf_counter()
    if not path.exists():
        report = _compile(sources, path)
        built = True
    build_s = time.perf_counter() - t0
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib, {'path': str(path), 'built': built, 'build_s': build_s,
                 'ptxas': report}
