r"""Build and load the CUDA kernels of :mod:`mrphy_tpu_torch.kernels`.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` into ONE shared library
with a plain C interface, written to ``build/kernels/`` at the root of the
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
              '-O3', '-fmad=false', '-shared', '-Xcompiler', '-fPIC')

_P, _I64 = ctypes.c_void_p, ctypes.c_int64

# C entry points and their argument types: every pointer and the stream
# are c_void_p, every size c_int64; each returns a cudaError_t (0 = ok).
_SIGNATURES = {
    # mi, rf2, gr2, loc, dfg, b1, E, e1_1, g2pd, vel, tarr, chk,
    # N, nS, nT, nC, tc, stream
    'mrphy_rfgr_fwd_f32': (_P,) * 12 + (_I64,) * 5 + (_P,),
    'mrphy_rfgr_fwd_f64': (_P,) * 12 + (_I64,) * 5 + (_P,),
    # mi, beff, E, e1_1, g2pd, chk, B, nT, tc, stream
    'mrphy_beff_fwd_f32': (_P,) * 6 + (_I64,) * 3 + (_P,),
    'mrphy_beff_fwd_f32_bf16': (_P,) * 6 + (_I64,) * 3 + (_P,),
    'mrphy_beff_fwd_f64': (_P,) * 6 + (_I64,) * 3 + (_P,),
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


def _compile(sources, out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    # write to a temporary name, then rename: a concurrent build of the
    # same sources never sees a half-written library
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=out.parent)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, '-o', tmp, *map(str, sources)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise KernelBuildError(
                f'nvcc failed ({proc.returncode}): {" ".join(cmd)}\n'
                f'{proc.stderr}')
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


@functools.cache
def library():
    r"""The loaded kernel library, built first if its sources changed.

    Returns ``(lib, info)``: the :class:`ctypes.CDLL` with ``argtypes``
    and ``restype`` set on every entry point, and a dict with the
    library's ``path``, whether it was ``built`` in this call, and the
    ``build_s`` seconds that took.
    """
    sources = _sources()
    path = BUILD_DIR / f'libmrphy_kernels_{_digest(sources)}.so'
    built, t0 = False, time.perf_counter()
    if not path.exists():
        _compile(sources, path)
        built = True
    build_s = time.perf_counter() - t0
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib, {'path': str(path), 'built': built, 'build_s': build_s}
