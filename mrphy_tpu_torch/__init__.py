r"""MRphy-TPU, PyTorch/CUDA port: the differentiable Bloch simulator of
:mod:`mrphy_tpu` on PyTorch tensors, with hand-written CUDA kernels for
NVIDIA Hopper (``sm_90a``) on the hot path.

The JAX package :mod:`mrphy_tpu` is the reference; every public name here
keeps its counterpart's signature and array layouts (``(N, *Nd, xyz)``,
``(N, xy, nT, (nCoils))``, ``(N, xyz, nT)``) so the two can be compared
like with like. Inside, the port uses PyTorch's idiom: plain functions on
tensors, objects holding tensors with ``.to(device=, dtype=)``, explicit
``device=`` on constructors, and ``torch.autograd.Function`` around each
kernel. This package never imports JAX.

Ported so far: the Bloch path and its gradient, ``SpinCube.applypulse``
through ``sims.blochsim_rfgr`` (fused engine, kernels ``rfgr_fwd`` and
``rfgr_bwd``) and ``sims.blochsim`` (B-effective streaming engine,
kernels ``beff_fwd`` and ``beff_bwd``), the joint RF + gradient design
loop :mod:`mrphy_tpu_torch.design`, and the two-pool Bloch–McConnell
engine ``ops.mc.blochsim_mc_rfgr`` (kernels ``mc_fwd`` and ``mc_bwd``)
with its oracle ``slowsims.blochsim_mc``. Kernels build with ``nvcc`` at
their first CUDA call (see :mod:`mrphy_tpu_torch.kernels`); CPU
tensors take each kernel's plain PyTorch version.

Shape grammar and units are those of :mod:`mrphy_tpu`.
"""

from math import pi as π, inf  # noqa: F401,E741

pi = π

# -- Physical constants (same values as mrphy_tpu) --
gamH = 4257.6      # Hz/Gauss, water proton gyromagnetic ratio
T1G = 1.47         # Sec, T1 of gray matter
T2G = 0.07         # Sec, T2 of gray matter

dt0 = 4e-6         # Sec, default dwell time
gmax0 = 5.0        # Gauss/cm, default max |gradient|
smax0 = 12e3       # Gauss/cm/Sec, default max |slew rate|
rfmax0 = 0.25      # Gauss, default max |RF|

# Unicode alias for reference-API compatibility
γH = gamH

_slice = slice(None)


def cuda_is_available() -> bool:
    r"""Return ``True`` iff PyTorch sees a CUDA device."""
    import torch
    return torch.cuda.is_available()


from mrphy_tpu_torch import utils                  # noqa: E402
from mrphy_tpu_torch.ops import beffective         # noqa: E402
from mrphy_tpu_torch.ops import sims               # noqa: E402
from mrphy_tpu_torch.ops import slowsims           # noqa: E402
from mrphy_tpu_torch.models import mobjs           # noqa: E402
from mrphy_tpu_torch import kernels                # noqa: E402
from mrphy_tpu_torch import design                 # noqa: E402

# Flat import paths (`import mrphy_tpu_torch.sims`), as in mrphy_tpu.
import sys as _sys                                 # noqa: E402

for _name, _mod in (('beffective', beffective), ('sims', sims),
                    ('slowsims', slowsims), ('mobjs', mobjs)):
    _sys.modules[f'{__name__}.{_name}'] = _mod

__all__ = ['gamH', 'γH', 'T1G', 'T2G', 'dt0', 'gmax0', 'smax0', 'rfmax0',
           'utils', 'beffective', 'sims', 'slowsims', 'mobjs', 'kernels',
           'design', 'cuda_is_available']
