r"""Hand-written CUDA kernels for Hopper (``sm_90a``) and their wrappers.

- :mod:`mrphy_tpu_torch.kernels.bloch`: ``rfgr_fwd`` and ``beff_fwd``,
  the Bloch forward kernels, with their plain PyTorch versions and
  launch counts.
- :mod:`mrphy_tpu_torch.kernels._build`: compiles ``csrc/*.cu`` with
  ``nvcc`` into one library under ``build/kernels/`` at the first CUDA
  launch and loads it with :mod:`ctypes`. Importing this package builds
  nothing.
"""

from mrphy_tpu_torch.kernels import bloch  # noqa: F401

__all__ = ['bloch']
