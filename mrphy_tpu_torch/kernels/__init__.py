r"""Hand-written CUDA kernels for Hopper (``sm_90a``) and their wrappers.

- :mod:`mrphy_tpu_torch.kernels.bloch`: ``rfgr_fwd`` and ``beff_fwd``,
  the Bloch forward kernels, and ``rfgr_bwd`` and ``beff_bwd``, their
  reconstruction adjoints, with their plain PyTorch versions and launch
  counts.
- :mod:`mrphy_tpu_torch.kernels.mc`: ``mc_fwd``, the two-pool
  Bloch–McConnell forward, and ``mc_bwd``, its two-phase chunk adjoint,
  with their plain PyTorch versions and launch counts.
- :mod:`mrphy_tpu_torch.kernels._build`: compiles ``csrc/*.cu`` with
  ``nvcc`` (one process per source, all at once) into one library under
  ``build/kernels/`` at the first CUDA launch and loads it with
  :mod:`ctypes`. Importing this package builds nothing.
"""

from mrphy_tpu_torch.kernels import bloch, mc  # noqa: F401

__all__ = ['bloch', 'mc']
