r"""Hand-written CUDA kernels for Hopper (``sm_90a``) and their wrappers.

- :mod:`mrphy_tpu_torch.kernels.bloch`: ``rfgr_fwd`` and ``beff_fwd``,
  the Bloch forward kernels, and ``rfgr_bwd`` and ``beff_bwd``, their
  reconstruction adjoints, with their plain PyTorch versions and launch
  counts.
- :mod:`mrphy_tpu_torch.kernels.mc`: ``mc_fwd``, the two-pool
  Bloch–McConnell forward, and ``mc_bwd``, its two-phase chunk adjoint,
  with their plain PyTorch versions and launch counts.
- :mod:`mrphy_tpu_torch.kernels.signal`: ``sig_fwd``, ``sig_adj`` and
  ``sig_vjp``, the k-space signal operator, its adjoint and its full VJP,
  with their plain PyTorch versions and launch counts.
- :mod:`mrphy_tpu_torch.kernels.nufft`: ``nufft_sample``,
  ``nufft_spread`` and ``nufft_dk``, the gridding NUFFT's interpolation,
  its transpose and its trajectory cotangent, with their plain PyTorch
  versions, launch counts and the autograd Functions of the two stages.
- :mod:`mrphy_tpu_torch.kernels.epg`: ``spgr_fwd``, ``spgr_fwd_chk`` and
  ``spgr_bwd``, the SPGR / MRF-FISP EPG train, the same with chunk
  checkpoints, and its two-phase chunk adjoint; ``cpmg_fwd``,
  ``cpmg_fwd_chk`` and ``cpmg_bwd``, the same three for the CPMG echo
  train; with their plain PyTorch versions, launch counts and the autograd
  Functions of the trains.
- :mod:`mrphy_tpu_torch.kernels.epgx`: ``xspgr_fwd``, ``xspgr_fwd_chk``
  and ``xspgr_bwd``, the two-pool EPG-X SPGR train at a fixed TR, the same
  with chunk checkpoints, and its two-phase chunk adjoint;
  ``xspgr_v_fwd``, ``xspgr_v_fwd_chk`` and ``xspgr_v_bwd``, their
  instances over a variable-TR train; ``xcpmg_fwd``, ``xcpmg_fwd_chk`` and
  ``xcpmg_bwd``, the same three for the two-pool CPMG echo train at a fixed
  echo spacing, and ``xcpmg_v_fwd``, ``xcpmg_v_fwd_chk`` and
  ``xcpmg_v_bwd``, their instances over an echo-spacing train; with their
  plain PyTorch versions, launch counts and the autograd Functions of the
  trains.
- :mod:`mrphy_tpu_torch.kernels.mrf`: ``match``, the fused matched filter
  of MRF dictionary matching, with its plain PyTorch version and launch
  count.
- :mod:`mrphy_tpu_torch.kernels._build`: compiles ``csrc/*.cu`` with
  ``nvcc`` (one process per source, all at once) into one library under
  ``build/kernels/`` at the first CUDA launch and loads it with
  :mod:`ctypes`. Importing this package builds nothing.
"""

from mrphy_tpu_torch.kernels import (bloch, epg, epgx, mc, mrf,  # noqa: F401
                                     nufft, signal)

__all__ = ['bloch', 'epg', 'epgx', 'mc', 'mrf', 'nufft', 'signal']
