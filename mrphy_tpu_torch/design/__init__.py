r"""Joint RF + gradient design by gradient descent through the Bloch
simulator (the workload of the reference's cited papers), with
``torch.optim`` optimizers.

Ported so far: :mod:`mrphy_tpu_torch.design.joint`. The JAX package's
``sta``, ``slr``, ``adiabatic``, ``verse``, ``sms`` and ``checkpoint``
are not ported yet.
"""

from mrphy_tpu_torch.design.joint import (DesignConfig, design_multiscale,
                                          design_pulse, design_step,
                                          init_params, make_optimizer,
                                          params2pulse)

__all__ = ['DesignConfig', 'design_pulse', 'design_multiscale',
           'design_step', 'init_params', 'make_optimizer', 'params2pulse']
