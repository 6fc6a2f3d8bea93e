r"""Slew-rate clamps and the constrained reparametrization of gradient
design (counterpart of :mod:`mrphy_tpu.utils.slew`).

``s``: `(N, xyz, nT)`, "Gauss/cm/Sec"; ``smax``: `()` ⊻ `(N, xyz)`, a
number or a tensor, used in the dtype and on the device of ``s``.
"""

import torch

from mrphy_tpu_torch import pi
from mrphy_tpu_torch.utils._shapes import asarr

__all__ = ['s2ts', 'ts2s', 'sclamp']


def s2ts(s, smax):
    r"""Slew rate → ts ≔ tan(s/smax·π/2) ∈ (−∞, ∞), for |s| < smax."""
    s = torch.as_tensor(s)
    return torch.tan(s / asarr(smax, s)[..., None] * pi / 2)


def ts2s(ts, smax):
    r"""ts ≔ tan(s/smax·π/2) → slew rate (inverse of :func:`s2ts`)."""
    ts = torch.as_tensor(ts)
    return torch.atan(ts) / pi * 2 * asarr(smax, ts)[..., None]


def sclamp(s, smax):
    r"""Clamp the slew rate elementwise to ``[−smax, smax]``."""
    s = torch.as_tensor(s)
    smax = asarr(smax, s)
    if smax.ndim == 0:
        smax = smax[None]
    return torch.clamp(s, -smax[..., None], smax[..., None])
