r"""k-space / gradient / slew-rate conversions and grid indexing
(counterpart of :mod:`mrphy_tpu.utils.conversions`)."""

import torch

from mrphy_tpu_torch import gamH, dt0
from mrphy_tpu_torch._kwalias import kwalias
from mrphy_tpu_torch.utils._shapes import asarr, rshape

__all__ = ['ctrsub', 'g2k', 'g2s', 'k2g', 's2g']


def ctrsub(shape):
    r"""Center subscript of a regular grid: ``shape // 2``.

    Accepts ints, tuples, or arrays; applies elementwise.
    """
    if isinstance(shape, (tuple, list)):
        return type(shape)(s // 2 for s in shape)
    return shape // 2


def _diff0(x):
    # first sample kept: difference against an implicit leading 0
    return torch.cat((x[:, :, :1], x[:, :, 1:] - x[:, :, :-1]), dim=2)


@kwalias(**{'γ': 'gam'})
def g2k(g, isTx: bool, dt=dt0, *, gam=gamH):
    r"""Compute k-space from gradients.

    Inputs:
        - ``g``: `(N, xyz, nT)`, "Gauss/cm", gradient.
        - ``isTx``: bool; if True, transmit k-space (ends at the origin).
    Optionals:
        - ``dt``: `()` ⊻ `(N ⊻ 1,)`, "Sec", dwell time.
        - ``gam`` (alias ``γ``): `()` ⊻ `(N ⊻ 1, ...)`, "Hz/Gauss".
    Outputs:
        - ``k``: `(N, xyz, nT)`, "cycle/cm".
    """
    g = torch.as_tensor(g)
    gam, dt = rshape(asarr(gam, g), g.ndim), rshape(asarr(dt, g), g.ndim)
    k = gam * dt * torch.cumsum(g, dim=2)
    if isTx:
        k = k - k[:, :, -1:]
    return k


def g2s(g, dt=dt0):
    r"""Compute slew rates from gradients (finite difference / dt).

    Inputs:
        - ``g``: `(N, xyz, nT)`, "Gauss/cm".
    Optionals:
        - ``dt``: `()` ⊻ `(N ⊻ 1,)`, "Sec".
    Outputs:
        - ``s``: `(N, xyz, nT)`, "Gauss/cm/Sec".
    """
    g = torch.as_tensor(g)
    return _diff0(g) / rshape(asarr(dt, g), g.ndim)


@kwalias(**{'γ': 'gam'})
def k2g(k, isTx: bool, dt=dt0, *, gam=gamH):
    r"""Compute gradients from k-space (inverse of :func:`g2k`).

    Inputs:
        - ``k``: `(N, xyz, nT)`, "cycle/cm". If ``isTx``, ``k[..., -1]``
          must be 0 (transmit k-space ends at the origin).
    Outputs:
        - ``g``: `(N, xyz, nT)`, "Gauss/cm".
    """
    k = torch.as_tensor(k)
    if isTx and not bool(torch.all(k[:, :, -1] == 0)):
        raise ValueError('Tx k-space must end at the origin')
    gam, dt = rshape(asarr(gam, k), k.ndim), rshape(asarr(dt, k), k.ndim)
    return _diff0(k) / gam / dt


def s2g(s, dt=dt0):
    r"""Compute gradients from slew rates (inverse of :func:`g2s`).

    Inputs:
        - ``s``: `(N, xyz, nT)`, "Gauss/cm/Sec".
    Outputs:
        - ``g``: `(N, xyz, nT)`, "Gauss/cm".
    """
    s = torch.as_tensor(s)
    return rshape(asarr(dt, s), s.ndim) * torch.cumsum(s, dim=2)
