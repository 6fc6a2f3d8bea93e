r"""Build the port's objects from :mod:`mrphy_tpu` state held as numpy.

Each function takes the dict that the JAX object's
``asdict(toNumpy=True)`` returns (grid form, the default, or compact
form with ``doEmbed=False``; the dict carries the static ``mask``) and
returns the matching :mod:`mrphy_tpu_torch.models.mobjs` object on
``device`` in ``dtype`` (default: the dict's own dtype). Grid-form
attributes are NaN outside the mask; building through the grid names
extracts the masked values, so both forms give the same object.

No JAX is needed: the values only pass through :func:`numpy.asarray`.
"""

import numpy as np
import torch

from mrphy_tpu_torch.models.mobjs import (Pulse, SpinArray, SpinBolus,
                                          SpinCube)

__all__ = ['pulse_from_numpy', 'spinarray_from_numpy', 'spincube_from_numpy',
           'spinbolus_from_numpy']


def _dtype(d, dtype):
    if dtype is not None:
        return dtype
    if d.get('dtype') is None:
        return torch.float32
    return torch.from_numpy(np.zeros(0, dtype=np.dtype(d['dtype']))).dtype


def _t(v):
    return torch.tensor(np.asarray(v))     # a copy: JAX's arrays are read-only


def _grid_or_compact(d, pairs):
    r"""Keyword arguments for the (dict key, keyword) pairs present in
    ``d``, compact form (``key_``) before grid form (``key``)."""
    kw = {}
    for key, name in pairs:
        if key + '_' in d:
            kw[name + '_'] = _t(d[key + '_'])
        elif key in d:
            kw[name] = _t(d[key])
    return kw


_SPINARRAY_KEYS = (('T1', 'T1'), ('T2', 'T2'), ('γ', 'gam'), ('M', 'M'))


def pulse_from_numpy(d: dict, *, device=None, dtype=None) -> Pulse:
    r"""A :class:`Pulse` from ``mrphy_tpu`` ``Pulse.asdict()``."""
    return Pulse(_t(d['rf']), _t(d['gr']), dt=_t(d['dt']),
                 gmax=_t(d['gmax']), smax=_t(d['smax']),
                 rfmax=_t(d['rfmax']), desc=d.get('desc', 'generic pulse'),
                 device=device, dtype=_dtype(d, dtype))


def spinarray_from_numpy(d: dict, *, device=None, dtype=None) -> SpinArray:
    r"""A :class:`SpinArray` from ``mrphy_tpu`` ``SpinArray.asdict()``."""
    return SpinArray(tuple(d['shape']), np.asarray(d['mask']),
                     **_grid_or_compact(d, _SPINARRAY_KEYS),
                     device=device, dtype=_dtype(d, dtype))


def spincube_from_numpy(d: dict, *, device=None, dtype=None) -> SpinCube:
    r"""A :class:`SpinCube` from ``mrphy_tpu`` ``SpinCube.asdict()``
    (``loc_`` is rebuilt from ``fov`` and ``ofst``)."""
    return SpinCube(tuple(d['shape']), _t(d['fov']),
                    mask=np.asarray(d['mask']), ofst=_t(d['ofst']),
                    **_grid_or_compact(d, _SPINARRAY_KEYS + (('Δf', 'df'),)),
                    device=device, dtype=_dtype(d, dtype))


def spinbolus_from_numpy(d: dict, *, device=None, dtype=None) -> SpinBolus:
    r"""A :class:`SpinBolus` from ``mrphy_tpu`` ``SpinBolus.asdict()``."""
    kw = _grid_or_compact(d, _SPINARRAY_KEYS + (('vel', 'vel'),))
    return SpinBolus(tuple(d['shape']), np.asarray(d['mask']), **kw,
                     device=device, dtype=_dtype(d, dtype))
