r"""Build the port's objects from :mod:`mrphy_tpu` state held as numpy.

The ``*_from_numpy`` object builders take the dict that the JAX object's
``asdict(toNumpy=True)`` returns (grid form, the default, or compact
form with ``doEmbed=False``; the dict carries the static ``mask``) and
return the matching :mod:`mrphy_tpu_torch.models.mobjs` object on
``device`` (default: the CUDA card, as the objects' own default) in
``dtype`` (default: the dict's own dtype). Grid-form
attributes are NaN outside the mask; building through the grid names
extracts the masked values, so both forms give the same object.

The design state carries across too: :func:`design_params_from_numpy`
takes the JAX ``design.init_params`` dict, :func:`adam_state_from_numpy`
optax's Adam state, so a design run in JAX can continue in the port;
:func:`nufftplan_from_numpy` a gridding plan's attributes, so both
packages can run on one plan; and :func:`basis_from_numpy` an MRF
compression basis (its singular vectors' signs are free, so two packages
compare compression and matching on one basis).

No JAX is needed: the values only pass through :func:`numpy.asarray`.
"""

import numpy as np
import torch

from mrphy_tpu_torch import default_device
from mrphy_tpu_torch.models.mobjs import (Pulse, SpinArray, SpinBolus,
                                          SpinCube)
from mrphy_tpu_torch.ops.mrf import Basis
from mrphy_tpu_torch.ops.nufft import NufftPlan

__all__ = ['pulse_from_numpy', 'spinarray_from_numpy', 'spincube_from_numpy',
           'spinbolus_from_numpy', 'design_params_from_numpy',
           'adam_state_from_numpy', 'nufftplan_from_numpy',
           'basis_from_numpy']


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
                 device=default_device(device), dtype=_dtype(d, dtype))


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


def design_params_from_numpy(d: dict, *, device=None, dtype=None) -> dict:
    r"""The port's design variables (leaf tensors that require grad, for
    :func:`mrphy_tpu_torch.design.design_step`) from a JAX
    ``design.init_params`` dict ``{'trho', 'theta', 'ts'}`` of arrays, on
    ``device`` (default: the CUDA card)."""
    device = default_device(device)
    return {k: torch.tensor(np.asarray(v), dtype=dtype,
                            device=device).requires_grad_()
            for k, v in d.items()}


def _adam_leaf(state):
    r"""The ``ScaleByAdamState`` (fields ``count``, ``mu``, ``nu``) inside
    an optax state (a chain's state is a tuple of its transforms')."""
    if all(hasattr(state, f) for f in ('count', 'mu', 'nu')):
        return state
    if isinstance(state, (tuple, list)):
        for s in state:
            found = _adam_leaf(s)
            if found is not None:
                return found
    return None


def adam_state_from_numpy(opt_state, params: dict) -> dict:
    r"""``torch.optim.Adam`` state from optax's Adam state.

    ``opt_state``: the state of ``optax.adam`` (or of a chain holding
    ``scale_by_adam``) with its arrays as numpy, e.g. through
    ``jax.tree.map(np.asarray, ...)``. ``params``: the port's design
    variables, keyed as optax's ``mu``/``nu``. Returns the per-parameter
    state (``step``, ``exp_avg``, ``exp_avg_sq``) to put into an Adam
    optimizer over ``params``: ``opt.state.update(...)``.
    """
    st = _adam_leaf(opt_state)
    if st is None:
        raise ValueError('no optax Adam state (count, mu, nu) in opt_state')
    step = float(np.asarray(st.count))

    def like(v, p):
        return torch.tensor(np.asarray(v), dtype=p.dtype, device=p.device)

    return {p: {'step': torch.tensor(step, dtype=torch.float32),
                'exp_avg': like(st.mu[k], p),
                'exp_avg_sq': like(st.nu[k], p)}
            for k, p in params.items()}


def nufftplan_from_numpy(d: dict, *, device=None, dtype=None) -> NufftPlan:
    r"""The port's :class:`~mrphy_tpu_torch.ops.nufft.NufftPlan` from a
    ``mrphy_tpu`` plan's attributes: ``d`` holds ``im_size``,
    ``grid_size``, ``fov``, ``width``, ``beta`` and ``deapod`` (numpy),
    e.g. ``{k: getattr(plan, k) for k in (...)}``. ``deapod`` goes to
    ``device`` (default: the CUDA card) in ``dtype`` (default: its own).
    The route is the port's ``interp='auto'`` (the JAX plan's TPU
    strategy does not carry over)."""
    deapod = np.asarray(d['deapod'])
    return NufftPlan(tuple(d['im_size']), tuple(d['grid_size']),
                     tuple(np.asarray(d['fov'], np.float64).reshape(-1)),
                     d['width'], d['beta'],
                     torch.tensor(deapod, dtype=_dtype(
                         {'dtype': deapod.dtype}, dtype),
                         device=default_device(device)))


def basis_from_numpy(b, *, device=None, dtype=None) -> Basis:
    r"""The port's :class:`~mrphy_tpu_torch.ops.mrf.Basis` from a
    ``mrphy_tpu`` ``Basis`` (or anything with its fields ``B``, ``jc``,
    ``s`` and ``tail``): the arrays go to ``device`` (default: the CUDA
    card) in ``dtype`` (default: their own)."""
    dev = default_device(device)

    def arr(v):
        if v is None:
            return None
        v = np.asarray(v)
        return torch.tensor(v, dtype=_dtype({'dtype': v.dtype}, dtype),
                            device=dev)

    return Basis(B=arr(b.B), jc=arr(b.jc), s=arr(b.s),
                 tail=tuple(int(n) for n in b.tail))
