r"""User-facing object model: ``Pulse``, ``SpinArray``, ``SpinCube``,
``SpinBolus``, ``Examples`` (counterpart of :mod:`mrphy_tpu.models.mobjs`).

Objects hold torch tensors on one device, given by the constructors'
``device=`` (default: the CPU), and move with ``.to(device=, dtype=)``.

- **Masked compact storage**: attributes are stored compact,
  ``(N, nM, ...)``, over a static boolean mask (host numpy) of the grid
  ``(N, *Nd, ...)``. The masked positions are kept as a ``torch.long``
  index on the object's device, so ``embed``/``extract`` are a gather
  and a scatter there; ``embed`` fills NaN outside the mask.
- Assignment through the grid name (``obj.T1 = grid``) extracts into the
  compact attribute (``obj.T1_``), as in the reference.
- Unicode attribute/keyword aliases are accepted: ``γ``/``γ_`` ↔
  ``gam``/``gam_``, ``Δf``/``Δf_`` ↔ ``df``/``df_``.

``Pulse.interpT`` and ``SpinArray.acquire`` are not ported yet.
"""

import numpy as np
import torch

from mrphy_tpu_torch import (gamH, dt0, gmax0, smax0, rfmax0, T1G, T2G, pi)
from mrphy_tpu_torch.ops import beffective, sims
from mrphy_tpu_torch.utils import ctrsub

__all__ = ['Pulse', 'SpinArray', 'SpinCube', 'SpinBolus', 'Examples']

# Unicode → ASCII attribute-name normalization (reference spellings)
_UNI2ASCII = {'γ': 'gam', 'γ_': 'gam_', 'Δf': 'df', 'Δf_': 'df_'}


def _norm_name(k: str) -> str:
    return _UNI2ASCII.get(k, k)


def _tonp(x, toNumpy: bool):
    x = x.detach()
    return x.cpu().numpy() if toNumpy else x


def _pop_df(kw):
    r"""Pop ``df``/``Δf`` and ``df_``/``Δf_`` from ``kw``; reject the rest."""
    df = _pop_alias(kw, 'Δf', kw.pop('df', None), 'df')
    df_ = _pop_alias(kw, 'Δf_', kw.pop('df_', None), 'df_')
    if kw:
        raise TypeError(f'unknown kwargs: {sorted(kw)}')
    if df is not None and df_ is not None:
        raise ValueError('pass df or df_, not both')
    return df, df_


def _pop_alias(kw, alias, value, name):
    r"""``value``, or the Unicode keyword ``alias`` popped from ``kw``."""
    if alias not in kw:
        return value
    if value is not None:
        raise TypeError(f"got both '{alias}' and '{name}'")
    return kw.pop(alias)


def _either(obj, grid, compact, name):
    r"""Compact form of a grid-xor-compact keyword pair."""
    if grid is not None and compact is not None:
        raise ValueError(f'pass {name} or {name}_, not both')
    return compact if grid is None else obj.extract(grid)


# ==========================================================================
# Pulse
# ==========================================================================

class Pulse:
    r"""RF + gradient pulse container.

    Usage:
        ``pulse = Pulse(rf, gr, *, dt, gmax, smax, rfmax, desc, device,``
        `` dtype)``

    Inputs:
        - ``rf``: `(N, xy, nT, (nCoils))`, "Gauss"; x: real, y: imag.
        - ``gr``: `(N, xyz, nT)`, "Gauss/cm".
        - ``dt``: `()` ⊻ `(N ⊻ 1,)`, "Sec", dwell time.
        - ``gmax``/``smax``: `()` ⊻ `(N ⊻ 1, xyz ⊻ 1)`, limits.
        - ``rfmax``: `()` ⊻ `(N ⊻ 1, (nCoils))`, "Gauss".
        - ``desc``: str description.
        - ``device``: torch device (default: that of a tensor ``rf``/``gr``,
          else the CPU).
        - ``dtype``: torch dtype (default: inferred from ``rf``/``gr``,
          falling back to float32).
    """

    _readonly = ('shape', 'dtype', 'device', 'is_cuda')
    __slots__ = ('rf', 'gr', 'dt', 'gmax', 'smax', 'rfmax', 'desc', '_dtype',
                 '_device')

    def __init__(self, rf=None, gr=None, *, dt=dt0, gmax=gmax0, smax=smax0,
                 rfmax=rfmax0, desc: str = 'generic pulse',
                 device=None, dtype=None):
        if rf is None and gr is None:
            raise ValueError('Missing both `rf` and `gr` inputs')
        given = [torch.as_tensor(x) for x in (rf, gr) if x is not None]
        if dtype is None:
            cands = [x.dtype for x in given if x.is_floating_point()]
            dtype = cands[0] if cands else torch.float32
            for c in cands[1:]:
                dtype = torch.promote_types(dtype, c)
        if device is None:
            device = given[0].device
        object.__setattr__(self, '_dtype', dtype)
        object.__setattr__(self, '_device', torch.device(device))

        if rf is None:
            gr = self._cast(gr)
            rf = torch.zeros((gr.shape[0], 2, gr.shape[2]), dtype=dtype,
                             device=self._device)
        elif gr is None:
            rf = self._cast(rf)
            gr = torch.zeros((rf.shape[0], 3, rf.shape[2]), dtype=dtype,
                             device=self._device)

        self.rf, self.gr = rf, gr
        self.dt, self.gmax, self.smax, self.rfmax = dt, gmax, smax, rfmax
        self.desc = desc

    def _cast(self, v):
        return torch.as_tensor(v, dtype=self._dtype, device=self._device)

    def __setattr__(self, k, v):
        if k in self._readonly:
            raise AttributeError(f"'Pulse' attribute '{k}' is read-only")
        if k == 'desc':
            object.__setattr__(self, k, v)
            return
        v = self._cast(v)
        if k in ('rf', 'gr'):
            cur = getattr(self, 'gr' if k == 'rf' else 'rf', None)
            if cur is not None and (v.shape[0] != cur.shape[0]
                                    or v.shape[2] != cur.shape[2]):
                raise ValueError(f'{k} shape {tuple(v.shape)} inconsistent '
                                 f'with {tuple(cur.shape)}')
        elif k in ('gmax', 'smax'):  # → (N ⊻ 1, xyz)
            if v.ndim == 0:
                v = v[None, None]
            elif v.ndim == 1:
                v = v[None, :] if v.shape[0] == 3 else v[:, None]
            v = v.expand(v.shape[0], 3)
        elif k == 'rfmax':  # → (N ⊻ 1, (nCoils))
            if v.ndim == 0:
                v = v[None]
            elif v.ndim == 2 and v.shape[1] == 1:
                v = v[:, 0]
        elif k == 'dt':
            if v.ndim == 0:
                v = v[None]
            if v.ndim != 1:
                raise ValueError(f'dt must be scalar or 1-d, got '
                                 f'{tuple(v.shape)}')
        object.__setattr__(self, k, v)

    def __getattr__(self, k):
        raise AttributeError(f"'Pulse' has no attribute '{k}'")

    # -- properties --
    @property
    def shape(self):
        return (self.rf.shape[0], 1, self.rf.shape[2])

    @property
    def dtype(self):
        return self._dtype

    @property
    def device(self):
        return self._device

    @property
    def is_cuda(self):
        return self._device.type == 'cuda'

    def __repr__(self):
        N, _, nT = self.shape
        return (f'Pulse(N={N}, nT={nT}, dtype={self.dtype}, '
                f'device={self.device}, desc={self.desc!r})')

    # -- methods --
    def asdict(self, *, toNumpy: bool = True) -> dict:
        r"""Detached dict of the object."""
        keys = ('rf', 'gr', 'dt', 'gmax', 'smax', 'rfmax')
        d = {k: _tonp(getattr(self, k), toNumpy) for k in keys}
        d.update(desc=self.desc, device=self.device, dtype=self.dtype)
        return d

    def beff(self, loc, *, gam=gamH, **kw):
        r"""B-effective at ``loc`` from this pulse.

        Optionals: ``df`` (alias ``Δf``): `(N, *Nd)`, "Hz"; ``b1Map``:
        `(N, *Nd, xy, (nCoils))`; ``gam`` (alias ``γ``).
        Outputs: ``beff``: `(N, *Nd, nT, xyz)`.
        """
        return beffective.rfgr2beff(self.rf, self.gr, loc, gam=gam, **kw)

    def to(self, *, device=None, dtype=None) -> 'Pulse':
        r"""Copy with new dtype and/or device (``self`` if neither
        changes)."""
        dtype = self.dtype if dtype is None else dtype
        device = self.device if device is None else torch.device(device)
        if dtype == self.dtype and device == self.device:
            return self
        return Pulse(self.rf, self.gr, dt=self.dt, gmax=self.gmax,
                     smax=self.smax, rfmax=self.rfmax, desc=self.desc,
                     device=device, dtype=dtype)


# ==========================================================================
# SpinArray
# ==========================================================================

class SpinArray:
    r"""Batched spin ensemble over a (statically) masked grid.

    Usage:
        ``spinarray = SpinArray(shape, mask, *, T1(_), T2(_), γ(_)/gam(_),``
        `` M(_), device, dtype)``

    Inputs:
        - ``shape``: tuple ``(N, *Nd)``.
    Optionals:
        - ``mask``: `(1, *Nd)` bool (host numpy); compact attributes hold
          only the ``nM = mask.sum()`` masked locations.
        - ``T1`` ⊻ ``T1_``, ``T2`` ⊻ ``T2_``, ``gam`` ⊻ ``gam_`` (aliases
          ``γ``/``γ_``), ``M`` ⊻ ``M_``: grid `(N, *Nd, ...)` or compact
          `(N, nM, ...)` attributes.
        - ``device``: torch device of every tensor (default: the CPU).

    Properties: ``shape``, ``mask``, ``ndim``, ``nM``, ``dtype``,
    ``device``; compact ``T1_, T2_, gam_, M_``; grid views via plain names
    (``obj.T1`` embeds).
    """

    _readonly = ('shape', 'mask', 'device', 'dtype', 'is_cuda', 'ndim',
                 'nM')
    _compact = ('T1_', 'T2_', 'gam_', 'M_')
    __slots__ = ('T1_', 'T2_', 'gam_', 'M_', '_shape', '_mask', '_midx',
                 '_dtype', '_device')

    def __init__(self, shape: tuple, mask=None, *,
                 T1=None, T1_=None, T2=None, T2_=None,
                 gam=None, gam_=None, M=None, M_=None,
                 device=None, dtype=torch.float32, **kw):
        gam = _pop_alias(kw, 'γ', gam, 'gam')
        gam_ = _pop_alias(kw, 'γ_', gam_, 'gam_')
        if kw:
            raise TypeError(f'unknown kwargs: {sorted(kw)}')

        shape = tuple(int(s) for s in shape)
        if mask is None:
            mask = np.ones((1,) + shape[1:], dtype=bool)
        mask = np.asarray(mask)
        if mask.dtype != np.bool_ or mask.shape != (1,) + shape[1:]:
            raise ValueError(f'mask must be bool of shape {(1,) + shape[1:]}')
        device = torch.device('cpu' if device is None else device)

        object.__setattr__(self, '_shape', shape)
        object.__setattr__(self, '_mask', mask)
        object.__setattr__(self, '_dtype', dtype)
        object.__setattr__(self, '_device', device)
        object.__setattr__(self, '_midx', torch.as_tensor(
            np.flatnonzero(mask[0].reshape(-1)), dtype=torch.long,
            device=device))

        for name, grid, compact, default in (
                ('T1', T1, T1_, T1G), ('T2', T2, T2_, T2G),
                ('gam', gam, gam_, gamH),
                ('M', M, M_, torch.tensor([0., 0., 1.]))):
            if grid is not None and compact is not None:
                raise ValueError(f'pass {name} or {name}_, not both')
            if grid is None:
                setattr(self, name + '_',
                        default if compact is None else compact)
            else:
                setattr(self, name, grid)

    # -- static properties --
    @property
    def shape(self):
        return self._shape

    @property
    def mask(self):
        return self._mask

    @property
    def ndim(self):
        return len(self._shape)

    @property
    def nM(self):
        return int(self._midx.numel())

    @property
    def dtype(self):
        return self._dtype

    @property
    def device(self):
        return self._device

    @property
    def is_cuda(self):
        return self._device.type == 'cuda'

    # -- attribute semantics --
    def __getattr__(self, k):
        k = _norm_name(k)
        if k in self._compact:  # unicode alias of a compact slot (γ_ → gam_)
            return object.__getattribute__(self, k)
        if k + '_' not in self._compact:
            raise AttributeError(f"'{type(self).__name__}' has no "
                                 f"attribute '{k}'")
        v_ = getattr(self, k + '_')
        if self.nM == int(np.prod(self.shape[1:])):
            return v_.reshape(self.shape + tuple(v_.shape[2:]))
        return self.embed(v_)

    def __setattr__(self, k_, v_):
        k_ = _norm_name(k_)
        if k_ in self._readonly:
            raise AttributeError(f"'SpinArray' attribute '{k_}' is read-only")
        if k_ in SpinArray.__slots__ and k_ not in self._compact:
            raise AttributeError(f"'{k_}' is internal")

        v_ = torch.as_tensor(v_, dtype=self._dtype, device=self._device)
        shape = self._shape
        vec3 = ('M_', 'vel_')  # (N, nM, xyz)-shaped compact attributes
        if k_ + '_' in self._compact:  # non-compact assignment → extract
            k_ = k_ + '_'
            tgt = shape + ((3,) if k_ in vec3 else ())
            v_ = self.extract(v_.expand(tgt))

        if k_ in vec3:
            v_ = v_.expand(shape[0], self.nM, 3)
        elif k_ in self._compact:  # (T1_, T2_, gam_)
            v_ = v_.expand(shape[0], self.nM)
        object.__setattr__(self, k_, v_)

    # -- embed/extract --
    def embed(self, v_, *, fill=float('nan')):
        r"""Compact `(N, nM, ...)` → grid `(N, *Nd, ...)`, ``fill`` outside
        the mask (NaN like the reference)."""
        v_ = torch.as_tensor(v_)
        N, tail = self.shape[0], tuple(v_.shape[2:])
        nS = int(np.prod(self.shape[1:]))
        flat = torch.full((N, nS) + tail, fill, dtype=v_.dtype,
                          device=v_.device)
        flat = flat.index_copy(1, self._midx.to(v_.device),
                               v_.expand((N,) + tuple(v_.shape[1:])))
        return flat.reshape(self.shape + tail)

    def extract(self, v):
        r"""Grid `(N, *Nd, ...)` → compact `(N, nM, ...)`."""
        v = torch.as_tensor(v)
        tail = tuple(v.shape[self.ndim:])
        nS = int(np.prod(self.shape[1:]))
        return v.reshape((v.shape[0], nS) + tail).index_select(
            1, self._midx.to(v.device))

    def crds_(self, crds: list) -> list:
        r"""Map grid indices to compact-attribute indices:
        ``v_[crds_] == v[crds]`` (grid positions outside the mask are
        dropped)."""
        ndim, nM = self.ndim, self.nM
        if len(crds) < ndim:
            raise ValueError(f'need at least {ndim} index entries')
        crds_ = [crds[0]] + [crds[i] for i in range(ndim, len(crds))]
        m = np.full(self.mask.shape, -1, dtype=np.int64)
        m[self.mask] = np.arange(nM)
        inds_ = [i for i in np.asarray(m[tuple([[0]] + list(crds[1:ndim]))]
                                       ).reshape(-1).tolist() if i != -1]
        crds_.insert(1, inds_)
        return crds_

    def mask_(self, *, mask) -> np.ndarray:
        r"""Compact form `(1, nM)` of an external grid ``mask``
        `(1, *Nd)`."""
        mask = np.asarray(mask)
        return mask[self.mask].reshape(1, -1)

    # -- physics methods --
    def applypulse(self, pulse: Pulse, *, doEmbed: bool = False,
                   doRelax: bool = True, doUpdate: bool = False,
                   doFuse: bool = True, mesh=None,
                   loc=None, loc_=None, b1Map=None, b1Map_=None, **kw):
        r"""Apply a pulse through the fast engine.

        Inputs:
            - ``pulse``: :class:`Pulse`.
            - ``loc`` ⊻ ``loc_``: `(N, *Nd ⊻ nM, xyz)`, "cm".
        Optionals:
            - ``doEmbed``: return grid ``M`` instead of compact ``M_``.
            - ``doRelax``: include T1/T2 relaxation.
            - ``doUpdate``: assign the result to ``self.M_``.
            - ``doFuse``: assemble B-effective inside the time loop
              (``sims.blochsim_rfgr``, kernel ``rfgr_fwd``). ``False``
              composes ``pulse2beff`` → ``sims.blochsim`` (kernel
              ``beff_fwd``) like the reference.
            - ``mesh``: not ported yet (raises).
            - ``df`` ⊻ ``df_`` (aliases ``Δf``/``Δf_``): `(N, *Nd ⊻ nM)`.
            - ``b1Map`` ⊻ ``b1Map_``: `(N, *Nd ⊻ nM, xy, (nCoils))`.
        """
        df, df_ = _pop_df(kw)
        if (loc_ is None) == (loc is None):
            raise ValueError('need loc xor loc_')
        loc_ = _either(self, loc, loc_, 'loc')
        df_ = _either(self, df, df_, 'df')
        b1Map_ = _either(self, b1Map, b1Map_, 'b1Map')
        if mesh is not None:
            raise NotImplementedError('mesh= is not ported yet')

        T1, T2 = (self.T1_, self.T2_) if doRelax else (None, None)
        pulse = pulse.to(device=self.device, dtype=self.dtype)
        if doFuse:
            M_ = sims.blochsim_rfgr(self.M_, pulse.rf, pulse.gr, loc_,
                                    T1=T1, T2=T2, df=df_, b1Map=b1Map_,
                                    gam=self.gam_, dt=pulse.dt,
                                    vel=self._vel())
        else:
            beff_ = self.pulse2beff(pulse, loc_=loc_, df_=df_,
                                    b1Map_=b1Map_, doEmbed=False)
            M_ = sims.blochsim(self.M_, beff_, T1=T1, T2=T2,
                               gam=self.gam_, dt=pulse.dt)
        if doUpdate:
            self.M_ = M_
        return self.embed(M_) if doEmbed else M_

    def _vel(self):
        r"""Per-spin velocities for the fused engine: none, the spins of a
        plain array stand still."""
        return None

    def freeprec(self, dur, *, doEmbed: bool = False, doRelax: bool = True,
                 doUpdate: bool = False, **kw):
        r"""Free precession for duration ``dur``.

        Optionals: ``df`` ⊻ ``df_`` (aliases ``Δf``/``Δf_``).
        """
        df, df_ = _pop_df(kw)
        df_ = _either(self, df, df_, 'df')
        T1, T2 = (self.T1_, self.T2_) if doRelax else (None, None)
        M_ = sims.freeprec(self.M_, dur, T1=T1, T2=T2, df=df_)
        if doUpdate:
            self.M_ = M_
        return self.embed(M_) if doEmbed else M_

    def pulse2beff(self, pulse: Pulse, *, doEmbed: bool = False,
                   loc=None, loc_=None, b1Map=None, b1Map_=None, **kw):
        r"""B-effective of ``pulse`` under this array's γ."""
        df, df_ = _pop_df(kw)
        if (loc_ is None) == (loc is None):
            raise ValueError('need loc xor loc_')
        loc_ = _either(self, loc, loc_, 'loc')
        df_ = _either(self, df, df_, 'df')
        b1Map_ = _either(self, b1Map, b1Map_, 'b1Map')
        pulse = pulse.to(device=self.device, dtype=self.dtype)
        beff_ = pulse.beff(loc_, gam=self.gam_, df=df_, b1Map=b1Map_)
        return self.embed(beff_) if doEmbed else beff_

    # -- bookkeeping --
    def asdict(self, *, toNumpy: bool = True, doEmbed: bool = True) -> dict:
        r"""Detached dict; keys use the reference's Unicode spellings
        (``γ``/``γ_``)."""
        keys = (('T1', 'T2', 'γ', 'M') if doEmbed else
                ('T1_', 'T2_', 'γ_', 'M_'))
        d = {k: _tonp(getattr(self, k), toNumpy) for k in keys}
        d['mask'] = self.mask.copy()
        d.update(shape=self.shape, device=self.device, dtype=self.dtype)
        return d

    def dim(self) -> int:
        return len(self.shape)

    def numel(self) -> int:
        return int(self.mask.size)

    def size(self) -> tuple:
        return self.shape

    def to(self, *, device=None, dtype=None) -> 'SpinArray':
        r"""Copy with new dtype and/or device (``self`` if neither
        changes)."""
        dtype = self.dtype if dtype is None else dtype
        device = self.device if device is None else torch.device(device)
        if dtype == self.dtype and device == self.device:
            return self
        return SpinArray(self.shape, self.mask, T1_=self.T1_, T2_=self.T2_,
                         gam_=self.gam_, M_=self.M_, device=device,
                         dtype=dtype)

    def __repr__(self):
        return (f'{type(self).__name__}(shape={self.shape}, nM={self.nM}, '
                f'dtype={self.dtype}, device={self.device})')


# ==========================================================================
# SpinCube
# ==========================================================================

class SpinCube(SpinArray):
    r"""``SpinArray`` + geometry: FOV/offset-derived locations and an
    off-resonance map.

    Usage:
        ``SpinCube(shape, fov, *, mask, ofst, Δf(_)/df(_), T1(_), T2(_),``
        `` γ(_)/gam(_), M(_), device, dtype)``

    Properties: ``spinarray``, ``fov`` `(N, xyz)`, ``ofst`` `(N, xyz)`,
    ``df_``/``Δf_`` `(N, nM)`, derived read-only ``loc_`` `(N, nM, xyz)`
    recomputed whenever ``fov``/``ofst`` are set. A ``spinarray``
    attribute holds the base object; unknown attributes forward to it.
    """

    _readonly = ('spinarray', 'loc_')
    _compact = ('df_', 'loc_')
    __slots__ = ('_spinarray', 'fov', 'ofst', 'df_', 'loc_')

    def __init__(self, shape: tuple, fov, *, mask=None, ofst=None,
                 df=None, df_=None, T1=None, T1_=None, T2=None, T2_=None,
                 gam=None, gam_=None, M=None, M_=None,
                 device=None, dtype=torch.float32, **kw):
        df = _pop_alias(kw, 'Δf', df, 'df')
        df_ = _pop_alias(kw, 'Δf_', df_, 'df_')
        gam = _pop_alias(kw, 'γ', gam, 'gam')
        gam_ = _pop_alias(kw, 'γ_', gam_, 'gam_')
        if kw:
            raise TypeError(f'unknown kwargs: {sorted(kw)}')

        sp = SpinArray(shape, mask, T1=T1, T1_=T1_, T2=T2, T2_=T2_,
                       gam=gam, gam_=gam_, M=M, M_=M_, device=device,
                       dtype=dtype)
        object.__setattr__(self, '_spinarray', sp)

        if ofst is None:
            ofst = torch.zeros((1, 3))
        for k, v in (('fov', fov), ('ofst', ofst)):
            v = torch.as_tensor(v, dtype=sp.dtype, device=sp.device)
            if v.ndim != 2:
                raise ValueError(f'{k} must be (N, xyz), got {tuple(v.shape)}')
            object.__setattr__(self, k, v)
        self._update_loc_()

        if df is not None and df_ is not None:
            raise ValueError('pass df or df_, not both')
        if df is None:
            self.df_ = 0.0 if df_ is None else df_
        else:
            self.df = df

    @property
    def spinarray(self) -> SpinArray:
        return self._spinarray

    def __getattr__(self, k):
        k = _norm_name(k)
        if k in SpinCube._compact:  # unicode alias of a compact slot
            return object.__getattribute__(self, k)
        if k + '_' not in SpinCube._compact:
            sp = object.__getattribute__(self, '_spinarray')
            return getattr(sp, k)
        v_, sp = getattr(self, k + '_'), self._spinarray
        if sp.nM == int(np.prod(sp.shape[1:])):
            return v_.reshape(sp.shape + tuple(v_.shape[2:]))
        return sp.embed(v_)

    def __setattr__(self, k_, v_):
        k_ = _norm_name(k_)
        if (k_ in SpinCube._readonly) or (k_ + '_' in SpinCube._readonly):
            raise AttributeError(f"'SpinCube' attribute '{k_}' is read-only")

        sp = self._spinarray
        if k_ in SpinArray._compact or k_ + '_' in SpinArray._compact:
            setattr(sp, k_, v_)
            return

        v_ = torch.as_tensor(v_, dtype=sp.dtype, device=sp.device)
        if k_ == 'df':  # grid assignment → extract
            k_, v_ = 'df_', sp.extract(v_.expand(sp.shape))
        if k_ == 'df_':
            v_ = v_.expand(sp.shape[0], sp.nM)
        elif k_ in ('fov', 'ofst') and v_.ndim != 2:
            raise ValueError(f'{k_} must be (N, xyz), got {tuple(v_.shape)}')
        object.__setattr__(self, k_, v_)

        if k_ in ('fov', 'ofst'):
            self._update_loc_()

    def _update_loc_(self):
        r"""Recompute ``loc_`` from FOV and offset: normalized grid
        coordinates ``(arange(n) - ctrsub(n)) / n`` scaled by FOV."""
        sp = self._spinarray
        crdn = [(np.arange(n) - ctrsub(n)) / n for n in sp.shape[1:]]
        locn = np.meshgrid(*crdn, indexing='ij')
        locn_ = np.stack([ln[sp.mask[0]] for ln in locn], axis=-1)  # (nM,xyz)
        locn_ = torch.as_tensor(locn_, dtype=sp.dtype, device=sp.device)
        loc_ = self.fov[:, None, :] * locn_[None] + self.ofst[:, None, :]
        object.__setattr__(self, 'loc_', loc_)

    # -- physics methods (inject loc_, df_) --
    def applypulse(self, pulse: Pulse, *, doEmbed: bool = False,
                   doRelax: bool = True, doUpdate: bool = False,
                   doFuse: bool = True, mesh=None, b1Map=None,
                   b1Map_=None):
        r"""Apply a pulse at the cube's own ``loc_`` and ``Δf_``; flags
        as :meth:`SpinArray.applypulse`."""
        sp = self._spinarray
        b1Map_ = _either(sp, b1Map, b1Map_, 'b1Map')
        return sp.applypulse(pulse, doEmbed=doEmbed, doRelax=doRelax,
                             doUpdate=doUpdate, doFuse=doFuse, mesh=mesh,
                             df_=self.df_, loc_=self.loc_, b1Map_=b1Map_)

    def freeprec(self, dur, *, doEmbed: bool = False, doRelax: bool = True,
                 doUpdate: bool = False):
        return self._spinarray.freeprec(dur, df_=self.df_, doEmbed=doEmbed,
                                        doRelax=doRelax, doUpdate=doUpdate)

    def pulse2beff(self, pulse: Pulse, *, doEmbed: bool = False,
                   b1Map=None, b1Map_=None):
        return self._spinarray.pulse2beff(pulse, loc_=self.loc_,
                                          doEmbed=doEmbed, df_=self.df_,
                                          b1Map=b1Map, b1Map_=b1Map_)

    def asdict(self, *, toNumpy: bool = True, doEmbed: bool = True) -> dict:
        keys = ('loc', 'Δf') if doEmbed else ('loc_', 'Δf_')
        d = {k: _tonp(getattr(self, k), toNumpy) for k in keys}
        d.update(fov=_tonp(self.fov, toNumpy), ofst=_tonp(self.ofst, toNumpy))
        d.update(self._spinarray.asdict(toNumpy=toNumpy, doEmbed=doEmbed))
        return d

    def to(self, *, device=None, dtype=None) -> 'SpinCube':
        dtype = self.dtype if dtype is None else dtype
        device = self.device if device is None else torch.device(device)
        if dtype == self.dtype and device == self.device:
            return self
        return SpinCube(self.shape, self.fov, mask=self.mask, ofst=self.ofst,
                        df_=self.df_, T1_=self.T1_, T2_=self.T2_,
                        gam_=self.gam_, M_=self.M_, device=device,
                        dtype=dtype)


class SpinBolus(SpinArray):
    r"""Flowing spin ensemble: a :class:`SpinArray` whose spins move with
    per-spin velocities during the pulse (fused engine only: locations
    evolve as ``loc + vel·t`` inside the time loop).

    Usage:
        ``SpinBolus(shape, mask, *, vel(_), T1(_), T2(_), γ(_), M(_),``
        `` device, dtype)``

    Extra properties:
        - ``vel_``: `(N, nM, xyz)`, "cm/s", per-spin velocity (grid form
          ``vel`` embeds/extracts like every other attribute).
    """

    _compact = SpinArray._compact + ('vel_',)
    __slots__ = ('vel_',)

    def __init__(self, shape: tuple, mask=None, *, vel=None, vel_=None,
                 **kw):
        super().__init__(shape, mask, **kw)
        if vel is not None and vel_ is not None:
            raise ValueError('pass vel or vel_, not both')
        if vel is None:
            self.vel_ = torch.zeros(3) if vel_ is None else vel_
        else:
            self.vel = vel

    def applypulse(self, pulse: Pulse, *, doFuse: bool = True, **kw):
        r"""Apply a pulse to the flowing ensemble (``loc``/``loc_`` are
        the spins' positions at t=0). Same flags and ⊻-kwargs as
        :meth:`SpinArray.applypulse`, except that ``doFuse=False`` is
        rejected (flow runs on the fused engine only)."""
        if not doFuse:
            raise ValueError('SpinBolus flow requires the fused engine')
        return super().applypulse(pulse, **kw)

    def _vel(self):
        return self.vel_

    def asdict(self, *, toNumpy: bool = True, doEmbed: bool = True) -> dict:
        d = super().asdict(toNumpy=toNumpy, doEmbed=doEmbed)
        k = 'vel' if doEmbed else 'vel_'
        d[k] = _tonp(getattr(self, k), toNumpy)
        return d

    def to(self, *, device=None, dtype=None) -> 'SpinBolus':
        dtype = self.dtype if dtype is None else dtype
        device = self.device if device is None else torch.device(device)
        if dtype == self.dtype and device == self.device:
            return self
        return SpinBolus(self.shape, self.mask, vel_=self.vel_,
                         T1_=self.T1_, T2_=self.T2_, gam_=self.gam_,
                         M_=self.M_, device=device, dtype=dtype)


# ==========================================================================
# Examples
# ==========================================================================

class Examples:
    r"""Canonical demo objects (the same as :class:`mrphy_tpu.models.mobjs
    .Examples`)."""

    @staticmethod
    def pulse(dtype=torch.float32, device=None) -> Pulse:
        r"""512-step cos/sin RF + atan gradient demo pulse."""
        N, nT = 1, 512
        t = torch.arange(nT, dtype=dtype, device=device).reshape((N, 1, nT))
        rf = 10 * torch.cat([torch.cos(t / nT * 2 * pi),
                             torch.sin(t / nT * 2 * pi)], dim=1)
        one = torch.ones((N, 1, nT), dtype=dtype, device=device)
        gr = torch.cat([one, one, 10 * torch.atan(t - round(nT / 2)) / pi],
                       dim=1)
        return Pulse(rf=rf, gr=gr, dt=dt0, device=device, dtype=dtype)

    @staticmethod
    def _cross_mask(Nd=(3, 3, 3)) -> np.ndarray:
        mask = np.zeros((1,) + Nd, dtype=bool)
        mask[0, :, 1, :] = True
        mask[0, 1, :, :] = True
        return mask

    @staticmethod
    def spinarray(dtype=torch.float32, device=None) -> SpinArray:
        r"""3×3×3 cross-masked spin array."""
        return SpinArray((1, 3, 3, 3), mask=Examples._cross_mask(),
                         T1_=[[1.]], T2_=[[4e-2]], gam_=gamH, device=device,
                         dtype=dtype)

    @staticmethod
    def spinbolus(dtype=torch.float32, device=None) -> SpinBolus:
        r"""3x3x3 cross-masked bolus flowing at 10 cm/s along z."""
        return SpinBolus((1, 3, 3, 3), mask=Examples._cross_mask(),
                         vel=[0., 0., 10.], T1_=[[1.]], T2_=[[4e-2]],
                         gam_=gamH, device=device, dtype=dtype)

    @staticmethod
    def spincube(dtype=torch.float32, device=None) -> SpinCube:
        r"""3×3×3 cross-masked cube, fov=[3,3,3], ofst=[0,0,1], Δf ∝ -x-y."""
        cube = SpinCube((1, 3, 3, 3), [[3., 3., 3.]],
                        mask=Examples._cross_mask(), ofst=[[0., 0., 1.]],
                        T1_=[[1.]], T2_=[[4e-2]], gam_=gamH, device=device,
                        dtype=dtype)
        cube.df_ = torch.sum(-cube.loc_[..., 0:2], dim=-1) * cube.gam_
        return cube
