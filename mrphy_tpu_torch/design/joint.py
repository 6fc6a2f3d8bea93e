r"""Joint RF + gradient waveform design by gradient descent through the
Bloch simulator (counterpart of :mod:`mrphy_tpu.design.joint`).

- **Constrained → unconstrained**: RF is parametrized by ``(tρ, θ)``
  (:func:`mrphy_tpu_torch.utils.rf2trho_theta`) and gradients by the
  slew-rate variable ``ts`` (:func:`mrphy_tpu_torch.utils.s2ts`), so the
  limits ``rfmax`` and ``smax`` hold by construction.
- **One iteration**: params → waveforms → ``sims.blochsim_rfgr`` (kernel
  ``rfgr_fwd``; the gradient through kernel ``rfgr_bwd`` on the card) →
  loss → ``loss.backward()`` → a ``torch.optim`` step. The loop is plain
  Python; each iteration's loss is written, detached, into a tensor on
  the device, so the host never waits on the card inside the loop.
- **Multi-scale**: design at a coarse dwell time, resample with
  :meth:`~mrphy_tpu_torch.models.mobjs.Pulse.interpT`, continue.

The optimizers map optax's to ``torch.optim`` (:func:`make_optimizer`);
``adam``, ``adamw``, ``sgd`` and ``momentum`` take the same updates as
the JAX package, ``lbfgs`` a different line search.
"""

import dataclasses
from typing import Optional, Tuple

import torch

from mrphy_tpu_torch import dt0, gamH, gmax0, rfmax0, smax0
from mrphy_tpu_torch.ops import sims
from mrphy_tpu_torch.utils import (apply_girf, g2s, pns_predict,
                                   rf2trho_theta, rfclamp, s2g, s2ts,
                                   sar_vops, sclamp, trho_theta2rf, ts2s)

__all__ = ['DesignConfig', 'design_pulse', 'design_multiscale',
           'design_step', 'init_params', 'params2pulse', 'make_optimizer']

_OPTIMIZERS = ('adam', 'adamw', 'sgd', 'momentum', 'lbfgs')


@dataclasses.dataclass(frozen=True)
class DesignConfig:
    r"""Hyper-parameters of the joint design loop (the fields and defaults
    of :class:`mrphy_tpu.design.DesignConfig`).

    ``rfmax`` is a scalar RF peak limit, or a ``(nCoils,)`` tuple of
    per-coil limits. ``loss`` is ``'sse'`` (squared error on the
    magnetization vector) or ``'mls'`` (magnitude least squares: the
    transverse phase is free). ``optimizer`` is one of ``'adam'``
    (default), ``'adamw'``, ``'sgd'``, ``'momentum'`` (Nesterov 0.9) or
    ``'lbfgs'`` (strong-Wolfe line search; ``lr`` unused). The ``lam_*``
    weights switch on the penalties: RF power, peak-gradient excess over
    ``gmax``, local SAR over ``sar_limit`` and PNS over ``pns_limit``.
    """
    niter: int = 100
    lr: float = 1e-1
    optimizer: str = 'adam'
    loss: str = 'sse'         # 'sse' ⊻ 'mls' (magnitude least squares)
    rfmax: object = rfmax0    # Gauss; float ⊻ (nCoils,) tuple
    smax: float = smax0       # Gauss/cm/Sec
    gmax: float = gmax0       # Gauss/cm (soft, via lam_gmax)
    dt: float = dt0           # Sec
    lam_pow: float = 0.0      # RF power penalty weight
    lam_gmax: float = 0.0     # peak-gradient excess penalty weight
    lam_sar: float = 0.0      # local-SAR (VOP) excess penalty weight
    sar_limit: float = 0.0    # per-VOP time-averaged SAR limit
    lam_pns: float = 0.0      # PNS excess penalty weight
    pns_limit: float = 80.0   # %, normal operating mode
    pns_smin: tuple = (6000.0, 6000.0, 6000.0)  # Gauss/cm/s rheobase
    pns_chronaxie: float = 334e-6               # Sec
    gam: float = gamH


def make_optimizer(cfg: DesignConfig, params) -> torch.optim.Optimizer:
    r"""The ``torch.optim`` optimizer named by ``cfg.optimizer`` over
    ``params`` (the dict of :func:`init_params`, or an iterable of
    tensors):

    - ``adam``: ``Adam(lr)``, optax's update (``eps`` outside the sqrt);
    - ``adamw``: ``AdamW(lr, weight_decay=1e-4)``, optax's default decay;
    - ``sgd``: ``SGD(lr)``;
    - ``momentum``: ``SGD(lr, momentum=0.9, nesterov=True)``, optax's
      Nesterov trace;
    - ``lbfgs``: ``LBFGS(lr=1, history_size=10, max_iter=1,
      line_search_fn='strong_wolfe')``, one L-BFGS step per iteration
      whose line search re-runs the simulation (optax's is a zoom line
      search, so the two take different steps); :func:`design_step`
      restarts its memory after a step that moved nothing.
    """
    ps = list(params.values()) if isinstance(params, dict) else list(params)
    name = cfg.optimizer
    if name == 'adam':
        return torch.optim.Adam(ps, lr=cfg.lr)
    if name == 'adamw':
        return torch.optim.AdamW(ps, lr=cfg.lr, weight_decay=1e-4)
    if name == 'sgd':
        return torch.optim.SGD(ps, lr=cfg.lr)
    if name == 'momentum':
        return torch.optim.SGD(ps, lr=cfg.lr, momentum=0.9, nesterov=True)
    if name == 'lbfgs':
        return torch.optim.LBFGS(ps, lr=1, history_size=10, max_iter=1,
                                 line_search_fn='strong_wolfe')
    raise ValueError(f'cfg.optimizer={name!r}; expected one of '
                     f'{", ".join(map(repr, _OPTIMIZERS))}')


def _rfmax_arr(cfg: DesignConfig, like: torch.Tensor) -> torch.Tensor:
    r"""``cfg.rfmax`` as the `()` ⊻ `(1, nCoils)` tensor the rf utils take
    (a tuple holds per-coil limits, broadcast over the batch)."""
    rfmax = torch.as_tensor(cfg.rfmax, dtype=like.dtype, device=like.device)
    return rfmax[None, :] if rfmax.ndim == 1 else rfmax


def init_params(rf, gr, cfg: DesignConfig) -> dict:
    r"""Initial (clamped) waveforms → the unbounded design variables, a
    dict ``{'trho', 'theta', 'ts'}`` of leaf tensors that require
    grad."""
    with torch.no_grad():
        rfmax = _rfmax_arr(cfg, rf)
        rf = rfclamp(rf, rfmax)
        s = sclamp(g2s(gr, cfg.dt), cfg.smax * (1 - 1e-6))
        trho, theta = rf2trho_theta(rf, rfmax)
        params = {'trho': trho, 'theta': theta, 'ts': s2ts(s, cfg.smax)}
    return {k: v.detach().clone().requires_grad_() for k, v in
            params.items()}


def params2pulse(params: dict,
                 cfg: DesignConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    r"""Unbounded design variables → ``(rf, gr)`` within rfmax/smax."""
    rf = trho_theta2rf(params['trho'], params['theta'],
                       _rfmax_arr(cfg, params['trho']))
    return rf, s2g(ts2s(params['ts'], cfg.smax), cfg.dt)


def _loss_fn(params, cfg, M0_, loc_, Mtgt_, T1_, T2_, gam_, df_, b1Map_,
             w_, girf_, sarQr_, sarQi_, doRelax: bool):
    r"""The design loss and the simulated ``M_``; the terms of JAX's
    ``_loss_fn``."""
    rf, gr = params2pulse(params, cfg)
    if girf_ is not None:
        # design through the gradient chain: simulate what the hardware
        # plays, so the optimizer pre-compensates it
        gr = apply_girf(gr, girf_)
    T1, T2 = (T1_, T2_) if doRelax else (None, None)
    M_ = sims.blochsim_rfgr(M0_, rf, gr, loc_, T1=T1, T2=T2, df=df_,
                            b1Map=b1Map_, gam=gam_, dt=cfg.dt)
    if cfg.loss == 'mls':
        # magnitude least squares; the smooth sqrt keeps the gradient
        # finite where |Mxy| → 0
        eps = 1e-12
        mag = torch.sqrt(M_[..., 0] ** 2 + M_[..., 1] ** 2 + eps)
        mtg = torch.sqrt(Mtgt_[..., 0] ** 2 + Mtgt_[..., 1] ** 2 + eps)
        se = (mag - mtg) ** 2 + (M_[..., 2] - Mtgt_[..., 2]) ** 2
    elif cfg.loss == 'sse':
        se = torch.sum((M_ - Mtgt_) ** 2, dim=-1)
    else:
        raise ValueError(f"cfg.loss={cfg.loss!r}; expected 'sse' or 'mls'")
    if w_ is None:
        err = torch.mean(se)
    else:
        # broadcast BEFORE normalizing: with w_ (1, nM) and N > 1 a bare
        # sum(w_) would undercount by N
        wb = w_.expand(se.shape)
        err = torch.sum(wb * se) / torch.sum(wb)
    pen = cfg.lam_pow * torch.mean(torch.sum(rf ** 2, dim=1))
    if cfg.lam_gmax:
        # soft peak-gradient limit (hinge²): ts bounds the slew, not |g|
        excess = torch.relu(torch.abs(gr) - cfg.gmax)
        pen = pen + cfg.lam_gmax * torch.mean(torch.sum(excess ** 2, dim=1))
    if sarQr_ is not None:
        sar_ex = torch.relu(sar_vops(rf, sarQr_, sarQi_) - cfg.sar_limit)
        pen = pen + cfg.lam_sar * torch.mean(torch.sum(sar_ex ** 2, dim=-1))
    if cfg.lam_pns:
        pns = pns_predict(gr, cfg.dt, smin=cfg.pns_smin,
                          chronaxie=cfg.pns_chronaxie)    # (N, nT), %
        pns_ex = torch.relu(pns - cfg.pns_limit)
        pen = pen + cfg.lam_pns * torch.mean(torch.sum(pns_ex ** 2, dim=-1))
    return err + pen, M_


def design_step(params, optimizer, cfg, *args):
    r"""One optimization step: the loss and its gradient through the
    Bloch simulation, then ``optimizer.step``. ``args``: ``M0_, loc_,
    Mtgt_, T1_, T2_, gam_, df_, b1Map_, w_, girf_, sarQr_, sarQi_,
    doRelax``. Returns ``(loss, M_)`` at the parameters before the step,
    detached."""
    first = []

    def closure():
        optimizer.zero_grad()
        loss, M_ = _loss_fn(params, cfg, *args)
        loss.backward()
        if not first:
            first.append((loss.detach(), M_.detach()))
        return loss

    if cfg.optimizer == 'lbfgs':
        # the line search re-evaluates the loss through the simulation
        optimizer.step(closure)
        state = optimizer.state[optimizer.param_groups[0]['params'][0]]
        if not state.get('t'):
            # no step taken (the quasi-Newton direction was no descent
            # direction, or the line search found no decrease): restart
            # from steepest descent, else every later call repeats it
            optimizer.state.clear()
    else:
        closure()
        optimizer.step()
    return first[0]


def _as(x, like):
    r"""``x`` as a tensor on ``like``'s device (None stays None)."""
    return None if x is None else torch.as_tensor(x, device=like.device)


def design_pulse(spinarray, pulse, Mtgt_, *, loc_=None, df_=None,
                 b1Map_=None, w_=None, girf_=None, sarQ_=None,
                 cfg: Optional[DesignConfig] = None, doRelax: bool = True,
                 verbose: bool = False, mesh=None, checkpoint=None):
    r"""Jointly design RF + gradients steering ``spinarray`` to ``Mtgt_``.

    Inputs:
        - ``spinarray``: :class:`~mrphy_tpu_torch.models.mobjs.SpinArray`
          or :class:`~mrphy_tpu_torch.models.mobjs.SpinCube` (supplies
          ``M_``, ``T1_``, ``T2_``, ``gam_``; a cube also ``loc_``/``df_``).
        - ``pulse``: the initial :class:`~mrphy_tpu_torch.models.mobjs.Pulse`.
        - ``Mtgt_``: `(N, nM, xyz)`, the target magnetization (compact).
    Optionals:
        - ``loc_``/``df_``/``b1Map_``: compact fields, as for
          ``applypulse``.
        - ``w_``: `(N ⊻ 1, nM)`, per-spin loss weights, normalized by their
          sum (0 for don't-care spins).
        - ``girf_``: `(3, nH)` ⊻ `(nH,)`, the gradient chain's impulse
          response; the loss simulates ``apply_girf(gr, girf_)``.
        - ``sarQ_``: VOP matrices ``Qr`` `(nVOP, nCoils, nCoils)` ⊻ a
          ``(Qr, Qi)`` pair, penalized with ``cfg.lam_sar``.
        - ``cfg``: :class:`DesignConfig` (default: the pulse's dwell time).
        - ``verbose``: print the loss every ``niter // 10`` iterations.
        - ``mesh``, ``checkpoint``: not ported yet (raise
          :class:`NotImplementedError`).
    Outputs:
        - ``(pulse, losses)``: the designed Pulse (on the spin array's
          device, in ``pulse``'s dtype) and the `(niter,)` losses, a
          tensor on that device.
    """
    from mrphy_tpu_torch.models.mobjs import Pulse
    if checkpoint is not None:
        raise NotImplementedError('checkpoint= (design/checkpoint.py) is '
                                  'not ported to mrphy_tpu_torch yet')
    if mesh is not None:
        raise NotImplementedError('mesh= (multi-device design) is not '
                                  'ported to mrphy_tpu_torch yet')
    pulse = pulse.to(device=spinarray.device)
    if cfg is None:
        cfg = DesignConfig(dt=float(pulse.dt.reshape(-1)[0]))
    if loc_ is None:
        loc_ = spinarray.loc_
    if df_ is None:
        df_ = getattr(spinarray, 'df_', None)
    if sarQ_ is None:
        sarQr_ = sarQi_ = None
    elif isinstance(sarQ_, (tuple, list)):
        sarQr_, sarQi_ = sarQ_
    else:
        sarQr_, sarQi_ = sarQ_, None
    M0_ = spinarray.M_
    args = (M0_, _as(loc_, M0_), _as(Mtgt_, M0_), spinarray.T1_,
            spinarray.T2_, spinarray.gam_, _as(df_, M0_), _as(b1Map_, M0_),
            _as(w_, M0_), _as(girf_, M0_), _as(sarQr_, M0_),
            _as(sarQi_, M0_), doRelax)

    params = init_params(pulse.rf, pulse.gr, cfg)
    optimizer = make_optimizer(cfg, params)
    losses = None
    for it in range(cfg.niter):
        loss, _ = design_step(params, optimizer, cfg, *args)
        if losses is None:
            losses = loss.new_empty(cfg.niter)
        losses[it] = loss
        if verbose and it % max(1, cfg.niter // 10) == 0:
            print(f'iter {it:4d}  loss {float(loss):.6e}')

    with torch.no_grad():
        rf, gr = params2pulse(params, cfg)
        out = Pulse(rf, gr, dt=cfg.dt, rfmax=_rfmax_arr(cfg, rf),
                    smax=cfg.smax, gmax=cfg.gmax,
                    desc=f'{pulse.desc} + designed({cfg.niter} iters)',
                    device=pulse.device, dtype=pulse.dtype)
    if losses is None:
        losses = torch.empty(0, dtype=pulse.dtype, device=pulse.device)
    return out, losses


def design_multiscale(spinarray, pulse, Mtgt_, *, dts, niters,
                      cfg: Optional[DesignConfig] = None, **kw):
    r"""Coarse-to-fine joint design in one call: design at dwell time
    ``dts[0]`` for ``niters[0]`` iterations, resample the result to
    ``dts[1]`` with :meth:`~mrphy_tpu_torch.models.mobjs.Pulse.interpT`,
    continue, and so on. ``cfg`` is the base :class:`DesignConfig`, each
    stage overriding its ``dt``/``niter``; other keywords go to
    :func:`design_pulse`. Returns the final Pulse and the list of the
    stages' loss tensors. The pulse's dwell time must be uniform."""
    if len(dts) != len(niters) or not dts:
        raise ValueError('dts and niters must be non-empty, equal lengths')
    cfg = DesignConfig() if cfg is None else cfg
    p, losses = pulse, []
    for dt_s, ni in zip(dts, niters):
        dt_s = float(dt_s)
        dt_all = p.dt.reshape(-1)
        # the resampling decision is global; differing per-batch dwell
        # times would be mishandled
        if float(dt_all.max() - dt_all.min()) != 0.0:
            raise ValueError('design_multiscale requires a scalar/uniform '
                             f'pulse dt, got {dt_all.tolist()}')
        if abs(float(dt_all[0]) - dt_s) > 1e-12:
            p = p.interpT(dt_s)
        cfg_s = dataclasses.replace(cfg, dt=dt_s, niter=int(ni))
        p, loss = design_pulse(spinarray, p, Mtgt_, cfg=cfg_s, **kw)
        losses.append(loss)
    return p, losses
