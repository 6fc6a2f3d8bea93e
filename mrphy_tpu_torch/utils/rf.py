r"""RF waveform converters, clamps, and constrained reparametrizations
(counterpart of :mod:`mrphy_tpu.utils.rf`).

- complex ↔ real: :func:`rf_c2r` / :func:`rf_r2c`, on torch complex
  tensors (the JAX package falls back to numpy there, for TPU runtimes
  without complex dtypes);
- the magnitude clamp :func:`rfclamp`;
- two bounded ↔ unbounded bijections for unconstrained optimization over
  peak-limited RF: tan-based :func:`rf2trho_theta` / :func:`trho_theta2rf`
  and logit-based :func:`rf2lrho_theta` / :func:`lrho_theta2rf`.

``rfmax`` is `()` ⊻ `(N, (nCoils))`, "Gauss", a number or a tensor; it is
used in the dtype and on the device of the waveform.
"""

import torch

from mrphy_tpu_torch import pi
from mrphy_tpu_torch.utils._shapes import asarr

__all__ = ['rf_c2r', 'rf_r2c', 'rf2trho_theta', 'trho_theta2rf',
           'rf2lrho_theta', 'lrho_theta2rf', 'rfclamp']


def rf_c2r(rf):
    r"""Complex RF `(N, 1, nT, (nCoils))` → real RF `(N, xy, nT,
    (nCoils))` (x: real, y: imaginary part)."""
    rf = torch.as_tensor(rf)
    return torch.cat((rf.real, rf.imag), dim=1)


def rf_r2c(rf):
    r"""Real RF `(N, xy, nT, (nCoils))` → complex RF `(N, 1, nT,
    (nCoils))`."""
    rf = torch.as_tensor(rf)
    return torch.complex(rf[:, 0:1], rf[:, 1:2])


def _rfmax_bcast(rfmax, like):
    r"""``rfmax``: `()` ⊻ `(N, (nCoils))` → `(N ⊻ 1, 1, 1, (nCoils))`."""
    rfmax = asarr(rfmax, like)
    if rfmax.ndim == 0:
        rfmax = rfmax[None]
    return rfmax[:, None, None, ...]


def _norm_xy(rf):
    return torch.linalg.vector_norm(rf, dim=1, keepdim=True)


def _phase(rf):
    return torch.atan2(rf[:, 1:2], rf[:, 0:1])


def rf2trho_theta(rf, rfmax):
    r"""Real RF → (tρ ≔ tan(ρ/rfmax·π/2), θ): unbounded design variables.

    Inputs: ``rf`` `(N, xy, nT, (nCoils))`, "Gauss", |rf| < rfmax;
    ``rfmax``. Outputs: ``trho`` ∈ [0, +∞) and ``theta`` ∈ [−π, π], both
    `(N, 1, nT, (nCoils))`.
    """
    rf = torch.as_tensor(rf)
    trho = torch.tan(_norm_xy(rf) / _rfmax_bcast(rfmax, rf) * pi / 2)
    return trho, _phase(rf)


def trho_theta2rf(trho, theta, rfmax):
    r"""(tρ, θ) → real RF `(N, xy, nT, (nCoils))`, |rf| < rfmax (inverse
    of :func:`rf2trho_theta`)."""
    trho, theta = torch.as_tensor(trho), torch.as_tensor(theta)
    rho = torch.atan(trho) / pi * 2 * _rfmax_bcast(rfmax, trho)
    return rho * torch.cat((torch.cos(theta), torch.sin(theta)), dim=1)


def rf2lrho_theta(rf, rfmax, *, eps=1e-7):
    r"""Real RF → (lρ ≔ logit(ρ/rfmax), θ), the ratio clipped to
    ``[eps, 1 − eps]``. Outputs `(N, 1, nT, (nCoils))`."""
    rf = torch.as_tensor(rf)
    p = torch.clamp(_norm_xy(rf) / _rfmax_bcast(rfmax, rf), eps, 1 - eps)
    return torch.log(p) - torch.log1p(-p), _phase(rf)


def lrho_theta2rf(lrho, theta, rfmax):
    r"""(lρ, θ) → real RF (inverse of :func:`rf2lrho_theta`)."""
    lrho, theta = torch.as_tensor(lrho), torch.as_tensor(theta)
    rho = torch.sigmoid(lrho) * _rfmax_bcast(rfmax, lrho)
    return rho * torch.cat((torch.cos(theta), torch.sin(theta)), dim=1)


def rfclamp(rf, rfmax, *, eps=1e-7):
    r"""Clamp the RF magnitude ‖rf‖₂ (over xy) to ``rfmax − eps``."""
    rf = torch.as_tensor(rf)
    scale = torch.clamp_max((_rfmax_bcast(rfmax, rf) - eps) / _norm_xy(rf),
                            1.0)
    return rf * scale
