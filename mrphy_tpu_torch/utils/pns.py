r"""Peripheral-nerve-stimulation (PNS) prediction for gradient waveforms,
the chronaxie convolution model (counterpart of :mod:`mrphy_tpu.utils.pns`;
Schulte & Noeske, MRM 68(5):1664, 2012).

Each axis's signed slew rate is convolved with the nerve impulse response
``h(u) = c / (c + u)²`` (chronaxie ``c``) and normalized by the axis
rheobase slew ``smin``; ``PNS(t) = ‖PNS_xyz(t)‖₂`` in %, e.g. limited to
80% (normal mode). The taps are the exact per-dwell integrals of ``h``,
truncated where the remaining tail mass drops below ``tail`` and
rescaled to unit sum. Everything is differentiable, so PNS can be a
design penalty (``DesignConfig.lam_pns``).
"""

from typing import Tuple

import numpy as np
import torch

from mrphy_tpu_torch import dt0

__all__ = ['pns_kernel', 'pns_predict', 'pns_max']

CHRONAXIE0 = 334e-6                    # Sec
SMIN0 = (6000.0, 6000.0, 6000.0)       # Gauss/cm/s, rheobase slew per axis


def _scalar_dt(dt) -> float:
    if torch.is_tensor(dt):
        dt = dt.detach().cpu()
    dt_all = np.asarray(dt, np.float64).reshape(-1)
    if dt_all.size != 1 and np.ptp(dt_all) != 0.0:
        raise ValueError(f'PNS needs one dwell time, got {dt_all}')
    return float(dt_all[0])


def pns_kernel(dt, *, chronaxie: float = CHRONAXIE0, tail: float = 0.01):
    r"""Discrete nerve impulse-response taps `(K,)`, float64, summing to
    exactly 1. ``dt`` is one dwell time (a number, or a tensor whose
    entries are all equal)."""
    c = float(chronaxie)
    dt = _scalar_dt(dt)
    # mass covered by K taps = 1 − c/(c + K·dt)  ⇒  K for 1 − tail
    K = int(np.ceil((c / tail - c) / dt))
    k = np.arange(K, dtype=np.float64)
    h = c * (1.0 / (c + k * dt) - 1.0 / (c + (k + 1) * dt))
    return torch.as_tensor(h / h.sum())


def pns_predict(gr, dt=dt0, *, smin: Tuple[float, ...] = SMIN0,
                chronaxie: float = CHRONAXIE0, tail: float = 0.01):
    r"""Predicted PNS level over time.

    Inputs:
        - ``gr``: `(N, xyz, nT)`, "Gauss/cm".
        - ``dt``: `()`, "Sec", dwell.
    Optionals: ``smin`` per-axis rheobase slew, "Gauss/cm/s";
        ``chronaxie``, "Sec"; ``tail``, the kernel's truncated mass.
    Outputs:
        - ``pns``: `(N, nT)`, "%": the ``‖·‖₂`` over axes of the filtered
          signed slew.

    The causal convolution is a ``conv1d`` with TF32 off (cuDNN would
    otherwise run a float32 convolution in TF32 on the card).
    """
    gr = torch.as_tensor(gr)
    N, nax, nT = gr.shape
    dt = _scalar_dt(dt)
    s = torch.diff(gr, dim=-1, prepend=gr[..., :1]) / dt    # signed slew
    h = pns_kernel(dt, chronaxie=chronaxie, tail=tail).to(gr)
    K = h.shape[0]
    x = torch.nn.functional.pad(s.reshape(N * nax, 1, nT), (K - 1, 0))
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        f = torch.nn.functional.conv1d(x, h.flip(0)[None, None])
    w = 100.0 / torch.as_tensor(smin, dtype=gr.dtype,
                                device=gr.device).reshape(1, nax, 1)
    return torch.sqrt(torch.clamp_min(((w * f.reshape(N, nax, nT)) ** 2)
                                      .sum(1), 1e-30))


def pns_max(gr, dt=dt0, **kw):
    r"""Peak predicted PNS, `(N,)` "%"; ``< 80`` is the usual
    normal-operating-mode criterion."""
    return pns_predict(gr, dt, **kw).amax(-1)
