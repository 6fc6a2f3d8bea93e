r"""Gradient-system impulse response (GIRF) modeling (counterpart of
:mod:`mrphy_tpu.utils.girf`).

What the spins see is the commanded gradient convolved with the gradient
chain's impulse response. :func:`mrphy_tpu_torch.design.design_pulse`
designs through it (``girf_=``), so the designed waveform pre-compensates
the hardware. The convolution is an FFT product, differentiable.
"""

import numpy as np
import torch

__all__ = ['apply_girf', 'exp_decay_girf']


def apply_girf(gr, girf, *, axis_dim: int = 1):
    r"""Causally convolve gradients with per-axis impulse responses.

    Inputs:
        - ``gr``: `(N, 3, nT)`, commanded gradients, "Gauss/cm".
        - ``girf``: `(3, nH)` ⊻ `(nH,)` per-axis (or shared) discrete
          impulse response at the dwell time of ``gr`` (identity:
          ``[1, 0, 0, ...]``).
        - ``axis_dim``: accepted for the JAX package's signature and has no
          effect (the JAX package does not use it either).
    Outputs:
        - `(N, 3, nT)`, the played gradients: ``out[..., t] =
          Σ_k girf[k]·gr[..., t-k]`` (the tail beyond nT is dropped).
    """
    gr = torch.as_tensor(gr)
    h = torch.as_tensor(girf, dtype=gr.dtype, device=gr.device)
    if h.ndim == 1:
        h = h.expand(3, h.shape[-1])
    if h.ndim != 2 or h.shape[0] != 3:
        raise ValueError(f'girf must be (3, nH) or (nH,), got '
                         f'{tuple(h.shape)}')
    nT, nH = gr.shape[-1], h.shape[-1]
    # the next power of two ≥ nT + nH − 1: no wrap-around, the JAX
    # package's length
    Lf = 1 << (nT + nH - 2).bit_length()
    G = torch.fft.rfft(gr, n=Lf, dim=-1)
    H = torch.fft.rfft(h, n=Lf, dim=-1)             # (3, Lf//2+1)
    return torch.fft.irfft(G * H, n=Lf, dim=-1)[..., :nT].to(gr.dtype)


def exp_decay_girf(nH: int, dt: float, *, delay_samples: int = 0,
                   amps=(), taus=(), dtype=np.float64):
    r"""A canonical gradient-chain impulse response: a (possibly delayed)
    passthrough minus exponential eddy-current terms,

    ``h[t] = δ[t - delay] - Σ_i amps[i]·(dt/taus[i])·exp(-t·dt/taus[i])``

    for `t ≥ delay`, normalized to unit DC gain. Returns a `(nH,)` numpy
    array (pass it to :func:`apply_girf`).
    """
    if len(amps) != len(taus):
        raise ValueError('amps and taus must have equal lengths')
    h = np.zeros(nH, dtype)
    h[delay_samples] = 1.0
    t = np.arange(nH - delay_samples, dtype=dtype) * dt
    for a, tau in zip(amps, taus):
        h[delay_samples:] -= a * (dt / tau) * np.exp(-t / tau)
    return h / h.sum()
