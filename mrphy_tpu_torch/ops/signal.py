r"""k-space signal acquisition (encoding) and its adjoint (counterpart of
:mod:`mrphy_tpu.ops.signal`).

Closed-form receiver model for a readout: from the transverse
magnetization a simulator produced, each spin accrues phase under the
readout gradients (the k-space trajectory), its own off-resonance and T2*
decay, and the coil signal is the sensitivity-weighted sum

.. math::
   s_c(t) = \sum_m \mathrm{sens}_{c,m}\, m_{xy,m}\,
            e^{-t_t/T2^*_m}\, e^{-i 2\pi (k(t)\cdot x_m + \Delta f_m t_t)}

with ``t_t = (t+1)·dt``; :func:`signal_adjoint` is its exact linear adjoint
in the transverse magnetization (conjugate-phase back-projection, the
building block of CG-SENSE). Signs and layouts are the JAX package's:
signals are re/im pairs `(N, nC, nT, 2)`, receive maps `(N ⊻ 1, nM, 2,
nC)`.

Kernels (:mod:`mrphy_tpu_torch.kernels.signal`): ``sig_fwd`` for
:func:`signal`, ``sig_vjp`` for its gradient, ``sig_adj`` for
:func:`signal_adjoint`. ``backend='auto'`` launches them for CUDA tensors
and takes their plain PyTorch versions for CPU tensors; ``'cuda'`` insists
on the kernels (and raises for CPU tensors); ``'torch'`` runs the plain
versions on any device. ``chunk=`` sizes the plain versions' spin chunks
(the kernels ignore it).

:func:`signal` is differentiable w.r.t. ``M``, ``loc_``, ``ktraj``,
``sens``, ``df`` and ``T2s`` (Mz's gradient is exactly 0). One
``torch.autograd.Function`` serves both routes: its forward is
``sig_fwd``, its backward the VJP planes function ``sig_vjp`` (the kernel
on CUDA tensors, its plain version elsewhere), and it keeps only its
inputs, O(inputs) memory. The coil weighting ``w = sens·(Mx + i·My)``
and ``1/T2*`` are formed outside it, so autograd applies the ``sens``
product rule and the chain ``∂/∂T2* = −di2/T2*²`` there, as the JAX
package's Pallas VJP does by hand. :func:`signal_adjoint` is not
differentiable here (it raises if an input requires grad).
"""

from typing import Optional

import torch

from mrphy_tpu_torch import dt0
from mrphy_tpu_torch._kwalias import kwalias
from mrphy_tpu_torch.kernels import signal as ksig
from mrphy_tpu_torch.ops import sims
from mrphy_tpu_torch.utils._shapes import asarr, rshape

__all__ = ['signal', 'signal_adjoint', 'signal_planes']


def _per_spin(x, like, N, nM):
    r"""``()`` ⊻ `(N ⊻ 1, nM)` per-spin parameter → `(N ⊻ 1, nM)`
    contiguous, in ``like``'s dtype and device (None stays None)."""
    if x is None:
        return None
    x = rshape(asarr(x, like), 2)
    return x.expand(x.shape[0], nM).contiguous()


def _planes(loc_, ktraj, df, T2s, like, N, nM):
    r"""The kernels' per-spin and per-sample planes: ``pos (N ⊻ 1, 3,
    nM)``, ``df``, ``it2 = 1/T2s`` `(N ⊻ 1, nM)` (or None) and ``k (N ⊻
    1, 3, nT)``."""
    pos = asarr(loc_, like).transpose(1, 2).contiguous()
    k = asarr(ktraj, like).contiguous()
    for x, name in ((pos, 'loc_'), (k, 'ktraj')):
        if x.ndim != 3 or x.shape[0] not in (1, N) or x.shape[1] != 3:
            raise ValueError(f'{name} has shape {tuple(x.shape)}')
    if pos.shape[2] != nM:
        raise ValueError(f'loc_ holds {pos.shape[2]} spins, M holds {nM}')
    df = _per_spin(df, like, N, nM)
    T2s = _per_spin(T2s, like, N, nM)
    return pos, df, None if T2s is None else 1 / T2s, k


def _weights(M, sens):
    r"""Coil-weighted transverse magnetization ``w = sens·(Mx + i·My)``
    as rows ``w2 (N, 2nC, nM)`` = ``[w_re; w_im]`` (``sens=None``: one
    uniform coil)."""
    mx, my = M[..., 0], M[..., 1]                          # (N, nM)
    if sens is None:
        return torch.stack([mx, my], dim=1)
    sr, si = sens[..., 0, :], sens[..., 1, :]              # (N ⊻ 1, nM, nC)
    wr = sr * mx[..., None] - si * my[..., None]
    wi = sr * my[..., None] + si * mx[..., None]
    return torch.cat([wr, wi], dim=-1).transpose(1, 2).contiguous()


def signal_planes(M, loc_, ktraj, *, sens=None, df=None, T2s=None):
    r"""The ``sig_fwd``/``sig_vjp`` kernels' arguments ``(w2, pos, df, it2,
    k)`` for a :func:`signal` call on the same inputs (layout in
    :mod:`mrphy_tpu_torch.kernels.signal`)."""
    M, sens = _inputs(M, loc_, ktraj, sens)
    pos, df, it2, k = _planes(loc_, ktraj, df, T2s, M, M.shape[0],
                              M.shape[1])
    return _weights(M, sens), pos, df, it2, k


def _sum_to(g, x):
    r"""``g`` `(N, ...)` summed over the batch where ``x`` broadcasts."""
    if x is None or g is None:
        return None
    return g.sum(dim=0, keepdim=True) if x.shape[0] == 1 != g.shape[0] else g


class _Signal(torch.autograd.Function):

    @staticmethod
    def forward(ctx, plain, dt, chunk, w2, pos, df, it2, k):
        fwd = ksig.sig_fwd_torch if plain else ksig.sig_fwd
        U, V = fwd(w2, pos, df, it2, k, dt, chunk=chunk)
        nC = w2.shape[1] // 2
        ctx.plain, ctx.dt, ctx.chunk = plain, dt, chunk
        ctx.save_for_backward(w2, pos, df, it2, k)
        return torch.stack([U[:, :nC] - V[:, nC:], V[:, :nC] + U[:, nC:]],
                           dim=-1)

    @staticmethod
    def backward(ctx, gs):
        w2, pos, df, it2, k = ctx.saved_tensors
        g2 = torch.cat([gs[..., 0], gs[..., 1]], dim=1).contiguous()
        vjp = ksig.sig_vjp_torch if ctx.plain else ksig.sig_vjp
        XR, XS, dloc, dk, ddf, di2 = vjp(g2, w2, pos, df, it2, k, ctx.dt,
                                         chunk=ctx.chunk)
        nC = w2.shape[1] // 2
        dw2 = torch.cat([XR[:, :nC] + XS[:, nC:], XR[:, nC:] - XS[:, :nC]],
                        dim=1)
        # None for plain, dt and chunk: no gradient
        return (None, None, None, dw2, _sum_to(dloc, pos), _sum_to(ddf, df),
                _sum_to(di2, it2), _sum_to(dk, k))


def _plain(backend: str, x) -> bool:
    r"""True where ``backend`` resolves to the plain versions for tensors
    on ``x``'s device (the rule of :mod:`mrphy_tpu_torch.ops.sims`)."""
    return sims._check_common(None, None, 'reconstruct', backend,
                              torch.as_tensor(x)) != 'cuda'


def _inputs(M, loc_, ktraj, sens):
    M = torch.as_tensor(M)
    if M.dtype not in (torch.float32, torch.float64):
        M = M.to(torch.float32)
    dtype = torch.promote_types(M.dtype, torch.as_tensor(loc_).dtype)
    M = M.to(dtype)
    sens = None if sens is None else asarr(sens, M)
    return M, sens


@kwalias(**{'Δf': 'df'})
def signal(M, loc_, ktraj, *, sens=None, df=None, T2s=None, dt=dt0,
           chunk: Optional[int] = None, mesh=None, backend: str = 'auto'):
    r"""Acquired k-space signal of a spin ensemble over a readout.

    Inputs:
        - ``M``: `(N, nM, xyz)` spins at readout start (compact layout);
          only ``Mx``/``My`` contribute.
        - ``loc_``: `(N ⊻ 1, nM, xyz)`, "cm", spin locations.
        - ``ktraj``: `(N ⊻ 1, xyz, nT)`, "cycle/cm", Rx k-space
          (:func:`mrphy_tpu_torch.utils.g2k` of the readout gradient with
          ``isTx=False``).
    Optionals:
        - ``sens``: `(N ⊻ 1, nM, xy, nC)` receive sensitivities as re/im
          pairs; ``None`` ⇒ a single uniform coil.
        - ``df`` (alias ``Δf``): `()` ⊻ `(N ⊻ 1, nM)`, "Hz".
        - ``T2s``: `()` ⊻ `(N ⊻ 1, nM)`, "Sec", T2* decay; ``None`` ⇒
          no decay.
        - ``dt``: `()`, "Sec", dwell time.
        - ``chunk``: spins per chunk of the plain version (default: the
          ``(chunk, nT)`` factor matrices near 32 MB).
        - ``mesh``: multi-device runs are not ported yet (raises
          :class:`NotImplementedError`).
        - ``backend``: ``'auto'`` | ``'torch'`` | ``'cuda'``.
    Outputs:
        - ``s``: `(N, nC, nT, 2)` signal as re/im pairs.
    """
    if mesh is not None:
        raise NotImplementedError('mesh= (multi-device runs) is not ported '
                                  'to mrphy_tpu_torch yet')
    plain = _plain(backend, M)
    planes = signal_planes(M, loc_, ktraj, sens=sens, df=df, T2s=T2s)
    return _Signal.apply(plain, float(dt), chunk, *planes)


@kwalias(**{'Δf': 'df'})
def signal_adjoint(s, loc_, ktraj, *, sens=None, df=None, T2s=None,
                   dt=dt0, chunk: Optional[int] = None, mesh=None,
                   backend: str = 'auto'):
    r"""Exact adjoint of :func:`signal` in the transverse magnetization:
    the conjugate-phase, decay-weighted, coil-combined back-projection

    .. math::
       \hat m_{xy,m} = \sum_{c,t} \overline{\mathrm{sens}_{c,m}}\,
           e^{-t_t/T2^*_m}\, e^{+i 2\pi (k_t\cdot x_m + \Delta f_m t_t)}
           \, s_c(t)

    Inputs:
        - ``s``: `(N, nC, nT, 2)` signal (re/im).
        - ``loc_``/``ktraj`` and the optionals: as :func:`signal`.
    Outputs:
        - ``mxy``: `(N, nM, 2)` re/im back-projected transverse
          magnetization.
    """
    if mesh is not None:
        raise NotImplementedError('mesh= (multi-device runs) is not ported '
                                  'to mrphy_tpu_torch yet')
    s, sens = _inputs(s, loc_, ktraj, sens)
    if torch.is_grad_enabled() and any(
            torch.is_tensor(x) and x.requires_grad
            for x in (s, loc_, ktraj, sens, df, T2s)):
        raise NotImplementedError('signal_adjoint is not differentiable in '
                                  'mrphy_tpu_torch yet')
    N, nC = s.shape[0], s.shape[1]
    nM = torch.as_tensor(loc_).shape[1]
    plain = _plain(backend, s)
    pos, df, it2, k = _planes(loc_, ktraj, df, T2s, s, N, nM)
    s2 = torch.cat([s[..., 0], s[..., 1]], dim=1).contiguous()
    adj = ksig.sig_adj_torch if plain else ksig.sig_adj
    XR, XS = adj(s2, pos, df, it2, k, float(dt), chunk=chunk)
    xr = XR[:, :nC] + XS[:, nC:]                           # (N, nC, nM)
    xi = XR[:, nC:] - XS[:, :nC]
    if sens is None:
        mr, mi = xr[:, 0], xi[:, 0]
    else:
        cr = sens[..., 0, :].transpose(1, 2)               # (N ⊻ 1, nC, nM)
        ci = sens[..., 1, :].transpose(1, 2)
        mr = (cr * xr + ci * xi).sum(dim=1)
        mi = (cr * xi - ci * xr).sum(dim=1)
    return torch.stack([mr, mi], dim=-1)
