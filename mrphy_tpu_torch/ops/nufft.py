r"""Gridding NUFFT (types 1/2) and the Toeplitz normal operator
(counterpart of :mod:`mrphy_tpu.ops.nufft`).

:mod:`mrphy_tpu_torch.ops.signal` is the exact encoding operator, O(nM·nT)
per application; this module is its fast companion for grid-resident
magnetization (a :class:`~mrphy_tpu_torch.models.mobjs.SpinCube`): the
Kaiser–Bessel gridding NUFFT [Beatty et al., IEEE TMI 24(6):799, 2005;
Fessler & Sutton, IEEE TSP 51(2):560, 2003], O(G^d log G + nT·W^d), and the
Toeplitz embedding of the normal operator ``AᴴA`` [Fessler et al., IEEE
TSP 53(9):3393, 2005]. Conventions are the JAX package's: spin locations
``x_j = fov·(j − n//2)/n``, ``ktraj`` in "cycle/cm", samples
``s(t) = Σ_j img_j e^{−i2π k(t)·x_j}``; images `(n_1, …, n_d, 2)`,
trajectories `(d, nT)` and samples `(nT, 2)` as re/im pairs.

- **Grid stage**: ``torch.fft``. The centred factor
  ``e^{−i2π m (p − n//2)/G}`` is the FFT of the zero-padded image with
  pixel p placed at ``(p − n//2) mod G``; the adjoint is the unnormalised
  inverse FFT followed by the crop; the deapodization ``1/Φ`` multiplies
  the image on both sides. On the card cuFFT runs in the image's own
  float32 or float64 (no TF32 is involved).
- **Interpolation**: the kernels of :mod:`mrphy_tpu_torch.kernels.nufft`
  (``nufft_sample`` for :func:`nufft`, ``nufft_spread`` for
  :func:`nufft_adjoint`, ``nufft_dk`` for trajectory gradients), wrapped in
  autograd Functions whose backwards are each other's stage. The plan's
  ``interp`` picks the route: ``'gather'`` runs the plain PyTorch versions
  on any device; every other value (``'auto'``, and ``'matmul'`` and
  ``'pallas'``, accepted for parity with JAX's assertions) launches the
  kernels for CUDA tensors and runs the plain versions for CPU tensors.
- **Gradients** w.r.t. the image, the samples, the trajectory, ``df`` and
  ``T2s`` (the last two through the segment weights, by autograd).
- **Batching**: ``img`` `(N, n…, 2)` / ``s`` `(N, nT, 2)` with ``ktraj``
  `(N ⊻ 1, d, nT)` (or `(d, nT)`, shared) stand for the ``jax.vmap`` the
  JAX examples wrap around each call (coils, shots, segments).
- **Toeplitz**: :func:`toeplitz_kernel` computes the exact PSF by chunked
  products (float32 in full float32), :func:`toeplitz_apply` convolves on
  the 2n grid through ``torch.fft``.

``mesh=`` (sample-sharded runs) is not ported yet (slice 16).
"""

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from mrphy_tpu_torch import default_device, pi
from mrphy_tpu_torch.kernels import nufft as knf
from mrphy_tpu_torch.kernels.signal import full_f32_matmul

__all__ = ['NufftPlan', 'nufft_plan', 'nufft', 'nufft_adjoint',
           'dcf_pipe_menon', 'toeplitz_kernel', 'toeplitz_apply']


def _kb_ft(xi, width: int, beta: float):
    r"""Continuous Fourier transform of the (I₀(β)-normalized) KB kernel
    at reduced frequency ``xi = (p − ctr)/G`` (host numpy, plan build):
    ``Φ(ξ) = W·sinh(√(β²−(πWξ)²)) / (I₀(β)·√(β²−(πWξ)²))``, sin past the
    mainlobe edge."""
    xi = np.asarray(xi, np.float64)
    a2 = beta ** 2 - (np.pi * width * xi) ** 2
    r = np.sqrt(np.abs(a2))
    r = np.where(r < 1e-12, 1e-12, r)
    val = np.where(a2 >= 0, np.sinh(r) / r, np.sin(r) / r)
    return width * val / np.i0(beta)


class NufftPlan:
    r"""A gridding plan: the scalar geometry and the deapodization.

    Attrs:
        - ``im_size``: `(n_1, …, n_d)` image grid.
        - ``grid_size``: `(G_1, …, G_d)`, ``G = ceil(osf·n)`` rounded up
          to even.
        - ``fov``: `(d,)` floats, "cm".
        - ``width``, ``beta``: kernel taps per axis and KB shape.
        - ``deapod``: `(n_1, …, n_d)` tensor, the separable ``1/Φ`` image
          weights, on the plan's device.
        - ``interp``: the interpolation route (see the module docstring).
    """

    def __init__(self, im_size, grid_size, fov, width, beta, deapod,
                 interp: str = 'auto'):
        self.im_size = tuple(int(n) for n in im_size)
        self.grid_size = tuple(int(g) for g in grid_size)
        self.fov = tuple(float(f) for f in fov)
        self.width = int(width)
        self.beta = float(beta)
        self.deapod = deapod
        self.interp = str(interp)

    @property
    def ndim(self) -> int:
        return len(self.im_size)

    @property
    def geom(self) -> knf.Geom:
        return knf.Geom(self.im_size, self.grid_size, self.fov, self.width,
                        self.beta)

    def __repr__(self):
        return (f'NufftPlan(im_size={self.im_size}, '
                f'grid_size={self.grid_size}, fov={self.fov}, '
                f'width={self.width}, beta={self.beta:.3f}, '
                f'interp={self.interp!r})')


def nufft_plan(im_size: Sequence[int], fov, *, osf: float = 2.0,
               width: int = 4, beta: Optional[float] = None,
               dtype=torch.float32, interp: str = 'auto',
               device=None) -> NufftPlan:
    r"""Build a gridding plan for a ``len(im_size)``-dim image grid.

    Inputs:
        - ``im_size``: `(n_1, …, n_d)` grid shape (the SpinCube shape,
          singleton axes dropped).
        - ``fov``: `(d,)`, "cm".
    Optionals:
        - ``osf``: grid oversampling σ (default 2.0).
        - ``width``: kernel taps W per axis (4 → ~1e-3 relative accuracy,
          6 → ~1e-5; the kernels take 2..8).
        - ``beta``: KB shape (default: Beatty's
          ``β = π√(W²/σ²·(σ−½)² − 0.8)``).
        - ``dtype``: dtype of ``deapod``.
        - ``interp``: ``'auto'`` | ``'gather'`` | ``'matmul'`` (d ≤ 2) |
          ``'pallas'`` (d = 3); see the module docstring.
        - ``device``: the plan's device (default: the CUDA card; raises
          without one).
    """
    device = default_device(device)
    im_size = tuple(int(n) for n in im_size)
    fov = tuple(float(f) for f in
                torch.as_tensor(fov, dtype=torch.float64).reshape(-1).tolist())
    d = len(im_size)
    assert len(fov) == d, (im_size, fov)
    assert all(n >= 2 for n in im_size), im_size
    assert interp in ('auto', 'gather', 'matmul', 'pallas'), interp
    assert not (interp == 'matmul' and d > 2), \
        f'interp=matmul supports d<=2 (got {d}-dim; use gather)'
    assert not (interp == 'pallas' and d != 3), \
        f'interp=pallas supports d=3 only (got {d}-dim)'
    grid = tuple(int(-2 * (-osf * n // 2)) for n in im_size)  # even ≥ σn
    if beta is None:
        s = osf
        beta = float(np.pi * np.sqrt(
            (width ** 2 / s ** 2) * (s - 0.5) ** 2 - 0.8))
    deap1 = []
    for n, G in zip(im_size, grid):
        assert G >= n + width, (
            f'grid {G} too small for image {n} + kernel {width}; '
            f'raise osf')
        xi = (np.arange(n, dtype=np.float64) - n // 2) / G
        deap1.append(1.0 / _kb_ft(xi, width, beta))
    full = deap1[0]
    for w in deap1[1:]:
        full = full[..., None] * w
    return NufftPlan(im_size, grid, fov, width, beta,
                     torch.as_tensor(full, dtype=dtype, device=device),
                     interp=interp)


# ------------------------------------------------------------------
# Grid stage and interpolation
# ------------------------------------------------------------------

def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def _dims(plan):
    return tuple(range(1, plan.ndim + 1))


def _to_grid(plan: NufftPlan, img):
    r"""`(N, n…, 2)` image → `(N, ΠG, 2)` centred oversampled spectrum."""
    x = img * plan.deapod.to(img.dtype)[..., None]
    pad = [0, 0]
    for n, G in zip(plan.im_size[::-1], plan.grid_size[::-1]):
        pad += [0, G - n]
    x = torch.roll(F.pad(x, pad), [-(n // 2) for n in plan.im_size],
                   dims=_dims(plan))
    X = torch.fft.fftn(torch.view_as_complex(x), dim=_dims(plan))
    return torch.view_as_real(X).reshape(x.shape[0], -1, 2)


def _from_grid(plan: NufftPlan, grid):
    r"""`(N, ΠG, 2)` grid → `(N, n…, 2)` image: the adjoint of
    :func:`_to_grid` (unnormalised inverse FFT, shift back, crop,
    deapodize)."""
    N = grid.shape[0]
    X = torch.view_as_complex(grid.reshape((N,) + plan.grid_size + (2,)))
    x = torch.view_as_real(torch.fft.ifftn(X, dim=_dims(plan),
                                           norm='forward'))
    x = torch.roll(x, [n // 2 for n in plan.im_size], dims=_dims(plan))
    x = x[(slice(None),) + tuple(slice(0, n) for n in plan.im_size)]
    return x * plan.deapod.to(x.dtype)[..., None]


def _plain(plan: NufftPlan) -> bool:
    return plan.interp == 'gather'


def _fwd_core(plan, img, k, chunk):
    return knf.Sample.apply(_plain(plan), plan.geom, chunk,
                            _to_grid(plan, img), k)


def _adj_core(plan, s, k, chunk):
    return _from_grid(plan, knf.Spread.apply(_plain(plan), plan.geom, chunk,
                                             s.contiguous(), k))


def _ktraj(plan: NufftPlan, ktraj, like, N: int):
    r"""``ktraj`` `(d, nT)` ⊻ `(N ⊻ 1, d, nT)` → `(N ⊻ 1, d, nT)`
    contiguous in ``like``'s dtype and device."""
    k = torch.as_tensor(ktraj).to(dtype=like.dtype, device=like.device)
    if k.ndim == 2:
        k = k[None]
    if k.ndim != 3 or k.shape[0] not in (1, N) or k.shape[1] != plan.ndim:
        raise ValueError(f'ktraj must be ({plan.ndim}, nT) or (1 or {N}, '
                         f'{plan.ndim}, nT), got {tuple(k.shape)}')
    return k.contiguous()


def _segments(plan, df, T2s, dt, nseg: int, nT: int, like):
    r"""Hat-function time segmentation [Sutton, Fessler & Noll, IEEE TMI
    22(2):178, 2003]: ``e^{−t/T2* − i2π Δf t} ≈ Σ_l b_l(t)·w_l`` with
    ``τ_l`` equispaced over the readout, ``b_l`` the linear-interp hats,
    ``w_l = e^{−τ_l/T2*}e^{−i2πΔf τ_l}`` per voxel. Returns `(nseg, nT)`
    coefficients and `(nseg, N ⊻ 1, n…, 2)` voxel weights (``df``/``T2s``
    `()`, `(n…)` or `(N, n…)`)."""
    dtype, dev = like.dtype, like.device
    t = (torch.arange(nT, dtype=dtype, device=dev) + 1) * dt   # signal()'s
    t0, t1 = dt, nT * dt
    nseg = min(nseg, nT)      # nseg > nT ⇒ dtau = 0 ⇒ NaN hats at nT=1
    if nseg == 1:
        taus = torch.tensor([(t0 + t1) / 2], dtype=dtype, device=dev)
        b = torch.ones((1, nT), dtype=dtype, device=dev)
    else:
        taus = t0 + (t1 - t0) * torch.arange(nseg, dtype=dtype,
                                             device=dev) / (nseg - 1)
        dtau = (t1 - t0) / (nseg - 1)
        b = torch.clamp_min(1.0 - torch.abs(t[None] - taus[:, None])
                            / dtau, 0.0)                      # (nseg, nT)

    def grid_map(x):                                          # (N ⊻ 1, n…)
        x = torch.as_tensor(x, dtype=dtype, device=dev)
        return x if x.ndim > plan.ndim else torch.broadcast_to(
            x, plan.im_size)[None]

    dfg = torch.zeros((1,) + plan.im_size, dtype=dtype, device=dev) \
        if df is None else grid_map(df)
    tau = taus.reshape((nseg,) + (1,) * dfg.ndim)
    phase = -2.0 * pi * dfg[None] * tau                       # (nseg, …)
    if T2s is None:
        env = torch.ones_like(phase)
    else:
        t2g = grid_map(T2s)
        env = torch.exp(-taus.reshape((nseg,) + (1,) * t2g.ndim)
                        / t2g[None])
    w = torch.stack(torch.broadcast_tensors(env * torch.cos(phase),
                                            env * torch.sin(phase)), -1)
    return b, w


def nufft(plan: NufftPlan, img, ktraj, *, df=None, T2s=None, dt=None,
          nseg: int = 8, chunk: Optional[int] = None, mesh=None):
    r"""Sample the image's spectrum at a nonuniform trajectory (type-2
    NUFFT): ``s(t) ≈ Σ_j img_j · e^{−i2π k(t)·x_j}``.

    Inputs:
        - ``img``: `([N,] n_1, …, n_d, 2)` re/im image on the plan's grid.
        - ``ktraj``: `(d, nT)` ⊻ `(N ⊻ 1, d, nT)`, "cycle/cm".
    Optionals:
        - ``df``/``T2s``: `()` ⊻ `([N,] n_1, …, n_d)`, "Hz"/"Sec" —
          off-resonance and T2* maps on the grid, modeled by ``nseg``-
          segment hat time segmentation (requires ``dt``; sample times
          ``(t+1)·dt``, as :func:`mrphy_tpu_torch.ops.signal.signal`).
        - ``dt``: `()`, "Sec", dwell (required with ``df``/``T2s``).
        - ``nseg``: time segments (error ∝ (2πΔf·T/nseg)²).
        - ``chunk``: samples per tap table of the plain route (the
          kernels ignore it).
        - ``mesh``: not ported yet (raises :class:`NotImplementedError`).
    Outputs:
        - ``s``: `([N,] nT, 2)` re/im samples.
    """
    if mesh is not None:
        raise NotImplementedError('mesh= (sample-sharded NUFFT) is not '
                                  'ported to mrphy_tpu_torch yet '
                                  '(ROADMAP.md slice 16)')
    img = torch.as_tensor(img)
    batched = img.ndim == plan.ndim + 2
    assert tuple(img.shape[batched:]) == plan.im_size + (2,), \
        (tuple(img.shape), plan.im_size)
    if not batched:
        img = img[None]
    k = _ktraj(plan, ktraj, img, img.shape[0])
    if df is None and T2s is None:
        s = _fwd_core(plan, img, k, chunk)
    else:
        assert dt is not None, 'df/T2s time segmentation needs dt'
        b, w = _segments(plan, df, T2s, dt, nseg, k.shape[-1], img)
        s = 0
        for el in range(b.shape[0]):
            wr, wi = _cmul(img[..., 0], img[..., 1], w[el, ..., 0],
                           w[el, ..., 1])
            s = s + b[el][:, None] * _fwd_core(
                plan, torch.stack([wr, wi], -1), k, chunk)
    return s if batched else s[0]


def nufft_adjoint(plan: NufftPlan, s, ktraj, *, df=None, T2s=None,
                  dt=None, nseg: int = 8, chunk: Optional[int] = None,
                  mesh=None):
    r"""Exact (complex-conjugate) adjoint of :func:`nufft`, also under
    ``df``/``T2s`` time segmentation (each segment's spread weighted by
    ``b_l`` and re-phased by ``conj(w_l)``), so ``⟨nufft(x), y⟩ = ⟨x,
    nufft_adjoint(y)⟩`` for the same arguments.

    Inputs:
        - ``s``: `([N,] nT, 2)` re/im samples.
        - ``ktraj``: as :func:`nufft`.
    Optionals: as :func:`nufft`.
    Outputs:
        - ``img``: `([N,] n_1, …, n_d, 2)`.
    """
    if mesh is not None:
        raise NotImplementedError('mesh= (sample-sharded NUFFT) is not '
                                  'ported to mrphy_tpu_torch yet '
                                  '(ROADMAP.md slice 16)')
    s = torch.as_tensor(s)
    batched = s.ndim == 3
    if not batched:
        s = s[None]
    k = _ktraj(plan, ktraj, s, s.shape[0])
    nT = k.shape[-1]
    assert tuple(s.shape[1:]) == (nT, 2), (tuple(s.shape), nT)
    if df is None and T2s is None:
        out = _adj_core(plan, s, k, chunk)
    else:
        assert dt is not None, 'df/T2s time segmentation needs dt'
        b, w = _segments(plan, df, T2s, dt, nseg, nT, s)
        out = 0
        for el in range(b.shape[0]):
            x = _adj_core(plan, b[el][:, None] * s, k, chunk)
            # conj(w_l) ⊙ x
            xr, xi = _cmul(x[..., 0], x[..., 1], w[el, ..., 0],
                           -w[el, ..., 1])
            out = out + torch.stack([xr, xi], -1)
    return out if batched else out[0]


# ------------------------------------------------------------------
# Density compensation (Pipe–Menon)
# ------------------------------------------------------------------

def dcf_pipe_menon(plan: NufftPlan, ktraj, *, iters: int = 30,
                   normalize: bool = True):
    r"""Iterative sampling-density compensation [Pipe & Menon, MRM
    41(1):179, 1999]: ``w ← w / (C Cᴴ w)`` with ``C`` the KB interpolation
    without the DFT stage (on the card ``nufft_spread`` then
    ``nufft_sample``), so that ``C Cᴴ w ≈ 1`` at every sample.

    Inputs:
        - ``ktraj``: `(d, nT)`, "cycle/cm".
    Optionals:
        - ``iters``: fixed-point iterations (30 ≈ converged for
          spiral/radial).
        - ``normalize``: calibrate the global scale to unit DC gain, so
          ``nufft_adjoint(w ⊙ nufft(𝟙))`` returns ≈𝟙.
    Outputs:
        - ``w``: `(nT,)` sample weights (not differentiable).
    """
    k = torch.as_tensor(ktraj).detach()
    assert k.ndim == 2 and k.shape[0] == plan.ndim, tuple(k.shape)
    k = k[None].contiguous()
    sample, spread, _ = knf._route(_plain(plan))
    w = torch.ones(k.shape[-1], dtype=k.dtype, device=k.device)
    with torch.no_grad():
        for _ in range(iters):
            g = spread(torch.stack([w, torch.zeros_like(w)], -1)[None], k,
                       plan.geom)
            w = w / torch.clamp_min(sample(g, k, plan.geom)[0, :, 0],
                                    1e-30)
        if normalize:
            ones = torch.stack([torch.ones(plan.im_size, dtype=k.dtype,
                                           device=k.device),
                                torch.zeros(plan.im_size, dtype=k.dtype,
                                            device=k.device)], -1)[None]
            y = nufft_adjoint(plan, w[:, None] * _fwd_core(plan, ones, k,
                                                           None)[0], k)
            w = w / torch.mean(y[..., 0])
    return w


# ------------------------------------------------------------------
# Toeplitz normal operator
# ------------------------------------------------------------------

def toeplitz_kernel(plan: NufftPlan, ktraj, *, weights=None,
                    chunk: int = 4096):
    r"""Spectrum of the normal operator's Toeplitz embedding, computed
    exactly (chunked products, no gridding): ``T̂ = DFT_{2n}(h)`` with PSF
    ``h(r) = Σ_t w_t e^{+i2π Σ_a u_{a,t} r_a/n_a}``, so that
    :func:`toeplitz_apply` realizes ``AᴴWA`` of the exact encoding
    operator to rounding.

    Inputs:
        - ``ktraj``: `(d, nT)`, "cycle/cm".
    Optionals:
        - ``weights``: `(nT,)` real sample weights (default 1).
        - ``chunk``: samples per product block (a 3-D block holds a
          `(chunk, 4·n_1·n_2)` complex factor).
    Outputs:
        - ``that``: `(2n_1, …, 2n_d, 2)` re/im multipliers.
    """
    k = torch.as_tensor(ktraj)
    nT, d = k.shape[-1], plan.ndim
    dtype, dev = k.dtype, k.device
    w = (torch.ones(nT, dtype=dtype, device=dev) if weights is None
         else torch.broadcast_to(torch.as_tensor(weights, dtype=dtype,
                                                 device=dev), (nT,)))
    h = 0
    with full_f32_matmul():
        for t0 in range(0, nT, min(chunk, nT)):
            kc, wc = k[:, t0:t0 + chunk], w[t0:t0 + chunk]
            # per-axis factors E_a[t, q] = e^{+i2π u_a,t (q−n)/n}
            es = []
            for a, (n, f) in enumerate(zip(plan.im_size, plan.fov)):
                q = torch.arange(2 * n, dtype=dtype, device=dev) - n
                ang = 2.0 * pi * (kc[a] * f)[:, None] * q[None] / n
                es.append(torch.complex(torch.cos(ang), torch.sin(ang)))
            es[0] = es[0] * wc[:, None]                # weight on axis 0
            if d == 1:
                hc = es[0].sum(0)
            elif d == 2:
                hc = es[0].T @ es[1]
            else:
                e01 = (es[0][:, :, None] * es[1][:, None, :]).reshape(
                    kc.shape[1], -1)
                hc = (e01.T @ es[2]).reshape(tuple(2 * n
                                                   for n in plan.im_size))
            h = h + hc
    # circulant layout: hc[r mod 2n] = h(r), r ∈ [−n, n); then the plain
    # (unshifted) DFT on the 2n grid
    h = torch.roll(h, [-n for n in plan.im_size], dims=tuple(range(d)))
    return torch.view_as_real(torch.fft.fftn(h)).contiguous()


def toeplitz_apply(plan: NufftPlan, that, img):
    r"""Apply the normal operator: zero-pad ``img`` to the `(2n)^d` grid,
    multiply its spectrum by ``that``, inverse FFT, crop — one circular
    convolution realizing exact ``AᴴWA`` for the planned trajectory.

    Inputs:
        - ``that``: from :func:`toeplitz_kernel`.
        - ``img``: `([N,] n_1, …, n_d, 2)`.
    Outputs: same shape as ``img``.
    """
    img = torch.as_tensor(img)
    d = plan.ndim
    assert tuple(img.shape[-d - 1:]) == plan.im_size + (2,), \
        (tuple(img.shape), plan.im_size)
    dims = tuple(range(-d, 0))
    X = torch.fft.fftn(torch.complex(img[..., 0], img[..., 1]),
                       s=[2 * n for n in plan.im_size], dim=dims)
    y = torch.fft.ifftn(X * torch.view_as_complex(that.contiguous()),
                        dim=dims)
    y = y[(Ellipsis,) + tuple(slice(0, n) for n in plan.im_size)]
    return torch.stack([y.real, y.imag], -1)
