r"""Receive-array utilities: SVD coil compression, noise handling, coil
sensitivity estimation and g-factor maps (counterpart of the JAX package's
``utils/coils.py``).

Calibration-time helpers around the acquisition operator
(:mod:`mrphy_tpu_torch.ops.signal`), in the package's real re/im-pair
convention (the ``(..., xy, nC)`` shape rule of ``sens``). The matrix
factorizations (SVD, Cholesky, the ESPIRiT eigendecompositions) run on the
host in numpy, one-off calibration work as in the JAX package; the
applications (:func:`apply_ccmat`, :func:`add_noise`, :func:`adaptive_maps`,
:func:`gfactor_sense`) are torch operations on the inputs' device. Matrix
products run in full float32 (:func:`mrphy_tpu_torch.kernels.signal
.full_f32_matmul`). Random numbers come from a ``torch.Generator`` where
the JAX package takes a ``jax.random`` key: the two draw different
numbers from the same seed.
"""

from typing import Tuple

import numpy as np
import torch

from mrphy_tpu_torch import default_device
from mrphy_tpu_torch.kernels.signal import full_f32_matmul

__all__ = ['coil_compress', 'apply_ccmat', 'noise_whiten_mat',
           'add_noise', 'adaptive_maps', 'espirit_maps',
           'gfactor_sense', 'gfactor_replica', 'replica_std']


def _to_complex(x):
    x = np.asarray(x)
    if x.shape[-2] != 2:
        raise ValueError(f're/im axis expected at -2, got {x.shape}')
    return x[..., 0, :] + 1j * x[..., 1, :]


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def coil_compress(calib, ncc: int) -> Tuple[np.ndarray, np.ndarray]:
    r"""SVD (SCC) coil compression from calibration data.

    Inputs:
        - ``calib``: `(..., xy, nC)` re/im calibration samples (e.g. the
          sensitivity maps; leading axes are flattened).
        - ``ncc``: number of virtual coils to keep.
    Outputs:
        - ``W``: `(xy, nC, ncc)` re/im compression matrix (columns: the
          dominant right-singular vectors of the calibration matrix).
        - ``energy``: `(nC,)` normalized singular-value energy.

    Host numpy (complex SVD); apply with :func:`apply_ccmat` to ``sens``
    and to acquired signals `(N, nC, nT, 2)`: compression commutes with
    the acquisition operator.
    """
    calib = _host(calib)
    X = _to_complex(calib).reshape(-1, calib.shape[-1])
    nC = X.shape[-1]
    if not 1 <= ncc <= nC:
        raise ValueError(f'ncc must be in [1, {nC}], got {ncc}')
    _, s, Vh = np.linalg.svd(X, full_matrices=False)
    W = Vh.conj().T[:, :ncc]                     # (nC, ncc)
    energy = (s ** 2) / max((s ** 2).sum(), 1e-30)
    energy = np.pad(energy, (0, nC - energy.size))
    return np.stack([W.real, W.imag], 0), energy


def apply_ccmat(x, W, *, axis: int = -1):
    r"""Apply a compression/whitening matrix along the coil axis.

    Inputs:
        - ``x``: a coil axis at ``axis`` and a re/im pair axis — ``sens``
          `(..., xy, nC)` (``axis=-1``, pairs at -2) or signals `(N, nC,
          nT, xy)` (``axis=1``, pairs at -1).
        - ``W``: `(xy, nC, k)` re/im matrix from :func:`coil_compress` /
          :func:`noise_whiten_mat`.
    Outputs:
        - ``x`` in the same layout with a coil axis of size ``k``:
          ``y = x @ W`` in the complex sense.
    """
    x = torch.as_tensor(x)
    W = torch.as_tensor(W, dtype=x.dtype, device=x.device)
    wr, wi = W[0], W[1]
    ax = axis % x.ndim
    xm = x if ax == x.ndim - 1 else torch.movedim(x, ax, -1)
    # pairs at -2 (after the move for the signal layout)
    xr, xi = xm[..., 0, :], xm[..., 1, :]
    with full_f32_matmul():
        y = torch.stack([xr @ wr - xi @ wi, xr @ wi + xi @ wr], dim=-2)
    return y if ax == x.ndim - 1 else torch.movedim(y, -1, ax)


def noise_whiten_mat(Psi) -> np.ndarray:
    r"""Noise pre-whitening matrix from a coil noise covariance.

    Inputs:
        - ``Psi``: `(xy, nC, nC)` re/im Hermitian noise covariance.
    Outputs:
        - ``W``: `(xy, nC, nC)` re/im, ``W = L⁻ᵀ`` for ``Psi = L Lᴴ``:
          under :func:`apply_ccmat`'s row convention ``y = x·W`` is ``y =
          L⁻¹·x``, identity-covariance noise. Apply the same ``W`` to
          signals and sensitivities.
    """
    Psi = _host(Psi)
    L = np.linalg.cholesky(Psi[0] + 1j * Psi[1])
    W = np.linalg.inv(L).T
    return np.stack([W.real, W.imag], 0)


def _color(n, Psi):
    r"""Noise ``n`` `(N, nC, nT, 2)` colored as ``L·n``, ``Psi = L Lᴴ``
    (host Cholesky)."""
    Psi = _host(Psi)
    L = np.linalg.cholesky(Psi[0] + 1j * Psi[1])
    # row convention y = x·W colors as L·n when W = Lᵀ
    return apply_ccmat(n, np.stack([L.T.real, L.T.imag], 0), axis=1)


def add_noise(generator, s, sigma, Psi=None):
    r"""Complex receiver noise on a signal.

    Inputs:
        - ``generator``: a ``torch.Generator`` on ``s``'s device (None:
          PyTorch's default one); ``s``: `(N, nC, nT, 2)` signal.
        - ``sigma``: per-channel std of the re/im components.
        - ``Psi``: optional `(xy, nC, nC)` coil covariance: the noise is
          colored as ``L n`` with ``Psi = L Lᴴ``.
    Outputs:
        - the noisy signal, same shape.
    """
    s = torch.as_tensor(s)
    n = sigma * torch.randn(s.shape, generator=generator, dtype=s.dtype,
                            device=s.device)
    if Psi is not None:
        n = _color(n, Psi)
    return s + n


def espirit_maps(calib, im_size, *, kernel: int = 6,
                 thresh_sv: float = 0.02, crop: float = 0.0):
    r"""ESPIRiT coil-sensitivity maps from a Cartesian calibration (ACS)
    block [Uecker et al., MRM 71(3):990, 2014]: the per-voxel dominant
    eigenvectors of the calibration matrix's row-space operator, and the
    eigenvalue map (≈ 1 where the data fits one smooth sensitivity).

    Convention: ``calib`` is the centered ACS block of the Cartesian
    spectrum under this package's encoding sign ``s(k) = Σ_j w_j
    e^{−i2πk·x_j}`` (:mod:`mrphy_tpu_torch.ops.signal`), i.e. the
    centered DFT ``fftshift(fftn(ifftshift(img)))`` of the coil images.

    Host numpy, as in the JAX package: block-Hankel matrix of all
    ``kernel^d`` windows → SVD → row-space kernels (σ ≥ ``thresh_sv``·σ₀)
    → zero-padded centered inverse DFT (scale ``N/√K``) → per-voxel
    ``nC×nC`` ``GᴴG`` eigendecomposition; maps are the conjugate top
    eigenvector, phase-anchored to the strongest coil.

    Inputs:
        - ``calib``: `(nC, c_1, …, c_d, 2)` re/im centered ACS block.
        - ``im_size``: `(n_1, …, n_d)` output grid.
    Optionals:
        - ``kernel``: window side; ``thresh_sv``: row-space cutoff;
          ``crop``: zero the maps where the eigenvalue < ``crop``.
    Outputs:
        - ``maps``: `(n_1, …, n_d, 2, nC)` unit-norm maps (numpy).
        - ``lam``: `(n_1, …, n_d)` top-eigenvalue map (numpy).
    """
    calib = _host(calib)
    if calib.shape[-1] != 2:
        raise ValueError(f'expected (nC, c…, 2), got {calib.shape}')
    C = calib[..., 0] + 1j * calib[..., 1]        # (nC, c…)
    nC = C.shape[0]
    cshape = C.shape[1:]
    d = len(cshape)
    im_size = tuple(int(n) for n in im_size)
    ks = (int(kernel),) * d
    if len(im_size) != d or any(c < k for c, k in zip(cshape, ks)) or any(
            n < k for n, k in zip(im_size, ks)):
        raise ValueError(f'calib {cshape}, im_size {im_size} and kernel '
                         f'{kernel} do not fit')

    # block-Hankel of sliding windows → row-space kernels
    win = np.lib.stride_tricks.sliding_window_view(
        C, ks, axis=tuple(range(1, 1 + d)))
    win = np.moveaxis(win, 0, -1)                 # (w…, k…, nC)
    A = win.reshape(-1, int(np.prod(ks)) * nC)
    _, s, Vh = np.linalg.svd(A, full_matrices=False)
    nk = max(1, int((s >= thresh_sv * s[0]).sum()))
    kerns = Vh[:nk].reshape((nk,) + ks + (nC,))   # (nk, k…, nC)

    # zero-pad centered, inverse centered DFT, scale N/√K
    N, K = int(np.prod(im_size)), int(np.prod(ks))
    kpad = np.zeros((nk,) + im_size + (nC,), complex)
    sl = (slice(None),) + tuple(
        slice(n // 2 - k // 2, n // 2 - k // 2 + k)
        for n, k in zip(im_size, ks)) + (slice(None),)
    kpad[sl] = kerns
    axes = tuple(range(1, 1 + d))
    G = np.fft.fftshift(np.fft.ifftn(
        np.fft.ifftshift(kpad, axes=axes), axes=axes),
        axes=axes) * (N / np.sqrt(K))             # (nk, n…, nC)

    # per-voxel GᴴG (nC×nC Hermitian), top eigenpair
    Gq = np.moveaxis(G, 0, -2)                    # (n…, nk, nC)
    M = np.einsum('...ic,...ie->...ce', Gq.conj(), Gq)
    w, v = np.linalg.eigh(M)
    lam = np.clip(w[..., -1].real, 0.0, None)
    m = v[..., -1].conj()                         # (n…, nC)

    # phase-anchor to the strongest coil (cf. adaptive_maps)
    ref = int(np.argmax((np.abs(m) ** 2).reshape(-1, nC).sum(0)))
    ph = m[..., ref] / np.maximum(np.abs(m[..., ref]), 1e-30)
    m = m * ph.conj()[..., None]
    if crop > 0:
        m = m * (lam >= crop)[..., None]
    return np.stack([m.real, m.imag], -2), lam


def _box_filter(a, axis: int, block: int):
    r"""Sum over a centered window of ``block`` samples along ``axis``
    (edge-clamped at the high end), by cumsum differences."""
    n, h = a.shape[axis], block // 2
    c = torch.cumsum(a, dim=axis)
    chi = torch.cat([c] + [c.narrow(axis, n - 1, 1)] * h, dim=axis)
    zshape = list(c.shape)
    zshape[axis] = h + 1
    clo = torch.cat([c.new_zeros(zshape), c], dim=axis).narrow(axis, 0, n)
    return chi.narrow(axis, h, n) - clo


def adaptive_maps(imgs, *, block: int = 5, iters: int = 40,
                  eps: float = 1e-12):
    r"""Receive-sensitivity maps from coil images by Walsh's adaptive
    method [Walsh, Gmitro & Marcellin, MRM 43(5):682, 2000]: per voxel,
    the principal eigenvector of the locally averaged coil covariance
    ``R(x) = Σ_{x'∈block} s(x') s(x')ᴴ``, by a fixed count of power
    iterations; the phase is anchored to the strongest coil.

    Inputs:
        - ``imgs``: `(nC, n_1, …, n_d, 2)` coil images (re/im).
    Optionals:
        - ``block``: box side (odd), voxels; ``iters``: power
          iterations.
    Outputs:
        - ``maps``: `(n_1, …, n_d, 2, nC)` unit-norm sensitivity
          vectors.
    """
    imgs = torch.as_tensor(imgs)
    if block % 2 != 1:
        raise ValueError(f'block must be odd, got {block}')
    nC, d = imgs.shape[0], imgs.ndim - 2
    xr, xi = imgs[..., 0], imgs[..., 1]                    # (nC, n…)

    def corr(a, b):                    # the a_i·b_j images, (nC, nC, n…)
        return a[:, None] * b[None]

    Rr = corr(xr, xr) + corr(xi, xi)   # Re(s_i s_j*)
    Ri = corr(xi, xr) - corr(xr, xi)   # Im(s_i s_j*)
    for ax in range(2, 2 + d):
        Rr = _box_filter(Rr, ax, block)
        Ri = _box_filter(Ri, ax, block)

    # power iteration on the Hermitian Rr + i·Ri, per voxel
    vr = torch.ones((nC,) + tuple(imgs.shape[1:-1]), dtype=imgs.dtype,
                    device=imgs.device)
    vi = torch.zeros_like(vr)
    for _ in range(iters):
        wr = (Rr * vr[None]).sum(1) - (Ri * vi[None]).sum(1)
        wi = (Rr * vi[None]).sum(1) + (Ri * vr[None]).sum(1)
        nrm = torch.sqrt((wr ** 2 + wi ** 2).sum(0, keepdim=True))
        nrm = torch.clamp_min(nrm, eps)
        vr, vi = wr / nrm, wi / nrm
    # anchor the per-voxel phase to the strongest coil (its map is made
    # real-positive), so the maps vary smoothly like physical coils
    power = vr ** 2 + vi ** 2
    ref = int(torch.argmax(power.sum(tuple(range(1, 1 + d)))))
    rr, ri = vr[ref], vi[ref]
    mag = torch.sqrt(torch.clamp_min(rr ** 2 + ri ** 2, eps))
    cr, ci = rr / mag, -ri / mag                       # conj(phase)
    mr = vr * cr - vi * ci
    mi = vr * ci + vi * cr
    return torch.movedim(torch.stack([mr, mi], -1), 0, -1)  # (n…, 2, nC)


def gfactor_sense(maps, R: int, *, axis: int = 0, Psi=None,
                  ridge: float = 1e-12):
    r"""Analytic SENSE geometry (g-) factor map for uniform Cartesian
    undersampling [Pruessmann et al., MRM 42(5):952, 1999, eq. 23]:
    ``g_ρ = sqrt([(Sᴴ Ψ⁻¹ S)⁻¹]_ρρ [Sᴴ Ψ⁻¹ S]_ρρ)``, ``S`` the
    sensitivities of the ``R`` pixels that alias onto each other
    (separation ``n/R`` along ``axis``).

    Inputs:
        - ``maps``: `(n_1, …, n_d, xy, nC)` re/im sensitivity maps.
        - ``R``: integer acceleration; ``n_axis % R == 0``.
    Optionals:
        - ``axis``: the undersampled spatial axis.
        - ``Psi``: `(xy, nC, nC)` re/im coil noise covariance (the maps
          are pre-whitened with :func:`noise_whiten_mat`).
        - ``ridge``: relative Tikhonov floor for all-zero aliasing sets.
    Outputs:
        - ``g``: `(n_1, …, n_d)`; 1 where one pixel of a set has
          support, 0 where the maps have none.

    The complex ``R×R`` inversion runs in real arithmetic through the
    ``[[Re, −Im], [Im, Re]]`` embedding, as in the JAX package.
    """
    m = torch.as_tensor(maps)
    if m.ndim < 3 or m.shape[-2] != 2:
        raise ValueError(f'expected (n…, xy, nC), got {tuple(m.shape)}')
    if Psi is not None:
        m = apply_ccmat(m, noise_whiten_mat(Psi))
    d = m.ndim - 2
    ax = axis % d
    R = int(R)
    n = m.shape[ax]
    if R < 1 or n % R:
        raise ValueError(f'R = {R} does not divide n = {n}')
    m = torch.movedim(m, ax, 0)                   # (n, rest…, xy, nC)
    rest = tuple(m.shape[1:-2])
    nC = m.shape[-1]
    m = m.reshape((R, n // R) + rest + (2, nC))   # pixels n/R apart alias
    Sr = torch.movedim(m[..., 0, :], 0, -2)       # (n/R, rest…, R, nC)
    Si = torch.movedim(m[..., 1, :], 0, -2)
    with full_f32_matmul():
        # H = S* Sᵀ (Hermitian, (…, R, R)): H[a,b] = Σ_c conj(S[a,c]) S[b,c]
        Hr = Sr @ Sr.transpose(-1, -2) + Si @ Si.transpose(-1, -2)
        Hi = Sr @ Si.transpose(-1, -2) - Si @ Sr.transpose(-1, -2)
        diag = torch.diagonal(Hr, dim1=-2, dim2=-1)   # (…, R) |s_ρ|²
        eye = torch.eye(R, dtype=m.dtype, device=m.device)
        eps = (ridge * diag.mean(-1, keepdim=True)[..., None] * eye
               + 1e-30 * eye)
        # real embedding [[Hr, -Hi], [Hi, Hr]]; its inverse's top-left
        # block is Re(H⁻¹)
        M = torch.cat([torch.cat([Hr + eps, -Hi], -1),
                       torch.cat([Hi, Hr + eps], -1)], -2)
        dinv = torch.diagonal(torch.linalg.inv(M), dim1=-2, dim2=-1)[..., :R]
    g = torch.sqrt(torch.clamp_min(dinv * diag, 0.0))
    g = torch.where(diag > 0, g, torch.zeros_like(g))  # no support → 0
    g = torch.movedim(g, -1, 0).reshape((n,) + rest)   # undo the grouping
    return torch.movedim(g, 0, ax)


def replica_std(recon, shape, *, n: int = 300, generator=None,
                sigma: float = 1.0, Psi=None, dtype=torch.float32,
                device=None):
    r"""Pixelwise noise std of a linear reconstruction by pseudo multiple
    replicas [Robson et al., MRM 60(4):895, 2008]: ``n`` iid noise-only
    inputs through ``recon``, the per-output-element std by Welford
    accumulation on the host.

    Inputs:
        - ``recon``: callable, noise tensor of ``shape`` → output (any
          shape, tensor or array); must be linear.
        - ``shape``: the input noise shape (with the re/im axis if the
          recon takes pairs); each element iid ``N(0, sigma²)``.
    Optionals:
        - ``n``: replica count (std-of-std ≈ ``1/√(2n)`` relative).
        - ``generator``: a ``torch.Generator`` on ``device`` (default:
          one seeded with 0).
        - ``Psi``: optional `(xy, nC, nC)` covariance: the noise is colored
          as in :func:`add_noise` (``shape`` is then `(N, nC, nT, xy)`).
        - ``dtype``/``device``: of the noise (device default: the CUDA
          card).
    Outputs:
        - ``std``: numpy array, the recon's output shape.
    """
    device = default_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    mean = m2 = None
    for i in range(int(n)):
        noise = sigma * torch.randn(tuple(shape), generator=generator,
                                    dtype=dtype, device=device)
        if Psi is not None:
            noise = _color(noise, Psi)
        x = np.asarray(_host(recon(noise)), dtype=np.float64)
        if mean is None:
            mean, m2 = np.zeros_like(x), np.zeros_like(x)
        delta = x - mean
        mean += delta / (i + 1)
        m2 += delta * (x - mean)
    return np.sqrt(m2 / max(int(n) - 1, 1))


def gfactor_replica(recon_accel, recon_full, shape, R: int, *,
                    n: int = 300, generator=None, Psi=None,
                    dtype=torch.float32, device=None, eps: float = 1e-30):
    r"""Monte-Carlo g-factor map for any linear recon pair (GRAPPA,
    CG-SENSE, compressed coils) by the pseudo-replica identity ``g =
    σ_acc / (σ_full·√R)``.

    Both recons take noise-only inputs of the same ``shape`` (the fully
    sampled signal layout); the accelerated one uses only its sampled
    subset. Inputs and optionals as :func:`replica_std` (one generator
    serves both recons, accelerated first; default: one seeded with 1),
    with ``R`` the acceleration.
    Outputs:
        - ``g``: numpy array, 0 where the full recon has no noise
          response.
    """
    device = default_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(1)
    kw = dict(n=n, generator=generator, Psi=Psi, dtype=dtype, device=device)
    sd_a = replica_std(recon_accel, shape, **kw)
    sd_f = replica_std(recon_full, shape, **kw)
    g = sd_a / (np.sqrt(float(R)) * np.maximum(sd_f, eps))
    return np.where(sd_f > eps, g, 0.0)
