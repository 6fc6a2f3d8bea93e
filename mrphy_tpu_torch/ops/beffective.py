r"""B-effective assembly and rotation extraction (counterpart of
:mod:`mrphy_tpu.ops.beffective`).

- :func:`rfgr2beff` — assemble B-effective from RF + gradients + locations,
  with off-resonance and multi-coil transmit sensitivity (B1) mixing.
  The contractions over xyz and coils are written out as elementwise
  products, so no float32 matrix product (and no TF32) is involved.
- :func:`beff2uphi` — rotation axis/angle from B-effective.
- :func:`beff2ab` — the Hargreaves affine propagator (A, B) of a whole
  pulse, ``M_out = A @ M_in + B``, by a time loop.
- :func:`beff2ab_assoc` — the same propagator by pairwise tree reduction
  over time (affine composition is associative): O(log nT) sequential
  depth for O(nT·12·nSpins) memory.
"""

from typing import Optional, Tuple

import torch

from mrphy_tpu_torch import gamH, dt0, pi
from mrphy_tpu_torch._kwalias import kwalias
from mrphy_tpu_torch.utils import uphirot
from mrphy_tpu_torch.utils._shapes import asarr, rshape

# NB: `beff2uϕ` (U+03D5) and `beff2uφ` (U+03C6) NFKC-normalize to the one
# attribute 'beff2uφ' below.
__all__ = ['beff2ab', 'beff2ab_assoc', 'beff2uphi', 'rfgr2beff', 'beff2uφ']

_NORM_EPS = 1e-12  # matches torch.nn.functional.normalize default eps


def beff2uphi(beff, gam2pidt, *, dim: int = -1
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    r"""Compute rotation axes and angles from B-effectives.

    Inputs:
        - ``beff``: `(N, *Nd, xyz)`, "Gauss".
        - ``gam2pidt``: `()` ⊻ `(N ⊻ 1, *Nd ⊻ 1,)`, "Rad/Gauss",
          2π·γ·dt.
    Optionals:
        - ``dim``: the ``xyz`` axis of ``beff``.
    Outputs:
        - ``u``: `(N, *Nd, xyz)`, unit rotation axis.
        - ``phi``: `(N, *Nd)`, rotation angle; negated (Bloch precession is
          M×B).
    """
    beff = torch.as_tensor(beff)
    nrm = torch.linalg.vector_norm(beff, dim=dim)
    u = beff / torch.clamp_min(nrm.unsqueeze(dim), _NORM_EPS)
    phi = -nrm * asarr(gam2pidt, beff)
    return u, phi


def _ab_step_inputs(beff, E1, E2, gam, dt):
    r"""The shared preprocessing of the two A/B propagators."""
    beff = torch.as_tensor(beff)
    ndim = beff.ndim - 2  # (N, *Nd) rank
    E1, E2, gam, dt = (rshape(asarr(x, beff), ndim) for x in (E1, E2, gam,
                                                              dt))
    return beff, E1, E2, 2 * pi * gam * dt


@kwalias(**{'γ': 'gam'})
def beff2ab(beff, *, E1=0.0, E2=0.0, gam=gamH, dt=dt0):
    r"""Hargreaves A/B affine propagator of a whole pulse.

    Runs the time loop once over an affine state ``AB = [A | B]`` of shape
    `(N, *Nd, xyz, 4)`, producing the pulse's total map ``M → A·M + B``
    including per-step E1/E2 relaxation.

    Inputs:
        - ``beff``: `(N, *Nd, nT, xyz)`, "Gauss".
    Optionals:
        - ``E1``/``E2``: `()` ⊻ `(N ⊻ 1, *Nd ⊻ 1,)`, per-step relaxation
          factors ``exp(-dt/T1)`` / ``exp(-dt/T2)``.
        - ``gam`` (alias ``γ``): `()` ⊻ `(N ⊻ 1, *Nd ⊻ 1,)`, "Hz/Gauss".
        - ``dt``: `()` ⊻ `(N ⊻ 1,)`, "Sec".
    Outputs:
        - ``A``: `(N, *Nd, xyz, 3)`; ``B``: `(N, *Nd, xyz)`.
    """
    beff, E1, E2, gam2pidt = _ab_step_inputs(beff, E1, E2, gam, dt)
    NNd = tuple(beff.shape[:-2])
    E2_ = E2[..., None, None]   # scales rows 0:2 of (xyz, 4)
    E1_ = E1[..., None, None]   # scales row 2
    # the recovery −(E1 − 1) lands on element (2, 3) only
    e23 = torch.zeros((3, 4), dtype=beff.dtype, device=beff.device)
    e23[2, 3] = 1
    ab = torch.eye(3, 4, dtype=beff.dtype, device=beff.device).expand(
        NNd + (3, 4))
    for t in range(beff.shape[-2]):
        u, phi = beff2uphi(beff[..., t, :], gam2pidt)
        ab = uphirot(u, phi, ab)  # rotate the 4 affine columns
        ab = torch.cat([ab[..., 0:2, :] * E2_, ab[..., 2:3, :] * E1_],
                       dim=-2)
        ab = ab + (-(E1 - 1))[..., None, None] * e23
    return ab[..., 0:3], ab[..., 3]


@kwalias(**{'γ': 'gam'})
def beff2ab_assoc(beff, *, E1=0.0, E2=0.0, gam=gamH, dt=dt0):
    r"""A/B propagator via parallel-in-time pairwise tree reduction.

    Same result as :func:`beff2ab`. Each step is an affine map ``M →
    D·R(u,φ)·M + c`` (D = diag(E2, E2, E1), c = [0, 0, 1−E1]); pairs of
    neighbouring steps compose level by level, so the pulse composes in
    O(log nT) depth. Each step's map is held as 9 + 3 planes of
    `(nT, S)` (S the flattened spins); only the final propagator is kept.
    """
    beff, E1, E2, gam2pidt = _ab_step_inputs(beff, E1, E2, gam, dt)
    NNd, nT = tuple(beff.shape[:-2]), beff.shape[-2]
    dtype = beff.dtype

    u, phi = beff2uphi(beff, gam2pidt[..., None])  # (N,*Nd,nT,xyz), (…,nT)
    u2 = u.reshape(-1, nT, 3).movedim(0, -1)            # (nT, 3, S)
    cp = torch.cos(phi).reshape(-1, nT).movedim(0, -1)  # (nT, S)
    sp = torch.sin(phi).reshape(-1, nT).movedim(0, -1)
    ux, uy, uz = u2[:, 0], u2[:, 1], u2[:, 2]

    E1f = E1.to(dtype).expand(NNd).reshape(-1)          # (S,)
    E2f = E2.to(dtype).expand(NNd).reshape(-1)
    c1 = 1 - cp
    # rows of D·R(u,φ): R_ik = cφ·δ_ik + (1−cφ)·u_i·u_k + sφ·[u]ₓ_ik
    row = ((cp + c1 * ux * ux, c1 * ux * uy - sp * uz,
            c1 * ux * uz + sp * uy),
           (c1 * uy * ux + sp * uz, cp + c1 * uy * uy,
            c1 * uy * uz - sp * ux),
           (c1 * uz * ux - sp * uy, c1 * uz * uy + sp * ux,
            cp + c1 * uz * uz))
    dscale = (E2f, E2f, E1f)
    a = [[dscale[i] * row[i][k] for k in range(3)] for i in range(3)]
    zb = torch.zeros((nT,) + tuple(E1f.shape), dtype=dtype,
                     device=beff.device)
    b = [zb, zb, (1 - E1f).expand((nT,) + tuple(E1f.shape))]

    nrem = nT
    while nrem > 1:
        odd = nrem % 2
        if odd:  # hold the temporally-last step out, re-append after
            a_last = [[m[-1:] for m in r] for r in a]
            b_last = [v[-1:] for v in b]
            a = [[m[:-1] for m in r] for r in a]
            b = [v[:-1] for v in b]
        lo = [[m[0::2] for m in r] for r in a]
        hi = [[m[1::2] for m in r] for r in a]
        b_lo = [v[0::2] for v in b]
        b_hi = [v[1::2] for v in b]
        a = [[hi[i][0] * lo[0][k] + hi[i][1] * lo[1][k]
              + hi[i][2] * lo[2][k] for k in range(3)] for i in range(3)]
        b = [hi[i][0] * b_lo[0] + hi[i][1] * b_lo[1] + hi[i][2] * b_lo[2]
             + b_hi[i] for i in range(3)]
        if odd:
            a = [[torch.cat([a[i][k], a_last[i][k]]) for k in range(3)]
                 for i in range(3)]
            b = [torch.cat([b[i], b_last[i]]) for i in range(3)]
        nrem = nrem // 2 + odd

    A = torch.stack([torch.stack([a[i][k][0] for k in range(3)], -1)
                     for i in range(3)], -2).reshape(NNd + (3, 3))
    B = torch.stack([b[i][0] for i in range(3)], -1).reshape(NNd + (3,))
    return A, B


@kwalias(**{'γ': 'gam', 'Δf': 'df'})
def rfgr2beff(rf, gr, loc, *, df: Optional[torch.Tensor] = None,
              b1Map: Optional[torch.Tensor] = None, gam=gamH,
              b0: Optional[float] = None):
    r"""Assemble B-effective from RF and gradients.

    Inputs:
        - ``rf``: `(N, xy, nT, (nCoils))`, "Gauss"; x: real, y: imag.
        - ``gr``: `(N, xyz, nT)`, "Gauss/cm".
        - ``loc``: `(N, *Nd, xyz)`, "cm", spin locations.
    Optionals:
        - ``df`` (alias ``Δf``): `(N, *Nd)`, "Hz", off-resonance.
        - ``b1Map``: `(N, *Nd, xy, (nCoils))`, a.u., transmit sensitivity
          (complex as real/imag pairs along ``xy``).
        - ``gam`` (alias ``γ``): `()` ⊻ `(N ⊻ 1, *Nd ⊻ 1,)`, "Hz/Gauss".
        - ``b0``: `()`, "Gauss", main field strength — when given, the
          lowest-order concomitant (Maxwell) field
          ``((gx z − gz x/2)² + (gy z − gz y/2)²) / (2 B0)`` is added to
          ``Bz``.
    Outputs:
        - ``beff``: `(N, *Nd, nT, xyz)`, "Gauss".

    Missing-coil-dim conventions as in :mod:`mrphy_tpu`: an ``rf`` with a
    coil dim but no ``b1Map`` is summed over coils; a coil-less ``rf`` or
    ``b1Map`` is single-coil.
    """
    rf, gr, loc = (torch.as_tensor(x) for x in (rf, gr, loc))
    shape = loc.shape
    N, Nd = shape[0], tuple(shape[1:-1])
    nT = gr.shape[2]

    loc2 = loc.reshape(N, -1, 3)
    x, y, z = (loc2[..., i, None] for i in range(3))   # (N, nS, 1)
    gx, gy, gz = (gr[:, i, None, :] for i in range(3))  # (N, 1, nT)
    Bz = x * gx + y * gy + z * gz                      # (N, nS, nT)

    if b0 is not None:
        cx = z * gx - 0.5 * x * gz
        cy = z * gy - 0.5 * y * gz
        Bz = Bz + (cx * cx + cy * cy) / (2.0 * b0)

    if df is not None:
        df = asarr(df, Bz).reshape(N, -1)              # (N, nS)
        # right-pad gam like the reference: plain broadcasting would
        # mis-align a (N,) gam against (N, *Nd)
        gam_b = rshape(asarr(gam, Bz), len(shape) - 1).expand(
            tuple(shape[:-1])).reshape(N, -1)
        Bz = Bz + (df / gam_b)[..., None]

    if b1Map is None:
        if rf.ndim == 4:  # (N, xy, nT, nCoils): sum over coils
            rf = torch.sum(rf, dim=-1)
        Bx = rf[:, 0, None, :].expand_as(Bz)
        By = rf[:, 1, None, :].expand_as(Bz)
    else:
        b1Map = torch.as_tensor(b1Map)
        if b1Map.ndim == 2 + len(Nd):   # (N, *Nd, xy) → add coil dim
            b1Map = b1Map[..., None]
        if rf.ndim == 3:                # (N, xy, nT) → add coil dim
            rf = rf[..., None]
        # b1Map spatial dims may be 1 (broadcast over spins)
        b1 = b1Map.reshape(N, -1, 2, b1Map.shape[-1])  # (N, nSb, xy, nC)
        b1x, b1y = b1[:, :, 0, None, :], b1[:, :, 1, None, :]
        rfx, rfy = rf[:, 0, None], rf[:, 1, None]      # (N, 1, nT, nC)
        # complex mix: B = Σ_coils b1 ⊗ rf (b1, rf complex as xy pairs)
        Bx = torch.sum(b1x * rfx - b1y * rfy, dim=-1).expand_as(Bz)
        By = torch.sum(b1x * rfy + b1y * rfx, dim=-1).expand_as(Bz)

    beff = torch.stack([Bx, By, Bz], dim=-1)           # (N, nS, nT, xyz)
    return beff.reshape((N,) + Nd + (nT, 3))


# Unicode alias: `beff2uϕ` / `beff2uφ` source spellings.
beff2uφ = beff2uphi
