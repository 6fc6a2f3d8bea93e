r"""B-effective assembly and rotation extraction (counterpart of
:mod:`mrphy_tpu.ops.beffective`).

- :func:`rfgr2beff` — assemble B-effective from RF + gradients + locations,
  with off-resonance and multi-coil transmit sensitivity (B1) mixing.
  The contractions over xyz and coils are written out as elementwise
  products, so no float32 matrix product (and no TF32) is involved.
- :func:`beff2uphi` — rotation axis/angle from B-effective.

``beff2ab`` / ``beff2ab_assoc`` are not ported yet.
"""

from typing import Optional, Tuple

import torch

from mrphy_tpu_torch import gamH
from mrphy_tpu_torch._kwalias import kwalias
from mrphy_tpu_torch.utils._shapes import asarr, rshape

# NB: `beff2uϕ` (U+03D5) and `beff2uφ` (U+03C6) NFKC-normalize to the one
# attribute 'beff2uφ' below.
__all__ = ['beff2uphi', 'rfgr2beff', 'beff2uφ']

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
