r"""Axis-angle (Rodrigues) rotation (counterpart of
:mod:`mrphy_tpu.utils.rotation`):

    Vo = cosΦ·Vi + (1-cosΦ)·(UᵀVi)·U + sinΦ·U×Vi

broadcast over an optional trailing ``nV`` dim.
"""

import torch

__all__ = ['uphirot']


def uphirot(u, phi, vi):
    r"""Rotate ``vi`` about unit axis ``u`` by angle ``phi``.

    Inputs:
        - ``u``:   `(N, *Nd, xyz)`, rotation axes, assumed unit-norm.
        - ``phi``: `(N, *Nd)`, rotation angles (radians).
        - ``vi``:  `(N, *Nd, xyz, (nV))`, vectors to rotate; the trailing
          ``nV`` dim (if present) broadcasts the rotation across vectors.
    Outputs:
        - ``vo``:  `(N, *Nd, xyz, (nV))`, rotated vectors.
    """
    u, phi, vi = (torch.as_tensor(x) for x in (u, phi, vi))

    if vi.ndim == u.ndim:        # vi: (..., xyz)
        dim, phi_ = -1, phi[..., None]
    else:                        # vi: (..., xyz, nV)
        dim, phi_, u = -2, phi[..., None, None], u[..., None]

    cphi, sphi = torch.cos(phi_), torch.sin(phi_)
    utv = torch.sum(u * vi, dim=dim, keepdim=True)
    uxv = torch.linalg.cross(u.expand_as(vi), vi, dim=dim)
    return cphi * vi + (1 - cphi) * utv * u + sphi * uxv
