r"""Internal shape/broadcast helpers shared across the package."""

import torch

__all__ = ['rshape', 'asarr', 'largest_divisor_leq',
           'largest_divisor_leq_pref']


def largest_divisor_leq(n: int, bound: int) -> int:
    r"""Largest divisor of ``n`` that is ≤ ``bound`` (≥ 1)."""
    best, i = 1, 1
    while i * i <= n:
        if n % i == 0:
            for d in (i, n // i):
                if best < d <= bound:
                    best = d
        i += 1
    return best


def largest_divisor_leq_pref(n: int, bound: int, pref: int) -> int:
    r"""Largest divisor of ``n`` ≤ ``bound`` that is itself a multiple
    of ``pref``, else the plain largest divisor ≤ ``bound``."""
    best = 0
    i = 1
    while i * i <= n:
        if n % i == 0:
            for d in (i, n // i):
                if best < d <= bound and d % pref == 0:
                    best = d
        i += 1
    return best if best else largest_divisor_leq(n, bound)


def asarr(x, like: torch.Tensor) -> torch.Tensor:
    r"""``x`` as a tensor of ``like``'s dtype and device (a no-op that
    keeps the autograd graph when it already is one)."""
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def rshape(x, ndim: int) -> torch.Tensor:
    r"""Right-pad ``x`` with trailing singleton dims up to ``ndim``.

    The reference threads scalars/`(N,)`/`(N,*Nd)` parameters through every
    API by reshaping ``x.shape + (ndim - x.ndim)*(1,)``; this is the same
    rule for tensors and Python scalars.
    """
    x = torch.as_tensor(x)
    if x.ndim > ndim:
        raise ValueError(f'cannot right-pad array of ndim {x.ndim} to {ndim}')
    return x.reshape(tuple(x.shape) + (ndim - x.ndim) * (1,))
