r"""Utilities ported so far: grid indexing, k-space conversions and the
Rodrigues rotation (counterpart of :mod:`mrphy_tpu.utils`), with the
reference's Unicode alias ``uφrot``.
"""

from mrphy_tpu_torch.utils.conversions import ctrsub, g2k, g2s, k2g, s2g
from mrphy_tpu_torch.utils.rotation import uphirot

# Python NFKC-normalizes identifiers: `uϕrot` (U+03D5) and `uφrot`
# (U+03C6) both resolve to this one attribute.
uφrot = uphirot

__all__ = ['ctrsub', 'g2k', 'g2s', 'k2g', 's2g', 'uphirot', 'uφrot']
