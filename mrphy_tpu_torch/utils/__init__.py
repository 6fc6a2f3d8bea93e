r"""Utilities ported so far (counterpart of :mod:`mrphy_tpu.utils`): grid
indexing and k-space conversions, the RF and slew reparametrizations of
pulse design, the Rodrigues rotation, interpolation matrices, and the
hardware models the design loop penalizes (GIRF, SAR VOPs, PNS), the
trajectory generators and the receive-array utilities of the acquisition
path, with the reference's Unicode aliases (``uφrot``, ``rf2tρθ``, ``tρθ2rf``,
``rf2lρθ``, ``lρθ2rf``).
"""

from mrphy_tpu_torch.utils.conversions import ctrsub, g2k, g2s, k2g, s2g
from mrphy_tpu_torch.utils.rf import (rf_c2r, rf_r2c, rf2trho_theta,
                                      trho_theta2rf, rf2lrho_theta,
                                      lrho_theta2rf, rfclamp)
from mrphy_tpu_torch.utils.slew import s2ts, ts2s, sclamp
from mrphy_tpu_torch.utils.rotation import uphirot
from mrphy_tpu_torch.utils.interp import interp_matrix, interp1d_apply
from mrphy_tpu_torch.utils.girf import apply_girf, exp_decay_girf
from mrphy_tpu_torch.utils.sar import sar_vops, vop_compress
from mrphy_tpu_torch.utils.pns import pns_kernel, pns_predict, pns_max
from mrphy_tpu_torch.utils.traj import (spiral2d, epi, radial, radial3d,
                                        rosette, trapezoid, rewinder,
                                        mintime_gradient, traj_check)
from mrphy_tpu_torch.utils.coils import (coil_compress, apply_ccmat,
                                         noise_whiten_mat, add_noise,
                                         adaptive_maps, espirit_maps,
                                         gfactor_sense, gfactor_replica,
                                         replica_std)

# Python NFKC-normalizes identifiers: `uϕrot` (U+03D5) and `uφrot`
# (U+03C6) both resolve to this one attribute.
uφrot = uphirot
rf2tρθ = rf2trho_theta
tρθ2rf = trho_theta2rf
rf2lρθ = rf2lrho_theta
lρθ2rf = lrho_theta2rf

__all__ = ['ctrsub', 'g2k', 'g2s', 'k2g', 's2g', 'rf_c2r', 'rf_r2c',
           'rf2trho_theta', 'trho_theta2rf', 'rf2lrho_theta',
           'lrho_theta2rf', 'rfclamp', 's2ts', 'ts2s', 'sclamp', 'uphirot',
           'interp_matrix', 'interp1d_apply', 'apply_girf',
           'exp_decay_girf', 'sar_vops', 'vop_compress', 'pns_kernel',
           'pns_predict', 'pns_max',
           'spiral2d', 'epi', 'radial', 'radial3d', 'rosette',
           'trapezoid', 'rewinder', 'mintime_gradient', 'traj_check',
           'coil_compress', 'apply_ccmat', 'noise_whiten_mat',
           'add_noise', 'adaptive_maps', 'espirit_maps',
           'gfactor_sense', 'gfactor_replica', 'replica_std',
           'uφrot', 'rf2tρθ', 'tρθ2rf', 'rf2lρθ', 'lρθ2rf']
