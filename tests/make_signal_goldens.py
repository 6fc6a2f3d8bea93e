r"""Print the JAX package's results on the CG-SENSE problem of
``chip_smoke.py`` (``RECON``, the default problem of
``examples/recon_sense.py``) in float64 on the CPU (XLA route): the
literal ``GOLDEN_RECON`` that ``chip_smoke.py`` phase 13a holds the port
to on the card — the acquired signal and ∂Σs²/∂ktraj at ``RECON_STEPS``
with their largest values, and the CG-SENSE image at ``RECON_PIXELS``.

Usage: ``JAX_PLATFORMS=cpu python tests/make_signal_goldens.py`` from the
root of a checkout (about ten seconds on one CPU core).
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

jax.config.update('jax_enable_x64', True)

import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from mrphy_tpu.ops import signal as sig  # noqa: E402


def cg_sense(A, AH, s, iters, lam):
    r"""The CG loop of ``chip_smoke.cg_sense`` (examples/recon_sense.py's)
    in JAX."""
    b = AH(s)
    x, r = jnp.zeros_like(b), b
    p, rs = r, jnp.vdot(r, r)
    rs0 = rs
    for _ in range(iters):
        live = rs > 1e-12 * rs0
        Ap = AH(A(p)) + lam * p
        alpha = jnp.where(live, rs / jnp.vdot(p, Ap), 0.0)
        x, r = x + alpha * p, r - alpha * Ap
        rs_new = jnp.vdot(r, r)
        p = jnp.where(live, r + (rs_new / jnp.maximum(rs, 1e-30)) * p, p)
        rs = rs_new
    return x, jnp.sqrt(rs)


def main():
    loc, x_true, sens, df, k = (jnp.asarray(a)
                                for a in chip_smoke.recon_arrays())
    nM = loc.shape[1]
    M = jnp.concatenate([x_true, jnp.zeros((nM, 1))], -1)[None]

    @jax.jit
    def A(x):
        Mx = jnp.concatenate([x, jnp.zeros((nM, 1))], -1)[None]
        return sig.signal(Mx, loc, k, sens=sens, df=df)

    @jax.jit
    def AH(s):
        return sig.signal_adjoint(s, loc, k, sens=sens, df=df).sum(0)

    steps = np.asarray(chip_smoke.RECON_STEPS)
    s = A(x_true)
    dk = jax.grad(lambda kk: jnp.sum(sig.signal(
        M, loc, kk, sens=sens, df=df) ** 2))(k)
    x, res = cg_sense(A, AH, s, chip_smoke.RECON['iters'],
                      chip_smoke.RECON['lam'])
    out = {'s': np.asarray(s[0][:, steps]).tolist(),
           's_max': float(jnp.abs(s).max()),
           'dk': np.asarray(dk[0][:, steps]).tolist(),
           'dk_max': float(jnp.abs(dk).max()),
           'x': np.asarray(x[np.asarray(chip_smoke.RECON_PIXELS)]).tolist()}
    err = float(jnp.linalg.norm(x - x_true) / jnp.linalg.norm(x_true))
    print(f'# nT {k.shape[-1]}, CG residual {float(res)!r}, image error '
          f'{err!r}')
    print('GOLDEN_RECON = ' + json.dumps(out))


if __name__ == '__main__':
    main()
