r"""Print the JAX package's results on the CEST fit problem of
``chip_smoke.py`` (``CEST_FIT``, the problem of ``examples/cest_fit.py``)
in float64 on the CPU (XLA backend): the literals ``GOLDEN_CEST_*`` that
``chip_smoke.py`` phase 11a holds the port to on the card.

Usage: ``JAX_PLATFORMS=cpu python tests/make_cest_goldens.py`` from the
root of a checkout (about a minute on one CPU core).
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
import optax  # noqa: E402

import chip_smoke  # noqa: E402
from mrphy_tpu.ops import mc  # noqa: E402


def main():
    c = chip_smoke.CEST_FIT
    kab_true, df0_true, offsets, rf = (jnp.asarray(x) for x in
                                       chip_smoke.cest_fit_arrays())
    nV, nF, nT = c['nV'], c['nF'], c['nT']
    nP, nM = rf.shape[0], nV * nF
    gr = jnp.zeros((nP, 3, nT))
    loc = jnp.zeros((nP, nM, 3))
    Mia = jnp.broadcast_to(jnp.asarray([0., 0., c['Ma0']]), (nP, nM, 3))
    Mib = jnp.broadcast_to(jnp.asarray([0., 0., c['Mb0']]), (nP, nM, 3))
    off_pair = jnp.tile(offsets, nV)

    def zspectra(kab_v, df0_v, rf, T2b):
        kab = jnp.repeat(kab_v, nF)[None]
        df = (jnp.repeat(df0_v, nF) - off_pair)[None]
        Ma, _ = mc.blochsim_mc_rfgr(
            Mia, Mib, rf, gr, loc, T1a=c['T1a'], T2a=c['T2a'],
            T1b=c['T1b'], T2b=T2b, kab=kab, kba=kab * (c['Ma0'] / c['Mb0']),
            Ma0=c['Ma0'], Mb0=c['Mb0'], dfb=c['dfb'], df=df, dt=c['dt'],
            backend='xla')
        return Ma[:, :, 2].reshape(nP, nV, nF) / c['Ma0']

    T2b = jnp.asarray(c['T2b'])
    Zdata = zspectra(kab_true, df0_true, rf, T2b)

    def loss(logk, dfs, rf, T2b):
        Z = zspectra(jnp.exp(logk), c['df_scale'] * dfs, rf, T2b)
        return jnp.mean((Z - Zdata) ** 2)

    zero = jnp.zeros(nV)
    g = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(zero, zero, rf, T2b)
    step = jax.jit(jax.value_and_grad(
        lambda p: loss(p['logk'], p['dfs'], rf, T2b)))
    opt = optax.adam(c['lr'])
    p = {'logk': zero, 'dfs': zero}
    st = opt.init(p)
    losses = []
    for _ in range(c['niter']):
        val, gp = step(p)
        up, st = opt.update(gp, st)
        p = optax.apply_updates(p, up)
        losses.append(float(val))
    grf = np.asarray(g[2])
    out = dict(
        GOLDEN_CEST_Z=np.asarray(Zdata)[:, chip_smoke.CEST_Z_VOXELS].tolist(),
        GOLDEN_CEST_GRAD={'logk': np.asarray(g[0]).tolist(),
                          'dfs': np.asarray(g[1]).tolist(),
                          'rf': grf[..., chip_smoke.CEST_RF_STEPS].tolist(),
                          'T2b': float(g[3])},
        GOLDEN_CEST_GRAD_MAX={'logk': float(np.abs(g[0]).max()),
                              'dfs': float(np.abs(g[1]).max()),
                              'rf': float(np.abs(grf).max()),
                              'T2b': abs(float(g[3]))},
        GOLDEN_CEST_LOSSES=losses)
    for k, v in out.items():
        print(f'{k} = {json.dumps(v)}')


if __name__ == '__main__':
    main()
