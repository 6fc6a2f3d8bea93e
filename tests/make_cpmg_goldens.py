r"""Print the JAX package's results on the CPMG problem of ``chip_smoke.py``
(``CPMG_EX``, the problem of ``examples/dwi_adc_fit.py``) in float64 on the
CPU: the literal ``GOLDEN_CPMG`` that ``chip_smoke.py`` phase 20b holds the
port to on the card. The model runs as the example writes it: the
refocusing train broadcast to every voxel (a 2-D train, so XLA's scan), the
three crushers by ``vmap``, ``optax.adam`` on (log T2, log D). Printed: the
target echo magnitudes at ``CPMG_EX_ENTRIES`` and their largest value, the
first loss and its gradient at ``CPMG_EX_VOXELS`` (with each gradient's
largest magnitude), the losses at ``CPMG_EX_LOSS_STEPS`` and the fitted
(log T2, log D) at ``CPMG_EX_VOXELS`` after the last step.

Usage: ``JAX_PLATFORMS=cpu python tests/make_cpmg_goldens.py`` from the
root of a checkout (under a minute on one CPU core).
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    import jax
    jax.config.update('jax_enable_x64', True)
    import jax.numpy as jnp
    import optax

    import chip_smoke
    from mrphy_tpu.ops import epg

    c = chip_smoke.CPMG_EX
    nV, nE = c['nV'], c['nE']
    T2_true, D_true = (jnp.asarray(x)
                       for x in chip_smoke.cpmg_example_arrays())
    flips = jnp.deg2rad(c['flip']) * jnp.ones(nE)
    dks = jnp.asarray(c['dks'])

    def model(T2, D):
        def one(dk):
            e = epg.epg_cpmg(jnp.broadcast_to(flips, (nV, nE)), T1=c['T1'],
                             T2=T2, esp=c['esp'], D=D, dk=dk)
            return jnp.hypot(e[..., 0], e[..., 1])
        return jax.vmap(one)(dks)

    target = jax.jit(model)(T2_true, D_true)

    @jax.jit
    def loss(p):
        m = model(jnp.exp(p['lt2']), jnp.exp(p['ld']))
        return jnp.mean((m - target) ** 2)

    p = {'lt2': jnp.log(c['T2_0'] * jnp.ones(nV)),
         'ld': jnp.log(c['D_0'] * jnp.ones(nV))}
    opt = optax.adam(c['lr'])
    state = opt.init(p)

    @jax.jit
    def step(p, state):
        ls, g = jax.value_and_grad(loss)(p)
        up, state = opt.update(g, state)
        return optax.apply_updates(p, up), state, ls, g

    losses = []
    for i in range(c['iters']):
        p, state, ls, g = step(p, state)
        losses.append(float(ls))
        if i == 0:
            g0 = g
    tgt = np.asarray(target)
    vox = chip_smoke.CPMG_EX_VOXELS
    gold = dict(
        target=[float(tgt[d, v, e]) for d, v, e in chip_smoke.CPMG_EX_ENTRIES],
        target_max=float(np.abs(tgt).max()),
        loss0=losses[0],
        grad0={k: [float(g0[k][v]) for v in vox] for k in ('lt2', 'ld')},
        grad0_max={k: float(jnp.abs(g0[k]).max()) for k in ('lt2', 'ld')},
        losses=[losses[i] for i in chip_smoke.CPMG_EX_LOSS_STEPS],
        p={k: [float(p[k][v]) for v in vox] for k in ('lt2', 'ld')})
    print('GOLDEN_CPMG = ' + json.dumps(gold, indent=1))


if __name__ == '__main__':
    main()
