r"""Print the JAX package's results on ``examples/mwf_fit.py``'s problem
(``chip_smoke.MWF_EX``, at the example's defaults) in float64 on the CPU:
the literal ``GOLDEN_MWF`` that ``chip_smoke.py`` phase 26b holds the port
to on the card.

The problem is the example's: 24 voxels from numpy default_rng(0) (MWF,
T2a, T2b and the b1 map, then the noise, in its order), 32 echoes at esp 10
ms through ``epgx_cpmg`` with its per-voxel π·b1 refocusing train, noise at
0.2% of the largest first echo, 800 Adam steps (optax, lr 0.03) on the log
pools (M0a, M0b, T2a, T2b) of the mean squared error, all in float64 (the
example runs float32). On the card the port's ``epgx_cpmg`` runs it through
the float64 instances of its kernels (``xcpmg_fwd``, ``xcpmg_fwd_chk``,
``xcpmg_bwd``) with the shared π train and the b1 map as ``b1=``; here JAX
runs its XLA scan. Printed: the noiseless echoes at ``MWF_EX_ENTRIES`` and
their largest value, the first loss, its gradient at ``MWF_EX_VOXELS`` and
each one's largest value, the losses at ``MWF_EX_LOSS_STEPS`` and the
fitted MWF of every voxel; then ``ULP_RESPONSE``, the largest relative
change of those losses and of the fitted MWF when the fit runs again on the
noisy echoes moved by one ulp: the rounding the 800 steps amplify, which
sets the bar on the port's losses and MWF; and ``LR_RESPONSE``, the same
change when the learning rate is 0.1% off: a fault the bar must catch.

Usage: ``JAX_PLATFORMS=cpu python tests/make_mwf_goldens.py`` from the root
of a checkout.
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

    c, nv = chip_smoke.MWF, chip_smoke.MWF_EX['nv']
    mwf, T2a, T2b, b1, rng = chip_smoke.mwf_truth(nv)
    flips = jnp.asarray(np.pi * b1[:, None] * np.ones((nv, c['nE'])))

    def train(p):
        return epg.epgx_cpmg(
            flips, T1a=c['T1a'], T2a=p['T2a'], T1b=c['T1b'], T2b=p['T2b'],
            kab=c['kba'] * p['M0b'] / p['M0a'], kba=c['kba'], esp=c['esp'],
            M0a=p['M0a'], M0b=p['M0b'])

    truth = {k: jnp.asarray(v) for k, v in
             chip_smoke.mwf_pools(mwf, T2a, T2b).items()}
    ech0 = jax.jit(train)(truth)
    sigma = c['noise'] / 100 * float(jnp.max(jnp.abs(ech0[:, 0])))
    ech = ech0 + sigma * jnp.asarray(rng.standard_normal(ech0.shape))

    def loss(logp, ech):
        return jnp.mean((train({k: jnp.exp(v) for k, v in logp.items()})
                         - ech) ** 2)

    step = jax.jit(jax.value_and_grad(loss))

    def fit(ech, lr=c['lr']):
        logp = {k: jnp.log(jnp.full(nv, v)) for k, v in c['start'].items()}
        opt = optax.adam(lr)
        state = opt.init(logp)
        losses = []
        for it in range(chip_smoke.MWF_EX['iters']):
            val, g = step(logp, ech)
            if it == 0:
                g0 = {k: np.asarray(v) for k, v in g.items()}
            up, state = opt.update(g, state)
            logp = optax.apply_updates(logp, up)
            losses.append(float(val))
        p = {k: np.asarray(jnp.exp(v)) for k, v in logp.items()}
        return losses, g0, p['M0b'] / (p['M0a'] + p['M0b'])

    losses, g0, mwf_fit = fit(ech)
    e0 = np.asarray(ech0)
    vox = chip_smoke.MWF_EX_VOXELS
    gold = {
        'echoes': [[float(x) for x in e0[v, e]]
                   for v, e in chip_smoke.MWF_EX_ENTRIES],
        'echoes_max': float(np.abs(e0).max()), 'loss0': losses[0],
        'grad0': {k: [float(x) for x in g0[k][vox]] for k in c['start']},
        'grad0_max': {k: float(np.abs(g0[k]).max()) for k in c['start']},
        'losses': [losses[k] for k in chip_smoke.MWF_EX_LOSS_STEPS],
        'mwf': [float(x) for x in mwf_fit]}
    print('GOLDEN_MWF = ' + json.dumps(gold, indent=4))
    # the fit's response to a 1-ulp change of its data: the same 800 steps
    # on the noisy echoes moved one ulp towards +inf
    steps = chip_smoke.MWF_EX_LOSS_STEPS
    def response(l1, m1):
        return json.dumps({
            'losses': max(abs(l1[k] - losses[k]) / abs(losses[k])
                          for k in steps),
            'mwf': float(np.max(np.abs(m1 - mwf_fit) / np.abs(mwf_fit)))})

    l1, _, m1 = fit(jnp.asarray(np.nextafter(np.asarray(ech), np.inf)))
    print('ULP_RESPONSE = ' + response(l1, m1))
    # and to a fault of the fit's own: its learning rate 0.1% off
    l2, _, m2 = fit(ech, lr=1.001 * c['lr'])
    print('LR_RESPONSE = ' + response(l2, m2))


if __name__ == '__main__':
    main()
