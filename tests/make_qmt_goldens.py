r"""Print the JAX package's results on ``examples/qmt_fit.py``'s problem
(``chip_smoke.QMT`` and ``chip_smoke.QMT_EX``, the example's defaults) in
float64 on the CPU: the literal ``GOLDEN_QMT`` that ``chip_smoke.py`` phase
32b holds the port to on the card.

The problem is the example's: 12 voxels of (F, kba, T2b) from numpy
default_rng(0), then the noise, in its order; the pool T1a 1.1 s, T1b 1.0
s, T2a 60 ms, tr 30 ms; 300 TRs of 10° with rf-spoiled phases through
``epgx_mt_spgr`` at K 48, the bound pool saturated per TR by ``wt = π·ω1²·
G(Δ; T2b)·τ_sat`` (the super-Lorentzian ``mt_lineshape``; 5 offsets × 2
powers, τ_sat 15 ms), the magnitude of the last TR's echo as the data; noise
at 0.1% of the largest; 600 Adam steps (optax, lr 0.05) on log (F, kba,
T2b) of the mean squared error, all in float64. JAX runs its XLA scan with
the example's batched ``wt[:, None]``; on the card the port runs the same
model through the float64 kernels in their rank-1 form (a constant ``wt``
train of π·ω1²·τ_sat and ``wscale = G``). Printed: the noiseless data of
every voxel and measurement and its largest value, the first loss, its
gradient w.r.t. the three log maps and each one's largest value, the losses
at ``QMT_EX_LOSS_STEPS`` and the fitted maps; then ``ULP_RESPONSE``, the
largest relative change of those losses and maps when the fit runs again on
the noisy data moved by one ulp: the rounding the 600 steps amplify, which
sets the bar on the port's losses and maps; and ``LR_RESPONSE``, the same
change when the learning rate is 0.1% off: a fault the bar must catch.

Usage: ``JAX_PLATFORMS=cpu python tests/make_qmt_goldens.py`` from the root
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

    c, ex = chip_smoke.QMT, chip_smoke.QMT_EX
    nv = ex['nv']
    F, kba, T2b, rng = chip_smoke.qmt_truth(nv)
    fl = jnp.full(ex['ntr'], np.deg2rad(c['flip']))
    ph = epg.rf_spoil_phases(ex['ntr'])
    w1rms = 2 * np.pi * np.asarray(c['w1rms'])

    def model(logp):
        p = {k: jnp.exp(v) for k, v in logp.items()}
        M0b, M0a = p['F'], 1.0 - p['F']
        outs = []
        for d in c['offs']:
            G = epg.mt_lineshape(jnp.asarray(d), p['T2b'])
            for w1 in w1rms:
                wt = jnp.pi * w1 ** 2 * G * c['tau']
                s = epg.epgx_mt_spgr(
                    fl, ph, T1a=c['T1a'], T2a=c['T2a'], T1b=c['T1b'],
                    kab=p['kba'] * M0b / M0a, kba=p['kba'], tr=c['tr'],
                    wt=wt[:, None], M0a=M0a, M0b=M0b, K=c['K'])
                outs.append(jnp.hypot(s[..., -1, 0], s[..., -1, 1]))
        return jnp.stack(outs, -1)                   # (nv, nm)

    truth = dict(F=jnp.log(jnp.asarray(F)), kba=jnp.log(jnp.asarray(kba)),
                 T2b=jnp.log(jnp.asarray(T2b)))
    y0 = jax.jit(model)(truth)
    sigma = ex['noise'] / 100 * float(y0.max())
    y = y0 + sigma * jnp.asarray(rng.standard_normal(y0.shape))

    def loss(logp, y):
        return jnp.mean((model(logp) - y) ** 2)

    step = jax.jit(jax.value_and_grad(loss))

    def fit(y, lr=ex['lr']):
        logp = {k: jnp.log(jnp.full(nv, v)) for k, v in ex['start'].items()}
        opt = optax.adam(lr)
        state = opt.init(logp)
        losses = []
        for it in range(ex['iters']):
            val, g = step(logp, y)
            if it == 0:
                g0 = {k: np.asarray(v) for k, v in g.items()}
            up, state = opt.update(g, state)
            logp = optax.apply_updates(logp, up)
            losses.append(float(val))
        return losses, g0, {k: np.asarray(jnp.exp(v))
                            for k, v in logp.items()}

    losses, g0, maps = fit(y)
    keys = tuple(ex['start'])
    gold = {
        'data': np.asarray(y0).tolist(), 'data_max': float(y0.max()),
        'loss0': losses[0],
        'grad0': {k: g0[k].tolist() for k in keys},
        'grad0_max': {k: float(np.abs(g0[k]).max()) for k in keys},
        'losses': [losses[k] for k in chip_smoke.QMT_EX_LOSS_STEPS],
        'maps': {k: maps[k].tolist() for k in keys}}
    print('GOLDEN_QMT = ' + json.dumps(gold, indent=4))
    truth_n = dict(F=F, kba=kba, T2b=T2b)
    print('median relative errors: ' + json.dumps(
        {k: float(np.median(np.abs(maps[k] / truth_n[k] - 1))) for k in keys}))
    steps = chip_smoke.QMT_EX_LOSS_STEPS

    def response(l1, m1):
        return json.dumps({
            'losses': max(abs(l1[k] - losses[k]) / abs(losses[k])
                          for k in steps),
            'maps': max(float(np.max(np.abs(m1[k] - maps[k])
                                     / np.abs(maps[k]))) for k in keys)})

    # the fit's response to a 1-ulp change of its data: the same 600 steps
    # on the noisy data moved one ulp towards +inf
    l1, _, m1 = fit(jnp.asarray(np.nextafter(np.asarray(y), np.inf)))
    print('ULP_RESPONSE = ' + response(l1, m1))
    # and to a fault of the fit's own: its learning rate 0.1% off
    l2, _, m2 = fit(y, lr=1.001 * ex['lr'])
    print('LR_RESPONSE = ' + response(l2, m2))


if __name__ == '__main__':
    main()
