r"""Print the JAX package's results on ``examples/qmt_fit.py``'s problem over
a variable-TR train (``chip_smoke.QMT`` and ``chip_smoke.QMT_V_EX``) in
float64 on the CPU: the literal ``GOLDEN_QMTV`` that ``chip_smoke.py`` phase
34b holds the port to on the card.

The problem is the example's pool and protocol: 12 voxels of (F, kba, T2b)
from numpy default_rng(0), then the noise, in its order; T1a 1.1 s, T1b 1.0
s, T2a 60 ms; 300 TRs of 10° with rf-spoiled phases through
``epgx_mt_spgr`` at K 48, the bound pool saturated per TR by ``wt = π·ω1²·
G(Δ; T2b)·τ_sat`` (the super-Lorentzian ``mt_lineshape``; 5 offsets × 2
powers, τ_sat 15 ms), the magnitude of the last TR's echo as the data, noise
at 0.1% of the largest; with the example's 30 ms TR replaced by the train
``0.03 + 0.005·sin(2πt/37)`` s (``chip_smoke.qmtv_trs``). The fit is the
mean squared error of log (F, kba, T2b), 20 Adam steps (optax, lr 0.05),
all in float64. JAX runs its XLA scan with the example's batched ``wt[:,
None]``; on the card the port runs the same model through the float64
instances of its variable-TR kernels (``xmt_v_fwd``, ``xmt_v_fwd_chk``,
``xmt_v_bwd``) in their rank-1 form (a constant ``wt`` train of
π·ω1²·τ_sat and ``wscale = G``). Printed: the echoes of the 4 kHz, 700 Hz
measurement at ``QMT_V_EX_ENTRIES`` and their largest |value|, the
noiseless data and its largest value, the first loss, its gradient w.r.t.
the three log maps and every element of the tr train with each one's
largest magnitude, the losses of the 20 steps; then ``ULP_RESPONSE``, the
largest relative change of those losses when the fit runs again on the
noisy data moved by one ulp (the rounding the steps amplify).

Usage: ``JAX_PLATFORMS=cpu python tests/make_qmtv_goldens.py`` from the
root of a checkout (about 90 s on one core).
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

    c, ex = chip_smoke.QMT, chip_smoke.QMT_V_EX
    nv = ex['nv']
    F, kba, T2b, rng = chip_smoke.qmt_truth(nv)
    fl = jnp.full(ex['ntr'], np.deg2rad(c['flip']))
    ph = epg.rf_spoil_phases(ex['ntr'])
    trs0 = jnp.asarray(chip_smoke.qmtv_trs(ex['ntr']))
    w1rms = 2 * np.pi * np.asarray(c['w1rms'])

    def echoes(logp, trs):
        r"""Every measurement's echoes, (offsets × powers, nv, nTR, 2)."""
        p = {k: jnp.exp(v) for k, v in logp.items()}
        M0b, M0a = p['F'], 1.0 - p['F']
        outs = []
        for d in c['offs']:
            G = epg.mt_lineshape(jnp.asarray(d), p['T2b'])
            for w1 in w1rms:
                wt = jnp.pi * w1 ** 2 * G * c['tau']
                outs.append(epg.epgx_mt_spgr(
                    fl, ph, T1a=c['T1a'], T2a=c['T2a'], T1b=c['T1b'],
                    kab=p['kba'] * M0b / M0a, kba=p['kba'], tr=trs,
                    wt=wt[:, None], M0a=M0a, M0b=M0b, K=c['K']))
        return jnp.stack(outs)

    def model(logp, trs):
        s = echoes(logp, trs)
        return jnp.hypot(s[..., -1, 0], s[..., -1, 1]).T       # (nv, nm)

    truth = dict(F=jnp.log(jnp.asarray(F)), kba=jnp.log(jnp.asarray(kba)),
                 T2b=jnp.log(jnp.asarray(T2b)))
    s0 = np.asarray(jax.jit(echoes)(truth, trs0))
    y0 = np.asarray(jax.jit(model)(truth, trs0))
    sigma = ex['noise'] / 100 * float(y0.max())
    y = y0 + sigma * rng.standard_normal(y0.shape)

    def loss(logp, trs, y):
        return jnp.mean((model(logp, trs) - y) ** 2)

    step = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))

    def fit(y):
        logp = {k: jnp.log(jnp.full(nv, v)) for k, v in ex['start'].items()}
        opt = optax.adam(ex['lr'])
        state = opt.init(logp)
        losses = []
        for it in range(ex['iters']):
            val, (g, gtr) = step(logp, trs0, jnp.asarray(y))
            if it == 0:
                g0 = {k: np.asarray(v) for k, v in g.items()}
                g0['tr'] = np.asarray(gtr)
            up, state = opt.update(g, state)
            logp = optax.apply_updates(logp, up)
            losses.append(float(val))
        return losses, g0

    losses, g0 = fit(y)
    # the 4 kHz, 700 Hz measurement (offsets outer, powers inner)
    sm = s0[2 * 1 + 1]
    gold = {
        'echoes': [sm[v, t].tolist() for v, t in chip_smoke.QMT_V_EX_ENTRIES],
        'echoes_max': float(np.abs(sm).max()),
        'data': y0.tolist(), 'data_max': float(y0.max()),
        'loss0': losses[0],
        'grad0': {k: v.tolist() for k, v in g0.items()},
        'grad0_max': {k: float(np.abs(v).max()) for k, v in g0.items()},
        'losses': losses}
    print('GOLDEN_QMTV = ' + json.dumps(gold, indent=4))
    # the fit's response to a 1-ulp change of its data: the same steps on
    # the noisy data moved one ulp towards +inf
    l1, _ = fit(np.nextafter(y, np.inf))
    print('ULP_RESPONSE = ' + json.dumps({'losses': max(
        abs(a - b) / abs(b) for a, b in zip(l1, losses))}))


if __name__ == '__main__':
    main()
