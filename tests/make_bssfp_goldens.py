r"""Print the JAX package's results on ``examples/bssfp_fit.py``'s problem
(``chip_smoke.BSSFP_EX``) and on ``examples/mrf_dictionary.py --seq
bssfp``'s (``chip_smoke.MRF_BSSFP_EX``), at the examples' defaults, in
float64 on the CPU: the literals ``GOLDEN_BSSFP_FIT`` and
``GOLDEN_MRF_BSSFP`` that ``chip_smoke.py`` phases 30b and 30c hold the port
to on the card.

The fit is the example's: 512 voxels from numpy default_rng(5), the
α/2-catalysed 35° train of 201 TRs at tr 5 ms over 4 phase-cycle
increments, the catalysation echo dropped, 400 Adam steps (optax, lr 0.05)
on (log T1, log T2, df / 30 Hz, M0) of the mean squared error, all in
float64 (the example runs float32) through JAX's XLA scan. Printed: the
data at ``BSSFP_EX_ENTRIES`` and its largest value, the first loss, its
gradient at ``BSSFP_EX_VOXELS`` and each one's largest value, the losses at
``BSSFP_EX_LOSS_STEPS`` and the fitted maps at ``BSSFP_EX_VOXELS``; then
``ULP_RESPONSE``, the largest relative change of those losses and maps when
the fit runs again on the data moved by one ulp (the rounding the 400 steps
amplify, which sets the bar on the port's), and ``LR_RESPONSE``, the same
change when the learning rate is 0.1% off (a fault the bar must catch).

The MRF problem: the dictionary over the (T1, T2) grid × 15 df, its SVD
basis at energy 1 − 1e-8, the compressed match of the probe and its
unrotated copy, 250 Adam steps of ``match_refine`` from the matched atom.
Printed: the dictionary at ``MRF_BSSFP_ENTRIES`` and its largest value, the
rank, the matched atoms and their m0, the refined parameters, the score
and the fit as the example prints it.

Usage: ``JAX_PLATFORMS=cpu python tests/make_bssfp_goldens.py`` from the
root of a checkout.
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def fit_goldens(jax, jnp):
    import optax

    import chip_smoke
    from mrphy_tpu.ops import ssfp

    c = chip_smoke.BSSFP_EX
    flips, trs, dphis, truth = chip_smoke.bssfp_example_arrays()
    flips, trs = jnp.asarray(flips), jnp.asarray(trs)

    def echoes(m):
        return jnp.stack([ssfp.bssfp_train(flips, tr=trs, dphi=float(dp),
                                           **m)
                          for dp in dphis])[:, :, 1:, :]

    data = jax.jit(echoes)({k: jnp.asarray(v) for k, v in truth.items()})

    def loss(p, data):
        m = dict(T1=jnp.exp(p['T1']), T2=jnp.exp(p['T2']),
                 df=c['df_scale'] * p['df'], M0=p['M0'])
        return jnp.mean((echoes(m) - data) ** 2)

    step = jax.jit(jax.value_and_grad(loss))
    names = chip_smoke.BSSFP_EX_MAPS

    def fit(data, lr=c['lr']):
        p = {k: jnp.full(c['nv'], np.log(v) if k in ('T1', 'T2') else v)
             for k, v in chip_smoke.BSSFP_FIT['start'].items()}
        opt = optax.adam(lr)
        state = opt.init(p)
        losses = []
        for it in range(c['iters']):
            val, g = step(p, data)
            if it == 0:
                g0 = {k: np.asarray(v) for k, v in g.items()}
            up, state = opt.update(g, state)
            p = optax.apply_updates(p, up)
            losses.append(float(val))
        maps = dict(T1=np.exp(np.asarray(p['T1'])),
                    T2=np.exp(np.asarray(p['T2'])),
                    df=c['df_scale'] * np.asarray(p['df']),
                    M0=np.asarray(p['M0']))
        return losses, g0, maps

    losses, g0, maps = fit(data)
    e = np.asarray(data)
    vox = chip_smoke.BSSFP_EX_VOXELS
    steps = chip_smoke.BSSFP_EX_LOSS_STEPS
    gold = {
        'data': [[float(x) for x in e[cy, v, t]]
                 for cy, v, t in chip_smoke.BSSFP_EX_ENTRIES],
        'data_max': float(np.abs(e).max()), 'loss0': losses[0],
        'grad0': {k: [float(x) for x in g0[k][vox]] for k in names},
        'grad0_max': {k: float(np.abs(g0[k]).max()) for k in names},
        'losses': [losses[k] for k in steps],
        'maps': {k: [float(x) for x in maps[k][vox]] for k in names}}
    err = {k: float(np.median(np.abs(maps[k] - truth[k])
                              / (1.0 if k == 'df' else truth[k])))
           for k in names}
    print(f'# median errors {err}; losses {losses[0]:.3e} -> '
          f'{losses[-1]:.3e}')
    print('GOLDEN_BSSFP_FIT = ' + json.dumps(gold, indent=4))

    def response(l1, m1):
        return json.dumps({
            'losses': max(abs(l1[k] - losses[k]) / abs(losses[k])
                          for k in steps),
            'maps': max(float(np.max(np.abs(m1[k][vox] - maps[k][vox])
                                     / np.abs(maps[k][vox])))
                        for k in names)})

    l1, _, m1 = fit(jnp.asarray(np.nextafter(e, np.inf)))
    print('ULP_RESPONSE = ' + response(l1, m1))
    l2, _, m2 = fit(data, lr=1.001 * c['lr'])
    print('LR_RESPONSE = ' + response(l2, m2))


def mrf_goldens(jax, jnp):
    import chip_smoke
    from mrphy_tpu.ops import mrf, ssfp

    c, b = chip_smoke.MRF_EX, chip_smoke.MRF_BSSFP_EX
    flips, _, _, T1a, T2a = (jnp.asarray(x) for x in
                             chip_smoke.mrf_example_arrays())
    nK = T1a.shape[0]
    T1d, T2d = jnp.tile(T1a, b['ndf']), jnp.tile(T2a, b['ndf'])
    dfd = jnp.asarray(np.repeat(np.linspace(-b['df_max'], b['df_max'],
                                            b['ndf']), nK))

    def signals(T1, T2, df):
        return ssfp.bssfp_train(flips, T1=T1, T2=T2, tr=c['tr'], df=df)

    D = jax.jit(signals)(T1d, T2d, dfd)
    basis = mrf.svd_basis(D, energy=c['energy'])
    Dc = mrf.compress(D, basis)
    probe0 = signals(jnp.asarray(c['T1']), jnp.asarray(c['T2']),
                     jnp.asarray(b['df']))
    cp, sp = np.cos(c['ph']), np.sin(c['ph'])
    probe = jnp.stack([cp * probe0[..., 0] - sp * probe0[..., 1],
                       sp * probe0[..., 0] + cp * probe0[..., 1]], -1)
    res = mrf.dict_match_compressed(Dc, jnp.stack([probe, probe0]), basis)
    best = int(res.idx[0])

    def sig(p):
        return signals(jnp.exp(p[0]), jnp.exp(p[1]), 100.0 * p[2])

    p0 = jnp.asarray([[np.log(float(T1d[best])), np.log(float(T2d[best])),
                       float(dfd[best]) / 100.0]])
    p, score = mrf.match_refine(sig, p0, probe[None], iters=c['iters'],
                                lr=c['lr'])
    D = np.asarray(D)
    p = [float(v) for v in np.asarray(p)[0]]
    gold = dict(D=[[float(v) for v in D[a, t]]
                   for a, t in chip_smoke.MRF_BSSFP_ENTRIES],
                D_max=float(np.abs(D).max()), rank=int(basis.B.shape[1]),
                idx=[int(i) for i in res.idx],
                m0=np.asarray(res.m0).tolist(), p=p,
                score=float(np.asarray(score)[0]),
                printed=chip_smoke.mrf_bssfp_printed(p))
    print(f'# {D.shape[0]} atoms, matched T1 {float(T1d[best]):.4f} T2 '
          f'{float(T2d[best]):.4f} df {float(dfd[best]):.2f}')
    print('GOLDEN_MRF_BSSFP = ' + json.dumps(gold, indent=1))


def main():
    import jax
    jax.config.update('jax_enable_x64', True)
    import jax.numpy as jnp
    mrf_goldens(jax, jnp)
    fit_goldens(jax, jnp)


if __name__ == '__main__':
    main()
