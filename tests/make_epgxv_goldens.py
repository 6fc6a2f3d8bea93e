r"""Print the JAX package's results on the exchange-MRF problem of
``chip_smoke.py`` over its variable-TR schedule (``MRFX_EX``, the problem of
``examples/mrfx_exchange.py``) in float64 on the CPU: the literal
``GOLDEN_MRFXV`` that ``chip_smoke.py`` phase 24b holds the port to on the
card.

The problem is the example's at its defaults (150 TRs a segment, two flip
scales, its tr train ``0.012 + 0.006·(0.5 + 0.5·sin(2πt/41))`` s for the
first segment and the same train reversed for the second, a 10 × 8 (T1a,
kab) grid, K 16, its off-grid probe, 250 Adam steps at lr 0.02 of 1 − the
real correlation), all in float64 (the example casts its flips, trains and
grid to float32). On the card the port's ``epgx_spgr`` runs it through the
float64 instances of its variable-TR kernels (``xspgr_v_fwd``,
``xspgr_v_fwd_chk``, ``xspgr_v_bwd``); here JAX runs its XLA scan. Printed:
the dictionary at ``MRFX_EX_ENTRIES`` and its largest value, the basis rank
at energy 1 − 1e-8, the matched atom, the kab separation (kab 1 against 15
at T1a 1 s), the first loss and its gradient w.r.t. (log T1a, log kab), the
losses at ``MRFX_EX_LOSS_STEPS`` and the fitted (T1a, kab).
``tests/make_epgx_goldens.py`` prints the same at a scalar tr (phase 22b).

Usage: ``JAX_PLATFORMS=cpu python tests/make_epgxv_goldens.py`` from the
root of a checkout.
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
    from mrphy_tpu.ops import epg, mrf

    c = chip_smoke.MRFX_EX
    pool = chip_smoke.XMRF_POOL
    t = np.arange(c['ntr'])
    flips = jnp.asarray(np.deg2rad(8 + 55 * np.abs(np.sin(np.pi * t / 60))))
    phis = epg.rf_spoil_phases(c['ntr'])
    trs = jnp.asarray(0.012 + 0.006 * (0.5 + 0.5 * np.sin(2 * np.pi * t
                                                          / 41)))

    def seg(t1a, kab, fscale, trv):
        return epg.epgx_spgr(flips * fscale, phis, T1a=t1a, T2a=pool['T2a'],
                             T1b=pool['T1b'], T2b=pool['T2b'], kab=kab,
                             kba=kab / pool['M0b'], M0a=pool['M0a'],
                             M0b=pool['M0b'], tr=trv, K=c['K'])

    def gen(t1a, kab):
        return jnp.concatenate([seg(t1a, kab, f, trv) for f, trv in
                                zip(c['scales'], (trs, trs[::-1]))],
                               axis=-2)

    T1, Kab = (jnp.asarray(x) for x in chip_smoke.mrfx_example_arrays())
    D = jax.jit(gen)(T1, Kab)
    s_lo = gen(jnp.asarray(1.0), jnp.asarray(1.0))
    s_hi = gen(jnp.asarray(1.0), jnp.asarray(15.0))
    sep = float(jnp.max(jnp.abs(s_lo - s_hi)) / jnp.max(jnp.abs(s_lo)))
    basis = mrf.svd_basis(D, energy=c['energy'])
    probe = gen(jnp.asarray(c['T1a']), jnp.asarray(c['kab']))
    res = mrf.dict_match_compressed(mrf.compress(D, basis), probe[None],
                                    basis)
    i = int(res.idx[0])
    pr = probe.reshape(-1)

    def loss(p):
        s = gen(jnp.exp(p['l1']), jnp.exp(p['lk'])).reshape(-1)
        return 1.0 - jnp.sum(s * pr) / jnp.sqrt(jnp.sum(s * s)
                                                * jnp.sum(pr * pr))

    p = {'l1': jnp.log(T1[i]), 'lk': jnp.log(Kab[i])}
    opt = optax.adam(c['lr'])
    state = opt.init(p)
    step = jax.jit(jax.value_and_grad(loss))
    losses = []
    for it in range(c['iters']):
        val, g = step(p)
        if it == 0:
            g0 = [float(g['l1']), float(g['lk'])]
        up, state = opt.update(g, state)
        p = optax.apply_updates(p, up)
        losses.append(float(val))
    Dn = np.asarray(D)
    gold = {
        'D': [[float(x) for x in Dn[a, k]]
              for a, k in chip_smoke.MRFX_EX_ENTRIES],
        'D_max': float(np.abs(Dn).max()), 'rank': int(basis.B.shape[1]),
        'idx': i, 'sep': sep, 'loss0': losses[0], 'grad0': g0,
        'losses': [losses[k] for k in chip_smoke.MRFX_EX_LOSS_STEPS],
        'p': [float(jnp.exp(p['l1'])), float(jnp.exp(p['lk']))]}
    print('GOLDEN_MRFXV = ' + json.dumps(gold, indent=4))


if __name__ == '__main__':
    main()
