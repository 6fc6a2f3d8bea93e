r"""Print the JAX package's results on the myelin-water model over an
echo-spacing train (``chip_smoke.MWF_V_EX``) in float64 on the CPU: the
literal ``GOLDEN_MWF_V`` that ``chip_smoke.py`` phase 28b holds the port to
on the card.

The problem: 24 voxels of ``examples/mwf_fit.py``'s tissue (numpy
default_rng(0): MWF, T2a, T2b and the b1 map, in the example's order), its
32 refocusing π pulses scaled by the b1 map (``b1=``) over phase 28's
echo-spacing train ``chip_smoke.MWF_V['esps']`` (echoes 1-16 at 6 ms, 17-32
at 14 ms), through ``epgx_cpmg`` on JAX's XLA scan; the loss Σ w·echoes
with weights ``w (24, 32, 2)`` from numpy default_rng(1). Printed: the
noiseless echoes at ``MWF_V_EX_ENTRIES`` and their largest value, the
loss's gradient w.r.t. every element of the esp train and its largest
value, and its gradient w.r.t. the log pools (M0a, M0b, T2a, T2b) at
``MWF_V_EX_VOXELS`` and each one's largest value, all at the truth. On the
card the port runs it through the float64 instances of the echo-spacing
kernels (``xcpmg_v_fwd``, ``xcpmg_v_fwd_chk``, ``xcpmg_v_bwd``).

Usage: ``JAX_PLATFORMS=cpu python tests/make_xcpmgv_goldens.py`` from the
root of a checkout.
"""

import json
import os
import textwrap
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    import jax
    jax.config.update('jax_enable_x64', True)
    import jax.numpy as jnp

    import chip_smoke
    from mrphy_tpu.ops import epg

    c, ex = chip_smoke.MWF, chip_smoke.MWF_V_EX
    nv = ex['nv']
    mwf, T2a, T2b, b1, _ = chip_smoke.mwf_truth(nv)
    flips = jnp.full((c['nE'],), np.pi)
    esps = jnp.asarray(chip_smoke.MWF_V['esps'])
    w = jnp.asarray(np.random.default_rng(ex['wseed']).standard_normal(
        (nv, c['nE'], 2)))

    def train(p, esps):
        return epg.epgx_cpmg(
            flips, T1a=c['T1a'], T2a=p['T2a'], T1b=c['T1b'], T2b=p['T2b'],
            kab=c['kba'] * p['M0b'] / p['M0a'], kba=c['kba'], esp=esps,
            M0a=p['M0a'], M0b=p['M0b'], b1=jnp.asarray(b1))

    def loss(logp, esps):
        ech = train({k: jnp.exp(v) for k, v in logp.items()}, esps)
        return jnp.sum(w * ech), ech

    logp = {k: jnp.log(jnp.asarray(v)) for k, v in
            chip_smoke.mwf_pools(mwf, T2a, T2b).items()}
    (_, ech), (g_logp, g_esp) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(logp, esps)
    ech, g_esp = np.asarray(ech), np.asarray(g_esp)
    vox = chip_smoke.MWF_V_EX_VOXELS
    gold = {
        'echoes': [[float(x) for x in ech[v, e]]
                   for v, e in chip_smoke.MWF_V_EX_ENTRIES],
        'echoes_max': float(np.abs(ech).max()),
        'grad_esp': [float(x) for x in g_esp],
        'grad_esp_max': float(np.abs(g_esp).max()),
        'grad': {k: [float(x) for x in np.asarray(g_logp[k])[vox]]
                 for k in c['start']},
        'grad_max': {k: float(np.abs(np.asarray(g_logp[k])).max())
                     for k in c['start']}}
    print(textwrap.fill('GOLDEN_MWF_V = ' + json.dumps(gold), width=78,
                        subsequent_indent='    ', break_long_words=False,
                        break_on_hyphens=False))


if __name__ == '__main__':
    main()
