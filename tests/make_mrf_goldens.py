r"""Print the JAX package's results on the MRF problem of ``chip_smoke.py``
(``MRF_EX``, the SPGR problem of ``examples/mrf_dictionary.py``) in float64
on the CPU (XLA route): the literal ``GOLDEN_MRF`` that ``chip_smoke.py``
phase 18b holds the port to on the card — the dictionary at
``MRF_EX_ENTRIES`` and its largest value, the basis rank, the matched atoms
of the two probes and their ``m0``, the refined parameters and score.

Usage: ``JAX_PLATFORMS=cpu python tests/make_mrf_goldens.py`` from the
root of a checkout (under a minute on one CPU core).
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
from mrphy_tpu.ops import epg, mrf  # noqa: E402


def main():
    c = chip_smoke.MRF_EX
    flips, phis, trs, T1a, T2a = (jnp.asarray(x) for x in
                                  chip_smoke.mrf_example_arrays())

    def signals(T1, T2):
        return epg.epg_spgr(flips, phis, T1=T1, T2=T2, tr=trs,
                            te=c['tr'] / 2, zinit=epg.ir_prep(c['ti'], T1))

    D = jax.jit(signals)(T1a, T2a)
    basis = mrf.svd_basis(D, energy=c['energy'])
    Dc = mrf.compress(D, basis)
    probe0 = signals(jnp.asarray(c['T1']), jnp.asarray(c['T2']))
    cp, sp = np.cos(c['ph']), np.sin(c['ph'])
    probe = jnp.stack([cp * probe0[..., 0] - sp * probe0[..., 1],
                       sp * probe0[..., 0] + cp * probe0[..., 1]], -1)
    res = mrf.dict_match_compressed(Dc, jnp.stack([probe, probe0]), basis)
    best = int(res.idx[0])

    def sig(p):
        return signals(jnp.exp(p[0]), jnp.exp(p[1]))

    p0 = jnp.asarray([[np.log(float(T1a[best])), np.log(float(T2a[best])),
                       0.0]])
    p, score = mrf.match_refine(sig, p0, probe[None], iters=c['iters'],
                                lr=c['lr'])
    D = np.asarray(D)
    gold = dict(D=[[float(v) for v in D[a, t]]
                   for a, t in chip_smoke.MRF_EX_ENTRIES],
                D_max=float(np.abs(D).max()), rank=int(basis.B.shape[1]),
                idx=[int(i) for i in res.idx],
                m0=np.asarray(res.m0).tolist(),
                p=[float(v) for v in np.asarray(p)[0]],
                score=float(np.asarray(score)[0]))
    print(f'# {D.shape[0]} atoms, fit T1 {np.exp(gold["p"][0]):.6f} T2 '
          f'{np.exp(gold["p"][1]):.6f}')
    print('GOLDEN_MRF = ' + json.dumps(gold, indent=1))


if __name__ == '__main__':
    main()
