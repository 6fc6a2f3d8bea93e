r"""Print the JAX package's results on the gridding problems of
``chip_smoke.py`` phase 15 in float64 on the CPU: the literals
``GOLDEN_RECON3D`` (15a: ``examples/recon3d.py`` at its defaults — the
calibration image ``nufft_adjoint(w ⊙ nufft(𝟙))``, the gridding image and
the Toeplitz CG image after ``RECON3D_CG_EARLY`` and after 12 iterations
at ``RECON3D_VOXELS``, each with its largest value; and the Pipe–Menon
weights of its trajectory at ``RECON3D_SAMPLES`` with their largest
value) and
``GOLDEN_RECON_NUFFT`` (15b: ``examples/recon_sense.py --op nufft`` on the
``RECON`` problem — the NUFFT signal and ∂Σs²/∂ktraj at
``RECON_STEPS`` with their largest values, and the CG-SENSE image at
``RECON_PIXELS``) that ``chip_smoke.py`` holds the port to on the card.

The route is pinned: the 3-D plan is ``interp='gather'`` (what ``'auto'``
resolves to without a TPU), the 2-D plan ``interp='gather'`` too (JAX's
``'matmul'`` mode equals it up to the order of its sums). The NUFFT calls
that read the trajectory run eagerly: under ``jax.jit`` XLA may
reassociate ``k·fov·(G/n)``, and a sample within an ulp of a tap edge then
takes the other tap set (the truncated Kaiser–Bessel kernel jumps by
1/I₀(β) there); the script checks the jitted operators it uses in the CG
loops against the eager ones.

It also prints, as comments, how far a 1-ulp change of the recon3d CG's
right-hand side (every element moved to the next float64 up), and a
relative change of 1e-14, move each CG iterate, relative to the iterate's
largest value: the JAX package's own sensitivity, which bounds how closely
the port can follow it there.

Usage: ``JAX_PLATFORMS=cpu python tests/make_nufft_goldens.py`` from the
root of a checkout (13 minutes on one CPU core, 9.5 of them 15a: the
exact synthesis of 32,768 spins × 169,200 samples and the Toeplitz
kernel).
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
from mrphy_tpu import dt0  # noqa: E402
from mrphy_tpu.ops import nufft as nf  # noqa: E402
from mrphy_tpu.ops import signal as sig  # noqa: E402


def cg_sense(A, AH, s, iters, lam):
    r"""``chip_smoke.cg_sense`` (examples/recon_sense.py's loop) in JAX."""
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


def recon3d():
    r"""``chip_smoke.recon3d_run`` in JAX."""
    P = chip_smoke.RECON3D
    n, fov = P['n'], P['fov']
    img0, kt, loc_, z = map(jnp.asarray, chip_smoke.recon3d_arrays())
    M = jnp.concatenate([img0.reshape(1, -1, 2), jnp.zeros((1, n ** 3, 1))],
                        -1)
    s = sig.signal(M, loc_, kt[None])[0, 0]
    s = s + P['noise'] * float(jnp.abs(s).max()) * z
    plan = nf.nufft_plan((n,) * 3, (fov,) * 3, width=P['width'],
                         osf=P['osf'], dtype=jnp.float64, interp='gather')
    w = jnp.sum(kt * kt, 0)
    w = w.at[w == 0].set(float(w[w > 0].min()))
    ones = jnp.stack([jnp.ones((n,) * 3), jnp.zeros((n,) * 3)], -1)
    cal = nf.nufft_adjoint(plan, w[:, None] * nf.nufft(plan, ones, kt), kt)
    w = w / jnp.mean(cal[..., 0])
    grid_rec = nf.nufft_adjoint(plan, w[:, None] * s, kt)
    that = nf.toeplitz_kernel(plan, kt)
    b = nf.nufft_adjoint(plan, s, kt)
    lam = P['l2'] * float(jnp.abs(that).max())
    aha = jax.jit(lambda x: nf.toeplitz_apply(plan, that, x) + lam * x)

    def cg(b):
        x, r = jnp.zeros_like(b), b
        p, rs = r, jnp.sum(r * r)
        xs = []
        for _ in range(P['iters']):
            Ap = aha(p)
            al = rs / jnp.maximum(jnp.sum(p * Ap), 1e-30)
            x, r = x + al * p, r - al * Ap
            rs2 = jnp.sum(r * r)
            p = r + (rs2 / jnp.maximum(rs, 1e-30)) * p
            rs = rs2
            xs.append(x)
        return xs

    xs = cg(b)
    x_early, x = xs[chip_smoke.RECON3D_CG_EARLY - 1], xs[-1]
    for what, b1 in (('a 1-ulp change', jnp.nextafter(b, jnp.inf)),
                     ('a relative change of 1e-14', b * (1 + 1e-14))):
        moved = [float(jnp.abs(a - b_).max() / jnp.abs(b_).max())
                 for a, b_ in zip(cg(b1), xs)]
        print(f'# recon3d CG: {what} of the right-hand side moves iterates '
              f'1..{P["iters"]} by {moved}')
    dcf = nf.dcf_pipe_menon(plan, kt)

    def nrmse(x):
        return float(jnp.linalg.norm(x[..., 0] - img0[..., 0])
                     / jnp.linalg.norm(img0[..., 0]))

    vox = np.asarray(chip_smoke.RECON3D_VOXELS)
    out = {}
    for key, a in (('cal', cal), ('grid', grid_rec), ('cg_early', x_early),
                   ('cg', x)):
        out[key] = np.asarray(a.reshape(-1, 2)[vox]).tolist()
        out[f'{key}_max'] = float(jnp.abs(a).max())
    out['dcf'] = np.asarray(dcf[np.asarray(chip_smoke.RECON3D_SAMPLES)]
                            ).tolist()
    out['dcf_max'] = float(jnp.abs(dcf).max())
    gain = float(jnp.mean(cal[..., 0]))
    print(f'# recon3d: nT {kt.shape[1]}, DC gain {gain!r}, NRMSE gridding '
          f'{nrmse(grid_rec)!r}, CG {nrmse(x)!r}')
    return out


def recon_nufft():
    r"""``chip_smoke.recon_nufft_ops`` and the CG-SENSE loop in JAX."""
    R, N = chip_smoke.RECON, chip_smoke.RECON_NUFFT
    n, nc, fov = R['n'], R['nc'], R['fov']
    loc, x_true, sens, df, k = map(jnp.asarray, chip_smoke.recon_arrays())
    nM = n * n
    s_acq = sig.signal(jnp.concatenate([x_true, jnp.zeros((nM, 1))],
                                       -1)[None], loc, k, sens=sens, df=df)
    plan = nf.nufft_plan((n, n), (fov, fov), width=N['width'],
                         dtype=jnp.float64, interp='gather')
    nkw = dict(df=df.reshape(n, n), dt=dt0, nseg=N['nseg'])
    k2 = k[:, (1, 0), :]
    sg = jnp.moveaxis(sens[0].reshape(n, n, 2, nc), -1, 0)

    def A(x, kk=k2):
        xg = x.reshape(n, n, 2)
        out = []
        for c in range(nc):
            sc = sg[c]
            w = jnp.stack([sc[..., 0] * xg[..., 0] - sc[..., 1] * xg[..., 1],
                           sc[..., 0] * xg[..., 1] + sc[..., 1] * xg[..., 0]],
                          -1)
            out.append(nf.nufft(plan, w, kk[0], **nkw))
        return jnp.stack(out)[None]

    def AH(s):
        x = 0
        for c in range(nc):
            sc = sg[c]
            xg = nf.nufft_adjoint(plan, s[0, c], k2[0], **nkw)
            x = x + jnp.stack(
                [sc[..., 0] * xg[..., 0] + sc[..., 1] * xg[..., 1],
                 sc[..., 0] * xg[..., 1] - sc[..., 1] * xg[..., 0]], -1)
        return x.reshape(nM, 2)

    steps = np.asarray(chip_smoke.RECON_STEPS)
    sn = A(x_true)
    dk = jax.grad(lambda kk: jnp.sum(A(x_true, kk) ** 2))(k2)
    jA, jAH = jax.jit(A), jax.jit(AH)
    dev = max(float(jnp.abs(jA(x_true) - sn).max() / jnp.abs(sn).max()),
              float(jnp.abs(jAH(s_acq) - AH(s_acq)).max()
                    / jnp.abs(AH(s_acq)).max()))
    assert dev < 1e-12, f'jitted operators differ from eager: {dev}'
    x, res = cg_sense(jA, jAH, s_acq, R['iters'], R['lam'])
    err = float(jnp.linalg.norm(x - x_true) / jnp.linalg.norm(x_true))
    print(f'# recon_sense --op nufft: nT {k.shape[-1]}, jit vs eager '
          f'{dev!r}, CG residual {float(res)!r}, image error {err!r}')
    return {'s': np.asarray(sn[0][:, steps]).tolist(),
            's_max': float(jnp.abs(sn).max()),
            'dk': np.asarray(dk[0][:, steps]).tolist(),
            'dk_max': float(jnp.abs(dk).max()),
            'x': np.asarray(x[np.asarray(chip_smoke.RECON_PIXELS)]).tolist()}


def main():
    print('GOLDEN_RECON_NUFFT = ' + json.dumps(recon_nufft()))
    print('GOLDEN_RECON3D = ' + json.dumps(recon3d()))


if __name__ == '__main__':
    main()
