r"""k-space trajectory generators — hardware-limited spirals, EPI,
radial, rosettes, trapezoids and rewinders (counterpart of the JAX
package's ``utils/traj.py``).

Design-time utilities on the host in numpy, as in the JAX package: they
run once, before a design loop or an acquisition, and produce gradient
waveforms that respect ``gmax``/``smax`` by construction, with their
k-space in the package's conventions (Tx k-space ends at the origin,
Rx k-space starts there: :func:`mrphy_tpu_torch.utils.g2k` with
``isTx=True``/``False``). Hand ``torch.as_tensor`` of the waveforms to
:meth:`SpinCube.acquire <mrphy_tpu_torch.models.mobjs.SpinCube.acquire>`
or to the design loop.
"""

from typing import Tuple

import numpy as np

from mrphy_tpu_torch import gamH, dt0, gmax0, smax0

__all__ = ['spiral2d', 'epi', 'radial', 'radial3d', 'rosette',
           'trapezoid', 'rewinder', 'mintime_gradient', 'traj_check']


def _g2k(gr, isTx: bool, dt, gam) -> np.ndarray:
    r"""k-space of gradients `(N, xyz, nT)` on the host: ``γ·dt·cumsum``,
    Tx k-space shifted to end at the origin (:func:`mrphy_tpu_torch.utils
    .g2k` in numpy)."""
    k = gam * dt * np.cumsum(np.asarray(gr, np.float64), axis=2)
    return k - k[:, :, -1:] if isTx else k


def spiral2d(fov: float, N: int, *, nshots: int = 1,
             gmax: float = gmax0, smax: float = smax0, dt: float = dt0,
             gam: float = gamH, direction: str = 'in',
             rewind: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    r"""Archimedean spiral reaching ``kmax = N/(2·fov)``, greedily
    integrated at the slew limit and capped at the amplitude limit.

    Inputs:
        - ``fov``: field of view, "cm".
        - ``N``: matrix size (resolution ``fov/N``).
    Optionals:
        - ``nshots``: interleaves (this returns ONE shot; rotate
          externally for the rest). Radial pitch = ``nshots/fov``.
        - ``gmax``/``smax``/``dt``/``gam``: hardware limits and dwell.
        - ``direction``: ``'in'`` (default; spiral-in, ends at k=0 with
          the Tx convention — ready for excitation design) ⊻ ``'out'``.
        - ``rewind``: append a slew-limited ramp-down to g=0 (and, for
          ``'in'``, prepend it time-reversed so the waveform starts
          from g=0).
    Outputs:
        - ``(gr, k)``: `(1, 3, nT)` gradients "Gauss/cm" (z row zero)
          and the matching `(1, 3, nT)` Tx k-space, "cycle/cm".

    The integrator picks, per step, the largest angular acceleration
    with ``|d²k/dt²| ≤ γ·smax`` (exact quadratic solve, not the
    asymptotic slew-limited form) and caps the angular rate at
    ``|dk/dt| = γ·gmax`` — both limits hold sample-by-sample
    (:func:`traj_check` asserts this; margin 1e-3).
    """
    assert direction in ('in', 'out')
    kmax = N / (2 * fov)
    lam = nshots / (2 * np.pi * fov)       # |k| = lam·θ, pitch nshots/fov
    # 1% safety + substeps: the greedy integrator bounds the CONTINUOUS
    # |k''|; the sampled finite-difference slew overshoots ~8% at dt
    # resolution (measured), <0.1% at dt/8 with the safety factor
    gbar, sbar = gam * gmax * 0.995, gam * smax * 0.99
    os_, dts = 8, dt / 8
    theta, w = 0.0, 0.0
    ths = [0.0]
    i = 0
    # θ'' from |k''| = γ·smax: k'' = λe^{iθ}[(1+iθ)a + (2i−θ)w²]
    # run to a FULL sample boundary past kmax: every sample spacing is
    # exactly dt (a partial last substep block would make the final
    # diff-derived gradient wrong and spike the slew at the rewinder)
    while lam * theta < kmax or i % os_ != 0:
        ur, ui = lam * 1.0, lam * theta            # u = λ(1+iθ)
        vr, vi = -lam * theta * w * w, lam * 2 * w * w
        uu = ur * ur + ui * ui
        uv = ur * vr + ui * vi
        disc = uv * uv - uu * (vr * vr + vi * vi - sbar * sbar)
        a = (-uv + np.sqrt(max(disc, 0.0))) / uu
        w = w + a * dts
        w = min(w, gbar / np.sqrt(uu))             # |k'| ≤ γ·gmax
        theta += w * dts
        i += 1
        if i % os_ == 0:
            ths.append(theta)
        assert i < 80_000_000, 'spiral failed to reach kmax'
    th = np.asarray(ths)
    k = lam * th * np.exp(1j * th)                 # outward, k(0)=0
    g = np.diff(k) / (gam * dt)                    # sample-centered
    gx, gy = g.real, g.imag
    if rewind:
        tail_x = rewinder(gx[-1], smax=smax, dt=dt)
        tail_y = rewinder(gy[-1], smax=smax, dt=dt)
        n = max(tail_x.size, tail_y.size)
        gx = np.concatenate([gx, np.pad(tail_x, (0, n - tail_x.size))])
        gy = np.concatenate([gy, np.pad(tail_y, (0, n - tail_y.size))])
    gr = np.zeros((1, 3, gx.size))
    gr[0, 0], gr[0, 1] = gx, gy
    if direction == 'in':
        gr = gr[:, :, ::-1].copy()                 # spiral-in: reverse
    # matching k convention: Tx (ends at origin) for excitation
    # spiral-in, Rx (starts at origin) for spiral-out
    return gr, _g2k(gr, direction == 'in', dt, gam)


def trapezoid(area: float, *, gmax: float = gmax0, smax: float = smax0,
              dt: float = dt0) -> np.ndarray:
    r"""Minimum-time trapezoid (or triangle) gradient lobe of the given
    ``area`` (∫g·dt, "Gauss/cm·Sec", signed): `(n,)` samples ramping at
    ``±smax`` to at most ``±gmax``, with the flat-top amplitude trimmed
    so the DISCRETE sum ``g.sum()·dt`` equals ``area`` exactly."""
    a = abs(area)
    if a < 1e-15:
        return np.zeros(0)
    sgn = 1.0 if area > 0 else -1.0
    # continuous minimum-time solution: triangle peak √(a·s), else trap
    gpk = min(gmax, np.sqrt(a * smax))
    nramp = int(np.ceil(gpk / (smax * dt)))
    ramp = np.arange(1, nramp + 1) * smax * dt
    ramp = np.minimum(ramp, gpk)
    nflat = max(0, int(np.ceil((a - 2 * ramp.sum() * dt)
                               / (gpk * dt))))
    g = np.concatenate([ramp, np.full(nflat, gpk), ramp[::-1]])
    g *= a / (g.sum() * dt)                        # exact discrete area
    assert np.abs(g).max() <= gmax * (1 + 1e-9)
    return sgn * g


def epi(fov: float, N: int, *, nshots: int = 1, flyback: bool = False,
        gmax: float = gmax0, smax: float = smax0, dt: float = dt0,
        gam: float = gamH) -> Tuple[np.ndarray, np.ndarray]:
    r"""Echo-planar (EPI) readout trajectory: ``N//nshots`` readout
    lines covering ``|kx| ≤ N/(2·fov)`` with phase-encode blips of
    ``nshots/fov`` between lines, preceded by simultaneous x/y
    pre-phasers to the k-space corner.

    Inputs:
        - ``fov``: field of view, "cm"; ``N``: matrix size.
    Optionals:
        - ``nshots``: interleaved shots (returns ONE shot: every
          ``nshots``-th line; blip area scales by ``nshots``).
        - ``flyback``: same-polarity readouts with fast return lobes
          (monotone per-line kx; costs dead time) instead of
          alternating polarity.
        - ``gmax``/``smax``/``dt``/``gam``: hardware limits and dwell.
    Outputs:
        - ``(gr, k)``: `(1, 3, nT)` gradients "Gauss/cm" (x = readout,
          y = phase encode, z = 0) and Rx k-space ("cycle/cm", starts
          at the origin; :func:`mrphy_tpu_torch.utils.g2k` with
          ``isTx=False``). Hardware limits hold sample-by-sample
          (:func:`traj_check`).
    """
    kmax = N / (2 * fov)
    nlines = int(np.ceil(N / nshots))
    read = trapezoid(2 * kmax / gam, gmax=gmax, smax=smax, dt=dt)
    back = trapezoid(-2 * kmax / gam, gmax=gmax, smax=smax, dt=dt)
    blip = trapezoid(nshots / fov / gam, gmax=gmax, smax=smax, dt=dt)
    pre_x = trapezoid(-kmax / gam, gmax=gmax, smax=smax, dt=dt)
    pre_y = trapezoid(-kmax / gam, gmax=gmax, smax=smax, dt=dt)
    # aligned (gx, gy) segments; a ≥1-sample zero gap separates every
    # pair of opposite-polarity x lobes (back-to-back ±smax·dt samples
    # would double the discrete slew at the junction)
    npre = max(pre_x.size, pre_y.size)
    segs = [(np.pad(pre_x, (npre - pre_x.size, 0)),
             np.pad(pre_y, (npre - pre_y.size, 0))),
            (np.zeros(1), np.zeros(1))]
    turn = (np.zeros(blip.size), blip)         # x idles, y blips
    for i in range(nlines):
        line = read if (flyback or i % 2 == 0) else -read
        segs.append((line, np.zeros(read.size)))
        if i < nlines - 1:
            if flyback:
                segs.append((np.zeros(1), np.zeros(1)))
                segs.append((back, np.pad(blip, (0, back.size
                                                 - blip.size))))
                segs.append((np.zeros(1), np.zeros(1)))
            else:
                segs.append(turn)
    gx = np.concatenate([s[0] for s in segs])
    gy = np.concatenate([s[1] for s in segs])
    gr = np.zeros((1, 3, gx.size))
    gr[0, 0], gr[0, 1] = gx, gy
    return gr, _g2k(gr, False, dt, gam)


def radial(fov: float, N: int, *, nspokes: int = 0, golden: bool = True,
           gmax: float = gmax0, smax: float = smax0, dt: float = dt0,
           gam: float = gamH) -> Tuple[np.ndarray, np.ndarray]:
    r"""2-D radial (projection) readout: full spokes (diameters) through
    the k-space center, ``|k| ≤ N/(2·fov)`` along each.

    Inputs:
        - ``fov``: field of view, "cm"; ``N``: matrix size.
    Optionals:
        - ``nspokes``: number of spokes (default ``ceil(π/2·N)``, the
          radial Nyquist count).
        - ``golden``: tiny-golden-angle ordering (``π·(√5−1)/2`` ≈
          111.246° increments — any contiguous subset is near-uniform,
          the standard for dynamic/self-gated imaging); ``False`` ⇒
          uniform ``π/nspokes`` increments.
        - ``gmax``/``smax``/``dt``/``gam``: hardware limits and dwell.
    Outputs:
        - ``(gr, k)``: `(nspokes, 3, nT)` gradients "Gauss/cm" and Rx
          k-space ("cycle/cm") — spokes on the BATCH axis, ready for
          :func:`mrphy_tpu_torch.ops.signal.signal`. Each spoke pre-phases to
          ``−kmax·u`` then reads through center to ``+kmax·u``; hardware
          limits hold sample-by-sample (:func:`traj_check`).
    """
    kmax = N / (2 * fov)
    if nspokes <= 0:
        nspokes = int(np.ceil(np.pi / 2 * N))
    pre = trapezoid(-kmax / gam, gmax=gmax, smax=smax, dt=dt)
    read = trapezoid(2 * kmax / gam, gmax=gmax, smax=smax, dt=dt)
    # 1-sample zero gap: the opposite-polarity junction would otherwise
    # see 2·smax·dt of discrete slew
    base = np.concatenate([pre, np.zeros(1), read])
    dphi = np.pi * (np.sqrt(5) - 1) / 2 if golden else np.pi / nspokes
    phi = dphi * np.arange(nspokes)
    gr = np.zeros((nspokes, 3, base.size))
    gr[:, 0] = np.cos(phi)[:, None] * base
    gr[:, 1] = np.sin(phi)[:, None] * base
    return gr, _g2k(gr, False, dt, gam)


def radial3d(fov: float, N: int, *, nspokes: int = 0,
             gmax: float = gmax0, smax: float = smax0, dt: float = dt0,
             gam: float = gamH) -> Tuple[np.ndarray, np.ndarray]:
    r"""3-D radial ("kooshball") readout: full spokes through the
    k-space center along near-uniform sphere directions.

    Directions follow the spherical Fibonacci (3-D golden-angle)
    lattice — ``z`` uniform in (−1, 1), azimuth in golden-angle
    increments — so any contiguous subset covers the sphere
    near-uniformly (the 3-D analogue of :func:`radial`'s ordering; the
    standard free-breathing/self-gated 3-D scheme).

    Optionals:
        - ``nspokes``: number of spokes (default ``ceil(π/2·N²)``, the
          3-D radial Nyquist count — undersample deliberately for
          golden-angle dynamic protocols).
    Outputs:
        - ``(gr, k)``: `(nspokes, 3, nT)` gradients and Rx k-space,
          spokes on the BATCH axis; per-axis hardware limits hold
          sample-by-sample (each axis carries ≤ the base waveform).
    """
    kmax = N / (2 * fov)
    if nspokes <= 0:
        nspokes = int(np.ceil(np.pi / 2 * N * N))
    pre = trapezoid(-kmax / gam, gmax=gmax, smax=smax, dt=dt)
    read = trapezoid(2 * kmax / gam, gmax=gmax, smax=smax, dt=dt)
    base = np.concatenate([pre, np.zeros(1), read])
    j = np.arange(nspokes)
    z = -1 + 2 * (j + 0.5) / nspokes
    phi = np.pi * (np.sqrt(5) - 1) * j          # 3-D golden angle
    st = np.sqrt(1 - z * z)
    dirs = np.stack([st * np.cos(phi), st * np.sin(phi), z], -1)
    gr = dirs[:, :, None] * base[None, None, :]
    return gr, _g2k(gr, False, dt, gam)


def rosette(fov: float, N: int, *, npetals: int = 16, q: float = 0.7,
            gmax: float = gmax0, smax: float = smax0, dt: float = dt0,
            gam: float = gamH) -> Tuple[np.ndarray, np.ndarray]:
    r"""Rosette readout ``k(t) = kmax·sin(ω₁t)·e^{iω₂t}`` — repeatedly
    re-crossing the k-space center (self-navigation, spectroscopic /
    off-resonance encoding).

    The fastest hardware-feasible rates are picked analytically:
    ``|k′| ≤ kmax·max(ω₁, ω₂)`` and ``|k″| ≤ kmax·(ω₁² + ω₂²)`` are the
    exact envelope maxima, so ``ω₁ = min(γ·gmax/(kmax·max(1,q)),
    √(γ·smax/(kmax·(1+q²))))`` with ``ω₂ = q·ω₁`` saturates whichever
    limit binds.

    Optionals:
        - ``npetals``: center-crossings (duration ``npetals·π/ω₁``).
        - ``q``: ``ω₂/ω₁`` rotation-to-oscillation ratio (irrational-ish
          values spread the petals; default 0.7).
    Outputs:
        - ``(gr, k)``: `(1, 3, nT)` gradients and Rx k-space. A
          compensating blip + slew-limited ramp-in precede the analytic
          waveform (net k of the preamble is zero), so the k-space of
          the analytic section IS the ideal rosette.
    """
    kmax = N / (2 * fov)
    w1 = min(gam * gmax / (kmax * max(1.0, q)) * 0.995,
             np.sqrt(gam * smax / (kmax * (1 + q * q))) * 0.995)
    w2 = q * w1
    nT = int(np.ceil(npetals * np.pi / w1 / dt))
    t = (np.arange(nT) + 1) * dt
    # g from the DISCRETE difference of the analytic k: the cumsum in
    # g2k then telescopes to the exact rosette samples (|k| ≤ kmax
    # exactly; the analytic-derivative form overshoots ~max|k'|·dt/2 ≈
    # 1.3% under Riemann integration), and the rate limits still hold:
    # |Δk|/dt ≤ max|k'| and |Δ²k|/dt² ≤ max|k''| by the MVT.
    kx = kmax * np.sin(w1 * t) * np.cos(w2 * t)
    ky = kmax * np.sin(w1 * t) * np.sin(w2 * t)
    gx = np.diff(kx, prepend=0.0) / (gam * dt)
    gy = np.diff(ky, prepend=0.0) / (gam * dt)
    def preamble(g0):
        ramp = rewinder(g0, smax=smax, dt=dt)[::-1]
        blip = trapezoid(-ramp.sum() * dt, gmax=gmax, smax=smax, dt=dt)
        return np.concatenate([blip, np.zeros(1), ramp])

    pre_x, pre_y = preamble(gx[0]), preamble(gy[0])
    npad = max(pre_x.size, pre_y.size)
    gr = np.zeros((1, 3, npad + nT))
    gr[0, 0, npad - pre_x.size:npad] = pre_x
    gr[0, 1, npad - pre_y.size:npad] = pre_y
    gr[0, 0, npad:], gr[0, 1, npad:] = gx, gy
    return gr, _g2k(gr, False, dt, gam)


def rewinder(g_end: float, *, smax: float = smax0,
             dt: float = dt0) -> np.ndarray:
    r"""Minimum-time slew-limited ramp from gradient ``g_end`` to 0:
    `(n,)` samples at ±``smax``·dt decrements (last step partial)."""
    n = int(np.ceil(abs(g_end) / (smax * dt)))
    if n == 0:
        return np.zeros(0)
    ramp = np.linspace(g_end, 0.0, n + 1)[1:]
    return ramp


def traj_check(gr: np.ndarray, *, gmax: float = gmax0,
               smax: float = smax0, dt: float = dt0,
               margin: float = 1e-3) -> None:
    r"""Assert ``|g| ≤ gmax`` and ``|dg/dt| ≤ smax`` per axis (within
    ``margin`` relative) — the contract every generator here honors."""
    g = np.asarray(gr)
    assert np.all(np.abs(g) <= gmax * (1 + margin)), np.abs(g).max()
    s = np.diff(g, axis=-1) / dt
    pre = g[..., :1] / dt                          # ramp from zero
    s = np.concatenate([pre, s], -1)
    assert np.all(np.abs(s) <= smax * (1 + margin)), np.abs(s).max()


def mintime_gradient(path, *, gmax: float = gmax0, smax: float = smax0,
                     dt: float = dt0, gam: float = gamH,
                     v0: float = 0.0, v1: float = 0.0,
                     margin: float = 0.995) -> np.ndarray:
    r"""Time-optimal gradient waveform tracing an ARBITRARY k-space
    path — the Lustig–Kim–Pauly method [IEEE TMI 27(6):866, 2008],
    rotationally-invariant constraints: reparametrize the curve by arc
    length, bound the traversal speed by amplitude (``v ≤ γ·gmax``)
    and curvature (``κv² ≤ γ·smax``), and propagate the tangential-
    acceleration limit ``(v·dv/ds)² ≤ (γ·smax)² − (κv²)²`` through one
    forward and one backward pass — the pointwise minimum is the
    optimal speed profile; resampling the curve at uniform ``dt``
    along it yields the gradients.

    Inputs:
        - ``path``: `(d ≤ 3, nP)`, "cycle/cm", the k-space curve in
          traversal order, densely and smoothly sampled (curvature is
          estimated by finite differences — kinks read as infinite
          curvature and the design slows to a crawl there, which is
          the physical answer). The produced Rx k-space starts at the
          path start; begin at the origin or prepend a prephaser
          (:func:`trapezoid`).
    Optionals:
        - ``gmax``/``smax``/``dt``/``gam``: hardware limits and dwell.
          The VECTOR-NORM limits are enforced (per-axis follows a
          fortiori — :func:`traj_check` passes by construction).
        - ``v0``/``v1``: entry/exit speeds, "cycle/cm/s" (default: at
          rest; pass ``γ·|g_end|`` to splice waveforms).
        - ``margin``: design at this fraction of the limits (absorbs
          resampling discretization).
    Outputs:
        - ``gr``: `(1, 3, nT)`, "Gauss/cm" (z row zero for 2-D paths).

    The framework's analytic generators (spiral/EPI/rosette) integrate
    their own rate equations; this is the general tool for every other
    curve (measured trajectories, optimized paths, splines).
    """
    p = np.atleast_2d(np.asarray(path, np.float64))
    d, nP = p.shape
    assert d <= 3 and nP >= 3, p.shape
    gm, sm = margin * gmax, margin * smax

    # --- arc-length resampling on a dense grid ---
    seg = np.linalg.norm(np.diff(p, axis=1), axis=0)
    s_nodes = np.concatenate([[0.0], np.cumsum(seg)])
    L = s_nodes[-1]
    assert L > 0, 'degenerate path'
    ds = min(gam * gm * dt / 4, L / (2 * nP))
    ns = int(np.ceil(L / ds)) + 1
    s = np.linspace(0.0, L, ns)
    ds = s[1] - s[0]
    c = np.stack([np.interp(s, s_nodes, p[a]) for a in range(d)])

    # --- curvature via central differences of the unit tangent ---
    t_vec = np.gradient(c, ds, axis=1)
    t_norm = np.maximum(np.linalg.norm(t_vec, axis=0), 1e-12)
    t_hat = t_vec / t_norm
    kappa = np.linalg.norm(np.gradient(t_hat, ds, axis=1), axis=0)
    kappa = np.maximum(kappa, 1e-12)

    # --- speed limits and the two passes ---
    a_max = gam * sm                              # cycle/cm/s^2
    vmax = np.minimum(gam * gm, np.sqrt(a_max / kappa))

    def sweep(v_init, vmax_dir, kappa_dir):
        v = np.empty(ns)
        v[0] = min(v_init, vmax_dir[0])
        for i in range(ns - 1):
            at2 = a_max ** 2 - (kappa_dir[i] * v[i] ** 2) ** 2
            at = np.sqrt(max(at2, 0.0))
            v[i + 1] = min(vmax_dir[i + 1],
                           np.sqrt(v[i] ** 2 + 2 * at * ds))
        return v

    v_f = sweep(v0, vmax, kappa)
    v_b = sweep(v1, vmax[::-1], kappa[::-1])[::-1]
    v = np.minimum(v_f, v_b)

    # --- time along the curve; resample at the dwell ---
    vsum = np.maximum(v[:-1] + v[1:], 1e-12)
    t = np.concatenate([[0.0], np.cumsum(2 * ds / vsum)])
    # invert via the SPEED, not the position: near the endpoints v→0
    # makes t(s) locally sqrt-like and adjacent s-nodes many dwells
    # apart — linear interp of s(t) there linearizes the braking
    # parabola and the finite-difference slew overshoots. v(t) is
    # piecewise-LINEAR in t under constant acceleration, so
    # trapezoid-integrating the interpolated v on the dwell grid is
    # exact through the ramps.
    nT = int(np.ceil(t[-1] / dt))
    tk_all = dt * np.arange(nT + 1)
    vk = np.interp(tk_all, t, v)
    sk = np.cumsum((vk[:-1] + vk[1:]) / 2 * dt)
    # the trapezoid under-integrates by O(ds²) at speed-profile
    # corners; rescale so the path completes exactly (relative speed
    # distortion = the drift, far below `margin`)
    sk = sk * (L / sk[-1])
    kpts = np.stack([np.interp(sk, s, c[a]) for a in range(d)])
    k0 = c[:, :1]
    g = np.diff(np.concatenate([k0, kpts], 1), axis=1) / (gam * dt)
    gr = np.zeros((1, 3, nT))
    gr[0, :d] = g
    return gr
