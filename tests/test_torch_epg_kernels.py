r"""The plain versions of the SPGR / MRF-FISP EPG kernels
(``spgr_fwd``/``spgr_fwd_chk``/``spgr_bwd``, :mod:`mrphy_tpu_torch.kernels.
epg`) on their own, and :func:`mrphy_tpu_torch.ops.routing.route`, on the
CPU.

The written-out chunk adjoint ``spgr_bwd_torch`` is held to torch autograd
of the plain forward at 1e-9 (float64), over several chunks; one float32
case with every option on is held to JAX's Pallas kernel in interpret mode
at the JAX suite's 2e-6 (``tests/test_epg_pallas.py``); the routing rows
are ``tests/test_routing.py``'s ``epg_spgr`` row in the port's path names.
The parity of ``epg_spgr``'s two routes with JAX's XLA scan is in
``tests/test_torch_epg.py``, whose inputs these tests share.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mrphy_tpu_torch.kernels import epg as kepg
from mrphy_tpu_torch.ops import epg as tepg
from mrphy_tpu_torch.ops import routing
from mrphy_tpu_torch.ops.routing import FAMILIES, route
from test_torch_epg import K, NA, NTR, _case, _close, _inputs, _torch_kw


@pytest.mark.parametrize('kw,kshift,tc', [
    (dict(tr=0.01, te=0.003), 1, 4),
    (dict(tr='trs', te='tes', b1='b1', D='D', dk=450.0), -1, 3),
    (dict(tr=0.01, te=0.002, D='D', dk=300.0), 3, 6)],
    ids=['const_tr_tc4', 'var_tr_b1_diffusion_kshift-1_tc3',
         'diffusion_kshift3_tc6'])
def test_spgr_bwd_torch_vs_autograd(kw, kshift, tc):
    r"""The written-out chunk adjoint against torch autograd of the plain
    forward, over several chunks, on the rows the kernels take."""
    inp = _inputs(3)
    base, _ = _case(inp, kw)
    coef, par, cdiff, cfg, _ = tepg._spgr_rows(**_torch_kw(base, kshift, K))
    coef, par = coef.detach().requires_grad_(), par.detach().requires_grad_()
    g = torch.as_tensor(inp['w'])
    sig = kepg.spgr_fwd_torch(coef, par, cdiff, cfg)
    dcoef_a, dpar_a = torch.autograd.grad((g * sig).sum(), (coef, par))
    sig2, chk = kepg.spgr_fwd_chk_torch(coef.detach(), par.detach(), cdiff,
                                        cfg, tc=tc)
    assert chk.shape == (NTR // tc, 6, K, NA)
    assert torch.equal(sig2, sig.detach())
    dcoef, dpar = kepg.spgr_bwd_torch(coef.detach(), par.detach(), cdiff,
                                      cfg, chk, g, tc=tc)
    np.testing.assert_allclose(dcoef, dcoef_a, rtol=1e-9,
                               atol=1e-9 * float(dcoef_a.abs().max()))
    np.testing.assert_allclose(dpar, dpar_a, rtol=1e-9,
                               atol=1e-9 * float(dpar_a.abs().max()))


def test_spgr_plain_versions_vs_pallas_interpret():
    r"""Float32, one tiny case with every option on (b1, variable TR/TE,
    diffusion, zinit), against JAX's Pallas kernel in interpret mode at
    the JAX suite's 2e-6."""
    from mrphy_tpu.ops import epg_pallas
    nA, nTR, Kp = 100, 12, 6
    inp = _inputs(4, nA=nA, nTR=nTR)
    f32 = np.float32
    kw = dict(T1=inp['T1'], T2=inp['T2'], tr=inp['trs'], te=inp['tes'],
              M0=inp['M0'], zinit=inp['zinit'], b1=inp['b1'], D=inp['D'])
    ref = np.asarray(epg_pallas.epg_spgr_pallas(
        jnp.asarray(inp['flips'], f32), jnp.asarray(inp['phis'], f32),
        **{k: jnp.asarray(v, f32) for k, v in kw.items()}, dk=450.0, K=Kp,
        tile=128, interpret=True))
    out = tepg._spgr_kernels(
        torch.tensor(inp['flips'], dtype=torch.float32),
        torch.tensor(inp['phis'], dtype=torch.float32),
        **{k: torch.tensor(v, dtype=torch.float32) for k, v in kw.items()},
        dk=450.0, K=Kp)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    _close(out, ref, 2e-6)


class TestRouting:
    r"""``tests/test_routing.py``'s ``epg_spgr`` row in the port's path
    names."""

    RNG = np.random.default_rng(0)
    FL = RNG.uniform(0.2, 1.2, 32)
    FL2D = RNG.uniform(0.2, 1.2, (4, 32))
    IV = RNG.uniform(0.008, 0.016, 32)
    A = RNG.uniform(0.5, 2.0, 100)

    def test_epg_spgr(self, monkeypatch):
        kw = dict(backend='cuda', T1=self.A, T2=self.A)
        # scalar + variable intervals, diffusion, b1: all the kernels,
        # forward and adjoint
        for extra in ({'tr': 0.01}, {'tr': self.IV},
                      {'tr': self.IV, 'te': self.IV},
                      {'tr': 0.01, 'D': self.A * 1e-3},
                      {'tr': self.IV, 'D': self.A * 1e-3},
                      {'tr': 0.01, 'b1': self.A}):
            r = route('epg_spgr', flips=self.FL, **kw, **extra)
            assert r['path'] == 'cuda-native-adjoint' and r['fused'], extra
        # per-voxel 2-D trains: the plain route under 'auto' on the card
        # (tensors taken as CUDA ones), refused under 'cuda'
        with pytest.raises(ValueError, match='per-voxel trains'):
            route('epg_spgr', flips=self.FL2D, **kw, tr=0.01)
        monkeypatch.setattr(routing, '_on_cuda', lambda kw: True)
        r = route('epg_spgr', flips=self.FL2D, T1=self.A, T2=self.A, tr=0.01)
        assert r['path'] == 'torch-fallback' and not r['fused']
        # JAX's adjoint budget gate sends this to its recompute VJP
        # ('pallas-xla-vjp'); the port has no H100 gate: the adjoint's
        # scratch is in device memory, its chunk shortened to fit
        r = route('epg_spgr', backend='cuda', T1=self.A, T2=self.A, tr=0.01,
                  flips=np.zeros(4096), K=4097)
        assert r['path'] == 'cuda-native-adjoint'
        assert kepg.pick_tc(4096, 4097, 100, 4) * 6 * 4097 * 100 * 4 \
            <= kepg.SCRATCH_BYTES
        assert kepg.pick_tc(400, 48, 65536, 4) == 25

    def test_backends_and_other_families(self):
        kw = dict(flips=self.FL, T1=self.A, T2=self.A, tr=0.01)
        assert route('epg_spgr', backend='torch', **kw)['path'] == 'torch'
        # 'auto' follows the tensors' device: the CPU takes the plain route
        assert route('epg_spgr', **kw)['path'] == 'torch'
        with pytest.raises(ValueError, match='CUDA tensors'):
            tepg.epg_spgr(torch.as_tensor(self.FL), T1=1.0, T2=0.1, tr=0.01,
                          backend='cuda')
        # the families still to port (epg_spgr, epg_cpmg, epgx_spgr and
        # epgx_cpmg are ported)
        assert set(routing._SLICES) == set(FAMILIES) - {
            'epg_spgr', 'epg_cpmg', 'epgx_spgr', 'epgx_cpmg'}
        for fam in routing._SLICES:
            with pytest.raises(NotImplementedError, match='slice'):
                route(fam, backend='cuda', flips=self.FL)
        with pytest.raises(NotImplementedError, match='mesh'):
            route('epg_spgr', mesh=object(), **kw)
        with pytest.raises(NotImplementedError, match='mesh'):
            tepg.epg_spgr(self.FL, T1=1.0, T2=0.1, tr=0.01, mesh=object())
