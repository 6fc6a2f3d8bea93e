r"""The CUDA kernels of :mod:`mrphy_tpu_torch.kernels` on the card: each
against its plain PyTorch version, the launch counts, the wrappers'
refusals and the backward that is not ported yet.

Every test here is marked ``cuda`` and skips without a CUDA device.
``tests/conftest.py`` imports JAX; where JAX is not installed, run them
with::

    python -m pytest --noconftest -q tests/test_torch_cuda.py -m cuda

This file imports no JAX. Its case builders are shared with
``tests/test_torch_kernels.py``. Tolerances: 2e-6 in float32 and 1e-12
in float64 (the kernels follow their plain versions' operations; on an
H100 they have agreed bit for bit).
"""

import numpy as np
import pytest
import torch

from mrphy_tpu_torch.kernels import bloch

G2PD = 2 * np.pi * 4257.6 * 4e-6   # γ2πdt at 4 µs, rad/Gauss


def _tt(a):
    return {k: torch.as_tensor(v) for k, v in a.items()}


def rfgr_args(N=2, nS=300, nT=64, nC=2, seed=0, dtype=np.float32):
    r"""Pre-scaled ``rfgr_fwd`` arguments (numpy): per-spin planes and
    waveforms of physical size; every optional input present."""
    rng = np.random.default_rng(seed)
    g2pd = np.full((N, nS), G2PD) * (1 + 0.1 * rng.random((N, nS)))
    E1 = 1 - rng.random((N, nS)) * 1e-5
    E2 = 1 - rng.random((N, nS)) * 1e-4
    a = dict(
        mi=rng.random((N, 3, nS)) - 0.5,
        rf2=(rng.random((N, 2 * nC, nT)) - 0.5) * 0.3,
        gr2=(rng.random((N, 3, nT)) - 0.5) * 4,
        loc_p=g2pd[:, None] * (rng.random((N, 3, nS)) - 0.5) * 4,
        dfg=2 * np.pi * 4e-6 * (rng.random((N, nS)) - 0.5) * 200,
        b1_p=g2pd[:, None] * (rng.random((N, 2 * nC, nS)) - 0.5),
        E=np.stack([E2, E2, E1], 1),
        e1_1=E1 - 1,
        g2pd=g2pd,
        vel_p=g2pd[:, None] * (rng.random((N, 3, nS)) - 0.5) * 50,
        tarr2=np.arange(nT)[None, :] * np.full((N, 1), 4e-6),
    )
    return {k: v.astype(dtype) for k, v in a.items()}


def beff_args(B=500, nT=96, seed=1, dtype=np.float32):
    rng = np.random.default_rng(seed)
    E1 = 1 - rng.random(B) * 1e-5
    E2 = 1 - rng.random(B) * 1e-4
    a = dict(mi=rng.random((3, B)) - 0.5,
             beff=(rng.random((nT, 3, B)) - 0.5) * 4,
             E=np.stack([E2, E2, E1]), e1_1=E1 - 1,
             g2pd=np.full(B, G2PD) * (1 + 0.1 * rng.random(B)))
    return {k: v.astype(dtype) for k, v in a.items()}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,bar', [(torch.float32, 2e-6),
                                       (torch.float64, 1e-12)])
def test_kernels_vs_plain_on_card(cuda, dtype, bar):
    npdt = np.float32 if dtype == torch.float32 else np.float64
    a = {k: v.to(cuda) for k, v in _tt(rfgr_args(dtype=npdt)).items()}
    args = (a['mi'], a['rf2'], a['gr2'], a['loc_p'], a['dfg'], a['b1_p'],
            a['E'], a['e1_1'], a['g2pd'], a['vel_p'], a['tarr2'])
    n0 = bloch.LAUNCHES['rfgr_fwd']
    torch.testing.assert_close(bloch.rfgr_fwd(*args),
                               bloch.rfgr_fwd_torch(*args), rtol=0, atol=bar)
    assert bloch.LAUNCHES['rfgr_fwd'] == n0 + 1
    b = {k: v.to(cuda) for k, v in _tt(beff_args(dtype=npdt)).items()}
    bargs = (b['mi'], b['beff'], b['E'], b['e1_1'], b['g2pd'])
    torch.testing.assert_close(bloch.beff_fwd(*bargs),
                               bloch.beff_fwd_torch(*bargs), rtol=0, atol=bar)


@pytest.mark.cuda
def test_kernel_wrappers_refuse_and_backward_raises(cuda):
    b = {k: v.to(cuda) for k, v in _tt(beff_args(B=64, nT=8)).items()}
    with pytest.raises(TypeError):
        bloch.beff_fwd(b['mi'].double(), b['beff'], b['E'], b['e1_1'],
                       b['g2pd'])
    with pytest.raises(ValueError, match='contiguous'):
        bloch.beff_fwd(b['mi'][:, ::2], b['beff'][..., ::2], None, None,
                       b['g2pd'][::2])
    mi = b['mi'].clone().requires_grad_()
    chk = bloch.beff_fwd(mi, b['beff'], b['E'], b['e1_1'], b['g2pd'])
    with pytest.raises(NotImplementedError, match='K4'):
        chk.sum().backward()
    a = {k: v.to(cuda) for k, v in _tt(rfgr_args(nT=8)).items()}
    rf2 = a['rf2'].clone().requires_grad_()
    chk = bloch.rfgr_fwd(a['mi'], rf2, a['gr2'], a['loc_p'], None, None,
                         None, None, a['g2pd'])
    with pytest.raises(NotImplementedError, match='K2'):
        chk.sum().backward()
