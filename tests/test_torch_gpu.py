"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs a CUDA device (a CUDA kernel has no CPU mode) and
skips without one.  On a machine with the card (which has no JAX, so the
JAX-configuring ``tests/conftest.py`` is not loaded):

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_gpu.py

Tolerance: 1e-5 (atol = rtol) at small widths, 1e-4 at full width, where
fp32 sums over a 2048-long contraction are taken in another order than
cuBLAS's and compound over the time steps.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the lstm_seq kernel runs only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _case(dev, B, T, D, H, seed=0):
    r = np.random.default_rng(seed)
    arrs = (r.normal(size=(B, T, D)), r.normal(size=(D, 4 * H)) / np.sqrt(D),
            r.normal(size=(H, 4 * H)) / np.sqrt(H), r.normal(size=(4 * H,)) * 0.2,
            r.normal(size=(B, H)), r.normal(size=(B, H)))
    return [torch.as_tensor(a, dtype=torch.float32, device=dev) for a in arrs]


def _close(got, want, tol):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, atol=tol, rtol=tol)


@pytest.mark.parametrize("B,T,D,H,tol", [
    (1, 16, 8, 8, 1e-5),
    (3, 7, 12, 16, 1e-5),       # prime T, ragged hidden tile
    (2, 1, 8, 8, 1e-5),         # T = 1
    (11, 5, 20, 36, 1e-5),      # B over one batch tile, H not a multiple of 8
    (8, 37, 1024, 1024, 1e-4),  # full width
])
def test_lstm_seq_kernel_matches_plain(cuda, B, T, D, H, tol):
    from repro_torch.kernels.lstm_cell import ops

    args = _case(cuda, B, T, D, H)
    _close(ops.lstm_seq(*args), ops.lstm_seq_ref(*args), tol)


def test_lstm_seq_kernel_lut_mode(cuda):
    from repro_torch.kernels.lstm_cell import ops
    from repro_torch.kernels.tanh_lut.ref import make_lut

    args = _case(cuda, 2, 24, 8, 12, seed=5)
    lut = make_lut(12, device=cuda)
    for g, w in zip(ops.lstm_seq(*args, lut=lut), ops.lstm_seq_lut_ref(*args, lut)):
        torch.testing.assert_close(g, w, atol=2e-6, rtol=1e-5)  # tests/test_recurrent.py's bar


def test_lstm_seq_kernel_resume_and_launch_count(cuda):
    """[0:T] == [0:T/2] then resumed from (h, c); one launch per call."""
    from repro_torch.kernels.lstm_cell import ops

    x, w_x, w_h, b, h0, c0 = _case(cuda, 2, 32, 8, 8, seed=4)
    ops.lstm_seq.launches = 0
    y, h, c = ops.lstm_seq(x, w_x, w_h, b, h0, c0)
    y_a, h_a, c_a = ops.lstm_seq(x[:, :16], w_x, w_h, b, h0, c0)
    y_b, h_b, c_b = ops.lstm_seq(x[:, 16:], w_x, w_h, b, h_a, c_a)
    assert ops.lstm_seq.launches == 3
    _close((torch.cat([y_a, y_b], 1), h_b, c_b), (y, h, c), 1e-5)


def test_lstm_seq_kernel_rejects_wrong_dtype(cuda):
    from repro_torch.kernels.lstm_cell import kernel

    x, w_x, w_h, b, h0, c0 = _case(cuda, 1, 4, 8, 8)
    with pytest.raises(ValueError, match="float32"):
        kernel.lstm_seq(x.double(), w_x, w_h, b, h0, c0)


def test_use_pallas_prefill_matches_plain_path(cuda):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm

    cfg = get_smoke_config("paper-lstm")
    params = lm.init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    toks = torch.as_tensor([[3, 1, 4, 1, 5, 9, 2, 6, 5]], device=cuda)
    lg_p, c_p = lm.prefill(params, cfg, toks)
    lg_k, c_k = lm.prefill(params, dataclasses.replace(cfg, use_pallas=True), toks)
    torch.testing.assert_close(lg_k, lg_p, atol=1e-5, rtol=1e-5)
    _close(c_k["groups"]["b0_recurrent"].values(), c_p["groups"]["b0_recurrent"].values(), 1e-5)
