"""The port's fused-LSTM kernel module on the CPU against the JAX reference.

On a CPU tensor ``repro_torch.kernels.lstm_cell.ops.lstm_seq`` takes its
plain PyTorch version; it must match the reference's Pallas kernel (run in
interpret mode, as the reference's own tests run it) and the reference's
``lstm_seq_ref`` at 1e-5 in fp32 — the bar of tests/test_recurrent.py.
The LUT mode must match ``lstm_seq_lut_ref`` at atol 2e-6, the same file's
bar.  Inputs are made with numpy from a seed and handed to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import _lut as jax_lut  # noqa: E402
from repro.kernels.lstm_cell import ops as jax_ops  # noqa: E402
from repro.kernels.tanh_lut import ref as jax_tanh_ref  # noqa: E402
from repro_torch.kernels import _lut as pt_lut  # noqa: E402
from repro_torch.kernels.lstm_cell import kernel as pt_kernel  # noqa: E402
from repro_torch.kernels.lstm_cell import ops as pt_ops  # noqa: E402
from repro_torch.kernels.tanh_lut import ref as pt_tanh_ref  # noqa: E402


def _case(Bsz, T, D, H, seed):
    r = np.random.default_rng(seed)
    return (r.normal(size=(Bsz, T, D)).astype(np.float32),
            (r.normal(size=(D, 4 * H)) / np.sqrt(D)).astype(np.float32),
            (r.normal(size=(H, 4 * H)) / np.sqrt(H)).astype(np.float32),
            (r.normal(size=(4 * H,)) * 0.2).astype(np.float32),
            r.normal(size=(Bsz, H)).astype(np.float32),
            r.normal(size=(Bsz, H)).astype(np.float32))


def _pt(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _assert_close(pt_out, jax_out, atol, rtol):
    for p, j in zip(pt_out, jax_out):
        np.testing.assert_allclose(p.numpy(), np.asarray(j), atol=atol, rtol=rtol)


@pytest.mark.parametrize("Bsz,T,D,H,carry", [
    (1, 16, 8, 8, False),
    (3, 7, 12, 16, True),     # prime T, random h0/c0
    (2, 1, 8, 8, True),       # T = 1
])
def test_lstm_seq_plain_path_matches_reference(Bsz, T, D, H, carry):
    x, w_x, w_h, b, h0, c0 = _case(Bsz, T, D, H, seed=Bsz * 100 + T)
    if not carry:
        h0 = c0 = np.zeros((Bsz, H), np.float32)
    pt_args = _pt(x, w_x, w_h, b)
    kw = dict(h0=torch.as_tensor(h0), c0=torch.as_tensor(c0)) if carry else {}
    launches = pt_ops.lstm_seq.launches
    y, h, c = pt_ops.lstm_seq(*pt_args, **kw)
    assert pt_ops.lstm_seq.launches == launches  # the CPU path launches no kernel
    assert y.dtype == torch.float32 and y.shape == (Bsz, T, H)

    jargs = [jnp.asarray(a) for a in (x, w_x, w_h, b, h0, c0)]
    _assert_close((y, h, c), jax_ops.lstm_seq(*jargs, interpret=True), 1e-5, 1e-5)
    _assert_close((y, h, c), jax_ops.lstm_seq_ref(*jargs), 1e-5, 1e-5)


def test_lstm_seq_carry_resume():
    """[0:T] == [0:T/2] then resumed from (h, c): the contract chunked
    prefill relies on."""
    x, w_x, w_h, b, h0, c0 = _pt(*_case(2, 12, 8, 8, seed=4))
    y, h, c = pt_ops.lstm_seq(x, w_x, w_h, b, h0, c0)
    y_a, h_a, c_a = pt_ops.lstm_seq(x[:, :5], w_x, w_h, b, h0, c0)
    y_b, h_b, c_b = pt_ops.lstm_seq(x[:, 5:], w_x, w_h, b, h_a, c_a)
    torch.testing.assert_close(torch.cat([y_a, y_b], 1), y, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(h_b, h, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(c_b, c, atol=1e-6, rtol=1e-6)


def test_lstm_seq_y_in_input_dtype():
    x, w_x, w_h, b, _, _ = _pt(*_case(2, 5, 8, 8, seed=6))
    y, h, c = pt_ops.lstm_seq(x.double(), w_x, w_h, b)
    assert y.dtype == torch.float64 and h.dtype == c.dtype == torch.float32


def test_lstm_seq_lut_mode_matches_reference():
    x, w_x, w_h, b, h0, c0 = _case(2, 24, 8, 12, seed=5)
    lut_j = jax_tanh_ref.make_lut(12)
    # the tables agree to two fp32 ulps near |tanh| = 1 (the two tanh
    # implementations round differently); the LSTM comparison feeds both
    # packages the same table
    np.testing.assert_allclose(pt_tanh_ref.make_lut(12).numpy(), np.asarray(lut_j),
                               atol=2.5e-7, rtol=0)
    lut_pt = torch.as_tensor(np.array(lut_j))
    out = pt_ops.lstm_seq(*_pt(x, w_x, w_h, b, h0, c0), lut=lut_pt)
    jargs = [jnp.asarray(a) for a in (x, w_x, w_h, b, h0, c0)]
    _assert_close(out, jax_ops.lstm_seq_lut_ref(*jargs, lut_j), 2e-6, 1e-5)
    y_exact, _, _ = pt_ops.lstm_seq(*_pt(x, w_x, w_h, b, h0, c0))
    assert float((out[0] - y_exact).abs().max()) < 2e-3  # 12-bit table


@pytest.mark.parametrize("addr_bits", [4, 8])
def test_lut_interpolate_edges_match_reference(addr_bits):
    """Below -4 (clamped), exactly on bin centres and edges, inside the first
    half-bin (linear extrapolation: frac < 0), in the last half-bin and
    above 4 (flat) — the reference's edge behaviour, not a 'fixed' one."""
    n = 2 ** addr_bits
    lut_j = jax_tanh_ref.make_lut(addr_bits)
    lut_pt = torch.as_tensor(np.array(lut_j))
    edges = np.linspace(-4.0, 4.0, n + 1)
    centres = (np.arange(n) + 0.5) / n * 8.0 - 4.0
    v = np.concatenate([[-9.0, -4.5, -4.0, -4.0 + 1e-3, 3.999, 4.0, 4.5, 9.0],
                        edges, centres]).astype(np.float32)
    got = pt_lut.lut_interpolate(torch.as_tensor(v), lut_pt, pt_lut.shifted_table(lut_pt), n)
    want = jax_lut.lut_interpolate(jnp.asarray(v), lut_j, jax_lut.shifted_table(lut_j), n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    ref = jax_tanh_ref.tanh_lut_ref(jnp.asarray(v), lut_j)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=0)
    # extrapolated below the first centre, flat above the last one
    first, last = float(lut_pt[0]), float(lut_pt[-1])
    assert float(got[2]) < first and float(got[6]) == pytest.approx(last)


def test_kernel_launcher_refuses_non_cuda_tensors():
    """The kernel path never runs a CPU stand-in: a non-CUDA tensor that
    reaches it raises."""
    args = _pt(*_case(1, 3, 8, 8, seed=0))
    with pytest.raises(RuntimeError, match="CUDA"):
        pt_kernel.lstm_seq(*args)
