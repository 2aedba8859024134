"""The port's ROM-LUT tanh on the CPU against the JAX reference: its plain
version against the reference's ``tanh_lut_ref`` and its Pallas kernel in
interpret mode (the reference tests' default here).  Bar: 1e-6 — the same
fp32 arithmetic in the same order, up to the last bit of an interpolation."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.tanh_lut import ops as j_ops  # noqa: E402
from repro.kernels.tanh_lut.ref import make_lut as j_make_lut  # noqa: E402
from repro.kernels.tanh_lut.ref import tanh_lut_ref as j_ref  # noqa: E402
from repro_torch.kernels.tanh_lut import ops  # noqa: E402
from repro_torch.kernels.tanh_lut.ref import make_lut, tanh_lut_ref  # noqa: E402


@pytest.mark.parametrize("bits", [6, 8, 12])
def test_make_lut_matches_reference(bits):
    """torch.tanh and jnp.tanh round differently in the last bit."""
    np.testing.assert_allclose(make_lut(bits).numpy(), np.asarray(j_make_lut(bits)),
                               atol=2.5e-7, rtol=0)


@pytest.mark.parametrize("shape,bits", [((1,), 6), ((1023,), 8), ((4, 33, 7), 12),
                                        ((2048,), 10)])
def test_tanh_lut_ref_matches_reference_and_its_kernel(shape, bits):
    r = np.random.default_rng(bits)
    x = (r.normal(size=shape) * 3).astype(np.float32)
    x.reshape(-1)[:3] = (-9.0, 3.999999, 0.0)[: x.size]   # clamps, edges, zero
    lut_np = np.array(j_make_lut(bits))
    got = ops.tanh_lut(torch.as_tensor(x), torch.as_tensor(lut_np))
    assert tuple(got.shape) == shape and got.dtype == torch.float32
    want = j_ref(jnp.asarray(x), jnp.asarray(lut_np))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
    kern = j_ops.tanh_lut(jnp.asarray(x), jnp.asarray(lut_np))
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), atol=1e-6, rtol=1e-6)


def test_tanh_lut_keeps_dtype_and_is_close_to_tanh():
    x = torch.linspace(-6, 6, 301, dtype=torch.float64)
    y = tanh_lut_ref(x, make_lut(12))
    assert y.dtype == torch.float64
    assert float((y - torch.tanh(x)).abs().max()) < 1e-3


def test_tanh_lut_wrapper_sends_other_devices_to_the_kernel():
    """A CPU tensor takes the plain version; any other device goes to the
    kernel, which needs CUDA tensors and raises — never the plain path."""
    launches = ops.tanh_lut.launches
    ops.tanh_lut(torch.zeros(5), make_lut(6))
    assert ops.tanh_lut.launches == launches
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.tanh_lut(torch.empty(5, device="meta"), torch.empty(64, device="meta"))
