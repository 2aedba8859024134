"""The port's int8 MACC matmul and its quantizers on the CPU against the JAX
package, bit for bit: ``int8_matmul`` against the reference's Pallas kernel
(interpret mode) and its oracle, ``quantize_rows`` / ``quantize_per_channel``
codes and scales, and ``quantized_matmul`` end to end.  Inputs come from
numpy seeds."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.int8_matmul import ops as jax_ops  # noqa: E402
from repro.kernels.int8_matmul.ref import int8_matmul_ref as jax_ref  # noqa: E402
from repro.kernels.int8_matmul.ref import quantize_matmul_ref as jax_qref  # noqa: E402
from repro_torch.kernels.int8_matmul import ops  # noqa: E402
from repro_torch.kernels.int8_matmul.ref import int8_matmul_ref, quantize_matmul_ref  # noqa: E402


def _operands(M, K, N, seed, lo=-127):
    r = np.random.default_rng(seed)
    a = r.integers(lo, 128, size=(M, K)).astype(np.int8)
    b = r.integers(lo, 128, size=(K, N)).astype(np.int8)
    a_s = r.uniform(0.01, 0.1, size=(M, 1)).astype(np.float32)
    b_s = r.uniform(0.01, 0.1, size=(1, N)).astype(np.float32)
    return a, b, a_s, b_s


def _equal(pt, ref):
    np.testing.assert_array_equal(pt.numpy(), np.asarray(ref))


@pytest.mark.parametrize("M,K,N", [(32, 64, 16), (64, 128, 32), (96, 64, 48),
                                   (33, 100, 77), (3, 5, 7), (1, 40, 9)])
def test_int8_matmul_bit_exact_with_reference(M, K, N):
    arrs = _operands(M, K, N, seed=M * K + N)
    blk = dict(bm=32, bn=32, bk=32)
    want_k = jax_ops.int8_matmul(*(jnp.asarray(a) for a in arrs), **blk)
    want_r = jax_ref(*(jnp.asarray(a) for a in arrs))
    ops.int8_matmul.launches = 0
    got = ops.int8_matmul(*(torch.as_tensor(a) for a in arrs))
    assert got.dtype == torch.float32 and tuple(got.shape) == (M, N)
    _equal(got, want_k)
    _equal(got, want_r)
    assert ops.int8_matmul.launches == 0          # the CPU path is the plain version


def test_int8_matmul_full_code_range():
    """-128 codes (outside the quantizers' ±127) and a long K still give the
    reference's bits: the int32 accumulator is exact."""
    arrs = _operands(8, 4096, 5, seed=1, lo=-128)
    arrs[0][0, :] = -128
    arrs[1][:, 0] = -128
    got = int8_matmul_ref(*(torch.as_tensor(a) for a in arrs))
    _equal(got, jax_ref(*(jnp.asarray(a) for a in arrs)))


@pytest.mark.parametrize("shape", [(7, 33), (64, 128), (1, 5)])
def test_quantizers_bit_exact_with_reference(shape):
    r = np.random.default_rng(sum(shape))
    a = (r.normal(size=shape) * 3).astype(np.float32)
    a[0, 0] = 0.0
    for got, want in ((ops.quantize_rows(torch.as_tensor(a)), jax_ops.quantize_rows(jnp.asarray(a))),
                      (ops.quantize_per_channel(torch.as_tensor(a), axis=0),
                       jax_ops.quantize_per_channel(jnp.asarray(a), axis=0))):
        assert got[0].dtype == torch.int8 and got[1].dtype == torch.float32
        _equal(got[0], want[0])
        _equal(got[1], want[1])
    zeros = ops.quantize_rows(torch.zeros((2, 3)))
    _equal(zeros[0], np.zeros((2, 3), np.int8))


@pytest.mark.parametrize("M,K,N", [(64, 128, 64), (5, 17, 3)])
def test_quantized_matmul_bit_exact_with_reference(M, K, N):
    r = np.random.default_rng(M + K + N)
    a = r.normal(size=(M, K)).astype(np.float32)
    b = r.normal(size=(K, N)).astype(np.float32)
    got = ops.quantized_matmul(torch.as_tensor(a), torch.as_tensor(b))
    _equal(got, jax_ops.quantized_matmul(jnp.asarray(a), jnp.asarray(b)))
    _equal(quantize_matmul_ref(torch.as_tensor(a), torch.as_tensor(b)),
           jax_qref(jnp.asarray(a), jnp.asarray(b)))
    rel = float(torch.linalg.norm(got - torch.as_tensor(a @ b)) / np.linalg.norm(a @ b))
    assert rel < 0.02   # int8 MACC keeps about 1% relative error on Gaussian data
