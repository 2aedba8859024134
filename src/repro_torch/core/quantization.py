"""Fixed-point analysis subsystem (paper §III-C, §IV-E, Fig. 11); the port's
copy of ``repro/core/quantization.py``.

The paper's stage-3 workflow step: pick word lengths by simulating the
state-space system in fixed point and measuring output SNR against a
double-precision reference.  On FPGA the datapath is arbitrary-width; on the
card the *deployment* precisions are fp32 and int8, so this module serves
two roles:

1. **Analysis** — bit-exact simulation of arbitrary Q(m.n) fixed-point
   arithmetic (exact integer path up to 29-bit words; float64
   round-to-step beyond, which is exact until the quantization step drops
   below double-precision ULP — consistent with the paper's observation that
   64-bit fixed point "approaches double-precision accuracy").
2. **Deployment** — per-channel symmetric int8 quantization
   (:func:`quantize_int8`, in torch: the one rounding rule that the
   quantized serving path, ``runtime/quantized.py``, and the int8 kernel's
   ``quantize_per_channel`` share).

Plus the state-space bonus the paper highlights: *analytic* propagation of
quantization noise through a linear system via the transition matrices,
validated against Monte-Carlo simulation in tests.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np
import torch

# NOTE: the analysis part of this module is deliberately NumPy (float64/int64) — it is the
# *reference analysis* stage of the workflow, run offline like the paper's
# MATLAB step, and bit-exact with the reference's copy.

_EXACT_MAX_BITS = 29  # products of two w-bit ints + 4-wide accum fit int64


@dataclasses.dataclass(frozen=True)
class FixedPointFormat:
    """Signed fixed point with ``total_bits`` (incl. sign) and ``frac_bits``."""

    total_bits: int
    frac_bits: int

    @property
    def int_bits(self) -> int:
        return self.total_bits - self.frac_bits

    @property
    def scale(self) -> float:
        return float(2.0 ** self.frac_bits)

    @property
    def max_int(self) -> int:
        return 2 ** (self.total_bits - 1) - 1

    @property
    def min_int(self) -> int:
        return -(2 ** (self.total_bits - 1))

    @property
    def exact(self) -> bool:
        return self.total_bits <= _EXACT_MAX_BITS

    def quantize_int(self, x: np.ndarray) -> np.ndarray:
        """Real → integer code (round-to-nearest, saturate)."""
        q = np.rint(np.asarray(x, np.float64) * self.scale)
        return np.clip(q, self.min_int, self.max_int).astype(np.int64)

    def to_real(self, q: np.ndarray) -> np.ndarray:
        return np.asarray(q, np.float64) / self.scale

    def quantize_real(self, x: np.ndarray) -> np.ndarray:
        """Round a real value onto the fixed-point grid (wide-word path)."""
        if self.exact:
            return self.to_real(self.quantize_int(x))
        lo = self.min_int / self.scale
        hi = self.max_int / self.scale
        return np.clip(np.rint(np.asarray(x, np.float64) * self.scale) / self.scale, lo, hi)


def default_format(total_bits: int) -> FixedPointFormat:
    """The paper's convention: one shared word length for all layers; we
    allocate 4 integer bits (sign + range ±8) — enough for tanh-bounded
    states times unit-scale weights in the case-study MLP."""
    return FixedPointFormat(total_bits=total_bits, frac_bits=total_bits - 4)


# ---------------------------------------------------------------------------
# LUT-based tanh (paper §IV-B: ROM LUT, computed offline)
# ---------------------------------------------------------------------------

_TANH_RANGE = 4.0  # |x| >= 4 saturates within 1 LSB for w <= ~13 frac bits


def make_tanh_lut(addr_bits: int, out_fmt: FixedPointFormat) -> np.ndarray:
    """Quantized tanh samples over [-R, R) — the ROM contents."""
    n = 2 ** addr_bits
    centers = (np.arange(n) + 0.5) / n * (2 * _TANH_RANGE) - _TANH_RANGE
    return out_fmt.quantize_real(np.tanh(centers))


def tanh_lut_apply(
    x: np.ndarray,
    lut: np.ndarray,
    interp: bool = True,
) -> np.ndarray:
    """Apply the ROM: clamp, index, (optionally linearly interpolate)."""
    n = lut.shape[0]
    xf = np.clip(np.asarray(x, np.float64), -_TANH_RANGE, _TANH_RANGE - 1e-12)
    pos = (xf + _TANH_RANGE) / (2 * _TANH_RANGE) * n - 0.5
    i0 = np.clip(np.floor(pos).astype(np.int64), 0, n - 1)
    if not interp:
        return lut[np.clip(np.rint(pos).astype(np.int64), 0, n - 1)]
    i1 = np.minimum(i0 + 1, n - 1)
    frac = pos - i0
    return lut[i0] * (1 - frac) + lut[i1] * frac


# ---------------------------------------------------------------------------
# Fixed-point MLP forward (the RTL datapath simulated bit-accurately)
# ---------------------------------------------------------------------------

def fixed_mlp_forward(
    W_stack: np.ndarray,  # [N, M, M] float64 weights
    b_stack: np.ndarray,  # [N, M]
    beta: np.ndarray,     # [M, L]
    C: np.ndarray,        # [P, M]
    u: np.ndarray,        # [L] or [R, L]
    fmt: FixedPointFormat,
    tanh_mode: Literal["lut", "interp", "exact"] = "interp",
    lut_addr_bits: int | None = None,
) -> np.ndarray:
    """Simulate the synthesized datapath: w-bit stored values, wide MACC
    accumulator (DSP48-style), LUT tanh, shared format across layers
    (paper §IV-C).  Vectorized over a batch of inputs if ``u`` is 2-D."""
    single = u.ndim == 1
    U = np.atleast_2d(np.asarray(u, np.float64))  # [R, L]

    addr = lut_addr_bits if lut_addr_bits is not None else min(max(fmt.total_bits, 8), 16)
    lut = make_tanh_lut(addr, fmt) if tanh_mode != "exact" else None

    qW = [fmt.quantize_real(W) for W in W_stack]
    qb = [fmt.quantize_real(b) for b in b_stack]
    qbeta = fmt.quantize_real(beta)
    qC = fmt.quantize_real(C)

    x = fmt.quantize_real(U @ qbeta.T)  # x0 = β u  (the δ[k] injection)
    for k in range(W_stack.shape[0]):
        # MACC in a wide accumulator (exact in f64 for w<=29 since the grid
        # spacing of products is 2^-2n and sums stay within 2^53 ULPs).
        acc = x @ qW[k].T + qb[k]
        if tanh_mode == "exact":
            x = fmt.quantize_real(np.tanh(acc))
        else:
            x = fmt.quantize_real(
                tanh_lut_apply(acc, lut, interp=(tanh_mode == "interp"))
            )
    y = fmt.quantize_real(x @ qC.T)
    return y[0] if single else y


def float_mlp_forward(W_stack, b_stack, beta, C, u) -> np.ndarray:
    """Double-precision reference (the paper's MATLAB simulation)."""
    U = np.atleast_2d(np.asarray(u, np.float64))
    x = U @ np.asarray(beta, np.float64).T
    for k in range(W_stack.shape[0]):
        x = np.tanh(x @ np.asarray(W_stack[k], np.float64).T + b_stack[k])
    y = x @ np.asarray(C, np.float64).T
    return y[0] if np.asarray(u).ndim == 1 else y


def output_snr_db(y_ref: np.ndarray, y_test: np.ndarray) -> np.ndarray:
    """Per-output-channel SNR in dB (paper Fig. 11 metric)."""
    y_ref = np.atleast_2d(y_ref)
    y_test = np.atleast_2d(y_test)
    sig = np.sum(y_ref ** 2, axis=0)
    err = np.sum((y_test - y_ref) ** 2, axis=0)
    err = np.where(err == 0, np.finfo(np.float64).tiny, err)
    return 10.0 * np.log10(sig / err)


def snr_sweep(
    W_stack, b_stack, beta, C,
    bit_widths, num_inputs: int = 256, seed: int = 0,
    tanh_mode: Literal["lut", "interp", "exact"] = "interp",
):
    """Reproduce Fig. 11: SNR per output channel vs total word length."""
    rng = np.random.default_rng(seed)
    U = rng.uniform(-1, 1, size=(num_inputs, beta.shape[1]))
    y_ref = float_mlp_forward(W_stack, b_stack, beta, C, U)
    rows = []
    for w in bit_widths:
        fmt = default_format(w)
        y = fixed_mlp_forward(W_stack, b_stack, beta, C, U, fmt, tanh_mode=tanh_mode)
        rows.append((w, output_snr_db(y_ref, y)))
    return rows


# ---------------------------------------------------------------------------
# Analytic quantization-noise propagation through a linear state-space system
# ---------------------------------------------------------------------------

def linear_noise_gain(A_seq: np.ndarray, C: np.ndarray) -> float:
    """For x[k+1] = A[k]x[k] + e[k] with white quantization noise e[k]
    (var σ² per component) injected at every state register, the output
    noise variance is   σ² · Σ_k ‖C Φ_{N,k+1}‖_F²   where Φ_{N,k} is the
    state-transition matrix from step k to N.  Returns the Σ‖·‖² gain, so
    predicted output noise var = gain · σ².  (Paper §III-C: "one can
    systematically analyze the effect of quantization noise".)"""
    N, M, _ = A_seq.shape
    gain = 0.0
    phi = np.eye(M)
    # iterate k = N-1 ... 0; Φ_{N,k+1} accumulates products of later A's
    for k in range(N - 1, -1, -1):
        gain += float(np.sum((np.asarray(C, np.float64) @ phi) ** 2))
        phi = phi @ np.asarray(A_seq[k], np.float64)
    return gain


# ---------------------------------------------------------------------------
# Deployment path: per-channel symmetric int8 (torch)
# ---------------------------------------------------------------------------

def quantize_int8(x: torch.Tensor, axis: int | None = -1):
    """Symmetric per-channel int8 quantization: ``(q int8, scale fp32)``
    with ``x ≈ q * scale``; ``axis`` is reduced (kept as size 1 in
    ``scale``), or all of ``x`` with ``axis=None``.  Scale
    ``max(amax, 1e-8) / 127`` in fp32, codes rounded half to even
    (``torch.round``, as ``jnp.round``) and clipped to ±127: bit-exact with
    the reference's ``quantize_int8`` on every device."""
    x = x.to(torch.float32)
    amax = x.abs().amax() if axis is None else x.abs().amax(dim=axis, keepdim=True)
    amax = torch.clamp(amax, min=1e-8)
    # a true division on every device: PyTorch divides a CUDA tensor by a
    # Python scalar as a product with its reciprocal, which can miss the
    # quotient by one ulp and move codes
    scale = amax / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale
