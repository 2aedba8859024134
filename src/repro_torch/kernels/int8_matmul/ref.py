"""Plain PyTorch versions of the fixed-point MACC matmul; the port's copy of
``repro/kernels/int8_matmul/ref.py``: int8 × int8 → int32 → f32.

The accumulator is exact int32.  On the CPU it is an int32 matmul; on the
card, where ``torch.matmul`` has no integer path, it is a float64 matmul
cast back to int32, exact because |acc| ≤ 128²·K < 2^53 (and equal to the
int32 sum while that does not overflow, K < 131 072).
"""

from __future__ import annotations

import torch


def int8_matmul_ref(a_q, b_q, a_scale, b_scale):
    """a_q: [M,K] int8, b_q: [K,N] int8, a_scale: [M,1] f32, b_scale: [1,N].
    Returns f32 [M,N] ≈ (a_q·a_scale) @ (b_q·b_scale), rescaled as
    ``acc · a_scale · b_scale`` in that order."""
    if a_q.device.type == "cpu":
        acc = a_q.to(torch.int32) @ b_q.to(torch.int32)
    else:
        acc = (a_q.to(torch.float64) @ b_q.to(torch.float64)).to(torch.int32)
    return acc.to(torch.float32) * a_scale * b_scale


def quantize_matmul_ref(a, b):
    """Float API: per-row/per-col symmetric int8 quantized matmul."""
    # a true division on every device (a CUDA tensor divided by a Python
    # scalar is multiplied by its reciprocal instead)
    a_amax = torch.clamp(a.abs().amax(dim=1, keepdim=True), min=1e-8)
    b_amax = torch.clamp(b.abs().amax(dim=0, keepdim=True), min=1e-8)
    a_s = a_amax / torch.full_like(a_amax, 127.0)
    b_s = b_amax / torch.full_like(b_amax, 127.0)
    a_q = torch.clamp(torch.round(a / a_s), -127, 127).to(torch.int8)
    b_q = torch.clamp(torch.round(b / b_s), -127, 127).to(torch.int8)
    return int8_matmul_ref(a_q, b_q, a_s, b_s)


__all__ = ["int8_matmul_ref", "quantize_matmul_ref"]
