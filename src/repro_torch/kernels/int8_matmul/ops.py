"""The int8 MACC matmul and its quantizers; the port's counterpart of
``repro/kernels/int8_matmul/ops.py``.

``int8_matmul`` picks its path by the tensor's device: a CUDA tensor
launches the hand-written Hopper kernel (``kernel.py``), a CPU tensor takes
the plain version (``ref.int8_matmul_ref``); there is no fallback between
the two, and ``int8_matmul.launches`` counts the kernel launches.  No model
path calls it yet (as in the reference); ``quantize_per_channel`` also packs
the generated stage kernel's int8 weight ROMs, so both packages round the
same way.  The TPU tiling keywords (``bm``, ``bn``, ``bk``) are not carried
over: they blocked VMEM and change no result.
"""

from __future__ import annotations

import torch

from . import kernel as _k
from .ref import int8_matmul_ref, quantize_matmul_ref


def int8_matmul(a_q, b_q, a_scale, b_scale):
    """f32 ``[M,N]`` = int32(a_q @ b_q) · a_scale · b_scale, bit-exact with
    ``int8_matmul_ref``."""
    if a_q.device.type == "cpu":
        return int8_matmul_ref(a_q, b_q, a_scale, b_scale)
    out = _k.int8_matmul(a_q.contiguous(), b_q.contiguous(),
                         a_scale.to(torch.float32).contiguous(),
                         b_scale.to(torch.float32).contiguous())
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0


def quantize_per_channel(w: torch.Tensor, axis: int = -2):
    """Symmetric int8 per-channel quantization of a weight ROM.

    ``axis`` is the contraction axis (reduced by the matmul): a ``[in, out]``
    matrix with ``axis=-2`` gets one scale per output channel.  Returns
    ``(w_q int8, scale f32)`` with ``scale`` keeping the reduced axis as
    size 1, so ``w_q * scale ≈ w`` broadcasts.  Scale
    ``max(|w|, 1e-8) / 127`` in fp32; codes rounded half to even
    (``torch.round``, as ``jnp.round``) and clipped to ±127 — bit-exact with
    the reference.
    """
    w = w.to(torch.float32)
    amax = torch.clamp(w.abs().amax(dim=axis, keepdim=True), min=1e-8)
    # a true division on every device: PyTorch divides a CUDA tensor by a
    # Python scalar as a product with its reciprocal, which can miss the
    # quotient by one ulp and move codes
    s = amax / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
    return q, s


def quantize_rows(a: torch.Tensor):
    """Symmetric int8 per-row activation quantization: ``(a_q, scale)`` with
    scale shaped ``[..., 1]``; bit-exact with the reference."""
    return quantize_per_channel(a, axis=-1)


def quantized_matmul(a, b):
    """Float API: per-row (M) / per-column (N) symmetric int8, int32 MACC."""
    a_q, a_s = quantize_rows(a)
    b_q, b_s = quantize_per_channel(b, axis=0)
    return int8_matmul(a_q, b_q, a_s, b_s)


__all__ = ["int8_matmul", "int8_matmul_ref", "quantize_matmul_ref", "quantize_per_channel",
           "quantize_rows", "quantized_matmul"]
