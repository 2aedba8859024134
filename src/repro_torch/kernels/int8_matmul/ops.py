"""Per-channel int8 quantization of a weight ROM; the port's copy of
``repro/kernels/int8_matmul/ops.py::quantize_per_channel``.

The ``int8_matmul`` kernel of that module is not ported yet (ROADMAP,
Queue 2); the generated stage kernel's int8 MACC path packs its weight ROMs
with this function, so both packages round the same way.
"""

from __future__ import annotations

import torch


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
    s = torch.clamp(w.abs().amax(dim=axis, keepdim=True), min=1e-8) / 127.0
    q = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
    return q, s


__all__ = ["quantize_per_channel"]
