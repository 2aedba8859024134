"""ROM-LUT interpolation (paper §IV-B): plain PyTorch versions of the
reference's ``kernels/_lut.py``.

On the card the same arithmetic is the ``__device__ lut_interpolate`` in
``kernels/csrc/lut.cuh``; there the gather is a direct indexed load, where
the TPU kernel used a one-hot × table matmul.  The semantics match the reference exactly, including its edge
behaviour: ``frac`` is not clipped, so values below the first sample centre
are extrapolated linearly (frac < 0) while values above the last one stay
flat (the shifted table repeats its last entry).
"""

from __future__ import annotations

import torch

RANGE = 4.0  # table domain [-RANGE, RANGE); matches tanh_lut.ref.make_lut


def lut_interpolate(v: torch.Tensor, lut: torch.Tensor, lut1: torch.Tensor,
                    n: int) -> torch.Tensor:
    """Interpolated table lookup.  v: any shape (f32); lut/lut1: [n] where
    ``lut1`` is ``lut`` shifted left by one entry (last entry repeated)."""
    xf = torch.clamp(v, -RANGE, RANGE - 1e-6)
    pos = (xf + RANGE) / (2 * RANGE) * n - 0.5
    i0 = torch.clamp(torch.floor(pos).to(torch.int64), 0, n - 1)
    frac = pos - i0.to(torch.float32)
    return lut[i0] * (1 - frac) + lut1[i0] * frac


def shifted_table(lut: torch.Tensor) -> torch.Tensor:
    """The interpolation partner table: lut shifted by one, edge repeated."""
    return torch.cat([lut[1:], lut[-1:]])


__all__ = ["RANGE", "lut_interpolate", "shifted_table"]
