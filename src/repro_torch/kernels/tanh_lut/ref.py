"""Plain versions for the ROM-LUT tanh (paper §IV-B: ROM LUT + interpolation);
the port's copy of ``repro/kernels/tanh_lut/ref.py``."""

from __future__ import annotations

import torch

RANGE = 4.0


def make_lut(addr_bits: int, device=None) -> torch.Tensor:
    """n = 2**addr_bits samples of tanh at the bin centres over [-4, 4)."""
    n = 2 ** addr_bits
    centers = (torch.arange(n, dtype=torch.float32, device=device) + 0.5) / n \
        * (2 * RANGE) - RANGE
    return torch.tanh(centers)


def tanh_lut_ref(x: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """Clamp to ±RANGE, linear-interpolate between the two nearest entries;
    the result in x's dtype."""
    n = lut.shape[0]
    lut = lut.to(torch.float32)
    xf = torch.clamp(x.to(torch.float32), -RANGE, RANGE - 1e-6)
    pos = (xf + RANGE) / (2 * RANGE) * n - 0.5
    i0 = torch.clamp(torch.floor(pos).to(torch.int64), 0, n - 1)
    i1 = torch.clamp(i0 + 1, max=n - 1)
    frac = pos - i0.to(torch.float32)
    return (lut[i0] * (1 - frac) + lut[i1] * frac).to(x.dtype)


__all__ = ["RANGE", "make_lut", "tanh_lut_ref"]
