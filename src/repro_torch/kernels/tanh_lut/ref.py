"""The tanh ROM table (paper §IV-B: ROM LUT + interpolation); the port's copy
of ``repro/kernels/tanh_lut/ref.py::make_lut``.  The standalone ``tanh_lut``
kernel is not ported yet (ROADMAP Queue 2)."""

from __future__ import annotations

import torch

RANGE = 4.0


def make_lut(addr_bits: int, device=None) -> torch.Tensor:
    """n = 2**addr_bits samples of tanh at the bin centres over [-4, 4)."""
    n = 2 ** addr_bits
    centers = (torch.arange(n, dtype=torch.float32, device=device) + 0.5) / n \
        * (2 * RANGE) - RANGE
    return torch.tanh(centers)


__all__ = ["RANGE", "make_lut"]
