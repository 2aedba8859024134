"""Public wrapper of the ROM-LUT tanh; the port's counterpart of
``repro/kernels/tanh_lut/ops.py``.

The tensor's device picks the path: a CUDA tensor launches the hand-written
Hopper kernel (``kernel.py``), a CPU tensor takes the plain version
(``ref.tanh_lut_ref``).  There is no fallback between the two.
``tanh_lut.launches`` counts the kernel launches made through this wrapper.
"""

from __future__ import annotations

import torch

from . import kernel as _k
from .ref import make_lut, tanh_lut_ref


def tanh_lut(x: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """y = interpolated table tanh of x (any shape), in x's dtype; ``lut`` a
    table from :func:`make_lut`."""
    if x.device.type == "cpu":
        return tanh_lut_ref(x, lut)
    y = _k.tanh_lut(x.to(torch.float32), lut.to(torch.float32))
    tanh_lut.launches += 1
    return y.to(x.dtype)


tanh_lut.launches = 0


__all__ = ["make_lut", "tanh_lut", "tanh_lut_ref"]
