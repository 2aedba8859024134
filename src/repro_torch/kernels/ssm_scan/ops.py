"""Public wrapper of the selective scan; the port's counterpart of
``repro/kernels/ssm_scan/ops.py``.

The tensor's device picks the path: a CUDA tensor launches the hand-written
Hopper kernel (``kernel.py``), a CPU tensor takes the plain PyTorch version
(``ref.py``).  There is no fallback between the two: a failed build or launch
raises.  The carry ``h0`` is an input of the kernel, so a resumed scan
(chunked prefill) runs on the kernel like a fresh one; the TPU kernel's
tiling keywords (``chunk``, ``block_d``, ``w``) blocked its VMEM and change
no result, so they are not carried over.  ``ssm_scan.launches`` counts the
kernel launches made through this wrapper.
"""

from __future__ import annotations

import torch

from . import kernel as _k
from .ref import ssm_scan_ref


def ssm_scan(x, delta, A, B, C, h0=None):
    """y, h_final = selective scan of x [Bsz, T, D] (see ``ref.py``).

    ``x``, ``delta``, ``B``, ``C`` may be bf16: they are computed in fp32, as
    the TPU kernel does.  y comes back in x's dtype, h_final in fp32; an
    absent ``h0`` means a zero carry.
    """
    if x.device.type == "cpu":
        y, h = ssm_scan_ref(x, delta, A, B, C, h0)
        return y.to(x.dtype), h
    f32 = lambda t: t.to(torch.float32).contiguous()
    y, h = _k.ssm_scan(f32(x), f32(delta), f32(A), f32(B), f32(C),
                       None if h0 is None else f32(h0))
    ssm_scan.launches += 1
    return y.to(x.dtype), h


ssm_scan.launches = 0


__all__ = ["ssm_scan", "ssm_scan_ref"]
