"""Public wrapper of blocked attention; the port's counterpart of
``repro/kernels/flash_attention/ops.py``.

The tensor's device picks the path: a CUDA tensor launches the hand-written
Hopper kernel (``kernel.py``), a CPU tensor takes the plain PyTorch version
(``ref.py``).  There is no fallback between the two: a failed build or launch
raises.  The TPU kernel's tiling keywords (``bq``, ``bk``) blocked its VMEM
and change no result, so they are not carried over.
``flash_attention.calls`` counts the calls that reached the kernel through
this wrapper, ``flash_attention.launches`` their CUDA launches: one a call,
two where the host split the key axis (the kernel and its combining pass).
"""

from __future__ import annotations

import torch

from . import kernel as _k
from .ref import flash_attention_ref


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0):
    """out [B,S,H,hd] = attention of q [B,S,H,hd] over k, v [B,T,KV,hd]
    (see ``ref.py``).

    q, k, v may be bf16: they are computed in fp32, as the TPU kernel does,
    and the result comes back in q's dtype.  They may be strided views (after
    RoPE and a reshape): the kernel gets contiguous fp32 copies.
    """
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window, softcap=softcap)
    q32, k32, v32 = (t.to(torch.float32).contiguous() for t in (q, k, v))
    out = _k.flash_attention(q32, k32, v32, causal=causal, window=window, softcap=softcap)
    flash_attention.calls += 1
    # the key shares that call chose, from the shapes it has just accepted
    flash_attention.launches += _k.launches_per_call(
        _k.splits(q32, k32, causal=causal, window=window))
    return out.to(q.dtype)


flash_attention.calls = 0
flash_attention.launches = 0


__all__ = ["flash_attention", "flash_attention_ref"]
