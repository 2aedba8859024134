"""Public wrapper of the fused LSTM kernel; the port's counterpart of
``repro/kernels/lstm_cell/ops.py``.

The tensor's device picks the path: a CUDA tensor launches the hand-written
Hopper kernel (``kernel.py``), a CPU tensor takes the plain PyTorch version
(``ref.py``).  There is no fallback between the two: a failed build or launch
raises.  ``lstm_seq.launches`` counts the calls that reached the kernel through
this wrapper (one per call, which is two CUDA launches: the input GEMM and
the persistent recurrence), so a run can show that its main path went
through the kernel.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

from . import kernel as _k
from .ref import lstm_seq_lut_ref, lstm_seq_ref


def lstm_seq(x, w_x, w_h, b, h0=None, c0=None, lut=None):
    """y, h_final, c_final = fused LSTM over x [Bsz, T, D].

    The carry is an explicit input, so prefill resume and cache-seeded
    continuation use the same path as fresh starts.  ``lut`` (a tanh table
    from ``tanh_lut.ref.make_lut``) selects the ROM-LUT gate activations.
    y comes back in x's dtype, h and c in fp32.
    """
    Bsz = x.shape[0]
    H = w_h.shape[0]
    f32 = dict(dtype=torch.float32, device=x.device)
    h0 = torch.zeros((Bsz, H), **f32) if h0 is None else h0.float()
    c0 = torch.zeros((Bsz, H), **f32) if c0 is None else c0.float()
    if x.device.type == "cpu":
        if lut is None:
            y, h, c = lstm_seq_ref(x, w_x, w_h, b, h0, c0)
        else:
            y, h, c = lstm_seq_lut_ref(x, w_x, w_h, b, h0, c0, lut)
        return y.to(x.dtype), h, c
    _build.refuse_grad("lstm_seq", x, w_x, w_h, b, h0, c0, lut)
    y, h, c = _k.lstm_seq(
        x.float().contiguous(), w_x.float().contiguous(), w_h.float().contiguous(),
        b.float().contiguous(), h0.contiguous(), c0.contiguous(),
        None if lut is None else lut.float().contiguous())
    lstm_seq.launches += 1
    return y.to(x.dtype), h, c


lstm_seq.launches = 0


__all__ = ["lstm_seq", "lstm_seq_lut_ref", "lstm_seq_ref"]
