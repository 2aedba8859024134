"""Plain PyTorch versions of the fused LSTM kernel; the port's copy of
``repro/kernels/lstm_cell/ref.py``.

Contract (matches the kernel and ``ops``):
    y, h_final, c_final = lstm_seq(x, w_x, w_h, b, h0, c0)
      x        : [Bsz, T, D]
      w_x      : [D, 4H]      fused gates, order (i, f, g, o)
      w_h      : [H, 4H]
      b        : [4H]
      h0, c0   : [Bsz, H]
    step: z  = [x_t, h] @ [w_x; w_h] + b          (ONE [D+H, 4H] contraction)
          c' = σ(z_f)·c + σ(z_i)·tanh(z_g)
          h' = σ(z_o)·tanh(c');   y_t = h'
All in fp32; y is returned in fp32.

The LUT variant replaces tanh/σ with the paper's ROM-LUT activation
(§IV-B): tanh from an interpolated table, σ(x) = (1 + tanh(x/2)) / 2.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._lut import lut_interpolate, shifted_table


def _gates(z, H, tanh_fn, sig_fn):
    i_g = sig_fn(z[..., :H])
    f_g = sig_fn(z[..., H : 2 * H])
    g_g = tanh_fn(z[..., 2 * H : 3 * H])
    o_g = sig_fn(z[..., 3 * H :])
    return i_g, f_g, g_g, o_g


def _lstm_seq(x, w_x, w_h, b, h0, c0, tanh_fn, sig_fn):
    x = x.float()
    W = torch.cat([w_x, w_h], dim=0).float()  # [D+H, 4H]
    b = b.float()
    H = w_h.shape[0]
    h, c = h0.float(), c0.float()
    ys = []
    for t in range(x.shape[1]):
        z = torch.cat([x[:, t], h], dim=-1) @ W + b
        i_g, f_g, g_g, o_g = _gates(z, H, tanh_fn, sig_fn)
        c = f_g * c + i_g * g_g
        h = o_g * tanh_fn(c)
        ys.append(h)
    return torch.stack(ys, dim=1), h, c


def lstm_seq_ref(x, w_x, w_h, b, h0, c0):
    return _lstm_seq(x, w_x, w_h, b, h0, c0, torch.tanh, torch.sigmoid)


def lstm_seq_lut_ref(x, w_x, w_h, b, h0, c0, lut):
    """Oracle for the quantized path: gate activations via the tanh ROM-LUT."""
    lut = lut.float()
    lut1 = shifted_table(lut)
    n = lut.shape[0]
    tanh_fn = lambda v: lut_interpolate(v, lut, lut1, n)
    sig_fn = lambda v: 0.5 * (1.0 + tanh_fn(0.5 * v))
    return _lstm_seq(x, w_x, w_h, b, h0, c0, tanh_fn, sig_fn)


__all__ = ["lstm_seq_lut_ref", "lstm_seq_ref"]
