"""Recurrent block for the layer stack: RMSNorm → LSTM/GRU cell → out-proj,
residual; the port's counterpart of ``repro/recurrent/block.py``.

Prefill runs the whole sequence and emits the final ``(h, c)`` carry as the
decode state; decode applies the one-step transition map.  The carry is the
entire serving state — O(1) per slot.

``cfg.use_pallas`` routes LSTM prefill through the hand-written fused kernel
(``kernels/lstm_cell``: the Hopper CUDA kernel for CUDA tensors, its plain
version on the CPU).  ``cfg.use_codegen`` (the generated kernel of the
reference's ``codegen`` package) is not ported yet and raises.
"""

from __future__ import annotations

from typing import Any, TYPE_CHECKING

import torch

from repro_torch.kernels.lstm_cell import ops as lstm_ops
from repro_torch.models.layers import dense_init

from . import cells

if TYPE_CHECKING:
    from repro_torch.models.config import ModelConfig

PyTree = Any


def recurrent_params(gen: torch.Generator, cfg: "ModelConfig") -> PyTree:
    D, H = cfg.d_model, cfg.rnn_hidden_actual
    ctor = cells.lstm_params if cfg.rnn_cell == "lstm" else cells.gru_params
    return {
        "cell": ctor(gen, D, H, cfg.p_dtype),
        "w_out": dense_init(gen, (H, D), cfg.p_dtype),
    }


def recurrent_init_state(cfg: "ModelConfig", batch: int, device) -> PyTree:
    H = cfg.rnn_hidden_actual
    st = {"h": torch.zeros((batch, H), dtype=torch.float32, device=device)}
    if cfg.rnn_cell == "lstm":
        st["c"] = torch.zeros((batch, H), dtype=torch.float32, device=device)
    return st


def _carry_in(cfg: "ModelConfig", state: PyTree):
    return (state["h"], state["c"]) if cfg.rnn_cell == "lstm" else state["h"]


def _carry_out(cfg: "ModelConfig", carry) -> PyTree:
    if cfg.rnn_cell == "lstm":
        return {"h": carry[0], "c": carry[1]}
    return {"h": carry}


def recurrent_prefill(p: PyTree, cfg: "ModelConfig", u: torch.Tensor,
                      state: PyTree | None = None):
    """u: [B, T, D] → (y [B, T, D], state).  Resumes from ``state`` if given."""
    if cfg.use_codegen:
        raise NotImplementedError(
            "use_codegen: the generated fused scan-step kernel is not ported "
            "yet (ROADMAP.md, Queue 1: Generated-kernel backend)")
    carry0 = None if state is None else _carry_in(cfg, state)
    if cfg.use_pallas and cfg.rnn_cell == "lstm":
        c = p["cell"]
        h0, c0 = (None, None) if carry0 is None else carry0
        y, h_f, c_f = lstm_ops.lstm_seq(
            u.float(), c["w_x"].float(), c["w_h"].float(), c["b"].float(),
            h0=h0, c0=c0,
        )
        carry = (h_f, c_f)
    else:
        y, carry = cells.cell_seq(cfg.rnn_cell, p["cell"], u, carry0)
    out = y.to(u.dtype) @ p["w_out"]
    return out, _carry_out(cfg, carry)


def recurrent_decode(p: PyTree, cfg: "ModelConfig", u_t: torch.Tensor, state: PyTree):
    """One token: u_t [B, 1, D] → (y [B, 1, D], state') — the transition map f."""
    carry = _carry_in(cfg, state)
    if cfg.rnn_cell == "lstm":
        h_new, c_new = cells.lstm_step(p["cell"], carry, u_t[:, 0])
        carry = (h_new, c_new)
    else:
        h_new = cells.gru_step(p["cell"], carry, u_t[:, 0])
        carry = h_new
    y = (h_new.to(u_t.dtype) @ p["w_out"])[:, None]
    return y, _carry_out(cfg, carry)


__all__ = [
    "recurrent_decode",
    "recurrent_init_state",
    "recurrent_params",
    "recurrent_prefill",
]
