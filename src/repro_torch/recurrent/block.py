"""Recurrent block for the layer stack: RMSNorm → LSTM/GRU cell → out-proj,
residual; the port's counterpart of ``repro/recurrent/block.py``.

Prefill runs the whole sequence and emits the final ``(h, c)`` carry as the
decode state; decode applies the one-step transition map.  The carry is the
entire serving state — O(1) per slot.

Fast paths: ``cfg.use_codegen`` routes LSTM and GRU prefill through the
*generated* stage kernel of :mod:`repro_torch.codegen` (produced from the
cell's datapath IR; ``cfg.quant_gate_bits`` in (0, 8] selects its int8 MACC
path); ``cfg.use_pallas`` routes LSTM prefill through the hand-written fused
kernel (``kernels/lstm_cell``).  ``use_codegen`` takes precedence, as in the
reference.  Each runs its CUDA kernel for CUDA tensors and its plain version
on the CPU; ``cells.cell_seq`` is the plain path and the oracle for both.
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


# Generated-kernel runners, one per (cell, D, H, quant_bits) datapath shape.
# A runner holds graph structure only (the lowered plan and its CUDA source)
# — weights are re-bound every call, so trained parameters flow through
# without regenerating.
_CODEGEN_RUNNERS: dict[tuple, Any] = {}


def _codegen_seq(cell: str, p_cell: PyTree, u: torch.Tensor, carry0,
                 quant_bits: int = 0):
    """Prefill via the codegen kernel backend (lstm AND gru).
    ``quant_bits`` in (0, 8] routes the gate contractions through the int8
    MACC path of the generated kernel (the paper's fixed-point stage)."""
    from repro_torch import codegen

    B, _, D = u.shape
    H = cells.cell_hidden_size(p_cell, cell)
    key = (cell, D, H, quant_bits)
    run = _CODEGEN_RUNNERS.get(key)
    if run is None:
        run, _ = codegen.cell_stage_runner(
            cell, D, H, device=u.device, quant_bits=quant_bits or None)
        _CODEGEN_RUNNERS[key] = run
    if carry0 is None:
        carry0 = cells.init_carry(cell, p_cell, (B,))
    x0 = {"h": carry0[0], "c": carry0[1]} if cell == "lstm" else {"h": carry0}
    finals, ys = run(codegen.bind_cell_params(cell, p_cell), x0, u.float())
    carry = (finals["h"], finals["c"]) if cell == "lstm" else finals["h"]
    return ys, carry


def recurrent_prefill(p: PyTree, cfg: "ModelConfig", u: torch.Tensor,
                      state: PyTree | None = None):
    """u: [B, T, D] → (y [B, T, D], state).  Resumes from ``state`` if given."""
    carry0 = None if state is None else _carry_in(cfg, state)
    if cfg.use_codegen and cfg.rnn_cell in ("lstm", "gru"):
        y, carry = _codegen_seq(cfg.rnn_cell, p["cell"], u, carry0,
                                quant_bits=cfg.quant_gate_bits)
    elif cfg.use_pallas and cfg.rnn_cell == "lstm":
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
