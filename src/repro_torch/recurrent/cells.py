"""LSTM / GRU cells as state-space systems; the port's counterpart of
``repro/recurrent/cells.py``.

A recurrent cell is the paper's eq. (1) with shared per-step parameters:

    x[k+1] = f(x[k], u[k])     x = (h, c) for LSTM, x = h for GRU
    y[k]   = g(x[k], u[k])     Mealy output: y[k] = h[k+1] depends on u[k]

Gate conventions
----------------
LSTM (order i, f, g, o along the fused 4H axis; forget bias +1):
    z = u @ W_x + h @ W_h + b
    c' = sigmoid(z_f) * c + sigmoid(z_i) * tanh(z_g)
    h' = sigmoid(z_o) * tanh(c')
GRU (order r, z, n along 3H; candidate uses a separate hidden bias so the
reset gate acts inside the tanh, torch-style):
    r = sigmoid(u@Wx_r + h@Wh_r + b_r);  z = sigmoid(...)
    n = tanh(u@Wx_n + b_n + r * (h@Wh_n + bh_n))
    h' = (1 - z) * n + z * h

``lstm_cell``/``gru_cell``/``make_cell`` are the paper-form views
(``StateSpaceModel``s whose weights ride in the closure — the shared ROM), and
``run_cell`` runs one through ``core.state_space.run_scan``.  ``cell_seq`` is
the batch-major time loop the serving block uses: one step map per time step,
where the paper-form view evaluates it twice (``f`` and ``g``), which XLA
merges in the reference and eager PyTorch does not.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.state_space import StateSpaceModel, run_scan

PyTree = Any


# ---------------------------------------------------------------------------
# parameter construction
# ---------------------------------------------------------------------------

def lstm_params(gen: torch.Generator, d_in: int, hidden: int,
                dtype=torch.float32) -> PyTree:
    """Fused-gate LSTM parameters: one [D, 4H] input and [H, 4H] hidden map,
    drawn on ``gen``'s device."""
    dev = gen.device
    b = torch.zeros((4 * hidden,), dtype=torch.float32, device=dev)
    b[hidden : 2 * hidden] = 1.0  # forget-gate bias: remember by default
    w_x = torch.randn((d_in, 4 * hidden), generator=gen, device=dev) / np.sqrt(d_in)
    w_h = torch.randn((hidden, 4 * hidden), generator=gen, device=dev) / np.sqrt(hidden)
    return {"w_x": w_x.to(dtype), "w_h": w_h.to(dtype), "b": b.to(dtype)}


def gru_params(gen: torch.Generator, d_in: int, hidden: int,
               dtype=torch.float32) -> PyTree:
    dev = gen.device
    w_x = torch.randn((d_in, 3 * hidden), generator=gen, device=dev) / np.sqrt(d_in)
    w_h = torch.randn((hidden, 3 * hidden), generator=gen, device=dev) / np.sqrt(hidden)
    return {
        "w_x": w_x.to(dtype),
        "w_h": w_h.to(dtype),
        "b": torch.zeros((3 * hidden,), dtype=dtype, device=dev),
        "bh_n": torch.zeros((hidden,), dtype=dtype, device=dev),  # candidate's hidden bias
    }


def cell_hidden_size(params: PyTree, cell: str) -> int:
    div = 4 if cell == "lstm" else 3
    return params["w_x"].shape[-1] // div


# ---------------------------------------------------------------------------
# single-step transition maps (batched over any leading dims)
# ---------------------------------------------------------------------------

def lstm_step(params: PyTree, carry, u: torch.Tensor):
    """(h, c), u -> (h', c').  All in f32 (the state registers are exact)."""
    h, c = carry
    H = h.shape[-1]
    z = (
        u.float() @ params["w_x"].float()
        + h @ params["w_h"].float()
        + params["b"].float()
    )
    i_g = torch.sigmoid(z[..., :H])
    f_g = torch.sigmoid(z[..., H : 2 * H])
    g_g = torch.tanh(z[..., 2 * H : 3 * H])
    o_g = torch.sigmoid(z[..., 3 * H :])
    c_new = f_g * c + i_g * g_g
    h_new = o_g * torch.tanh(c_new)
    return h_new, c_new


def gru_step(params: PyTree, h: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """h, u -> h'."""
    H = h.shape[-1]
    zx = u.float() @ params["w_x"].float() + params["b"].float()
    zh = h @ params["w_h"].float()
    r = torch.sigmoid(zx[..., :H] + zh[..., :H])
    z = torch.sigmoid(zx[..., H : 2 * H] + zh[..., H : 2 * H])
    n = torch.tanh(zx[..., 2 * H :] + r * (zh[..., 2 * H :] + params["bh_n"].float()))
    return (1.0 - z) * n + z * h


# ---------------------------------------------------------------------------
# StateSpaceModel factories (the paper-form view)
# ---------------------------------------------------------------------------

def lstm_cell(params: PyTree) -> StateSpaceModel:
    """LSTM as ``StateSpaceModel``: state (h, c), Mealy output y[k] = h[k+1]."""

    def f(params_k, carry, u, k):
        del params_k, k
        return lstm_step(params, carry, u)

    def g(params_k, carry, u, k):
        del params_k, k
        h_new, _ = lstm_step(params, carry, u)
        return h_new

    return StateSpaceModel(f=f, g=g, output_mode="mealy")


def gru_cell(params: PyTree) -> StateSpaceModel:
    """GRU as ``StateSpaceModel``: state h, Mealy output y[k] = h[k+1]."""

    def f(params_k, h, u, k):
        del params_k, k
        return gru_step(params, h, u)

    def g(params_k, h, u, k):
        del params_k, k
        return gru_step(params, h, u)

    return StateSpaceModel(f=f, g=g, output_mode="mealy")


def make_cell(cell: str, params: PyTree) -> StateSpaceModel:
    if cell == "lstm":
        return lstm_cell(params)
    if cell == "gru":
        return gru_cell(params)
    raise ValueError(f"unknown recurrent cell '{cell}' (lstm|gru)")


def init_carry(cell: str, params: PyTree, batch_shape: tuple[int, ...] = ()):
    H = cell_hidden_size(params, cell)
    h = torch.zeros(batch_shape + (H,), dtype=torch.float32, device=params["w_x"].device)
    return (h, torch.zeros_like(h)) if cell == "lstm" else h


# ---------------------------------------------------------------------------
# sequence execution
# ---------------------------------------------------------------------------

def run_cell(cell: str, params: PyTree, us: torch.Tensor, carry0=None, *,
             unroll: int = 1):
    """Run a cell over a time-major input ``us: [T, ..., D]``.

    Returns (final_carry, ys [T, ..., H]) — literally
    ``run_scan(make_cell(...), None, x0, us)``: the cell's weights ride in
    the closure (constant ROM), so ``stacked_params`` is None.  ``unroll``
    is the j knob (no effect in eager execution).
    """
    if carry0 is None:
        carry0 = init_carry(cell, params, tuple(us.shape[1:-1]))
    model = make_cell(cell, params)
    return run_scan(model, None, carry0, us, length=us.shape[0], unroll=unroll)


def cell_seq(cell: str, params: PyTree, x: torch.Tensor, carry0=None):
    """Batch-major time loop: x [B, T, D] -> (y [B, T, H], final_carry)."""
    if cell not in ("lstm", "gru"):
        raise ValueError(f"unknown recurrent cell '{cell}' (lstm|gru)")
    carry = init_carry(cell, params, x.shape[:1]) if carry0 is None else carry0
    ys = []
    for t in range(x.shape[1]):
        if cell == "lstm":
            carry = lstm_step(params, carry, x[:, t])
            ys.append(carry[0])
        else:
            carry = gru_step(params, carry, x[:, t])
            ys.append(carry)
    return torch.stack(ys, dim=1), carry


__all__ = [
    "cell_hidden_size",
    "cell_seq",
    "gru_cell",
    "gru_params",
    "gru_step",
    "init_carry",
    "lstm_cell",
    "lstm_params",
    "lstm_step",
    "make_cell",
    "run_cell",
]
