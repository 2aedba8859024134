"""NetworkSpec / cell → IR builders, with a registry for new cell types; the
port's counterpart of ``repro/codegen/builders.py``.

Each cell registers a builder ``(spec, device) -> Program``;
:func:`build_program` is the front of the generator.  The datapath graphs
here ARE the Table-I wiring diagrams: the LSTM graph is the fused-gate
structure the hand-written ``kernels/lstm_cell`` implements (one
concatenated [D+H, 4H] MACC feeding four gate slices), which is what lets
the kernel backend emit an equivalent CUDA stage kernel for *any* registered
cell.

Weights are drawn on the CPU from ``torch.Generator().manual_seed(spec.seed)``
with the reference's shapes and scales, in one fixed order shared with
``synthesis.create_top_module`` (so the IR path and the legacy path are
bit-identical given the same spec), then moved to ``device``.  They are not
the reference's numbers (its ``jax.random`` stream differs); parity with the
reference goes through ``repro_torch.bridge.program_from_jax``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, TYPE_CHECKING

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.recurrent import cells as rnn_cells

from .ir import DatapathGraph, GraphBuilder, Program, Schedule, Stage

if TYPE_CHECKING:  # import cycle: synthesis imports codegen for its backends
    from repro_torch.core.synthesis import NetworkSpec

PyTree = Any

CELL_BUILDERS: Dict[str, Callable[["NetworkSpec", torch.device], Program]] = {}


def register_cell(name: str):
    """Register a ``(spec, device) -> Program`` builder for a new cell type;
    it is immediately synthesizable on every backend (eager / kernel)."""

    def deco(fn):
        CELL_BUILDERS[name] = fn
        return fn

    return deco


def registered_cells() -> list[str]:
    return sorted(CELL_BUILDERS)


def build_program(spec: "NetworkSpec", device=None) -> Program:
    """spec → validated :class:`Program` with weights on ``device`` (default:
    the card)."""
    dev = resolve_device(device)
    try:
        builder = CELL_BUILDERS[spec.cell]
    except KeyError:
        raise ValueError(
            f"no codegen builder for cell '{spec.cell}'; "
            f"registered: {registered_cells()}"
        ) from None
    if spec.cell != "mlp" and spec.seq_len <= 0:
        raise ValueError(f"recurrent spec '{spec.cell}' requires seq_len > 0")
    prog = builder(spec, dev)
    prog.validate()
    return prog


# ---------------------------------------------------------------------------
# Cell graphs (shape-only — params bound separately so the recurrent block
# can reuse them with already-trained weights)
# ---------------------------------------------------------------------------

def mlp_graph(nodes: int, activation: str) -> DatapathGraph:
    """Paper eq. 8: x[k+1] = af(W[k] x[k] + b[k]); layers are the time axis,
    so W/b are per-step ROM pages."""
    g = GraphBuilder()
    x = g.state("x", nodes)
    W = g.const("W", (nodes, nodes), per_step=True)
    b = g.const("b", (1, nodes), per_step=True)
    z = g.macc("z", x, W, b)
    g.update("x", g.af("x_next", z, activation))
    return g.build(output=None)  # Moore: read out only at k = N


def lstm_graph(d_in: int, hidden: int) -> DatapathGraph:
    """The fused-gate LSTM datapath (same math as ``cells.lstm_step``)."""
    H = hidden
    g = GraphBuilder()
    u = g.input("u", d_in)
    h = g.state("h", H)
    c = g.state("c", H)
    xu = g.concat("xu", u, h)
    W = g.const("W", (d_in + H, 4 * H))
    b = g.const("b", (1, 4 * H))
    z = g.macc("z", xu, W, b)
    i_g = g.af("i_gate", g.slice("z_i", z, 0, H), "sigmoid")
    f_g = g.af("f_gate", g.slice("z_f", z, H, 2 * H), "sigmoid")
    g_g = g.af("g_gate", g.slice("z_g", z, 2 * H, 3 * H), "tanh")
    o_g = g.af("o_gate", g.slice("z_o", z, 3 * H, 4 * H), "sigmoid")
    c_new = g.add("c_next", g.mul("fc", f_g, c), g.mul("ig", i_g, g_g))
    h_new = g.mul("h_next", o_g, g.af("c_tanh", c_new, "tanh"))
    g.update("h", h_new)
    g.update("c", c_new)
    return g.build(output=h_new)


def gru_graph(d_in: int, hidden: int) -> DatapathGraph:
    """GRU with the torch-style candidate (reset gate inside the tanh).
    ``h' = n + z·(h − n)`` is the gate-count-minimal form of
    ``(1−z)·n + z·h``."""
    H = hidden
    g = GraphBuilder()
    u = g.input("u", d_in)
    h = g.state("h", H)
    Wx = g.const("w_x", (d_in, 3 * H))
    Wh = g.const("w_h", (H, 3 * H))
    b = g.const("b", (1, 3 * H))
    bhn = g.const("bh_n", (1, H))
    zx = g.macc("zx", u, Wx, b)
    zh = g.macc("zh", h, Wh)
    r = g.af("r_gate", g.add("r_pre", g.slice("zx_r", zx, 0, H),
                             g.slice("zh_r", zh, 0, H)), "sigmoid")
    z = g.af("z_gate", g.add("z_pre", g.slice("zx_z", zx, H, 2 * H),
                             g.slice("zh_z", zh, H, 2 * H)), "sigmoid")
    nh = g.add("n_hid", g.slice("zh_n", zh, 2 * H, 3 * H), bhn)
    n = g.af("n_cand", g.add("n_pre", g.slice("zx_n", zx, 2 * H, 3 * H),
                             g.mul("rn", r, nh)), "tanh")
    h_new = g.add("h_next", n, g.mul("zd", z, g.sub("hn", h, n)))
    g.update("h", h_new)
    return g.build(output=h_new)


def ssm_graph(d_in: int, hidden: int) -> DatapathGraph:
    """Diagonal linear SSM: h' = a ⊙ h + (u W_in + b) — the paper's eq. 4
    with drive."""
    g = GraphBuilder()
    u = g.input("u", d_in)
    h = g.state("h", hidden)
    a = g.const("a", (1, hidden))
    Win = g.const("w_in", (d_in, hidden))
    b = g.const("b", (1, hidden))
    drive = g.macc("drive", u, Win, b)
    h_new = g.add("h_next", g.mul("ah", a, h), drive)
    g.update("h", h_new)
    return g.build(output=h_new)


CELL_GRAPHS: Dict[str, Callable[[int, int], DatapathGraph]] = {
    "lstm": lstm_graph,
    "gru": gru_graph,
    "ssm": ssm_graph,
}


# ---------------------------------------------------------------------------
# Binding trained cell parameters to graph consts (block.py fast path)
# ---------------------------------------------------------------------------

def bind_cell_params(cell: str, params: PyTree) -> dict[str, torch.Tensor]:
    """Map a ``recurrent.cells``-layout parameter dict onto the graph's const
    names (f32, ``v @ W`` orientation)."""
    f32 = lambda t: t.to(torch.float32)
    if cell == "lstm":
        return {
            "W": torch.cat([f32(params["w_x"]), f32(params["w_h"])], dim=0),
            "b": f32(params["b"])[None],
        }
    if cell == "gru":
        return {
            "w_x": f32(params["w_x"]),
            "w_h": f32(params["w_h"]),
            "b": f32(params["b"])[None],
            "bh_n": f32(params["bh_n"])[None],
        }
    if cell == "ssm":
        return {
            "a": f32(params["a"])[None],
            "w_in": f32(params["w_in"]),
            "b": f32(params["b"])[None],
        }
    raise ValueError(f"no const binding for cell '{cell}'")


def ssm_params(gen: torch.Generator, d_in: int, hidden: int,
               dtype=torch.float32) -> PyTree:
    """Stable diagonal-SSM parameters: decays in (0.5, 0.95), drawn on
    ``gen``'s device."""
    dev = gen.device
    a = 0.5 + 0.45 * torch.rand((hidden,), generator=gen, device=dev)
    w = torch.randn((d_in, hidden), generator=gen, device=dev) / np.sqrt(d_in)
    return {"a": a.to(dtype), "w_in": w.to(dtype),
            "b": torch.zeros((hidden,), dtype=dtype, device=dev)}


_CELL_PARAM_CTORS = {
    "lstm": rnn_cells.lstm_params,
    "gru": rnn_cells.gru_params,
    "ssm": ssm_params,
}


def cell_stage_runner(cell: str, d_in: int, hidden: int, *, device=None,
                      **compile_opts):
    """Generated-kernel runner for ONE bare cell datapath (no readout).

    Returns ``(run, graph)`` where ``run(consts, x0, us)`` is the kernel
    backend's stage executor (``consts`` from :func:`bind_cell_params`,
    ``x0`` a dict of ``[B, width]`` state registers from ``graph.states``,
    ``us`` ``[B, T, d_in]``).  The schedule steps come from ``us`` at call
    time; any ``B``/``T`` is accepted.  CUDA tensors run the generated
    kernel, CPU tensors its plain version.  ``compile_opts`` forward to
    :func:`kernel_backend.compile_stage` — notably ``quant_bits<=8`` (int8
    gate MACC) and ``lut`` (ROM-LUT activations).  ``device`` (default: the
    card) is where the runner is meant to run; without a card the default
    raises.
    """
    from . import kernel_backend

    resolve_device(device)
    graph = CELL_GRAPHS[cell](d_in, hidden)
    stage = Stage(name=cell, graph=graph,
                  schedule=Schedule(steps=1), params={})
    return kernel_backend.compile_stage(stage, **compile_opts), graph


# ---------------------------------------------------------------------------
# Spec-level builders (registry entries)
# ---------------------------------------------------------------------------

def _spec_schedule(spec: "NetworkSpec") -> Schedule:
    return (Schedule(steps=spec.serial_steps)
            .with_unroll(spec.unroll)
            .with_c_slow(spec.c_slow))


def _to(tree: dict, dev: torch.device) -> dict:
    return {k: v.to(dev) for k, v in tree.items()}


@register_cell("mlp")
def _build_mlp(spec: "NetworkSpec", dev: torch.device) -> Program:
    from repro_torch.core.synthesis import draw_mlp_params

    p = draw_mlp_params(spec)
    graph = mlp_graph(spec.nodes_per_layer, spec.activation)
    stage = Stage(
        name="hidden",
        graph=graph,
        schedule=_spec_schedule(spec),
        # stored in v @ W orientation: W_std @ x == x @ W_stdᵀ
        params=_to({"W": p["W"].transpose(-1, -2).contiguous(),
                    "b": p["b"][:, None, :]}, dev),
    )
    return Program(spec=spec, stages=[stage], C=p["C"].to(dev),
                   readout_state="x", beta=p["beta"].to(dev))


def _build_recurrent(spec: "NetworkSpec", dev: torch.device) -> Program:
    """Shared lstm/gru/ssm builder: a stack of ``num_hidden_layers`` cell
    stages over the ``seq_len`` time axis, readout C on the final carry —
    the same draws as ``create_top_module``."""
    from repro_torch.core.synthesis import draw_recurrent_params

    p = draw_recurrent_params(spec, _CELL_PARAM_CTORS[spec.cell])
    graph_fn = CELL_GRAPHS[spec.cell]
    stages = []
    for i, cell_p in enumerate(p["cells"]):
        d_in = spec.num_inputs if i == 0 else spec.nodes_per_layer
        stages.append(Stage(
            name=f"layer{i}",
            graph=graph_fn(d_in, spec.nodes_per_layer),
            schedule=_spec_schedule(spec),
            params=_to(bind_cell_params(spec.cell, cell_p), dev),
        ))
    return Program(spec=spec, stages=stages, C=p["C"].to(dev), readout_state="h")


for _cell in ("lstm", "gru", "ssm"):
    register_cell(_cell)(_build_recurrent)


__all__ = [
    "CELL_BUILDERS",
    "CELL_GRAPHS",
    "bind_cell_params",
    "build_program",
    "cell_stage_runner",
    "gru_graph",
    "lstm_graph",
    "mlp_graph",
    "register_cell",
    "registered_cells",
    "ssm_graph",
    "ssm_params",
]
