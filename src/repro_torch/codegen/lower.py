"""Lowering of a datapath graph to the plan of a generated CUDA stage kernel,
and the plan's interpreter on tensors (the kernel's plain version).

The TPU kernel (``repro/codegen/pallas_backend.py::compile_stage``) held a
whole stage in one grid cell: state registers in VMEM, the graph evaluated on
whole ``[B, width]`` tiles.  On the card one step is spread over the grid
instead, and the plan says how:

* every **macc** node is materialised once per step into a ``[B, width]``
  scratch buffer, by its own launch, in topological order;
* every other node (``input``, ``state``, ``const``, ``af``, ``concat``,
  ``slice``, ``add``, ``sub``, ``mul``) is a **lane function** of
  ``(b, lane)``: ``slice`` offsets the lane, ``concat`` branches on lane
  ranges, elementwise ops combine their inputs at the same lane, and a
  ``macc`` node read as an input is a load from its buffer.

So a macc's input row, its bias, every register write-back and the output
are pure lane functions, with no exchange between threads, for any Table-I
graph, including a macc that reads another macc through gate algebra.  A
register update reads the step's old registers and writes new ones
(ping-pong buffers), so no lane ever sees a half-updated register.

:func:`interpret` evaluates a plan on tensors with the same lane arithmetic
(index tensors in place of a thread's lane), the same MACC forms and the
same activations as the emitted kernel.  ``kernel_backend`` runs it for CPU
tensors, so the lowering (lane maps, slices, concats, int8 pages, LUT) is
tested without a card; ``eager_backend`` is an independent oracle for both.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping

import torch
import torch.nn.functional as F

from repro_torch.kernels._lut import lut_interpolate, shifted_table

from .ir import DatapathGraph, Node

# the activations a lane function may apply (``ir`` af nodes); tanh and σ
# follow the TPU kernel: σ(v) = 0.5·(1 + tanh(v/2)) with or without a LUT
LANE_ACTIVATIONS = ("tanh", "sigmoid", "relu", "gelu", "silu", "identity")

# the emitted MACC stages a tile of batch rows of its input row in shared
# memory; this caps rows × contraction width (floats) per block
MACC_MAX_ROWS = 8
MACC_SMEM_FLOATS = 50 * 1024


@dataclasses.dataclass(frozen=True)
class Macc:
    """One materialised MACC: ``buf[b, :] = x(b, :) @ W (+ bias(b, :))``.

    ``int8`` is None (fp32 ROM), ``"shared"`` (int8 codes dequantised as
    they are read: ``x @ (w_q·s)``, as the TPU kernel's hoisted dequant) or
    ``"per_step"`` (``(x @ w_q)·s`` after the dot, as its streamed pages)."""

    name: str
    x: str
    w: str
    bias: str | None
    k: int
    n: int
    per_step: bool
    int8: str | None
    rows: int          # batch rows per block of the emitted kernel


@dataclasses.dataclass(frozen=True)
class Plan:
    """What the emitter and the interpreter need of one stage.

    ``consts`` are every const node in graph order; ``int8`` names the
    weight ROMs packed as int8 codes with a ``<name>.scale`` companion."""

    graph: DatapathGraph
    states: tuple[tuple[str, int], ...]     # sorted register names, widths
    input: tuple[str, int] | None
    consts: tuple[Node, ...]
    int8: tuple[str, ...]
    maccs: tuple[Macc, ...]
    updates: tuple[tuple[str, str], ...]    # (register, node), states order
    output: str | None
    out_width: int
    lut: bool

    def node(self, name: str) -> Node:
        return self.graph.node(name)


def lower(graph: DatapathGraph, *, lut: bool = False,
          int8_weights: tuple[str, ...] = ()) -> Plan:
    """Classify the graph's nodes for the generated kernel.

    ``int8_weights``: the weight ROMs to run on the int8 path (a subset of
    ``graph.quantizable_weights()``).  Raises on a graph the kernel cannot
    run: a macc whose weight port is not a 2-D const ROM, a matrix const
    read elementwise, an unknown activation, or a contraction too wide for
    one batch row in shared memory."""
    graph.validate()
    bad = set(int8_weights) - set(graph.quantizable_weights())
    if bad:
        raise ValueError(f"not quantizable weight ROMs: {sorted(bad)}")
    maccs = []
    for n in graph.macc_nodes():
        w = graph.node(n.inputs[1])
        if w.op != "const" or len(w.attr("shape")) != 2:
            raise NotImplementedError(
                f"macc '{n.name}': the generated kernel needs a 2-D const ROM on "
                f"the weight port, got '{w.name}' ({w.op})")
        k, width = w.attr("shape")
        rows = min(MACC_MAX_ROWS, MACC_SMEM_FLOATS // k)
        if rows < 1:
            raise NotImplementedError(
                f"macc '{n.name}': contraction width {k} exceeds one batch row of "
                f"shared memory ({MACC_SMEM_FLOATS} floats)")
        q = None
        if w.name in int8_weights:
            q = "per_step" if w.attr("per_step") else "shared"
        maccs.append(Macc(n.name, n.inputs[0], w.name,
                          n.inputs[2] if len(n.inputs) == 3 else None,
                          k, width, bool(w.attr("per_step")), q, rows))
    for n in graph.nodes:
        if n.op == "af" and n.attr("fn") not in LANE_ACTIVATIONS:
            raise NotImplementedError(f"af '{n.name}': activation {n.attr('fn')!r}")
        for j, i in enumerate(n.inputs):
            src = graph.node(i)
            lane_read = not (n.op == "macc" and j == 1)
            if lane_read and src.op == "const" and src.attr("shape")[0] != 1:
                raise NotImplementedError(
                    f"node '{n.name}' reads the matrix const '{i}' elementwise")
    inp = graph.input_node()
    out_w = graph.node(graph.output).width if graph.output is not None else 0
    states = tuple(sorted(graph.states.items()))
    return Plan(
        graph=graph,
        states=states,
        input=None if inp is None else (inp.name, inp.width),
        consts=tuple(graph.consts()),
        int8=tuple(n.name for n in graph.consts() if n.name in int8_weights),
        maccs=tuple(maccs),
        updates=tuple((s, graph.updates[s]) for s, _ in states),
        output=graph.output,
        out_width=out_w,
        lut=lut,
    )


# ---------------------------------------------------------------------------
# the plan's interpreter (the generated kernel's plain version)
# ---------------------------------------------------------------------------

def activation_table(lut: torch.Tensor | None) -> dict[str, Callable]:
    """The generated kernel's activations: tanh from the table when one is
    loaded, σ(v) = 0.5·(1 + tanh(v/2)) always (as the TPU kernel), gelu the
    tanh approximation, silu the logistic form."""
    if lut is not None:
        lut = lut.to(torch.float32)
        lut1 = shifted_table(lut)
        tanh = lambda v: lut_interpolate(v, lut, lut1, lut.shape[0])
    else:
        tanh = torch.tanh
    return {
        "tanh": tanh,
        "sigmoid": lambda v: 0.5 * (1.0 + tanh(0.5 * v)),
        "relu": torch.relu,
        "gelu": lambda v: F.gelu(v, approximate="tanh"),
        "silu": F.silu,
        "identity": lambda v: v,
    }


def interpret(plan: Plan, consts: Mapping[str, torch.Tensor],
              x0: Mapping[str, torch.Tensor], us: torch.Tensor | None,
              T: int, lut: torch.Tensor | None = None):
    """Run the plan for ``T`` steps on tensors, lane function by lane
    function.  ``consts`` hold fp32 ROMs, and int8 codes plus ``.scale``
    companions for ``plan.int8``; ``x0`` is ``{register: [B, width]}``;
    ``us`` is ``[B, T, D]`` or None.  Returns ``(finals, ys)`` as the
    kernel does (``ys`` ``[B, T, out_width]`` or None)."""
    if plan.lut != (lut is not None):
        raise ValueError("the plan was lowered "
                         f"{'with' if plan.lut else 'without'} a LUT")
    states = {s: x0[s].to(torch.float32) for s, _ in plan.states}
    B = next(iter(states.values())).shape[0]
    dev = next(iter(states.values())).device
    act = activation_table(None if lut is None else lut.to(dev))
    # shared ROMs: fp32, or int8 codes dequantised once before the step loop
    # (the TPU kernel's hoist); per-step pages are read at their step
    shared = {}
    for m in plan.maccs:
        if not m.per_step:
            w = consts[m.w].to(torch.float32)
            shared[m.w] = w * consts[f"{m.w}.scale"] if m.int8 else w
    ys = []
    for t in range(T):
        bufs: dict[str, torch.Tensor] = {}

        def lane(name: str, lanes: torch.Tensor) -> torch.Tensor:
            n = plan.node(name)
            if n.op == "input":
                return us[:, t, :].to(torch.float32)[:, lanes]
            if n.op == "state":
                return states[name][:, lanes]
            if n.op == "macc":
                return bufs[name][:, lanes]
            if n.op == "const":
                c = consts[name].to(torch.float32)
                row = c[t, 0] if n.attr("per_step") else c[0]
                return row[lanes].expand(B, lanes.shape[0])
            if n.op == "af":
                return act[n.attr("fn")](lane(n.inputs[0], lanes))
            if n.op == "slice":
                return lane(n.inputs[0], lanes + n.attr("start"))
            if n.op == "concat":
                out = torch.empty((B, lanes.shape[0]), dtype=torch.float32, device=dev)
                off = 0
                for part in n.inputs:
                    w = plan.node(part).width
                    sel = (lanes >= off) & (lanes < off + w)
                    if bool(sel.any()):
                        out[:, sel] = lane(part, lanes[sel] - off)
                    off += w
                return out
            a, b = lane(n.inputs[0], lanes), lane(n.inputs[1], lanes)
            if n.op == "add":
                return a + b
            if n.op == "sub":
                return a - b
            if n.op == "mul":
                return a * b
            raise ValueError(f"unknown op {n.op}")  # pragma: no cover

        for m in plan.maccs:
            x = lane(m.x, torch.arange(m.k, device=dev))
            if not m.per_step:
                v = x @ shared[m.w]
            elif m.int8:
                v = (x @ consts[m.w][t].to(torch.float32)) * consts[f"{m.w}.scale"][t]
            else:
                v = x @ consts[m.w][t].to(torch.float32)
            if m.bias is not None:
                v = v + lane(m.bias, torch.arange(m.n, device=dev))
            bufs[m.name] = v
        new = {s: lane(src, torch.arange(dict(plan.states)[s], device=dev))
               for s, src in plan.updates}
        if plan.output is not None:
            ys.append(lane(plan.output, torch.arange(plan.out_width, device=dev)))
        states = new
    return states, (torch.stack(ys, dim=1) if plan.output is not None else None)


__all__ = ["LANE_ACTIVATIONS", "Macc", "Plan", "activation_table", "interpret", "lower"]
