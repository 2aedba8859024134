"""Scheduled FSM + datapath IR — the generator's intermediate form; the
port's counterpart of ``repro/codegen/ir.py``.

The paper's C# tool goes hyper-parameters → Table-I Verilog modules in one
opaque step.  This IR makes the intermediate explicit: a **datapath graph**
of Table-I ops (macc, af, gate algebra, state-register write-back) plus an
**FSM schedule** (how many serial steps the one shared datapath is
time-multiplexed over, with ``unroll``/``c_slow`` as scheduling transforms).
Every backend — the eager scan executor and the generated CUDA stage kernel
here, the XLA scan, Pallas kernel and Verilog text in the reference —
consumes the same :class:`Program`, so a new cell type registered once runs
on all of them.

Op set (deliberately the paper's Table I, nothing more):

    input   u[k], the per-step sequence input        (Layer1 port)
    state   state-register read                      (the x[k] register file)
    const   weight/bias ROM (``per_step`` marks a stacked-per-step ROM page)
    macc    v @ W (+ b) — the Create_mult MACC array
    af      elementwise activation from core ``ACTIVATIONS`` (Create_AF)
    concat  bus concatenation (fused-gate trick: one MACC serves all gates)
    slice   bus bit-select (split the fused gate bus back apart)
    add/sub/mul  elementwise gate algebra (LUT-free FPGA logic)

Values are all ``[batch, width]`` f32 buses; matrix consts are stored
``[in, out]`` (``v @ W`` orientation), vector consts ``[1, width]``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Mapping

import numpy as np
import torch

PyTree = Any

# op -> (min_arity, max_arity)
_ARITY = {
    "input": (0, 0),
    "state": (0, 0),
    "const": (0, 0),
    "macc": (2, 3),
    "af": (1, 1),
    "concat": (2, None),
    "slice": (1, 1),
    "add": (2, 2),
    "sub": (2, 2),
    "mul": (2, 2),
}


@dataclasses.dataclass(frozen=True)
class Node:
    """One datapath element.  ``width`` is the bus width (last-axis size) of
    the node's value; ``attrs`` carries op-specific parameters (activation
    name, slice bounds, const shape / per_step flag)."""

    name: str
    op: str
    inputs: tuple[str, ...] = ()
    width: int = 0
    attrs: tuple[tuple[str, Any], ...] = ()

    def attr(self, key: str, default=None):
        for k, v in self.attrs:
            if k == key:
                return v
        return default


@dataclasses.dataclass
class DatapathGraph:
    """The combinational datapath between two clock edges: reads the state
    registers and ``u[k]``, produces next-state values and the per-step
    output.  ``updates`` is the register write-back map; ``output`` the
    Mealy output node (None for Moore systems read out only at the end)."""

    nodes: list[Node]
    states: dict[str, int]            # register name -> width
    updates: dict[str, str]           # register name -> node producing next value
    output: str | None = None

    def node(self, name: str) -> Node:
        return self._by_name[name]

    @functools.cached_property
    def _by_name(self) -> dict[str, Node]:
        # nodes are fixed after construction (builders never mutate), so one
        # dict serves every node() lookup
        return {n.name: n for n in self.nodes}

    def validate(self) -> None:
        seen: set[str] = set()
        for n in self.nodes:
            if n.op not in _ARITY:
                raise ValueError(f"unknown op '{n.op}' in node '{n.name}'")
            lo, hi = _ARITY[n.op]
            if len(n.inputs) < lo or (hi is not None and len(n.inputs) > hi):
                raise ValueError(f"node '{n.name}' ({n.op}): bad arity {len(n.inputs)}")
            for i in n.inputs:
                if i not in seen:
                    raise ValueError(f"node '{n.name}' uses '{i}' before definition")
            if n.op == "state" and n.name not in self.states:
                raise ValueError(f"state node '{n.name}' has no register")
            if n.name in seen:
                raise ValueError(f"duplicate node name '{n.name}'")
            seen.add(n.name)
            self._check_widths(n)
        for reg, src in self.updates.items():
            if reg not in self.states:
                raise ValueError(f"update of unknown register '{reg}'")
            if src not in seen:
                raise ValueError(f"register '{reg}' written from unknown node '{src}'")
            if self.node(src).width != self.states[reg]:
                raise ValueError(
                    f"register '{reg}' ({self.states[reg]} lanes) written "
                    f"from '{src}' ({self.node(src).width} lanes)")
        if set(self.updates) != set(self.states):
            raise ValueError("every state register needs exactly one write-back")
        if self.output is not None and self.output not in seen:
            raise ValueError(f"output node '{self.output}' undefined")

    def _check_widths(self, n: Node) -> None:
        """Bus-width agreement — what the per-lane RTL emission and the
        bit-accurate simulators assume.  Elementwise ops are lane-aligned,
        slices in-range, concat the sum of its parts, MACC ports matched to
        the coefficient ROM shape."""
        w_in = [self.node(i).width for i in n.inputs]
        if n.op in ("add", "sub", "mul"):
            if not (n.width == w_in[0] == w_in[1]):
                raise ValueError(
                    f"node '{n.name}' ({n.op}): lane widths differ "
                    f"({n.width} vs {w_in})")
        elif n.op == "af":
            if n.width != w_in[0]:
                raise ValueError(f"af '{n.name}': width {n.width} != input {w_in[0]}")
        elif n.op == "concat":
            if n.width != sum(w_in):
                raise ValueError(f"concat '{n.name}': width {n.width} != {sum(w_in)}")
        elif n.op == "slice":
            a, b = n.attr("start"), n.attr("stop")
            if not (0 <= a < b <= w_in[0] and n.width == b - a):
                raise ValueError(
                    f"slice '{n.name}': [{a}:{b}] out of range for {w_in[0]}")
        elif n.op == "macc":
            w = self.node(n.inputs[1])
            if w.op == "const":
                shape = w.attr("shape")
                if len(shape) == 2 and (shape[0] != w_in[0] or shape[1] != n.width):
                    raise ValueError(
                        f"macc '{n.name}': ROM {shape} mismatches "
                        f"{w_in[0]}->{n.width}")
            if len(n.inputs) == 3 and self.node(n.inputs[2]).width != n.width:
                raise ValueError(f"macc '{n.name}': bias width mismatch")

    # -- structural queries used by the backends / resource report ------------
    def consts(self, per_step: bool | None = None) -> list[Node]:
        out = [n for n in self.nodes if n.op == "const"]
        if per_step is None:
            return out
        return [n for n in out if bool(n.attr("per_step")) == per_step]

    def input_node(self) -> Node | None:
        for n in self.nodes:
            if n.op == "input":
                return n
        return None

    def macc_nodes(self) -> list[Node]:
        return [n for n in self.nodes if n.op == "macc"]

    def macc_flops_per_step(self) -> int:
        """2·in·out per MACC node — the datapath's multiply-accumulate work
        per FSM step (one batch row)."""
        total = 0
        for n in self.macc_nodes():
            in_w = self.node(n.inputs[0]).width
            total += 2 * in_w * n.width
        return total

    def rom_elements(self, steps: int = 1) -> int:
        """Total coefficient-ROM entries; per-step consts count every one of
        the ``steps`` ROM pages."""
        total = 0
        for n in self.consts():
            count = 1
            for d in n.attr("shape"):
                count *= d
            total += count * (steps if n.attr("per_step") else 1)
        return total

    def af_nodes(self) -> list[Node]:
        return [n for n in self.nodes if n.op == "af"]

    def quantizable_weights(self) -> list[str]:
        """Const names eligible for the fixed-point MACC path (paper §IV-B):
        every 2-D coefficient ROM whose ONLY uses are macc weight ports.
        Biases (3rd macc input) and elementwise consts stay full-precision;
        a const with any non-weight-port use is excluded entirely — its
        quantized codes would reach the other consumer undequantized."""
        weight_uses: set[str] = set()
        for n in self.macc_nodes():
            w = self.node(n.inputs[1])
            if w.op == "const" and len(w.attr("shape")) == 2:
                weight_uses.add(w.name)
        other_uses = {
            i for n in self.nodes for j, i in enumerate(n.inputs)
            if not (n.op == "macc" and j == 1)
        }
        return [n.name for n in self.consts()
                if n.name in weight_uses and n.name not in other_uses]


@dataclasses.dataclass(frozen=True)
class Schedule:
    """The FSM: how many serial steps the datapath is multiplexed over, and
    the paper's two scheduling transforms — ``unroll`` (j datapath copies
    per stage, paper §II-C) and ``c_slow`` (C interleaved streams through
    one datapath, paper §III-F)."""

    steps: int
    unroll: int = 1
    c_slow: int = 1

    def with_unroll(self, j: int) -> "Schedule":
        if j < 1:
            raise ValueError(f"unroll must be >= 1, got {j}")
        return dataclasses.replace(self, unroll=j)

    def with_c_slow(self, c: int) -> "Schedule":
        if c < 1:
            raise ValueError(f"c_slow must be >= 1, got {c}")
        return dataclasses.replace(self, c_slow=c)

    @property
    def cycles(self) -> int:
        """Total FSM cycles per inference: C·N (each of the C interleaved
        streams advances every C-th cycle)."""
        return self.steps * self.c_slow


@dataclasses.dataclass
class Stage:
    """One scheduled datapath: a graph run for ``schedule.steps`` serial
    steps.  ``params`` binds const-node names to tensors; per-step consts
    carry a leading ``steps`` axis (the stacked ROM pages)."""

    name: str
    graph: DatapathGraph
    schedule: Schedule
    params: dict[str, torch.Tensor]

    def validate(self) -> None:
        """Structural checks: the graph, every const bound with its shape
        (per-step consts with a leading ``steps`` axis), and the static
        AF-domain check of ``repro_torch.analyze.ranges`` (an AF node whose
        input interval lies entirely outside the ROM's domain)."""
        self.graph.validate()
        for n in self.graph.consts():
            if n.name not in self.params:
                raise ValueError(f"stage '{self.name}': const '{n.name}' unbound")
            got = tuple(self.params[n.name].shape)
            want = tuple(n.attr("shape"))
            if n.attr("per_step"):
                want = (self.schedule.steps,) + want
            if got != want:
                raise ValueError(
                    f"stage '{self.name}': const '{n.name}' shape {got} != {want}"
                )
        if self.graph.af_nodes():
            # static AF-domain check (repro_torch.analyze interval
            # primitives): an AF node whose input interval lies ENTIRELY
            # outside the 64-entry ROM's addressable domain [-2^(W-2),
            # 2^(W-2)) can only ever read a clamped edge entry — a wiring
            # bug, not a quantization choice
            from repro_torch.analyze.ranges import af_domain_violations

            bad = af_domain_violations(self, width=None, max_iters=8)
            if bad:
                raise ValueError(
                    f"stage '{self.name}': AF node(s) {sorted(bad)} have "
                    f"input bounds entirely outside the ROM domain — every "
                    f"lookup would clamp to an edge entry")


@dataclasses.dataclass
class Program:
    """spec → stages → readout.  ``beta`` (optional) is the input-injection
    matrix (x0 = u @ betaᵀ — the βuδ[k] term of the MLP form); ``C`` the
    readout applied to ``readout_state`` of the last stage's final carry."""

    spec: Any                       # NetworkSpec (kept duck-typed: no cycle)
    stages: list[Stage]
    C: torch.Tensor
    readout_state: str
    beta: torch.Tensor | None = None

    def validate(self) -> None:
        if not self.stages:
            raise ValueError("program has no stages")
        if self.beta is not None and len(self.stages) != 1:
            # every backend realizes the βuδ[k] injection as the single
            # stage's loaded state — a multi-stage beta program has no
            # defined cascade semantics, so reject it loudly here
            raise ValueError(
                f"beta-injection programs must have exactly 1 stage, "
                f"got {len(self.stages)}")
        for st in self.stages:
            st.validate()
        if self.readout_state not in self.stages[-1].graph.states:
            raise ValueError(f"readout state '{self.readout_state}' missing")

    @property
    def params(self) -> PyTree:
        p: dict[str, Any] = {"stages": [st.params for st in self.stages], "C": self.C}
        if self.beta is not None:
            p["beta"] = self.beta
        return p

    def num_params(self) -> int:
        leaves = [v for st in self.stages for v in st.params.values()] + [self.C]
        if self.beta is not None:
            leaves.append(self.beta)
        return sum(int(np.prod(tuple(leaf.shape))) for leaf in leaves)


# ---------------------------------------------------------------------------
# Graph construction + the one shared evaluator
# ---------------------------------------------------------------------------

class GraphBuilder:
    """Fluent construction with width inference; ``build()`` validates."""

    def __init__(self) -> None:
        self._nodes: list[Node] = []
        self._states: dict[str, int] = {}
        self._updates: dict[str, str] = {}

    def _add(self, node: Node) -> str:
        self._nodes.append(node)
        return node.name

    def _width(self, name: str) -> int:
        for n in self._nodes:
            if n.name == name:
                return n.width
        raise KeyError(name)

    def input(self, name: str, width: int) -> str:
        return self._add(Node(name, "input", (), width))

    def state(self, name: str, width: int) -> str:
        self._states[name] = width
        return self._add(Node(name, "state", (), width))

    def const(self, name: str, shape: tuple[int, ...], per_step: bool = False) -> str:
        return self._add(Node(name, "const", (), shape[-1],
                              (("shape", tuple(shape)), ("per_step", per_step))))

    def macc(self, name: str, x: str, w: str, b: str | None = None) -> str:
        ins = (x, w) if b is None else (x, w, b)
        return self._add(Node(name, "macc", ins, self._width(w)))

    def af(self, name: str, x: str, fn: str) -> str:
        return self._add(Node(name, "af", (x,), self._width(x), (("fn", fn),)))

    def concat(self, name: str, *xs: str) -> str:
        return self._add(Node(name, "concat", xs, sum(self._width(x) for x in xs)))

    def slice(self, name: str, x: str, start: int, stop: int) -> str:
        return self._add(Node(name, "slice", (x,), stop - start,
                              (("start", start), ("stop", stop))))

    def add(self, name: str, a: str, b: str) -> str:
        return self._add(Node(name, "add", (a, b), self._width(a)))

    def sub(self, name: str, a: str, b: str) -> str:
        return self._add(Node(name, "sub", (a, b), self._width(a)))

    def mul(self, name: str, a: str, b: str) -> str:
        return self._add(Node(name, "mul", (a, b), self._width(a)))

    def update(self, state: str, src: str) -> None:
        self._updates[state] = src

    def build(self, output: str | None = None) -> DatapathGraph:
        g = DatapathGraph(list(self._nodes), dict(self._states),
                          dict(self._updates), output)
        g.validate()
        return g


def eval_graph(
    graph: DatapathGraph,
    *,
    consts: Callable[[str], torch.Tensor],
    states: Mapping[str, torch.Tensor],
    u: torch.Tensor | None,
    act: Callable[[str], Callable[[torch.Tensor], torch.Tensor]],
    mm: Callable[[torch.Tensor, str, torch.Tensor], torch.Tensor] | None = None,
):
    """Evaluate one datapath step on tensors — the eager backend's scan body.
    (The generated CUDA kernel evaluates the same graph lane by lane through
    ``codegen.lower``; the tests hold the two against each other.)

    Args:
      consts: name -> tensor, already step-sliced for per-step ROMs.
      states: register name -> current value ``[..., width]``.
      u: the per-step input bus, or None for autonomous graphs.
      act: activation-name -> callable resolver (the LUT hook).
      mm: optional MACC override ``(x, w_name, w) -> x·w`` — the fixed-point
        datapath hook (int8 weights + per-channel scales; default is the f32
        contraction).

    Returns (new_states dict, output value or None).
    """
    if mm is None:
        mm = lambda x, _name, w: x @ w
    env: dict[str, torch.Tensor] = {}
    for n in graph.nodes:
        if n.op == "input":
            if u is None:
                raise ValueError(f"graph has input '{n.name}' but no input given")
            env[n.name] = u
        elif n.op == "state":
            env[n.name] = states[n.name]
        elif n.op == "const":
            env[n.name] = consts(n.name)
        elif n.op == "macc":
            v = mm(env[n.inputs[0]], n.inputs[1], env[n.inputs[1]])
            if len(n.inputs) == 3:
                v = v + env[n.inputs[2]]
            env[n.name] = v
        elif n.op == "af":
            env[n.name] = act(n.attr("fn"))(env[n.inputs[0]])
        elif n.op == "concat":
            env[n.name] = torch.cat([env[i] for i in n.inputs], dim=-1)
        elif n.op == "slice":
            env[n.name] = env[n.inputs[0]][..., n.attr("start"): n.attr("stop")]
        elif n.op == "add":
            env[n.name] = env[n.inputs[0]] + env[n.inputs[1]]
        elif n.op == "sub":
            env[n.name] = env[n.inputs[0]] - env[n.inputs[1]]
        elif n.op == "mul":
            env[n.name] = env[n.inputs[0]] * env[n.inputs[1]]
        else:  # pragma: no cover - validate() rejects earlier
            raise ValueError(f"unknown op {n.op}")
    new_states = {s: env[src] for s, src in graph.updates.items()}
    out = env[graph.output] if graph.output is not None else None
    return new_states, out
