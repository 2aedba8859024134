"""Schedule/structure hazard analysis over the scheduled IR; the port's
counterpart of ``repro/analyze/hazards.py``.

``DatapathGraph.validate()`` rejects malformed graphs loudly, but hazards
are a different class: structurally legal programs whose *FSM semantics*
are broken or wasteful.  The kinds, in hardware terms:

* ``state-unwritten`` (error) — a register that is read but never written:
  the RTL reads reset/X forever.  This IS the read-before-write hazard: in
  the emitted FSM every state read happens before the step's write-back
  edge, so the only way a read can see stale data is a missing write.
* ``writeback-alias`` (warning) — two registers written from the same node
  (the write-after-write shape: both registers always carry identical
  words, one of them is redundant datapath).
* ``writeback-overlap`` (warning) — registers written from *overlapping
  slices* of one bus: aliased lanes across registers.
* ``state-unread`` (warning) — a register written but never read and not
  the readout carry: dead registers burn write-back muxes.
* ``dead-node`` (warning) — a node no write-back, output, or readout can
  reach: dead datapath (the Verilog emitter would still burn its LUTs).
* ``cascade-break`` (error) — a multi-stage program whose stage *i* has no
  Mealy output or whose stage *i+1* input width disagrees: the start-pulse
  cascade in ``create_top_module`` would wire a mismatched bus.
* ``schedule-mismatch`` (error) — stages disagreeing on
  unroll/c_slow/steps: every backend (and ``fsm_cycle_estimate``) assumes
  ``stages[0]``'s schedule governs the whole FSM.
* ``unreachable-stage`` (error) — ``schedule.steps < 1``: the FSM never
  enters the stage's ITER state.
* ``unroll-excess`` (warning) — more datapath copies than MACC input
  lanes: the extra copies are permanently gated pad lanes.

All checks work on hand-built graphs that bypass ``validate()`` (the test
fixtures construct broken programs directly).
"""

from __future__ import annotations

from repro_torch.codegen.ir import DatapathGraph, Program

from .report import Finding

HAZARD_KINDS = ("state-unwritten", "writeback-alias", "writeback-overlap",
                "state-unread", "dead-node", "cascade-break",
                "schedule-mismatch", "unreachable-stage", "unroll-excess")


def _reachable(graph: DatapathGraph, roots: set[str]) -> set[str]:
    by_name = {n.name: n for n in graph.nodes}
    seen: set[str] = set()
    work = [r for r in roots if r in by_name]
    while work:
        name = work.pop()
        if name in seen:
            continue
        seen.add(name)
        work.extend(by_name[name].inputs)
    return seen


def _graph_hazards(stage_name: str, graph: DatapathGraph,
                   readout_state: str | None) -> list[Finding]:
    out: list[Finding] = []
    by_name = {n.name: n for n in graph.nodes}

    # a register is READ when its state node feeds another node (or is the
    # Mealy output) — the node existing is not a read
    state_names = {n.name for n in graph.nodes if n.op == "state"}
    read_states = {src for n in graph.nodes for src in n.inputs
                   if src in state_names}
    if graph.output in state_names:
        read_states.add(graph.output)
    for reg in graph.states:
        if reg not in graph.updates:
            out.append(Finding(
                kind="state-unwritten", severity="error", stage=stage_name,
                node=reg, detail="register is read but has no write-back — "
                "the RTL reads reset/X on every step"))
        if reg not in read_states and reg != readout_state:
            out.append(Finding(
                kind="state-unread", severity="warning", stage=stage_name,
                node=reg, detail="register is written but never read and is "
                "not the readout carry"))

    # write-after-write shapes: same source node, or overlapping slices
    by_src: dict[str, list[str]] = {}
    for reg, src in graph.updates.items():
        by_src.setdefault(src, []).append(reg)
    for src, regs in sorted(by_src.items()):
        if len(regs) > 1:
            out.append(Finding(
                kind="writeback-alias", severity="warning", stage=stage_name,
                node=src, detail=f"registers {sorted(regs)} are all written "
                f"from '{src}' — identical words every step"))
    slices = []
    for reg, src in sorted(graph.updates.items()):
        n = by_name.get(src)
        if n is not None and n.op == "slice":
            slices.append((reg, n.inputs[0], n.attr("start"), n.attr("stop")))
    for i in range(len(slices)):
        for j in range(i + 1, len(slices)):
            ri, pi, ai, bi = slices[i]
            rj, pj, aj, bj = slices[j]
            if pi == pj and ai < bj and aj < bi:
                out.append(Finding(
                    kind="writeback-overlap", severity="warning",
                    stage=stage_name, node=pi,
                    detail=f"registers '{ri}' and '{rj}' write back "
                    f"overlapping lanes [{max(ai, aj)}:{min(bi, bj)}] of "
                    f"'{pi}'"))

    roots = set(graph.updates.values())
    if graph.output is not None:
        roots.add(graph.output)
    if readout_state is not None and readout_state in by_name:
        roots.add(readout_state)
    live = _reachable(graph, roots)
    for n in graph.nodes:
        if n.name not in live:
            out.append(Finding(
                kind="dead-node", severity="warning", stage=stage_name,
                node=n.name, detail=f"{n.op} node is unreachable from every "
                "write-back/output/readout — dead datapath"))
    return out


def analyze_hazards(program: Program) -> list[Finding]:
    out: list[Finding] = []
    stages = program.stages
    s0 = stages[0].schedule
    for si, st in enumerate(stages):
        readout = (program.readout_state if si == len(stages) - 1 else None)
        out.extend(_graph_hazards(st.name, st.graph, readout))

        sched = st.schedule
        if sched.steps < 1:
            out.append(Finding(
                kind="unreachable-stage", severity="error", stage=st.name,
                node="<schedule>", detail=f"steps={sched.steps}: the FSM "
                "never enters this stage's ITER state"))
        if (sched.unroll, sched.c_slow, sched.steps) != \
                (s0.unroll, s0.c_slow, s0.steps):
            out.append(Finding(
                kind="schedule-mismatch", severity="error", stage=st.name,
                node="<schedule>",
                detail=f"(unroll={sched.unroll}, c_slow={sched.c_slow}, "
                f"steps={sched.steps}) differs from stage 0 "
                f"(unroll={s0.unroll}, c_slow={s0.c_slow}, "
                f"steps={s0.steps}); backends assume stages[0] governs"))

        maccs = st.graph.macc_nodes()
        if maccs:
            widest = max(st.graph.node(n.inputs[0]).width for n in maccs)
            if sched.unroll > widest:
                out.append(Finding(
                    kind="unroll-excess", severity="warning", stage=st.name,
                    node="<schedule>",
                    detail=f"unroll={sched.unroll} exceeds the widest MACC "
                    f"input bus ({widest} lanes): "
                    f"{sched.unroll - widest} copies are pad-gated off"))

        if si > 0:
            prev = stages[si - 1]
            in_node = st.graph.input_node()
            if prev.graph.output is None:
                out.append(Finding(
                    kind="cascade-break", severity="error", stage=st.name,
                    node="<cascade>",
                    detail=f"stage '{prev.name}' has no Mealy output to "
                    "drive this stage's input bus"))
            elif in_node is None:
                out.append(Finding(
                    kind="cascade-break", severity="error", stage=st.name,
                    node="<cascade>",
                    detail="stage has no input node to receive the cascade "
                    "bus"))
            elif prev.graph.node(prev.graph.output).width != in_node.width:
                out.append(Finding(
                    kind="cascade-break", severity="error", stage=st.name,
                    node=in_node.name,
                    detail=f"cascade width mismatch: '{prev.name}' drives "
                    f"{prev.graph.node(prev.graph.output).width} lanes, "
                    f"input expects {in_node.width}"))
    return out


__all__ = ["HAZARD_KINDS", "analyze_hazards"]
