"""The structural FSM cycle model of the emitted Table-I controller; the port
keeps only this part of ``repro/codegen/rtlsim.py`` so far.

:func:`fsm_cycle_estimate` is the cheap, predicted side of the
predicted-vs-measured ledger (``obs.ledger``): the clocks the paper's
``Create_TopModule`` controller spends on one evaluation, traced from the
FSM's happy path, from the schedule and the graph shapes alone.  It returns
the same integers as the reference.  The bit-accurate simulator
(``simulate``) and the Verilog emitter it is checked against come with the
fixed-point bit path (ROADMAP, Queue 1).
"""

from __future__ import annotations

import math

from .ir import DatapathGraph, Program

# Activations realizable as combinational logic instead of a ROM
# (``repro/codegen/verilog.py::_COMB_AF``).
_COMB_AF = {"identity", "relu"}


def _af_depth(graph: DatapathGraph) -> int:
    """Longest chain of REGISTERED AF ROMs on any path through the datapath
    — each adds one clock of latency between MACC done and settled outputs
    (LSTM: gate ROM → c_tanh ROM = 2; SSM: 0).  The reference's
    ``verilog.py::_af_depth``."""
    depth: dict[str, int] = {}
    for n in graph.nodes:
        d = max((depth.get(i, 0) for i in n.inputs), default=0)
        if n.op == "af" and n.attr("fn") not in _COMB_AF:
            d += 1
        depth[n.name] = d
    return max(depth.values(), default=0)


def _stage_serial(graph: DatapathGraph, unroll: int) -> int:
    """Serial MACC clocks of one datapath kick: its layer arrays run in
    parallel off the same start, so the slowest (ceil(in/J)) gates done."""
    return max((math.ceil(graph.node(n.inputs[0]).width / unroll)
                for n in graph.macc_nodes()), default=0)


def _fsm_cycles_per_stream(program: Program, unroll: int, T: int,
                           is_mlp: bool) -> int:
    """Clocks the emitted Create_TopModule controller spends on one stream:

    * IDLE→LOAD transition: 1.
    * LOAD: ``beta`` MACC start latch + its serial count + the qualified
      transition clock (mlp); 2 clocks when ``load_done`` is wired high
      (recurrent cells).
    * each ITER step: kick + start latch + serial_0, then each cascaded
      stage's start pipe (prev AF depth + 1) + latch + serial_i, then the
      last stage's done edge + SETTLE (= AF depth + 2) + advance.
    * READOUT + DONE: readout start latch + serial + transition + done flag.
    """
    graphs = [st.graph for st in program.stages]
    serials = [_stage_serial(g, unroll) for g in graphs]
    depths = [_af_depth(g) for g in graphs]
    step = 1 + serials[0]
    for i in range(1, len(graphs)):
        step += depths[i - 1] + 2 + serials[i]
    step += depths[-1] + 3
    load = (program.beta.shape[1] + 2) if is_mlp else 2
    ro_serial = graphs[-1].states[program.readout_state]
    return 1 + load + T * step + ro_serial + 3


def fsm_cycle_estimate(program: Program, T: int | None = None) -> int:
    """Predicted controller clocks for ONE full evaluation of ``program``
    (all C streams), for an input of ``T`` serial steps per stream (default:
    the schedule's step count).  Width-independent: the FSM trace depends
    only on the schedule and graph shapes, never on word length."""
    sched = program.stages[0].schedule
    is_mlp = program.beta is not None
    steps = sched.steps if T is None else T
    return sched.c_slow * _fsm_cycles_per_stream(
        program, sched.unroll, steps, is_mlp)


__all__ = ["fsm_cycle_estimate"]
