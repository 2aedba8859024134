"""Eager backend: IR → ``StateSpaceModel`` → a loop over the steps; the port's
counterpart of ``repro/codegen/xla_backend.py`` (its ``"xla"`` backend).

The datapath graph becomes the step body (one datapath, time-multiplexed by
the carry — the paper's §IV-A architecture); per-step const ROMs ride as
``run_scan``'s stacked params, and the two scheduling transforms lower as in
the core: ``unroll`` is carried (and changes nothing in eager execution),
``c_slow`` → C interleaved streams through :func:`cslow_vectorized`.

This executor is the port's oracle for the generated CUDA stage kernel: it
evaluates the graph with ``ir.eval_graph`` on whole tensors and shares no
code with ``codegen.lower``.  The reference's mesh constraints
(``_mesh_constraints``) are not ported: ``mesh=`` raises.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.core.cslow import cslow_vectorized
from repro_torch.core.state_space import StateSpaceModel, resolve_activation, run_scan
from repro_torch.device import resolve_device

from .ir import DatapathGraph, Program, Stage, eval_graph

PyTree = Any

MESH_NOT_PORTED = ("mesh= is not ported yet: the sharded program comes with "
                   "torch.distributed (ROADMAP.md, Queue 1: Multi-device and launchers)")


def graph_model(graph: DatapathGraph, shared: dict[str, torch.Tensor]) -> StateSpaceModel:
    """Wrap a datapath graph as a ``StateSpaceModel``: the state dict is the
    carry, per-step consts arrive as ``params_k``.  Moore when the graph has
    no input (MLP readout happens after the last step)."""

    def consts_of(params_k):
        def get(name):
            if params_k is not None and name in params_k:
                return params_k[name].to(torch.float32)
            return shared[name]
        return get

    def f(params_k, x, u, k):
        del k
        new_states, _ = eval_graph(graph, consts=consts_of(params_k), states=x,
                                   u=u, act=resolve_activation)
        return new_states

    def g(params_k, x, u, k):
        del k
        new_states, out = eval_graph(graph, consts=consts_of(params_k), states=x,
                                     u=u, act=resolve_activation)
        return out if graph.output is not None else new_states

    mode = "mealy" if graph.input_node() is not None else "moore"
    return StateSpaceModel(f=f, g=g, output_mode=mode)


def compile_stage(stage: Stage) -> Callable:
    """Returns ``run(consts, x0, us) -> (final_states, ys)``.

    ``x0`` leaves are ``[lead..., width]``, ``us`` is ``[lead..., T, D]`` (or
    None for autonomous graphs).  With ``c_slow = C > 1`` the first leading
    axis is the C interleaved streams, executed through
    :func:`cslow_vectorized` (one datapath, C state registers).
    """
    graph, sched = stage.graph, stage.schedule
    per_step = [n.name for n in graph.consts(per_step=True)]
    shared_names = [n.name for n in graph.consts(per_step=False)]

    def run(consts: dict, x0: dict, us):
        shared = {k: consts[k].to(torch.float32) for k in shared_names}
        stacked = {k: consts[k] for k in per_step} or None
        model = graph_model(graph, shared)
        if sched.c_slow > 1:
            # [C, lead..., T, D] -> per-stream time-major [C, T, lead..., D]
            us_streams = None if us is None else us.movedim(-2, 1)
            finals, ys = cslow_vectorized(model, stacked, x0, us_streams,
                                          unroll=sched.unroll)
            if graph.output is None:
                return finals, None
            return finals, ys.movedim(1, -2)
        us_tm = None if us is None else us.movedim(-2, 0)
        finals, ys = run_scan(model, stacked, x0, us_tm, length=sched.steps,
                              unroll=sched.unroll)
        if graph.output is None:
            return finals, None
        return finals, ys.movedim(0, -2)

    return run


def compile_program(program: Program, mesh=None, device=None) -> Callable:
    """IR → batched forward: ``forward(params, u) -> y``.

    Shapes (B = batch; with ``c_slow = C > 1`` prepend a stream axis C):
      mlp        u [B, L]     -> y [B, P]
      recurrent  u [B, T, D]  -> y [B, P]   (readout of the final carry)

    ``device`` (default: the card) is where the forward is meant to run;
    it computes on the device of the tensors it is given.
    """
    if mesh is not None:
        raise NotImplementedError(MESH_NOT_PORTED)
    resolve_device(device)
    program.validate()
    runners = [compile_stage(st) for st in program.stages]
    is_mlp = program.beta is not None
    readout = program.readout_state

    def forward(params: PyTree, u: torch.Tensor) -> torch.Tensor:
        C = params["C"].to(torch.float32)
        sp = params["stages"]
        u = u.to(torch.float32)
        if is_mlp:
            x0 = {"x": u @ params["beta"].to(torch.float32).T}
            finals, _ = runners[0](sp[0], x0, None)
            return finals["x"] @ C.T
        ys = u
        finals = None
        for stage, run, p in zip(program.stages, runners, sp):
            lead = tuple(ys.shape[:-2])
            x0 = {name: torch.zeros(lead + (w,), dtype=torch.float32, device=ys.device)
                  for name, w in stage.graph.states.items()}
            finals, ys = run(p, x0, ys)
        return finals[readout] @ C.T

    return forward


__all__ = ["MESH_NOT_PORTED", "compile_program", "compile_stage", "graph_model"]
