"""Eager backend: IR → ``StateSpaceModel`` → a loop over the steps; the port's
counterpart of ``repro/codegen/xla_backend.py`` (its ``"xla"`` backend).

The datapath graph becomes the step body (one datapath, time-multiplexed by
the carry — the paper's §IV-A architecture); per-step const ROMs ride as
``run_scan``'s stacked params, and the two scheduling transforms lower as in
the core: ``unroll`` is carried (and changes nothing in eager execution),
``c_slow`` → C interleaved streams through :func:`cslow_vectorized`.

This executor is the port's oracle for the generated CUDA stage kernel: it
evaluates the graph with ``ir.eval_graph`` on whole tensors and shares no
code with ``codegen.lower``.

``mesh=`` (a ``DeviceMesh``, every rank of it calling the forward) is the
counterpart of the reference's GSPMD constraints (``_mesh_constraints``),
written out as SPMD code:

* every MACC weight ROM is row-parallel over ``"model"``: model rank ``r``
  holds rows ``r·R/tp ..`` of a 2-D ``[D+H, 4H]`` weight, or of dim 1 of a
  stacked per-step ``[N, M, M]`` one, computes the partial pre-activation
  from its slice of the input, and one ``all_reduce`` over the model group
  completes it before the bias and the nonlinearity;
* the leading (batch or C-slow stream) axis splits over the data ranks,
  and the output's row blocks are joined on every rank, bit for bit.

Each is divisibility-guarded as the reference's pins are: a weight whose
rows ``tp`` does not divide, or a leading axis that ``dp`` does not divide,
is computed whole on every rank.  TP changes the fp32 summation order of
the contraction, so its results agree with one device's to rounding.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.core.cslow import cslow_vectorized
from repro_torch.core.state_space import StateSpaceModel, resolve_activation, run_scan
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import mesh_tp, model_group, model_index, require_group
from repro_torch.parallel import comm
from repro_torch.parallel.data_parallel import data_parallel

from .ir import DatapathGraph, Program, Stage, eval_graph

PyTree = Any


def graph_model(graph: DatapathGraph, shared: dict[str, torch.Tensor],
                mm: Callable | None = None) -> StateSpaceModel:
    """Wrap a datapath graph as a ``StateSpaceModel``: the state dict is the
    carry, per-step consts arrive as ``params_k``.  Moore when the graph has
    no input (MLP readout happens after the last step).  ``mm`` overrides
    the MACC contraction (``ir.eval_graph``'s hook)."""

    def consts_of(params_k):
        def get(name):
            if params_k is not None and name in params_k:
                return params_k[name].to(torch.float32)
            return shared[name]
        return get

    def fg(params_k, x, u, k):
        # one evaluation a step (one MACC, and under TP one all-reduce, per
        # contraction), as the reference's compiled scan body is
        del k
        new_states, out = eval_graph(graph, consts=consts_of(params_k), states=x,
                                     u=u, act=resolve_activation, mm=mm)
        return new_states, (out if graph.output is not None else new_states)

    def f(params_k, x, u, k):
        return fg(params_k, x, u, k)[0]

    def g(params_k, x, u, k):
        return fg(params_k, x, u, k)[1]

    mode = "mealy" if graph.input_node() is not None else "moore"
    return StateSpaceModel(f=f, g=g, output_mode=mode, fg=fg)


def compile_stage(stage: Stage, mm: Callable | None = None) -> Callable:
    """Returns ``run(consts, x0, us) -> (final_states, ys)``.

    ``x0`` leaves are ``[lead..., width]``, ``us`` is ``[lead..., T, D]`` (or
    None for autonomous graphs).  With ``c_slow = C > 1`` the first leading
    axis is the C interleaved streams, executed through
    :func:`cslow_vectorized` (one datapath, C state registers).  ``mm`` is
    the MACC hook (the TP contraction under a mesh).
    """
    graph, sched = stage.graph, stage.schedule
    per_step = [n.name for n in graph.consts(per_step=True)]
    shared_names = [n.name for n in graph.consts(per_step=False)]

    def run(consts: dict, x0: dict, us):
        shared = {k: consts[k].to(torch.float32) for k in shared_names}
        stacked = {k: consts[k] for k in per_step} or None
        model = graph_model(graph, shared, mm)
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


def _tp_mm(mesh) -> tuple[Callable, Callable]:
    """``(shard_w, mm)`` for row-parallel MACCs over the mesh's model axis:
    ``shard_w`` keeps this model rank's rows of a weight ROM (dim 0 of a
    2-D one, dim 1 of a stacked per-step one) where ``tp`` divides them;
    ``mm`` contracts a row shard with its slice of the input and
    all-reduces the partial over the model group."""
    tp, r, group = mesh_tp(mesh), model_index(mesh), model_group(mesh)

    def shard_w(w: torch.Tensor) -> torch.Tensor:
        rows = w.dim() - 2                  # the contraction dim
        if w.dim() not in (2, 3) or w.shape[rows] % tp:
            return w
        n = w.shape[rows] // tp
        return w.narrow(rows, r * n, n)

    def mm(x: torch.Tensor, _name: str, w: torch.Tensor) -> torch.Tensor:
        if w.shape[0] == x.shape[-1]:       # not split: a whole contraction
            return x @ w
        n = w.shape[0]
        return comm.all_reduce(x[..., r * n:(r + 1) * n] @ w, group)

    return shard_w, mm


def compile_program(program: Program, mesh=None, device=None) -> Callable:
    """IR → batched forward: ``forward(params, u) -> y``.

    Shapes (B = batch; with ``c_slow = C > 1`` prepend a stream axis C):
      mlp        u [B, L]     -> y [B, P]
      recurrent  u [B, T, D]  -> y [B, P]   (readout of the final carry)

    ``device`` (default: the card) is where the forward is meant to run;
    it computes on the device of the tensors it is given.  With ``mesh``
    (a ``DeviceMesh``) the forward is SPMD over the mesh's ranks: MACCs
    row-parallel over ``"model"``, the leading axis over the data ranks
    (module docstring); every rank returns the whole output.
    """
    resolve_device(device)
    program.validate()
    shard_w = mm = None
    if mesh is not None:
        require_group(mesh)
        if mesh_tp(mesh) > 1:
            shard_w, mm = _tp_mm(mesh)
    runners = [compile_stage(st, mm) for st in program.stages]
    w_names = [{n.inputs[1] for n in st.graph.macc_nodes()} for st in program.stages]
    is_mlp = program.beta is not None
    readout = program.readout_state

    def forward(params: PyTree, u: torch.Tensor) -> torch.Tensor:
        C = params["C"].to(torch.float32)
        sp = params["stages"]
        u = u.to(torch.float32)
        if shard_w is not None:
            sp = [{k: (shard_w(v) if k in names else v) for k, v in p.items()}
                  for p, names in zip(sp, w_names)]
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

    return forward if mesh is None else data_parallel(forward, mesh)


__all__ = ["compile_program", "compile_stage", "graph_model"]
