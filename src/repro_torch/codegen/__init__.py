"""State-space code generation: spec → scheduled FSM/datapath IR → backends;
the port's counterpart of ``repro/codegen``.

The paper's headline artifact is a code *generator* (hyper-parameters →
synthesizable Verilog).  This subsystem is that generator with an explicit
IR in the middle; on the card the executable text is CUDA C++:

    NetworkSpec ──build_program──▶ Program (FSM schedule + datapath graph)
                                      │
              ┌───────────────────────┼──────────────────────────┐
        eager_backend           kernel_backend                 verilog
   (the scan loop; the    (lower → cuda_emit → one      (Table-I RTL text;
    float oracle)          generated CUDA stage kernel   rtlsim runs it word
                           per stage)                    for word)

``register_cell`` adds a new cell type once; every backend picks it up.
The design-space tuner over these backends is :mod:`repro_torch.tune`.
"""

from __future__ import annotations

from typing import Any

from .builders import (
    CELL_GRAPHS,
    bind_cell_params,
    build_program,
    cell_stage_runner,
    register_cell,
    registered_cells,
    ssm_params,
)
from .ir import DatapathGraph, GraphBuilder, Node, Program, Schedule, Stage, eval_graph
from .verilog import ResourceReport, emit_program, report_program
from . import cuda_emit, eager_backend, kernel_backend, knobs, lower, rtlsim, verilog

BACKENDS = ("eager", "kernel", "verilog")


def compile_spec(spec: Any, backend: str = "eager", *, device=None):
    """spec → (params, batched forward) through the chosen backend, on
    ``device`` (default: the card).

    ``forward(params, u)`` expects a leading batch axis (and a leading
    stream axis before it when ``spec.c_slow > 1``): mlp ``u [B, L]``,
    recurrent cells ``u [B, T, D]``; returns ``y [B, num_outputs]``.
    """
    program = build_program(spec, device)
    if backend == "eager":
        return program.params, eager_backend.compile_program(program, device=device)
    if backend == "kernel":
        return program.params, kernel_backend.compile_program(program, device=device)
    raise ValueError(f"unknown executable backend '{backend}' (eager|kernel); "
                     "use emit_program() / synthesize(backend='verilog') for RTL")


__all__ = [
    "BACKENDS",
    "CELL_GRAPHS",
    "DatapathGraph",
    "GraphBuilder",
    "Node",
    "Program",
    "ResourceReport",
    "Schedule",
    "Stage",
    "bind_cell_params",
    "build_program",
    "cell_stage_runner",
    "compile_spec",
    "cuda_emit",
    "eager_backend",
    "emit_program",
    "eval_graph",
    "kernel_backend",
    "knobs",
    "lower",
    "register_cell",
    "registered_cells",
    "report_program",
    "rtlsim",
    "ssm_params",
    "verilog",
]
