"""Kernel backend: IR → one generated CUDA stage kernel per stage; the port's
counterpart of ``repro/codegen/pallas_backend.py`` (its ``"pallas"``
backend).

``compile_stage`` lowers the stage's graph (``lower.py``) and emits its CUDA
C++ (``cuda_emit.py``) once; the returned ``run(consts, x0, us)`` launches
that kernel for CUDA tensors (built by ``nvcc`` at its first call, into
``build/``) and runs the plan's interpreter, the kernel's plain version, for
CPU tensors.  A call that reaches the card is one GEMM launch per hoisted or
split macc, then one persistent launch: two for each registered cell, one
for an autonomous stage (the MLP), and the call waits for the stream at its
end to read the grid barrier's error word (counted in
``_build.host_syncs()``).  The grid and the shared memory are chosen by
``cuda_emit.residency`` for the card's SM count and written into the
source, so a card with another SM count builds its own library.  There is
no fallback between the two: a failed build or launch raises.
:func:`codegen_stage` is the kernel's wrapper, and
``codegen_stage.launches`` counts its launches (one per stage call that
reached the card).

Semantics kept from the TPU kernel:

* σ(v) = 0.5·(1 + tanh(v/2)) inside the kernel, with or without a LUT; with
  a ``lut`` (a tanh table from ``tanh_lut.ref.make_lut``) tanh is the
  interpolated ROM lookup (``kernels/csrc/lut.cuh``).
* ``quant_bits <= 8`` runs every quantizable weight ROM on the weight-only
  int8 path: per-step pages compute ``(x @ w_q) · scale`` after the dot,
  shared ROMs dequantise as they are read (``x @ (w_q · scale)``).  Consts
  packed by :func:`prequantize_consts` are recognised by their ``.scale``
  companion; float consts are quantized at each call.
* Any B and T: the kernel loops to T exactly and takes B in row tiles, so
  no padded step ever advances a register.
* C-slow folds the stream axis into the batch (``compile_program``).

``chunk``, ``block_b`` and ``double_buffer`` are the TPU kernel's tiling and
ROM-prefetch knobs.  They are accepted, so that ``synthesize``'s memo and
ledger keys match the reference's, and on the card they change nothing: the
kernel's tiling is fixed by the emitter.

``mesh=`` (a ``DeviceMesh``) splits the leading (C-slow stream or batch)
axis over the mesh's data ranks: each rank folds its local streams into its
own generated-kernel launch, and the output's blocks are joined on every
rank (``parallel.data_parallel``).  Parameters are whole on every rank,
as the reference's ``shard_map`` replicates them.  A leading axis that the
data axis does not divide runs whole on every rank: that is the reference's
rule for a ragged axis (``pallas_backend.compile_program``), not a fallback
from the kernel, which runs in both cases.
"""

from __future__ import annotations

import ctypes
from typing import Any, Callable

import torch

from repro_torch.core.cslow import fold_streams, unfold_streams
from repro_torch.device import resolve_device
from repro_torch.kernels import _build
from repro_torch.kernels._lut import shifted_table
from repro_torch.kernels.int8_matmul.ops import quantize_per_channel
from repro_torch.launch.mesh import require_group
from repro_torch.parallel.data_parallel import data_parallel

from . import cuda_emit, lower
from .ir import DatapathGraph, Program, Stage

PyTree = Any

DEFAULT_CHUNK = 32
DEFAULT_BLOCK_B = 8
LIBRARY = "codegen_stage"


def prequantize_consts(graph: DatapathGraph, consts: dict,
                       quant_bits: int | None) -> dict:
    """Pack every quantizable weight ROM to int8 ONCE, at synthesis time.

    Returns a new consts dict where each ``graph.quantizable_weights()``
    entry is replaced by its int8 codes and a ``"<name>.scale"`` companion
    carries the per-output-channel scale (``quantize_per_channel`` keepdims
    layout; per-step ROM stacks keep their leading T axis, one scale bank
    per page).  ``compile_stage``'s ``run()`` recognizes packed consts by
    the ``.scale`` companion and uses the codes as they are.
    """
    if quant_bits is None or quant_bits > 8:
        return consts
    out = dict(consts)
    for name in graph.quantizable_weights():
        if name not in out or f"{name}.scale" in out:
            continue  # absent (bound later) or already packed
        w_q, s = quantize_per_channel(out[name].to(torch.float32), axis=-2)
        out[name] = w_q
        out[f"{name}.scale"] = s
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    if not getattr(lib, "_repro_bound", False):
        lib.run_stage.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_void_p]
        lib.run_stage.restype = ctypes.c_int
        lib.stage_config.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.stage_config.restype = ctypes.c_int
        lib.stage_serial_floor.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        lib.stage_serial_floor.restype = ctypes.c_int
        lib.stage_error_string.argtypes = [ctypes.c_int]
        lib.stage_error_string.restype = ctypes.c_char_p
        lib._repro_bound = True
    return lib


def codegen_stage(plan: lower.Plan, source: str, consts: dict, x0: dict,
                  us: torch.Tensor | None, T: int, lut: torch.Tensor | None = None):
    """Launch the generated kernel of ``plan`` (CUDA C++ ``source``) on the
    current stream: CUDA tensors in, ``(finals, ys)`` out.  ``consts`` hold
    fp32 ROMs, and int8 codes plus fp32 ``.scale`` companions for
    ``plan.int8``.  Raises on a tensor that is not on the card, a wrong dtype
    or shape, an input that autograd tracks, a failed build or a failed
    launch."""
    first = x0[plan.states[0][0]]
    dev = first.device
    if dev.type != "cuda":
        raise RuntimeError(f"codegen_stage kernel needs CUDA tensors, got {dev}")
    _build.refuse_grad("codegen_stage", us, *x0.values(), *consts.values(), lut)
    B = first.shape[0]
    if B < 1 or T < 1:
        raise ValueError(f"codegen_stage kernel: empty batch or sequence (B={B}, T={T})")
    f32 = dict(dtype=torch.float32, device=dev)

    def check(what: str, t: torch.Tensor, shape: tuple, dtype=torch.float32) -> torch.Tensor:
        if t.device != dev:
            raise RuntimeError(f"codegen_stage kernel: {what} is on {t.device}, expected {dev}")
        if t.dtype != dtype:
            raise ValueError(f"codegen_stage kernel: {what} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"codegen_stage kernel: {what} has shape "
                             f"{tuple(t.shape)}, expected {tuple(shape)}")
        return t.contiguous()

    keep: list[torch.Tensor] = []   # operands stay alive until the launch returns
    ptrs: list[int] = []
    outs: dict[str, torch.Tensor] = {}
    ys = None
    for role, name in cuda_emit.buffer_layout(plan):
        if role == "input":
            t = check("us", us, (B, T, plan.input[1]))
        elif role == "const":
            n = plan.node(name)
            shape = ((T,) if n.attr("per_step") else ()) + tuple(n.attr("shape"))
            t = check(name, consts[name], shape,
                      torch.int8 if name in plan.int8 else torch.float32)
        elif role == "scale":
            n = plan.node(name)
            shape = ((T,) if n.attr("per_step") else ()) + (1, n.attr("shape")[1])
            t = check(f"{name}.scale", consts[f"{name}.scale"], shape)
        elif role == "x0":
            t = check(f"x0[{name}]", x0[name], (B, plan.graph.states[name]))
        elif role == "lut":
            table = lut.to(**f32) if name == "lut" else shifted_table(lut.to(**f32))
            t = check(name, table, (lut.shape[0],))
        elif role == "y":
            t = ys = torch.empty((B, T, plan.out_width), **f32)
        elif role == "final":
            t = outs[name] = torch.empty((B, plan.graph.states[name]), **f32)
        elif role == "scratch":
            t = torch.empty((2, B, plan.graph.states[name]), **f32)
        elif role == "pre":
            t = torch.empty((B, T, plan.node(name).width), **f32)
        elif role == "barrier":
            t = torch.empty((_build.GRID_BARRIER_WORDS,), dtype=torch.int32, device=dev)
        else:  # macc buffer
            t = torch.empty((B, plan.node(name).width), **f32)
        keep.append(t)
        ptrs.append(t.data_ptr())

    lib = _bind(_build.load(LIBRARY, source))
    bufs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    n_lut = 0 if lut is None else int(lut.shape[0])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.run_stage(bufs, B, T, n_lut, stream)
    _raise_on(lib, rc)
    _build.count_host_sync()
    codegen_stage.launches += 1
    return outs, ys


def _raise_on(lib: ctypes.CDLL, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"codegen_stage kernel launch failed: code {rc} "
                           f"({lib.stage_error_string(rc).decode()})")


def launch_config(source: str) -> dict:
    """The persistent kernel's launch configuration written into ``source``
    (checked against the current card): ``grid`` blocks,
    ``weights_resident`` (the step's shared ROM slices held in shared
    memory), ``smem_bytes`` of dynamic shared memory, ``barriers_per_step``."""
    lib = _bind(_build.load(LIBRARY, source))
    out = (ctypes.c_int * 4)()
    _raise_on(lib, lib.stage_config(out))
    return {"grid": out[0], "weights_resident": bool(out[1]), "smem_bytes": out[2],
            "barriers_per_step": out[3]}


def serial_floor(source: str, T: int) -> None:
    """Launch the serial floor of one call on the current stream: the
    persistent kernel's grid running the grid barriers of ``T`` steps and
    no work (for timing; not counted as a launch)."""
    lib = _bind(_build.load(LIBRARY, source))
    dev = torch.device("cuda", torch.cuda.current_device())
    bar = torch.empty((_build.GRID_BARRIER_WORDS,), dtype=torch.int32, device=dev)
    _raise_on(lib, lib.stage_serial_floor(T, bar.data_ptr(),
                                          torch.cuda.current_stream(dev).cuda_stream))


codegen_stage.launches = 0


def compile_stage(stage: Stage, *, lut=None, chunk: int = DEFAULT_CHUNK,
                  block_b: int = DEFAULT_BLOCK_B,
                  quant_bits: int | None = None,
                  double_buffer: bool = True) -> Callable:
    """Generate the stage kernel for one scheduled datapath.

    Returns ``run(consts, x0, us) -> (final_states, ys)`` with ``x0`` leaves
    ``[B, width]`` and ``us`` ``[B, T, D]`` (None for autonomous graphs,
    which then run ``stage.schedule.steps`` steps).  Any ``B``/``T`` is
    accepted.  ``run.plan`` and ``run.source`` are the lowered plan and the
    emitted CUDA C++ for a 132-SM H100; on a card with another SM count the
    launch emits and builds the source for that count.  ``chunk``,
    ``block_b`` and ``double_buffer`` change nothing on the card (see the
    module docstring).
    """
    del chunk, block_b, double_buffer
    graph, sched = stage.graph, stage.schedule
    int8 = quant_bits is not None and quant_bits <= 8
    qnames = tuple(graph.quantizable_weights()) if int8 else ()
    plan = lower.lower(graph, lut=lut is not None, int8_weights=qnames)
    source = cuda_emit.emit(plan)
    sources = {cuda_emit.H100_SMS: source}   # SM count -> emitted text

    def run(consts: dict, x0: dict, us):
        T = us.shape[1] if us is not None else sched.steps
        first = x0[plan.states[0][0]]
        B = first.shape[0]
        for s, w in plan.states:
            if tuple(x0[s].shape) != (B, w):
                raise ValueError(f"x0[{s}] has shape {tuple(x0[s].shape)}, expected {(B, w)}")
        if (us is None) != (plan.input is None) or (
                us is not None and tuple(us.shape) != (B, T, plan.input[1])):
            raise ValueError(f"us of shape {None if us is None else tuple(us.shape)} for a "
                             f"stage with input {plan.input} and batch {B}")
        packed = prequantize_consts(graph, consts, quant_bits) if int8 else consts
        if first.device.type == "cpu":
            return lower.interpret(plan, packed, x0, us, T, lut)
        x0 = {k: v.to(torch.float32) for k, v in x0.items()}
        us = None if us is None else us.to(torch.float32)
        packed = {k: (v if k in plan.int8 else v.to(torch.float32))
                  for k, v in packed.items()}
        src = source          # off the card: codegen_stage raises
        if first.device.type == "cuda":
            sms = torch.cuda.get_device_properties(first.device).multi_processor_count
            if sms not in sources:
                sources[sms] = cuda_emit.emit(plan, sm_count=sms)
            src = sources[sms]
        return codegen_stage(plan, src, packed, x0, us, T, lut)

    run.plan = plan
    run.source = source
    return run


def compile_program(program: Program, *, lut=None,
                    chunk: int = DEFAULT_CHUNK, block_b: int = DEFAULT_BLOCK_B,
                    quant_bits: int | None = None,
                    double_buffer: bool = True, mesh=None, device=None) -> Callable:
    """IR → batched forward through generated stage kernels — the same
    signature as :func:`eager_backend.compile_program`.

    ``c_slow = C > 1`` folds the stream axis into the batch
    (:func:`repro_torch.core.cslow.fold_streams`): the kernel's batch
    dimension IS the C-slow interleave, one launch per stage for all C·B
    streams.  ``quant_bits <= 8`` runs every gate contraction on the
    weight-only int8 ROM path.  ``forward.sources`` lists the emitted CUDA
    C++ of each stage.  ``mesh`` splits the leading axis over the data
    ranks (module docstring).
    """
    if mesh is not None:
        require_group(mesh)
    resolve_device(device)
    program.validate()
    runners = [compile_stage(st, lut=lut, chunk=chunk, block_b=block_b,
                             quant_bits=quant_bits, double_buffer=double_buffer)
               for st in program.stages]
    is_mlp = program.beta is not None
    readout = program.readout_state
    c_slow = program.stages[0].schedule.c_slow

    def forward(params: PyTree, u: torch.Tensor) -> torch.Tensor:
        u = u.to(torch.float32)
        C_streams = u.shape[0] if c_slow > 1 else 1
        if c_slow > 1:  # [C, B, ...] -> [(C·B), ...]: batch-axis interleave
            u = fold_streams(u)
        C = params["C"].to(torch.float32)
        sp = params["stages"]
        if is_mlp:
            x0 = {"x": u @ params["beta"].to(torch.float32).T}
            finals, _ = runners[0](sp[0], x0, None)
            y = finals["x"] @ C.T
        else:
            ys = u
            finals = None
            for stage, run, p in zip(program.stages, runners, sp):
                B = ys.shape[0]
                x0 = {name: torch.zeros((B, w), dtype=torch.float32, device=ys.device)
                      for name, w in stage.graph.states.items()}
                finals, ys = run(p, x0, ys)
            y = finals[readout] @ C.T
        if c_slow > 1:
            y = unfold_streams(y, C_streams)
        return y

    sources = [r.source for r in runners]
    if mesh is not None:
        forward = data_parallel(forward, mesh)
    forward.sources = sources
    return forward


__all__ = [
    "DEFAULT_BLOCK_B",
    "DEFAULT_CHUNK",
    "codegen_stage",
    "compile_program",
    "compile_stage",
    "launch_config",
    "prequantize_consts",
    "serial_floor",
]
