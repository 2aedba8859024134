"""The "HDL code generator" (paper §IV-D3, Table I, Fig. 10) — the port's
counterpart of ``repro/core/synthesis.py``.

The paper ships a C# tool that takes NN hyper-parameters through a GUI and
emits synthesizable Verilog.  On the card the counterpart of "emitting RTL"
is building the state-space program and emitting a CUDA stage kernel from
it.  The public API mirrors Table I one-to-one:

    Create_TopModule  -> create_top_module(spec)
    Create_Layer1     -> create_layer1(...)     (input → first hidden)
    Create_Layer      -> create_layer(...)      (hidden → hidden, shared)
    Create_Layer_End  -> create_layer_end(...)  (hidden → output)
    Create_AF         -> create_af(...)         (activation function unit)
    Create_AF_End     -> create_af_end(...)
    Create_mult       -> create_mult(...)       (MACC unit)

``synthesize()`` is the push-button flow: spec → IR program → lower → build →
report, on four backends, each the counterpart of one of the reference's:

    ``"eager"``   (reference ``"xla"``)     the eager scan executor
    ``"kernel"``  (reference ``"pallas"``)  the generated CUDA stage kernel
    ``"verilog"`` (reference ``"verilog"``) the Table-I RTL text and its
                                            resource report, beside the
                                            eager program it builds and runs
    ``"ref"``     (reference ``"ref"``)     ``create_top_module``, no IR

``analyze=True`` gates any backend on the static analyzer
(:mod:`repro_torch.analyze`).  ``optimize=`` and ``mesh=`` are not ported
yet and raise ``NotImplementedError`` naming their ROADMAP item.  Weights are
drawn from ``torch.Generator().manual_seed(spec.seed)``, so a spec gives the
same network on every backend of the port (not the reference's numbers).
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import obs as obs_lib
from repro_torch.codegen.eager_backend import MESH_NOT_PORTED
from repro_torch.device import resolve_device

from .state_space import mlp_forward, resolve_activation


# ---------------------------------------------------------------------------
# Spec — what the paper's GUI collects
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NetworkSpec:
    num_inputs: int
    num_hidden_layers: int
    nodes_per_layer: int
    num_outputs: int
    activation: str = "tanh"
    # Cell type: "mlp" is the paper's case-study feed-forward network
    # (layers-as-time); "lstm"/"gru"/"ssm" are the intrinsically recurrent
    # forms (inputs-as-time, seq_len steps).
    cell: str = "mlp"
    seq_len: int = 0         # required (> 0) for recurrent cells
    # Resource/speed compromise (paper: clk_max vs clk_data):
    unroll: int = 1          # j datapath copies per scan stage
    c_slow: int = 1          # independent interleaved streams
    # Fixed-point word length used by the analysis stage (None = fp32 deploy)
    quant_bits: int | None = None
    seed: int = 0

    @property
    def name(self) -> str:
        tag = "nn" if self.cell == "mlp" else self.cell
        return (
            f"{tag}_{self.num_inputs}i_{self.num_hidden_layers}x"
            f"{self.nodes_per_layer}_{self.num_outputs}o"
        )

    @property
    def serial_steps(self) -> int:
        """Length of the time-multiplexed axis: layers for the MLP form,
        sequence steps for recurrent cells."""
        return self.num_hidden_layers if self.cell == "mlp" else self.seq_len


# ---------------------------------------------------------------------------
# Table-I module constructors
# ---------------------------------------------------------------------------

def create_mult(dtype=torch.float32) -> Callable:
    """The MACC unit: one dot-product lane (a row of FMAs on the card, a
    DSP48 on the FPGA)."""

    def macc(x, w, b):
        return (w.to(dtype) @ x.to(dtype)) + b

    return macc


def create_af(activation: str) -> Callable:
    """The activation-function unit for hidden nodes (shared core table)."""
    return resolve_activation(activation)


def create_af_end(activation: str = "identity") -> Callable:
    """Output-layer activation (paper: usually different from hidden)."""
    return create_af(activation)


def create_layer1(num_inputs: int, nodes: int, gen: torch.Generator) -> torch.Tensor:
    """Input layer β: injects u into the state at k=0 (the βuδ[k] term)."""
    return torch.randn((nodes, num_inputs), generator=gen) / np.sqrt(num_inputs)


def create_layer(nodes: int, num_hidden_layers: int, gen: torch.Generator):
    """The shared hidden datapath: stacked [N, M, M] weights + [N, M] biases
    — one physical layer, N time-multiplexed uses (paper §IV-A)."""
    W = torch.randn((num_hidden_layers, nodes, nodes), generator=gen) / np.sqrt(nodes)
    b = 0.1 * torch.randn((num_hidden_layers, nodes), generator=gen)
    return W, b


def create_layer_end(nodes: int, num_outputs: int, gen: torch.Generator) -> torch.Tensor:
    """Readout C: y = C x[N]."""
    return torch.randn((num_outputs, nodes), generator=gen) / np.sqrt(nodes)


def draw_mlp_params(spec: NetworkSpec) -> dict:
    """β, W, b, C of an mlp spec, drawn on the CPU in that order from
    ``spec.seed`` — shared by ``create_top_module`` and ``build_program``."""
    gen = torch.Generator().manual_seed(spec.seed)
    beta = create_layer1(spec.num_inputs, spec.nodes_per_layer, gen)
    W, b = create_layer(spec.nodes_per_layer, spec.num_hidden_layers, gen)
    C = create_layer_end(spec.nodes_per_layer, spec.num_outputs, gen)
    return {"beta": beta, "W": W, "b": b, "C": C}


def draw_recurrent_params(spec: NetworkSpec, ctor: Callable) -> dict:
    """Each layer's cell parameters (``ctor(gen, d_in, hidden)``), then C,
    drawn on the CPU in that order from ``spec.seed``."""
    gen = torch.Generator().manual_seed(spec.seed)
    cells = [ctor(gen, spec.num_inputs if i == 0 else spec.nodes_per_layer,
                  spec.nodes_per_layer)
             for i in range(spec.num_hidden_layers)]
    C = create_layer_end(spec.nodes_per_layer, spec.num_outputs, gen)
    return {"cells": cells, "C": C}


def create_top_module(spec: NetworkSpec, device=None):
    """Wire the modules into the full state-space network (paper eq. 8).

    Returns (params, forward), with params on ``device`` (default: the
    card).  For the MLP form ``forward(params, u)`` maps inputs ``u [..., L]``
    to the outputs (layers-as-time); for recurrent cells it maps input
    *sequences* ``u [..., seq_len, num_inputs]`` through
    ``spec.num_hidden_layers`` stacked cells to the readout of the final
    carry (inputs-as-time).  Leading axes are batch (and C-slow streams),
    where the reference vmaps a single input.
    """
    from repro_torch.recurrent import cells as rnn_cells

    dev = resolve_device(device)
    if spec.cell != "mlp":
        if spec.seq_len <= 0:
            raise ValueError(f"recurrent spec '{spec.cell}' requires seq_len > 0")
        ctor = rnn_cells.lstm_params if spec.cell == "lstm" else rnn_cells.gru_params
        p = draw_recurrent_params(spec, ctor)
        params = {"cells": [{k: v.to(dev) for k, v in cp.items()} for cp in p["cells"]],
                  "C": p["C"].to(dev)}

        def forward(params, u):
            ys = u.to(torch.float32).movedim(-2, 0)  # [T, ..., D] time-major
            carry = None
            for cp in params["cells"]:
                carry, ys = rnn_cells.run_cell(spec.cell, cp, ys, unroll=spec.unroll)
            h_final = carry[0] if spec.cell == "lstm" else carry
            return h_final @ params["C"].T

        return params, forward

    params = {k: v.to(dev) for k, v in draw_mlp_params(spec).items()}

    def forward(params, u):
        return mlp_forward(
            params["W"], params["b"], params["beta"], params["C"], u.to(torch.float32),
            activation_name=spec.activation, unroll=spec.unroll,
        )

    return params, forward


# ---------------------------------------------------------------------------
# synthesize(): the push-button multi-backend flow + report
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SynthesisReport:
    """What ``synthesize`` built and measured.  The fields the reference
    took from XLA have stand-ins on the card:

    * ``flops`` — ``macc_flops_per_step`` of every stage × serial steps ×
      batch × C (the datapath's MACC work, from the IR);
    * ``peak_bytes`` — the rise of ``torch.cuda.max_memory_allocated()``
      over the first run on the card; ``None`` on the CPU;
    * ``hlo_bytes`` — the length of the emitted CUDA C++ of every stage
      (``"kernel"``), 0 on the other backends;
    * ``trace_lower_s`` — building the forward: plan lowering and CUDA
      emission (``"kernel"``);
    * ``compile_s`` — the first run on zeros of the input shape: ``nvcc``
      (when the library is not built yet) and the first launch.
    """

    spec: NetworkSpec
    num_params: int
    trace_lower_s: float
    compile_s: float
    hlo_bytes: int
    flops: float | None
    peak_bytes: int | None
    output_shape: tuple
    serial_depth: int
    backend: str = "eager"
    cache_hit: bool = False
    rtl: str | None = None              # backend="verilog": Table-I RTL text
    resources: Any = None               # backend="verilog": codegen.ResourceReport
    quant: dict | None = None           # quant_bits analysis (SNR / LUT mode)
    fallback_from: str | None = None    # the requested backend, after a fallback hop
    analysis: dict | None = None        # analyze=True: the repro.analyze/v1
    #                                     result document

    def summary(self) -> str:
        extra = ""
        if self.quant is not None:
            snr = self.quant.get("snr_db")
            extra += f" q{self.quant['bits']}" + (
                f"={snr:.1f}dB" if snr is not None else f":{self.quant['mode']}")
        if self.rtl is not None:
            extra += f" rtl={len(self.rtl) / 1024:.1f}KiB"
        if self.cache_hit:
            extra += " (cached)"
        return (
            f"[{self.spec.name}|{self.backend}] params={self.num_params:,} "
            f"lower={self.trace_lower_s * 1e3:.1f}ms compile={self.compile_s * 1e3:.1f}ms "
            f"src={self.hlo_bytes / 1024:.1f}KiB flops={self.flops} "
            f"peak_bytes={self.peak_bytes} depth={self.serial_depth}{extra}"
        )


# Memoization: Fig. 10-style sweeps re-synthesize identical specs; one build
# per cache key is enough.  NetworkSpec is frozen/hashable.
_SYNTH_CACHE: dict[tuple, SynthesisReport] = {}

BACKENDS = ("eager", "kernel", "verilog", "ref")

_NOT_PORTED = {
    "optimize": "optimize= (the repro.tune auto-tuner) is not ported yet; it "
                "is the next slice of ROADMAP.md, Queue 1: Bit path and tools "
                "(tune/ with synthesize(optimize=, budget=))",
    "mesh": MESH_NOT_PORTED,
}

# Degradation order when an injected fault keeps a backend from building:
# the generated kernel falls back to the eager scan, and that to the
# unlowered reference forward ("ref": create_top_module, no IR).  verilog's
# built artifact is the eager program, so it degrades straight to ref (RTL
# emission is unaffected).
_SYNTH_FALLBACK: dict[str, tuple[str, ...]] = {
    "kernel": ("eager", "ref"),
    "eager": ("ref",),
    "verilog": ("ref",),
    "ref": (),
}


def _faults_mod():
    """The fault-injection module, WITHOUT importing the runtime package:
    if ``repro_torch.runtime.faults`` was never imported, no plan can be
    installed and there is nothing to consult."""
    return sys.modules.get("repro_torch.runtime.faults")


def _cache_key(spec: NetworkSpec, batch: int | None, backend: str,
               device: torch.device | None = None) -> tuple:
    """EVERY knob that changes the built artifact must appear here.

    ``spec`` is frozen, so its hash covers the shape knobs AND
    ``quant_bits`` (which derives the kernel's lut/int8-MACC modes).  The
    reference's TPU tiling knobs (``double_buffer`` / ``chunk`` /
    ``block_b``) build the same kernel on the card, so they are not part of
    the key.  The device the artifact ran on is the last element (the
    reference keys its mesh there)."""
    dev = None if device is None else str(device)
    return (spec, batch, backend, dev)


def synthesize_cache_clear() -> None:
    _SYNTH_CACHE.clear()


def synthesize_cache_info() -> dict:
    return {"entries": len(_SYNTH_CACHE)}


def _quant_analysis(spec: NetworkSpec, backend: str, prog) -> dict | None:
    """Honor ``spec.quant_bits`` (paper stage 3, Fig. 11).

    mlp: bit-exact fixed-point simulation vs double reference → output SNR.
    recurrent + kernel: gate activations switch to the ROM-LUT path;
    ``quant_bits <= 8`` additionally runs every gate contraction on the
    int8 MACC datapath, which also covers af-free cells like the ssm.
    recurrent + eager: unsupported — raise rather than silently ignore.
    (verilog always honors quant_bits as the RTL word width.)
    """
    if spec.quant_bits is None:
        return None
    int8_macc = backend == "kernel" and spec.quant_bits <= 8
    if spec.cell == "mlp":
        from .quantization import snr_sweep

        sp = prog.stages[0].params
        W = np.swapaxes(sp["W"].detach().cpu().numpy().astype(np.float64), -1, -2)
        b = sp["b"].detach().cpu().numpy().astype(np.float64)[:, 0, :]
        beta = prog.beta.detach().cpu().numpy().astype(np.float64)
        C = prog.C.detach().cpu().numpy().astype(np.float64)
        [(bits, snr)] = snr_sweep(W, b, beta, C, [spec.quant_bits],
                                  num_inputs=128, seed=spec.seed)
        return {"bits": bits, "mode": "fixed-point", "int8_macc": int8_macc,
                "snr_db": float(np.mean(snr)),
                "per_output_snr_db": [float(s) for s in snr]}
    has_af = any(st.graph.af_nodes() for st in prog.stages)
    if backend == "kernel" and has_af:  # ssm has no af units to quantize
        return {"bits": spec.quant_bits, "mode": "lut", "int8_macc": int8_macc}
    if int8_macc:  # af-free cells still have MACC units to quantize
        return {"bits": spec.quant_bits, "mode": "int8", "int8_macc": True}
    if backend == "verilog":
        return {"bits": spec.quant_bits, "mode": "rtl-width"}
    raise ValueError(
        f"quant_bits={spec.quant_bits} with cell='{spec.cell}' is not supported "
        f"on backend='{backend}' — use backend='kernel' on a cell with "
        "activation units (ROM-LUT gates) or quant_bits<=8 (int8 MACC), "
        "backend='verilog' (RTL word width), or cell='mlp' (fixed-point SNR)"
    )


def _ledger_key(spec: NetworkSpec, batch: int | None, backend: str,
                double_buffer: bool = True, chunk: int | None = None,
                block_b: int | None = None) -> str:
    """Program id in the predicted-vs-measured ledger, in the reference's
    format with the port's backend names.  The tiling knobs are named as the
    reference names them, although on the card they build the same kernel."""
    key = f"{spec.name}|{backend}|u{spec.unroll}|c{spec.c_slow}"
    if spec.quant_bits is not None:
        key += f"|q{spec.quant_bits}"
    if batch:
        key += f"|b{batch}"
    if backend == "kernel":
        if not double_buffer:
            key += "|db0"
        if chunk is not None:
            key += f"|ch{chunk}"
        if block_b is not None:
            key += f"|bb{block_b}"
    return key


def _build_fwd(program, spec: NetworkSpec, backend: str, quant: dict | None,
               double_buffer: bool, chunk: int | None, block_b: int | None,
               device: torch.device):
    """One backend's ``(fwd, params, sources)``; the ``synth.compile``
    fault point fires here."""
    from repro_torch import codegen

    m = _faults_mod()
    if m is not None:
        m.maybe_raise("synth.compile")

    if backend == "ref":
        ref_params, ref_fwd = create_top_module(spec, device)
        return ref_fwd, ref_params, []

    lut = None
    if quant is not None and quant["mode"] == "lut":
        from repro_torch.kernels.tanh_lut.ref import make_lut

        lut = make_lut(min(max(spec.quant_bits // 2, 6), 10), device=device)
    params = program.params
    if backend == "kernel":
        int8_bits = spec.quant_bits if quant and quant.get("int8_macc") else None
        kb = codegen.kernel_backend
        fwd = kb.compile_program(
            program, lut=lut, quant_bits=int8_bits,
            double_buffer=double_buffer,
            chunk=chunk if chunk is not None else kb.DEFAULT_CHUNK,
            block_b=block_b if block_b is not None else kb.DEFAULT_BLOCK_B,
            device=device)
        if int8_bits is not None:
            # pack the int8 weight ROMs ONCE, here at synthesis time
            params = dict(params)
            params["stages"] = [
                kb.prequantize_consts(st.graph, sp, int8_bits)
                for st, sp in zip(program.stages, params["stages"])]
        return fwd, params, fwd.sources
    # "eager", and the program that "verilog" builds and runs beside its RTL
    return codegen.eager_backend.compile_program(program, device=device), params, []


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _build_and_run(program, spec, backend, quant, double_buffer, chunk, block_b,
                   u_shape, device):
    """build → first run: (timings, source bytes, peak bytes, fwd, params).
    The first run on the card includes ``nvcc`` when the library is not
    built yet, and the first launch."""
    tr = obs_lib.OBS.tracer
    t0 = time.perf_counter()
    with tr.span("synth.lower", cat="synth"):
        fwd, params, sources = _build_fwd(program, spec, backend, quant,
                                          double_buffer, chunk, block_b, device)
    t1 = time.perf_counter()
    peak = None
    with tr.span("synth.compile", cat="synth"):
        if device.type == "cuda":
            _sync(device)
            torch.cuda.reset_peak_memory_stats(device)
            base = torch.cuda.memory_allocated(device)
        with torch.no_grad():
            fwd(params, torch.zeros(u_shape, dtype=torch.float32, device=device))
        _sync(device)
        if device.type == "cuda":
            peak = int(torch.cuda.max_memory_allocated(device) - base)
    t2 = time.perf_counter()
    return t1 - t0, t2 - t1, sum(len(s) for s in sources), peak, fwd, params


def _measure(fwd, params, u_shape, key: str, device: torch.device) -> None:
    """Time one real execution of the built program (warmup + best-of-2)
    into the process ledger — the *measured* column of the Fig. 10 loop."""
    O = obs_lib.OBS
    u0 = torch.zeros(u_shape, dtype=torch.float32, device=device)
    with O.tracer.span("synth.measure", cat="synth", args={"program": key}), \
            torch.no_grad():
        fwd(params, u0)                                      # warmup
        _sync(device)
        for _ in range(2):
            t0 = time.perf_counter()
            fwd(params, u0)
            _sync(device)
            O.ledger.measure(key, time.perf_counter() - t0)


def _static_gate(spec: NetworkSpec, program, waivers, O, device) -> dict:
    """``synthesize(analyze=True)``: run :mod:`repro_torch.analyze` on the
    IR and raise :class:`repro_torch.analyze.AnalysisError` on unwaived
    error findings — purely static, before (and regardless of) any backend
    build."""
    from repro_torch import codegen
    from repro_torch.analyze import analyze_program, gate

    if program is None:                 # memo-hit path: rebuild (no backend)
        program = codegen.build_program(spec, device)
    with O.tracer.span("synth.analyze", cat="synth", args={"spec": spec.name}):
        res = analyze_program(program, waivers=waivers)
    O.metrics.counter("synth_analyze", "synthesize(analyze=True) gate runs",
                      result="fail" if res.errors else "pass").inc()
    gate(res)
    return res.to_doc()


def build_forward(spec: NetworkSpec, backend: str = "eager", *, device=None,
                  double_buffer: bool = True, chunk: int | None = None,
                  block_b: int | None = None):
    """``(forward, params)`` as :func:`synthesize` builds them for ``spec``
    on ``backend``, honouring ``spec.quant_bits`` as it does (LUT gates,
    int8 ROMs packed once).  ``forward(params, u)`` takes ``u`` as
    ``synthesize`` shapes it: mlp ``[B, L]``, recurrent ``[B, T, D]``, with
    a leading stream axis C when ``spec.c_slow > 1``."""
    from repro_torch import codegen

    dev = resolve_device(device)
    program = codegen.build_program(spec, dev)
    quant = _quant_analysis(spec, backend, program) if backend != "ref" else None
    fwd, params, _ = _build_fwd(program, spec, backend, quant, double_buffer,
                                chunk, block_b, dev)
    return fwd, params


def synthesize(spec: NetworkSpec, batch: int | None = None,
               backend: str = "eager", *,
               mesh=None,
               double_buffer: bool = True,
               chunk: int | None = None,
               block_b: int | None = None,
               measure: bool = True,
               optimize: str | None = None,
               budget: int | None = None,
               retries: int = 2,
               backoff_s: float = 0.05,
               fallback: bool = True,
               analyze: bool = False,
               waivers=None,
               device=None):
    """spec → IR program → {eager scan, generated CUDA stage kernel, Verilog
    RTL, ref}.

    The IR backends consume the same :mod:`repro_torch.codegen` program, so
    ``backend="eager"`` and ``backend="kernel"`` are output-equivalent (up to
    rounding; the kernel's σ is 0.5·(1 + tanh(v/2)), as the TPU kernel's),
    and ``backend="verilog"`` builds and runs the eager program and
    attaches the Table-I RTL text and a :class:`~repro_torch.codegen.ResourceReport`
    (its ``xla_flops`` / ``xla_peak_bytes`` are the built forward's MACC
    flops and peak device bytes, under the reference's field names).
    The forward is built, run once on zeros of the input shape (on
    ``device``, default: the card) and, with ``measure``, timed into the
    process ledger (:data:`repro_torch.obs.OBS`), with the FSM cycle
    estimate and the MACC flops as its predicted columns.  Results are
    memoized by :func:`_cache_key`.

    ``double_buffer`` / ``chunk`` / ``block_b`` are the reference's TPU
    tiling knobs: accepted and named in the ledger key, without effect on
    the card.

    Robustness: an injected transient build fault (the ``synth.compile``
    point of :mod:`repro_torch.runtime.faults`) is retried up to ``retries``
    times with exponential ``backoff_s`` backoff; a backend that keeps
    failing on injected faults degrades down the kernel → eager → ref chain
    (``fallback=False`` re-raises instead).  The report's ``backend`` is the
    backend that built, ``fallback_from`` the requested one, and the
    ``synth_retries`` / ``synth_fallback{from_backend,to}`` counters track
    both; such a degraded report is not memoized.  Unlike the reference, which degrades on any exception, only a
    :class:`~repro_torch.runtime.faults.FaultError` hops: a real failure
    (``nvcc``, a ``cudaError`` at launch, a grid-barrier timeout) raises at
    once whatever ``fallback`` says, so a fallback never hides the card or
    the kernel.

    ``analyze=True`` runs the :mod:`repro_torch.analyze` static range/
    overflow + hazard analysis on the IR *before* any backend build and
    raises :class:`repro_torch.analyze.AnalysisError` on unwaived
    error-grade findings (pass a
    :class:`repro_torch.analyze.WaiverRegistry` as ``waivers`` to
    acknowledge known ones); the ``repro.analyze/v1`` result document is
    attached as ``report.analysis``.  The gate is outside the memo key — a
    cache hit re-runs it and attaches a fresh analysis.

    Not ported yet, and raising ``NotImplementedError``: ``mesh`` and
    ``optimize`` / ``budget``.
    """
    from repro_torch import codegen

    if optimize is not None or budget is not None:
        raise NotImplementedError(_NOT_PORTED["optimize"])
    if mesh is not None:
        raise NotImplementedError(_NOT_PORTED["mesh"])
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend '{backend}'; available: {BACKENDS}")
    dev = resolve_device(device)

    O = obs_lib.OBS
    key = _cache_key(spec, batch, backend, dev)
    if key in _SYNTH_CACHE:
        O.metrics.counter("synth_cache", "synthesize() memo", result="hit").inc()
        report = dataclasses.replace(_SYNTH_CACHE[key], cache_hit=True)
        if analyze:    # the gate is outside the memo key: re-run, re-attach
            report = dataclasses.replace(
                report, analysis=_static_gate(spec, None, waivers, O, dev))
        return report
    O.metrics.counter("synth_cache", "synthesize() memo", result="miss").inc()

    with O.tracer.span("synth.build_program", cat="synth",
                       args={"spec": spec.name, "backend": backend}):
        program = codegen.build_program(spec, dev)
    analysis_doc = (_static_gate(spec, program, waivers, O, dev)
                    if analyze else None)
    # the REQUESTED backend's quant validation still raises on unsupported
    # combinations (user error, not a fault to degrade around)
    quant = _quant_analysis(spec, backend, program)

    u_shape = (spec.num_inputs,) if spec.cell == "mlp" \
        else (spec.seq_len, spec.num_inputs)
    u_shape = (batch or 1,) + u_shape
    if spec.c_slow > 1:  # C interleaved streams through the one datapath
        u_shape = (spec.c_slow,) + u_shape

    m = _faults_mod()
    injected = (m.FaultError,) if m is not None else ()
    chain = (backend,) + (_SYNTH_FALLBACK[backend] if fallback else ())
    built, last_err, used = None, None, backend
    for hop, bk in enumerate(chain):
        if hop:
            O.metrics.counter("synth_fallback", "backend fallback hops",
                              from_backend=chain[hop - 1], to=bk).inc()
            try:
                quant = _quant_analysis(spec, bk, program)
            except ValueError:
                quant = None    # degraded: the quant mode is not expressible here
        for attempt in range(max(0, retries) + 1):
            try:
                built = _build_and_run(program, spec, bk, quant, double_buffer, chunk,
                                       block_b, u_shape, dev)
                break
            except injected as e:   # only an injected fault retries or hops
                last_err = e
                if isinstance(e, m.TransientFault) and attempt < retries:
                    O.metrics.counter("synth_retries", "transient compile retries").inc()
                    if backoff_s > 0:
                        time.sleep(backoff_s * (2 ** attempt))
                    continue
                break
        if built is not None:
            used = bk
            break
    if built is None:
        raise last_err
    lower_s, compile_s, src_bytes, peak, fwd, params = built
    flops = float(sum(st.graph.macc_flops_per_step() for st in program.stages)
                  * spec.serial_steps * (batch or 1) * spec.c_slow)

    # predicted-vs-measured ledger: the Fig. 10 loop's instrumentation
    lkey = _ledger_key(spec, batch, used, double_buffer, chunk, block_b)
    O.ledger.predict(
        lkey,
        fsm_cycles=codegen.rtlsim.fsm_cycle_estimate(program),
        flops=flops, peak_bytes=peak, hlo_bytes=src_bytes,
        compile_s=compile_s, num_params=program.num_params(),
    )
    if measure:
        _measure(fwd, params, u_shape, lkey, dev)

    rtl = resources = None
    if backend == "verilog":
        rtl = codegen.emit_program(program)
        resources = codegen.report_program(program)
        resources.xla_flops = flops          # the built forward's MACC flops
        resources.xla_peak_bytes = peak

    from .transition import serial_depth_estimate

    report = SynthesisReport(
        spec=spec,
        num_params=program.num_params(),
        trace_lower_s=lower_s,
        compile_s=compile_s,
        hlo_bytes=src_bytes,
        flops=flops,
        peak_bytes=peak,
        # the true output shape: always batched, stream axis when C>1
        output_shape=(u_shape[:-1] if spec.cell == "mlp" else u_shape[:-2])
        + (spec.num_outputs,),
        serial_depth=serial_depth_estimate(
            spec.serial_steps * spec.c_slow, spec.unroll),
        backend=used,
        fallback_from=backend if used != backend else None,
        quant=quant,
        rtl=rtl,
        resources=resources,
    )
    if used == backend:  # a degraded build must not answer a later fault-free call
        _SYNTH_CACHE[key] = report
    if analysis_doc is not None:
        return dataclasses.replace(report, analysis=analysis_doc)
    return report


__all__ = [
    "BACKENDS",
    "NetworkSpec",
    "SynthesisReport",
    "build_forward",
    "create_af",
    "create_af_end",
    "create_layer",
    "create_layer1",
    "create_layer_end",
    "create_mult",
    "create_top_module",
    "synthesize",
    "synthesize_cache_clear",
    "synthesize_cache_info",
]
