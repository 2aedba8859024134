"""Emission: a lowered :class:`~repro_torch.codegen.lower.Plan` → the CUDA C++
source of one generated stage kernel for Hopper (``sm_90a``).

This replaces the TPU kernel that ``repro/codegen/pallas_backend.py::
compile_stage`` generates: the scheduled datapath of one stage, run for T
steps with the state registers carried across steps.  As the Verilog
emitter writes the paper's Table-I modules for the FPGA, this writes, for
the card:

* one ``__device__`` lane function per graph node (``v_<i>``: the node's
  value at batch row ``b`` and lane ``l``), in topological order;
* one ``__global__`` per macc node, tiled over (output columns, batch rows):
  a block stages its rows' input vector in shared memory (a lane function),
  32 columns × 8 warps split the contraction, each thread looping over its
  share with fp32 FMAs, and the partial sums meet in shared memory before
  the bias and the write to the macc's ``[B, n]`` buffer;
* one ``__global__`` update kernel that writes every register into its
  ping-pong buffer and ``y[:, t, :]``;
* ``run_stage``, a host function with one fixed C signature for every
  generated library, ``int run_stage(void** bufs, int B, int T, int n_lut,
  void* stream)``, which loops over T with no Python in the loop, launches
  on ``stream``, checks every launch's ``cudaError_t`` and returns the
  first failure (0 on success).

``bufs`` holds device pointers in the order :func:`buffer_layout` gives.

What bounds it on this card.  Every step reads every shared weight ROM once
(the fused LSTM gate ROM at D = H = 1024 is [2048, 4096] fp32, 32 MB) to do
``2·B·Σ k·n`` FLOPs, and step t+1 needs all of step t's registers: at
serving batch sizes each step is a latency-bound pass over the ROMs, one
launch per macc plus one for the update.  The contraction is plain FMA (no
tensor cores, no TF32), so the fp32 results hold against the plain version
to rounding.  Not done here, and left for later work: hoisting the
input-only half of a macc into one GEMM over all T (as ``lstm_seq`` does),
prefetching the next step's pages, ``wgmma``/TMA, and a persistent kernel.
"""

from __future__ import annotations

from .lower import Plan

MACC_COLS = 32      # output columns per block: one warp's lanes
MACC_KSPLIT = 8     # warps sharing the contraction
THREADS = MACC_COLS * MACC_KSPLIT
UPDATE_THREADS = 256


def buffer_layout(plan: Plan) -> list[tuple[str, str]]:
    """The ``bufs`` array of ``run_stage``, as ``(role, name)`` pairs:
    the input ``u [B, T, D]``; every const ROM (fp32, or int8 codes); the
    ``.scale`` companion of every int8 ROM; each register's ``x0 [B, w]``;
    the LUT and its shifted partner (LUT plans); ``y [B, T, out]``; each
    register's final value ``[B, w]``; each register's ping-pong scratch
    ``[2, B, w]``; each macc's buffer ``[B, n]``."""
    out = []
    if plan.input is not None:
        out.append(("input", plan.input[0]))
    out += [("const", n.name) for n in plan.consts]
    out += [("scale", name) for name in plan.int8]
    out += [("x0", s) for s, _ in plan.states]
    if plan.lut:
        out += [("lut", "lut"), ("lut", "lut1")]
    if plan.output is not None:
        out.append(("y", plan.output))
    out += [("final", s) for s, _ in plan.states]
    out += [("scratch", s) for s, _ in plan.states]
    out += [("macc", m.name) for m in plan.maccs]
    return out


def _act(fn: str, v: str, lut: bool) -> str:
    tanh = (lambda e: f"lut_interpolate({e}, a.lut, a.lut1, a.n_lut)") if lut \
        else (lambda e: f"tanhf({e})")
    return {
        "tanh": tanh(v),
        "sigmoid": f"0.5f * (1.0f + {tanh(f'0.5f * {v}')})",
        "relu": f"fmaxf({v}, 0.0f)",
        "gelu": (f"0.5f * {v} * (1.0f + tanhf(0.7978845608028654f * "
                 f"({v} + 0.044715f * {v} * {v} * {v})))"),
        "silu": f"{v} / (1.0f + expf(-{v}))",
        "identity": v,
    }[fn]


def emit(plan: Plan) -> str:
    """The CUDA C++ text of the plan's stage kernel (deterministic: the same
    plan always gives the same text, so the build cache keys on it)."""
    g = plan.graph
    idx = {n.name: i for i, n in enumerate(g.nodes)}
    cidx = {n.name: i for i, n in enumerate(plan.consts)}
    sidx = {s: i for i, (s, _) in enumerate(plan.states)}
    swidth = dict(plan.states)
    midx = {m.name: i for i, m in enumerate(plan.maccs)}
    weight_only = {m.w for m in plan.maccs} - {
        i for n in g.nodes for j, i in enumerate(n.inputs) if not (n.op == "macc" and j == 1)}
    NS, NC, NM = len(plan.states), len(plan.consts), len(plan.maccs)
    D = plan.input[1] if plan.input is not None else 0
    OW = plan.out_width
    max_w = max([w for _, w in plan.states] + [OW])

    L = []
    w = L.append
    summary = ", ".join(f"{n.name}:{n.op}" for n in g.nodes)
    w("// Generated by repro_torch.codegen.cuda_emit from a datapath graph; do not edit.")
    w(f"// nodes: {summary}")
    w(f"// registers: {', '.join(f'{s}[{x}]' for s, x in plan.states)}; "
      f"output: {plan.output or '-'}[{OW}]; lut: {int(plan.lut)}; "
      f"int8: {', '.join(plan.int8) or '-'}")
    w("#include <cuda_runtime.h>")
    w("#include <stddef.h>")
    w("#include <stdint.h>")
    w("")
    w('#include "lut.cuh"')
    w("")
    w("namespace {")
    w("")
    w("struct Args {")
    w("  const float* u;            // [B, T, D] (null without an input node)")
    w(f"  const void* c[{max(NC, 1)}];          // const ROMs: fp32, or int8 codes")
    w(f"  const float* cs[{max(NC, 1)}];        // per-channel scales of int8 ROMs")
    w(f"  const float* s[{max(NS, 1)}];         // registers this step reads")
    w(f"  float* sn[{max(NS, 1)}];              // registers this step writes")
    w(f"  float* m[{max(NM, 1)}];               // macc buffers [B, n]")
    w("  float* y;                  // [B, T, out]")
    w("  const float* lut;")
    w("  const float* lut1;")
    w("  int n_lut;")
    w("  int B, T, t;")
    w("};")
    w("")

    # -- lane functions ----------------------------------------------------
    for n in g.nodes:
        if n.op == "const" and n.name in weight_only:
            continue
        i = idx[n.name]
        w(f"// {n.name} ({n.op}, {n.width} lanes)")
        w(f"__device__ __forceinline__ float v_{i}(const Args& a, int b, int l) {{")
        if n.op == "input":
            w(f"  return a.u[((size_t)b * a.T + a.t) * {D} + l];")
        elif n.op == "state":
            w(f"  return a.s[{sidx[n.name]}][(size_t)b * {swidth[n.name]} + l];")
        elif n.op == "const":
            off = f"(size_t)a.t * {n.width} + l" if n.attr("per_step") else "l"
            w(f"  return static_cast<const float*>(a.c[{cidx[n.name]}])[{off}];")
        elif n.op == "macc":
            w(f"  return a.m[{midx[n.name]}][(size_t)b * {n.width} + l];")
        elif n.op == "af":
            w(f"  const float v = v_{idx[n.inputs[0]]}(a, b, l);")
            w(f"  return {_act(n.attr('fn'), 'v', plan.lut)};")
        elif n.op == "slice":
            w(f"  return v_{idx[n.inputs[0]]}(a, b, l + {n.attr('start')});")
        elif n.op == "concat":
            off = 0
            for j, part in enumerate(n.inputs):
                pw = g.node(part).width
                call = f"v_{idx[part]}(a, b, l - {off})"
                if j < len(n.inputs) - 1:
                    w(f"  if (l < {off + pw}) return {call};")
                else:
                    w(f"  return {call};")
                off += pw
        else:
            sym = {"add": "+", "sub": "-", "mul": "*"}[n.op]
            w(f"  return v_{idx[n.inputs[0]]}(a, b, l) {sym} v_{idx[n.inputs[1]]}(a, b, l);")
        w("}")
        w("")

    # -- one kernel per macc ----------------------------------------------
    w(f"constexpr int MACC_COLS = {MACC_COLS};")
    w(f"constexpr int MACC_KSPLIT = {MACC_KSPLIT};")
    w(f"constexpr int THREADS = {THREADS};")
    w("")
    for mi, m in enumerate(plan.maccs):
        wi = cidx[m.w]
        wt = "int8_t" if m.int8 else "float"
        w(f"// macc {m.name}: [B, {m.k}] x {m.w} [{m.k}, {m.n}]"
          f"{' per step' if m.per_step else ''}{f' int8 ({m.int8})' if m.int8 else ''}"
          f"{f' + {m.bias}' if m.bias else ''}")
        w(f"__global__ void __launch_bounds__(THREADS) macc_{mi}(Args a, int rows) {{")
        w(f"  extern __shared__ float xs[];  // [rows, {m.k}] input rows")
        w(f"  __shared__ float part[MACC_KSPLIT][{m.rows}][MACC_COLS];")
        w("  const int tid = threadIdx.x;")
        w("  const int lane = tid % MACC_COLS;")
        w("  const int ks = tid / MACC_COLS;")
        w("  const int b0 = blockIdx.y * rows;")
        w("  const int nb = min(rows, a.B - b0);")
        w(f"  for (int i = tid; i < nb * {m.k}; i += THREADS) {{")
        w(f"    const int r = i / {m.k};")
        w(f"    xs[i] = v_{idx[m.x]}(a, b0 + r, i - r * {m.k});")
        w("  }")
        w("  __syncthreads();")
        w(f"  float acc[{m.rows}];")
        w("#pragma unroll")
        w(f"  for (int r = 0; r < {m.rows}; ++r) acc[r] = 0.0f;")
        w("  const int col = blockIdx.x * MACC_COLS + lane;")
        w(f"  if (col < {m.n}) {{")
        page = f" + (size_t)a.t * {m.k * m.n}" if m.per_step else ""
        w(f"    const {wt}* wp = static_cast<const {wt}*>(a.c[{wi}]){page} + col;")
        if m.int8 == "shared":
            w(f"    const float sc = a.cs[{wi}][col];")
        w("#pragma unroll 4")
        w(f"    for (int k = ks; k < {m.k}; k += MACC_KSPLIT) {{")
        if m.int8 == "shared":
            w(f"      const float wk = (float)__ldg(wp + (size_t)k * {m.n}) * sc;")
        elif m.int8 == "per_step":
            w(f"      const float wk = (float)__ldg(wp + (size_t)k * {m.n});")
        else:
            w(f"      const float wk = __ldg(wp + (size_t)k * {m.n});")
        w("#pragma unroll")
        w(f"      for (int r = 0; r < {m.rows}; ++r)")
        w(f"        if (r < nb) acc[r] = fmaf(xs[r * {m.k} + k], wk, acc[r]);")
        w("    }")
        w("  }")
        w("#pragma unroll")
        w(f"  for (int r = 0; r < {m.rows}; ++r) part[ks][r][lane] = acc[r];")
        w("  __syncthreads();")
        w("  if (tid < nb * MACC_COLS) {")
        w("    const int r = tid / MACC_COLS;")
        w("    const int c = blockIdx.x * MACC_COLS + tid % MACC_COLS;")
        w(f"    if (c < {m.n}) {{")
        w("      float s = 0.0f;")
        w("#pragma unroll")
        w("      for (int q = 0; q < MACC_KSPLIT; ++q) s += part[q][r][tid % MACC_COLS];")
        if m.int8 == "per_step":
            w(f"      s *= a.cs[{wi}][(size_t)a.t * {m.n} + c];")
        if m.bias is not None:
            w(f"      s += v_{idx[m.bias]}(a, b0 + r, c);")
        w(f"      a.m[{mi}][(size_t)(b0 + r) * {m.n} + c] = s;")
        w("    }")
        w("  }")
        w("}")
        w("")

    # -- register write-back and output ------------------------------------
    w("// every register's next value into its ping-pong buffer, and y[:, t, :]")
    w(f"__global__ void __launch_bounds__({UPDATE_THREADS}) update(Args a) {{")
    w("  const int l = blockIdx.x * blockDim.x + threadIdx.x;")
    w("  for (int b = blockIdx.y; b < a.B; b += gridDim.y) {")
    for s, src in plan.updates:
        sw = swidth[s]
        w(f"    if (l < {sw}) a.sn[{sidx[s]}][(size_t)b * {sw} + l] = v_{idx[src]}(a, b, l);")
    if plan.output is not None:
        w(f"    if (l < {OW}) a.y[((size_t)b * a.T + a.t) * {OW} + l] = "
          f"v_{idx[plan.output]}(a, b, l);")
    w("  }")
    w("}")
    w("")
    w("}  // namespace")
    w("")

    # -- host loop ---------------------------------------------------------
    w('extern "C" {')
    w("")
    w("// bufs: device pointers in the order of codegen.cuda_emit.buffer_layout.")
    w("// Launches on `stream`, does not synchronise; returns the cudaError_t of")
    w("// the first launch that failed, or 0.")
    w("int run_stage(void** bufs, int B, int T, int n_lut, void* stream_ptr) {")
    w("  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);")
    w(f"  if (B < 1 || T < 1 || n_lut < {1 if plan.lut else 0}) return cudaErrorInvalidValue;")
    w("  Args a = {};")
    w("  int i = 0;")
    if plan.input is not None:
        w("  a.u = static_cast<const float*>(bufs[i++]);")
    for j in range(NC):
        w(f"  a.c[{j}] = bufs[i++];")
    for name in plan.int8:
        w(f"  a.cs[{cidx[name]}] = static_cast<const float*>(bufs[i++]);")
    w(f"  const float* x0[{max(NS, 1)}];")
    w(f"  float* fin[{max(NS, 1)}];")
    w(f"  float* scr[{max(NS, 1)}];")
    w(f"  for (int j = 0; j < {NS}; ++j) x0[j] = static_cast<const float*>(bufs[i++]);")
    if plan.lut:
        w("  a.lut = static_cast<const float*>(bufs[i++]);")
        w("  a.lut1 = static_cast<const float*>(bufs[i++]);")
        w("  a.n_lut = n_lut;")
    if plan.output is not None:
        w("  a.y = static_cast<float*>(bufs[i++]);")
    w(f"  for (int j = 0; j < {NS}; ++j) fin[j] = static_cast<float*>(bufs[i++]);")
    w(f"  for (int j = 0; j < {NS}; ++j) scr[j] = static_cast<float*>(bufs[i++]);")
    w(f"  for (int j = 0; j < {NM}; ++j) a.m[j] = static_cast<float*>(bufs[i++]);")
    w("  a.B = B;")
    w("  a.T = T;")
    w(f"  const size_t width[{max(NS, 1)}] = {{{', '.join(str(x) for _, x in plan.states) or '0'}}};")
    w("  cudaError_t err;")
    for mi, m in enumerate(plan.maccs):
        w(f"  const int rows_{mi} = B < {m.rows} ? B : {m.rows};")
        w(f"  const size_t smem_{mi} = (size_t)rows_{mi} * {m.k} * sizeof(float);")
        w(f"  const dim3 grid_{mi}({-(-m.n // MACC_COLS)}, (B + rows_{mi} - 1) / rows_{mi});")
        # above 48 KB in all (the static `part` included) a launch needs the opt-in
        static = 4 * MACC_KSPLIT * m.rows * MACC_COLS
        w(f"  if (smem_{mi} + {static} > 48 * 1024) {{")
        w(f"    err = cudaFuncSetAttribute(macc_{mi}, "
          "cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_" f"{mi});")
        w("    if (err != cudaSuccess) return err;")
        w("  }")
    w(f"  const dim3 ugrid({-(-max_w // UPDATE_THREADS)}, B < 65535 ? B : 65535);")
    w("  for (int t = 0; t < T; ++t) {")
    w("    a.t = t;")
    w(f"    for (int j = 0; j < {NS}; ++j) {{")
    w("      const size_t page = (size_t)B * width[j];")
    w("      a.s[j] = t == 0 ? x0[j] : scr[j] + ((t - 1) & 1) * page;")
    w("      a.sn[j] = t == T - 1 ? fin[j] : scr[j] + (t & 1) * page;")
    w("    }")
    for mi, m in enumerate(plan.maccs):
        w(f"    macc_{mi}<<<grid_{mi}, THREADS, smem_{mi}, stream>>>(a, rows_{mi});")
        w("    err = cudaGetLastError();")
        w("    if (err != cudaSuccess) return err;")
    w(f"    update<<<ugrid, {UPDATE_THREADS}, 0, stream>>>(a);")
    w("    err = cudaGetLastError();")
    w("    if (err != cudaSuccess) return err;")
    w("  }")
    w("  return 0;")
    w("}")
    w("")
    w("const char* stage_error_string(int code) {")
    w("  return cudaGetErrorString(static_cast<cudaError_t>(code));")
    w("}")
    w("")
    w('}  // extern "C"')
    return "\n".join(L) + "\n"


__all__ = ["MACC_COLS", "MACC_KSPLIT", "buffer_layout", "emit"]
