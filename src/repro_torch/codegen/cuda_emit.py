"""Emission: a lowered :class:`~repro_torch.codegen.lower.Plan` → the CUDA C++
source of one generated stage kernel for Hopper (``sm_90a``).

This replaces the TPU kernel that ``repro/codegen/pallas_backend.py::
compile_stage`` generates: the scheduled datapath of one stage, run for T
steps with the state registers carried across steps.  As the Verilog
emitter writes the paper's Table-I modules for the FPGA, this writes, for
the card:

* one ``__device__`` lane function per graph node (``v_<i>``: the node's
  value at batch row ``b``, step ``t`` and lane ``l``), in topological order;
* one ``__global__`` GEMM per hoisted or split macc (``hoist_<j>``, the
  tiled fp32 GEMM of ``kernels/csrc/gemm.cuh``): its input-only rows of W
  over all ``B·T`` rows, reading its input row as a lane function, into a
  ``[B, T, n]`` pre-activation buffer (the bias added when it moved too);
* one persistent cooperative ``__global__ stage_persistent`` that runs all
  T steps.  Per step, in topological order: each macc the step computes
  (split or recurrent) over the block's column tiles of 32 columns × 8
  warps splitting the contraction, with the step's input rows staged in
  shared memory and the partial sums meeting in shared memory before the
  pre-activation, the bias and the write to the macc's ``[B, n]`` buffer;
  then the update phase (every register into its ping-pong buffer, and
  ``y[:, t]``).  A grid barrier (``kernels/csrc/grid_barrier.cuh``) stands
  wherever a phase reads a macc buffer written since the last one
  (:func:`barrier_plan`: before a macc that reads an earlier macc of the
  step, before the update), and after the update;
* ``run_stage``, a host function with one fixed C signature for every
  generated library, ``int run_stage(void** bufs, int B, int T, int n_lut,
  void* stream)``: the hoisting GEMMs, then the persistent kernel through
  ``cudaLaunchCooperativeKernel``, on ``stream``; it checks every launch's
  ``cudaError_t``, waits for the stream to read the barrier's error word,
  and returns the first failure (0 on success, ``GRID_BARRIER_TIMEOUT`` for
  a barrier past its deadline).  ``stage_config`` and
  ``stage_serial_floor`` report the launch configuration and run the empty
  chain of barriers (the serial floor), for reports.

``bufs`` holds device pointers in the order :func:`buffer_layout` gives.

What bounds it on this card.  Step t+1 needs all of step t's registers, so
the T steps form a chain; at serving batch sizes each step's arithmetic
(``2·B·Σ k·n`` FLOPs over the step's rows of W) is far too small to fill
the card, and a step costs what the chain costs: its grid-wide exchanges
(:func:`barrier_plan`), about a microsecond each, plus reading the step's
rows of W.
So the design keeps both small.  The rows of W that read only the input do
not recur, and run as one GEMM before the loop (the input half of lstm's
``[D+H, 4H]`` ROM, all of gru's ``zx``).  The grid is one block per column
tile of the widest step macc, never more than the card has SMs; when every
block's column slices of the step's shared ROMs fit in its shared memory
beside the staged rows, they are loaded there once, before step 0, and a
step reads only the registers (from L2).  :func:`residency` makes that
choice, once, for the card the source is emitted for, and the emitter
writes it into the source as constants: the C++ only checks, at its first
launch on a device, that the card holds the grid at that shared memory.
A stage whose slices do not fit reads them from global memory in the same
kernel; int8 shared ROMs stay resident as codes and are dequantised as
read; per-step pages (the MLP) are read from global memory at their step.
The contraction is plain FMA (no tensor cores, no TF32), so the fp32
results hold against the plain version to rounding.  Not done here, and
left for later work: ``wgmma``/TMA with a stated tolerance, prefetching the
next step's pages.

Buffers the persistent kernel both writes and reads across blocks (the
register ping-pong buffers, the macc buffers) are read with plain loads,
never through ``const __restrict__`` or ``__ldg``; only the weights, the
input and the pre-activations, which no block writes during the launch, use
the read-only path.
"""

from __future__ import annotations

from .lower import Plan

MACC_COLS = 32      # output columns per tile: one warp's lanes
MACC_KSPLIT = 8     # warps sharing the contraction
THREADS = MACC_COLS * MACC_KSPLIT
H100_SMS = 132
H100_SMEM_OPTIN = 232_448   # 227 KiB: the most dynamic shared memory a block can opt in to


def buffer_layout(plan: Plan) -> list[tuple[str, str]]:
    """The ``bufs`` array of ``run_stage``, as ``(role, name)`` pairs:
    the input ``u [B, T, D]``; every const ROM (fp32, or int8 codes); the
    ``.scale`` companion of every int8 ROM; each register's ``x0 [B, w]``;
    the LUT and its shifted partner (LUT plans); ``y [B, T, out]``; each
    register's final value ``[B, w]``; each register's ping-pong scratch
    ``[2, B, w]``; each macc's buffer ``[B, n]``; each hoisted or split
    macc's pre-activations ``[B, T, n]``; the grid barrier's words."""
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
    out += [("pre", m.name) for m in plan.maccs if m.hoist is not None]
    out.append(("barrier", "barrier"))
    return out


def _step_maccs(plan: Plan):
    return [m for m in plan.maccs if m.kind != "hoisted"]


def _padded(m) -> int:
    """The macc's step rows rounded up to a multiple of 4 (the staged rows and
    the resident slices are read four k at a time; the pad is zero)."""
    k0, k1 = m.step_rows
    return -(-(k1 - k0) // 4) * 4


def _geometry(plan: Plan) -> dict:
    """What the persistent kernel's launch configuration depends on."""
    step = _step_maccs(plan)
    res = [m for m in step if not m.per_step]
    return dict(
        rows=min([m.rows for m in step] or [1]),
        kmax=max([_padded(m) for m in step] or [4]),
        max_tiles=max([-(-m.n // MACC_COLS) for m in step] or [1]),
        max_w=max([w for _, w in plan.states] + [plan.out_width]),
        # (tiles, step rows, bytes per element) of each ROM that may be resident
        slices=[(-(-m.n // MACC_COLS), _padded(m), 1 if m.int8 else 4) for m in res],
    )


def residency(plan: Plan, sm_count: int = H100_SMS,
              smem_limit: int = H100_SMEM_OPTIN) -> dict:
    """The persistent kernel's grid, and whether its weight slices are
    resident, on a card of ``sm_count`` SMs with ``smem_limit`` bytes of
    shared memory a block: the one place this is decided (``emit`` writes
    the result into the source).

    The grid is one block per column tile of the widest step macc (or per
    256 lanes of one row tile's update, if more), at most one per SM; each
    block holds ``ceil(tiles / grid)`` column slices of every shared ROM the
    step reads, and the slices are resident when they fit beside the staged
    input rows (one row tile) and the static partial-sum tile.  Returns
    ``grid``, ``weights_resident``, ``smem_bytes`` (dynamic) and
    ``static_bytes`` (the ``part`` tile, and the barrier's flag, which
    ``nvcc`` pads to 16 bytes)."""
    g = _geometry(plan)
    static = 4 * MACC_KSPLIT * g["rows"] * MACC_COLS + 16
    xs = 4 * g["rows"] * g["kmax"]
    want = max(g["max_tiles"], -(-g["rows"] * g["max_w"] // THREADS))
    grid = min(want, sm_count)
    slices = sum(-(-tiles // grid) * k * MACC_COLS * es for tiles, k, es in g["slices"])
    resident = bool(g["slices"]) and static + xs + slices <= smem_limit
    return {"grid": grid, "weights_resident": resident,
            "smem_bytes": xs + (slices if resident else 0), "static_bytes": static}


def barrier_plan(plan: Plan) -> dict:
    """Where the persistent kernel's grid barriers stand in a step.

    A phase must wait for the grid when it reads a macc buffer that another
    block may have written since the last barrier: a step macc whose input
    row or bias reads an earlier step macc (``before[name]``), and the
    update when it reads one (``before_update``).  One more barrier closes
    every step but the last (the next step reads the registers).  Returns
    those and ``per_step``, the barriers a step runs."""
    step = _step_maccs(plan)
    names = {m.name for m in step}
    hoisted = {m.name: m for m in plan.maccs if m.kind == "hoisted"}
    g = plan.graph
    memo: dict[str, frozenset] = {}

    def reads(name: str | None) -> frozenset:
        """The step macc buffers the lane function ``name`` loads."""
        if name is None:
            return frozenset()
        if name not in memo:
            n = g.node(name)
            if name in names:
                out = frozenset([name])
            elif name in hoisted:
                m = hoisted[name]
                out = reads(None if m.bias_hoisted else m.bias)
            elif n.op in ("input", "state", "const"):
                out = frozenset()
            else:
                out = frozenset().union(*(reads(i) for i in n.inputs))
            memo[name] = out
        return memo[name]

    before, pending = {}, set()
    for m in step:
        before[m.name] = bool(pending & (reads(m.x) | reads(None if m.bias_hoisted else m.bias)))
        if before[m.name]:
            pending = set()
        pending.add(m.name)
    tail = [src for _, src in plan.updates] + ([plan.output] if plan.output else [])
    before_update = bool(pending & frozenset().union(*(reads(x) for x in tail)))
    return {"before": before, "before_update": before_update,
            "per_step": sum(before.values()) + before_update + 1}


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


def emit(plan: Plan, sm_count: int = H100_SMS, smem_limit: int = H100_SMEM_OPTIN) -> str:
    """The CUDA C++ text of the plan's stage kernel for a card of
    ``sm_count`` SMs and ``smem_limit`` bytes of opt-in shared memory a
    block (deterministic: the same arguments always give the same text, so
    the build cache keys on it)."""
    g = plan.graph
    idx = {n.name: i for i, n in enumerate(g.nodes)}
    cidx = {n.name: i for i, n in enumerate(plan.consts)}
    sidx = {s: i for i, (s, _) in enumerate(plan.states)}
    swidth = dict(plan.states)
    midx = {m.name: i for i, m in enumerate(plan.maccs)}
    hoisted = {m.name: m for m in plan.maccs if m.kind == "hoisted"}
    weight_only = {m.w for m in plan.maccs} - {
        i for n in g.nodes for j, i in enumerate(n.inputs) if not (n.op == "macc" and j == 1)}
    NS, NC, NM = len(plan.states), len(plan.consts), len(plan.maccs)
    D = plan.input[1] if plan.input is not None else 0
    OW = plan.out_width
    geo = _geometry(plan)
    cfg = residency(plan, sm_count, smem_limit)
    bars = barrier_plan(plan)
    step = _step_maccs(plan)
    R, KMAX, MAXW = geo["rows"], geo["kmax"], geo["max_w"]
    GRID, RESIDENT = cfg["grid"], cfg["weights_resident"]

    L = []
    w = L.append
    summary = ", ".join(f"{n.name}:{n.op}" for n in g.nodes)
    w("// Generated by repro_torch.codegen.cuda_emit from a datapath graph; do not edit.")
    w(f"// nodes: {summary}")
    w(f"// registers: {', '.join(f'{s}[{x}]' for s, x in plan.states)}; "
      f"output: {plan.output or '-'}[{OW}]; lut: {int(plan.lut)}; "
      f"int8: {', '.join(plan.int8) or '-'}")
    w(f"// maccs: {', '.join(f'{m.name}:{m.kind}' for m in plan.maccs) or '-'}")
    w("#include <cuda_runtime.h>")
    w("#include <stddef.h>")
    w("#include <stdint.h>")
    w("")
    w("#include <atomic>")
    w("")
    w('#include "gemm.cuh"')
    w('#include "grid_barrier.cuh"')
    w('#include "lut.cuh"')
    w("")
    w("namespace {")
    w("")
    w("struct Args {")
    w("  const float* u;            // [B, T, D] (null without an input node)")
    w(f"  const void* c[{max(NC, 1)}];          // const ROMs: fp32, or int8 codes")
    w(f"  const float* cs[{max(NC, 1)}];        // per-channel scales of int8 ROMs")
    w(f"  const float* x0[{max(NS, 1)}];        // registers at step 0")
    w(f"  float* fin[{max(NS, 1)}];             // registers after step T - 1")
    w(f"  float* scr[{max(NS, 1)}];             // ping-pong scratch [2, B, w]")
    w(f"  const float* s[{max(NS, 1)}];         // registers this step reads")
    w(f"  float* sn[{max(NS, 1)}];              // registers this step writes")
    w(f"  float* m[{max(NM, 1)}];               // macc buffers [B, n], written every step")
    w(f"  float* pre[{max(NM, 1)}];             // hoisted pre-activations [B, T, n]")
    w("  float* y;                  // [B, T, out]")
    w("  const float* lut;")
    w("  const float* lut1;")
    w("  GridBarrier* bar;")
    w("  int n_lut;")
    w("  int B, T;")
    w("};")
    w("")

    # -- lane functions ----------------------------------------------------
    def call(name: str, b: str = "b", t: str = "t", lane: str = "l") -> str:
        return f"v_{idx[name]}(a, {b}, {t}, {lane})"

    for n in g.nodes:
        if n.op == "const" and n.name in weight_only:
            continue
        w(f"// {n.name} ({n.op}, {n.width} lanes)")
        w(f"__device__ __forceinline__ float v_{idx[n.name]}(const Args& a, int b, int t, int l) {{")
        if n.op == "input":
            w(f"  return __ldg(a.u + ((size_t)b * a.T + t) * {D} + l);")
        elif n.op == "state":
            w(f"  return a.s[{sidx[n.name]}][(size_t)b * {swidth[n.name]} + l];")
        elif n.op == "const":
            off = f"(size_t)t * {n.width} + l" if n.attr("per_step") else "l"
            w(f"  return __ldg(static_cast<const float*>(a.c[{cidx[n.name]}]) + {off});")
        elif n.op == "macc" and n.name in hoisted:
            m = hoisted[n.name]
            v = f"__ldg(a.pre[{midx[m.name]}] + ((size_t)b * a.T + t) * {m.n} + l)"
            if m.bias is not None and not m.bias_hoisted:
                v += f" + {call(m.bias)}"
            w(f"  return {v};")
        elif n.op == "macc":
            w(f"  return a.m[{midx[n.name]}][(size_t)b * {n.width} + l];")
        elif n.op == "af":
            w(f"  const float v = {call(n.inputs[0])};")
            w(f"  return {_act(n.attr('fn'), 'v', plan.lut)};")
        elif n.op == "slice":
            start = n.attr("start")
            w(f"  return {call(n.inputs[0], lane=f'l + {start}')};")
        elif n.op == "concat":
            off = 0
            for j, part in enumerate(n.inputs):
                pw = g.node(part).width
                c = call(part, lane=f"l - {off}")
                if j < len(n.inputs) - 1:
                    w(f"  if (l < {off + pw}) return {c};")
                else:
                    w(f"  return {c};")
                off += pw
        else:
            sym = {"add": "+", "sub": "-", "mul": "*"}[n.op]
            w(f"  return {call(n.inputs[0])} {sym} {call(n.inputs[1])};")
        w("}")
        w("")

    # -- one GEMM per hoisted or split macc --------------------------------
    for m in plan.maccs:
        if m.hoist is None:
            continue
        j, wi = midx[m.name], cidx[m.w]
        r0, r1 = m.hoist
        wt = "int8_t" if m.int8 else "float"
        sc = f"a.cs[{wi}]" if m.int8 else "nullptr"
        w(f"// {m.name} ({m.kind}): pre[b, t, :] = x(b, t, {r0}:{r1}) @ {m.w}[{r0}:{r1}, :]"
          f"{f' + {m.bias}' if m.bias_hoisted else ''}, one GEMM over all B*T rows")
        w(f"__global__ void __launch_bounds__(gemm::THREADS) hoist_{j}(Args a) {{")
        w(f"  const {wt}* w = static_cast<const {wt}*>(a.c[{wi}]) + (size_t){r0} * {m.n};")
        w(f"  const float* sc = {sc};")
        w(f"  float* pre = a.pre[{j}];")
        w(f"  gemm::tile(a.B * a.T, {m.n}, {r1 - r0},")
        w("      [&](int m, int k) {")
        w("        const int b = m / a.T;")
        w(f"        return {call(m.x, t='m - b * a.T', lane=f'{r0} + k')};")
        w("      },")
        w(f"      [&](int k, int n) {{ return gemm::rom(w, (size_t)k * {m.n} + n, sc, n); }},")
        w("      [&](int m, int n, float acc) {")
        if m.bias_hoisted:
            w("        const int b = m / a.T;")
            w(f"        acc += {call(m.bias, t='m - b * a.T', lane='n')};")
        w(f"        pre[(size_t)m * {m.n} + n] = acc;")
        w("      });")
        w("}")
        w("")

    # -- the persistent kernel ---------------------------------------------
    w(f"constexpr int MACC_COLS = {MACC_COLS};")
    w(f"constexpr int MACC_KSPLIT = {MACC_KSPLIT};")
    w(f"constexpr int THREADS = {THREADS};")
    w(f"constexpr int ROWS = {R};        // batch rows per row tile")
    w(f"constexpr int KMAX = {KMAX};      // widest row range a step stages, padded to 4")
    w(f"constexpr int MAXW = {MAXW};      // widest register or output")
    w(f"// codegen.cuda_emit.residency for {sm_count} SMs and {smem_limit} bytes a block:")
    w(f"constexpr int GRID = {GRID};")
    w(f"constexpr int RESIDENT = {int(RESIDENT)};   // the step's shared ROM slices in shared memory")
    w(f"constexpr int SMEM = {cfg['smem_bytes']};   // dynamic shared memory, bytes")
    w(f"constexpr int BARRIERS_PER_STEP = {bars['per_step']};   // codegen.cuda_emit.barrier_plan")
    w("")
    w("// One ROM element as fp32: an int8 code times its scale (1 for per-step")
    w("// pages, which are rescaled after the sum).")
    w("__device__ __forceinline__ float widen(float w, float) { return w; }")
    w("__device__ __forceinline__ float widen(int8_t w, float sc) { return (float)w * sc; }")
    w("__device__ __forceinline__ float4 widen(float4 w, float) { return w; }")
    w("__device__ __forceinline__ float4 widen(char4 w, float sc) {")
    w("  return make_float4((float)w.x * sc, (float)w.y * sc, (float)w.z * sc, (float)w.w * sc);")
    w("}")
    w("")
    w("// acc[r] += sum_k xs[r, k] * w[k, col] over warp ks's contiguous share of k,")
    w("// for NB rows (a compile-time count: the loop issues only its loads and")
    w("// FMAs).  A resident slice is laid out [kp / 4][MACC_COLS][4]: one load")
    w("// gives a thread four k of its column, conflict-free across the warp, and")
    w("// the staged rows are read four k at a time as broadcasts.")
    w("template <int NB, typename W4>")
    w("__device__ __forceinline__ void dot_resident(const float* xs, int kp, const W4* w4, int ks,")
    w("                                             float sc, float* acc) {")
    w("  const int k4 = kp / 4;")
    w("  const int per = (k4 + MACC_KSPLIT - 1) / MACC_KSPLIT;")
    w("  const int q1 = min(ks * per + per, k4);")
    w("#pragma unroll 2")
    w("  for (int q = ks * per; q < q1; ++q) {")
    w("    const float4 w = widen(w4[(size_t)q * MACC_COLS], sc);")
    w("#pragma unroll")
    w("    for (int r = 0; r < NB; ++r) {")
    w("      const float4 x = reinterpret_cast<const float4*>(xs + (size_t)r * kp)[q];")
    w("      acc[r] = fmaf(x.x, w.x, acc[r]);")
    w("      acc[r] = fmaf(x.y, w.y, acc[r]);")
    w("      acc[r] = fmaf(x.z, w.z, acc[r]);")
    w("      acc[r] = fmaf(x.w, w.w, acc[r]);")
    w("    }")
    w("  }")
    w("}")
    w("")
    w("// The same sum with W read from global memory (column pointer wp, row")
    w("// stride ld), k = ks, ks + MACC_KSPLIT, ...")
    w("template <int NB, typename WT>")
    w("__device__ __forceinline__ void dot_global(const float* xs, int kp, int kr, const WT* wp,")
    w("                                           int ld, int ks, float sc, float* acc) {")
    w("#pragma unroll 4")
    w("  for (int k = ks; k < kr; k += MACC_KSPLIT) {")
    w("    const float w = widen(__ldg(wp + (size_t)k * ld), sc);")
    w("#pragma unroll")
    w("    for (int r = 0; r < NB; ++r) acc[r] = fmaf(xs[(size_t)r * kp + k], w, acc[r]);")
    w("  }")
    w("}")
    w("")

    def dispatch(call_fmt: str, indent: str) -> None:
        w(f"{indent}switch (nb) {{")
        for n_rows in range(1, R + 1):
            w(f"{indent}  case {n_rows}: {call_fmt.format(n=n_rows)}; break;")
        w(f"{indent}}}")

    w("// Dynamic shared memory: [the resident column slices of each shared ROM")
    w("// the step reads, when RESIDENT] [staged input rows: ROWS x KMAX].")
    w("__global__ void __launch_bounds__(THREADS) stage_persistent(Args args) {")
    w("  extern __shared__ __align__(16) unsigned char smem[];")
    w("  __shared__ float part[MACC_KSPLIT][ROWS][MACC_COLS];")
    w("  Args a = args;")
    w("  const int tid = threadIdx.x;")
    w("  const int lane = tid % MACC_COLS;")
    w("  const int ks = tid / MACC_COLS;")
    w("  const int rows = min(a.B, ROWS);")
    res_off = {}
    off = 0
    if RESIDENT:
        for m in step:
            if m.per_step:
                continue
            res_off[m.name] = off
            off += -(-(-(-m.n // MACC_COLS)) // GRID) * _padded(m) * MACC_COLS * (1 if m.int8 else 4)
    w(f"  float* xs = reinterpret_cast<float*>(smem + {off});")
    if res_off:
        w("  // every block's column slices, once, before step 0")
        for m in step:
            if m.name not in res_off:
                continue
            j, wi = midx[m.name], cidx[m.w]
            k0, k1 = m.step_rows
            kp = _padded(m)
            wt = "int8_t" if m.int8 else "float"
            w("  {")
            w(f"    {wt}* ws = reinterpret_cast<{wt}*>(smem + {res_off[m.name]});")
            w(f"    const {wt}* w = static_cast<const {wt}*>(a.c[{wi}]) + (size_t){k0} * {m.n};")
            w("    int lt = 0;")
            w(f"    for (int tile = blockIdx.x; tile < {-(-m.n // MACC_COLS)}; "
              "tile += gridDim.x, ++lt)")
            w(f"      for (int i = tid; i < {kp} * MACC_COLS; i += THREADS) {{   // i = (q, c, e)")
            w("        const int e = i % 4;")
            w("        const int c = tile * MACC_COLS + i / 4 % MACC_COLS;")
            w("        const int k = i / (4 * MACC_COLS) * 4 + e;")
            w(f"        ws[(size_t)lt * {kp} * MACC_COLS + i] = "
              f"c < {m.n} && k < {k1 - k0} ? __ldg(w + (size_t)k * {m.n} + c) : ({wt})0;")
            w("      }")
            w("  }")
    w("")
    w("  for (int t = 0; t < a.T; ++t) {")
    for s_, sw in plan.states:
        i = sidx[s_]
        w(f"    a.s[{i}] = t == 0 ? a.x0[{i}] : a.scr[{i}] + ((t - 1) & 1) * (size_t)a.B * {sw};")
        w(f"    a.sn[{i}] = t == a.T - 1 ? a.fin[{i}] : a.scr[{i}] + (t & 1) * (size_t)a.B * {sw};")
    for m in step:
        j, wi = midx[m.name], cidx[m.w]
        k0, k1 = m.step_rows
        kr, kp = k1 - k0, _padded(m)
        tiles = -(-m.n // MACC_COLS)
        wt = "int8_t" if m.int8 else "float"
        w("")
        if bars["before"][m.name]:
            w("    // its row reads a macc of this step that other blocks wrote")
            w("    if (!grid_sync(a.bar)) return;")
        w(f"    // macc {m.name} ({m.kind}): buf = x(b, t, {k0}:{k1}) @ {m.w}[{k0}:{k1}, :]"
          f"{' (page t)' if m.per_step else ''}{f' int8 ({m.int8})' if m.int8 else ''}"
          f"{' + pre' if m.hoist is not None else ''}"
          f"{f' + {m.bias}' if m.bias is not None and not m.bias_hoisted else ''}")
        w("    for (int b0 = 0; b0 < a.B; b0 += rows) {")
        w("      const int nb = min(rows, a.B - b0);")
        w("      __syncthreads();   // xs of the previous rows is no longer read")
        w(f"      for (int i = tid; i < nb * {kp}; i += THREADS) {{")
        w(f"        const int r = i / {kp};")
        w(f"        const int k = i - r * {kp};")
        w(f"        xs[i] = k < {kr} ? {call(m.x, b='b0 + r', lane=f'{k0} + k')} : 0.0f;")
        w("      }")
        w("      __syncthreads();")
        w("      int lt = 0;")
        w(f"      for (int tile = blockIdx.x; tile < {tiles}; tile += gridDim.x, ++lt) {{")
        if m.hoist is not None:   # independent of the step's rows: in flight meanwhile
            w("        const int pc = tile * MACC_COLS + tid % MACC_COLS;")
            w(f"        const float pre_v = tid < nb * MACC_COLS && pc < {m.n} ? __ldg(a.pre[{j}] + "
              f"((size_t)(b0 + tid / MACC_COLS) * a.T + t) * {m.n} + pc) : 0.0f;")
        w("        float acc[ROWS];")
        w("#pragma unroll")
        w("        for (int r = 0; r < ROWS; ++r) acc[r] = 0.0f;")
        w("        const int col = tile * MACC_COLS + lane;")
        w(f"        if (col < {m.n}) {{")
        w(f"          const float sc = {f'__ldg(a.cs[{wi}] + col)' if m.int8 == 'shared' else '1.0f'};")
        page = f" + (size_t)t * {m.k * m.n}" if m.per_step else ""
        glob = f"dot_global<{{n}}>(xs, {kp}, {kr}, wp, {m.n}, ks, sc, acc)"
        if m.name in res_off:
            w4 = "char4" if m.int8 else "float4"
            w(f"          const {w4}* w4 = reinterpret_cast<const {w4}*>(smem + {res_off[m.name]}) "
              f"+ (size_t)lt * {kp // 4} * MACC_COLS + lane;")
            dispatch(f"dot_resident<{{n}}>(xs, {kp}, w4, ks, sc, acc)", "          ")
        else:
            w(f"          const {wt}* wp = static_cast<const {wt}*>(a.c[{wi}]){page} + "
              f"(size_t){k0} * {m.n} + col;")
            dispatch(glob, "          ")
        w("        }")
        w("#pragma unroll")
        w("        for (int r = 0; r < ROWS; ++r) part[ks][r][lane] = acc[r];")
        w("        __syncthreads();")
        w("        if (tid < nb * MACC_COLS) {")
        w("          const int r = tid / MACC_COLS;")
        w("          const int c = tile * MACC_COLS + tid % MACC_COLS;")
        w(f"          if (c < {m.n}) {{")
        w("            float s = 0.0f;")
        w("#pragma unroll")
        w("            for (int q = 0; q < MACC_KSPLIT; ++q) s += part[q][r][tid % MACC_COLS];")
        if m.int8 == "per_step":
            w(f"            s *= __ldg(a.cs[{wi}] + (size_t)t * {m.n} + c);")
        if m.hoist is not None:
            w("            s += pre_v;")
        if m.bias is not None and not m.bias_hoisted:
            w(f"            s += {call(m.bias, b='b0 + r', lane='c')};")
        w(f"            a.m[{j}][(size_t)(b0 + r) * {m.n} + c] = s;")
        w("          }")
        w("        }")
        w("        __syncthreads();   // part is rewritten by the next tile")
        w("      }")
        w("    }")
    if bars["before_update"]:
        w("    if (!grid_sync(a.bar)) return;   // the update reads the macc buffers")
    w("")
    w("    // every register's next value into its ping-pong buffer, and y[:, t, :]")
    w("    for (int i = blockIdx.x * THREADS + tid; i < a.B * MAXW; i += gridDim.x * THREADS) {")
    w("      const int b = i / MAXW;")
    w("      const int l = i - b * MAXW;")
    for s, src in plan.updates:
        sw = swidth[s]
        w(f"      if (l < {sw}) a.sn[{sidx[s]}][(size_t)b * {sw} + l] = {call(src)};")
    if plan.output is not None:
        w(f"      if (l < {OW}) a.y[((size_t)b * a.T + t) * {OW} + l] = {call(plan.output)};")
    w("    }")
    w("    if (t + 1 < a.T && !grid_sync(a.bar)) return;")
    w("  }")
    w("}")
    w("")

    # -- the card's check of the configuration ------------------------------
    w("// Before the first launch on a device: the opt-in covers SMEM (refused")
    w("// when the static part and SMEM exceed the card's limit) and the card")
    w("// holds GRID blocks at once.  Checked once a device.")
    w("cudaError_t stage_ready_() {")
    w("  static std::atomic<unsigned long long> ready{0};   // a bit per device")
    w("  int dev = 0, sms = 0, per_sm = 0;")
    w("  cudaError_t err = cudaGetDevice(&dev);")
    w("  if (err != cudaSuccess) return err;")
    w("  if (dev < 64 && (ready.load() >> dev & 1)) return cudaSuccess;")
    w("  // the opt-in before the occupancy query, which reads it")
    w("  err = cudaFuncSetAttribute(stage_persistent, cudaFuncAttributeMaxDynamicSharedMemorySize,")
    w("                             SMEM);")
    w("  if (err != cudaSuccess) return err;")
    w("  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stage_persistent, THREADS, SMEM);")
    w("  if (err != cudaSuccess) return err;")
    w("  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);")
    w("  if (err != cudaSuccess) return err;")
    w("  if ((long long)per_sm * sms < GRID) return cudaErrorCooperativeLaunchTooLarge;")
    w("  if (dev < 64) ready.fetch_or(1ull << dev);")
    w("  return cudaSuccess;")
    w("}")
    w("")
    w("}  // namespace")
    w("")

    # -- host function -----------------------------------------------------
    w('extern "C" {')
    w("")
    w("// bufs: device pointers in the order of codegen.cuda_emit.buffer_layout.")
    w("// Launches on `stream`: the hoisting GEMMs, then the persistent kernel")
    w("// (cooperative); then waits for the stream to read the barrier's error")
    w("// word.  Returns the cudaError_t of the first call that failed,")
    w("// GRID_BARRIER_TIMEOUT (-1) for a barrier past its deadline, or 0.")
    w("int run_stage(void** bufs, int B, int T, int n_lut, void* stream_ptr) {")
    w("  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);")
    w(f"  if (B < 1 || T < 1 || n_lut < {1 if plan.lut else 0}) return cudaErrorInvalidValue;")
    w("  if (((long long)B * T + gemm::BM - 1) / gemm::BM > 65535) return cudaErrorInvalidValue;")
    w("  Args a = {};")
    w("  int i = 0;")
    if plan.input is not None:
        w("  a.u = static_cast<const float*>(bufs[i++]);")
    for j in range(NC):
        w(f"  a.c[{j}] = bufs[i++];")
    for name in plan.int8:
        w(f"  a.cs[{cidx[name]}] = static_cast<const float*>(bufs[i++]);")
    w(f"  for (int j = 0; j < {NS}; ++j) a.x0[j] = static_cast<const float*>(bufs[i++]);")
    if plan.lut:
        w("  a.lut = static_cast<const float*>(bufs[i++]);")
        w("  a.lut1 = static_cast<const float*>(bufs[i++]);")
        w("  a.n_lut = n_lut;")
    if plan.output is not None:
        w("  a.y = static_cast<float*>(bufs[i++]);")
    w(f"  for (int j = 0; j < {NS}; ++j) a.fin[j] = static_cast<float*>(bufs[i++]);")
    w(f"  for (int j = 0; j < {NS}; ++j) a.scr[j] = static_cast<float*>(bufs[i++]);")
    w(f"  for (int j = 0; j < {NM}; ++j) a.m[j] = static_cast<float*>(bufs[i++]);")
    for m in plan.maccs:
        if m.hoist is not None:
            w(f"  a.pre[{midx[m.name]}] = static_cast<float*>(bufs[i++]);")
    w("  a.bar = static_cast<GridBarrier*>(bufs[i++]);")
    w("  a.B = B;")
    w("  a.T = T;")
    w("  cudaError_t err;")
    for m in plan.maccs:
        if m.hoist is None:
            continue
        j = midx[m.name]
        w(f"  hoist_{j}<<<dim3(({m.n} + gemm::BN - 1) / gemm::BN, (B * T + gemm::BM - 1) / gemm::BM), "
          "gemm::THREADS, 0, stream>>>(a);")
        w("  err = cudaGetLastError();")
        w("  if (err != cudaSuccess) return err;")
    w("  err = stage_ready_();")
    w("  if (err != cudaSuccess) return err;")
    w("  void* args[] = {&a};")
    w("  return grid_barrier_launch((const void*)stage_persistent, GRID, THREADS, args, SMEM,")
    w("                             a.bar, stream);")
    w("}")
    w("")
    w("// The persistent kernel's configuration, for reports:")
    w("// out = [grid, resident (0/1), dynamic shared memory bytes, barriers a step].")
    w("int stage_config(int* out) {")
    w("  const cudaError_t err = stage_ready_();")
    w("  if (err != cudaSuccess) return err;")
    w("  out[0] = GRID;")
    w("  out[1] = RESIDENT;")
    w("  out[2] = SMEM;")
    w("  out[3] = BARRIERS_PER_STEP;")
    w("  return 0;")
    w("}")
    w("")
    w("// The serial floor: the persistent kernel's grid running the grid")
    w("// barriers of T steps and nothing else.  `bar` holds 4 words.")
    w("int stage_serial_floor(int T, void* bar, void* stream_ptr) {")
    w("  if (T < 1) return cudaErrorInvalidValue;")
    w("  return grid_barrier_run_probe(GRID, THREADS, T * BARRIERS_PER_STEP - 1, -1,")
    w("                                static_cast<GridBarrier*>(bar),")
    w("                                static_cast<cudaStream_t>(stream_ptr));")
    w("}")
    w("")
    w("const char* stage_error_string(int code) { return grid_barrier_error_string(code); }")
    w("")
    w('}  // extern "C"')
    return "\n".join(L) + "\n"


__all__ = ["H100_SMEM_OPTIN", "H100_SMS", "MACC_COLS", "MACC_KSPLIT", "THREADS",
           "barrier_plan", "buffer_layout", "emit", "residency"]
