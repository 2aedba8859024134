"""Verilog backend: IR → the paper's Table-I module hierarchy as text; the
port's counterpart of ``repro/codegen/verilog.py``, byte for byte.

Emits the same module tree the paper's C# tool generates —
``Create_TopModule`` instantiating a controller FSM plus per-stage datapath
modules built from ``Create_Layer`` (MACC arrays of ``Create_mult`` lanes),
``Create_AF``/``Create_AF_End`` (ROM-LUT activation units) — driven entirely
by the datapath graph, so any registered cell gets RTL for free.

The emission is deterministic (graph topo order, sorted activations, no
timestamps) so tests can diff the text exactly.  Word widths are
parameterized from ``spec.quant_bits`` (default 18, Q(4.w−4) as in
``core.quantization.default_format``).  Coefficient ROMs hold the program's
weights, read on the host as float64 numpy wherever the tensors live;
activation ROMs hold the quantized samples of ``af_samples`` (the
reference's float32 values, never recomputed with torch).

Alongside the RTL a Fig. 10-style :class:`ResourceReport` counts DSP MACC
lanes, ROM bits, state-register bits and FSM cycles.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core.quantization import FixedPointFormat
from repro_torch.kernels._lut import RANGE as _AF_RANGE  # ROM domain [-R, R)

from .af_samples import AF_ADDR_BITS, samples
from .ir import DatapathGraph, Program, Stage
from .knobs import word_bits_reason

DEFAULT_WIDTH = 18

# Activations realizable as combinational logic instead of a ROM.
_COMB_AF = {"identity", "relu"}


def _af_depth(graph: DatapathGraph) -> int:
    """Longest chain of REGISTERED AF ROMs on any path through the datapath
    — each adds one clock of latency between MACC done and settled outputs
    (LSTM: gate ROM → c_tanh ROM = 2; SSM: 0)."""
    depth: dict[str, int] = {}
    for n in graph.nodes:
        d = max((depth.get(i, 0) for i in n.inputs), default=0)
        if n.op == "af" and n.attr("fn") not in _COMB_AF:
            d += 1
        depth[n.name] = d
    return max(depth.values(), default=0)


@dataclasses.dataclass
class ResourceReport:
    """Fig. 10 analogs: datapath area + FSM timing, from the IR alone."""

    name: str
    width_bits: int
    dsp_macc_lanes: int       # Create_mult instances (j copies included)
    rom_bits: int             # coefficient ROMs + activation LUT ROMs
    state_reg_bits: int       # state registers (× C for C-slow)
    fsm_cycles: int           # serial steps × C across all stages
    macc_flops_per_step: int  # 2·in·out summed over MACC nodes, all stages
    flops_per_inference: int  # per batch row, whole schedule
    # synthesize(backend="verilog")'s built forward, under the reference's
    # field names: the MACC flops of the batched run and its peak device
    # bytes (None on the CPU)
    xla_flops: float | None = None
    xla_peak_bytes: int | None = None

    def summary(self) -> str:
        return (
            f"[{self.name}] width={self.width_bits}b dsp={self.dsp_macc_lanes} "
            f"rom={self.rom_bits / 1024:.1f}Kib regs={self.state_reg_bits}b "
            f"cycles={self.fsm_cycles} flops/inf={self.flops_per_inference}"
            + (f" xla_flops={self.xla_flops:.0f}" if self.xla_flops else "")
        )


def report_program(program: Program) -> ResourceReport:
    spec = program.spec
    width = spec.quant_bits or DEFAULT_WIDTH
    dsp = rom = regs = cycles = per_step = total_flops = 0
    for st in program.stages:
        g, sched = st.graph, st.schedule
        lanes = sum(n.width for n in g.macc_nodes())
        dsp += lanes * sched.unroll
        rom += g.rom_elements(sched.steps) * width
        # one private LUT ROM per AF *lane* (create_datapath instantiates
        # n.width Create_AF units per af node)
        rom += sum(2 ** AF_ADDR_BITS * width * n.width for n in g.af_nodes()
                   if n.attr("fn") not in _COMB_AF)
        regs += sum(g.states.values()) * width * sched.c_slow
        cycles += sched.cycles
        per_step += g.macc_flops_per_step()
        total_flops += g.macc_flops_per_step() * sched.steps
    # readout + input injection: one extra MACC pass (and ROM) each
    rom += program.C.numel() * width
    total_flops += 2 * program.C.numel()
    if program.beta is not None:
        rom += program.beta.numel() * width
        total_flops += 2 * program.beta.numel()
    return ResourceReport(
        name=spec.name, width_bits=width, dsp_macc_lanes=dsp, rom_bits=rom,
        state_reg_bits=regs, fsm_cycles=cycles,
        macc_flops_per_step=per_step, flops_per_inference=total_flops,
    )


# ---------------------------------------------------------------------------
# Module emitters (Table I, one function per row)
# ---------------------------------------------------------------------------

def create_mult(width: int) -> str:
    """Create_mult: one signed MACC lane (DSP48 slice)."""
    return f"""\
module Create_mult #(parameter WIDTH = {width}) (
  input  wire                      clk,
  input  wire                      en,
  input  wire                      clr,
  input  wire signed [WIDTH-1:0]   a,     // datapath operand
  input  wire signed [WIDTH-1:0]   w,     // coefficient (ROM port)
  output reg  signed [2*WIDTH-1:0] acc    // wide accumulator
);
  always @(posedge clk) begin
    if (clr)     acc <= {{2*WIDTH{{1'b0}}}};
    else if (en) acc <= acc + a * w;
  end
endmodule"""


def host64(vals) -> np.ndarray:
    """A tensor (on any device) or array as float64 numpy, the values the
    reference reads its weights as."""
    if isinstance(vals, torch.Tensor):
        vals = vals.detach().cpu().numpy()
    return np.asarray(vals, np.float64)


def _quantize_words(vals, fmt: FixedPointFormat) -> list[int]:
    """Real values → masked fixed-point ROM words."""
    q = fmt.quantize_int(host64(vals).reshape(-1))
    mask = (1 << fmt.total_bits) - 1
    return [int(v) & mask for v in q]


def _af_rom_entries(fn: str, fmt: FixedPointFormat) -> list[int]:
    """Quantized samples of ``fn`` at the 64 bin centres of [-R, R)."""
    return _quantize_words(np.asarray(samples(fn), np.float64), fmt)


def _rom_init(name: str, words: list[int], width: int) -> str:
    """An ``initial`` block loading the quantized coefficients — the emitted
    RTL is self-contained (the paper's tool embeds coefficients the same
    way; no $readmemh side files)."""
    hexw = (width + 3) // 4
    lines = "\n".join(f"    {name}[{i}] = {width}'h{v:0{hexw}x};"
                      for i, v in enumerate(words))
    return f"  initial begin\n{lines}\n  end"


def create_af(fn: str, width: int, end: bool = False) -> str:
    """Create_AF / Create_AF_End: the activation unit — a ROM LUT for
    transcendental functions, combinational logic for relu/identity."""
    mod = "Create_AF_End" if end else "Create_AF"
    name = f"{mod}_{fn}"
    if fn == "identity":
        return f"""\
module {name} #(parameter WIDTH = {width}) (
  input  wire signed [WIDTH-1:0] x,
  output wire signed [WIDTH-1:0] y
);
  assign y = x;  // pass-through readout
endmodule"""
    if fn == "relu":
        return f"""\
module {name} #(parameter WIDTH = {width}) (
  input  wire signed [WIDTH-1:0] x,
  output wire signed [WIDTH-1:0] y
);
  assign y = x[WIDTH-1] ? {{WIDTH{{1'b0}}}} : x;
endmodule"""
    fmt = FixedPointFormat(total_bits=width, frac_bits=width - 4)
    entries = _af_rom_entries(fn, fmt)
    hexw = (width + 3) // 4
    rom = "\n".join(
        f"      {AF_ADDR_BITS}'d{i}: y <= {width}'h{v:0{hexw}x};"
        for i, v in enumerate(entries)
    )
    n = 2 ** AF_ADDR_BITS
    return f"""\
module {name} #(parameter WIDTH = {width}) (
  input  wire                    clk,
  input  wire signed [WIDTH-1:0] x,     // Q({fmt.int_bits}.{fmt.frac_bits}) MACC result
  output reg  signed [WIDTH-1:0] y
);
  // ROM LUT: {fn} sampled on [-{_AF_RANGE:g}, {_AF_RANGE:g}), {n} entries.
  // addr = clamp(x, -{_AF_RANGE:g}, {_AF_RANGE:g}) mapped linearly: bias by +{_AF_RANGE:g}
  // (= 1 << WIDTH-2 in Q{fmt.int_bits}.{fmt.frac_bits}), saturate to [0, {2 * _AF_RANGE:g}), take the top
  // {AF_ADDR_BITS} magnitude bits.
  wire signed [WIDTH:0] biased = {{x[WIDTH-1], x}} + (1 <<< (WIDTH - 2));
  wire [{AF_ADDR_BITS - 1}:0] addr =
      (biased < 0)                    ? {AF_ADDR_BITS}'d0 :
      (biased >= (1 <<< (WIDTH - 1))) ? {AF_ADDR_BITS}'d{n - 1} :
      biased[WIDTH-2 -: {AF_ADDR_BITS}];
  always @(posedge clk) begin
    case (addr)
{rom}
      default: y <= {{WIDTH{{1'b0}}}};
    endcase
  end
endmodule"""


def create_layer(name: str, in_width: int, out_width: int, width: int,
                 unroll: int, per_step: bool, steps: int,
                 has_bias: bool = False, coeffs=None, bias=None) -> str:
    """Create_Layer / Create_Layer1: an out_width-lane MACC array sharing one
    coefficient ROM (plus a bias ROM when the macc node carries one),
    serially accumulating over the in_width bus in ceil(in/j) cycles
    (j = unroll datapath copies).  ``coeffs`` ([pages?, out, in]) and
    ``bias`` ([pages?, out]) are quantized into ``initial`` ROM loads so the
    RTL is self-contained."""
    serial = math.ceil(in_width / unroll)
    rom_pages = steps if per_step else 1
    # shared-ROM layers (recurrent cells: one page for every step) must not
    # index by the FSM step counter
    kw = f"k*{out_width * in_width} + " if per_step else ""
    kb = f"k*{out_width} + " if per_step else ""
    fmt = FixedPointFormat(total_bits=width, frac_bits=width - 4)
    inits = []
    if coeffs is not None:
        inits.append(_rom_init("rom", _quantize_words(coeffs, fmt), width))
    if has_bias and bias is not None:
        inits.append(_rom_init("rom_b", _quantize_words(bias, fmt), width))
    init_txt = ("\n" + "\n".join(inits)) if inits else ""
    bias_rom = (f"\n  reg signed [WIDTH-1:0] rom_b [0:{rom_pages * out_width - 1}];"
                f"  // bias ROM, one word per lane" if has_bias else "")
    bias_add = (f" + rom_b[{kb}gi]" if has_bias else "")
    return f"""\
module {name} #(parameter WIDTH = {width}, parameter J = {unroll}) (
  input  wire                        clk,
  input  wire                        start,
  input  wire [$clog2({max(steps, 2)})-1:0]        k,      // FSM step (ROM page select)
  input  wire signed [{in_width}*WIDTH-1:0]  x_bus,  // input bus ({in_width} lanes)
  output wire signed [{out_width}*WIDTH-1:0] z_bus,  // MACC results ({out_width} lanes)
  output reg                         done
);
  // coefficient ROM: {rom_pages} page(s) x {out_width}x{in_width} words
  reg signed [WIDTH-1:0] rom [0:{rom_pages * out_width * in_width - 1}];{bias_rom}{init_txt}
  reg [$clog2({max(serial, 2)}):0] cyc;  // {serial} serial MACC cycles (J = {unroll} copies)
  genvar gi, ji;
  generate
    for (gi = 0; gi < {out_width}; gi = gi + 1) begin : lane
      // J parallel Create_mult copies stride the input bus; term ji covers
      // element cyc*J + ji (zero-padded past in_width), summed combinationally
      wire signed [2*WIDTH-1:0] acc [0:J-1];
      wire signed [2*WIDTH-1:0] acc_sum [0:J];
      assign acc_sum[0] = {{2*WIDTH{{1'b0}}}};
      for (ji = 0; ji < J; ji = ji + 1) begin : copy
        wire [31:0] idx = cyc * J + ji;
        wire        pad = (idx >= {in_width});
        Create_mult #(.WIDTH(WIDTH)) u_mult (
          .clk(clk), .en(~done & ~pad), .clr(start),
          .a(x_bus[(idx % {in_width})*WIDTH +: WIDTH]),
          .w(rom[{kw}gi*{in_width} + (idx % {in_width})]),
          .acc(acc[ji])
        );
        assign acc_sum[ji+1] = acc_sum[ji] + acc[ji];
      end
      assign z_bus[gi*WIDTH +: WIDTH] = acc_sum[J][2*WIDTH-1-4 -: WIDTH]{bias_add};  // Q-align
    end
  endgenerate
  always @(posedge clk) begin
    if (start) begin cyc <= 0; done <= 1'b0; end
    else if (!done) begin
      cyc  <= cyc + 1;
      done <= (cyc == {serial - 1});
    end
  end
endmodule"""


def _bus(node_name: str) -> str:
    return f"w_{node_name}"


def _macc_port_uses(g: DatapathGraph) -> set[str]:
    """Const names consumed ONLY through Create_Layer ports (weight/bias
    ROMs) — these never need a datapath bus; everything else does.  A macc
    node's inputs[0] is its x_bus DATA port, so it counts as 'elsewhere':
    a const feeding it still needs a materialized bus."""
    macc_ins = {i for n in g.macc_nodes() for i in n.inputs[1:]}
    elsewhere = {i for n in g.nodes for j, i in enumerate(n.inputs)
                 if not (n.op == "macc" and j >= 1)}
    return macc_ins - elsewhere


def _const_bus(node, words: list[int], width: int) -> str:
    """An elementwise const as a constant bus: lane i carries word i (lane 0
    in the LSBs, so the concatenation lists words MSB-first)."""
    hexw = (width + 3) // 4
    lanes = ", ".join(f"{width}'h{w:0{hexw}x}" for w in reversed(words))
    return (f"  wire signed [{node.width}*WIDTH-1:0] {_bus(node.name)} = "
            f"{{{lanes}}};")


def create_datapath(stage: Stage, width: int) -> str:
    """One combinational-plus-MACC datapath module wired node-for-node from
    the IR graph; state registers are the module's sequential elements."""
    g = stage.graph
    name = f"Create_Datapath_{stage.name}"
    ports = ["  input  wire clk,", "  input  wire start,", "  input  wire load,",
             f"  input  wire [$clog2({max(stage.schedule.steps, 2)})-1:0] k,"]
    inp = g.input_node()
    if inp is not None:
        ports.append(f"  input  wire signed [{inp.width}*WIDTH-1:0] u_bus,")
    for sname, w in sorted(g.states.items()):
        ports.append(f"  input  wire signed [{w}*WIDTH-1:0] {sname}_init,")
        ports.append(f"  output wire signed [{w}*WIDTH-1:0] {sname}_bus,")
    if g.output is not None:
        ports.append(f"  output wire signed [{g.node(g.output).width}*WIDTH-1:0] y_bus,")
    ports.append("  output wire step_done")
    fmt = FixedPointFormat(total_bits=width, frac_bits=width - 4)
    rom_only = _macc_port_uses(g)
    body: list[str] = []
    dones: list[str] = []
    for n in g.nodes:
        wn = _bus(n.name)
        decl = f"  wire signed [{n.width}*WIDTH-1:0] {wn};"
        if n.op == "input":
            body.append(f"{decl}  assign {wn} = u_bus;")
        elif n.op == "state":
            body.append(f"  reg signed [{n.width}*WIDTH-1:0] r_{n.name};  // state register")
            body.append(f"{decl}  assign {wn} = r_{n.name};")
        elif n.op == "const":
            shape = "x".join(str(d) for d in n.attr("shape"))
            body.append(f"  // const ROM '{n.name}' [{shape}]"
                        + (" (per-step pages)" if n.attr("per_step") else ""))
            if n.name not in rom_only:
                # consumed by gate algebra: materialize a constant bus
                # (Create_Layer ports read the coefficient ROMs directly)
                if n.attr("per_step"):
                    raise NotImplementedError(
                        f"per-step const '{n.name}' feeds an elementwise op; "
                        "only MACC ports may read per-step ROM pages")
                body.append(_const_bus(
                    n, _quantize_words(stage.params[n.name], fmt),
                    width))
        elif n.op == "macc":
            has_b = len(n.inputs) == 3
            in_w = g.node(n.inputs[0]).width
            body.append(decl)
            body.append(
                f"  wire d_{n.name};\n"
                f"  Create_Layer_{stage.name}_{n.name} #(.WIDTH(WIDTH)) u_{n.name} (\n"
                f"    .clk(clk), .start(start), .k(k),\n"
                f"    .x_bus({_bus(n.inputs[0])}), .z_bus({wn}), .done(d_{n.name})\n"
                f"  );  // {in_w} -> {n.width} MACC array"
                + (" + bias ROM" if has_b else ""))
            dones.append(f"d_{n.name}")
        elif n.op == "af":
            fn = n.attr("fn")
            src = _bus(n.inputs[0])
            body.append(decl)
            if fn in _COMB_AF:
                inst = (f"      Create_AF_{fn} #(.WIDTH(WIDTH)) u_{n.name} "
                        f"(.x({src}[ai*WIDTH +: WIDTH]), .y({wn}[ai*WIDTH +: WIDTH]));")
            else:
                inst = (f"      Create_AF_{fn} #(.WIDTH(WIDTH)) u_{n.name} (.clk(clk),\n"
                        f"        .x({src}[ai*WIDTH +: WIDTH]),"
                        f" .y({wn}[ai*WIDTH +: WIDTH]));")
            body.append(
                f"  genvar ai_{n.name};\n"
                f"  generate\n"
                f"    for (ai_{n.name} = 0; ai_{n.name} < {n.width}; ai_{n.name} = ai_{n.name} + 1)"
                f" begin : af_{n.name}\n"
                + inst.replace("ai*", f"ai_{n.name}*").replace("[ai ", f"[ai_{n.name} ")
                + f"\n    end\n  endgenerate")
        elif n.op == "concat":
            srcs = ", ".join(_bus(i) for i in reversed(n.inputs))
            body.append(f"{decl}  assign {wn} = {{{srcs}}};")
        elif n.op == "slice":
            a, b = n.attr("start"), n.attr("stop")
            body.append(f"{decl}  assign {wn} = "
                        f"{_bus(n.inputs[0])}[{a}*WIDTH +: {(b - a)}*WIDTH];")
        elif n.op in ("add", "sub", "mul"):
            # per-lane arithmetic: a whole-bus assign would bleed carries
            # across lane boundaries (and bus-wide * is not lane-wise at all)
            op = {"add": "+", "sub": "-", "mul": "*"}[n.op]
            ei = f"ei_{n.name}"
            a = f"{_bus(n.inputs[0])}[{ei}*WIDTH +: WIDTH]"
            b = f"{_bus(n.inputs[1])}[{ei}*WIDTH +: WIDTH]"
            if n.op == "mul":
                # Q-align the 2W-bit lane product with the MACC's select
                lane = (f"      wire signed [2*WIDTH-1:0] p = "
                        f"$signed({a}) {op} $signed({b});\n"
                        f"      assign {wn}[{ei}*WIDTH +: WIDTH] = "
                        f"p[2*WIDTH-1-4 -: WIDTH];")
            else:
                lane = (f"      assign {wn}[{ei}*WIDTH +: WIDTH] = "
                        f"$signed({a}) {op} $signed({b});")
            body.append(
                f"{decl}  // elementwise {n.op}, {n.width} VPU lanes\n"
                f"  genvar {ei};\n"
                f"  generate\n"
                f"    for ({ei} = 0; {ei} < {n.width}; {ei} = {ei} + 1)"
                f" begin : ew_{n.name}\n"
                f"{lane}\n"
                f"    end\n  endgenerate")
    # register load (FSM S_LOAD) / write-back (every completed step)
    ld = "\n".join(f"      r_{s} <= {s}_init;" for s in sorted(g.states))
    wb = "\n".join(f"      r_{s} <= {_bus(src)};"
                   for s, src in sorted(g.updates.items()))
    done_expr = " & ".join(dones) if dones else "1'b1"
    outs = [f"  assign {s}_bus = r_{s};" for s in sorted(g.states)]
    if g.output is not None:
        outs.append(f"  assign y_bus = {_bus(g.output)};")
    nl = "\n"
    return f"""\
module {name} #(parameter WIDTH = {width}) (
{nl.join(ports)}
);
{nl.join(body)}
  assign step_done = {done_expr};
  // ONE register write-back per start kick (step_done is a sticky level
  // that only clears on the next start pulse).  AF_DEPTH settle cycles let
  // the registered AF ROM chain propagate the FINAL MACC sum (one clock per
  // chained ROM) before the state registers latch.
  localparam AF_DEPTH = {_af_depth(g)};
  reg stepped;
  reg [2:0] af_wait;
  always @(posedge clk) begin
    if (load) begin
      stepped <= 1'b0; af_wait <= 3'd0;
{ld}
    end else if (start) begin
      stepped <= 1'b0; af_wait <= 3'd0;
    end else if (step_done && af_wait < AF_DEPTH) begin
      af_wait <= af_wait + 3'd1;
    end else if (step_done && !stepped) begin
      stepped <= 1'b1;
{wb}
    end
  end
{nl.join(outs)}
endmodule"""


def create_top_module(program: Program, width: int) -> str:
    """Create_TopModule: the controller FSM (IDLE → LOAD → ITERATE×N →
    READOUT → DONE) time-multiplexing the stage datapaths, with the C-slow
    stream counter when C > 1.  Deep stacks cascade stage i's Mealy output
    bus into stage i+1's input bus (the layer-pipeline skew registers are
    elided — every stage shares the one fsm_k counter)."""
    spec = program.spec
    # stages run in lock-step off one counter; ResourceReport.fsm_cycles
    # accounts the full C·ΣN serial schedule
    fsm_steps = max(st.schedule.steps for st in program.stages)
    c_slow = program.stages[0].schedule.c_slow
    is_mlp = program.beta is not None
    last = program.stages[-1]
    ro_width = last.graph.states[program.readout_state]

    wires, insts = [], []
    prev_y = prev_done = None
    prev_y_width = prev_depth = 0
    for st in program.stages:
        g = st.graph
        if prev_done is None:
            start_net, in_bus = "step_start", "u_bus"
        else:
            # cascade: stage i+1 starts AF_DEPTH+1 cycles after stage i's
            # done EDGE (one clock per chained AF ROM), latching stage i's
            # settled output — its serial MACC never sees the predecessor's
            # in-flight partial sums, unsettled ROMs, or write-backs
            start_net, in_bus = f"start_{st.name}", f"{prev_y}_r"
            edge = f"{prev_done} & ~{prev_done}_q"
            pipe = f"{prev_done}_pipe"
            shift = (f"{{{pipe}[{prev_depth - 1}:0], {edge}}}" if prev_depth > 0
                     else f"{edge}")
            wires += [
                f"  reg {prev_done}_q;",
                f"  reg [{prev_depth}:0] {pipe};  // prev stage AF-ROM settle delay",
                f"  wire {start_net} = {pipe}[{prev_depth}];",
                f"  reg signed [{prev_y_width}*WIDTH-1:0] {prev_y}_r;",
                "  always @(posedge clk) begin",
                f"    {prev_done}_q <= {prev_done};",
                f"    {pipe} <= {shift};",
                f"    if ({start_net}) {prev_y}_r <= {prev_y};",
                "  end",
            ]
        conns = [f"    .clk(clk), .start({start_net}), .load(load), .k(fsm_k),"]
        if g.input_node() is not None:
            conns.append(f"    .u_bus({in_bus}),")
        for s in sorted(g.states):
            w = g.states[s]
            wires.append(f"  wire signed [{w}*WIDTH-1:0] {st.name}_{s};")
            if is_mlp:
                # βu injection: the loaded state IS x0 (the δ[k] impulse)
                wires.append(f"  wire signed [{w}*WIDTH-1:0] {st.name}_{s}_init = x0_bus;")
            else:
                wires.append(f"  wire signed [{w}*WIDTH-1:0] {st.name}_{s}_init = "
                             f"{{{w}*WIDTH{{1'b0}}}};")
            conns.append(f"    .{s}_init({st.name}_{s}_init),")
            conns.append(f"    .{s}_bus({st.name}_{s}),")
        if g.output is not None:
            ow = g.node(g.output).width
            wires.append(f"  wire signed [{ow}*WIDTH-1:0] y_{st.name};")
            conns.append(f"    .y_bus(y_{st.name}),")
            prev_y, prev_y_width = f"y_{st.name}", ow
        wires.append(f"  wire done_{st.name};")
        conns.append(f"    .step_done(done_{st.name})")
        insts.append(
            f"  Create_Datapath_{st.name} #(.WIDTH(WIDTH)) u_{st.name} (\n"
            + "\n".join(conns) + "\n  );")
        prev_done = f"done_{st.name}"
        prev_depth = _af_depth(g)

    # Step-k completion is the done EDGE of the LAST cascaded stage (sticky
    # done levels from step k-1 on downstream stages must not re-trigger).
    done_edge = f"""\
  reg done_{last.name}_q;
  always @(posedge clk) done_{last.name}_q <= done_{last.name};
  wire step_done_all = done_{last.name} & ~done_{last.name}_q;"""
    if is_mlp:
        inject = f"""\
  // Create_Layer1: the beta u delta[k] input injection -> loaded state x0
  wire signed [{program.beta.shape[0]}*WIDTH-1:0] x0_bus;
  wire load_done;
  Create_Layer_beta #(.WIDTH(WIDTH)) u_layer1 (
    .clk(clk), .start(load_kick), .k(1'b0),
    .x_bus(u_bus), .z_bus(x0_bus), .done(load_done)
  );"""
    else:
        inject = """\
  // recurrent cells: state registers load zero; u_bus streams per step
  wire load_done = 1'b1;"""
    in_w = spec.num_inputs if is_mlp or not program.stages \
        else program.stages[0].graph.input_node().width
    out_w = spec.num_outputs
    nl = "\n"
    cslow_note = (f"  // C-slow: {c_slow} interleaved streams "
                  f"(stream = cycle mod {c_slow})" if c_slow > 1 else "")
    # recurrent forms stream u[k] per FSM step: u_ready pulses when the step-
    # u_k input must be valid on u_bus (mlp consumes u_bus once, at LOAD)
    stream_ports = "" if is_mlp else f"""
  output wire                       u_ready,  // present u[u_k] on u_bus
  output wire [$clog2({max(fsm_steps, 2)})-1:0]       u_k,"""
    stream_assigns = "" if is_mlp else """
  assign u_ready = kick;
  assign u_k     = fsm_k;"""
    return f"""\
module Create_TopModule_{spec.name} #(parameter WIDTH = {width}) (
  input  wire                       clk,
  input  wire                       rst,
  input  wire                       start,
  input  wire signed [{in_w}*WIDTH-1:0]   u_bus,{stream_ports}
  output wire signed [{out_w}*WIDTH-1:0]  y_bus,
  output reg                        done
);
  // FSM: IDLE -> LOAD -> ITERATE x {fsm_steps} -> READOUT -> DONE
  localparam S_IDLE = 3'd0, S_LOAD = 3'd1, S_ITER = 3'd2,
             S_READ = 3'd3, S_DONE = 3'd4;
  localparam STEPS = {fsm_steps}, CSLOW = {c_slow}, J = {program.stages[0].schedule.unroll};
  localparam SETTLE = {_af_depth(last.graph) + 2};  // last stage AF chain + write-back
{cslow_note}
  reg [2:0] fsm_state;
  reg [$clog2({max(fsm_steps, 2)})-1:0] fsm_k;  // the time-multiplex counter
  // MACC layers treat start as a synchronous clear, so every use is kicked
  // by a ONE-CYCLE pulse; transitions qualify on !kick to let the sticky
  // done levels clear after each kick.
  reg kick;        // per-step start pulse into the first stage datapath
  reg load_kick;   // input-injection start (Create_Layer1)
  reg read_kick;   // readout start (Create_Layer_End)
  reg [2:0] settle;  // AF-ROM chain + write-back cycles before advancing
  wire step_start = kick;
  wire load       = (fsm_state == S_LOAD);{stream_assigns}
{nl.join(wires)}
{nl.join(insts)}
{done_edge}
{inject}
  // Create_Layer_End: readout y = C x[N] on the final carry
  wire signed [{ro_width}*WIDTH-1:0] x_final = {last.name}_{program.readout_state};
  wire read_done;
  Create_Layer_End_C #(.WIDTH(WIDTH)) u_readout (
    .clk(clk), .start(read_kick), .k(1'b0),
    .x_bus(x_final), .z_bus(y_bus), .done(read_done)
  );
  always @(posedge clk) begin
    if (rst) begin
      fsm_state <= S_IDLE; fsm_k <= 0; done <= 1'b0;
      kick <= 1'b0; load_kick <= 1'b0; read_kick <= 1'b0; settle <= 3'd0;
    end else begin
      kick <= 1'b0; load_kick <= 1'b0; read_kick <= 1'b0;
      case (fsm_state)
        S_IDLE: if (start) begin fsm_state <= S_LOAD; load_kick <= 1'b1; end
        S_LOAD: if (load_done && !load_kick) begin
          fsm_state <= S_ITER; fsm_k <= 0; kick <= 1'b1;
        end
        S_ITER: begin
          // done EDGE -> SETTLE cycles (AF ROM chain, then register
          // write-back) -> next kick / readout
          if (settle == SETTLE) begin
            settle <= 3'd0;
            if (fsm_k == STEPS - 1) begin fsm_state <= S_READ; read_kick <= 1'b1; end
            else begin fsm_k <= fsm_k + 1; kick <= 1'b1; end  // next use
          end else if (settle != 3'd0) begin
            settle <= settle + 3'd1;
          end else if (step_done_all) begin
            settle <= 3'd1;
          end
        end
        S_READ: if (read_done && !read_kick) fsm_state <= S_DONE;
        S_DONE: begin done <= 1'b1; fsm_state <= S_IDLE; end
      endcase
    end
  end
endmodule"""


def emit_program(program: Program) -> str:
    """The full RTL text: prims → AF ROMs → MACC layers → datapaths → top."""
    program.validate()
    spec = program.spec
    width = spec.quant_bits or DEFAULT_WIDTH
    reason = word_bits_reason(width)
    if reason is not None:
        raise ValueError(f"verilog backend: quant_bits={width}: {reason}")
    # the header names the reference's generator, so that both emit one text
    parts = [
        f"// Generated by repro.codegen (paper Table I) — spec {spec.name}",
        f"// cell={spec.cell} steps={sum(st.schedule.steps for st in program.stages)} "
        f"unroll={program.stages[0].schedule.unroll} "
        f"c_slow={program.stages[0].schedule.c_slow} width={width}",
        create_mult(width),
    ]
    # Activation units, one per distinct function (sorted for determinism).
    fns = sorted({n.attr("fn") for st in program.stages
                  for n in st.graph.af_nodes()})
    for fn in fns:
        parts.append(create_af(fn, width))
    # MACC layer modules, one per (stage, macc node) — stage-qualified names
    # keep multi-stage programs free of module redefinitions.
    for st in program.stages:
        for n in st.graph.macc_nodes():
            in_w = st.graph.node(n.inputs[0]).width
            per_step = any(st.graph.node(i).attr("per_step")
                           for i in n.inputs[1:])
            W = host64(st.params[n.inputs[1]])      # [pages?, in, out]
            coeffs = np.swapaxes(W, -1, -2)         # ROM order: [pages?, out, in]
            has_b = len(n.inputs) == 3
            bias = host64(st.params[n.inputs[2]]) if has_b else None
            parts.append(create_layer(
                f"Create_Layer_{st.name}_{n.name}", in_w, n.width, width,
                st.schedule.unroll, per_step, st.schedule.steps,
                has_bias=has_b, coeffs=coeffs, bias=bias))
    # Input injection + readout as Layer1 / Layer_End MACC arrays.
    if program.beta is not None:
        parts.append(create_layer("Create_Layer_beta", program.beta.shape[1],
                                  program.beta.shape[0], width, 1, False, 1,
                                  coeffs=host64(program.beta)))
    parts.append(create_layer("Create_Layer_End_C", program.C.shape[1],
                              program.C.shape[0], width, 1, False, 1,
                              coeffs=host64(program.C)))
    for st in program.stages:
        parts.append(create_datapath(st, width))
    parts.append(create_top_module(program, width))
    return "\n\n".join(parts) + "\n"


__all__ = [
    "AF_ADDR_BITS",
    "DEFAULT_WIDTH",
    "ResourceReport",
    "create_af",
    "create_datapath",
    "create_layer",
    "create_mult",
    "create_top_module",
    "emit_program",
    "host64",
    "report_program",
]
