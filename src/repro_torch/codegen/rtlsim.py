"""Bit-accurate RTL simulator: the executable oracle for the Verilog backend;
the port's counterpart of ``repro/codegen/rtlsim.py``, on int64 tensors.

``emit_program`` turns a :class:`~repro_torch.codegen.ir.Program` into
Table-I Verilog text.  This module simulates the emitted module hierarchy
word for word in integer arithmetic, so the RTL's semantics (paper §IV:
fixed-point MACC datapath, ROM-LUT activation units, gate algebra, state
write-back FSM) run as a program and can be diffed against the float
backends and an independent fixed-point golden model
(``repro_torch.verify.golden``).  :func:`simulate` runs on the card unless
the caller passes a CPU device, and gives the reference's words and cycles.

Faithfulness contract — every arithmetic step mirrors the emitted RTL:

* **Words** are ``width``-bit two's complement (``Q(4.width-4)``).
  Coefficient ROMs hold exactly the words ``verilog._quantize_words`` burns
  into the ``initial`` blocks; AF ROMs hold the ``_af_rom_entries`` tables.
* **Create_mult / Create_Layer**: ``J = unroll`` copies stride the input
  bus (copy ``ji`` takes elements ``ji, ji + J, …``; pad lanes gated off),
  each accumulating its products in a ``2*width``-bit register that wraps
  on overflow; the copies' accumulators add at 2W bits; the result bus takes
  bits ``[2W-5 -: W]`` (arithmetic >> (W-4), wrap to W) and bias words add
  with W-bit wrap — exactly the ``z_bus`` assign.  A copy's serial cycles
  are one dot product modulo 2^(2W) (the per-cycle wrap is a ring
  homomorphism), computed as float64 products of 16-bit limbs: each limb
  product is below 2^32, so every partial sum stays exact below 2^53 for a
  fan-in up to 2^21, and the limbs recombine in int64 with wraparound.
  (The golden model takes another route: an int64 broadcast product and
  sum.)
* **Create_AF**: ``biased = x + (1 << (W-2))`` in W+1 bits, clamp to
  ``[0, 2^(W-1))``, address = top ``AF_ADDR_BITS`` magnitude bits, ROM read.
  ``relu``/``identity`` are combinational, as in the RTL.
* **Gate algebra** (add/sub/mul) is lane-wise W-bit arithmetic; ``mul``
  Q-aligns the 2W-bit product with the same ``[2W-5 -: W]`` select as the
  MACC.
* **Schedules**: ``with_unroll`` changes only the serial MACC cycle count
  (never values — pad lanes are gated); ``with_c_slow`` runs C independent
  interleaved streams through the one datapath (values per stream identical
  to C independent runs, cycle count ×C).  Multi-stage programs cascade
  stage i's Mealy output into stage i+1 within the same FSM step, matching
  ``create_top_module``'s start-pulse chain.

The cycle model (:func:`fsm_cycle_estimate`) counts FSM clocks the way the
emitted controller spends them, traced from the FSM's happy path, and
:class:`RtlSimResult` reports them for Fig. 10-style cross-checks.
"""

from __future__ import annotations

import dataclasses
import math
import sys

import numpy as np
import torch

from repro_torch.core.quantization import FixedPointFormat, default_format
from repro_torch.device import resolve_device

from .ir import DatapathGraph, Program, Stage
from .knobs import WORD_BITS_MIN, word_bits_reason
from .verilog import (
    AF_ADDR_BITS,
    DEFAULT_WIDTH,
    _COMB_AF,
    _af_depth,
    _af_rom_entries,
)

MIN_WIDTH = WORD_BITS_MIN  # one shared width table (codegen.knobs)

_LIMB = 16
_LIMB_MASK = (1 << _LIMB) - 1


# ---------------------------------------------------------------------------
# Word-level primitives (two's complement at a given bit width)
# ---------------------------------------------------------------------------

def wrap(v: torch.Tensor, bits: int) -> torch.Tensor:
    """Reinterpret the low ``bits`` bits as a signed value (wrap-on-overflow
    — what any Verilog reg/wire of that width does)."""
    if bits >= 64:  # int64 is already two's complement mod 2^64
        return v
    half = 1 << (bits - 1)
    return ((v + half) & ((1 << bits) - 1)) - half


def words_of(vals, fmt: FixedPointFormat, device=None) -> torch.Tensor:
    """Real values → signed ROM words on ``device`` (the ``initial`` blocks'
    quantization: round half to even, saturate; ``_quantize_words`` masks to
    unsigned, these are the identical bits in signed form).  ``vals`` may
    be a tensor on any device or an array; the default device is the
    tensor's own."""
    if device is None and isinstance(vals, torch.Tensor):
        device = vals.device
    x = torch.as_tensor(vals, device=device).to(torch.float64)
    q = torch.round(x * fmt.scale)
    return torch.clamp(q, fmt.min_int, fmt.max_int).to(torch.int64)


def af_rom(fn: str, fmt: FixedPointFormat, device=None) -> torch.Tensor:
    """The Create_AF ROM contents as signed words."""
    rom = torch.tensor(_af_rom_entries(fn, fmt), dtype=torch.int64, device=device)
    return wrap(rom, fmt.total_bits)


def macc_word(acc: torch.Tensor, width: int) -> torch.Tensor:
    """The Create_Layer result select: bits ``[2W-5 -: W]`` of the 2W-bit
    accumulator — arithmetic >> (W-4) then wrap to W bits (Q-align)."""
    return wrap(wrap(acc, 2 * width) >> (width - 4), width)


def af_addr(x: torch.Tensor, width: int) -> torch.Tensor:
    """Create_AF address computation, bit-for-bit: sign-extend, bias by
    ``1 << (W-2)`` (= +R in Q), clamp, take the top AF_ADDR_BITS bits.
    Monotone nondecreasing in ``x`` — the property the static range
    analyzer's address-restricted ROM bounds rely on."""
    biased = x + (1 << (width - 2))
    addr = biased >> (width - 2 - (AF_ADDR_BITS - 1))  # [W-2 -: 6]
    addr = torch.where(biased >= (1 << (width - 1)), (1 << AF_ADDR_BITS) - 1, addr)
    return torch.where(biased < 0, 0, addr)


def af_lookup(x: torch.Tensor, rom: torch.Tensor, width: int) -> torch.Tensor:
    """Create_AF ROM read at the bit-accurate address."""
    return rom[af_addr(x, width)]


# ---------------------------------------------------------------------------
# Module models
# ---------------------------------------------------------------------------

def limbs(w: torch.Tensor) -> torch.Tensor:
    """A weight ROM ``[in, out]`` of signed words (at most 32 bits) as its
    float64 limbs ``[in, 2*out]``: the low 16 bits (unsigned), then the
    rest (signed)."""
    return torch.cat([(w & _LIMB_MASK).to(torch.float64),
                      (w >> _LIMB).to(torch.float64)], dim=-1)


def _copy_acc(x: torch.Tensor, w_limbs: torch.Tensor) -> torch.Tensor:
    """One Create_mult copy's serial accumulation: ``Σ x·w`` modulo 2^64
    (exact: every float64 partial sum of limb products stays below 2^53)."""
    out = w_limbs.shape[-1] // 2
    xl = (x & _LIMB_MASK).to(torch.float64)
    xh = (x >> _LIMB).to(torch.float64)
    pl = (xl @ w_limbs).to(torch.int64)   # [..., 2*out]: xl·wl | xl·wh
    ph = (xh @ w_limbs).to(torch.int64)   # [..., 2*out]: xh·wl | xh·wh
    mid = pl[..., out:] + ph[..., :out]
    return (ph[..., out:] << (2 * _LIMB)) + (mid << _LIMB) + pl[..., :out]


def macc_layer(x: torch.Tensor, w_rom: torch.Tensor, width: int,
               bias: torch.Tensor | None = None, unroll: int = 1,
               w_limbs: torch.Tensor | None = None) -> torch.Tensor:
    """Create_Layer: an ``out``-lane MACC array over the ``in`` bus.

    ``x``: ``[..., in]`` signed words; ``w_rom``: ``[in, out]`` signed words
    (the ROM holds the transpose, same values; ``w_limbs`` its precomputed
    :func:`limbs`).  ``J = unroll`` Create_mult copies stride the input bus
    over ``ceil(in/J)`` cycles, pad lanes gated off (``en=0``), each copy's
    accumulator a 2W-bit register, the copies' accumulators summed
    combinationally at 2W bits.
    """
    in_w = w_rom.shape[0]
    if in_w >= 1 << 21:
        raise ValueError(f"MACC fan-in {in_w} exceeds the exact limb range 2^21")
    wl = limbs(w_rom) if w_limbs is None else w_limbs
    total = None
    for ji in range(min(unroll, in_w)):   # copies past in_w only ever pad
        acc = wrap(_copy_acc(x[..., ji::unroll], wl[ji::unroll]), 2 * width)
        total = acc if total is None else wrap(total + acc, 2 * width)
    z = macc_word(total, width)
    if bias is not None:
        z = wrap(z + bias, width)
    return z


def _elementwise(op: str, a: torch.Tensor, b: torch.Tensor, width: int):
    """Per-lane gate algebra at W bits (the corrected datapath emission)."""
    if op == "add":
        return wrap(a + b, width)
    if op == "sub":
        return wrap(a - b, width)
    # mul: 2W-bit lane product, Q-aligned with the same select as the MACC
    return macc_word(wrap(a * b, 2 * width), width)


# ---------------------------------------------------------------------------
# Stage quantization + one datapath step
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class QuantStage:
    """A stage with its const ROMs quantized to signed words (weight ROMs
    keep the params' ``[in, out]`` orientation; values identical to the
    emitted ``[out, in]`` ROM order), on the simulation's device."""

    stage: Stage
    roms: dict[str, torch.Tensor]
    af_roms: dict[str, torch.Tensor]
    width: int
    rom_limbs: dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)

    @classmethod
    def build(cls, stage: Stage, fmt: FixedPointFormat,
              device: torch.device) -> "QuantStage":
        roms = {n.name: words_of(stage.params[n.name], fmt, device)
                for n in stage.graph.consts()}
        rom_limbs = {m.inputs[1]: limbs(roms[m.inputs[1]])
                     for m in stage.graph.macc_nodes()}
        af_roms = {fn: af_rom(fn, fmt, device)
                   for fn in sorted({n.attr("fn") for n in stage.graph.af_nodes()})
                   if fn not in _COMB_AF}
        return cls(stage=stage, roms=roms, af_roms=af_roms,
                   width=fmt.total_bits, rom_limbs=rom_limbs)


def _watch_update(watch: dict, key: str, vals: torch.Tensor) -> None:
    """Fold observed words into ``watch[key] = (lo, hi)`` per bus lane —
    min/max reduced over every leading (batch/stream) axis so the record
    matches the static analyzer's per-lane intervals."""
    v = vals.reshape(-1, vals.shape[-1])
    lo, hi = v.amin(dim=0), v.amax(dim=0)
    prev = watch.get(key)
    if prev is not None:
        lo, hi = torch.minimum(prev[0], lo), torch.maximum(prev[1], hi)
    watch[key] = (lo, hi)


def step_graph(q: QuantStage, states: dict[str, torch.Tensor],
               u: torch.Tensor | None, k: int, unroll: int = 1,
               watch: dict | None = None):
    """One FSM step of one datapath, word-for-word.

    ``states`` leaves and ``u`` are ``[..., width]`` signed words.  Returns
    ``(new_states, output_words or None)`` — the register write-back values
    and the Mealy output bus after the step settles.  When ``watch`` is a
    dict, every settled bus value is folded into it as a per-lane
    (min, max) record keyed ``'{stage}.{node}'``.
    """
    g, W = q.stage.graph, q.width
    env: dict[str, torch.Tensor] = {}
    for n in g.nodes:
        if n.op == "input":
            if u is None:
                raise ValueError(f"graph has input '{n.name}' but no input")
            env[n.name] = u
        elif n.op == "state":
            env[n.name] = states[n.name]
        elif n.op == "const":
            rom = q.roms[n.name]
            env[n.name] = rom[k] if n.attr("per_step") else rom
        elif n.op == "macc":
            wq = env[n.inputs[1]]
            wl = q.rom_limbs[n.inputs[1]]
            if g.node(n.inputs[1]).attr("per_step"):
                wl = wl[k]
            bias = env[n.inputs[2]] if len(n.inputs) == 3 else None
            if bias is not None and bias.ndim > 1:  # [1, out] vector const
                bias = bias[0]
            env[n.name] = macc_layer(env[n.inputs[0]], wq, W, bias=bias,
                                     unroll=unroll, w_limbs=wl)
        elif n.op == "af":
            fn = n.attr("fn")
            x = env[n.inputs[0]]
            if fn == "identity":
                env[n.name] = x
            elif fn == "relu":
                env[n.name] = torch.clamp(x, min=0)
            else:
                env[n.name] = af_lookup(x, q.af_roms[fn], W)
        elif n.op == "concat":
            lead = env[n.inputs[0]].shape[:-1]
            env[n.name] = torch.cat(
                [env[i].expand(lead + (g.node(i).width,)) for i in n.inputs], dim=-1)
        elif n.op == "slice":
            env[n.name] = env[n.inputs[0]][..., n.attr("start"):n.attr("stop")]
        elif n.op in ("add", "sub", "mul"):
            # vector consts are [1, width] — broadcasting is the bus
            env[n.name] = _elementwise(n.op, env[n.inputs[0]], env[n.inputs[1]], W)
        else:  # pragma: no cover - graph.validate() rejects earlier
            raise ValueError(f"unknown op {n.op}")
    if watch is not None:
        for n in g.nodes:
            if n.op == "const":
                continue  # ROM words are static; the analyzer reads them
            _watch_update(watch, f"{q.stage.name}.{n.name}", env[n.name])
    new_states = {s: env[src] for s, src in g.updates.items()}
    out = env[g.output] if g.output is not None else None
    return new_states, out


# ---------------------------------------------------------------------------
# Program-level FSM simulation
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RtlSimResult:
    """What the testbench would capture: output words + real values, the
    final state registers, and the controller's cycle count."""

    y: torch.Tensor                       # [..., P] real values (words / 2^F), float64
    y_codes: torch.Tensor                 # [..., P] signed words, int64
    final_states: dict[str, torch.Tensor]  # 'stage.reg' -> words, last stream
    cycles: int                           # FSM clocks (all C streams)
    width: int
    fmt: FixedPointFormat
    # injected single-event upsets ({stream, step, stage, state, index, bit}
    # per flip) — empty unless a fault plan watching 'rtlsim.seu' was active
    seu_flips: list = dataclasses.field(default_factory=list)
    # 'stage.node' -> (lo, hi) observed signed words per bus lane (int64
    # numpy), plus the virtual wires 'inject.x0' / 'readout.y'; None unless
    # collect_ranges
    wire_ranges: dict | None = None


def _stage_serial(graph: DatapathGraph, unroll: int) -> int:
    """Serial MACC clocks of one datapath kick: its layer arrays run in
    parallel off the same start, so the slowest (ceil(in/J)) gates done."""
    return max((math.ceil(graph.node(n.inputs[0]).width / unroll)
                for n in graph.macc_nodes()), default=0)


def _fsm_cycles_per_stream(program: Program, unroll: int, T: int,
                           is_mlp: bool) -> int:
    """Clocks the emitted Create_TopModule controller spends on one stream,
    traced from the FSM's happy path:

    * IDLE→LOAD transition: 1.
    * LOAD: ``beta`` MACC start latch + its serial count + the
      qualified transition clock (mlp); 2 clocks when ``load_done`` is
      wired high (recurrent cells).
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


def _seu_plan(fault_plan):
    """Resolve the fault plan that watches ``rtlsim.seu`` — the explicit
    argument, else the ambient plan IF ``repro_torch.runtime.faults`` is
    already imported (never import the runtime package from codegen)."""
    if fault_plan is not None:
        return fault_plan
    m = sys.modules.get("repro_torch.runtime.faults")
    return m.get_plan() if m is not None else None


def _seu_flip(plan, spec_f, states, qstages, width: int,
              stream: int, step: int) -> dict:
    """Apply one single-event upset: flip one bit of one word of one state
    register (all choices drawn from the plan's seeded per-point RNG unless
    pinned in the rule's payload), two's-complement semantics preserved."""
    rng = plan.rng("rtlsim.seu")
    pay = spec_f.payload
    si = int(pay.get("stage", rng.randrange(len(qstages))))
    st = states[si]
    name = pay.get("state") or rng.choice(sorted(st))
    arr = st[name].clone()
    flat = arr.view(-1)
    idx = int(pay.get("index", rng.randrange(flat.numel())))
    bit = int(pay.get("bit", rng.randrange(width)))
    flat[idx] = wrap(flat[idx] ^ (1 << bit), width)
    st[name] = arr
    return {"stream": stream, "step": step,
            "stage": qstages[si].stage.name, "state": name,
            "index": idx, "bit": bit}


def _host_ranges(watch: dict) -> dict:
    return {k: (lo.cpu().numpy(), hi.cpu().numpy()) for k, (lo, hi) in watch.items()}


def simulate(program: Program, u, *, width: int | None = None,
             collect_ranges: bool = False, fault_plan=None,
             device=None) -> RtlSimResult:
    """Run the emitted Create_TopModule, bit-accurately, on real inputs, on
    ``device`` (default: the card; a CPU device runs it on the host).

    ``u`` (array or tensor): mlp ``[B, L]``; recurrent ``[B, T, D]``; with
    ``c_slow = C > 1`` prepend a stream axis (``[C, B, ...]``) — the same
    shapes the eager and kernel backends take, so outputs diff directly.

    ``width`` overrides ``spec.quant_bits`` (default ``DEFAULT_WIDTH``).
    Returns :class:`RtlSimResult` with tensors on ``device``; ``y`` is
    ``y_codes / 2**frac_bits``.

    ``fault_plan`` (or the ambient :mod:`repro_torch.runtime.faults` plan,
    when that module is loaded) may schedule ``rtlsim.seu`` single-event
    upsets: each register write-back is one opportunity to flip one
    seeded-random bit in one state word.  Every flip is recorded in
    ``RtlSimResult.seu_flips``.
    """
    dev = resolve_device(device)
    program.validate()
    spec = program.spec
    W = width if width is not None else (spec.quant_bits or DEFAULT_WIDTH)
    reason = word_bits_reason(W)
    if reason is not None:
        raise ValueError(f"rtlsim: {reason}")
    fmt = default_format(W)
    qstages = [QuantStage.build(st, fmt, dev) for st in program.stages]
    is_mlp = program.beta is not None
    c_slow = program.stages[0].schedule.c_slow
    unroll = program.stages[0].schedule.unroll
    steps = program.stages[0].schedule.steps

    u = torch.as_tensor(np.asarray(u) if not isinstance(u, torch.Tensor) else u)
    want_nd = (2 if is_mlp else 3) + (1 if c_slow > 1 else 0)
    if u.ndim != want_nd:
        raise ValueError(
            f"expected u.ndim={want_nd} for cell='{spec.cell}' "
            f"c_slow={c_slow}, got shape {tuple(u.shape)}")
    streams = u if c_slow > 1 else u[None]

    C_t = words_of(program.C, fmt, dev).T.contiguous()          # [M, P]
    beta_t = (words_of(program.beta, fmt, dev).T.contiguous()   # [L, M]
              if is_mlp else None)

    plan = _seu_plan(fault_plan)
    seu_watch = plan is not None and plan.watches("rtlsim.seu")
    seu_flips: list[dict] = []
    watch: dict | None = {} if collect_ranges else None

    ys, finals = [], {}
    cycles = 0
    for ci in range(streams.shape[0]):  # C independent interleaved streams
        u_q = words_of(streams[ci], fmt, dev)
        if is_mlp:
            # Create_Layer_beta: x0 = beta · u (the βuδ[k] injection)
            x = macc_layer(u_q, beta_t, W)
            states = [{name: x for name in qstages[0].stage.graph.states}]
            T = steps
            if watch is not None:
                _watch_update(watch, "inject.x0", x)
        else:
            states = [{name: torch.zeros(u_q.shape[:-2] + (w_,), dtype=torch.int64,
                                         device=dev)
                       for name, w_ in q.stage.graph.states.items()}
                      for q in qstages]
            T = u_q.shape[-2]
        for k in range(T):
            bus = None if is_mlp else u_q[..., k, :]
            for si, q in enumerate(qstages):
                new_states, out = step_graph(q, states[si], bus, k,
                                             unroll=unroll, watch=watch)
                states[si] = new_states
                bus = out
            if seu_watch:
                spec_f = plan.fire("rtlsim.seu")
                if spec_f is not None:
                    seu_flips.append(_seu_flip(plan, spec_f, states,
                                               qstages, W, ci, k))
        x_final = states[-1][program.readout_state]
        y = macc_layer(x_final, C_t, W)
        if watch is not None:
            _watch_update(watch, "readout.y", y)
            for q, st in zip(qstages, states):  # final write-back values
                for name, v in st.items():
                    _watch_update(watch, f"{q.stage.name}.{name}", v)
        cycles += _fsm_cycles_per_stream(program, unroll, T, is_mlp)
        ys.append(y)
        finals = {f"{q.stage.name}.{name}": v
                  for q, st in zip(qstages, states) for name, v in st.items()}

    y_codes = torch.stack(ys) if c_slow > 1 else ys[0]
    return RtlSimResult(
        y=y_codes.to(torch.float64) / fmt.scale,
        y_codes=y_codes,
        final_states=finals,
        cycles=cycles,
        width=W,
        fmt=fmt,
        seu_flips=seu_flips,
        wire_ranges=None if watch is None else _host_ranges(watch),
    )


def fsm_cycle_estimate(program: Program, T: int | None = None) -> int:
    """Predicted controller clocks for ONE full evaluation of ``program``
    (all C streams), without running the datapath — the cheap side of the
    predicted-vs-measured ledger (:mod:`repro_torch.obs.ledger`).

    Exactly the count :func:`simulate` reports as ``cycles`` for an input of
    ``T`` serial steps per stream (default: the schedule's step count).
    Width-independent: the FSM trace depends only on the schedule and graph
    shapes, never on word length.
    """
    sched = program.stages[0].schedule
    is_mlp = program.beta is not None
    steps = sched.steps if T is None else T
    return sched.c_slow * _fsm_cycles_per_stream(
        program, sched.unroll, steps, is_mlp)


__all__ = [
    "MIN_WIDTH",
    "QuantStage",
    "RtlSimResult",
    "af_addr",
    "af_lookup",
    "af_rom",
    "fsm_cycle_estimate",
    "limbs",
    "macc_layer",
    "macc_word",
    "simulate",
    "step_graph",
    "words_of",
    "wrap",
]
