"""Program-level range/overflow analysis — the fixpoint loop; the port's
counterpart of ``repro/analyze/ranges.py``, with the same findings.

Mirrors :func:`repro_torch.codegen.rtlsim.simulate` step for step, but over the
interval domain of :mod:`repro_torch.analyze.intervals` and **without any input
data**: ROM words come from the actual quantized constants, input words
from the declared ``input_range``, AF outputs from the reachable ROM slice.

Propagation strategy per program shape:

* **mlp** (βuδ[k] injection, finite schedule): exact bounded run — the
  injection MACC seeds the state interval, then each of the
  ``schedule.steps`` FSM steps is evaluated with its exact per-step ROM
  page.  No fixpoint needed.
* **recurrent** (lstm/gru/ssm stacks, unbounded sequence length): Kleene
  iteration with accumulating join — states start at the reset point
  ``{0}``, each iteration joins the step transfer's result into the state
  intervals, and the loop stops when an iteration adds nothing (a forward
  invariant: sound for EVERY sequence length, because the transfer is
  monotone).  If the join is still growing after ``max_iters`` steps the
  still-moving registers are **widened** to the full word range (sound; a
  ``nonconverged`` warning records the precision loss) and one settle pass
  rebuilds the downstream hulls.

``unroll`` and ``c_slow`` never enter: unroll only re-schedules the serial
MACC (pad lanes gated off) and C-slow runs independent streams, so proven
bounds are invariant under both.

Severity grading: a flag first provable at **step 0** is graded ``error``
(reachable from reset — states at their reset values, one adversarial
input word) when it fires in the first stage or the injection; anything
later needs a sustained adversarial input sequence and grades ``warning``
(possible, not certain).  The difftest ``--trace-ranges`` soundness gate
checks the bounds; the zero-false-positive gate checks that shipped widths
produce zero *error*-grade range findings.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.codegen.ir import DatapathGraph, Program
from repro_torch.codegen.knobs import word_bits_reason
from repro_torch.codegen.rtlsim import DEFAULT_WIDTH, _COMB_AF, af_rom, words_of
from repro_torch.core.quantization import default_format

from .intervals import (
    Bd,
    MaccRom,
    addsub_raw,
    checked,
    af_bd,
    af_domain_lanes,
    lerp_lanes,
    macc_bd,
    mul_bd,
    word_max,
    word_min,
)
from .report import Finding

#: finding kinds the range pass can emit (hazards/lint have their own)
RANGE_KINDS = ("acc-wrap", "qalign-clip", "bias-wrap", "add-wrap",
               "sub-wrap", "mul-wrap", "af-domain", "nonconverged")


@dataclasses.dataclass
class RangeResult:
    width: int
    input_range: float
    wires: dict[str, Bd]          # 'stage.node' (+ inject.x0 / readout.y)
    findings: list[Finding]
    converged: bool
    iters: int


class _Recorder:
    """Dedupes flags to one Finding per (kind, stage, node), keeping the
    FIRST step each condition became provable — that step decides
    severity."""

    def __init__(self, first_stage: str):
        self.first_stage = first_stage
        self.found: dict[tuple, Finding] = {}
        self._stage = "?"
        self._step: int | None = None

    def at(self, stage: str, step: int | None) -> None:
        self._stage, self._step = stage, step

    #: kinds that never gate: an AF input past the ROM domain clamps to the
    #: end entry, which for the saturating activations IS the saturation
    #: value — informative, not a wrap; non-convergence is a precision
    #: limitation of the analyzer, not a property of the program
    WARN_ONLY = ("af-domain", "nonconverged")

    def flag_for(self, node: str):
        stage, step = self._stage, self._step
        certain = step == 0 and stage in (self.first_stage, "inject")

        def flag(kind: str, lanes: list[int], detail: str) -> None:
            key = (kind, stage, node)
            f = self.found.get(key)
            if f is None:
                self.found[key] = Finding(
                    kind=kind,
                    severity="error" if certain
                    and kind not in self.WARN_ONLY else "warning",
                    stage=stage, node=node, detail=detail, step=step,
                    lanes=len(lanes))
            else:
                f.lanes = max(f.lanes, len(lanes))

        return flag

    @property
    def findings(self) -> list[Finding]:
        return list(self.found.values())


def _quant_stage(stage, fmt):
    """The stage's ROMs as int64 word tensors on its params' device — each
    MACC weight ROM prepared once as a :class:`MaccRom` (a list of them,
    one a page, for per-step weights) — and its AF ROMs as lists of words."""
    weights = {m.inputs[1] for m in stage.graph.macc_nodes()}
    roms = {}
    for n in stage.graph.consts():
        words = words_of(stage.params[n.name], fmt)
        if n.name in weights:
            words = ([MaccRom.of(p) for p in words] if n.attr("per_step")
                     else MaccRom.of(words))
        roms[n.name] = words
    af_roms = {fn: af_rom(fn, fmt).tolist()
               for fn in {n.attr("fn") for n in stage.graph.af_nodes()}
               if fn not in _COMB_AF}
    return roms, af_roms


def _const_bd(entry: dict, k: int | None) -> Bd:
    """A const used as a bus value (bias / elementwise operand): row 0 of
    the page, matching rtlsim's ``bias[0]``; any-step mode hulls pages."""
    rows = entry["rows"]
    if entry["per_step"]:
        if k is not None:
            rows = rows[k]
        else:
            pages = rows[:, 0]
            return Bd(tuple(pages.amin(dim=0).tolist()),
                      tuple(pages.amax(dim=0).tolist()))
    return Bd.point(rows[0].tolist())


def _as_bd(v, k: int | None) -> Bd:
    return _const_bd(v, k) if isinstance(v, dict) else v


def _try_lerp(graph: DatapathGraph, n, env, k, width):
    """Detect ``add(a, mul(z, sub(x, a)))`` (any operand order) and return
    ``(a_bd, x_bd, refinable_lane_set)`` or None."""
    for an, mn in ((n.inputs[0], n.inputs[1]), (n.inputs[1], n.inputs[0])):
        m = graph.node(mn)
        if m.op != "mul":
            continue
        for zn, dn in ((m.inputs[0], m.inputs[1]), (m.inputs[1], m.inputs[0])):
            d = graph.node(dn)
            if d.op != "sub" or d.inputs[1] != an:
                continue
            a_bd = _as_bd(env[an], k)
            x_bd = _as_bd(env[d.inputs[0]], k)
            z_bd = _as_bd(env[zn], k)
            lanes = lerp_lanes(a_bd, x_bd, z_bd, width)
            if lanes:
                return a_bd, x_bd, set(lanes)
    return None


def step_bounds(graph: DatapathGraph, roms: dict, af_roms: dict,
                states: dict[str, Bd], u: Bd | None, k: int | None,
                width: int, rec: _Recorder):
    """One FSM step over intervals — the interval twin of
    ``rtlsim.step_graph``.  ``k`` selects the per-step ROM page; ``k=None``
    means "any step" (fixpoint mode: per-step ROMs are hulled over pages).
    Returns ``(new_states, out_bd, env)``.
    """
    env: dict = {}
    for n in graph.nodes:
        flag = rec.flag_for(n.name)
        if n.op == "input":
            if u is None:
                raise ValueError(f"graph has input '{n.name}' but no bound")
            env[n.name] = u
        elif n.op == "state":
            env[n.name] = states[n.name]
        elif n.op == "const":
            env[n.name] = {"rows": roms[n.name],
                           "per_step": bool(n.attr("per_step"))}
        elif n.op == "macc":
            x = _as_bd(env[n.inputs[0]], k)
            w = env[n.inputs[1]]
            bias = (_as_bd(env[n.inputs[2]], k)
                    if len(n.inputs) == 3 else None)
            if not isinstance(w, dict):
                raise ValueError(
                    f"macc '{n.name}': non-const weight is not analyzable")
            if w["per_step"] and k is None:
                out = None
                for page in w["rows"]:
                    r = macc_bd(x, page, width, bias=bias, flag=flag)
                    out = r if out is None else out.join(r)
                env[n.name] = out
            else:
                rows = w["rows"][k] if w["per_step"] else w["rows"]
                env[n.name] = macc_bd(x, rows, width, bias=bias, flag=flag)
        elif n.op == "af":
            x = _as_bd(env[n.inputs[0]], k)
            fn = n.attr("fn")
            env[n.name] = af_bd(x, fn, af_roms.get(fn), width, flag=flag)
        elif n.op == "concat":
            parts = [_as_bd(env[i], k) for i in n.inputs]
            env[n.name] = Bd(tuple(v for p in parts for v in p.lo),
                             tuple(v for p in parts for v in p.hi))
        elif n.op == "slice":
            x = _as_bd(env[n.inputs[0]], k)
            a, b = n.attr("start"), n.attr("stop")
            env[n.name] = Bd(x.lo[a:b], x.hi[a:b])
        elif n.op == "mul":
            env[n.name] = mul_bd(_as_bd(env[n.inputs[0]], k),
                                 _as_bd(env[n.inputs[1]], k), width,
                                 flag=flag)
        elif n.op == "sub":
            a, b = _as_bd(env[n.inputs[0]], k), _as_bd(env[n.inputs[1]], k)
            lo, hi = addsub_raw("sub", a, b)
            env[n.name] = checked(lo, hi, width, "sub-wrap", flag)
        elif n.op == "add":
            a, b = _as_bd(env[n.inputs[0]], k), _as_bd(env[n.inputs[1]], k)
            lo, hi = addsub_raw("add", a, b)
            hit = _try_lerp(graph, n, env, k, width)
            if hit is not None:
                a_bd, x_bd, ok = hit
                for i in ok:  # hull(a, x) is exact for the lerp write-back
                    lo[i] = min(a_bd.lo[i], x_bd.lo[i])
                    hi[i] = max(a_bd.hi[i], x_bd.hi[i])
            env[n.name] = checked(lo, hi, width, "add-wrap", flag)
        else:  # pragma: no cover - validate() rejects earlier
            raise ValueError(f"unknown op {n.op}")
    new_states = {s: _as_bd(env[src], k) for s, src in graph.updates.items()}
    out = _as_bd(env[graph.output], k) if graph.output is not None else None
    return new_states, out, env


def _record_env(wires: dict[str, Bd], stage_name: str, graph, env) -> None:
    for n in graph.nodes:
        if n.op == "const":
            continue
        key = f"{stage_name}.{n.name}"
        bd = env[n.name]
        prev = wires.get(key)
        wires[key] = bd if prev is None else prev.join(bd)


def _record_states(wires, stage_name, states) -> None:
    for name, bd in states.items():
        key = f"{stage_name}.{name}"
        prev = wires.get(key)
        wires[key] = bd if prev is None else prev.join(bd)


def input_word_bounds(input_range: float, fmt) -> tuple[int, int]:
    """Input-bus word interval for reals in ``[-r, r]`` — through the same
    round+saturate quantizer rtlsim applies to the stimulus."""
    r = abs(float(input_range))
    lo = int(words_of(np.array([-r]), fmt)[0])
    hi = int(words_of(np.array([r]), fmt)[0])
    return lo, hi


def analyze_ranges(program: Program, width: int | None = None,
                   input_range: float = 1.0,
                   max_iters: int = 512) -> RangeResult:
    """Prove per-wire word bounds for ``program`` — statically."""
    spec = program.spec
    W = width if width is not None else (
        getattr(spec, "quant_bits", None) or DEFAULT_WIDTH)
    reason = word_bits_reason(W)
    if reason is not None:
        raise ValueError(f"analyze: {reason}")
    fmt = default_format(W)
    quant = [_quant_stage(st, fmt) for st in program.stages]
    is_mlp = program.beta is not None
    rec = _Recorder(first_stage=program.stages[0].name)
    wires: dict[str, Bd] = {}

    u_lo, u_hi = input_word_bounds(input_range, fmt)

    if is_mlp:
        stage = program.stages[0]
        roms, af_roms = quant[0]
        beta_t = MaccRom.of(words_of(program.beta, fmt).T)
        rec.at("inject", 0)
        x0 = macc_bd(Bd.span(u_lo, u_hi, program.beta.shape[1]), beta_t, W,
                     flag=rec.flag_for("x0"))
        wires["inject.x0"] = x0
        states = {name: x0 for name in stage.graph.states}
        _record_states(wires, stage.name, states)
        T = stage.schedule.steps
        for k in range(T):
            rec.at(stage.name, k)
            states, _, env = step_bounds(stage.graph, roms, af_roms,
                                         states, None, k, W, rec)
            _record_env(wires, stage.name, stage.graph, env)
            _record_states(wires, stage.name, states)
        converged, iters = True, T
        x_read = states[program.readout_state]
    else:
        states = [{name: Bd.point([0] * lanes)
                   for name, lanes in st.graph.states.items()}
                  for st in program.stages]
        for si, st in enumerate(program.stages):
            _record_states(wires, st.name, states[si])
        converged = False
        iters = 0
        for k in range(max_iters):
            iters = k + 1
            changed = False
            bus: Bd | None = Bd.span(
                u_lo, u_hi,
                program.stages[0].graph.input_node().width)
            for si, st in enumerate(program.stages):
                rec.at(st.name, k)
                roms, af_roms = quant[si]
                new_states, out, env = step_bounds(
                    st.graph, roms, af_roms, states[si], bus, None, W, rec)
                joined = {name: states[si][name].join(new_states[name])
                          for name in states[si]}
                if joined != states[si]:
                    changed = True
                    states[si] = joined
                _record_env(wires, st.name, st.graph, env)
                _record_states(wires, st.name, joined)
                bus = out
            if not changed:
                converged = True
                break
        if not converged:
            # widen the still-moving registers to the full word range (a
            # wrapped/creeping register is still SOME word — sound, just
            # imprecise) and settle the downstream hulls once
            for si, st in enumerate(program.stages):
                rec.at(st.name, iters)
                for name in st.graph.states:
                    full = Bd.full(W, st.graph.states[name])
                    if not states[si][name].contains(full):
                        rec.flag_for(name)(
                            "nonconverged", list(range(full.lanes)),
                            f"state bound still growing after {iters} "
                            "joined steps; widened to the full word range")
                        states[si][name] = full
                _record_states(wires, st.name, states[si])
            bus = Bd.span(u_lo, u_hi,
                          program.stages[0].graph.input_node().width)
            for si, st in enumerate(program.stages):
                rec.at(st.name, iters)
                roms, af_roms = quant[si]
                new_states, out, env = step_bounds(
                    st.graph, roms, af_roms, states[si], bus, None, W, rec)
                states[si] = {name: states[si][name].join(new_states[name])
                              for name in states[si]}
                _record_env(wires, st.name, st.graph, env)
                _record_states(wires, st.name, states[si])
                bus = out
        x_read = states[-1][program.readout_state]

    c_t = MaccRom.of(words_of(program.C, fmt).T)
    rec.at("readout", None)
    wires["readout.y"] = macc_bd(x_read, c_t, W, flag=rec.flag_for("y"))

    return RangeResult(width=W, input_range=float(input_range), wires=wires,
                       findings=rec.findings, converged=converged,
                       iters=iters)


def af_domain_violations(stage, width: int | None,
                         input_range: float = 1.0,
                         max_iters: int = 8) -> list[str]:
    """Cheap ``ir.Stage.validate`` helper: AF nodes whose input interval is
    ENTIRELY outside the 64-entry ROM's addressable domain — every lookup
    would read a clamped end entry, so the activation is a constant and the
    graph is almost certainly mis-scaled.  A short (non-convergent is fine)
    propagation is enough: bounds only grow, so "entirely outside" at any
    prefix of the fixpoint is already proof.
    """
    if width is None:
        width = DEFAULT_WIDTH
    fmt = default_format(width)
    roms, af_roms = _quant_stage(stage, fmt)
    rec = _Recorder(first_stage=stage.name)
    g = stage.graph
    u_lo, u_hi = input_word_bounds(input_range, fmt)
    in_node = g.input_node()
    u = Bd.span(u_lo, u_hi, in_node.width) if in_node is not None else None
    # recurrent stages reset to 0 (a known over-approximation start); a
    # stage with no input node is state-injected from outside (mlp β), so
    # seed full range — only const-driven paths can then prove a violation
    seed = ((lambda lanes: Bd.point([0] * lanes)) if in_node is not None
            else (lambda lanes: Bd.full(width, lanes)))
    states = {name: seed(lanes) for name, lanes in g.states.items()}
    per_step = bool(g.consts(per_step=True))
    bad: list[str] = []
    steps = min(max_iters, stage.schedule.steps) if per_step else max_iters
    for k in range(max(1, steps)):
        rec.at(stage.name, k)
        new_states, _, env = step_bounds(
            g, roms, af_roms, states, u, k if per_step else None, width, rec)
        for n in g.af_nodes():
            if n.attr("fn") in _COMB_AF:
                continue
            x = _as_bd(env[n.inputs[0]], k if per_step else None)
            if len(af_domain_lanes(x, width, entire=True)) == x.lanes:
                if n.name not in bad:
                    bad.append(n.name)
        joined = {name: states[name].join(new_states[name])
                  for name in states}
        if joined == states:
            break
        states = joined
    return bad


__all__ = [
    "RANGE_KINDS",
    "RangeResult",
    "af_domain_violations",
    "analyze_ranges",
    "input_word_bounds",
    "step_bounds",
]
