"""Two-phase design-space search: predict (free) → measure (top-k) →
difftest-validate (the paper's Fig. 10 loop, closed); the port's
counterpart of ``repro/tune/search.py``.

* **predict** — every candidate is costed WITHOUT building a backend:
  ``build_program`` (IR assembly, weights drawn on ``device``), rtlsim's
  FSM cycle model (:func:`~repro_torch.codegen.rtlsim.fsm_cycle_estimate`),
  the IR resource report (:func:`~repro_torch.codegen.verilog.report_program`)
  and the static analyzer give cycles, MACC-lane/ROM/register area, flops
  per inference and the static SNR / overflow profile.  Each distinct spec
  is built once.  Candidates are ranked by the objective's predicted
  score; ties break on the key under the reference's backend names
  (:attr:`~repro_torch.tune.space.Candidate.order_key`), so a grid ranks
  as the reference's does.
* **measure** — only the ``budget`` best-predicted candidates (plus the
  ``unroll=1, c_slow=1`` baseline, always) go through ``synthesize()``:
  build (``nvcc`` for a ``kernel`` candidate's stage kernels) + timed
  execution on ``device`` through the memo cache, with the wall-clock
  landing in the process ledger (:data:`repro_torch.obs.OBS`) next to the
  prediction.
* **validate** — walking the measured ranking, the first candidate that
  passes :func:`repro_torch.verify.difftest.validate_candidate` (the ref,
  eager and kernel float legs ≤ 1e-5, rtlsim bit-exact against the golden
  model) is the winner; parity failures are recorded on the candidate and
  skipped, so the tuner never returns a configuration that breaks backend
  parity.

Nothing here catches a real build or launch error: ``synthesize`` hops
backends only on an injected fault, and ``validate_candidate`` records a
crash as a failed gate, as the reference does.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Sequence

from repro_torch import obs as obs_lib
from repro_torch.analyze import analyze_program
from repro_torch.analyze.ranges import RANGE_KINDS
from repro_torch.codegen import build_program, report_program, rtlsim
from repro_torch.core import synthesis
from repro_torch.device import resolve_device
from repro_torch.obs import log

from .pareto import pareto_front
from .space import Candidate, baseline_candidate, enumerate_space

OBJECTIVES = ("latency", "throughput", "resources")
DEFAULT_BUDGET = 8


@dataclasses.dataclass
class Scored:
    """A candidate with its predict / measure / validate trajectory."""

    cand: Candidate
    predicted: dict                  # fsm_cycles, flops, score, resources…
    measured: dict | None = None     # wall_us, objective, tokens
    validated: bool | None = None    # None = never reached validation
    parity_error: str | None = None
    gate: Any = None                 # the difftest gate's result, once run

    @property
    def key(self) -> str:
        return self.cand.key


@dataclasses.dataclass
class TuneResult:
    spec: Any
    objective: str
    best: Scored                     # difftest-validated winner
    baseline: Scored                 # unroll=1, c_slow=1 default synthesis
    scored: list[Scored]             # full space, predict-ranked
    measured: list[Scored]           # measure subset, measured-ranked
    pareto: list[Scored]             # non-dominated (objective, resources)
    report: Any = None               # winner's SynthesisReport
    cache_key: tuple | None = None   # synthesis memo key of the winner

    @property
    def speedup(self) -> float | None:
        """baseline measured objective / winner measured objective (>1 =
        the tuner beat default synthesis)."""
        b = (self.baseline.measured or {}).get("objective")
        w = (self.best.measured or {}).get("objective")
        if not b or not w:
            return None
        return b / w

    def to_doc(self) -> dict:
        from .report import result_doc

        return result_doc(self)

    def table(self) -> str:
        from .report import format_table

        return format_table(self)


# ---------------------------------------------------------------------------
# predict phase — no backend build
# ---------------------------------------------------------------------------

def _tokens_per_launch(spec, batch: int) -> int:
    """Outputs produced by one forward launch: C-slow streams × batch ×
    (sequence steps for recurrent cells, 1 inference for the MLP form)."""
    steps = spec.seq_len if spec.cell != "mlp" else 1
    return max(1, spec.c_slow) * max(1, batch) * max(1, steps)


def resource_score(rr) -> float:
    """Scalar area proxy from a :class:`~repro_torch.codegen.ResourceReport`:
    DSP lanes weighted by word width, plus ROM and register bits — the
    quantities the paper's Table IV trades against cycle count."""
    return (rr.dsp_macc_lanes * rr.width_bits + rr.rom_bits
            + rr.state_reg_bits)


#: memoized per-(spec, device) static-analysis summaries for the predict
#: phase — candidates differing only in backend share one IR
_STATIC_PROFILE_CACHE: dict = {}


def static_profile(spec, device=None, program=None) -> dict:
    """The :mod:`repro_torch.analyze` summary the predict phase attaches to
    every candidate: a static quantization-SNR lower bound + minimal safe
    word length (the Fig. 11 axis as an accuracy score) and the count of
    error-grade overflow findings (the ``analyze_prune`` pruner's input).
    Purely static and memoized by spec and device; ``program`` (``spec``
    built on ``device``) saves a build.  ``max_iters`` is kept small
    because error-grade findings are step-0 facts and the SNR estimate only
    needs a bounded fixpoint prefix."""
    dev = resolve_device(device)
    cached = _STATIC_PROFILE_CACHE.get((spec, str(dev)))
    if cached is not None:
        return cached
    if program is None:
        program = build_program(spec, dev)
    res = analyze_program(program, max_iters=64)
    cached = {
        "static_snr_db": res.static_snr_db,
        "min_safe_width": res.min_safe_width,
        "overflow_errors": sum(
            1 for f in res.findings
            if f.severity == "error" and f.kind in RANGE_KINDS),
    }
    _STATIC_PROFILE_CACHE[(spec, str(dev))] = cached
    return cached


def predict_candidate(cand: Candidate, batch: int, device=None,
                      program=None) -> dict:
    """Cost-model pass for ONE candidate: IR build (or ``program``, the
    candidate's spec already built on ``device``) + rtlsim cycle estimate +
    IR resource report + static analyzer profile (SNR lower bound, minimal
    safe width, overflow-error count).  No backend build, no execution."""
    dev = resolve_device(device)
    if program is None:
        program = build_program(cand.spec, dev)
    rr = report_program(program)
    cycles = rtlsim.fsm_cycle_estimate(program)
    res = resource_score(rr)
    tokens = _tokens_per_launch(cand.spec, batch)
    profile = static_profile(cand.spec, dev, program)
    # Backend handicap: none.  The cycle model is the paper's FSM — it ranks
    # *schedules*, not eager-vs-kernel runtimes; both backends of the same
    # schedule share a prediction and the measure pass separates them.
    scores = {
        "latency": float(cycles),
        "throughput": float(cycles) / tokens,
        "resources": float(res),
    }
    return {"fsm_cycles": int(cycles),
            "flops_per_inference": int(rr.flops_per_inference),
            "dsp_macc_lanes": int(rr.dsp_macc_lanes),
            "rom_bits": int(rr.rom_bits),
            "state_reg_bits": int(rr.state_reg_bits),
            "width_bits": int(rr.width_bits),
            "resource_score": float(res),
            "tokens_per_launch": tokens,
            "static_snr_db": profile["static_snr_db"],
            "min_safe_width": profile["min_safe_width"],
            "overflow_errors": profile["overflow_errors"],
            "scores": scores}


def predict_rank(cands: Sequence[Candidate], objective: str,
                 batch: int, device=None) -> list[Scored]:
    """Predict-phase ranking: ascending predicted score, ties broken by the
    key under the reference's backend names — a fixed grid therefore
    always ranks identically, and as the reference's.  Each distinct spec
    is built once on ``device`` and dropped before the next."""
    if objective not in OBJECTIVES:
        raise ValueError(
            f"unknown objective '{objective}'; one of {OBJECTIVES}")
    dev = resolve_device(device)
    by_spec: dict[Any, list[Candidate]] = {}
    for c in cands:
        by_spec.setdefault(c.spec, []).append(c)
    scored = []
    for spec, group in by_spec.items():
        program = build_program(spec, dev)
        scored += [Scored(cand=c, predicted=predict_candidate(c, batch, dev, program))
                   for c in group]
        del program
    scored.sort(key=lambda s: (s.predicted["scores"][objective],
                               s.cand.order_key))
    return scored


# ---------------------------------------------------------------------------
# measure phase — builds top-k through the synthesize memo cache
# ---------------------------------------------------------------------------

def measure_candidate(cand: Candidate, batch: int, device=None) -> dict | None:
    """Build + time one candidate on ``device`` via ``synthesize``
    (memo-cached; a memoized build that was never timed under the
    candidate's ledger key is timed again there), then read the measured
    wall-clock back out of the process ledger.  Returns ``{"wall_us",
    "ledger_key", ...}``, or None when an injected fault degraded the build
    to another backend (the candidate was never built as itself); swapped
    out by tests for a stub timer."""
    dev = resolve_device(device)
    report = synthesis.synthesize(cand.spec, batch=batch, device=dev,
                                  **cand.synth_kwargs())
    if report.fallback_from is not None:
        return None
    lkey = synthesis._ledger_key(cand.spec, batch, cand.backend)
    [row] = [r for r in obs_lib.OBS.ledger.report(match=lkey)
             if r["program"] == lkey]
    return {"wall_us": float(row["measured_wall_us"]),
            "ledger_key": lkey,
            "predicted_fsm_cycles": row.get("fsm_cycles"),
            "implied_clock_mhz": row.get("implied_clock_mhz")}


def _measured_objective(s: Scored, objective: str) -> float:
    if objective == "resources":
        # area is exact from the IR — "measuring" it is the predict number
        return s.predicted["resource_score"]
    wall = s.measured["wall_us"]
    if objective == "throughput":
        return wall / s.predicted["tokens_per_launch"]   # us per token
    return wall                                          # latency: us/launch


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------

def tune(spec, optimize: str = "latency", budget: int | None = None,
         batch: int | None = None, *,
         backends: Sequence[str] = ("eager", "kernel"),
         space_kwargs: dict | None = None,
         analyze_prune: bool = False,
         measure_fn: Callable[[Candidate, int], dict | None] | None = None,
         validate_fn: Callable[..., Any] | None = None,
         device=None) -> TuneResult:
    """Close the Fig. 10 loop for ``spec`` on ``device`` (default: the
    card): enumerate → predict → measure → validate → Pareto report.

    ``budget`` caps the number of candidates that get built/timed
    (default :data:`DEFAULT_BUDGET`); the predict pass always covers the
    whole space.  ``analyze_prune=True`` drops candidates the static
    analyzer proves can wrap from reset (error-grade overflow findings)
    before the measure phase spends build budget on them — the baseline
    is always kept so ``speedup`` stays well-defined.  ``measure_fn(cand,
    batch)`` / ``validate_fn(spec, batch=)`` are dependency seams for tests
    (stub timer, injected parity breaks) and default to
    :func:`measure_candidate` / ``difftest.validate_candidate`` on
    ``device``.
    """
    budget = DEFAULT_BUDGET if budget is None else int(budget)
    if budget < 1:
        raise ValueError(f"budget={budget} must be >= 1")
    batch = batch or 1
    dev = resolve_device(device)
    real_measure = measure_fn is None
    if real_measure:
        measure_fn = functools.partial(measure_candidate, device=dev)
    if validate_fn is None:
        from repro_torch.verify.difftest import validate_candidate

        validate_fn = functools.partial(validate_candidate, device=dev)

    O = obs_lib.OBS
    with O.tracer.span("tune", cat="tune",
                       args={"spec": spec.name, "objective": optimize}):
        cands = enumerate_space(spec, backends=backends,
                                **(space_kwargs or {}))
        with O.tracer.span("tune.predict", cat="tune",
                           args={"candidates": len(cands)}):
            scored = predict_rank(cands, optimize, batch, dev)
        O.metrics.counter("tune_candidates", "design points enumerated",
                          phase="predict").inc(len(scored))
        base = baseline_candidate(spec, backend=backends[0])
        if analyze_prune:
            keep = [s for s in scored
                    if not s.predicted.get("overflow_errors")
                    or s.cand == base]
            pruned = len(scored) - len(keep)
            if pruned:
                O.metrics.counter("tune_candidates",
                                  "design points enumerated",
                                  phase="pruned").inc(pruned)
                log.info(f"tune[{spec.name}]: analyzer pruned {pruned} "
                         f"candidate(s) with provable reset-reachable "
                         f"overflow")
            scored = keep
        log.info(f"tune[{spec.name}|{optimize}]: {len(scored)} candidates, "
                 f"measuring top {min(budget, len(scored))} (+baseline)")

        # measure set: top-k predicted + the default-synthesis baseline
        to_measure = scored[:budget]
        base_scored = next((s for s in to_measure if s.cand == base), None)
        if base_scored is None:
            base_scored = next((s for s in scored if s.cand == base), None)
            if base_scored is None:
                base_scored = Scored(
                    cand=base, predicted=predict_candidate(base, batch, dev))
            to_measure = to_measure + [base_scored]

        measured: list[Scored] = []
        for s in to_measure:
            with O.tracer.span("tune.measure", cat="tune",
                               args={"candidate": s.key}):
                s.measured = measure_fn(s.cand, batch)
            if s.measured is None and optimize != "resources":
                log.info(f"tune: no measurement for {s.key}; dropped")
                continue
            s.measured = s.measured or {}
            s.measured["objective"] = _measured_objective(s, optimize)
            measured.append(s)
        O.metrics.counter("tune_candidates", "design points enumerated",
                          phase="measure").inc(len(measured))
        if not measured:
            raise RuntimeError(
                f"tune[{spec.name}]: no candidate produced a measurement")
        measured.sort(key=lambda s: (s.measured["objective"],
                                     s.cand.order_key))

        # difftest gate: walk the measured ranking until parity holds
        best = None
        for s in measured:
            with O.tracer.span("tune.validate", cat="tune",
                               args={"candidate": s.key}):
                res = validate_fn(s.cand.spec, batch=batch)
            s.gate = res
            s.validated = bool(res.ok)
            if res.ok:
                best = s
                break
            s.parity_error = res.error or "parity failure"
            O.metrics.counter("tune_parity_rejects",
                              "candidates rejected by the difftest gate").inc()
            log.info(f"tune: difftest REJECTED {s.key}: {s.parity_error}")
        if best is None:
            raise RuntimeError(
                f"tune[{spec.name}]: every measured candidate failed the "
                "difftest parity gate — this is a codegen bug, not a tuning "
                "failure; run python -m repro_torch.verify.difftest")

        front = pareto_front([(s.measured["objective"],
                               s.predicted["resource_score"])
                              for s in measured])
        pareto = [measured[i] for i in front]

        # the winner's reproducible synthesis: memo key + final report
        report = None
        if real_measure:
            report = synthesis.synthesize(best.cand.spec, batch=batch,
                                          device=dev,
                                          **best.cand.synth_kwargs())
        cache_key = synthesis._cache_key(best.cand.spec, batch,
                                         best.cand.backend, dev)
    return TuneResult(spec=spec, objective=optimize, best=best,
                      baseline=base_scored, scored=scored, measured=measured,
                      pareto=pareto, report=report, cache_key=cache_key)


__all__ = ["DEFAULT_BUDGET", "OBJECTIVES", "Scored", "TuneResult",
           "measure_candidate", "predict_candidate", "predict_rank",
           "resource_score", "static_profile", "tune"]
