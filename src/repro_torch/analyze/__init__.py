"""``repro_torch.analyze`` — static analysis for the codegen IR; the port's
counterpart of ``repro/analyze`` (its source lints, ``lint.py``, are not
ported yet: ROADMAP, Queue 1).

Three analyses over a scheduled :class:`~repro_torch.codegen.ir.Program`, all
purely static (no input data, no backend compile, no device dispatch):

* **range/overflow** (:mod:`.ranges` + :mod:`.intervals`): proven per-wire
  word bounds from the actual quantized ROM constants, with 2W-accumulator
  wrap / Q-align clip / AF-domain findings — falsified against rtlsim by
  ``python -m repro_torch.verify.difftest --trace-ranges``;
* **quantization error** (:mod:`.errors`): a static SNR lower bound and
  minimal safe word length per bus (the Fig. 11 axis, feeding the tuner's
  predict stage);
* **schedule hazards** (:mod:`.hazards`): unwritten/aliased state
  write-backs, dead datapath, broken cascades, degenerate schedules.

:func:`analyze_program` runs all of them and returns one
:class:`AnalyzeResult`; ``synthesize(spec, analyze=True)`` gates on its
unwaived errors (:class:`AnalysisError`), and ``python -m repro_torch.analyze``
is the CLI.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from .errors import error_model
from .hazards import analyze_hazards
from .intervals import Bd
from .ranges import analyze_ranges
from .report import (
    ANALYZE_SCHEMA,
    Finding,
    format_findings,
    format_table,
    result_doc,
    summarize,
    sweep_doc,
    write_doc,
)
from .waivers import WaiverRegistry


class AnalysisError(RuntimeError):
    """Raised by the ``synthesize(analyze=True)`` gate on unwaived
    error-grade findings; carries the findings for programmatic triage."""

    def __init__(self, message: str, findings: list[Finding]):
        super().__init__(message)
        self.findings = findings


@dataclasses.dataclass
class AnalyzeResult:
    spec: Any
    width: int
    input_range: float
    wires: dict[str, Bd]
    wire_stats: dict[str, dict]
    findings: list[Finding]
    converged: bool
    iters: int
    static_snr_db: float | None
    min_safe_width: int | None

    @property
    def errors(self) -> list[Finding]:
        return [f for f in self.findings
                if f.severity == "error" and not f.waived]

    @property
    def ok(self) -> bool:
        return not self.errors

    def to_doc(self) -> dict[str, Any]:
        return result_doc(self)


def analyze_program(program, width: int | None = None,
                    input_range: float = 1.0, max_iters: int = 512,
                    snr_target_db: float = 20.0,
                    waivers: WaiverRegistry | None = None) -> AnalyzeResult:
    """Run range + error-model + hazard analysis on ``program``."""
    rng = analyze_ranges(program, width=width, input_range=input_range,
                         max_iters=max_iters)
    em = error_model(program, rng.wires, rng.width,
                     input_range=input_range, snr_target_db=snr_target_db)
    findings = rng.findings + analyze_hazards(program)
    if waivers is not None:
        waivers.apply(findings)
    return AnalyzeResult(
        spec=program.spec,
        width=rng.width,
        input_range=rng.input_range,
        wires=rng.wires,
        wire_stats=em["wire_stats"],
        findings=findings,
        converged=rng.converged,
        iters=rng.iters,
        static_snr_db=em["static_snr_db"],
        min_safe_width=em["min_safe_width"],
    )


def analyze_spec(spec, device=None, **kwargs) -> AnalyzeResult:
    """Build the IR for ``spec`` on ``device`` (default: the card; parameter
    init only — no backend build) and analyze it on the host."""
    from repro_torch.codegen.builders import build_program

    return analyze_program(build_program(spec, device), **kwargs)


def gate(result: AnalyzeResult) -> None:
    """Raise :class:`AnalysisError` when unwaived error findings exist."""
    errs = result.errors
    if errs:
        lines = "; ".join(f"{f.id}: {f.detail}" for f in errs[:4])
        more = f" (+{len(errs) - 4} more)" if len(errs) > 4 else ""
        raise AnalysisError(
            f"static analysis found {len(errs)} unwaived error(s): "
            f"{lines}{more}", errs)


__all__ = [
    "ANALYZE_SCHEMA",
    "AnalysisError",
    "AnalyzeResult",
    "Bd",
    "Finding",
    "WaiverRegistry",
    "analyze_hazards",
    "analyze_program",
    "analyze_ranges",
    "analyze_spec",
    "error_model",
    "format_findings",
    "format_table",
    "gate",
    "result_doc",
    "summarize",
    "sweep_doc",
    "write_doc",
]
