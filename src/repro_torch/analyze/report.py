"""``repro.analyze/v1`` report documents — findings, run docs, CLI tables;
the port's copy of ``repro/analyze/report.py``, schema name unchanged.

One schema covers both shapes the toolchain emits:

* a **single-run doc** (one program at one width): proven per-wire bounds,
  the static SNR / minimal-word-length model, and the findings list;
* a **sweep doc** (the CI ``analyze-smoke`` artifact): ``{"runs": [...]}``
  of single-run docs plus an optional ``"lint"`` block from ``--lint-src``.

``repro_torch.obs.check`` validates both (``check_analyze_doc``), so a malformed
analyzer report fails CI the same way a malformed trace or tune report does.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

ANALYZE_SCHEMA = "repro.analyze/v1"

#: severity ladder: ``error`` findings gate ``synthesize(analyze=True)`` and
#: exit the CLI non-zero; ``warning`` findings are reported but do not gate.
SEVERITIES = ("error", "warning")


@dataclasses.dataclass
class Finding:
    """One analyzer diagnosis.

    ``id`` is the stable waiver handle (``kind:stage.node``).  ``step`` is
    the first FSM step the condition was provable at: step 0 means reachable
    from reset (states at their reset values, one adversarial input word) —
    those grade ``error``; later steps need a sustained adversarial input
    sequence and grade ``warning`` (possible, not certain).
    """

    kind: str
    severity: str
    stage: str
    node: str
    detail: str
    step: int | None = None
    lanes: int = 0
    waived: bool = False
    waived_reason: str | None = None

    @property
    def id(self) -> str:
        return f"{self.kind}:{self.stage}.{self.node}"

    def to_dict(self) -> dict[str, Any]:
        return {
            "id": self.id,
            "kind": self.kind,
            "severity": self.severity,
            "stage": self.stage,
            "node": self.node,
            "step": self.step,
            "lanes": self.lanes,
            "detail": self.detail,
            "waived": self.waived,
            "waived_reason": self.waived_reason,
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Finding":
        return cls(kind=d["kind"], severity=d["severity"], stage=d["stage"],
                   node=d["node"], detail=d["detail"], step=d.get("step"),
                   lanes=int(d.get("lanes", 0)),
                   waived=bool(d.get("waived", False)),
                   waived_reason=d.get("waived_reason"))


def summarize(findings: list[Finding]) -> dict[str, Any]:
    errors = sum(1 for f in findings if f.severity == "error" and not f.waived)
    warnings = sum(1 for f in findings
                   if f.severity == "warning" and not f.waived)
    waived = sum(1 for f in findings if f.waived)
    return {"errors": errors, "warnings": warnings, "waived": waived,
            "clean": errors == 0 and warnings == 0}


def result_doc(result) -> dict[str, Any]:
    """Single-run ``repro.analyze/v1`` document from an ``AnalyzeResult``.

    Per-wire bounds are flattened to scalar extremes (min lo / max hi over
    lanes) — the JSON artifact is for humans and CI gates; the exact
    per-lane intervals live on the in-memory result (difftest containment
    checks those directly).
    """
    spec = result.spec
    wires = {}
    for key, st in result.wire_stats.items():
        wires[key] = {
            "lo": int(min(st["bd"].lo)),
            "hi": int(max(st["bd"].hi)),
            "amp_real": round(float(st["amp_real"]), 9),
            "eps_real": float(st["eps_real"]),
            "snr_db": round(float(st["snr_db"]), 3),
            "min_word_bits": st["min_word_bits"],
        }
    return {
        "schema": ANALYZE_SCHEMA,
        "suite": "analyze",
        "spec": {
            "name": getattr(spec, "name", None),
            "cell": getattr(spec, "cell", None),
            "quant_bits": getattr(spec, "quant_bits", None),
        },
        "width": result.width,
        "input_range": result.input_range,
        "converged": result.converged,
        "iters": result.iters,
        "static_snr_db": (None if result.static_snr_db is None
                          else round(float(result.static_snr_db), 3)),
        "min_safe_width": result.min_safe_width,
        "wires": wires,
        "findings": [f.to_dict() for f in result.findings],
        "summary": summarize(result.findings),
    }


def sweep_doc(runs: list[dict[str, Any]],
              lint_findings: list[Finding] | None = None) -> dict[str, Any]:
    doc: dict[str, Any] = {"schema": ANALYZE_SCHEMA, "suite": "analyze",
                           "runs": runs}
    if lint_findings is not None:
        doc["lint"] = {"findings": [f.to_dict() for f in lint_findings],
                       "summary": summarize(lint_findings)}
    return doc


def write_doc(doc: dict[str, Any], path: str) -> None:
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=1, sort_keys=True)
        fh.write("\n")


def format_findings(findings: list[Finding]) -> str:
    if not findings:
        return "  no findings"
    lines = []
    for f in findings:
        mark = "~" if f.waived else ("!" if f.severity == "error" else "?")
        step = "-" if f.step is None else str(f.step)
        lines.append(f"  {mark} [{f.severity:7s}] {f.id:40s} "
                     f"step={step:>4s} {f.detail}")
    return "\n".join(lines)


def format_table(doc: dict[str, Any]) -> str:
    """Human summary of a single-run doc for the CLI."""
    rows = [f"{'wire':28s} {'lo':>12s} {'hi':>12s} {'amp':>9s} "
            f"{'snr dB':>8s} {'min W':>6s}"]
    for key in sorted(doc["wires"]):
        w = doc["wires"][key]
        snr = w["snr_db"]
        rows.append(
            f"{key:28s} {w['lo']:12d} {w['hi']:12d} {w['amp_real']:9.3f} "
            f"{('inf' if snr is None else f'{snr:.1f}'):>8s} "
            f"{str(w['min_word_bits']):>6s}")
    s = doc["summary"]
    rows.append(f"width={doc['width']} converged={doc['converged']} "
                f"iters={doc['iters']} static_snr_db={doc['static_snr_db']} "
                f"min_safe_width={doc['min_safe_width']}")
    rows.append(f"findings: {s['errors']} error(s), {s['warnings']} "
                f"warning(s), {s['waived']} waived")
    return "\n".join(rows)


__all__ = [
    "ANALYZE_SCHEMA",
    "SEVERITIES",
    "Finding",
    "format_findings",
    "format_table",
    "result_doc",
    "summarize",
    "sweep_doc",
    "write_doc",
]
