"""Pareto-report serialization: ``repro.tune/v1`` JSON + the obs-style
table; the port's copy of ``repro/tune/report.py``, schema unchanged.

The JSON document is the tuner's artifact contract, and
``repro_torch.obs.check`` validates it (schema drift fails the check
instead of shipping an unreadable report).  ``best.repro`` carries
everything needed to re-synthesize the winning configuration: the
``synthesize()`` kwargs, the spec fields, and the repr of the synthesis
memo ``cache_key``.
"""

from __future__ import annotations

import dataclasses
import json

TUNE_SCHEMA = "repro.tune/v1"


def _scored_doc(s) -> dict:
    d = {"key": s.key,
         "knobs": s.cand.knobs_dict(),
         "predicted": dict(s.predicted),
         "measured": dict(s.measured) if s.measured is not None else None,
         "validated": s.validated}
    if s.parity_error:
        d["parity_error"] = s.parity_error
    return d


def result_doc(result) -> dict:
    """A :class:`~repro_torch.tune.TuneResult` as the ``repro.tune/v1`` doc."""
    best = result.best
    doc = {
        "schema": TUNE_SCHEMA,
        "suite": "tune",
        "spec": dataclasses.asdict(result.spec),
        "spec_name": result.spec.name,
        "objective": result.objective,
        "candidates": [_scored_doc(s) for s in result.scored],
        "measured": [s.key for s in result.measured],
        "pareto": [s.key for s in result.pareto],
        "best": {
            "key": best.key,
            "knobs": best.cand.knobs_dict(),
            "measured_objective": (best.measured or {}).get("objective"),
            "repro": {
                "spec": dataclasses.asdict(best.cand.spec),
                "synthesize_kwargs": best.cand.synth_kwargs(),
                "cache_key": repr(result.cache_key),
            },
        },
        "baseline": {
            "key": result.baseline.key,
            "measured_objective":
                (result.baseline.measured or {}).get("objective"),
        },
        "speedup": result.speedup,
    }
    return doc


def write_doc(result, path: str) -> dict:
    doc = result_doc(result)
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=1, default=str)
    return doc


def format_table(result) -> str:
    """Measured-set table in the ``repro_torch.obs.report`` style: one row per
    measured candidate, predicted cycles next to measured objective so the
    predicted-vs-measured delta is visible at a glance."""
    obj = result.objective
    unit = {"latency": "us", "throughput": "us/tok",
            "resources": "area"}[obj]
    hdr = (f"{'candidate':<46} {'pred_cycles':>11} {'pred_score':>11} "
           f"{obj + '_' + unit:>14} {'valid':>6} {'front':>6}")
    lines = [f"tune[{result.spec.name}] objective={obj} "
             f"speedup_vs_default={result.speedup and f'{result.speedup:.2f}x' or 'n/a'}",
             hdr, "-" * len(hdr)]
    front_keys = {s.key for s in result.pareto}
    for s in result.measured:
        mark = {True: "ok", False: "FAIL", None: "-"}[s.validated]
        star = "*" if s.key == result.best.key else ""
        lines.append(
            f"{s.key + star:<46} "
            f"{s.predicted['fsm_cycles']:>11} "
            f"{s.predicted['scores'][obj]:>11.1f} "
            f"{s.measured['objective']:>14.2f} "
            f"{mark:>6} "
            f"{'yes' if s.key in front_keys else '':>6}")
    lines.append(f"(* = winner; {len(result.scored)} candidates predicted, "
                 f"{len(result.measured)} measured, "
                 f"{len(result.pareto)} on the Pareto front)")
    return "\n".join(lines)


__all__ = ["TUNE_SCHEMA", "format_table", "result_doc", "write_doc"]
