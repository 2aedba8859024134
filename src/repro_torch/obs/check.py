"""Schema checks for exported observability documents; the port's copy of
``repro/obs/check.py``, which gives the same list of errors for the same
document.

    python -m repro_torch.obs.check trace.json metrics.json loadgen.json

Files are dispatched on content: a top-level ``traceEvents`` key is checked
as a Chrome trace, a ``repro.tune`` schema (or ``suite: tune``) as an
auto-tuner Pareto report, a ``repro.chaos`` schema (or ``suite: chaos``) as
a fault-injection report, a ``repro.loadgen`` schema as a trace-replay
report, a ``repro.analyze`` schema as a static-analysis report, anything
else as a metrics document.  The tune, analyze and chaos checks are pure
schema checks: the port does not write those documents yet.

Wherever a ``shard`` dimension appears (a ``shard=N`` metric label, a
``shard`` span arg, a ledger column, ``per_shard`` loadgen rows) it must be
a non-negative integer.
"""

from __future__ import annotations

import json
import re
import sys

_NUM = (int, float)

TRACE_PHASES = {"X", "B", "E", "i", "I", "C", "M", "b", "e", "n", "s", "t", "f"}

_SHARD_LABEL = re.compile(r"\bshard=([^,}]*)")


def _check_shard(value, where: str) -> list[str]:
    """A shard tag must be a non-negative integer (string digits accepted
    for flattened metric labels)."""
    if isinstance(value, bool) or not isinstance(value, (int, str)) \
            or (isinstance(value, str) and not value.isdigit()) \
            or int(value) < 0:
        return [f"{where}: shard {value!r} is not a non-negative integer"]
    return []


def check_trace_doc(doc) -> list[str]:
    """Validate the Chrome-trace-event JSON object format."""
    errs: list[str] = []
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        return ["trace: top level must be an object with 'traceEvents'"]
    events = doc["traceEvents"]
    if not isinstance(events, list):
        return ["trace: 'traceEvents' must be a list"]
    for i, ev in enumerate(events):
        where = f"trace: event[{i}]"
        if not isinstance(ev, dict):
            errs.append(f"{where} is not an object")
            continue
        ph = ev.get("ph")
        if ph not in TRACE_PHASES:
            errs.append(f"{where} has unknown phase {ph!r}")
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            errs.append(f"{where} missing 'name'")
        for key in ("pid", "tid"):
            if not isinstance(ev.get(key), int):
                errs.append(f"{where} missing integer '{key}'")
        if not isinstance(ev.get("ts"), _NUM):
            errs.append(f"{where} missing numeric 'ts'")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, _NUM) or dur < 0:
                errs.append(f"{where} complete event needs 'dur' >= 0")
        if ph in ("C", "M") and not isinstance(ev.get("args"), dict):
            errs.append(f"{where} phase {ph!r} needs an 'args' object")
        args = ev.get("args")
        if isinstance(args, dict) and "shard" in args:
            errs.extend(_check_shard(args["shard"], where))
    return errs


def check_metrics_doc(doc) -> list[str]:
    """Validate a metrics export: registry snapshot (+ optional stats and
    predicted-vs-measured ledger sections)."""
    errs: list[str] = []
    if not isinstance(doc, dict):
        return ["metrics: top level must be an object"]
    snap = doc.get("metrics")
    if not isinstance(snap, dict):
        return ["metrics: missing 'metrics' registry snapshot object"]
    for kind in ("counters", "gauges"):
        vals = snap.get(kind, {})
        if not isinstance(vals, dict):
            errs.append(f"metrics: '{kind}' must be an object")
            continue
        for name, v in vals.items():
            if not isinstance(v, _NUM):
                errs.append(f"metrics: {kind}[{name}] is not numeric")
            m = _SHARD_LABEL.search(name)
            if m:
                errs.extend(_check_shard(m.group(1),
                                         f"metrics: {kind}[{name}]"))
    hists = snap.get("histograms", {})
    if not isinstance(hists, dict):
        errs.append("metrics: 'histograms' must be an object")
        hists = {}
    for name, h in hists.items():
        if not isinstance(h, dict):
            errs.append(f"metrics: histograms[{name}] is not an object")
            continue
        for key in ("count", "sum", "p50", "p95", "p99"):
            if key not in h:
                errs.append(f"metrics: histograms[{name}] missing '{key}'")
            elif h[key] is not None and not isinstance(h[key], _NUM):
                errs.append(f"metrics: histograms[{name}].{key} not numeric")
    ledger = doc.get("ledger", [])
    if not isinstance(ledger, list):
        errs.append("metrics: 'ledger' must be a list")
        ledger = []
    for i, row in enumerate(ledger):
        if not isinstance(row, dict) or not isinstance(row.get("program"), str):
            errs.append(f"metrics: ledger[{i}] needs a string 'program'")
            continue
        for key in ("fsm_cycles", "flops", "measured_wall_us"):
            if key not in row:
                errs.append(f"metrics: ledger[{i}] missing '{key}'")
        if "shard" in row:
            errs.extend(_check_shard(row["shard"], f"metrics: ledger[{i}]"))
    if "stats" in doc and not isinstance(doc["stats"], dict):
        errs.append("metrics: 'stats' must be an object")
    return errs


def check_tune_doc(doc) -> list[str]:
    """Validate a ``repro.tune/v1`` Pareto report (the auto-tuner's JSON
    artifact): every candidate carries knobs + predicted scores, measured /
    pareto reference known candidate keys, and the winner is reproducible
    (spec + synthesize kwargs + cache key)."""
    errs: list[str] = []
    if not isinstance(doc, dict):
        return ["tune: top level must be an object"]
    if doc.get("schema") != "repro.tune/v1":
        errs.append(f"tune: unknown schema {doc.get('schema')!r}")
    if doc.get("suite") != "tune":
        errs.append("tune: 'suite' must be 'tune'")
    if "runs" in doc:  # BENCH_tune.json wrapper: one tune run per spec
        runs = doc["runs"]
        if not isinstance(runs, list) or not runs:
            return errs + ["tune: 'runs' must be a non-empty list"]
        for i, run in enumerate(runs):
            errs.extend(f"runs[{i}]: {e}" for e in check_tune_doc(run))
        return errs
    for key in ("spec", "spec_name", "objective"):
        if key not in doc:
            errs.append(f"tune: missing '{key}'")
    if doc.get("objective") not in ("latency", "throughput", "resources",
                                    None):
        errs.append(f"tune: unknown objective {doc.get('objective')!r}")
    cands = doc.get("candidates")
    keys: set[str] = set()
    if not isinstance(cands, list) or not cands:
        errs.append("tune: 'candidates' must be a non-empty list")
    else:
        for i, c in enumerate(cands):
            where = f"tune: candidates[{i}]"
            if not isinstance(c, dict):
                errs.append(f"{where} is not an object")
                continue
            if not isinstance(c.get("key"), str) or not c["key"]:
                errs.append(f"{where} needs a string 'key'")
            else:
                keys.add(c["key"])
            if not isinstance(c.get("knobs"), dict):
                errs.append(f"{where} needs a 'knobs' object")
            pred = c.get("predicted")
            if not isinstance(pred, dict):
                errs.append(f"{where} needs a 'predicted' object")
            else:
                for pk in ("fsm_cycles", "scores"):
                    if pk not in pred:
                        errs.append(f"{where}.predicted missing '{pk}'")
            if c.get("measured") is not None \
                    and not isinstance(c["measured"], dict):
                errs.append(f"{where}.measured must be an object or null")
    for section in ("measured", "pareto"):
        refs = doc.get(section)
        if not isinstance(refs, list):
            errs.append(f"tune: '{section}' must be a list of candidate keys")
            continue
        for k in refs:
            if k not in keys:
                errs.append(f"tune: {section} key {k!r} not in candidates")
    best = doc.get("best")
    if not isinstance(best, dict):
        errs.append("tune: missing 'best' object")
    else:
        if best.get("key") not in keys:
            errs.append(f"tune: best key {best.get('key')!r} not in candidates")
        if not isinstance(best.get("measured_objective"), _NUM):
            errs.append("tune: best.measured_objective not numeric")
        repro = best.get("repro")
        if not isinstance(repro, dict):
            errs.append("tune: best missing 'repro' object")
        else:
            for key in ("spec", "synthesize_kwargs", "cache_key"):
                if key not in repro:
                    errs.append(f"tune: best.repro missing '{key}'")
    baseline = doc.get("baseline")
    if baseline is not None and not isinstance(baseline, dict):
        errs.append("tune: 'baseline' must be an object or null")
    if "speedup" in doc and doc["speedup"] is not None \
            and not isinstance(doc["speedup"], _NUM):
        errs.append("tune: 'speedup' not numeric")
    return errs


def _check_findings(findings, where: str) -> tuple[list[str], dict]:
    """Shared finding-list validation; returns (errors, recount)."""
    errs: list[str] = []
    recount = {"errors": 0, "warnings": 0, "waived": 0}
    if not isinstance(findings, list):
        return [f"{where}: 'findings' must be a list"], recount
    for i, f in enumerate(findings):
        fw = f"{where}: findings[{i}]"
        if not isinstance(f, dict):
            errs.append(f"{fw} is not an object")
            continue
        for key in ("kind", "severity", "stage", "node", "detail"):
            if not isinstance(f.get(key), str) or not f[key]:
                errs.append(f"{fw} needs a string '{key}'")
        sev = f.get("severity")
        if sev not in ("error", "warning"):
            errs.append(f"{fw} unknown severity {sev!r}")
        if f.get("waived"):
            if not isinstance(f.get("waived_reason"), str) \
                    or not f["waived_reason"]:
                errs.append(f"{fw} waived without a 'waived_reason'")
            recount["waived"] += 1
        elif sev == "error":
            recount["errors"] += 1
        elif sev == "warning":
            recount["warnings"] += 1
        if f.get("id") is not None and isinstance(f.get("kind"), str) \
                and f.get("id") != f"{f['kind']}:{f.get('stage')}.{f.get('node')}":
            errs.append(f"{fw} id {f['id']!r} does not match kind:stage.node")
    return errs, recount


def _check_summary(doc, recount, where: str) -> list[str]:
    s = doc.get("summary")
    if not isinstance(s, dict):
        return [f"{where}: missing 'summary' object"]
    errs = []
    for key, want in recount.items():
        if s.get(key) != want:
            errs.append(f"{where}: summary.{key}={s.get(key)!r} but the "
                        f"findings list has {want}")
    if s.get("clean") != (recount["errors"] == 0
                          and recount["warnings"] == 0):
        errs.append(f"{where}: 'clean' flag inconsistent with counts")
    return errs


def check_analyze_doc(doc) -> list[str]:
    """Validate a ``repro.analyze/v1`` static-analysis report: a single-run
    doc (proven wire bounds + SNR model + findings with a consistent
    summary) or the CI sweep wrapper (``runs`` + optional ``lint`` block)."""
    errs: list[str] = []
    if not isinstance(doc, dict):
        return ["analyze: top level must be an object"]
    if doc.get("schema") != "repro.analyze/v1":
        errs.append(f"analyze: unknown schema {doc.get('schema')!r}")
    if doc.get("suite") != "analyze":
        errs.append("analyze: 'suite' must be 'analyze'")
    if "runs" in doc:  # the analyze-smoke sweep artifact
        runs = doc["runs"]
        if not isinstance(runs, list) or not runs:
            return errs + ["analyze: 'runs' must be a non-empty list"]
        for i, run in enumerate(runs):
            errs.extend(f"runs[{i}]: {e}" for e in check_analyze_doc(run))
        lint = doc.get("lint")
        if lint is not None:
            if not isinstance(lint, dict):
                errs.append("analyze: 'lint' must be an object")
            else:
                ferrs, recount = _check_findings(lint.get("findings"),
                                                 "analyze: lint")
                errs.extend(ferrs)
                errs.extend(_check_summary(lint, recount, "analyze: lint"))
        return errs
    spec = doc.get("spec")
    if not isinstance(spec, dict) or not spec.get("name"):
        errs.append("analyze: missing 'spec' object with a 'name'")
    if not isinstance(doc.get("width"), int) or doc["width"] < 1:
        errs.append("analyze: 'width' must be a positive integer")
    if not isinstance(doc.get("converged"), bool):
        errs.append("analyze: missing boolean 'converged'")
    if not isinstance(doc.get("iters"), int) or doc["iters"] < 0:
        errs.append("analyze: 'iters' must be a non-negative integer")
    snr = doc.get("static_snr_db")
    if snr is not None and not isinstance(snr, _NUM):
        errs.append("analyze: 'static_snr_db' must be numeric or null")
    msw = doc.get("min_safe_width")
    if msw is not None and (not isinstance(msw, int) or msw < 1):
        errs.append("analyze: 'min_safe_width' must be a positive integer "
                    "or null")
    wires = doc.get("wires")
    if not isinstance(wires, dict) or not wires:
        errs.append("analyze: 'wires' must be a non-empty object")
        wires = {}
    for key, w in wires.items():
        where = f"analyze: wires[{key}]"
        if not isinstance(w, dict):
            errs.append(f"{where} is not an object")
            continue
        for field in ("lo", "hi"):
            if not isinstance(w.get(field), int):
                errs.append(f"{where}.{field} must be an integer word")
        if isinstance(w.get("lo"), int) and isinstance(w.get("hi"), int) \
                and w["lo"] > w["hi"]:
            errs.append(f"{where}: lo > hi")
        for field in ("amp_real", "eps_real", "snr_db"):
            if not isinstance(w.get(field), _NUM):
                errs.append(f"{where}.{field} must be numeric")
        mwb = w.get("min_word_bits")
        if mwb is not None and (not isinstance(mwb, int) or mwb < 1):
            errs.append(f"{where}.min_word_bits must be a positive integer "
                        "or null")
    ferrs, recount = _check_findings(doc.get("findings"), "analyze")
    errs.extend(ferrs)
    errs.extend(_check_summary(doc, recount, "analyze"))
    return errs


def check_chaos_doc(doc) -> list[str]:
    """Validate a ``repro.chaos/v1`` fault-injection report: every scenario
    carries a verdict + its fault-plan hit counts, the per-class table only
    names registered fault points, and the aggregate flags are consistent
    with the scenarios they summarize."""
    errs: list[str] = []
    if not isinstance(doc, dict):
        return ["chaos: top level must be an object"]
    if doc.get("schema") != "repro.chaos/v1":
        errs.append(f"chaos: unknown schema {doc.get('schema')!r}")
    if doc.get("suite") != "chaos":
        errs.append("chaos: 'suite' must be 'chaos'")
    if not isinstance(doc.get("seed"), int):
        errs.append("chaos: missing integer 'seed'")
    scenarios = doc.get("scenarios")
    all_passed = True
    if not isinstance(scenarios, list) or not scenarios:
        errs.append("chaos: 'scenarios' must be a non-empty list")
        scenarios = []
    for i, sc in enumerate(scenarios):
        where = f"chaos: scenarios[{i}]"
        if not isinstance(sc, dict):
            errs.append(f"{where} is not an object")
            continue
        if not isinstance(sc.get("name"), str) or not sc["name"]:
            errs.append(f"{where} needs a string 'name'")
        if not isinstance(sc.get("passed"), bool):
            errs.append(f"{where} needs a boolean 'passed'")
        else:
            all_passed &= sc["passed"]
        faults = sc.get("faults")
        if not isinstance(faults, dict):
            errs.append(f"{where} needs a 'faults' hit-count object")
        else:
            for point, fires in faults.items():
                if not isinstance(fires, int) or fires < 0:
                    errs.append(f"{where}.faults[{point}] not a count")
    classes = doc.get("fault_classes")
    if not isinstance(classes, dict) or not classes:
        errs.append("chaos: 'fault_classes' must be a non-empty object")
        classes = {}
    for point, fires in classes.items():
        if not isinstance(fires, int) or fires < 0:
            errs.append(f"chaos: fault_classes[{point}] not a count")
    try:
        from repro_torch.runtime.faults import FAULT_POINTS

        unknown = set(classes) - set(FAULT_POINTS)
        if unknown:
            errs.append(f"chaos: unregistered fault classes {sorted(unknown)}")
        missing = set(FAULT_POINTS) - set(classes)
        if missing:
            errs.append(f"chaos: fault classes never exercised "
                        f"{sorted(missing)}")
    except ImportError:  # standalone check of a foreign report
        pass
    if doc.get("all_classes_hit") is not True:
        errs.append("chaos: 'all_classes_hit' must be true")
    elif any(v < 1 for v in classes.values()):
        errs.append("chaos: all_classes_hit claimed but some class has "
                    "zero fires")
    if not isinstance(doc.get("passed"), bool):
        errs.append("chaos: missing boolean 'passed'")
    elif doc["passed"] and not all_passed:
        errs.append("chaos: 'passed' true but a scenario failed")
    return errs


def check_loadgen_doc(doc) -> list[str]:
    """Validate a ``repro.loadgen/v1`` trace-replay report: a seeded spec,
    consistent request/token accounting, a stable tokens digest, and
    ``per_shard`` rows that sum to the aggregate (one row per data shard
    when a mesh is attached, a single shard-0 row otherwise)."""
    errs: list[str] = []
    if not isinstance(doc, dict):
        return ["loadgen: top level must be an object"]
    if doc.get("schema") != "repro.loadgen/v1":
        errs.append(f"loadgen: unknown schema {doc.get('schema')!r}")
    spec = doc.get("spec")
    if not isinstance(spec, dict):
        errs.append("loadgen: missing 'spec' object")
    else:
        for key in ("seed", "num_requests", "max_new_tokens"):
            if not isinstance(spec.get(key), int):
                errs.append(f"loadgen: spec.{key} must be an integer")
    for key in ("requests", "completed", "ticks", "decoded_tokens"):
        v = doc.get(key)
        if not isinstance(v, int) or v < 0:
            errs.append(f"loadgen: '{key}' must be a non-negative integer")
    if isinstance(doc.get("requests"), int) \
            and isinstance(doc.get("completed"), int) \
            and doc["completed"] > doc["requests"]:
        errs.append("loadgen: completed > requests")
    for key in ("wall_s", "throughput_tok_s"):
        if not isinstance(doc.get(key), _NUM) or doc[key] < 0:
            errs.append(f"loadgen: '{key}' must be a non-negative number")
    reasons = doc.get("by_reason")
    if not isinstance(reasons, dict):
        errs.append("loadgen: 'by_reason' must be an object")
    else:
        for reason, n in reasons.items():
            if not isinstance(n, int) or n < 0:
                errs.append(f"loadgen: by_reason[{reason}] not a count")
        if isinstance(doc.get("completed"), int) \
                and sum(n for n in reasons.values()
                        if isinstance(n, int)) != doc["completed"]:
            errs.append("loadgen: by_reason counts don't sum to 'completed'")
    if not isinstance(doc.get("tokens_digest"), str) \
            or not doc["tokens_digest"]:
        errs.append("loadgen: missing string 'tokens_digest'")
    mesh = doc.get("mesh")
    if mesh is not None:
        if not isinstance(mesh, dict):
            errs.append("loadgen: 'mesh' must be an object or null")
            mesh = None
        else:
            for key in ("dp", "tp"):
                if not isinstance(mesh.get(key), int) or mesh[key] < 1:
                    errs.append(f"loadgen: mesh.{key} must be a positive "
                                "integer")
            if mesh.get("layout") not in ("folded", "sharded"):
                errs.append(f"loadgen: mesh.layout {mesh.get('layout')!r} "
                            "must be 'folded' or 'sharded'")
    rows = doc.get("per_shard")
    if not isinstance(rows, list) or not rows:
        errs.append("loadgen: 'per_shard' must be a non-empty list")
        rows = []
    seen: set[int] = set()
    total = 0
    for i, row in enumerate(rows):
        where = f"loadgen: per_shard[{i}]"
        if not isinstance(row, dict):
            errs.append(f"{where} is not an object")
            continue
        errs.extend(_check_shard(row.get("shard"), where))
        if isinstance(row.get("shard"), int):
            if row["shard"] in seen:
                errs.append(f"{where} duplicate shard {row['shard']}")
            seen.add(row["shard"])
        for key in ("decoded_tokens", "dispatched", "quarantined"):
            v = row.get(key)
            if not isinstance(v, int) or v < 0:
                errs.append(f"{where}.{key} must be a non-negative integer")
        if isinstance(row.get("decoded_tokens"), int):
            total += row["decoded_tokens"]
    if rows and isinstance(doc.get("decoded_tokens"), int) \
            and not any(e.startswith("loadgen: per_shard") for e in errs) \
            and total != doc["decoded_tokens"]:
        errs.append(f"loadgen: per_shard decoded_tokens sum {total} != "
                    f"aggregate {doc['decoded_tokens']}")
    if mesh is not None and isinstance(mesh.get("dp"), int) \
            and rows and len(rows) != mesh["dp"]:
        errs.append(f"loadgen: {len(rows)} per_shard rows for dp={mesh['dp']}")
    return errs


def check_file(path: str) -> list[str]:
    try:
        with open(path) as fh:
            doc = json.load(fh)
    except (OSError, ValueError) as e:
        return [f"{path}: unreadable ({e})"]
    if isinstance(doc, dict) and "traceEvents" in doc:
        errs = check_trace_doc(doc)
    elif isinstance(doc, dict) and (
            str(doc.get("schema", "")).startswith("repro.tune")
            or doc.get("suite") == "tune"):
        errs = check_tune_doc(doc)
    elif isinstance(doc, dict) and (
            str(doc.get("schema", "")).startswith("repro.chaos")
            or doc.get("suite") == "chaos"):
        errs = check_chaos_doc(doc)
    elif isinstance(doc, dict) \
            and str(doc.get("schema", "")).startswith("repro.loadgen"):
        errs = check_loadgen_doc(doc)
    elif isinstance(doc, dict) and (
            str(doc.get("schema", "")).startswith("repro.analyze")
            or doc.get("suite") == "analyze"):
        errs = check_analyze_doc(doc)
    else:
        errs = check_metrics_doc(doc)
    return [f"{path}: {e}" for e in errs]


def main(argv: list[str] | None = None) -> int:
    from . import log

    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        log.warning("usage: python -m repro_torch.obs.check FILE [FILE ...]")
        return 2
    failures = 0
    for path in argv:
        errs = check_file(path)
        if errs:
            failures += 1
            for e in errs:
                log.warning(e)
        else:
            log.info(f"[ok] {path}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
