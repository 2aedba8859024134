"""Seeded chaos suite: every registered fault class, injected and verified;
the port's counterpart of ``repro/verify/chaos.py``.

The robustness contract is that under every fault point in
:data:`repro_torch.runtime.faults.FAULT_POINTS` the stack (a) retires
affected requests with a structured ``finish_reason``, (b) keeps unaffected
slots bit-identical to a fault-free run, and (c) never hangs — the watchdog
bounds any stall.  This module *proves* that, one scenario per fault class,
against a real model on ``--device`` (default: the card):

    python -m repro_torch.verify.chaos --seed 0 --out chaos.json

The report is ``repro.chaos/v1`` JSON (schema-checked by
``python -m repro_torch.obs.check chaos.json``): per-scenario pass/fail with
the fault plan's fire counts, plus the aggregated per-class hit table
(every class >= 1 fire).  Everything is seeded — the same ``--seed``
replays the identical fault schedule.  The model's weights are drawn from
``torch.Generator(device).manual_seed(0)`` (not the reference's numbers);
:func:`run_suite` also takes a ``cfg`` (a full-width one, say) and
``params`` (the reference's, through :mod:`repro_torch.bridge`).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch import obs as obs_lib
from repro_torch._tree import tree_leaves
from repro_torch.device import resolve_device
from repro_torch.runtime import DecodeServer, Request, SchedulerConfig
from repro_torch.runtime import faults as fl

SCHEMA = "repro.chaos/v1"


# ---------------------------------------------------------------------------
# Harness plumbing
# ---------------------------------------------------------------------------

def _server(cfg, params, *, persistent=False, plan=None, watchdog_s=None,
            prefix_mb=0, slots=4, sched=None) -> DecodeServer:
    return DecodeServer(
        cfg, params, num_slots=slots, max_seq=96, block_k=4,
        persistent=persistent, prefix_cache_bytes=prefix_mb << 20,
        scheduler=sched if sched is not None else SchedulerConfig(),
        obs=obs_lib.Observability(), faults=plan, watchdog_s=watchdog_s,
        device=tree_leaves(params)[0].device)


def _requests(cfg, n: int, seed: int, max_new: int = 6,
              deadline_s=None) -> list[Request]:
    rng = np.random.default_rng(seed)
    return [Request(uid=i,
                    prompt=[int(t) for t in rng.integers(1, cfg.vocab, 6)],
                    max_new_tokens=max_new, deadline_s=deadline_s)
            for i in range(n)]


def _by_reason(done: list[Request]) -> dict[str, int]:
    out: dict[str, int] = {}
    for r in done:
        out[r.finish_reason] = out.get(r.finish_reason, 0) + 1
    return out


def _scenario(name: str, plan: "fl.FaultPlan | None", passed: bool,
              detail: dict) -> dict:
    return {"name": name, "passed": bool(passed),
            "faults": dict(plan.hits) if plan is not None else {},
            "detail": detail}


# ---------------------------------------------------------------------------
# Scenarios — one per fault class, plus the deadline/shed paths
# ---------------------------------------------------------------------------

def scenario_quarantine(cfg, params, seed: int, persistent: bool) -> dict:
    """NaN poison in one slot: that request retires ``error:nonfinite``,
    every survivor's token stream is bit-identical to a fault-free run."""
    point = "decode.nan_carry" if persistent else "decode.nan_logits"
    baseline = _server(cfg, params, persistent=persistent)
    for r in _requests(cfg, 4, seed):
        baseline.submit(r)
    clean = {r.uid: list(r.out_tokens) for r in baseline.run_until_drained()}

    plan = fl.FaultPlan([fl.FaultSpec(point, after=1)], seed=seed)
    srv = _server(cfg, params, persistent=persistent, plan=plan)
    for r in _requests(cfg, 4, seed):
        srv.submit(r)
    done = srv.run_until_drained()
    reasons = _by_reason(done)
    bad = [r for r in done if r.finish_reason == "error:nonfinite"]
    survivors_ok = all(
        list(r.out_tokens) == clean[r.uid]
        for r in done if r.finish_reason != "error:nonfinite")
    passed = (len(done) == 4 and len(bad) == 1 and survivors_ok
              and plan.hits[point] >= 1)
    return _scenario(f"quarantine_{'block' if persistent else 'step'}",
                     plan, passed,
                     {"reasons": reasons, "survivors_identical": survivors_ok,
                      "health": srv.health()["status"]})


def scenario_dispatch_retry(cfg, params, seed: int) -> dict:
    """A transient dispatch fault costs retries, never correctness."""
    plan = fl.FaultPlan([fl.FaultSpec("decode.dispatch", times=3)], seed=seed)
    srv = _server(cfg, params, plan=plan)
    for r in _requests(cfg, 4, seed):
        srv.submit(r)
    done = srv.run_until_drained()
    retries = int(srv.obs.metrics.value("decode_dispatch_retries"))
    ok_reasons = all(r.finish_reason in ("eos", "max_tokens", "out_of_cache")
                     for r in done)
    passed = len(done) == 4 and ok_reasons and retries >= 3
    return _scenario("dispatch_retry", plan, passed,
                     {"reasons": _by_reason(done), "retries": retries})


def scenario_stall_watchdog(cfg, params, seed: int) -> dict:
    """A *permanent* dispatch fault must not hang: the watchdog aborts all
    in-flight requests with ``error:stalled`` within its bound."""
    plan = fl.FaultPlan([fl.FaultSpec("decode.dispatch", times=None)],
                        seed=seed)
    srv = _server(cfg, params, plan=plan, watchdog_s=0.25)
    for r in _requests(cfg, 4, seed):
        srv.submit(r)
    t0 = time.perf_counter()
    done = srv.run_until_drained()
    wall = time.perf_counter() - t0
    health = srv.health()
    stalled = [r for r in done if r.finish_reason == "error:stalled"]
    passed = (len(done) == 4 and len(stalled) == 4
              and health["stalled_events"] >= 1
              and health["status"] == "stalled" and wall < 30.0)
    return _scenario("stall_watchdog", plan, passed,
                     {"reasons": _by_reason(done), "wall_s": round(wall, 3),
                      "health": health["status"],
                      "stalled_events": health["stalled_events"]})


def scenario_splice_corruption(cfg, params, seed: int) -> dict:
    """A corrupted prefix-cache splice is caught by the same non-finite
    quarantine — the re-submitted prompt retires ``error:nonfinite``."""
    plan = fl.FaultPlan([fl.FaultSpec("prefix.splice")], seed=seed)
    srv = _server(cfg, params, plan=plan, prefix_mb=64)
    [first] = _requests(cfg, 1, seed)
    srv.submit(first)
    srv.run_until_drained()
    again = _requests(cfg, 1, seed)[0]
    again.uid = 1
    srv.submit(again)
    done = srv.run_until_drained()
    passed = (again.finish_reason == "error:nonfinite"
              and again.prefix_hit_tokens == len(again.prompt)
              and plan.hits["prefix.splice"] == 1)
    return _scenario("splice_corruption", plan, passed,
                     {"reasons": _by_reason(done),
                      "prefix_hit_tokens": again.prefix_hit_tokens})


def scenario_slow_tick(cfg, params, seed: int) -> dict:
    """tick.slow is latency-only: everything still completes."""
    plan = fl.FaultPlan([fl.FaultSpec("tick.slow", times=2, delay_s=0.02)],
                        seed=seed)
    srv = _server(cfg, params, plan=plan)
    for r in _requests(cfg, 3, seed):
        srv.submit(r)
    done = srv.run_until_drained()
    passed = (len(done) == 3 and plan.hits["tick.slow"] == 2
              and all(r.finish_reason in ("eos", "max_tokens")
                      for r in done))
    return _scenario("slow_tick", plan, passed,
                     {"reasons": _by_reason(done)})


def scenario_deadlines(cfg, params, seed: int) -> dict:
    """TTL semantics: ``deadline_s<=0`` expires at submit, a queued request
    past its deadline reaps as ``expired:queue`` — and every expiry still
    carries latency stamps."""
    srv = _server(cfg, params, slots=2)
    head = _requests(cfg, 2, seed, max_new=6)
    tail = _requests(cfg, 4, seed, max_new=6, deadline_s=1e-4)
    for i, r in enumerate(tail):
        r.uid = 2 + i
    zero = _requests(cfg, 1, seed, deadline_s=0.0)[0]
    zero.uid = 99
    for r in head + tail:
        srv.submit(r)
    srv.submit(zero)
    done = srv.run_until_drained()
    reasons = _by_reason(done)
    stamped = all(r.submitted_at is not None and r.retired_at is not None
                  for r in done)
    passed = (len(done) == 7 and zero.finish_reason == "expired:queue"
              and reasons.get("expired:queue", 0) >= 3 and stamped)
    return _scenario("deadlines", None, passed,
                     {"reasons": reasons, "stamped": stamped})


def scenario_synth_fallback(seed: int, device=None) -> dict:
    """A persistent build fault degrades the eager backend down to the
    reference forward instead of failing the synthesis."""
    from repro_torch.core.synthesis import (NetworkSpec, synthesize,
                                            synthesize_cache_clear)

    spec = NetworkSpec(num_inputs=4, num_hidden_layers=2, nodes_per_layer=8,
                       num_outputs=2, seed=seed)
    plan = fl.FaultPlan([fl.FaultSpec("synth.compile", times=3)], seed=seed)
    synthesize_cache_clear()
    with fl.active(plan):
        rep = synthesize(spec, batch=2, backend="eager", measure=False,
                         backoff_s=0.0, device=device)
    synthesize_cache_clear()
    passed = (rep.backend == "ref" and rep.fallback_from == "eager"
              and plan.hits["synth.compile"] == 3)
    return _scenario("synth_fallback", plan, passed,
                     {"backend": rep.backend,
                      "fallback_from": rep.fallback_from})


def scenario_rtlsim_seu(seed: int, device=None, program=None) -> dict:
    """One SEU bit flip diverges the RTL sim from the clean run, is recorded
    in ``seu_flips``, and replays identically for the same plan seed.
    ``program`` replaces the scenario's own (the same spec's weights from
    elsewhere, e.g. the reference's through the bridge)."""
    from repro_torch import codegen
    from repro_torch.core.synthesis import NetworkSpec

    dev = resolve_device(device)
    if program is None:
        spec = NetworkSpec(num_inputs=4, num_hidden_layers=3,
                           nodes_per_layer=8, num_outputs=2, quant_bits=16,
                           seed=seed)
        program = codegen.build_program(spec, dev)
    u = np.random.default_rng(seed).uniform(-1, 1, (2, 4))
    clean = codegen.rtlsim.simulate(program, u, device=dev)

    def run():
        plan = fl.FaultPlan([fl.FaultSpec("rtlsim.seu", after=1)], seed=seed)
        return codegen.rtlsim.simulate(program, u, fault_plan=plan,
                                       device=dev), plan

    faulty, plan = run()
    replay, _ = run()
    diverged = not torch.equal(clean.y_codes, faulty.y_codes)
    passed = (diverged and len(faulty.seu_flips) == 1
              and faulty.seu_flips == replay.seu_flips
              and torch.equal(faulty.y_codes, replay.y_codes))
    return _scenario("rtlsim_seu", plan, passed,
                     {"diverged": diverged, "flips": faulty.seu_flips})


# ---------------------------------------------------------------------------
# Suite runner + report
# ---------------------------------------------------------------------------

def run_suite(seed: int = 0, arch: str = "smollm-135m", *, device=None,
              cfg=None, params=None) -> dict:
    """All nine scenarios on ``arch`` on ``device`` (default: the card).
    ``cfg`` defaults to the arch's smoke config and ``params`` to weights
    drawn from ``torch.Generator(device).manual_seed(0)``."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm

    dev = resolve_device(device)
    cfg = cfg if cfg is not None else get_smoke_config(arch)
    if params is None:
        params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                                device=dev)
    scenarios = [
        scenario_quarantine(cfg, params, seed, persistent=False),
        scenario_quarantine(cfg, params, seed, persistent=True),
        scenario_dispatch_retry(cfg, params, seed),
        scenario_stall_watchdog(cfg, params, seed),
        scenario_splice_corruption(cfg, params, seed),
        scenario_slow_tick(cfg, params, seed),
        scenario_deadlines(cfg, params, seed),
        scenario_synth_fallback(seed, dev),
        scenario_rtlsim_seu(seed, dev),
    ]
    classes = {p: 0 for p in fl.FAULT_POINTS}
    for sc in scenarios:
        for point, fires in sc["faults"].items():
            classes[point] += fires
    return {
        "schema": SCHEMA,
        "suite": "chaos",
        "seed": seed,
        "arch": arch,
        "scenarios": scenarios,
        "fault_classes": classes,
        "all_classes_hit": all(v >= 1 for v in classes.values()),
        "passed": (all(sc["passed"] for sc in scenarios)
                   and all(v >= 1 for v in classes.values())),
    }


def main(argv: list[str] | None = None) -> int:
    from repro_torch.obs import log

    ap = argparse.ArgumentParser(prog="python -m repro_torch.verify.chaos")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--device", default=None,
                    help="where the model and the scenarios run (default: "
                    "the card; 'cpu' on a machine without one)")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="write the repro.chaos/v1 JSON report")
    args = ap.parse_args(argv)

    doc = run_suite(seed=args.seed, arch=args.arch, device=args.device)
    for sc in doc["scenarios"]:
        tag = "ok" if sc["passed"] else "FAIL"
        log.info(f"[{tag}] {sc['name']}: faults={sc['faults']} "
                 f"{sc['detail']}")
    log.info(f"fault classes hit: {doc['fault_classes']}")
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(doc, fh, indent=2, default=str)
        log.info(f"wrote chaos report -> {args.out}")
    if not doc["passed"]:
        log.warning("chaos suite FAILED")
        return 1
    log.info("chaos suite passed: every fault class injected and contained")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
