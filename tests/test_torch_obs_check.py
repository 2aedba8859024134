"""The port's ``obs.check`` and ``obs.report`` and its serving launcher,
against the JAX reference.

``repro_torch.obs.check`` gives the reference's list of errors for the same
document, valid or broken, for every document kind (trace, metrics,
loadgen, tune, analyze, chaos; the mutations of the chaos report are the
reference's own in ``tests/test_faults.py``).  The reference's
``check_file`` accepts the port's exported trace, metrics and ledger
unchanged.  ``python -m repro_torch.launch.serve`` and ``python -m
repro_torch.obs.report``, run on the CPU, write documents both checkers
accept.
"""

import copy
import json

import pytest

torch = pytest.importorskip("torch")

from repro.obs import check as jax_check  # noqa: E402
from repro.runtime.faults import FAULT_POINTS  # noqa: E402
from repro_torch.obs import check as pt_check  # noqa: E402


def _trace():
    return {"traceEvents": [
        {"ph": "M", "name": "thread_name", "pid": 1, "tid": 0, "ts": 0, "args": {"name": "s"}},
        {"ph": "X", "name": "decode_step", "pid": 1, "tid": 0, "ts": 5.0, "dur": 3.0},
        {"ph": "X", "name": "request", "pid": 1, "tid": 2, "ts": 1.0, "dur": 9.0,
         "args": {"uid": 1, "shard": 0}},
        {"ph": "C", "name": "live", "pid": 1, "tid": 0, "ts": 2.0, "args": {"live": 1}}]}


def _metrics():
    return {"schema": "repro.metrics/v1",
            "metrics": {"counters": {"decode_syncs": 4, "faults_injected{point=tick.slow}": 1,
                                     "decoded_tokens_shard{shard=1}": 3},
                        "gauges": {"live_slots": 0},
                        "histograms": {"ttft_ms": {"count": 2, "sum": 3.0, "p50": 1.0,
                                                   "p95": 2.0, "p99": None}}},
            "ledger": [{"program": "nn|eager|u1|c1", "fsm_cycles": 44, "flops": 512.0,
                        "measured_wall_us": 99.5, "shard": 0}],
            "stats": {"decode_syncs": 4}}


def _loadgen():
    return {"schema": "repro.loadgen/v1",
            "spec": {"seed": 0, "num_requests": 2, "max_new_tokens": 4},
            "requests": 2, "completed": 2, "by_reason": {"max_tokens": 2}, "ticks": 9,
            "wall_s": 0.5, "decoded_tokens": 6, "throughput_tok_s": 12.0,
            "tokens_digest": "abc", "mesh": None,
            "per_shard": [{"shard": 0, "decoded_tokens": 6, "dispatched": 2, "quarantined": 0}]}


def _tune():
    cand = {"key": "k1", "knobs": {"unroll": 1},
            "predicted": {"fsm_cycles": 10, "scores": {}}, "measured": {"wall_us": 3.0}}
    return {"schema": "repro.tune/v1", "suite": "tune", "spec": {}, "spec_name": "nn",
            "objective": "latency", "candidates": [cand, dict(cand, key="k2", measured=None)],
            "measured": ["k1"], "pareto": ["k1"],
            "best": {"key": "k1", "measured_objective": 3.0,
                     "repro": {"spec": {}, "synthesize_kwargs": {}, "cache_key": "x"}},
            "baseline": None, "speedup": 1.0}


def _analyze():
    finding = {"kind": "overflow", "severity": "warning", "stage": "s0", "node": "z",
               "detail": "d", "id": "overflow:s0.z"}
    return {"schema": "repro.analyze/v1", "suite": "analyze", "spec": {"name": "nn"},
            "width": 16, "converged": True, "iters": 3, "static_snr_db": 40.0,
            "min_safe_width": 12,
            "wires": {"s0.z": {"lo": -3, "hi": 5, "amp_real": 1.0, "eps_real": 0.1,
                               "snr_db": 30.0, "min_word_bits": 8}},
            "findings": [finding],
            "summary": {"errors": 0, "warnings": 1, "waived": 0, "clean": False}}


def _chaos():
    return {"schema": "repro.chaos/v1", "suite": "chaos", "seed": 0,
            "scenarios": [{"name": "s", "passed": True, "faults": {"tick.slow": 1},
                           "detail": {}}],
            "fault_classes": {p: 1 for p in FAULT_POINTS},
            "all_classes_hit": True, "passed": True}


def _set(path, value):
    def mutate(d):
        for k in path[:-1]:
            d = d[k]
        if value is _DEL:
            del d[path[-1]]
        else:
            d[path[-1]] = value
    return mutate


_DEL = object()

CASES = {
    "trace": (_trace, "check_trace_doc", [
        _set(("traceEvents",), {}), _set(("traceEvents", 1, "ph"), "Q"),
        _set(("traceEvents", 1, "dur"), -1), _set(("traceEvents", 1, "ts"), _DEL),
        _set(("traceEvents", 0, "args"), _DEL), _set(("traceEvents", 2, "args", "shard"), -2),
        _set(("traceEvents", 2, "tid"), "2"), _set(("traceEvents", 3), 7)]),
    "metrics": (_metrics, "check_metrics_doc", [
        _set(("metrics",), _DEL), _set(("metrics", "counters", "decode_syncs"), "4"),
        _set(("metrics", "counters", "x{shard=a}"), 1),
        _set(("metrics", "histograms", "ttft_ms", "p95"), _DEL),
        _set(("metrics", "histograms", "ttft_ms", "p50"), "1"), _set(("ledger",), {}),
        _set(("ledger", 0, "fsm_cycles"), _DEL), _set(("ledger", 0, "program"), 3),
        _set(("ledger", 0, "shard"), True), _set(("stats",), [])]),
    "loadgen": (_loadgen, "check_loadgen_doc", [
        _set(("schema",), "repro.loadgen/v0"), _set(("spec", "seed"), "0"),
        _set(("completed",), 3), _set(("wall_s",), -1.0), _set(("by_reason", "eos"), 1),
        _set(("tokens_digest",), ""), _set(("mesh",), {"dp": 0, "tp": 1, "layout": "x"}),
        _set(("per_shard",), []), _set(("per_shard", 0, "decoded_tokens"), 5),
        _set(("per_shard", 0, "shard"), -1), _set(("decoded_tokens",), 7)]),
    "tune": (_tune, "check_tune_doc", [
        _set(("schema",), "repro.tune/v0"), _set(("objective",), "power"),
        _set(("candidates",), []), _set(("pareto",), ["nope"]),
        _set(("best", "key"), "k9"), _set(("best", "repro"), _DEL),
        _set(("candidates", 0, "predicted"), {}), _set(("speedup",), "2x")]),
    "analyze": (_analyze, "check_analyze_doc", [
        _set(("schema",), "repro.analyze/v0"), _set(("width",), 0),
        _set(("wires", "s0.z", "lo"), 9), _set(("findings", 0, "severity"), "fatal"),
        _set(("summary", "warnings"), 0), _set(("findings", 0, "waived"), True),
        _set(("findings", 0, "id"), "bad"), _set(("converged",), "yes")]),
    # tests/test_faults.py::test_check_chaos_doc_rejects_broken's mutations
    "chaos": (_chaos, "check_chaos_doc", [
        _set(("schema",), "repro.chaos/v0"), _set(("scenarios",), []),
        lambda d: d["fault_classes"].pop("rtlsim.seu"),
        lambda d: d["fault_classes"].update({"rtlsim.seu": 0}),
        lambda d: d["scenarios"][0].update(passed=False),
        lambda d: d.update(all_classes_hit=False),
        lambda d: d["fault_classes"].update({"decode.unknown": 1}),
        _set(("seed",), None)]),
}


@pytest.mark.parametrize("kind", list(CASES))
def test_valid_documents_pass_both_checkers(kind):
    make, fn, _ = CASES[kind]
    doc = make()
    assert getattr(pt_check, fn)(doc) == getattr(jax_check, fn)(doc) == []


@pytest.mark.parametrize("kind,i", [(k, i) for k, (_, _, m) in CASES.items()
                                    for i in range(len(m))])
def test_broken_documents_give_the_reference_errors(kind, i, tmp_path):
    make, fn, mutations = CASES[kind]
    doc = make()
    mutations[i](doc)
    got = getattr(pt_check, fn)(copy.deepcopy(doc))
    assert got and got == getattr(jax_check, fn)(doc)
    path = tmp_path / f"{kind}.json"
    path.write_text(json.dumps(doc))
    assert pt_check.check_file(str(path)) == jax_check.check_file(str(path))


def test_check_file_dispatch_and_main_match_reference(tmp_path):
    paths = []
    for kind, (make, _, _) in CASES.items():
        paths.append(tmp_path / f"{kind}.json")
        paths[-1].write_text(json.dumps(make()))
    (tmp_path / "bad.json").write_text("{not json")
    (tmp_path / "list.json").write_text("[1, 2]")
    for p in list(paths) + [tmp_path / "bad.json", tmp_path / "list.json",
                            tmp_path / "missing.json"]:
        got, ref = pt_check.check_file(str(p)), jax_check.check_file(str(p))
        assert [e.split(": ", 1)[1] for e in got] == [e.split(": ", 1)[1] for e in ref]
    assert pt_check.main([str(p) for p in paths]) == 0
    assert pt_check.main([str(tmp_path / "bad.json")]) == 1
    assert pt_check.main([]) == 2


# ---------------------------------------------------------------------------
# the port's own documents, through both checkers
# ---------------------------------------------------------------------------

def test_launcher_writes_documents_both_checkers_accept(tmp_path):
    from repro_torch.launch import serve

    out = {k: str(tmp_path / f"{k}.json") for k in ("loadgen", "trace", "metrics")}
    serve.main(["--arch", "paper-lstm", "--loadgen", "--requests", "10", "--max-new", "4",
                "--prefill-chunk", "4", "--prefix-cache", "64", "--device", "cpu",
                "--loadgen-out", out["loadgen"], "--trace-out", out["trace"],
                "--metrics-out", out["metrics"]])
    for path in out.values():
        assert pt_check.check_file(path) == []
        assert jax_check.check_file(path) == []
    rep = json.load(open(out["loadgen"]))
    assert rep["completed"] == 10 and rep["by_reason"] == {"max_tokens": 10}
    metrics = json.load(open(out["metrics"]))
    assert metrics["stats"]["prefix_cache"]["insertions"] > 0
    names = {ev["name"] for ev in json.load(open(out["trace"]))["traceEvents"]}
    assert {"prefill_chunk", "decode_step", "request"} <= names


def test_launcher_synthetic_stream_and_unported_mesh(tmp_path, capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", "smollm-135m", "--requests", "3", "--max-new", "3",
                "--persistent", "--watchdog-s", "30", "--device", "cpu"])
    err = capsys.readouterr()
    assert "served 3 requests" in err.out + err.err
    for flag in (["--mesh", "2x1"], ["--mesh-layout", "folded"]):
        with pytest.raises(NotImplementedError, match="Multi-device and launchers"):
            serve.main(["--arch", "paper-lstm", "--device", "cpu"] + flag)


def test_report_writes_a_ledger_both_checkers_accept(tmp_path):
    from repro_torch.obs import report

    path = str(tmp_path / "ledger.json")
    assert report.main(["--backends", "eager", "kernel", "--cells", "mlp", "gru",
                        "--device", "cpu", "--out", path]) == 0
    doc = json.load(open(path))
    programs = {row["program"] for row in doc["ledger"]}
    assert {"nn_4i_2x8_2o|eager|u1|c1|b2", "nn_4i_2x8_2o|kernel|u1|c1|b2",
            "gru_4i_2x8_2o|eager|u1|c1|b2", "gru_4i_2x8_2o|kernel|u1|c1|b2"} <= programs
    assert all(row["measured_wall_us"] > 0 for row in doc["ledger"])
    assert pt_check.check_file(path) == [] and jax_check.check_file(path) == []
    # the json format prints the rows
    assert report.main(["--backends", "eager", "--cells", "mlp", "--device", "cpu",
                        "--format", "json", "--program", "|eager|"]) == 0


def test_exported_server_documents_pass_the_reference_checker(tmp_path):
    from repro_torch import obs as pt_obs
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm
    from repro_torch.runtime import DecodeServer, Request

    cfg = get_smoke_config("falcon-mamba-7b")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    obs = pt_obs.Observability(trace=True)
    srv = DecodeServer(cfg, params, num_slots=2, max_seq=32, prefill_chunk=3,
                       prefix_cache_bytes=8 << 20, obs=obs, device="cpu")
    for uid in range(3):
        srv.submit(Request(uid=uid, prompt=[5, 6, 7, 8, 9][: 3 + uid], max_new_tokens=3))
    srv.run_until_drained()
    trace, metrics = str(tmp_path / "t.json"), str(tmp_path / "m.json")
    obs.export_trace(trace)
    obs.export_metrics(metrics, stats=srv.stats(), ledger=pt_obs.OBS.ledger)
    assert jax_check.check_file(trace) == [] and jax_check.check_file(metrics) == []
    args = [ev["args"] for ev in json.load(open(trace))["traceEvents"]
            if ev["name"] == "request"]
    assert sorted(a["prefix_hit_tokens"] for a in args) == [0, 0, 3]   # uid 2 waits for a slot


def test_launcher_and_report_default_to_the_card():
    """Without ``--device``, the launcher and the report ask for CUDA and
    raise on a machine without it; they never run on the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is usable")
    from repro_torch.launch import serve
    from repro_torch.obs import report

    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "paper-lstm", "--requests", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        report.main(["--backends", "kernel", "--cells", "mlp"])
