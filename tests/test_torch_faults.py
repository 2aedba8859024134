"""The port's fault layer against the JAX reference: ``runtime/faults.py``,
the server's fault points, quarantine, retries and stall watchdog, and
``synthesize``'s retries and kernel → eager → ref fallback chain.

Same ``FaultPlan`` specs and seed → the same firing sequence and
``report()``.  Same plan and bridged smoke weights → the same quarantined
request, the same ``finish_reason`` for every request, bit-identical
survivor tokens and the same ``dispatch_retries``, under ``step()`` and
``step_block()``.  Only an injected fault may degrade ``synthesize``: any
other exception raises whatever ``fallback`` says.
"""

import dataclasses
import time

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jax_configs  # noqa: E402
from repro import obs as jax_obs  # noqa: E402
from repro.core import synthesis as jax_synth  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.runtime import faults as jax_faults  # noqa: E402
from repro.runtime import server as jax_server  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import obs as pt_obs  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import synthesis  # noqa: E402
from repro_torch.runtime import faults as fl  # noqa: E402
from repro_torch.runtime.server import DecodeServer, Request  # noqa: E402


# ---------------------------------------------------------------------------
# FaultPlan semantics against the reference's
# ---------------------------------------------------------------------------

PLANS = {
    "after_times": ([("tick.slow", dict(after=2, times=2))], ["tick.slow"] * 6),
    "prob_seeded": ([("tick.slow", dict(prob=0.5, times=None))], ["tick.slow"] * 32),
    "two_rules_one_point": ([("decode.dispatch", dict(times=1)),
                             ("decode.dispatch", dict(after=3, prob=0.7, times=3))],
                            ["decode.dispatch"] * 12),
    "interleaved_points": ([("decode.nan_logits", dict(after=1, prob=0.6, times=None)),
                            ("prefix.splice", dict(prob=0.3, times=None)),
                            ("synth.compile", dict(times=2))],
                           ["decode.nan_logits", "prefix.splice", "synth.compile",
                            "decode.dispatch"] * 10),
}


@pytest.mark.parametrize("name", list(PLANS))
@pytest.mark.parametrize("seed", [0, 7])
def test_fault_plan_fires_as_the_reference(name, seed):
    rules, points = PLANS[name]
    seqs = []
    for mod in (fl, jax_faults):
        plan = mod.FaultPlan([mod.FaultSpec(p, **kw) for p, kw in rules], seed=seed)
        fired = [plan.fire(p) is not None for p in points]
        # payload choices draw from the same per-point streams
        picks = [plan.rng(p).choice(range(8)) for p in sorted(set(points))]
        seqs.append((fired, picks, plan.report(), plan.hits))
    assert seqs[0] == seqs[1]
    assert any(seqs[0][0])


def test_fault_points_are_the_reference_table():
    assert set(fl.FAULT_POINTS) == set(jax_faults.FAULT_POINTS)
    assert {k: v[0] for k, v in fl.FAULT_POINTS.items()} == \
        {k: v[0] for k, v in jax_faults.FAULT_POINTS.items()}
    with pytest.raises(ValueError, match="unknown fault point"):
        fl.FaultSpec("decode.never_heard_of_it")


def test_maybe_raise_and_the_ambient_scope():
    plan = fl.FaultPlan([fl.FaultSpec("decode.dispatch")], seed=0)
    assert fl.get_plan() is None
    with fl.active(plan):
        assert fl.get_plan() is plan
        with pytest.raises(fl.TransientFault):
            fl.maybe_raise("decode.dispatch")
        assert fl.fire("decode.dispatch") is None       # times=1 exhausted
    assert fl.get_plan() is None
    assert fl.fire("decode.dispatch") is None
    fl.maybe_raise("decode.dispatch")


def test_watchdog_bounds():
    with pytest.raises(ValueError):
        fl.Watchdog(0.0)
    w = fl.Watchdog(0.5, now=0.0)
    assert not w.stalled(0.4)
    assert w.stalled(0.6)
    w.progress(1.0)
    assert not w.stalled(1.4)
    assert w.idle_s(1.25) == pytest.approx(0.25)


# ---------------------------------------------------------------------------
# the server under injected faults, against the reference server
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    """Bridged smoke weights of paper-lstm and smollm-135m."""
    out = {}
    for arch in ("paper-lstm", "smollm-135m"):
        jcfg = jax_configs.get_smoke_config(arch)
        p_j = jax_lm.init_params(jcfg, jax.random.PRNGKey(0))
        cfg = get_smoke_config(arch)
        out[arch] = (jcfg, p_j, cfg,
                     bridge.params_from_jax(jax.tree.map(np.asarray, p_j), cfg, "cpu"))
    return out


def _prompts(vocab, n=4, seed=0):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, vocab, 5)] for _ in range(n)]


def _drain(srv, request_cls, prompts, max_new=6):
    for i, p in enumerate(prompts):
        srv.submit(request_cls(uid=i, prompt=list(p), max_new_tokens=max_new))
    done = srv.run_until_drained()
    return {r.uid: (list(r.out_tokens), r.finish_reason) for r in done}


CHAOS = [(False, "decode.nan_logits"), (False, "decode.nan_carry"), (True, "decode.nan_carry")]


@pytest.mark.parametrize("persistent,point", CHAOS)
@pytest.mark.parametrize("arch", ["paper-lstm", "smollm-135m"])
def test_quarantine_and_retries_match_the_reference(models, arch, persistent, point):
    jcfg, p_j, cfg, p_pt = models[arch]
    prompts = _prompts(cfg.vocab)

    def specs(mod):
        return [mod.FaultSpec(point, after=1), mod.FaultSpec("decode.dispatch", after=1, times=2)]

    kw = dict(num_slots=4, max_seq=64, persistent=persistent, block_k=4)
    ref_plan = jax_faults.FaultPlan(specs(jax_faults), seed=0)
    ref_srv = jax_server.DecodeServer(jcfg, p_j, faults=ref_plan, **kw)
    ref = _drain(ref_srv, jax_server.Request, prompts)
    plan = fl.FaultPlan(specs(fl), seed=0)
    srv = DecodeServer(cfg, p_pt, faults=plan, device="cpu", **kw)
    got = _drain(srv, Request, prompts)

    assert got == ref                 # tokens of every request, every finish_reason
    bad = [u for u, (_, reason) in got.items() if reason == "error:nonfinite"]
    assert len(bad) == 1
    clean = _drain(DecodeServer(cfg, p_pt, device="cpu", **kw), Request, prompts)
    assert all(got[u] == clean[u] for u in got if u not in bad)   # survivors bit-identical
    h, ref_h = srv.health(), ref_srv.health()
    assert set(h) == set(ref_h)
    for key in ("status", "dispatch_retries", "slots_quarantined_total", "faults"):
        assert h[key] == ref_h[key], key
    assert h["status"] == "degraded" and h["dispatch_retries"] == 2
    m = srv.obs.metrics
    assert int(m.value("faults_injected", point=point)) == 1
    assert int(m.value("decode_dispatch_retries")) == 2


def _port_server(models, arch="paper-lstm", **kw):
    _, _, cfg, p_pt = models[arch]
    return DecodeServer(cfg, p_pt, num_slots=kw.pop("slots", 4), max_seq=kw.pop("max_seq", 64),
                        device="cpu", **kw), cfg


def test_quarantined_slot_is_scrubbed_and_reused(models):
    plan = fl.FaultPlan([fl.FaultSpec("decode.nan_logits", after=1, payload={"slot": 0})])
    srv, cfg = _port_server(models, slots=1, faults=plan)
    poisoned = Request(uid=0, prompt=_prompts(cfg.vocab, 1)[0], max_new_tokens=6)
    srv.submit(poisoned)
    srv.run_until_drained()
    assert poisoned.finish_reason == "error:nonfinite"
    fresh = Request(uid=1, prompt=_prompts(cfg.vocab, 1, seed=9)[0], max_new_tokens=4)
    srv.submit(fresh)
    srv.run_until_drained()
    assert fresh.finish_reason == "max_tokens" and len(fresh.out_tokens) == 4
    assert not srv.quarantined.any()
    assert all(bool(torch.isfinite(t).all()) for t in srv._slot_leaves(floating=True))


@pytest.mark.parametrize("arch", ["paper-lstm", "smollm-135m"])
def test_prefix_splice_corruption_is_quarantined(models, arch):
    plan = fl.FaultPlan([fl.FaultSpec("prefix.splice")], seed=0)
    srv, cfg = _port_server(models, arch, faults=plan, prefix_cache_bytes=64 << 20)
    prompt = _prompts(cfg.vocab, 1)[0]
    first = Request(uid=0, prompt=list(prompt), max_new_tokens=4)
    srv.submit(first)
    srv.run_until_drained()
    again = Request(uid=1, prompt=list(prompt), max_new_tokens=4)   # a full hit
    srv.submit(again)
    srv.run_until_drained()
    assert first.finish_reason == "max_tokens"
    assert again.prefix_hit_tokens == len(prompt)
    assert again.finish_reason == "error:nonfinite"
    assert plan.hits["prefix.splice"] == 1
    # the stored checkpoint was not poisoned: a third admission is healthy
    third = Request(uid=2, prompt=list(prompt), max_new_tokens=4)
    srv.submit(third)
    srv.run_until_drained()
    assert third.finish_reason == "max_tokens" and third.out_tokens == first.out_tokens


@pytest.mark.parametrize("persistent", [False, True])
def test_permanent_dispatch_fault_trips_the_watchdog(models, persistent):
    plan = fl.FaultPlan([fl.FaultSpec("decode.dispatch", times=None)], seed=0)
    srv, cfg = _port_server(models, faults=plan, watchdog_s=0.2, persistent=persistent)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=50)
            for i, p in enumerate(_prompts(cfg.vocab, 3))]
    for r in reqs:
        srv.submit(r)
    t0 = time.perf_counter()
    srv.run_until_drained()
    assert time.perf_counter() - t0 < 30.0
    assert all(r.finish_reason == "error:stalled" for r in reqs)
    h = srv.health()
    assert h["status"] == "stalled" and h["stalled_events"] >= 1
    assert int(srv.obs.metrics.value("server_stalled")) >= 1


def test_slow_tick_beyond_the_bound_trips_the_watchdog(models):
    """A tick slower than ``watchdog_s`` that makes no progress (its decode
    dispatch fails once, transiently) aborts the in-flight work."""
    plan = fl.FaultPlan([fl.FaultSpec("tick.slow", after=2, delay_s=0.3),
                         fl.FaultSpec("decode.dispatch", after=2)], seed=0)
    srv, cfg = _port_server(models, faults=plan, watchdog_s=0.1)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=20)
            for i, p in enumerate(_prompts(cfg.vocab, 3))]
    for r in reqs:
        srv.submit(r)
    srv.run_until_drained()
    assert plan.hits == {"tick.slow": 1, "decode.dispatch": 1}
    assert all(r.finish_reason == "error:stalled" for r in reqs)
    assert all(len(r.out_tokens) == 3 for r in reqs)   # prefill + 2 decode ticks
    assert srv.health()["status"] == "stalled"


def test_slow_tick_within_the_bound_is_latency_only(models):
    plan = fl.FaultPlan([fl.FaultSpec("tick.slow", times=2, delay_s=0.02)], seed=0)
    srv, cfg = _port_server(models, faults=plan, watchdog_s=60.0)
    got = _drain(srv, Request, _prompts(cfg.vocab, 2), max_new=3)
    assert plan.hits["tick.slow"] == 2
    assert all(reason == "max_tokens" for _, reason in got.values())
    h = srv.stats()["health"]
    assert h["status"] == "ok" and h["stalled_events"] == 0
    assert h["watchdog_s"] == 60.0 and h["last_progress_idle_s"] >= 0
    assert h["faults"] == plan.report()


def test_ambient_plan_reaches_the_server(models):
    srv, cfg = _port_server(models)
    plan = fl.FaultPlan([fl.FaultSpec("decode.nan_logits", after=1)], seed=0)
    with fl.active(plan):
        got = _drain(srv, Request, _prompts(cfg.vocab, 2))
        assert srv.health()["faults"] == plan.report()
    assert sorted(reason for _, reason in got.values()) == ["error:nonfinite", "max_tokens"]
    assert "faults" not in srv.health()


def test_health_keys_match_the_reference(models):
    jcfg, p_j, cfg, p_pt = models["paper-lstm"]
    for kw in (dict(), dict(watchdog_s=5.0)):
        ref = jax_server.DecodeServer(jcfg, p_j, num_slots=2, max_seq=16,
                                      faults=jax_faults.FaultPlan([], seed=3), **kw)
        got = DecodeServer(cfg, p_pt, num_slots=2, max_seq=16, device="cpu",
                           faults=fl.FaultPlan([], seed=3), **kw)
        assert set(got.health()) == set(ref.health())
        assert set(got.stats()) == set(ref.stats())
        assert got.health()["faults"] == ref.health()["faults"]


# ---------------------------------------------------------------------------
# synthesize(): retries and the fallback chain
# ---------------------------------------------------------------------------

# the port's backend for each of the reference's
PORT_BACKEND = {"pallas": "kernel", "xla": "eager", "ref": "ref"}


def _counts(metrics):
    return (int(metrics.value("synth_retries")),
            {(c.labels["from_backend"], c.labels["to"]): int(c.value)
             for c in metrics.children("synth_fallback") if c.value})


@pytest.mark.parametrize("backend,times", [("xla", 2), ("xla", 3), ("pallas", 3),
                                           ("pallas", 5), ("ref", 2)])
def test_synthesize_retries_and_fallback_match_the_reference(backend, times):
    outs = []
    for mod, faults, O, bk, kw in (
            (jax_synth, jax_faults, jax_obs.OBS, backend, {}),
            (synthesis, fl, pt_obs.OBS, PORT_BACKEND[backend], dict(device="cpu"))):
        spec = mod.NetworkSpec(num_inputs=4, num_hidden_layers=2, nodes_per_layer=8,
                               num_outputs=2)
        mod.synthesize_cache_clear()
        before = _counts(O.metrics)
        plan = faults.FaultPlan([faults.FaultSpec("synth.compile", times=times)], seed=0)
        with faults.active(plan):
            rep = mod.synthesize(spec, batch=2, backend=bk, measure=False, backoff_s=0.0, **kw)
        after = _counts(O.metrics)
        hops = {k: v - before[1].get(k, 0) for k, v in after[1].items()
                if v - before[1].get(k, 0)}
        outs.append((rep.backend, rep.fallback_from, after[0] - before[0], hops,
                     plan.report(), rep.output_shape))
        mod.synthesize_cache_clear()
    ref, got = outs
    rename = lambda b: PORT_BACKEND.get(b, b)   # noqa: E731
    assert got[0] == rename(ref[0]) and got[1] == (ref[1] and rename(ref[1]))
    assert got[2] == ref[2]
    assert got[3] == {(rename(a), rename(b)): n for (a, b), n in ref[3].items()}
    assert got[4:] == ref[4:]


def test_synthesize_without_fallback_raises_the_injected_fault():
    synthesis.synthesize_cache_clear()
    plan = fl.FaultPlan([fl.FaultSpec("synth.compile", times=None)], seed=0)
    with fl.active(plan), pytest.raises(fl.TransientFault):
        synthesis.synthesize(synthesis.NetworkSpec(4, 2, 8, 2), batch=2, backend="eager",
                             measure=False, backoff_s=0.0, fallback=False, device="cpu")
    assert synthesis.synthesize_cache_info() == {"entries": 0}


@pytest.mark.parametrize("error", [RuntimeError("nvcc failed to build stage.cu"),
                                   RuntimeError("codegen_stage kernel launch failed: code 1"),
                                   ValueError("bad shape")])
def test_a_real_failure_never_falls_back(monkeypatch, error):
    """With ``fallback=True`` and a plan installed, an exception that the
    plan did not inject (a failed build, a launch error) raises at once: no
    retry, no hop to another backend."""
    from repro_torch.codegen import kernel_backend

    def broken(*a, **kw):
        raise error

    monkeypatch.setattr(kernel_backend, "compile_program", broken)
    synthesis.synthesize_cache_clear()
    before = _counts(pt_obs.OBS.metrics)
    plan = fl.FaultPlan([fl.FaultSpec("tick.slow")], seed=0)
    spec = synthesis.NetworkSpec(3, 1, 4, 2, cell="gru", seq_len=3)
    with fl.active(plan), pytest.raises(type(error), match=str(error)):
        synthesis.synthesize(spec, backend="kernel", fallback=True, backoff_s=0.0,
                             device="cpu")
    assert _counts(pt_obs.OBS.metrics) == before
    assert synthesis.synthesize_cache_info() == {"entries": 0}


@pytest.mark.parametrize("backend", ["kernel", "eager"])
def test_a_fallback_report_is_not_memoized(backend):
    """A build that an injected fault degraded answers only its own call: a
    later call without faults builds on the backend that it asks for."""
    synthesis.synthesize_cache_clear()
    spec = dataclasses.replace(synthesis.NetworkSpec(4, 2, 8, 2), seed=5)
    plan = fl.FaultPlan([fl.FaultSpec("synth.compile", times=3)], seed=0)
    with fl.active(plan):
        rep = synthesis.synthesize(spec, batch=2, backend=backend, measure=False,
                                   backoff_s=0.0, device="cpu")
    assert rep.fallback_from == backend and rep.backend != backend
    assert synthesis.synthesize_cache_info() == {"entries": 0}
    again = synthesis.synthesize(spec, batch=2, backend=backend, measure=False, device="cpu")
    assert (again.backend, again.fallback_from, again.cache_hit) == (backend, None, False)
    third = synthesis.synthesize(spec, batch=2, backend=backend, measure=False, device="cpu")
    assert (third.backend, third.cache_hit) == (backend, True)
    synthesis.synthesize_cache_clear()
