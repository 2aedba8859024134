"""The port's DecodeServer on the CPU against the JAX reference server.

Both servers get the same bridged ``paper-lstm`` (and ``falcon-mamba-7b``
and ``smollm-135m``) smoke weights and the same greedy requests; they must return identical
``out_tokens`` and ``finish_reason`` under ``step()``, ``step_block()`` and
chunked prefill, and count the same ``decode_syncs`` and
``decoded_tokens``.  (Sampled decoding
cannot match across frameworks — the random streams differ — so it is only
checked for well-formed output.)
"""

import dataclasses
import math

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jax_configs  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.runtime import scheduler as jax_sched  # noqa: E402
from repro.runtime import server as jax_server  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.runtime import scheduler as pt_sched  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.runtime.server import DecodeServer, Request, splice_cache  # noqa: E402

PROMPTS = [[5, 17, 3], [9, 9, 200, 41], [7, 1, 2, 3, 4], [250, 6, 6], [11, 12, 13, 14]]
MAX_NEW = [6, 3, 5, 7, 4]
DRIVERS = {"step": (False, 0), "step_block": (True, 0), "chunked": (False, 2)}


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_configs.get_smoke_config("paper-lstm")
    p_j = jax_lm.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_smoke_config("paper-lstm")
    return jcfg, cfg, p_j, bridge.params_from_jax(jax.tree.map(np.asarray, p_j), cfg, "cpu")


def _run(server, request_cls, persistent):
    for i, (p, n) in enumerate(zip(PROMPTS, MAX_NEW)):
        server.submit(request_cls(uid=i, prompt=list(p), max_new_tokens=n))
    done = server.run_until_drained(persistent=persistent)
    st = server.stats()
    return ({r.uid: (r.out_tokens, r.finish_reason) for r in done},
            st["decode_syncs"], st["decoded_tokens"])


@pytest.fixture(scope="module")
def reference_runs(weights):
    """The JAX server's results per (driver, eos_id, max_seq), computed once."""
    jcfg, _, p_j, _ = weights
    memo = {}

    def get(driver, eos_id=None, max_seq=32):
        key = (driver, eos_id, max_seq)
        if key not in memo:
            persistent, chunk = DRIVERS[driver]
            srv = jax_server.DecodeServer(jcfg, p_j, num_slots=2, max_seq=max_seq,
                                          eos_id=eos_id, block_k=4, prefill_chunk=chunk)
            memo[key] = _run(srv, jax_server.Request, persistent)
        return memo[key]

    return get


def _port(weights, driver, use_pallas=False, **kw):
    _, cfg, _, p_pt = weights
    persistent, chunk = DRIVERS[driver]
    srv = DecodeServer(dataclasses.replace(cfg, use_pallas=use_pallas), p_pt, num_slots=2,
                       max_seq=kw.pop("max_seq", 32), block_k=4, prefill_chunk=chunk,
                       device="cpu", **kw)
    return _run(srv, Request, persistent)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("driver", list(DRIVERS))
def test_greedy_tokens_and_syncs_match_reference(weights, reference_runs, driver, use_pallas):
    tokens, syncs, decoded = _port(weights, driver, use_pallas)
    ref_tokens, ref_syncs, ref_decoded = reference_runs(driver)
    assert tokens == ref_tokens
    assert (syncs, decoded) == (ref_syncs, ref_decoded)
    assert all(len(tokens[i][0]) == MAX_NEW[i] for i in tokens)


@pytest.fixture(scope="module")
def falcon_runs():
    """falcon-mamba-7b smoke weights, bridged, and the JAX server's results
    per driver (computed once)."""
    jcfg = jax_configs.get_smoke_config("falcon-mamba-7b")
    p_j = jax_lm.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_smoke_config("falcon-mamba-7b")
    p_pt = bridge.params_from_jax(jax.tree.map(np.asarray, p_j), cfg, "cpu")
    memo = {}

    def reference(driver):
        if driver not in memo:
            persistent, chunk = DRIVERS[driver]
            srv = jax_server.DecodeServer(jcfg, p_j, num_slots=2, max_seq=32,
                                          block_k=4, prefill_chunk=chunk)
            memo[driver] = _run(srv, jax_server.Request, persistent)
        return memo[driver]

    return cfg, p_pt, reference


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("driver", list(DRIVERS))
def test_falcon_mamba_greedy_tokens_and_syncs_match_reference(falcon_runs, driver, use_pallas):
    """The Mamba-1 decode state ({"h", "conv"} per slot) splices and serves
    like the recurrent carry: same tokens, reasons and sync counts as the
    JAX server under every driver."""
    cfg, p_pt, reference = falcon_runs
    persistent, chunk = DRIVERS[driver]
    srv = DecodeServer(dataclasses.replace(cfg, use_pallas=use_pallas), p_pt, num_slots=2,
                       max_seq=32, block_k=4, prefill_chunk=chunk, device="cpu")
    tokens, syncs, decoded = _run(srv, Request, persistent)
    ref_tokens, ref_syncs, ref_decoded = reference(driver)
    assert tokens == ref_tokens
    assert (syncs, decoded) == (ref_syncs, ref_decoded)
    assert all(len(tokens[i][0]) == MAX_NEW[i] for i in tokens)


@pytest.fixture(scope="module")
def smollm_runs():
    """smollm-135m smoke weights, bridged, and the JAX server's results per
    driver (computed once)."""
    jcfg = jax_configs.get_smoke_config("smollm-135m")
    p_j = jax_lm.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_smoke_config("smollm-135m")
    p_pt = bridge.params_from_jax(jax.tree.map(np.asarray, p_j), cfg, "cpu")
    memo = {}

    def reference(driver):
        if driver not in memo:
            persistent, chunk = DRIVERS[driver]
            srv = jax_server.DecodeServer(jcfg, p_j, num_slots=2, max_seq=32,
                                          block_k=4, prefill_chunk=chunk)
            memo[driver] = _run(srv, jax_server.Request, persistent)
        return memo[driver]

    return cfg, p_pt, reference


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("driver", list(DRIVERS))
def test_smollm_greedy_tokens_and_syncs_match_reference(smollm_runs, driver, use_pallas):
    """The KV cache splices left-aligned into a slot (one-shot prefill) or
    as a batch row (chunked prefill) and serves like the recurrent and SSM
    states: same tokens, reasons and sync counts as the JAX server under
    every driver."""
    cfg, p_pt, reference = smollm_runs
    persistent, chunk = DRIVERS[driver]
    srv = DecodeServer(dataclasses.replace(cfg, use_pallas=use_pallas), p_pt, num_slots=2,
                       max_seq=32, block_k=4, prefill_chunk=chunk, device="cpu")
    tokens, syncs, decoded = _run(srv, Request, persistent)
    ref_tokens, ref_syncs, ref_decoded = reference(driver)
    assert tokens == ref_tokens
    assert (syncs, decoded) == (ref_syncs, ref_decoded)
    assert all(len(tokens[i][0]) == MAX_NEW[i] for i in tokens)


def test_splice_cache_kv_left_aligned_and_overflow_raises():
    """A one-shot prefill's [G, 1, L, KV, hd] KV lands in positions 0..L-1
    of its slot and nowhere else; a source longer than the cache raises (the
    reference's full-attention rule); a chunked prefill's max_seq-long B=1
    cache is a plain batch row."""
    cfg = get_smoke_config("smollm-135m")
    caches = lm.init_cache(cfg, 3, 8, "cpu")
    for leaf in ("k", "v"):
        caches["groups"]["b0_attn"][leaf].normal_(generator=torch.Generator().manual_seed(1))
    before = {k: t.clone() for k, t in caches["groups"]["b0_attn"].items()}
    src = {"groups": {"b0_attn": {k: torch.full((2, 1, 5, 1, 16), 7.0) for k in ("k", "v")}}}
    out = splice_cache(caches, src, 1)
    for leaf in ("k", "v"):
        got = out["groups"]["b0_attn"][leaf]
        assert got is caches["groups"]["b0_attn"][leaf]          # updated in place
        assert bool((got[:, 1, :5] == 7.0).all())
        assert torch.equal(got[:, 1, 5:], before[leaf][:, 1, 5:])
        assert torch.equal(got[:, 0], before[leaf][:, 0]) and torch.equal(got[:, 2], before[leaf][:, 2])
    long = {"groups": {"b0_attn": {k: torch.zeros((2, 1, 9, 1, 16)) for k in ("k", "v")}}}
    with pytest.raises(ValueError, match="overflows the full-attention cache"):
        splice_cache(caches, long, 0)
    row = lm.init_cache(cfg, 1, 8, "cpu")
    row["groups"]["b0_attn"]["k"].fill_(3.0)
    splice_cache(caches, row, 2)
    assert bool((caches["groups"]["b0_attn"]["k"][:, 2] == 3.0).all())


@pytest.mark.parametrize("driver", ["step", "step_block"])
def test_eos_and_out_of_cache_stops_match_reference(weights, reference_runs, driver):
    """EOS picked from the reference's own stream, and a cache so short that
    requests retire as out_of_cache: same tokens and reasons."""
    eos = reference_runs(driver)[0][0][0][2]
    tokens, syncs, _ = _port(weights, driver, eos_id=eos)
    assert tokens == reference_runs(driver, eos_id=eos)[0]
    assert any(reason == "eos" for _, reason in tokens.values())
    tokens, _, _ = _port(weights, driver, max_seq=8)
    assert tokens == reference_runs(driver, max_seq=8)[0]
    assert any(reason == "out_of_cache" for _, reason in tokens.values())


def _server(weights, **kw):
    _, cfg, _, p_pt = weights
    return DecodeServer(cfg, p_pt, num_slots=2, max_seq=16, device="cpu", **kw)


def test_budget_edges_and_rejections(weights):
    srv = _server(weights)
    reqs = [Request(uid=0, prompt=[1, 2], max_new_tokens=0),
            Request(uid=1, prompt=[1, 2], max_new_tokens=1),
            Request(uid=2, prompt=[], max_new_tokens=3),
            Request(uid=3, prompt=list(range(40)), max_new_tokens=3),
            Request(uid=4, prompt=[3], max_new_tokens=2, deadline_s=0.0),
            Request(uid=5, prompt=[4, 5], max_new_tokens=2)]
    for r in reqs:
        srv.submit(r)
    dup = Request(uid=5, prompt=[4], max_new_tokens=2)
    assert not srv.submit(dup)
    srv.run_until_drained()
    got = {r.uid: (len(r.out_tokens), r.finish_reason) for r in reqs}
    assert got == {0: (0, "max_tokens"), 1: (1, "max_tokens"),
                   2: (0, "rejected:empty_prompt"), 3: (0, "rejected:prompt_too_long"),
                   4: (0, "expired:queue"), 5: (2, "max_tokens")}
    assert dup.finish_reason == "rejected:duplicate_uid"


def test_stats_keys_match_reference(weights):
    jcfg, _, p_j, _ = weights
    st = _server(weights).stats()
    ref = jax_server.DecodeServer(jcfg, p_j, num_slots=2, max_seq=16).stats()
    assert set(st) <= set(ref)
    assert set(st["prefill"]) <= set(ref["prefill"])
    assert set(st["latency"]) == set(ref["latency"])
    assert set(st["scheduler"]) == set(ref["scheduler"])


@pytest.mark.parametrize("kw", [dict(plan=object())])
def test_unported_server_features_raise(weights, kw):
    with pytest.raises(NotImplementedError, match="not ported"):
        _server(weights, **kw)


@pytest.mark.parametrize("persistent", [False, True])
def test_sampled_decoding_is_well_formed(weights, persistent):
    _, cfg, _, _ = weights
    srv = _server(weights, seed=3)
    for i in range(3):
        srv.submit(Request(uid=i, prompt=[i + 1, 7], max_new_tokens=5, temperature=0.8))
    done = srv.run_until_drained(persistent=persistent)
    assert all(len(r.out_tokens) == 5 and all(0 <= t < cfg.vocab for t in r.out_tokens)
               for r in done)
    # step() pays one extra sync per sampled token; step_block() samples on device
    syncs = srv.stats()["decode_syncs"]
    assert (syncs < 12) if persistent else (syncs > 12)


def test_nonfinite_slot_is_quarantined_and_others_continue(weights):
    ref = _server(weights)
    for i in range(2):
        ref.submit(Request(uid=i, prompt=[i + 3, 4], max_new_tokens=4))
    ref.run_until_drained()
    want = {r.uid: r.out_tokens for r in ref.completed}

    srv = _server(weights)
    for i in range(2):
        srv.submit(Request(uid=i, prompt=[i + 3, 4], max_new_tokens=4))
    srv.step()                                      # both admitted and decoding
    srv.caches["groups"]["b0_recurrent"]["h"][:, 1] = float("nan")
    srv.run_until_drained()
    got = {r.uid: (r.out_tokens, r.finish_reason) for r in srv.completed}
    assert got[0] == (want[0], "max_tokens")
    assert got[1][1] == "error:nonfinite"
    assert srv.stats()["health"]["slots_quarantined_total"] == 1
    assert not srv.quarantined.any()                # scrubbed at the next tick
    assert bool(torch.isfinite(srv.caches["groups"]["b0_recurrent"]["h"]).all())


def test_cancel_queued_and_live_requests(weights):
    srv = _server(weights)
    for i in range(3):
        srv.submit(Request(uid=i, prompt=[i + 1], max_new_tokens=6))
    srv.step()                    # uids 0 and 1 take the two slots; 2 waits
    assert srv.cancel(2) and srv.cancel(0) and not srv.cancel(99)
    srv.run_until_drained()
    reasons = {r.uid: r.finish_reason for r in srv.completed}
    assert reasons == {0: "cancelled", 1: "max_tokens", 2: "cancelled"}


def test_scheduler_order_matches_reference():
    """Priority classes with aging, FIFO policy, queue bound and truncation:
    the port's scheduler pops in the reference's order."""
    for cfg_kw in (dict(), dict(policy="fifo"), dict(max_queue=3),
                   dict(overflow="truncate", max_prompt_tokens=2)):
        orders = []
        for mod, req_cls in ((pt_sched, Request), (jax_sched, jax_server.Request)):
            sched = mod.Scheduler(mod.SchedulerConfig(**cfg_kw), prompt_limit=8)
            for i, prio in enumerate([2, 0, 1, 0, 3]):
                sched.admit(req_cls(uid=i, prompt=[1, 2, 3], priority=prio), now=float(i))
            popped = []
            while (r := sched.next_request(now=10.0)) is not None:
                popped.append((r.uid, len(r.prompt)))
            orders.append((popped, sched.telemetry()))
        assert orders[0] == orders[1], cfg_kw
    assert math.isclose(pt_sched.Scheduler().telemetry()["aging_rate"], 1.0)
