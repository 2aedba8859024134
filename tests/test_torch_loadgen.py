"""The port's seeded load generator against the JAX reference's.

``make_trace`` gives the reference's trace for the same spec.  A replay of
one trace on bridged smoke weights gives the reference server's
``tokens_digest`` under every decode loop and prefill path of the port
(``step()``, ``step_block()``, chunked, adaptive, with the prefix cache on
and off), and the reference's ``decode_syncs`` and ``syncs_per_token`` for
the same server settings.  Both ``check_loadgen_doc``s accept the port's
report.
"""

import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jax_configs  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.obs import check as jax_check  # noqa: E402
from repro.runtime import loadgen as jax_loadgen  # noqa: E402
from repro.runtime import server as jax_server  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.obs import check as pt_check  # noqa: E402
from repro_torch.runtime import loadgen  # noqa: E402
from repro_torch.runtime.server import DecodeServer  # noqa: E402

SPECS = [dict(),
         dict(num_requests=12, short_len=(2, 4), long_len=(6, 9), fleet_frac=0.5,
              fleet_prefix_len=4, fleet_suffix_len=(1, 3), max_new_tokens=5, vocab=256),
         dict(num_requests=32, mean_interarrival_ticks=0.25, vocab=32_000, short_len=(8, 64),
              long_len=(128, 257), long_frac=0.25, fleet_frac=0.4, num_fleets=2,
              fleet_prefix_len=128, fleet_suffix_len=(1, 33), max_new_tokens=32, seed=0),
         dict(num_requests=20, num_fleets=0, long_frac=0.5, seed=11),
         dict(num_requests=7, mean_interarrival_ticks=3.0, seed=3, num_fleets=3)]


@pytest.mark.parametrize("i", range(len(SPECS)))
def test_make_trace_is_the_reference_trace(i):
    got = loadgen.make_trace(loadgen.TraceSpec(**SPECS[i]))
    ref = jax_loadgen.make_trace(jax_loadgen.TraceSpec(**SPECS[i]))
    assert [dataclasses.astuple(it) for it in got.items] == \
        [dataclasses.astuple(it) for it in ref.items]
    assert dataclasses.asdict(got.spec) == dataclasses.asdict(ref.spec)
    assert loadgen.make_trace(loadgen.TraceSpec(**SPECS[i])) == got     # seeded


def test_tokens_digest_is_the_reference_digest():
    outs = {3: [1, 2, 3], 0: [], 17: [5]}
    assert loadgen.tokens_digest(outs) == jax_loadgen.tokens_digest(outs)
    assert loadgen.tokens_digest({0: [1]}) != loadgen.tokens_digest({0: [2]})


# a small trace: few distinct prompt lengths keep the reference's jit
# compiles few, fleets give the prefix cache full and partial hits
TRACE = dict(num_requests=10, mean_interarrival_ticks=0.5, short_len=(2, 4), long_len=(8, 9),
             long_frac=0.2, fleet_frac=0.5, num_fleets=2, fleet_prefix_len=4,
             fleet_suffix_len=(1, 3), max_new_tokens=5, vocab=256, seed=0)

# name -> server settings, identical for the two servers
RUNS = {
    "step": dict(),
    "step_block": dict(persistent=True),
    "chunked": dict(prefill_chunk=2),
    "chunked_prefix": dict(prefill_chunk=2, prefix_cache_bytes=64 << 20),
    "adaptive_prefix": dict(prefill_chunk=2, prefill_adaptive=True, prefix_cache_bytes=64 << 20),
    "block_chunked_prefix": dict(persistent=True, prefill_chunk=2, prefix_cache_bytes=64 << 20),
    "prefix_oneshot": dict(prefix_cache_bytes=64 << 20),
}
# the runs held to the reference's own replay, sync for sync (the others to
# its digest: greedy tokens do not depend on the decode loop or the cache)
REFERENCE_RUNS = {"paper-lstm": ("step", "step_block", "chunked_prefix", "adaptive_prefix"),
                  "falcon-mamba-7b": ("chunked_prefix",),
                  "smollm-135m": ("step", "chunked_prefix")}


@pytest.fixture(scope="module")
def reference():
    """Bridged smoke weights and the reference server's replays (twice
    each: cold, then the same prompts under fresh uids, with the server's
    ``decode_syncs`` and ``syncs_per_token`` after each), computed once."""
    out = {}
    for arch, runs in REFERENCE_RUNS.items():
        jcfg = jax_configs.get_smoke_config(arch)
        p_j = jax_lm.init_params(jcfg, jax.random.PRNGKey(0))
        cfg = get_smoke_config(arch)
        p_pt = bridge.params_from_jax(jax.tree.map(np.asarray, p_j), cfg, "cpu")
        out[arch] = (cfg, p_pt, {name: _replay_twice(
            jax_loadgen, jax_server.DecodeServer(jcfg, p_j, num_slots=4, max_seq=32, block_k=4,
                                                 **RUNS[name]))
            for name in runs})
    return out


def _replay_twice(mod, srv):
    trace = mod.make_trace(mod.TraceSpec(**TRACE))
    out = []
    for offset in (0, 100):
        rep = mod.replay(srv, trace, uid_offset=offset)
        st = srv.stats()
        out.append(dict(rep, decode_syncs=st["decode_syncs"],
                        syncs_per_token=st["syncs_per_token"]))
    return out


def _port_replays(cfg, p_pt, name, use_pallas=False):
    srv = DecodeServer(dataclasses.replace(cfg, use_pallas=use_pallas), p_pt, num_slots=4,
                       max_seq=32, block_k=4, device="cpu", **RUNS[name])
    return srv, _replay_twice(loadgen, srv)


COMPARED = ("ticks", "requests", "completed", "by_reason", "decoded_tokens", "tokens_digest",
            "per_shard", "spec", "mesh", "decode_syncs", "syncs_per_token")


@pytest.mark.parametrize("name", list(RUNS))
def test_paper_lstm_replay_matches_reference(reference, name):
    """Every path's digest is the reference's; where the reference ran the
    same settings, so are the ticks, the syncs and ``syncs_per_token``."""
    cfg, p_pt, reps = reference["paper-lstm"]
    srv, got = _port_replays(cfg, p_pt, name)
    digest = reps["step"][0]["tokens_digest"]
    assert got[0]["tokens_digest"] == got[1]["tokens_digest"] == digest
    assert got[0]["completed"] == TRACE["num_requests"]
    if name in reps:
        for g, r in zip(got, reps[name]):
            assert {k: g[k] for k in COMPARED} == {k: r[k] for k in COMPARED}
    if "prefix_cache_bytes" in RUNS[name]:
        pc = srv.stats()["prefix_cache"]
        assert pc["hits"] >= TRACE["num_requests"] and pc["prompt_steps_saved"] > 0


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "smollm-135m"])
@pytest.mark.parametrize("name", ["step", "step_block", "chunked_prefix"])
def test_mamba_and_dense_replays_match_reference(reference, arch, name):
    cfg, p_pt, reps = reference[arch]
    digest = next(iter(reps.values()))[0]["tokens_digest"]
    _, got = _port_replays(cfg, p_pt, name, use_pallas=True)
    assert got[0]["tokens_digest"] == got[1]["tokens_digest"] == digest
    if name in reps:
        for g, r in zip(got, reps[name]):
            assert {k: g[k] for k in COMPARED} == {k: r[k] for k in COMPARED}


def test_both_checkers_accept_the_port_report(reference):
    cfg, p_pt, _ = reference["paper-lstm"]
    _, (first, second) = _port_replays(cfg, p_pt, "chunked_prefix")
    for doc in (first, second):
        assert pt_check.check_loadgen_doc(doc) == []
        assert jax_check.check_loadgen_doc(doc) == []
    assert first["schema"] == "repro.loadgen/v1" and first["mesh"] is None
    assert first["per_shard"][0]["decoded_tokens"] == first["decoded_tokens"]
