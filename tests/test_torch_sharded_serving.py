"""``DecodeServer(plan=)`` in both layouts against the reference's
``run_sharded_serving.py`` and ``run_sharded_loadgen.py`` contracts.

paper-lstm smoke, 8 slots, ``dp=8, tp=1``, the scripts' requests and seeds.
The sharded layout runs on 8 gloo ranks spawned by
``repro_torch.launch.spawn.run_ranks``: every rank serves the same stream
and holds one slot.  The reference runs here in the parent process, on the
weights that cross to the port (and to the ranks) as numpy arrays; the
ranks import no JAX.

PARITY     — greedy tokens under ``step()`` and under ``persistent=True,
             block_k=4`` equal the port's ``plan=None`` server's, which
             equal the reference ``plan=None`` server's.
LOGITS     — every decode call's logits are the ``plan=None`` server's
             rows, bit for bit, in both layouts and under both drivers.
AFFINITY   — a repeated prompt goes to the shard whose prefix cache holds
             its checkpoint, though a lower shard is as free.
QUARANTINE — NaN in slot 0 (shard 0) quarantines that slot only.
HOST STATE — after every drain the host state (slot map, positions, flags,
             queue, jobs, retired requests, prefix-cache trees, counters)
             is the same on every rank, and the same as the folded
             layout's.
LOADGEN    — the script's trace under dp1, dp8_folded and dp8_sharded gives
             one ``tokens_digest``; every report passes
             ``repro_torch.obs.check``; ``per_shard`` rows sum to the
             aggregate; the shard-tagged ledger rows survive the metrics
             export.
"""

import contextlib
import hashlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import bridge  # noqa: E402
from repro_torch import obs as obs_lib  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch.mesh import AXES, AbstractMesh, make_local_mesh  # noqa: E402
from repro_torch.launch.spawn import run_ranks  # noqa: E402
from repro_torch.obs.check import check_loadgen_doc, check_metrics_doc  # noqa: E402
from repro_torch.runtime import DecodeServer, Request, ShardPlan, loadgen  # noqa: E402

DP = 8
ARCH = "paper-lstm"
TRACE = dict(num_requests=12, mean_interarrival_ticks=0.5, max_new_tokens=6, seed=7)
# a sharded rank's logits against plan=None's rows, relative to max |logit|,
# where the GEMM's bits depend on its row count (measured 2.980e-07 at a max
# |logit| of 0.6426: a few fp32 ulps carried through the recurrence)
DP_ROW_GAP = 2e-6


def reqs(vocab, n=8, max_new=6, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(uid=i, prompt=[int(t) for t in rng.integers(1, vocab,
                                                                size=int(rng.integers(2, 6)))],
                    max_new_tokens=max_new)
            for i in range(n)]


@contextlib.contextmanager
def decode_logits(srv, rows):
    """``{(uid, position): logits}`` of every ``lm.decode_step`` call of
    ``srv`` for the requests in the slot ``rows`` this process holds: a
    request's logits at each position, wherever the plan placed it (the
    first call at a position; a slot that retires inside a decode block
    idles there)."""
    from repro_torch.models import lm

    got, inner = {}, lm.decode_step

    def recorded(params, cfg, tokens, caches, pos):
        out = inner(params, cfg, tokens, caches, pos)
        logits = out[0].float().reshape(len(rows), -1).numpy()
        for j, b in enumerate(rows):
            if srv.slot_req[b] is not None:
                got.setdefault((srv.slot_req[b].uid, int(pos.reshape(-1)[j])), logits[j].copy())
        return out

    lm.decode_step = recorded
    try:
        yield got
    finally:
        lm.decode_step = inner


def gemm_bits_depend_on_rows(params, rows: int, part: int) -> bool:
    """Whether this machine's GEMM gives the first ``part`` rows of a
    ``rows``-row product other bits than the ``part``-row product, on the
    decode's tied head (``h @ table.T``)."""
    w = params["embed"]["table"].T
    x = torch.randn(rows, w.shape[0], generator=torch.Generator().manual_seed(0))
    return not torch.equal((x @ w)[:part], x[:part] @ w)


def _digest(state) -> str:
    return hashlib.sha256(repr(state).encode()).hexdigest()[:16]


def _drain(cfg, params, plan=None, rs=None, logits=None, **kw):
    """Serve ``rs`` to the end: the tokens by uid and the server; with a
    ``logits`` dict, the decode logits of this process's requests go into
    it by (uid, position)."""
    srv = DecodeServer(cfg, params, num_slots=kw.pop("slots", 8), max_seq=32, plan=plan,
                       device="cpu", **kw)
    for r in (rs if rs is not None else reqs(cfg.vocab)):
        srv.submit(r)
    rows = (range(srv.B) if plan is None or plan.fold_data
            else plan.slots_of_shard(plan.local_shard, srv.B))
    with decode_logits(srv, rows) if logits is not None else contextlib.nullcontext() as got:
        done = srv.run_until_drained()
    if logits is not None:
        logits.update(got)
    return {r.uid: list(r.out_tokens) for r in done}, srv


def scenarios(cfg, params, plan):
    """The scripts' scenarios on one server layout; the results every rank
    (or the one folded process) reports."""
    out = {"logits_step": {}, "logits_block": {}}
    out["base"], srv = _drain(cfg, params, plan, logits=out["logits_step"])
    out["state_step"] = _digest(srv.host_state())
    out["mesh"] = srv.stats()["mesh"]
    out["persistent"], srv = _drain(cfg, params, plan, persistent=True, block_k=4,
                                    logits=out["logits_block"])
    out["state_block"] = _digest(srv.host_state())

    pa, pb = [3, 1, 4, 1, 5], [2, 7, 1, 8, 2]
    _, srv = _drain(cfg, params, plan,
                    rs=[Request(uid=0, prompt=pa, max_new_tokens=3),
                        Request(uid=1, prompt=pb, max_new_tokens=3)],
                    prefill_chunk=2, prefix_cache_bytes=64 << 20)
    out["first"] = {tuple(r.prompt): r.shard for r in srv.completed}
    rb = Request(uid=2, prompt=list(pb), max_new_tokens=3)
    srv.submit(rb)
    srv.run_until_drained()
    out["affine"] = (rb.shard, rb.prefix_hit_tokens,
                     [(p["hits"], p["entries"]) for p in srv.stats()["prefix_cache"]["per_shard"]])
    out["state_affinity"] = _digest(srv.host_state())
    out["state_affinity_raw"] = srv.host_state()["prefix_caches"]

    srv = DecodeServer(cfg, params, num_slots=8, max_seq=32, plan=plan, device="cpu")
    for r in reqs(cfg.vocab, max_new=8, seed=3):
        srv.submit(r)
    srv.step()                      # all 8 live, one token decoded each
    srv._poison_slot(0, "nan")      # slot 0 == shard 0 (one slot per shard)
    srv.run_until_drained()
    out["quarantine"] = ({r.uid: (list(r.out_tokens), r.finish_reason) for r in srv.completed},
                         [int(srv.obs.metrics.value("slots_quarantined_shard", shard=s))
                          for s in range(plan.dp)],
                         srv.health()["mesh"])
    out["state_quarantine"] = _digest(srv.host_state())

    obs = obs_lib.Observability()
    srv = DecodeServer(cfg, params, num_slots=8, max_seq=32, persistent=True, block_k=4,
                       plan=plan, obs=obs, prefix_cache_bytes=32 << 20, device="cpu")
    rep = loadgen.replay(srv, loadgen.make_trace(loadgen.TraceSpec(vocab=cfg.vocab, **TRACE)))
    doc = obs.export_metrics()
    out["loadgen"] = (rep, check_metrics_doc(doc),
                      sorted({r["shard"] for r in doc["ledger"]
                              if r["program"].startswith("serve|loadgen|")}))
    out["state_loadgen"] = _digest(srv.host_state())
    return out


def _ranks_serving(rank, world, np_params):
    cfg = get_smoke_config(ARCH)
    params = bridge.params_from_jax(np_params, cfg, device="cpu")
    plan = ShardPlan(make_local_mesh(dp=world, tp=1))
    assert (plan.dp, plan.tp, plan.local_shard) == (world, 1, rank)
    out = scenarios(cfg, params, plan)
    # what the sharded layout refuses
    refusals = []
    for kw in (dict(watchdog_s=1.0), dict(scheduler=None, prefix_cache_bytes=0)):
        try:
            srv = DecodeServer(cfg, params, num_slots=8, max_seq=32, plan=plan, device="cpu", **kw)
            srv.submit(Request(uid=0, prompt=[1, 2], deadline_s=5.0))
        except NotImplementedError as e:
            refusals.append(str(e))
    out["refusals"] = refusals
    out["saw_jax"] = "jax" in sys.modules
    return out


@pytest.fixture(scope="module")
def reference():
    """The reference's plan=None tokens and the bridged weights."""
    import jax

    from repro.configs import get_smoke_config as jax_smoke
    from repro.models import lm as jax_lm
    from repro.runtime import DecodeServer as JaxServer
    from repro.runtime import Request as JaxRequest
    from repro.runtime import TraceSpec as JaxTraceSpec
    from repro.runtime import make_trace as jax_make_trace
    from repro.runtime import replay as jax_replay

    jcfg = jax_smoke(ARCH)
    jparams = jax_lm.init_params(jcfg, jax.random.PRNGKey(0))

    def jdrain(rs):
        srv = JaxServer(jcfg, jparams, num_slots=8, max_seq=32)
        for r in rs:
            srv.submit(JaxRequest(uid=r.uid, prompt=r.prompt, max_new_tokens=r.max_new_tokens))
        return {r.uid: list(r.out_tokens) for r in srv.run_until_drained()}

    base = jdrain(reqs(jcfg.vocab))
    q_base = jdrain(reqs(jcfg.vocab, max_new=8, seed=3))
    srv = JaxServer(jcfg, jparams, num_slots=2, max_seq=32, persistent=True, block_k=4,
                    prefix_cache_bytes=32 << 20)
    rep = jax_replay(srv, jax_make_trace(JaxTraceSpec(vocab=jcfg.vocab, **TRACE)))
    return jax.tree.map(np.asarray, jparams), base, q_base, rep["tokens_digest"]


@pytest.fixture(scope="module")
def runs(reference):
    np_params, *_ = reference
    cfg = get_smoke_config(ARCH)
    params = bridge.params_from_jax(np_params, cfg, device="cpu")
    folded = scenarios(cfg, params, ShardPlan(AbstractMesh((1, DP, 1), AXES), fold_data=True))
    sharded = run_ranks(_ranks_serving, DP, (np_params,), timeout_s=300)
    return cfg, params, folded, sharded


def test_port_unsharded_server_gives_the_reference_tokens(reference, runs):
    _, base, q_base, _ = reference
    cfg, params, *_ = runs
    assert _drain(cfg, params)[0] == base
    assert _drain(cfg, params, rs=reqs(cfg.vocab, max_new=8, seed=3))[0] == q_base


@pytest.mark.parametrize("layout", ["folded", "sharded"])
def test_parity_both_drivers_equal_the_unsharded_server(reference, runs, layout):
    _, base, _, _ = reference
    cfg, params, folded, sharded = runs
    for out in ([folded] if layout == "folded" else sharded):
        assert out["base"] == base, "per-token driver diverged under dp=8"
        assert out["persistent"] == base, "persistent driver diverged under dp=8"
        by_shard = out["mesh"]["decoded_tokens_by_shard"]
        assert sum(by_shard) == sum(len(v) - 1 for v in base.values())
        assert sum(1 for t in by_shard if t > 0) > 1, by_shard
        assert out["mesh"]["layout"] == layout and out["mesh"]["dp"] == DP


@pytest.mark.parametrize("layout", ["folded", "sharded"])
def test_dp_logits_against_the_unsharded_server(runs, layout):
    """DP splits rows: every request's decode logits at every position are
    the ``plan=None`` server's (the folded process holds all of them, each
    sharded rank its own slots' requests, and the ranks together all of
    them once).  The folded layout runs the same batch and is held bit for
    bit.  A sharded rank runs B/dp rows, and the library's GEMM picks its
    kernel by the row count: where this machine's GEMM gives other bits for
    the same rows at B/dp rows than at B (read here on the tied head), the
    gap is reported and held at ``DP_ROW_GAP`` of max |logit|; elsewhere it
    is held bit for bit."""
    cfg, params, folded, sharded = runs
    want = {"step": {}, "block": {}}
    _drain(cfg, params, logits=want["step"])
    _drain(cfg, params, persistent=True, block_k=4, logits=want["block"])
    outs = [folded] if layout == "folded" else sharded
    gap, top = 0.0, 0.0
    for driver, w in want.items():
        keys = [k for out in outs for k in out[f"logits_{driver}"]]
        assert sorted(keys) == sorted(w) and len(w) > 0, driver
        for out in outs:
            for k, g in out[f"logits_{driver}"].items():
                gap = max(gap, float(np.abs(g - w[k]).max()))
                top = max(top, float(np.abs(w[k]).max()))
    print(f"dp={DP} {layout}: max |logit gap| {gap:.3e}, max |logit| {top:.3e}")
    if layout == "folded" or not gemm_bits_depend_on_rows(params, 8, 8 // DP):
        assert gap == 0.0, f"{layout}: logits differ from plan=None by {gap:.3e}"
    else:
        assert gap <= DP_ROW_GAP * top, f"{layout}: logits gap {gap:.3e} > {DP_ROW_GAP} x {top:.3e}"


@pytest.mark.parametrize("layout", ["folded", "sharded"])
def test_affinity_places_a_repeat_on_its_checkpoint_shard(runs, layout):
    _, _, folded, sharded = runs
    for out in ([folded] if layout == "folded" else sharded):
        assert out["first"] == {(3, 1, 4, 1, 5): 0, (2, 7, 1, 8, 2): 1}
        shard, hit, per = out["affine"]
        assert shard == 1, f"affinity lost: placed on shard {shard}"
        assert hit == 5
        assert per[1][0] == 1 and per[0][0] == 0, per


@pytest.mark.parametrize("layout", ["folded", "sharded"])
def test_quarantine_stays_on_its_shard(reference, runs, layout):
    _, _, q_base, _ = reference
    _, _, folded, sharded = runs
    for out in ([folded] if layout == "folded" else sharded):
        done, per_shard, mesh = out["quarantine"]
        assert [u for u, (_, why) in done.items() if why == "error:nonfinite"] == [0]
        for uid, (toks, _) in done.items():
            if uid != 0:
                assert toks == q_base[uid], f"survivor {uid} diverged"
        assert per_shard == [1] + [0] * (DP - 1)
        assert mesh["dp"] == DP


def test_host_state_is_identical_on_every_rank_and_to_the_folded_layout(runs):
    _, _, folded, sharded = runs
    keys = [k for k in folded if k.startswith("state_")]
    for k in keys:
        assert {repr(out[k]) for out in sharded} == {repr(folded[k])}, k
    assert all(not out["saw_jax"] for out in sharded)


def test_loadgen_digests_agree_across_topologies(reference, runs):
    _, _, _, ref_digest = reference
    cfg, params, folded, sharded = runs
    obs = obs_lib.Observability()
    srv = DecodeServer(cfg, params, num_slots=2, max_seq=32, persistent=True, block_k=4,
                       obs=obs, prefix_cache_bytes=32 << 20, device="cpu")
    dp1 = loadgen.replay(srv, loadgen.make_trace(loadgen.TraceSpec(vocab=cfg.vocab, **TRACE)))
    reports = {"dp1": (dp1, [], None), "dp8_folded": folded["loadgen"]}
    reports.update({f"dp8_sharded_r{r}": out["loadgen"] for r, out in enumerate(sharded)})
    for name, (rep, metrics_errs, shards) in reports.items():
        assert not check_loadgen_doc(rep), (name, check_loadgen_doc(rep))
        assert rep["completed"] == rep["requests"] == 12, name
        assert sum(r["decoded_tokens"] for r in rep["per_shard"]) == rep["decoded_tokens"]
        if name != "dp1":
            assert len(rep["per_shard"]) == DP
            assert rep["mesh"]["layout"] == ("folded" if name == "dp8_folded" else "sharded")
            assert sum(r["dispatched"] for r in rep["per_shard"]) == 12
            assert not metrics_errs, metrics_errs
            assert shards == list(range(DP))
    digests = {rep["tokens_digest"] for rep, _, _ in reports.values()}
    assert digests == {ref_digest}


def test_sharded_layout_refusals(runs):
    _, _, _, sharded = runs
    for out in sharded:
        watchdog, deadline = out["refusals"]
        assert "watchdog_s" in watchdog and "item 12c" in watchdog
        assert "deadlines" in deadline and "item 12c" in deadline


def test_plan_refusals_without_a_group(runs):
    cfg, params, *_ = runs
    # a sharded plan needs a process group of dp*tp ranks: no quiet fallback
    with pytest.raises(RuntimeError, match="needs a DeviceMesh over an initialised"):
        DecodeServer(cfg, params, num_slots=8, max_seq=32, device="cpu",
                     plan=ShardPlan(AbstractMesh((1, DP, 1), AXES)))
    # tp > 1 serving is item 12c; folded tp > 1 is the reference's ValueError
    with pytest.raises(NotImplementedError, match="tp=2.*item 12c"):
        DecodeServer(cfg, params, num_slots=8, max_seq=32, device="cpu",
                     plan=ShardPlan(AbstractMesh((1, 4, 2), AXES)))
    with pytest.raises(ValueError, match="tensor parallelism needs the physical layout"):
        ShardPlan(AbstractMesh((1, 4, 2), AXES), fold_data=True)
    # an uneven slot pool
    with pytest.raises(ValueError, match="num_slots=6 must divide evenly over dp=8"):
        DecodeServer(cfg, params, num_slots=6, max_seq=32, device="cpu",
                     plan=ShardPlan(AbstractMesh((1, DP, 1), AXES), fold_data=True))


def test_launcher_serves_sharded_under_torchrun(tmp_path):
    """``--mesh 2x1`` under torchrun (a standalone rendezvous on a free
    port): rank 0 writes the replay report, whose digest is the folded
    layout's in one process."""
    import json
    import os
    import subprocess
    from pathlib import Path

    from repro_torch.launch import serve

    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=src, OMP_NUM_THREADS="1")
    args = ["--arch", ARCH, "--device", "cpu", "--requests", "6", "--max-new", "4",
            "--loadgen", "--prefix-cache", "8", "--mesh", "2x1"]
    out = tmp_path / "sharded.json"
    subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                    "--nproc-per-node=2", "-m", "repro_torch.launch.serve", *args,
                    "--loadgen-out", str(out)],
                   env=env, check=True, timeout=240, capture_output=True)
    folded = tmp_path / "folded.json"
    serve.main(args + ["--mesh-layout", "folded", "--loadgen-out", str(folded)])
    a, b = json.loads(out.read_text()), json.loads(folded.read_text())
    assert a["mesh"]["layout"] == "sharded" and b["mesh"]["layout"] == "folded"
    assert a["tokens_digest"] == b["tokens_digest"] and a["completed"] == 6
    assert not check_loadgen_doc(a)
