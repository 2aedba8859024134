"""The port's radix prefix cache against the JAX reference's.

The reference's radix, LRU and prune tests are replayed side by side: the
same operations on both classes give equal lookup depths, stats, evictions
and tree sizes.  A stored checkpoint is a copy no later in-place write can
reach (torch tensors are mutable, JAX arrays are not).  Served with the
cache on bridged smoke weights, full and partial hits give the reference
server's tokens and ``prompt_steps_computed`` on ``paper-lstm``,
``falcon-mamba-7b`` and ``smollm-135m``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jax_configs  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.runtime import prefix_cache as jax_pc  # noqa: E402
from repro.runtime import server as jax_server  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch._tree import tree_leaves  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.runtime import prefix_cache as pt_pc  # noqa: E402
from repro_torch.runtime.server import DecodeServer, Request  # noqa: E402

BOTH = ((pt_pc, lambda a: torch.as_tensor(np.asarray(a, np.float32))),
        (jax_pc, lambda a: jnp.asarray(np.asarray(a, np.float32))))


def _nodes(pc):
    n, stack = 0, [pc.root]
    while stack:
        node = stack.pop()
        n += 1
        stack.extend(node.children.values())
    return n


def _side_by_side(ops):
    """Run ``ops(mod, arr)`` against both classes; return both outcomes."""
    return [ops(mod, arr) for mod, arr in BOTH]


def test_radix_structure_matches_reference():
    def ops(mod, arr):
        pc = mod.PrefixCache(budget_bytes=1 << 30)
        s1 = {"h": arr(np.ones((1, 4)))}
        pc.insert([1, 2, 3, 4], s1, logits=arr(np.ones(8)), resumable=True)
        pc.insert([1, 2, 5], s1, logits=arr(np.ones(8)), resumable=False)
        pc.insert([1, 2], s1, logits=arr(np.ones(8)), resumable=True)
        out = [[(e.length, e.resumable, e.nbytes) for e in pc.lookup(p)]
               for p in ([1, 2, 3, 4, 9], [1, 2, 5], [2, 1], [1], [1, 2, 3])]
        out.append([pc.peek_depth(p) for p in ([1, 2, 3, 4, 9], [1, 2, 5, 6], [7])])
        pc.record_hit(4, full=True)
        pc.record_hit(2, full=False)
        pc.record_miss()
        return out, pc.telemetry(), _nodes(pc)

    got, ref = _side_by_side(ops)
    assert got == ref
    assert got[0][0] == [(4, True, 48), (2, True, 48)]


@pytest.mark.parametrize("budget,n", [(1, 1), (2 * 16 + 8, 4), (16, 6), (3 * 16, 9)])
def test_lru_eviction_matches_reference(budget, n):
    def ops(mod, arr):
        pc = mod.PrefixCache(budget_bytes=budget)
        trail = []
        for i in range(n):
            pc.insert([i, i + 1], {"h": arr(np.full((1, 4), float(i)))})
            if i % 3 == 2:       # touch an older prefix: it becomes most recent
                pc.lookup([i - 1, i])
            trail.append((pc.telemetry(), [e.length for e in pc.lookup([i, i + 1])]))
        return trail, [len(pc.lookup([i, i + 1])) for i in range(n)], _nodes(pc)

    got, ref = _side_by_side(ops)
    assert got == ref
    assert got[0][-1][0]["bytes_in_use"] <= budget or budget < 16


def test_eviction_prunes_tree_nodes_as_reference():
    def ops(mod, arr):
        pc = mod.PrefixCache(budget_bytes=2 * 16 + 8)
        for i in range(200):
            pc.insert([i, i + 1, i + 2], {"h": arr(np.full((1, 4), float(i)))})
        pc2 = mod.PrefixCache(budget_bytes=16)
        pc2.insert([7, 8, 9, 10], {"h": arr(np.ones((1, 4)))})
        pc2.insert([7, 8], {"h": arr(np.ones((1, 4)))})        # splits, evicts the leaf
        pc2.insert([1, 2], {"h": arr(np.ones((1, 4)))})        # evicts [7, 8] as well
        return (pc.telemetry(), _nodes(pc), pc2.telemetry(), _nodes(pc2),
                [e.length for e in pc2.lookup([1, 2])])

    got, ref = _side_by_side(ops)
    assert got == ref
    assert got[1] <= 1 + 2 * got[0]["entries"] and got[3] == 2


def test_tree_bytes_counts_tensor_leaves():
    tree = {"a": torch.zeros((3, 4)), "b": {"c": torch.zeros(5, dtype=torch.int8),
                                            "d": torch.zeros(2, dtype=torch.bfloat16)}}
    assert pt_pc.tree_bytes(tree) == 48 + 5 + 4
    assert pt_pc.tree_bytes(tree) == jax_pc.tree_bytes(
        {"a": jnp.zeros((3, 4)), "b": {"c": jnp.zeros(5, jnp.int8), "d": jnp.zeros(2, jnp.bfloat16)}})


def test_insert_stores_a_copy():
    pc = pt_pc.PrefixCache()
    h = torch.arange(8.0).reshape(2, 4)
    kv = torch.arange(24.0).reshape(1, 1, 6, 4)
    logits = torch.ones(5)
    pc.insert([1, 2], {"h": h, "k": kv[:, :, :2]}, logits=logits)
    h.fill_(-1)
    kv.fill_(-1)
    logits.fill_(-1)
    (entry,) = pc.lookup([1, 2])
    assert torch.equal(entry.caches["h"], torch.arange(8.0).reshape(2, 4))
    assert torch.equal(entry.caches["k"], torch.arange(24.0).reshape(1, 1, 6, 4)[:, :, :2])
    assert bool((entry.logits == 1).all())
    assert entry.nbytes == 4 * (8 + 8 + 5)


# ---------------------------------------------------------------------------
# served hits against the reference server
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["paper-lstm", "falcon-mamba-7b", "smollm-135m"])
def model(request):
    arch = request.param
    jcfg = jax_configs.get_smoke_config(arch)
    p_j = jax_lm.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_smoke_config(arch)
    return arch, jcfg, p_j, cfg, bridge.params_from_jax(jax.tree.map(np.asarray, p_j), cfg, "cpu")


SHARED = [3, 1, 4, 1, 5, 9, 2, 6]            # 2 chunks of 4
LONG = SHARED + [8, 7, 8, 2, 5]
OTHER = [11, 12, 13]
_REF = {}


def _serve_hits(srv, request_cls):
    """Cold shared prompt, a longer prompt resuming from it (partial hit),
    both again (full hits), and an unrelated prompt (miss); returns each
    pass's tokens and the prompt steps and cache stats after each."""
    out = []
    for uid, prompt in enumerate([SHARED, LONG, SHARED, LONG, OTHER]):
        srv.submit(request_cls(uid=uid, prompt=list(prompt), max_new_tokens=4))
        done = srv.run_until_drained()
        st = srv.stats()
        out.append((list(done[-1].out_tokens), done[-1].finish_reason,
                    done[-1].prefix_hit_tokens, st["prefill"]["prompt_steps_computed"],
                    {k: st["prefix_cache"][k] for k in ("hits", "partial_hits", "misses",
                                                        "insertions", "evictions",
                                                        "prompt_steps_saved", "entries")}))
    return out, st["decode_syncs"]


@pytest.mark.parametrize("use_pallas", [False, True])
def test_full_and_partial_hits_match_reference(model, use_pallas):
    arch, jcfg, p_j, cfg, p_pt = model
    kw = dict(num_slots=2, max_seq=48, prefill_chunk=4, prefix_cache_bytes=64 << 20)
    if arch not in _REF:      # the reference server's run, once per model
        _REF[arch] = _serve_hits(jax_server.DecodeServer(jcfg, p_j, **kw), jax_server.Request)
    ref = _REF[arch]
    got = _serve_hits(DecodeServer(dataclasses.replace(cfg, use_pallas=use_pallas), p_pt,
                                   device="cpu", **kw), Request)
    assert got == ref
    passes = got[0]
    assert [p[2] for p in passes] == [0, len(SHARED), len(SHARED), len(LONG), 0]
    assert passes[2][3] == passes[1][3]          # a full hit recomputes 0 steps
    assert passes[3][0] == passes[1][0] and passes[2][0] == passes[0][0]
    cold = DecodeServer(cfg, p_pt, num_slots=2, max_seq=48, device="cpu")
    cold.submit(Request(uid=0, prompt=list(LONG), max_new_tokens=4))
    assert cold.run_until_drained()[0].out_tokens == passes[1][0]


def test_one_shot_prompts_serve_full_hits(model):
    """Unchunked: every prompt end is stored, not resumable; a repeated
    prompt is a full hit, a longer one a miss."""
    arch, jcfg, p_j, cfg, p_pt = model
    kw = dict(num_slots=2, max_seq=48, prefix_cache_bytes=64 << 20)

    def run(srv, request_cls):
        toks = []
        for uid, prompt in enumerate([SHARED, SHARED, LONG]):
            srv.submit(request_cls(uid=uid, prompt=list(prompt), max_new_tokens=3))
            toks.append(list(srv.run_until_drained()[-1].out_tokens))
        st = srv.stats()
        return toks, st["prefill"]["prompt_steps_computed"], st["prefix_cache"]["hits"], \
            st["prefix_cache"]["misses"]

    got = run(DecodeServer(cfg, p_pt, device="cpu", **kw), Request)
    assert got == run(jax_server.DecodeServer(jcfg, p_j, **kw), jax_server.Request)
    assert got[1:] == (len(SHARED) + len(LONG), 1, 2)


def test_stored_checkpoints_are_not_aliased(model):
    """Every stored checkpoint is unchanged after the server goes on
    prefilling, splicing and decoding other requests (which write cache
    trees in place)."""
    arch, _, _, cfg, p_pt = model
    srv = DecodeServer(cfg, p_pt, num_slots=2, max_seq=48, prefill_chunk=4,
                       prefix_cache_bytes=64 << 20, device="cpu")
    srv.submit(Request(uid=0, prompt=list(LONG), max_new_tokens=3))
    srv.run_until_drained()
    entries = [n.entry for n in srv.prefix_cache._entry_nodes]
    assert len(entries) == 4                      # 4, 8, 12 and the prompt's end, 13
    before = [[t.clone() for t in tree_leaves(e.caches)] + [e.logits.clone()]
              for e in entries]
    rng = np.random.default_rng(3)
    for uid in range(1, 6):
        prompt = SHARED[:4] + [int(t) for t in rng.integers(1, cfg.vocab, 6)]
        srv.submit(Request(uid=uid, prompt=prompt, max_new_tokens=6))
    srv.submit(Request(uid=9, prompt=list(LONG), max_new_tokens=6))
    srv.run_until_drained()
    assert srv.stats()["prefix_cache"]["hits"] == 1
    for e, want in zip(entries, before):
        for t, w in zip(tree_leaves(e.caches) + [e.logits], want):
            assert torch.equal(t, w)
