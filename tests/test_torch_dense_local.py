"""The port's gemma3 (sliding-window ``attn_local`` blocks, a 5:1
local:global pattern, the unstacked ``tail_pattern`` blocks, ring-buffer
decode caches) and ``internlm2-20b`` on the CPU against the JAX reference.

Parameters are drawn by the reference (``repro.models.lm.init_params``,
``jax.random.PRNGKey(0)``) and bridged; inputs come from numpy seeds.  Bars:
1e-5 (fp32) for the block functions, 1e-4 for whole-model logits, greedy
tokens equal.  The gemma3 smoke window is W = 16, so every ring here wraps.

On gemma3 the reference's ``DecodeServer`` is no oracle: its
``splice_cache`` leaves the tail rings empty (ROADMAP.md, Queue 3).  The
port's server is held against the reference *model's* greedy loop
(``prefill_chunk`` over the prompt from a fresh cache, then
``decode_step``),
and on ``internlm2-20b``, which has no tail, against the reference server
too.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jax_configs  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.models import transformer as jax_tr  # noqa: E402
from repro.runtime import server as jax_server  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch._tree import tree_map  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config  # noqa: E402
from repro_torch.models import lm, transformer  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.runtime.server import DecodeServer, Request, splice_cache  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
W = 16                      # gemma3 smoke's sliding window
MAX_SEQ = 64

# prompts on both sides of the window, decode running past it; two slots,
# so slots are reused and hold an earlier request's rings
PROMPTS = [(20, 12), (7, 20), (33, 8), (16, 10), (17, 14), (12, 6)]
DRIVERS = {"step": (False, 0), "step_block": (True, 0), "chunked": (False, 4)}


def _prompt(n, seed, vocab=256):
    return [int(t) for t in np.random.default_rng(seed).integers(1, vocab, n)]


def _bridged(arch, **over):
    jcfg = dataclasses.replace(jax_configs.get_smoke_config(arch), **over)
    p_j = jax_lm.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = dataclasses.replace(get_smoke_config(arch), **over)
    return jcfg, cfg, p_j, bridge.params_from_jax(jax.tree.map(np.asarray, p_j), cfg, "cpu")


@pytest.fixture(scope="module")
def gemma():
    return _bridged("gemma3-27b")


@pytest.fixture(scope="module")
def internlm():
    return _bridged("internlm2-20b")


_JIT = {}


def _ref(fn, static=(1,)):
    """A reference function, jitted once (its cfg argument static)."""
    if fn not in _JIT:
        _JIT[fn] = jax.jit(fn, static_argnums=static)
    return _JIT[fn]


def _close(pt, ref, **tol):
    np.testing.assert_allclose(pt.detach().numpy(), np.asarray(ref), **(tol or TOL))


def _close_tree(pt, ref, **tol):
    flat_ref = dict(jax.tree_util.tree_flatten_with_path(ref)[0])
    flat_pt = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        else:
            flat_pt[path] = t

    walk(pt, ())
    keys = {tuple(getattr(p, "key", p) for p in path): v for path, v in flat_ref.items()}
    assert set(keys) == set(flat_pt)
    for k, v in keys.items():
        _close(flat_pt[k], v, **tol)


def _ref_greedy(jcfg, p_j, prompt, n, chunk=8):
    """The reference model's greedy loop: the prompt in chained chunks of
    ``chunk`` from a fresh cache (few distinct shapes to compile), then
    ``decode_step``."""
    cache = jax_lm.init_cache(jcfg, 1, MAX_SEQ)
    for s in range(0, len(prompt), chunk):
        lg, cache = _ref(jax_lm.prefill_chunk)(
            p_j, jcfg, jnp.asarray([prompt[s:s + chunk]], jnp.int32), cache, jnp.int32(s))
    out = [int(np.argmax(np.asarray(lg[0])))]
    pos = len(prompt)
    while len(out) < n:
        lg, cache = _ref(jax_lm.decode_step)(p_j, jcfg, jnp.asarray([[out[-1]]], jnp.int32),
                                             cache, jnp.int32(pos))
        out.append(int(np.argmax(np.asarray(lg[0]))))
        pos += 1
    return out


_GREEDY = {}


def _greedy(jcfg, p_j, prompt, n):
    key = (jcfg.name, tuple(prompt), n)
    if key not in _GREEDY:
        _GREEDY[key] = _ref_greedy(jcfg, p_j, prompt, n)
    return _GREEDY[key]


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_configs_registered_and_equal_to_reference():
    for arch in ("gemma3-27b", "internlm2-20b"):
        assert arch in ARCH_IDS
        for ours, theirs in ((get_config(arch), jax_configs.get_config(arch)),
                             (get_smoke_config(arch), jax_configs.get_smoke_config(arch))):
            assert ours == ModelConfig(**dataclasses.asdict(theirs))
            assert ours.layer_pattern == theirs.layer_pattern
            assert ours.n_groups == theirs.n_groups
    g = get_config("gemma3-27b")
    assert g.layer_pattern == ("attn_local",) * 5 + ("attn",) and g.n_groups == 10
    assert g.tail_pattern == ("attn_local", "attn_local")


def test_full_width_param_counts():
    """gemma3-27b at its published widths (d 5376, GQA 32/16 at hd 128,
    qk-norm, d_ff 21 504, vocab 262 144, tied): 412.9 M a layer and a
    1.41 B table, so 27.0 B at 62 layers and 7.19 B at the 14 layers the
    card runs; internlm2-20b (d 6144, GQA 48/8, d_ff 16 384, vocab 92 544,
    untied): 19.9 B at 48 layers, 2.70 B at 4.  Counted from shapes."""
    counts = {}
    for arch in ("gemma3-27b", "internlm2-20b"):
        cfg = get_config(arch)
        D, F, H, KV, hd = cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        per_layer = 2 * D + D * (H + 2 * KV) * hd + H * hd * D + 3 * D * F \
            + (2 * hd if cfg.qk_norm else 0)
        table = cfg.vocab * D * (1 if cfg.tie_embeddings else 2)
        counts[arch] = (per_layer, table)
    assert counts["gemma3-27b"] == (412_887_808, 1_409_286_144)
    assert 62 * 412_887_808 + 1_409_286_144 + 5376 == 27_008_335_616
    assert 14 * 412_887_808 + 1_409_286_144 + 5376 == 7_189_720_832
    assert counts["internlm2-20b"] == (390_082_560, 1_137_180_672)
    assert 48 * 390_082_560 + 1_137_180_672 + 6144 == 19_861_149_696
    assert 4 * 390_082_560 + 1_137_180_672 + 6144 == 2_697_517_056


def test_init_params_and_cache_layout_match_reference(gemma, internlm):
    for jcfg, cfg, p_j, _ in (gemma, internlm):
        p = lm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        assert jax.tree.map(lambda t: tuple(t.shape), p) == \
            jax.tree.map(lambda a: tuple(a.shape), p_j)
        assert lm.param_count(p) == jax_lm.param_count(p_j)
        for B, S in ((3, 8), (2, 40)):       # a ring of max_seq, and of W
            c_pt = lm.init_cache(cfg, B, S, "cpu")
            c_j = jax_lm.init_cache(jcfg, B, S)
            assert jax.tree.map(lambda t: tuple(t.shape), c_pt) == \
                jax.tree.map(lambda a: tuple(a.shape), c_j)
    c = lm.init_cache(gemma[1], 2, 40, "cpu")
    assert c["groups"]["b0_attn_local"]["k"].shape == (1, 2, W, 2, 16)
    assert c["groups"]["b5_attn"]["k"].shape == (1, 2, 40, 2, 16)
    assert c["tail"]["t1_attn_local"]["v"].shape == (2, W, 2, 16)      # no G axis
    assert "tail" not in lm.init_cache(internlm[1], 2, 40, "cpu")


def test_bridge_checks_the_tail(gemma):
    jcfg, cfg, p_j, _ = gemma
    tree = jax.tree.map(np.asarray, p_j)
    bad = dict(tree, tail={"t0_attn_local": tree["tail"]["t0_attn_local"]})
    with pytest.raises(ValueError, match="tail pattern"):
        bridge.params_from_jax(bad, cfg, "cpu")
    c = bridge.cache_from_jax(jax.tree.map(np.asarray, jax_lm.init_cache(jcfg, 2, 20)), "cpu")
    assert c["tail"]["t0_attn_local"]["k"].shape == (2, W, 2, 16)


# ---------------------------------------------------------------------------
# the ring-buffer block functions, 40 steps (past two wraps)
# ---------------------------------------------------------------------------

def _attn(bridged):
    """Block b0_attn_local's attention weights of group 0, both sides."""
    jcfg, cfg, p_j, p_pt = bridged
    pj = jax.tree.map(lambda a: a[0], p_j["groups"]["b0_attn_local"]["attn"])
    pp = tree_map(lambda t: t[0], p_pt["groups"]["b0_attn_local"]["attn"])
    return jcfg, cfg, pj, pp


def _empty_ring(cfg, B):
    z = np.zeros((B, W, cfg.n_kv_heads, cfg.head_dim), np.float32)
    return ({"k": jnp.asarray(z), "v": jnp.asarray(z)},
            {"k": torch.as_tensor(z), "v": torch.as_tensor(z)})


def test_local_window_cache_update_matches_reference(gemma):
    _, cfg, _, _ = gemma
    r = np.random.default_rng(11)
    c_j, c_pt = _empty_ring(cfg, 2)
    start = np.array([0, 5], np.int32)          # per-row positions
    for t in range(40):
        k, v = (r.normal(size=(2, 1, cfg.n_kv_heads, cfg.head_dim)).astype(np.float32)
                for _ in range(2))
        pos = start + t
        c_j = _ref(jax_tr._local_window_cache_update, ())(c_j, jnp.asarray(k), jnp.asarray(v),
                                                jnp.asarray(pos))
        c_pt = transformer._local_window_cache_update(c_pt, torch.as_tensor(k),
                                                      torch.as_tensor(v), torch.as_tensor(pos))
        for n in ("k", "v"):
            np.testing.assert_array_equal(c_pt[n].numpy(), np.asarray(c_j[n]))


def test_gqa_decode_local_matches_reference_past_the_wrap(gemma):
    jcfg, cfg, pj, pp = _attn(gemma)
    r = np.random.default_rng(12)
    c_j, c_pt = _empty_ring(cfg, 2)
    start = np.array([0, 9], np.int32)
    for t in range(40):
        x = r.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
        pos = start + t
        o_j, c_j = _ref(jax_tr._gqa_decode_local)(pj, jcfg, jnp.asarray(x), c_j, jnp.asarray(pos))
        o_pt, c_pt = transformer._gqa_decode_local(pp, cfg, torch.as_tensor(x), c_pt,
                                                   torch.as_tensor(pos))
        _close(o_pt, o_j)
        _close(c_pt["k"], c_j["k"])


@pytest.mark.parametrize("chunk", [1, 5, 8])
def test_gqa_local_chunk_matches_reference_past_the_wrap(gemma, chunk):
    """Chunks of 1, 5 and 8 tokens across W = 16: attention over [old ring
    ∥ chunk], then the chunk's last min(S, W) tokens committed."""
    jcfg, cfg, pj, pp = _attn(gemma)
    r = np.random.default_rng(13 + chunk)
    c_j, c_pt = _empty_ring(cfg, 1)
    for s in range(0, 40, chunk):
        n = min(chunk, 40 - s)
        x = r.normal(size=(1, n, cfg.d_model)).astype(np.float32)
        o_j, c_j = _ref(jax_tr._gqa_local_chunk)(pj, jcfg, jnp.asarray(x), c_j, jnp.int32(s))
        o_pt, c_pt = transformer._gqa_local_chunk(pp, cfg, torch.as_tensor(x), c_pt, s)
        _close(o_pt, o_j)
        _close(c_pt["v"], c_j["v"])


def test_gqa_local_chunk_longer_than_the_window_matches_reference(gemma):
    """One 37-token chunk into a ring of 16 that already holds 5 tokens."""
    jcfg, cfg, pj, pp = _attn(gemma)
    r = np.random.default_rng(20)
    c_j, c_pt = _empty_ring(cfg, 1)
    for s, n in ((0, 5), (5, 37)):
        x = r.normal(size=(1, n, cfg.d_model)).astype(np.float32)
        o_j, c_j = _ref(jax_tr._gqa_local_chunk)(pj, jcfg, jnp.asarray(x), c_j, jnp.int32(s))
        o_pt, c_pt = transformer._gqa_local_chunk(pp, cfg, torch.as_tensor(x), c_pt, s)
        _close(o_pt, o_j)
        _close(c_pt["k"], c_j["k"])


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("arch", ["gemma3-27b", "internlm2-20b"])
def test_prefill_logits_and_caches_match_reference(gemma, internlm, arch, use_pallas):
    """Both sides with ``use_pallas``: the reference's Pallas kernel
    (interpret mode), the port's wrapper (its plain version on the CPU).
    24 tokens: longer than gemma3's window, so the local layers' masks cut."""
    jcfg, cfg, p_j, p_pt = gemma if arch == "gemma3-27b" else internlm
    jcfg, cfg = (dataclasses.replace(c, use_pallas=use_pallas) for c in (jcfg, cfg))
    toks = np.random.default_rng(3).integers(0, cfg.vocab, size=(2, 24)).astype(np.int32)
    lg_j, c_j = jax_lm.prefill(p_j, jcfg, jnp.asarray(toks))
    lg_pt, c_pt = lm.prefill(p_pt, cfg, torch.as_tensor(toks))
    _close(lg_pt, lg_j, **MODEL_TOL)
    _close_tree(c_pt, c_j)
    assert ("tail" in c_pt) == bool(cfg.tail_pattern)


def test_gemma3_two_groups_prefill_chunks_and_decode_match_reference():
    """14 layers (G = 2, the depth the card runs): one-shot prefill, chained
    chunks of 5 across the window, and 24 decode steps past two wraps, each
    against the reference; the chained chunks against one-shot prefill."""
    jcfg, cfg, p_j, p_pt = _bridged("gemma3-27b", n_layers=14)
    assert cfg.n_groups == 2
    toks = np.random.default_rng(4).integers(0, cfg.vocab, size=(1, 24)).astype(np.int32)
    lg_one, _ = lm.prefill(p_pt, cfg, torch.as_tensor(toks))
    _close(lg_one, jax_lm.prefill(p_j, jcfg, jnp.asarray(toks))[0], **MODEL_TOL)
    c_pt = lm.init_cache(cfg, 1, MAX_SEQ, "cpu")
    c_j = jax_lm.init_cache(jcfg, 1, MAX_SEQ)
    for s in range(0, 24, 5):
        chunk = toks[:, s:s + 5]
        lg, c_pt = lm.prefill_chunk(p_pt, cfg, torch.as_tensor(chunk), c_pt, s)
        lg_j, c_j = _ref(jax_lm.prefill_chunk)(p_j, jcfg, jnp.asarray(chunk), c_j, jnp.int32(s))
        _close(lg, lg_j, **MODEL_TOL)
    torch.testing.assert_close(lg, lg_one, **MODEL_TOL)
    _close_tree(c_pt, c_j, **MODEL_TOL)
    nxt = np.argmax(np.asarray(lg_j), -1).astype(np.int32)[:, None]
    for t in range(24):
        lg, c_pt = lm.decode_step(p_pt, cfg, torch.as_tensor(nxt), c_pt, 24 + t)
        lg_j, c_j = _ref(jax_lm.decode_step)(p_j, jcfg, jnp.asarray(nxt), c_j, jnp.int32(24 + t))
        _close(lg, lg_j, **MODEL_TOL)
        nxt = np.argmax(np.asarray(lg_j), -1).astype(np.int32)[:, None]
    _close_tree(c_pt, c_j, **MODEL_TOL)


@pytest.mark.parametrize("arch", ["gemma3-27b", "internlm2-20b"])
def test_chained_chunks_equal_one_shot_and_decode_matches_reference(gemma, internlm, arch):
    """Chunks of 4 over a 22-token prompt against one-shot prefill, then 24
    decode steps at per-row positions against the reference."""
    jcfg, cfg, p_j, p_pt = gemma if arch == "gemma3-27b" else internlm
    toks = np.random.default_rng(5).integers(0, cfg.vocab, size=(2, 22)).astype(np.int32)
    lg_one, _ = lm.prefill(p_pt, cfg, torch.as_tensor(toks))
    c_pt = lm.init_cache(cfg, 2, MAX_SEQ, "cpu")
    c_j = jax_lm.init_cache(jcfg, 2, MAX_SEQ)
    for s in range(0, 22, 4):
        lg, c_pt = lm.prefill_chunk(p_pt, cfg, torch.as_tensor(toks[:, s:s + 4]), c_pt, s)
        _, c_j = _ref(jax_lm.prefill_chunk)(p_j, jcfg, jnp.asarray(toks[:, s:s + 4]), c_j,
                                            jnp.int32(s))
    torch.testing.assert_close(lg, lg_one, **MODEL_TOL)
    nxt = np.argmax(lg.numpy(), -1).astype(np.int32)[:, None]
    pos = np.array([22, 22], np.int32)
    for _ in range(24):
        lg, c_pt = lm.decode_step(p_pt, cfg, torch.as_tensor(nxt), c_pt, torch.as_tensor(pos))
        lg_j, c_j = _ref(jax_lm.decode_step)(p_j, jcfg, jnp.asarray(nxt), c_j, jnp.asarray(pos))
        _close(lg, lg_j, **MODEL_TOL)
        nxt = np.argmax(np.asarray(lg_j), -1).astype(np.int32)[:, None]
        pos = pos + 1


# ---------------------------------------------------------------------------
# splice_cache: the ring wrap, and the tail the reference drops
# ---------------------------------------------------------------------------

def test_splice_cache_wraps_rings_and_splices_the_tail(gemma):
    """A one-shot prefill's 37 positions into a slot whose local rings hold
    16: the groups' leaves equal the reference's splice (last W positions at
    slot p mod W), the tail's get the same placement — which the reference
    leaves undone — and other slots are untouched.  A full-attention leaf
    still raises on overflow."""
    jcfg, cfg, _, _ = gemma
    r = np.random.default_rng(7)
    dst_np = jax.tree.map(lambda a: r.normal(size=a.shape).astype(np.float32),
                          jax_lm.init_cache(jcfg, 3, 40))
    src_np = {"groups": {}, "tail": {}}
    for name, kind in [(f"b{i}_{k}", k) for i, k in enumerate(cfg.layer_pattern)]:
        src_np["groups"][name] = {n: r.normal(size=(1, 1, 37, 2, 16)).astype(np.float32)
                                  for n in ("k", "v")}
    for i, kind in enumerate(cfg.tail_pattern):
        src_np["tail"][f"t{i}_{kind}"] = {n: r.normal(size=(1, 37, 2, 16)).astype(np.float32)
                                         for n in ("k", "v")}
    ref = jax_server.splice_cache(jax.tree.map(jnp.asarray, dst_np),
                                  jax.tree.map(jnp.asarray, src_np), 1, 37, 40)
    got = splice_cache(bridge.cache_from_jax(dst_np, "cpu"),
                       bridge.cache_from_jax(src_np, "cpu"), 1, 40)
    _close_tree({"groups": got["groups"]}, {"groups": ref["groups"]}, atol=0, rtol=0)
    slots = np.arange(37 - W, 37) % W
    for name, leaves in got["tail"].items():
        for n, t in leaves.items():
            want = dst_np["tail"][name][n].copy()
            want[1, slots] = src_np["tail"][name][n][0, 37 - W:]
            np.testing.assert_array_equal(t.numpy(), want)
            # the reference's splice left this leaf as it was
            np.testing.assert_array_equal(np.asarray(ref["tail"][name][n]),
                                          dst_np["tail"][name][n])
    long = jax.tree.map(lambda a: np.zeros(a.shape[:-3] + (41,) + a.shape[-2:], np.float32),
                        src_np)
    with pytest.raises(ValueError, match="overflows the full-attention cache"):
        splice_cache(bridge.cache_from_jax(dst_np, "cpu"), bridge.cache_from_jax(long, "cpu"),
                     0, 40)


REF_LOOP = [13, 123, 52, 123, 162, 249, 52, 126, 162, 163]
REF_SERVER = [13, 221, 13, 123, 162, 196, 243, 73, 73, 36]


@pytest.mark.parametrize("chunk", [0, 4])
def test_reference_server_drops_the_tail_and_the_port_does_not(gemma, chunk):
    """The fault ROADMAP.md Queue 3 records: on a 20-token prompt the
    reference's server decodes from empty tail rings and leaves its own
    model's greedy loop at the second token; the port's server gives the
    loop's tokens."""
    jcfg, cfg, p_j, p_pt = gemma
    prompt = [int(t) for t in np.random.default_rng(0).integers(0, 256, 20)]
    cache = jax_lm.init_cache(jcfg, 1, 48)
    lg, cache = _ref(jax_lm.prefill_chunk)(p_j, jcfg, jnp.asarray([prompt], jnp.int32), cache,
                                           jnp.int32(0))
    loop = [int(np.argmax(np.asarray(lg[0])))]
    while len(loop) < 10:
        lg, cache = _ref(jax_lm.decode_step)(p_j, jcfg, jnp.asarray([[loop[-1]]], jnp.int32),
                                             cache, jnp.int32(19 + len(loop)))
        loop.append(int(np.argmax(np.asarray(lg[0]))))
    assert loop == REF_LOOP
    ref = jax_server.DecodeServer(jcfg, p_j, num_slots=2, max_seq=48, prefill_chunk=chunk)
    ref.submit(jax_server.Request(uid=0, prompt=prompt, max_new_tokens=10))
    assert ref.run_until_drained()[0].out_tokens == REF_SERVER
    srv = DecodeServer(cfg, p_pt, num_slots=2, max_seq=48, prefill_chunk=chunk, device="cpu")
    srv.submit(Request(uid=0, prompt=prompt, max_new_tokens=10))
    assert srv.run_until_drained()[0].out_tokens == REF_LOOP


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------

def _serve(cfg, params, driver, prompts, uid0=0, srv=None, **kw):
    persistent, chunk = DRIVERS[driver]
    if srv is None:
        srv = DecodeServer(cfg, params, num_slots=2, max_seq=MAX_SEQ, block_k=4,
                           prefill_chunk=chunk, device="cpu", **kw)
    for i, (prompt, n) in enumerate(prompts):
        srv.submit(Request(uid=uid0 + i, prompt=list(prompt), max_new_tokens=n))
    done = srv.run_until_drained(persistent=persistent)
    return {r.uid: (r.out_tokens, r.finish_reason) for r in done if r.uid >= uid0}, srv


def _gemma_prompts():
    return [(_prompt(n, seed=30 + i), m) for i, (n, m) in enumerate(PROMPTS)]


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("driver", list(DRIVERS))
def test_gemma3_server_matches_reference_greedy_loop(gemma, driver, use_pallas):
    """Prompts of 7-33 tokens around W = 16 and decode past it, two slots:
    the port's server gives the reference model's greedy tokens under
    every driver."""
    jcfg, cfg, p_j, p_pt = gemma
    prompts = _gemma_prompts()
    got, _ = _serve(dataclasses.replace(cfg, use_pallas=use_pallas), p_pt, driver, prompts)
    for uid, (prompt, n) in enumerate(prompts):
        assert got[uid] == (_greedy(jcfg, p_j, prompt, n), "max_tokens"), uid


def test_gemma3_prefix_cache_hits_give_the_reference_tokens(gemma):
    """Chunked prefill with the prefix cache: a cold pass, a second pass of
    the same prompts under new uids (every one a full hit), and prompts
    sharing a 20-token prefix (partial hits resumed past the window)."""
    jcfg, cfg, p_j, p_pt = gemma
    prompts = _gemma_prompts()
    cold, srv = _serve(cfg, p_pt, "chunked", prompts, prefix_cache_bytes=1 << 24)
    warm, srv = _serve(cfg, p_pt, "chunked", prompts, uid0=100, srv=srv)
    st = srv.stats()["prefix_cache"]
    assert st["hits"] == len(prompts)
    for uid, (prompt, n) in enumerate(prompts):
        want = (_greedy(jcfg, p_j, prompt, n), "max_tokens")
        assert cold[uid] == want and warm[100 + uid] == want, uid
    shared = prompts[0][0]
    fleet = [(shared + _prompt(k, seed=50 + k), 9) for k in (3, 14)]
    got, srv = _serve(cfg, p_pt, "chunked", fleet, uid0=200, srv=srv)
    assert srv.stats()["prefix_cache"]["partial_hits"] >= 2
    for i, (prompt, n) in enumerate(fleet):
        assert got[200 + i] == (_greedy(jcfg, p_j, prompt, n), "max_tokens")


def test_gemma3_adaptive_prefill_and_checkpoint_bytes(gemma):
    """Adaptive chunked prefill under ``step_block()`` with the prefix
    cache gives the reference loop's tokens, and every stored checkpoint
    holds (and counts) the tail rings."""
    from repro_torch.runtime.prefix_cache import tree_bytes

    jcfg, cfg, p_j, p_pt = gemma
    prompts = _gemma_prompts()
    srv = DecodeServer(cfg, p_pt, num_slots=2, max_seq=MAX_SEQ, block_k=4, prefill_chunk=4,
                       prefill_adaptive=True, prefix_cache_bytes=1 << 24, device="cpu")
    got, srv = _serve(cfg, p_pt, "step_block", prompts, srv=srv)
    for uid, (prompt, n) in enumerate(prompts):
        assert got[uid] == (_greedy(jcfg, p_j, prompt, n), "max_tokens"), uid
    entries = [node.entry for node in srv.prefix_cache._entry_nodes]
    assert entries and all(set(e.caches) == {"groups", "tail"} for e in entries)
    assert srv.prefix_cache.bytes_in_use == sum(
        tree_bytes(e.caches) + e.logits.numel() * e.logits.element_size() for e in entries)


def test_gemma3_one_shot_prefix_hit_splices_the_tail(gemma):
    """A one-shot prefill stores its full-length caches; a full hit splices
    them, tail rings included, into a slot that held another request."""
    jcfg, cfg, p_j, p_pt = gemma
    prompts = _gemma_prompts()[:3]
    srv = DecodeServer(cfg, p_pt, num_slots=1, max_seq=MAX_SEQ, prefix_cache_bytes=1 << 24,
                       device="cpu")
    _serve(cfg, p_pt, "step", prompts, srv=srv)
    got, srv = _serve(cfg, p_pt, "step", prompts[::-1], uid0=10, srv=srv)
    assert srv.stats()["prefix_cache"]["hits"] == 3
    for i, (prompt, n) in enumerate(prompts[::-1]):
        assert got[10 + i] == (_greedy(jcfg, p_j, prompt, n), "max_tokens")


def test_quarantined_slot_tail_rings_are_scrubbed(gemma):
    """NaN written into every cache row of a live slot, the tail's rings
    included: the slot is quarantined, scrubbed, and the next request in it
    (a prompt shorter than the window, so most ring rows stay masked) gives
    a fresh server's tokens.  A scrub that skipped the tail would leave NaN
    in masked rows, and 0·NaN in the attention's P·V poisons the request."""
    jcfg, cfg, p_j, p_pt = gemma
    srv = DecodeServer(cfg, p_pt, num_slots=2, max_seq=MAX_SEQ, device="cpu")
    srv.submit(Request(uid=0, prompt=_prompt(20, 40), max_new_tokens=30))
    srv.submit(Request(uid=1, prompt=_prompt(9, 41), max_new_tokens=30))
    srv.step()
    srv.step()
    b = int(np.flatnonzero([r is not None and r.uid == 0 for r in srv.slot_req])[0])
    srv._poison_slot(b)
    for top, axis in (("groups", 1), ("tail", 0)):
        for leaves in srv.caches[top].values():
            for t in leaves.values():
                assert bool(torch.isnan(t.select(axis, b)).all())
                assert not bool(torch.isnan(t.select(axis, 1 - b)).any())
    srv.step()
    assert srv.quarantined[b] and srv.completed[-1].finish_reason == "error:nonfinite"
    prompt = _prompt(6, 42)
    srv.submit(Request(uid=2, prompt=prompt, max_new_tokens=12))
    done = srv.run_until_drained()
    by_uid = {r.uid: r for r in done}
    assert by_uid[2].finish_reason == "max_tokens"
    fresh, _ = _serve(cfg, p_pt, "step", [(prompt, 12)])
    assert by_uid[2].out_tokens == fresh[0][0] == _greedy(jcfg, p_j, prompt, 12)
    assert by_uid[1].finish_reason == "max_tokens"


@pytest.mark.parametrize("driver", list(DRIVERS))
def test_internlm2_server_matches_reference_server_and_loop(internlm, driver):
    """No tail: the reference server is an oracle too.  Tokens, reasons and
    sync counts equal to it under every driver, and to the greedy loop."""
    jcfg, cfg, p_j, p_pt = internlm
    prompts = [(_prompt(n, seed=60 + i), m) for i, (n, m) in enumerate(PROMPTS[:4])]
    got, srv = _serve(cfg, p_pt, driver, prompts)
    persistent, chunk = DRIVERS[driver]
    ref = jax_server.DecodeServer(jcfg, p_j, num_slots=2, max_seq=MAX_SEQ, block_k=4,
                                  prefill_chunk=chunk)
    for i, (prompt, n) in enumerate(prompts):
        ref.submit(jax_server.Request(uid=i, prompt=list(prompt), max_new_tokens=n))
    done = ref.run_until_drained(persistent=persistent)
    assert got == {r.uid: (r.out_tokens, r.finish_reason) for r in done}
    assert srv.stats()["decode_syncs"] == ref.stats()["decode_syncs"]
    for uid, (prompt, n) in enumerate(prompts):
        assert got[uid][0] == _greedy(jcfg, p_j, prompt, n)
