"""The port's MoE family (``olmoe-1b-7b``; ``deepseek-v2-lite-16b`` with MLA)
and weight-only int8 serving on the CPU against the JAX reference.

Parameters are drawn by the reference (``repro.models.lm.init_params``,
``jax.random.PRNGKey(0)``) and bridged; inputs come from numpy seeds.  Bar:
1e-5 (fp32, atol = rtol) everywhere.  The router is discontinuous (a
one-ulp change upstream can swap a token's k-th and (k+1)-th expert), so
every comparison of MoE outputs first asserts that the expert ids from
``route`` are equal, then compares values.

Chunked prefill differs from one-shot prefill on MoE configs through
capacity drops alone (the groups are chunk-local, so the tokens dropped
differ): each path is held against the same path of the reference, chunks
against one-shot only at ``capacity_factor=100``, where nothing drops.  The
servers run 3 slots, so a decode tick's group of 3 tokens has capacity
``C = 2`` per expert and one slot's token can drop another's; the port's
server must give the reference server's tokens under every driver.
"""

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jax_configs  # noqa: E402
from repro.models import attention as jax_attn  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.runtime import faults as jax_faults  # noqa: E402
from repro.runtime import loadgen as jax_loadgen  # noqa: E402
from repro.runtime import quantized as jax_quant  # noqa: E402
from repro.runtime import server as jax_server  # noqa: E402
from repro.runtime.scheduler import AsyncServer as JaxAsyncServer  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch._tree import tree_map  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config  # noqa: E402
from repro_torch.core.quantization import output_snr_db  # noqa: E402
from repro_torch.models import attention, lm, moe  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.layers import mlp_apply  # noqa: E402
from repro_torch.runtime import AsyncServer  # noqa: E402
from repro_torch.runtime import faults as fl  # noqa: E402
from repro_torch.runtime.loadgen import tokens_digest  # noqa: E402
from repro_torch.runtime.prefix_cache import tree_bytes  # noqa: E402
from repro_torch.runtime.quantized import dequantize_lm_params, quantize_lm_params  # noqa: E402
from repro_torch.runtime.server import DecodeServer, Request, splice_cache  # noqa: E402

ARCHS = ("olmoe-1b-7b", "deepseek-v2-lite-16b")
TOL = dict(atol=1e-5, rtol=1e-5)
MAX_SEQ = 64
SLOTS = 3


def _prompt(n, seed, vocab=256):
    return [int(t) for t in np.random.default_rng(seed).integers(1, vocab, n)]


_MODELS = {}


def _model(arch, **over):
    """(reference cfg, port cfg, reference params, port params) on bridged
    weights; ``over`` replaces config fields on both sides."""
    key = (arch, tuple(sorted(over.items())))
    if key not in _MODELS:
        jcfg = dataclasses.replace(jax_configs.get_smoke_config(arch), **over)
        cfg = dataclasses.replace(get_smoke_config(arch), **over)
        base = _MODELS.get((arch, ()))
        p_j = base[2] if base else _ref(jax_lm.init_params, (0,))(jcfg, jax.random.PRNGKey(0))
        p_pt = base[3] if base else bridge.params_from_jax(
            jax.tree.map(np.asarray, p_j), cfg, "cpu")
        _MODELS[key] = (jcfg, cfg, p_j, p_pt)
    return _MODELS[key]


_JIT = {}


def _ref(fn, static=(1,)):
    """A reference function, jitted once (its cfg argument static)."""
    if (fn, static) not in _JIT:
        _JIT[fn, static] = jax.jit(fn, static_argnums=static)
    return _JIT[fn, static]


def _close(pt, ref, **tol):
    np.testing.assert_allclose(pt.detach().numpy(), np.asarray(ref), **(tol or TOL))


def _flat(tree, path=()):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, path + (key,)).items()}
    return {path: tree}


def _close_tree(pt, ref, **tol):
    flat_pt = _flat(pt)
    flat_ref = {tuple(getattr(p, "key", p) for p in path): v
                for path, v in jax.tree_util.tree_flatten_with_path(ref)[0]}
    assert set(flat_pt) == set(flat_ref)
    for k, v in flat_ref.items():
        _close(flat_pt[k], v, **tol)


def _moe_block(bridged, g=0):
    """Group ``g``'s MoE parameters, both sides."""
    _, _, p_j, p_pt = bridged
    return (jax.tree.map(lambda a: a[g], p_j["groups"]["b0_moe"]["moe"]),
            tree_map(lambda t: t[g], p_pt["groups"]["b0_moe"]["moe"]))


def _attn_block(bridged, g=0):
    _, _, p_j, p_pt = bridged
    return (jax.tree.map(lambda a: a[g], p_j["groups"]["b0_moe"]["attn"]),
            tree_map(lambda t: t[g], p_pt["groups"]["b0_moe"]["attn"]))


# ---------------------------------------------------------------------------
# configs, sizes, layouts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_config_registered_and_equal_to_reference(arch):
    assert arch in ARCH_IDS
    for ours, theirs in ((get_config(arch), jax_configs.get_config(arch)),
                         (get_smoke_config(arch), jax_configs.get_smoke_config(arch))):
        assert ours == ModelConfig(**dataclasses.asdict(theirs))
        assert (ours.layer_pattern, ours.n_groups) == (theirs.layer_pattern, theirs.n_groups)
        assert ours.layer_pattern == ("moe",)
        assert ours.kv_cache_bytes(3, 777) == theirs.kv_cache_bytes(3, 777)


# parameters at the published widths, from jax.eval_shape of the reference's
# init_params; the MLA cache's fp32 bytes a position a slot
FULL = {"olmoe-1b-7b": (6_919_100_416, 16 * 2 * 16 * 128 * 4),
        "deepseek-v2-lite-16b": (16_210_324_992, 27 * (512 + 64) * 4)}


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_param_count_and_cache_bytes(arch):
    """Parameters counted from the reference's shapes at full width, the
    same count from the layout's formula, and ``init_cache``'s bytes:
    olmoe's K/V of 16 heads at hd 128, deepseek's 512-wide latent and
    64-wide rope key (62 KB a position in fp32 over 27 layers);
    ``kv_cache_bytes`` counts the same elements in bf16."""
    cfg = get_config(arch)
    jcfg = jax_configs.get_config(arch)
    shapes = jax.eval_shape(lambda k: jax_lm.init_params(jcfg, k), jax.random.PRNGKey(0))
    n = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
    D, E, Fe, H = cfg.d_model, cfg.n_experts, cfg.d_ff_expert, cfg.n_heads
    if cfg.use_mla:
        r, dn, dr, dv = cfg.kv_lora_rank, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, \
            cfg.v_head_dim
        attn = D * H * (dn + dr) + D * r + D * dr + r * H * (dn + dv) + H * dv * D + r
    else:
        attn = 4 * D * H * cfg.head_dim + 2 * cfg.head_dim
    ffn = D * E + 3 * E * D * Fe + 3 * D * cfg.n_shared_experts * Fe
    assert n == cfg.n_layers * (2 * D + attn + ffn) + 2 * cfg.vocab * D + D == FULL[arch][0]
    S = 16
    got = tree_bytes(lm.init_cache(cfg, 1, S, "meta"))
    assert got == S * FULL[arch][1] == 2 * cfg.kv_cache_bytes(1, S)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_and_cache_layout_match_reference(arch):
    jcfg, cfg, p_j, p_pt = _model(arch)
    p = lm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert tree_map(lambda t: tuple(t.shape), p) == jax.tree.map(lambda a: tuple(a.shape), p_j)
    assert lm.param_count(p) == jax_lm.param_count(p_j)
    assert p["groups"]["b0_moe"]["moe"]["router"].dtype == torch.float32
    for B, S in ((3, 8), (2, 40)):
        assert tree_map(lambda t: tuple(t.shape), lm.init_cache(cfg, B, S, "cpu")) == \
            jax.tree.map(lambda a: tuple(a.shape), jax_lm.init_cache(jcfg, B, S))
    # the bridge keeps the router in fp32 whatever the parameter dtype
    half = bridge.params_from_jax(jax.tree.map(np.asarray, p_j),
                                  dataclasses.replace(cfg, param_dtype="bfloat16"), "cpu")
    assert half["groups"]["b0_moe"]["moe"]["router"].dtype == torch.float32
    assert half["groups"]["b0_moe"]["moe"]["w_in"].dtype == torch.bfloat16
    np.testing.assert_array_equal(p_pt["groups"]["b0_moe"]["moe"]["router"].numpy(),
                                  np.asarray(p_j["groups"]["b0_moe"]["moe"]["router"]))


# ---------------------------------------------------------------------------
# the MoE FFN: the reference's five properties, then parity
# ---------------------------------------------------------------------------

def _olmoe_moe(**over):
    cfg = dataclasses.replace(get_smoke_config("olmoe-1b-7b"), **over)
    return cfg, moe.moe_params(torch.Generator().manual_seed(0), cfg)


def _randn(shape, seed, scale=1.0):
    return torch.as_tensor(np.random.default_rng(seed).normal(size=shape).astype(np.float32)
                           * scale)


def test_router_weights_normalized():
    cfg, p = _olmoe_moe()
    top_e, top_w, aux = moe.route(p, cfg, _randn((4, 8, cfg.d_model), 0))
    assert top_e.shape == (4, 8, cfg.top_k)
    np.testing.assert_allclose(top_w.sum(-1).numpy(), 1.0, atol=1e-5)
    assert float(aux) >= 1.0 - 1e-5  # Switch aux loss lower bound at balance


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("cf", [0.5, 1.0, 2.0])
def test_capacity_never_exceeded(seed, cf):
    """No expert keeps more than C of a group's choices: the kept outputs
    of each expert are at most C distinct slots."""
    cfg, p = _olmoe_moe(capacity_factor=cf)
    x = _randn((1, 64, cfg.d_model), 100 + seed)
    top_e, _, _ = moe.route(p, cfg, x)
    C = moe._capacity(64, cfg)
    oh = torch.nn.functional.one_hot(top_e, cfg.n_experts).reshape(1, 64 * cfg.top_k, -1)
    slot = ((torch.cumsum(oh, 1) - oh) * oh).sum(-1)
    kept = torch.zeros(cfg.n_experts, dtype=torch.long)
    for e, s in zip(top_e.reshape(-1).tolist(), slot.reshape(-1).tolist()):
        kept[e] += s < C
    assert int(kept.max()) <= C
    assert int(kept.sum()) < 64 * cfg.top_k or cf >= 2.0


def test_moe_matches_dense_oracle_when_capacity_ample():
    """With nothing dropped the dispatch/combine einsums equal the naive
    per-token weighted sum of expert MLPs."""
    cfg, p = _olmoe_moe(capacity_factor=64.0)
    x = _randn((2, 8, cfg.d_model), 5, 0.5)
    y, _ = moe.moe_apply(p, cfg, x)
    top_e, top_w, _ = moe.route(p, cfg, x)
    ref = torch.zeros_like(x)
    for e in range(cfg.n_experts):
        pe = {"w_in": p["w_in"][e], "w_gate": p["w_gate"][e], "w_out": p["w_out"][e]}
        wsel = torch.where(top_e == e, top_w, 0.0).sum(-1)
        ref = ref + wsel[..., None] * mlp_apply(pe, x, act=cfg.mlp_act)
    np.testing.assert_allclose(y.numpy(), ref.numpy(), atol=2e-5, rtol=1e-4)


def test_shared_experts_always_active():
    """deepseek's shared experts contribute to every token, even when the
    routed capacity is floored at top_k."""
    cfg = dataclasses.replace(get_smoke_config("deepseek-v2-lite-16b"), capacity_factor=0.0)
    p = moe.moe_params(torch.Generator().manual_seed(0), cfg)
    x = _randn((1, 4, cfg.d_model), 1)
    y, _ = moe.moe_apply(p, cfg, x)
    shared_only = mlp_apply(p["shared"], x, act=cfg.mlp_act)
    assert float(y.norm()) > 0 and float(shared_only.norm()) > 0
    routed = y - shared_only
    assert float(routed.norm()) > 0       # the top_k floor keeps a few slots


def test_dropping_monotone_in_capacity():
    """Lower capacity moves the output further from the no-drop one."""
    x = _randn((2, 32, 64), 6, 0.5)
    outs = {}
    for cf in (0.25, 1.0, 64.0):
        cfg, p = _olmoe_moe(capacity_factor=cf)
        outs[cf] = moe.moe_apply(p, cfg, x)[0]
    assert float((outs[0.25] - outs[64.0]).norm()) > float((outs[1.0] - outs[64.0]).norm())


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("B,S,group", [(2, 1, 2048), (2, 19, 2048), (2, 64, 2048),
                                       (2, 20, 16), (1, 21, 16)])
def test_moe_apply_matches_reference(arch, B, S, group):
    """Ids first, then y and the aux loss.  B·S = 40 over groups of 16
    runs 5 groups of 8; 21 tokens run 21 groups of one token (C = top_k);
    64 tokens in one group drop choices (C = 40 of 128)."""
    cfg = get_smoke_config(arch)
    jcfg = jax_configs.get_smoke_config(arch)
    p_j, p_pt = _moe_block(_model(arch))
    x = np.random.default_rng(B * S).normal(size=(B, S, cfg.d_model)).astype(np.float32)
    assert moe.group_size_of(B * S, group) == {2: 2, 38: 38, 128: 128, 40: 8, 21: 1}[B * S]
    e_j, w_j, a_j = _ref(jax_moe.route)(p_j, jcfg, jnp.asarray(x))
    e_pt, w_pt, a_pt = moe.route(p_pt, cfg, torch.as_tensor(x))
    np.testing.assert_array_equal(e_pt.numpy(), np.asarray(e_j))
    _close(w_pt, w_j)
    _close(a_pt, a_j)
    y_j, aux_j = _ref(jax_moe.moe_apply, (1, 3))(p_j, jcfg, jnp.asarray(x), group)
    y_pt, aux_pt = moe.moe_apply(p_pt, cfg, torch.as_tensor(x), group_size=group)
    _close(y_pt, y_j)
    _close(aux_pt, aux_j)


def test_one_nan_token_poisons_its_group_as_in_the_reference():
    """A non-finite token spreads to every token of its group through the
    one-hot dispatch (0 · NaN), in both packages (ROADMAP.md Queue 3)."""
    jcfg = jax_configs.get_smoke_config("olmoe-1b-7b")
    cfg = get_smoke_config("olmoe-1b-7b")
    p_j, p_pt = _moe_block(_model("olmoe-1b-7b"))
    x = np.random.default_rng(3).normal(size=(3, 1, cfg.d_model)).astype(np.float32)
    x[1] = np.nan
    y_j, _ = _ref(jax_moe.moe_apply)(p_j, jcfg, jnp.asarray(x))
    y_pt, _ = moe.moe_apply(p_pt, cfg, torch.as_tensor(x))
    assert np.isnan(np.asarray(y_j)).all() and torch.isnan(y_pt).all()


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

def test_mla_prefill_and_decode_match_reference():
    bridged = _model("deepseek-v2-lite-16b")
    jcfg, cfg = bridged[:2]
    p_j, p_pt = _attn_block(bridged)
    x = np.random.default_rng(7).normal(size=(2, 11, cfg.d_model)).astype(np.float32)
    out_j, (c_j, kr_j) = _ref(jax_attn.mla_prefill)(p_j, jcfg, jnp.asarray(x))
    out_pt, (c_pt, kr_pt) = attention.mla_prefill(p_pt, cfg, torch.as_tensor(x))
    _close(out_pt, out_j)
    _close(c_pt, c_j)
    _close(kr_pt, kr_j)
    # decode (one token and a 4-token chunk) from per-row positions
    cache_np = {"c_kv": np.zeros((2, 16, cfg.kv_lora_rank), np.float32),
                "k_rope": np.zeros((2, 16, cfg.qk_rope_head_dim), np.float32)}
    cache_np["c_kv"][:, :11] = np.asarray(c_j)
    cache_np["k_rope"][:, :11] = np.asarray(kr_j)
    for S, pos in ((1, np.array([11, 7])), (4, np.array([11, 3]))):
        xs = np.random.default_rng(S).normal(size=(2, S, cfg.d_model)).astype(np.float32)
        o_j, c_j2 = _ref(jax_attn.mla_decode)(p_j, jcfg, jnp.asarray(xs),
                                        jax.tree.map(jnp.asarray, cache_np), jnp.asarray(pos))
        o_pt, c_pt2 = attention.mla_decode(p_pt, cfg, torch.as_tensor(xs),
                                           tree_map(torch.as_tensor, cache_np),
                                           torch.as_tensor(pos))
        _close(o_pt, o_j)
        _close_tree(c_pt2, c_j2)


def test_mla_absorbed_decode_equals_naive_prefill():
    """The absorbed (latent-space) decode, token by token, gives the naive
    prefill's outputs: the reference's own property, held on the port."""
    bridged = _model("deepseek-v2-lite-16b")
    cfg = bridged[1]
    _, p = _attn_block(bridged)
    x = _randn((2, 9, cfg.d_model), 8)
    out_prefill, _ = attention.mla_prefill(p, cfg, x)
    cache = {"c_kv": torch.zeros((2, 9, cfg.kv_lora_rank)),
             "k_rope": torch.zeros((2, 9, cfg.qk_rope_head_dim))}
    outs = []
    for t in range(9):
        o, cache = attention.mla_decode(p, cfg, x[:, t:t + 1], cache, t)
        outs.append(o)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), out_prefill.numpy(), **TOL)


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("use_pallas", [False, True])
def test_prefill_logits_and_caches_match_reference(arch, use_pallas):
    """One-shot prefill of 19 tokens at B = 2 (one MoE group of 38): the
    per-block routing ids, then logits and every cache leaf.  On olmoe
    ``use_pallas`` routes the attention core to ``flash_attention`` (its
    plain version here, the reference's Pallas kernel in interpret mode)."""
    jcfg, cfg, p_j, p_pt = _model(arch, use_pallas=use_pallas)
    toks = np.random.default_rng(1).integers(1, cfg.vocab, (2, 19))
    lg_j, c_j = _ref(jax_lm.prefill)(p_j, jcfg, jnp.asarray(toks, jnp.int32))
    with torch.no_grad():
        lg_pt, c_pt = lm.prefill(p_pt, cfg, torch.as_tensor(toks))
    _close(lg_pt, lg_j)
    _close_tree(c_pt, c_j)


@pytest.mark.parametrize("arch", ARCHS)
def test_chained_chunks_match_reference_chunks_and_decode(arch):
    """19 tokens in chunks of 8, 8 and 3, then two decode ticks, against the
    reference's same chunks: logits and caches."""
    jcfg, cfg, p_j, p_pt = _model(arch)
    toks = np.random.default_rng(2).integers(1, cfg.vocab, (1, 21))
    c_j = jax_lm.init_cache(jcfg, 1, 32)
    c_pt = lm.init_cache(cfg, 1, 32, "cpu")
    with torch.no_grad():
        for s, e in ((0, 8), (8, 16), (16, 19)):
            lg_j, c_j = _ref(jax_lm.prefill_chunk)(p_j, jcfg, jnp.asarray(toks[:, s:e]),
                                                   c_j, jnp.int32(s))
            lg_pt, c_pt = lm.prefill_chunk(p_pt, cfg, torch.as_tensor(toks[:, s:e]), c_pt, s)
            _close(lg_pt, lg_j)
        for t in (19, 20):
            lg_j, c_j = _ref(jax_lm.decode_step)(p_j, jcfg, jnp.asarray(toks[:, t:t + 1]),
                                                 c_j, jnp.int32(t))
            lg_pt, c_pt = lm.decode_step(p_pt, cfg, torch.as_tensor(toks[:, t:t + 1]), c_pt, t)
            _close(lg_pt, lg_j)
    _close_tree(c_pt, c_j)


@pytest.mark.parametrize("arch", ARCHS)
def test_chunks_equal_one_shot_only_where_nothing_drops(arch):
    """At ``capacity_factor=100`` nothing drops, and 19 tokens in chunks of
    8 give the one-shot logits within 1e-5 on both packages.  At 1.25 the
    reference's own chunked and one-shot logits differ (its red
    ``test_prefill_chunk_moe_greedy_parity``): the chunk-local groups drop
    other tokens."""
    toks = np.random.default_rng(4).integers(1, 256, (1, 19))
    for cf, equal in ((100.0, True), (1.25, False)):
        jcfg, cfg, p_j, p_pt = _model(arch, capacity_factor=cf)
        one_j, _ = _ref(jax_lm.prefill)(p_j, jcfg, jnp.asarray(toks))
        c_j = jax_lm.init_cache(jcfg, 1, 32)
        c_pt = lm.init_cache(cfg, 1, 32, "cpu")
        with torch.no_grad():
            one_pt, _ = lm.prefill(p_pt, cfg, torch.as_tensor(toks))
            for s in range(0, 19, 8):
                lg_j, c_j = _ref(jax_lm.prefill_chunk)(p_j, jcfg, jnp.asarray(toks[:, s:s + 8]),
                                                       c_j, jnp.int32(s))
                lg_pt, c_pt = lm.prefill_chunk(p_pt, cfg, torch.as_tensor(toks[:, s:s + 8]),
                                               c_pt, s)
        _close(one_pt, one_j)
        _close(lg_pt, lg_j)
        gap_j = float(np.abs(np.asarray(lg_j) - np.asarray(one_j)).max())
        gap_pt = float((lg_pt - one_pt).abs().max())
        if equal:
            assert gap_j <= 1e-5 and gap_pt <= 1e-5
        else:
            assert gap_j > 1e-3 and gap_pt > 1e-3


def test_splice_cache_writes_the_latent_into_the_slot():
    """A one-shot prefill's ``c_kv``/``k_rope`` (L = 11 positions) go
    left-aligned into slot 1 of a 3-slot cache, as the reference splices."""
    jcfg, cfg, p_j, p_pt = _model("deepseek-v2-lite-16b")
    toks = np.random.default_rng(9).integers(1, cfg.vocab, (1, 11))
    _, src_j = _ref(jax_lm.prefill)(p_j, jcfg, jnp.asarray(toks))
    src_np = jax.tree.map(np.asarray, src_j)
    rng = np.random.default_rng(0)
    dst_np = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32),
                          jax_lm.init_cache(jcfg, SLOTS, 24))
    ref = jax_server.splice_cache(jax.tree.map(jnp.asarray, dst_np),
                                  jax.tree.map(jnp.asarray, src_np), 1, 11, 24)
    got = splice_cache(bridge.cache_from_jax(dst_np, "cpu"), bridge.cache_from_jax(src_np, "cpu"),
                       1, 24)
    for leaf in ("c_kv", "k_rope"):
        g = got["groups"]["b0_moe"][leaf].numpy()
        np.testing.assert_array_equal(g, np.asarray(ref["groups"]["b0_moe"][leaf]))
        np.testing.assert_array_equal(g[:, 1, :11], src_np["groups"]["b0_moe"][leaf][:, 0])
        np.testing.assert_array_equal(g[:, 0], dst_np["groups"]["b0_moe"][leaf][:, 0])


# ---------------------------------------------------------------------------
# the server against the reference server (3 slots: decode drops)
# ---------------------------------------------------------------------------

# three lengths (each reference server compiles one prefill per length)
PROMPTS = [(19, 8), (5, 10), (12, 6), (19, 7), (5, 9), (12, 5)]


def _prompts():
    return [(_prompt(n, seed=40 + i), m) for i, (n, m) in enumerate(PROMPTS)]


DRIVERS = {
    "step": dict(persistent=False),
    "step_block": dict(persistent=True),
    "chunked_cache": dict(persistent=False, prefill_chunk=8, prefix_cache_bytes=1 << 24),
    "adaptive_block": dict(persistent=True, prefill_chunk=8, prefill_adaptive=True,
                           prefix_cache_bytes=1 << 24),
}


def _run(srv, request_cls, prompts, persistent, uid0=0):
    for i, (p, n) in enumerate(prompts):
        srv.submit(request_cls(uid=uid0 + i, prompt=list(p), max_new_tokens=n))
    done = srv.run_until_drained(persistent=persistent)
    return {r.uid: (list(r.out_tokens), r.finish_reason) for r in done if r.uid >= uid0}


def _both(arch, driver, passes=1):
    """The reference's and the port's server over the prompts, ``passes``
    times (a second pass under new uids: prefix-cache full hits)."""
    jcfg, cfg, p_j, p_pt = _model(arch)
    kw = dict(DRIVERS[driver])
    persistent = kw.pop("persistent")
    ref = jax_server.DecodeServer(jcfg, p_j, num_slots=SLOTS, max_seq=MAX_SEQ, block_k=4, **kw)
    srv = DecodeServer(cfg, p_pt, num_slots=SLOTS, max_seq=MAX_SEQ, block_k=4, device="cpu", **kw)
    out = []
    for k in range(passes):
        want = _run(ref, jax_server.Request, _prompts(), persistent, uid0=100 * k)
        got = _run(srv, Request, _prompts(), persistent, uid0=100 * k)
        out.append((got, want))
    return out, srv, ref


@pytest.mark.parametrize("arch,driver", [("olmoe-1b-7b", d) for d in DRIVERS]
                         + [("deepseek-v2-lite-16b", d) for d in ("step", "chunked_cache")])
def test_server_matches_reference_server(arch, driver):
    """Equal tokens, finish reasons and ``tokens_digest`` per driver; the
    chunked run twice (the second pass all full hits on both sides).
    deepseek runs the drivers that move its MLA latents differently:
    one-shot splices and chunk-boundary checkpoints."""
    passes = 2 if driver == "chunked_cache" else 1
    runs, srv, ref = _both(arch, driver, passes)
    for got, want in runs:
        assert got == want
        assert tokens_digest({u: t for u, (t, _) in got.items()}) == \
            jax_loadgen.tokens_digest({u: t for u, (t, _) in want.items()})
    if driver == "chunked_cache":
        st, ref_st = srv.stats(), ref.stats()
        assert st["prefix_cache"]["hits"] == ref_st["prefix_cache"]["hits"] >= len(PROMPTS)
        # checkpoints keep the latents trimmed to their prefix
        for node in srv.prefix_cache._entry_nodes:
            for leaf in _flat(node.entry.caches["groups"]).values():
                assert leaf.shape[2] == node.entry.length
        assert srv.prefix_cache.bytes_in_use == ref.prefix_cache.bytes_in_use


def test_async_server_matches_reference_async_server():
    """Every prompt at once through each package's ``AsyncServer`` over a
    chunked olmoe server: the same tokens."""
    jcfg, cfg, p_j, p_pt = _model("olmoe-1b-7b")
    prompts = _prompts()

    async def drive(front, request_cls):
        try:
            done = await asyncio.gather(*(front.generate(request_cls(
                uid=i, prompt=list(p), max_new_tokens=n)) for i, (p, n) in enumerate(prompts)))
        finally:
            if hasattr(front, "close"):       # the port's tick thread
                front.close()
        return {r.uid: (list(r.out_tokens), r.finish_reason) for r in done}

    want = asyncio.run(drive(JaxAsyncServer(jax_server.DecodeServer(
        jcfg, p_j, num_slots=SLOTS, max_seq=MAX_SEQ, prefill_chunk=8)), jax_server.Request))
    got = asyncio.run(drive(AsyncServer(DecodeServer(
        cfg, p_pt, num_slots=SLOTS, max_seq=MAX_SEQ, prefill_chunk=8, device="cpu")), Request))
    assert got == want


@pytest.mark.parametrize("persistent", [False, True])
def test_nan_carry_spreads_and_quarantines_as_in_the_reference(persistent):
    """``decode.nan_carry`` poisons one slot's cache; its NaN reaches every
    live slot of the decode group through the MoE dispatch, so every live
    request retires ``error:nonfinite``, exactly as on the reference."""
    jcfg, cfg, p_j, p_pt = _model("olmoe-1b-7b")
    prompts = [_prompt(5, seed=60 + i) for i in range(4)]
    kw = dict(num_slots=SLOTS, max_seq=MAX_SEQ, persistent=persistent, block_k=4)

    def drain(srv, request_cls):
        for i, p in enumerate(prompts):
            srv.submit(request_cls(uid=i, prompt=list(p), max_new_tokens=6))
        return {r.uid: (list(r.out_tokens), r.finish_reason) for r in srv.run_until_drained()}

    ref_srv = jax_server.DecodeServer(jcfg, p_j, faults=jax_faults.FaultPlan(
        [jax_faults.FaultSpec("decode.nan_carry", after=1)], seed=0), **kw)
    want = drain(ref_srv, jax_server.Request)
    srv = DecodeServer(cfg, p_pt, faults=fl.FaultPlan(
        [fl.FaultSpec("decode.nan_carry", after=1)], seed=0), device="cpu", **kw)
    got = drain(srv, Request)
    assert got == want
    assert sum(r == "error:nonfinite" for _, r in got.values()) == SLOTS
    h, ref_h = srv.health(), ref_srv.health()
    for key in ("status", "slots_quarantined_total", "faults"):
        assert h[key] == ref_h[key], key


# ---------------------------------------------------------------------------
# weight-only int8 serving
# ---------------------------------------------------------------------------

QUANT_ARCHS = ("smollm-135m", "falcon-mamba-7b", "gemma3-27b", "olmoe-1b-7b",
               "deepseek-v2-lite-16b")


@pytest.mark.parametrize("arch", QUANT_ARCHS)
def test_quantize_lm_params_bit_equal_to_reference(arch):
    """Codes, scales, pass-through leaves, the leaf form and the stats equal
    the reference's bit for bit; the router stays fp32; the dequantized
    tree has the original layout.  The logits' SNR and greedy agreement
    against the full-precision model: above the reference's bars (20 dB,
    0.8) on the configs its own test holds to them; on the MoE smoke
    configs, where the reference's own SNR is 9-15 dB (quantization noise
    swaps near-tied experts at d_model 64), equal to the reference's."""
    if arch in ARCHS:
        jcfg, cfg, p_j, p_pt = _model(arch)
    else:   # the port draws; the reference quantizes the same arrays
        jcfg, cfg = jax_configs.get_smoke_config(arch), get_smoke_config(arch)
        p_pt = lm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        p_j = tree_map(lambda t: jnp.asarray(t.numpy()), p_pt)
    qj, st_j = jax_quant.quantize_lm_params(p_j)
    qp, st = quantize_lm_params(p_pt)
    assert st == st_j
    flat_j = {tuple(getattr(k, "key", k) for k in path): v
              for path, v in jax.tree_util.tree_flatten_with_path(qj)[0]}
    flat_pt = _flat(qp)
    assert set(flat_pt) == set(flat_j)
    for k, v in flat_j.items():
        if isinstance(v, str):
            assert flat_pt[k] == v
        else:
            got = flat_pt[k].numpy()
            assert got.dtype == np.asarray(v).dtype and got.shape == v.shape, k
            np.testing.assert_array_equal(got, np.asarray(v), err_msg=str(k))
    if arch in ARCHS:
        assert qp["groups"]["b0_moe"]["moe"]["router"].dtype == torch.float32
        assert "__int8__" in qp["groups"]["b0_moe"]["moe"]["w_in"]
    dq = dequantize_lm_params(qp)
    assert tree_map(lambda t: (tuple(t.shape), t.dtype), dq) == \
        tree_map(lambda t: (tuple(t.shape), t.dtype), p_pt)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 16))
    with torch.no_grad():
        lf, _ = lm.forward(p_pt, cfg, torch.as_tensor(toks))
        lq, _ = lm.forward(dq, cfg, torch.as_tensor(toks))

    def snr_agree(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        snr = float(np.mean(output_snr_db(a.reshape(-1, cfg.vocab), b.reshape(-1, cfg.vocab))))
        return snr, float(np.mean(a.argmax(-1) == b.argmax(-1)))

    snr, agree = snr_agree(lf.numpy(), lq.numpy())
    if arch in ARCHS:
        lf_j, _ = _ref(jax_lm.forward)(p_j, jcfg, jnp.asarray(toks))
        lq_j, _ = _ref(jax_lm.forward)(jax_quant.dequantize_lm_params(qj), jcfg,
                                       jnp.asarray(toks))
        snr_j, agree_j = snr_agree(lf_j, lq_j)
        assert abs(snr - snr_j) < 1e-2 and agree == agree_j, (snr, snr_j, agree, agree_j)
    else:
        assert snr > 20.0 and agree > 0.8, (snr, agree)


def test_quantize_int8_matches_reference_rounding():
    """Half-way codes round to even, the scale floor and the clip, on the
    reference's own ``quantize_int8``, per axis and whole-tensor."""
    from repro.core import quantization as jax_qz
    from repro_torch.core import quantization as qz

    x = np.random.default_rng(0).normal(size=(6, 40, 33)).astype(np.float32)
    x[0] = 0.0                                  # the 1e-8 floor
    x[1, :, 0] = np.arange(40) - 19.5           # halves
    for axis in (-1, -2, 0, None):
        q_j, s_j = jax_qz.quantize_int8(jnp.asarray(x), axis=axis)
        q, s = qz.quantize_int8(torch.as_tensor(x), axis=axis)
        np.testing.assert_array_equal(q.numpy(), np.asarray(q_j))
        np.testing.assert_array_equal(s.numpy(), np.asarray(s_j))
        np.testing.assert_array_equal(qz.dequantize_int8(q, s).numpy(),
                                      np.asarray(jax_qz.dequantize_int8(q_j, s_j)))
