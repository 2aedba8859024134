"""The port's ``paper-lstm``, ``falcon-mamba-7b``, ``smollm-135m`` and
``phi4-mini-3.8b`` language models on the CPU against the JAX ones.

Parameters are drawn by the reference (``repro.models.lm.init_params``) and
bridged with ``repro_torch.bridge.params_from_jax``.  Bars: prefill and
decode logits at 1e-5 (fp32), chained ``prefill_chunk`` against one-shot
prefill at 1e-4 (the reference's own chunked-prefill bar).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jax_configs  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config  # noqa: E402
from repro_torch.configs.paper_lstm import gru_config  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def bridged():
    jcfg = jax_configs.get_smoke_config("paper-lstm")
    p_j = jax_lm.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_smoke_config("paper-lstm")
    return jcfg, cfg, p_j, bridge.params_from_jax(jax.tree.map(np.asarray, p_j), cfg, "cpu")


def _tokens(B, T, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, T)).astype(np.int32)


def _close(pt, ref, **tol):
    np.testing.assert_allclose(pt.numpy(), np.asarray(ref), **(tol or TOL))


def test_config_matches_reference_for_every_family():
    """layer_pattern, n_groups, kv_cache_bytes and every field agree with the
    reference's ModelConfig for all of its registered architectures."""
    for arch in jax_configs.ARCH_IDS:
        for jcfg in (jax_configs.get_config(arch), jax_configs.get_smoke_config(arch)):
            cfg = ModelConfig(**dataclasses.asdict(jcfg))
            assert cfg.layer_pattern == jcfg.layer_pattern, arch
            assert cfg.n_groups == jcfg.n_groups, arch
            assert cfg.kv_cache_bytes(3, 777) == jcfg.kv_cache_bytes(3, 777), arch
            assert cfg.rnn_hidden_actual == jcfg.rnn_hidden_actual
            assert cfg.act_dtype == getattr(torch, jcfg.dtype)
    assert ARCH_IDS == ("deepseek-v2-lite-16b", "falcon-mamba-7b", "gemma3-27b",
                        "hubert-xlarge", "internlm2-20b", "llama-3.2-vision-90b",
                        "olmoe-1b-7b", "paper-lstm", "phi4-mini-3.8b", "smollm-135m",
                        "zamba2-1.2b")
    assert set(ARCH_IDS) == set(jax_configs.ARCH_IDS)
    for arch in ARCH_IDS:
        assert get_config(arch) == ModelConfig(**dataclasses.asdict(
            jax_configs.get_config(arch)))
        assert get_smoke_config(arch) == ModelConfig(**dataclasses.asdict(
            jax_configs.get_smoke_config(arch)))
    assert gru_config().rnn_cell == "gru" and gru_config().name == "paper-gru"


def test_init_params_layout_matches_reference(bridged):
    jcfg, cfg, p_j, _ = bridged
    p = lm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    shapes_pt = jax.tree.map(lambda t: tuple(t.shape), p)
    shapes_j = jax.tree.map(lambda a: tuple(a.shape), p_j)
    assert shapes_pt == shapes_j
    assert lm.param_count(p) == jax_lm.param_count(p_j)
    b = p["groups"]["b0_recurrent"]["rnn"]["cell"]["b"]
    H = cfg.rnn_hidden_actual
    assert bool((b[:, H:2 * H] == 1).all()) and bool((b[:, :H] == 0).all())
    # the same generator seed draws the same weights
    p2 = lm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    torch.testing.assert_close(p2["embed"]["table"], p["embed"]["table"], atol=0, rtol=0)


def test_full_width_config_param_count():
    """paper-lstm at its published width: 8 layers, d 1024, H 1024, vocab
    32 000, tied embeddings — about 108 M parameters (counted from shapes)."""
    cfg = get_config("paper-lstm")
    D, H = cfg.d_model, cfg.rnn_hidden_actual
    per_layer = D + D * 4 * H + H * 4 * H + 4 * H + H * D
    assert cfg.n_layers * per_layer + cfg.vocab * D + D == 108_307_456


@pytest.mark.parametrize("use_pallas", [False, True])
def test_prefill_and_decode_logits_match_reference(bridged, use_pallas):
    jcfg, cfg, p_j, p_pt = bridged
    cfg = dataclasses.replace(cfg, use_pallas=use_pallas)
    toks = _tokens(2, 7, cfg.vocab, seed=1)
    lg_j, c_j = jax_lm.prefill(p_j, jcfg, jnp.asarray(toks))
    lg_pt, c_pt = lm.prefill(p_pt, cfg, torch.as_tensor(toks))
    _close(lg_pt, lg_j)
    for k in ("h", "c"):
        _close(c_pt["groups"]["b0_recurrent"][k], c_j["groups"]["b0_recurrent"][k])
    nxt = _tokens(2, 1, cfg.vocab, seed=2)
    for t in range(3):
        lg_j, c_j = jax_lm.decode_step(p_j, jcfg, jnp.asarray(nxt), c_j, jnp.int32(7 + t))
        lg_pt, c_pt = lm.decode_step(p_pt, cfg, torch.as_tensor(nxt), c_pt, 7 + t)
        _close(lg_pt, lg_j)
        nxt = np.argmax(np.asarray(lg_j), -1).astype(np.int32)[:, None]
    # full-sequence forward (train mode) returns per-position logits
    logits, _aux = lm.forward(p_pt, cfg, torch.as_tensor(toks))
    logits_j, _ = jax_lm.forward(p_j, jcfg, jnp.asarray(toks))
    _close(logits, logits_j)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_chained_prefill_chunks_match_one_shot(bridged, use_pallas):
    _, cfg, _, p_pt = bridged
    cfg = dataclasses.replace(cfg, use_pallas=use_pallas)
    toks = torch.as_tensor(_tokens(1, 11, cfg.vocab, seed=3))
    lg_one, c_one = lm.prefill(p_pt, cfg, toks)
    caches = lm.init_cache(cfg, 1, 32, "cpu")
    for s in range(0, 11, 4):
        lg, caches = lm.prefill_chunk(p_pt, cfg, toks[:, s:s + 4], caches, s)
    torch.testing.assert_close(lg, lg_one, atol=1e-4, rtol=1e-4)
    for k in ("h", "c"):
        torch.testing.assert_close(caches["groups"]["b0_recurrent"][k],
                                   c_one["groups"]["b0_recurrent"][k], atol=1e-4, rtol=1e-4)


def test_cache_layout_and_bridge(bridged):
    jcfg, cfg, _, _ = bridged
    c_j = jax_lm.init_cache(jcfg, 3, 16)
    c_pt = lm.init_cache(cfg, 3, 16, "cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), c_pt) == jax.tree.map(lambda a: a.shape, c_j)
    c_b = bridge.cache_from_jax(jax.tree.map(np.asarray, c_j), "cpu")
    assert c_b["groups"]["b0_recurrent"]["h"].dtype == torch.float32
    with pytest.raises(ValueError, match="pattern"):
        bridge.params_from_jax({"groups": {"b0_attn": {}}}, cfg, "cpu")


def test_unported_families_raise():
    """No family is left unported: the VLM (llama-vision's cross blocks)
    and the encoder (hubert's frontend) build with the reference's layout
    and caches; MoE and MLA (olmoe, deepseek) build, and an MLA ``attn``
    block caches the latent, as the reference's does."""
    for arch in ("llama-3.2-vision-90b", "hubert-xlarge"):
        jcfg = jax_configs.get_smoke_config(arch)
        cfg = ModelConfig(**dataclasses.asdict(jcfg))
        p = lm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        assert jax.tree.map(lambda t: tuple(t.shape), p) == jax.tree.map(
            lambda a: tuple(a.shape), jax.eval_shape(
                lambda: jax_lm.init_params(jcfg, jax.random.PRNGKey(0))))
        assert jax.tree.map(lambda t: tuple(t.shape), lm.init_cache(cfg, 2, 8, "cpu")) == \
            jax.tree.map(lambda a: tuple(a.shape), jax_lm.init_cache(jcfg, 2, 8))
    for arch in ("olmoe-1b-7b", "deepseek-v2-lite-16b"):
        lm.init_params(get_smoke_config(arch), torch.Generator().manual_seed(0), device="cpu")
    mla = dataclasses.replace(get_smoke_config("smollm-135m"), use_mla=True, kv_lora_rank=16,
                              qk_rope_head_dim=8)
    jmla = dataclasses.replace(jax_configs.get_smoke_config("smollm-135m"), use_mla=True,
                               kv_lora_rank=16, qk_rope_head_dim=8)
    assert jax.tree.map(lambda t: tuple(t.shape), lm.init_cache(mla, 1, 8, "cpu")) == \
        jax.tree.map(lambda a: tuple(a.shape), jax_lm.init_cache(jmla, 1, 8))


# ---------------------------------------------------------------------------
# falcon-mamba-7b (Mamba-1) at smoke widths
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def falcon():
    jcfg = jax_configs.get_smoke_config("falcon-mamba-7b")
    p_j = jax_lm.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_smoke_config("falcon-mamba-7b")
    return jcfg, cfg, p_j, bridge.params_from_jax(jax.tree.map(np.asarray, p_j), cfg, "cpu")


def test_falcon_init_params_layout_matches_reference(falcon):
    _, cfg, p_j, _ = falcon
    p = lm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), p) == \
        jax.tree.map(lambda a: tuple(a.shape), p_j)
    assert lm.param_count(p) == jax_lm.param_count(p_j)
    # stacked leaves filled group by group: groups differ, seeds repeat
    w = p["groups"]["b0_mamba1"]["mamba"]["w_x"]
    assert not torch.equal(w[0], w[1])
    p2 = lm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    torch.testing.assert_close(p2["groups"]["b0_mamba1"]["mamba"]["w_x"], w, atol=0, rtol=0)


def test_falcon_full_width_param_count():
    """falcon-mamba-7b at its published widths: 64 layers of about 105 M
    parameters plus an untied embedding and head of 266 M each, about 7.3 B
    (counted from shapes)."""
    cfg = get_config("falcon-mamba-7b")
    D, DI, N, R, K = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank_actual, cfg.d_conv
    per_layer = (D + 2 * D * DI + K * DI + DI + DI * (R + 2 * N) + R * DI
                 + DI + DI * N + DI + DI * D)
    total = cfg.n_layers * per_layer + 2 * cfg.vocab * D + D
    assert (cfg.n_layers, D, DI, N, R, cfg.vocab) == (64, 4096, 8192, 16, 256, 65_024)
    assert total == 7_272_665_088


@pytest.mark.parametrize("use_pallas", [False, True])
def test_falcon_prefill_and_decode_logits_match_reference(falcon, use_pallas):
    """Both sides with ``use_pallas``: the reference's Pallas kernel (interpret
    mode), the port's wrapper (its plain version on the CPU)."""
    jcfg, cfg, p_j, p_pt = falcon
    jcfg, cfg = (dataclasses.replace(c, use_pallas=use_pallas) for c in (jcfg, cfg))
    toks = _tokens(2, 16, cfg.vocab, seed=4)
    lg_j, c_j = jax_lm.prefill(p_j, jcfg, jnp.asarray(toks))
    lg_pt, c_pt = lm.prefill(p_pt, cfg, torch.as_tensor(toks))
    _close(lg_pt, lg_j)
    for k in ("h", "conv"):
        _close(c_pt["groups"]["b0_mamba1"][k], c_j["groups"]["b0_mamba1"][k])
    nxt = _tokens(2, 1, cfg.vocab, seed=5)
    for t in range(3):
        lg_j, c_j = jax_lm.decode_step(p_j, jcfg, jnp.asarray(nxt), c_j, jnp.int32(16 + t))
        lg_pt, c_pt = lm.decode_step(p_pt, cfg, torch.as_tensor(nxt), c_pt, 16 + t)
        _close(lg_pt, lg_j)
        nxt = np.argmax(np.asarray(lg_j), -1).astype(np.int32)[:, None]


def test_falcon_chained_prefill_chunks_match_reference(falcon):
    """Chained ``prefill_chunk`` (conv tail and h carried across chunks)
    against the reference's chained chunks and the one-shot prefill."""
    jcfg, cfg, p_j, p_pt = falcon
    toks = _tokens(1, 11, cfg.vocab, seed=6)
    caches = lm.init_cache(cfg, 1, 32, "cpu")
    c_j = jax_lm.init_cache(jcfg, 1, 32)
    assert jax.tree.map(lambda t: tuple(t.shape), caches) == \
        jax.tree.map(lambda a: a.shape, c_j)
    for s in range(0, 11, 4):
        lg, caches = lm.prefill_chunk(p_pt, cfg, torch.as_tensor(toks[:, s:s + 4]), caches, s)
        lg_j, c_j = jax_lm.prefill_chunk(p_j, jcfg, jnp.asarray(toks[:, s:s + 4]), c_j,
                                         jnp.int32(s))
        _close(lg, lg_j)
    for k in ("h", "conv"):
        _close(caches["groups"]["b0_mamba1"][k], c_j["groups"]["b0_mamba1"][k])
    lg_one, c_one = lm.prefill(p_pt, cfg, torch.as_tensor(toks))
    torch.testing.assert_close(lg, lg_one, atol=1e-4, rtol=1e-4)
    bridged = bridge.cache_from_jax(jax.tree.map(np.asarray, c_j), "cpu")
    torch.testing.assert_close(bridged["groups"]["b0_mamba1"]["conv"],
                               caches["groups"]["b0_mamba1"]["conv"], **TOL)


# ---------------------------------------------------------------------------
# the dense family: smollm-135m and phi4-mini-3.8b at smoke widths
# ---------------------------------------------------------------------------

def _dense(arch):
    jcfg = jax_configs.get_smoke_config(arch)
    p_j = jax_lm.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_smoke_config(arch)
    return jcfg, cfg, p_j, bridge.params_from_jax(jax.tree.map(np.asarray, p_j), cfg, "cpu")


@pytest.fixture(scope="module")
def smollm():
    return _dense("smollm-135m")


def test_smollm_init_params_and_cache_layout_match_reference(smollm):
    jcfg, cfg, p_j, _ = smollm
    p = lm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), p) == \
        jax.tree.map(lambda a: tuple(a.shape), p_j)
    assert lm.param_count(p) == jax_lm.param_count(p_j)
    assert "head" not in p                      # tied embeddings
    c_pt = lm.init_cache(cfg, 3, 16, "cpu")
    c_j = jax_lm.init_cache(jcfg, 3, 16)
    assert jax.tree.map(lambda t: tuple(t.shape), c_pt) == jax.tree.map(lambda a: a.shape, c_j)
    assert c_pt["groups"]["b0_attn"]["k"].shape == (2, 3, 16, 1, 16)


def test_dense_full_width_param_counts():
    """smollm-135m (30 layers, d 576, GQA 9/3 at hd 64, d_ff 1536, vocab
    49 152, tied): about 135 M parameters; phi4-mini-3.8b (32 layers, d
    3072, GQA 24/8 at hd 128, d_ff 8192, vocab 200 064, tied): about 3.8 B.
    Counted from shapes."""
    counts = {}
    for arch in ("smollm-135m", "phi4-mini-3.8b"):
        cfg = get_config(arch)
        D, F, H, KV, hd = cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        per_layer = 2 * D + D * (H + 2 * KV) * hd + H * hd * D + 3 * D * F
        counts[arch] = cfg.n_layers * per_layer + cfg.vocab * D + D
        assert cfg.layer_pattern == ("attn",) and cfg.n_groups == cfg.n_layers
    assert counts == {"smollm-135m": 134_515_008, "phi4-mini-3.8b": 3_836_021_760}


@pytest.mark.parametrize("use_pallas", [False, True])
def test_smollm_prefill_and_decode_logits_match_reference(smollm, use_pallas):
    """Both sides with ``use_pallas``: the reference's Pallas kernel
    (interpret mode), the port's wrapper (its plain version on the CPU)."""
    jcfg, cfg, p_j, p_pt = smollm
    jcfg, cfg = (dataclasses.replace(c, use_pallas=use_pallas) for c in (jcfg, cfg))
    toks = _tokens(2, 16, cfg.vocab, seed=7)
    lg_j, c_j = jax_lm.prefill(p_j, jcfg, jnp.asarray(toks))
    lg_pt, c_pt = lm.prefill(p_pt, cfg, torch.as_tensor(toks))
    _close(lg_pt, lg_j)
    for k in ("k", "v"):
        _close(c_pt["groups"]["b0_attn"][k], c_j["groups"]["b0_attn"][k])
    # decode against a max_seq cache holding the prompt's KV, at per-row positions
    caches = lm.init_cache(cfg, 2, 24, "cpu")
    c_jd = jax_lm.init_cache(jcfg, 2, 24)
    for k in ("k", "v"):
        caches["groups"]["b0_attn"][k][:, :, :16] = c_pt["groups"]["b0_attn"][k]
        c_jd["groups"]["b0_attn"][k] = c_jd["groups"]["b0_attn"][k].at[:, :, :16].set(
            c_j["groups"]["b0_attn"][k])
    nxt = _tokens(2, 1, cfg.vocab, seed=8)
    pos = np.array([16, 16], np.int32)
    for _ in range(3):
        lg_j, c_jd = jax_lm.decode_step(p_j, jcfg, jnp.asarray(nxt), c_jd, jnp.asarray(pos))
        lg_pt, caches = lm.decode_step(p_pt, cfg, torch.as_tensor(nxt), caches,
                                       torch.as_tensor(pos))
        _close(lg_pt, lg_j)
        nxt = np.argmax(np.asarray(lg_j), -1).astype(np.int32)[:, None]
        pos = pos + 1
    logits, _aux = lm.forward(p_pt, cfg, torch.as_tensor(toks))
    _close(logits, jax_lm.forward(p_j, jcfg, jnp.asarray(toks))[0])


def test_smollm_chained_prefill_chunks_match_reference_and_one_shot(smollm):
    """Chained ``prefill_chunk`` (each chunk scattered into the cache and
    attending causally over it) against the reference's chained chunks, and
    against one-shot prefill at the reference's 1e-4 chunk bar."""
    jcfg, cfg, p_j, p_pt = smollm
    toks = _tokens(1, 11, cfg.vocab, seed=9)
    caches = lm.init_cache(cfg, 1, 32, "cpu")
    c_j = jax_lm.init_cache(jcfg, 1, 32)
    for s in range(0, 11, 4):
        lg, caches = lm.prefill_chunk(p_pt, cfg, torch.as_tensor(toks[:, s:s + 4]), caches, s)
        lg_j, c_j = jax_lm.prefill_chunk(p_j, jcfg, jnp.asarray(toks[:, s:s + 4]), c_j,
                                         jnp.int32(s))
        _close(lg, lg_j)
    for k in ("k", "v"):
        _close(caches["groups"]["b0_attn"][k], c_j["groups"]["b0_attn"][k])
    for use_pallas in (False, True):
        lg_one, c_one = lm.prefill(p_pt, dataclasses.replace(cfg, use_pallas=use_pallas),
                                   torch.as_tensor(toks))
        torch.testing.assert_close(lg, lg_one, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(caches["groups"]["b0_attn"]["k"][:, :, :11],
                                   c_one["groups"]["b0_attn"]["k"], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_phi4_prefill_logits_match_reference(use_pallas):
    """phi4-mini smoke: partial rotary 0.75 and GQA 6/2 through the stack."""
    jcfg, cfg, p_j, p_pt = _dense("phi4-mini-3.8b")
    jcfg, cfg = (dataclasses.replace(c, use_pallas=use_pallas) for c in (jcfg, cfg))
    toks = _tokens(2, 13, cfg.vocab, seed=10)
    lg_j, c_j = jax_lm.prefill(p_j, jcfg, jnp.asarray(toks))
    lg_pt, c_pt = lm.prefill(p_pt, cfg, torch.as_tensor(toks))
    _close(lg_pt, lg_j)
    _close(c_pt["groups"]["b0_attn"]["k"], c_j["groups"]["b0_attn"]["k"])
