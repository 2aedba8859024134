"""The port's attention path on the CPU against the JAX package: the plain
version of ``flash_attention``, RoPE, the gated MLP and the GQA block.

Inputs come from numpy seeds; block parameters are the reference's
(``repro.models.attention.gqa_params``, ``repro.models.layers.mlp_params``)
moved over as arrays.  Bars: ``flash_attention_ref`` against the
reference's Pallas kernel (interpret mode, the reference's own tiling
``bq = bk = 32``) at 1e-5 in fp32 and 2e-2 in bf16 (the reference's own bf16
bar, ``tests/test_kernels.py``); everything else at 1e-5 in fp32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jax_configs  # noqa: E402
from repro.kernels.flash_attention import ops as jax_fa_ops  # noqa: E402
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_fa_ref  # noqa: E402
from repro.models import attention as jax_attn  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro_torch._tree import tree_map  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import NEG_INF, flash_attention_ref  # noqa: E402
from repro_torch.models import attention, layers  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)

# tests/test_kernels.py's five cases (the last is smollm's heads)
KERNEL_CASES = [
    dict(B=2, S=64, H=4, KV=2, hd=32, causal=True, window=0, softcap=0.0),
    dict(B=1, S=128, H=8, KV=8, hd=64, causal=True, window=32, softcap=0.0),
    dict(B=2, S=64, H=4, KV=1, hd=16, causal=False, window=0, softcap=0.0),
    dict(B=1, S=96, H=2, KV=2, hd=80, causal=True, window=0, softcap=20.0),
    dict(B=1, S=64, H=9, KV=3, hd=64, causal=True, window=0, softcap=0.0),
]


def _close(pt, ref, **tol):
    np.testing.assert_allclose(pt.float().numpy(), np.asarray(ref, np.float32), **(tol or TOL))


def _qkv(B, S, T, H, KV, hd, seed=0):
    r = np.random.default_rng(seed)
    return (r.normal(size=(B, S, H, hd)).astype(np.float32),
            r.normal(size=(B, T, KV, hd)).astype(np.float32),
            r.normal(size=(B, T, KV, hd)).astype(np.float32))


def _both(arrs, dtype):
    """The same arrays as JAX and torch tensors of one dtype."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    return ([jnp.asarray(a, jdt) for a in arrs], [torch.as_tensor(a).to(dtype) for a in arrs])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", KERNEL_CASES, ids=lambda c: f"S{c['S']}_H{c['H']}_hd{c['hd']}")
def test_flash_attention_ref_matches_reference_kernel(case, dtype):
    """The plain version against the reference's Pallas kernel in interpret
    mode, which is what the reference's own tests run on the CPU."""
    c = dict(case)
    (qj, kj, vj), (q, k, v) = _both(_qkv(c["B"], c["S"], c["S"], c["H"], c["KV"], c["hd"]), dtype)
    kw = dict(causal=c["causal"], window=c["window"], softcap=c["softcap"])
    want = jax_fa_ops.flash_attention(qj, kj, vj, bq=32, bk=32, interpret=True, **kw)
    got = flash_attention_ref(q, k, v, **kw)
    assert got.dtype == dtype and got.shape == q.shape
    _close(got, np.asarray(want, np.float32), **(TOL if dtype == torch.float32 else BF16_TOL))
    # the wrapper takes the plain version for CPU tensors, and counts no launch
    launches = ops.flash_attention.launches
    torch.testing.assert_close(ops.flash_attention(q, k, v, **kw), got, atol=0, rtol=0)
    assert ops.flash_attention.launches == launches


@pytest.mark.parametrize("S,T,H,KV,hd,causal,window,softcap", [
    (37, 100, 4, 2, 32, True, 0, 0.0),      # S != T: masks aligned top-left
    (100, 37, 4, 2, 32, True, 8, 0.0),      # S > T with a window: rows with no visible key
    (1, 1, 3, 1, 16, True, 0, 0.0),         # S = T = 1
    (1, 50, 6, 2, 16, False, 0, 30.0),      # one query over many keys, softcap
    (53, 53, 8, 4, 128, True, 16, 0.0),     # prime length, hd 128, a window
])
def test_flash_attention_ref_ragged_shapes_match_reference(S, T, H, KV, hd, causal, window,
                                                           softcap):
    (qj, kj, vj), (q, k, v) = _both(_qkv(2, S, T, H, KV, hd, seed=S + T), torch.float32)
    kw = dict(causal=causal, window=window, softcap=softcap)
    _close(flash_attention_ref(q, k, v, **kw), jax_fa_ref(qj, kj, vj, **kw))


def test_flash_attention_ref_masked_rows_are_finite():
    """A row with no visible key averages v uniformly (the finite -2^30),
    as the reference's oracle does, never NaN."""
    q, k, v = (torch.as_tensor(a) for a in _qkv(1, 20, 4, 2, 1, 8, seed=3))
    out = flash_attention_ref(q, k, v, causal=True, window=2)
    assert NEG_INF == -2.0 ** 30 and bool(torch.isfinite(out).all())
    torch.testing.assert_close(out[0, 10, 0], v[0, :, 0].mean(0), atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# the numeric premise of the CUDA kernel: 3xTF32 products hold the fp32 bar
# ---------------------------------------------------------------------------

# tests/test_torch_gpu.py's FLASH_CASES: the shapes the kernel is held to on the card
FLASH_CASES = [
    dict(B=2, S=64, T=64, H=4, KV=2, hd=32, causal=True, window=0, softcap=0.0),
    dict(B=1, S=128, T=128, H=8, KV=8, hd=64, causal=True, window=32, softcap=0.0),
    dict(B=2, S=64, T=64, H=4, KV=1, hd=16, causal=False, window=0, softcap=0.0),
    dict(B=1, S=96, T=96, H=2, KV=2, hd=80, causal=True, window=0, softcap=20.0),
    dict(B=1, S=64, T=64, H=9, KV=3, hd=64, causal=True, window=0, softcap=0.0),
    dict(B=1, S=37, T=100, H=4, KV=2, hd=32, causal=True, window=0, softcap=0.0),
    dict(B=1, S=1, T=1, H=3, KV=1, hd=16, causal=True, window=0, softcap=0.0),
    dict(B=2, S=100, T=37, H=4, KV=2, hd=32, causal=True, window=8, softcap=0.0),
    dict(B=1, S=1300, T=1300, H=4, KV=2, hd=128, causal=True, window=1024, softcap=0.0),
]


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 (10 mantissa bits): to nearest, ties away from
    zero, on the 13 low bits, as ``cvt.rna.tf32.f32`` rounds."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_product(eq: str, a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """``einsum(eq, a, b)`` with TF32 operands summed in fp32.  passes=3 is
    3xTF32 (hi·hi + hi·lo + lo·hi, hi = tf32(x), lo = tf32(x - hi)); passes=1
    is plain TF32 (hi·hi).  A product of two TF32 values is exact in fp32, so
    an fp32 einsum of the rounded operands gives the tensor cores' products;
    their accumulation does not round to nearest, which the kernel confines
    to one key tile (``flash_attention.cu``)."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    out = torch.einsum(eq, a_hi, b_hi)
    if passes == 3:
        a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
        out = torch.einsum(eq, a_lo, b_hi) + torch.einsum(eq, a_hi, b_lo) + out
    return out


def _attention_tf32(q, k, v, *, causal, window, softcap, passes):
    """flash_attention_ref with its two products (q·k and p·v) done as on the
    kernel's tensor cores: the softmax in fp32, p left unnormalised (in
    [0, 1]) into the second product and divided by the row sum after it."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    qg = q.reshape(B, S, KV, H // KV, hd)
    scores = _tf32_product("bskgd,btkd->bkgst", qg, k, passes) * hd ** -0.5
    if softcap > 0:
        scores = softcap * torch.tanh(scores / softcap)
    qpos, kpos = torch.arange(S)[:, None], torch.arange(T)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    out = _tf32_product("bkgst,btkd->bskgd", p, v, passes) / p.sum(-1).permute(0, 3, 1, 2)[..., None]
    return out.reshape(B, S, H, hd)


def test_tf32_rounding_is_round_to_nearest_ties_away():
    one_ulp = 2.0 ** -10                                   # TF32's unit in the last place at 1
    x = torch.tensor([1.0, 1 + one_ulp / 2, -(1 + one_ulp / 2), 1 + one_ulp / 2 - 2 ** -20,
                      1 + 3 * one_ulp / 2, 3.0e-30, -7.25])
    want = torch.tensor([1.0, 1 + one_ulp, -(1 + one_ulp), 1.0, 1 + 2 * one_ulp,
                         float(np.float32(3.0e-30)), -7.25])
    got = _tf32(x)
    assert torch.equal(got[:5], want[:5]) and got[6] == -7.25
    assert abs(float(got[5]) - 3.0e-30) <= 3.0e-30 * 2.0 ** -11
    assert torch.equal(_tf32(got), got)                    # already TF32: unchanged
    assert not bool((got.view(torch.int32) & 0x1FFF).any())


@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=lambda c: f"S{c['S']}_T{c['T']}_H{c['H']}_hd{c['hd']}_w{c['window']}")
def test_3xtf32_attention_holds_the_fp32_bar(case):
    """The CUDA kernel's products, 3xTF32 on the tensor cores, emulated on the
    CPU: within 1e-5 of the plain version on every shape the card's tests
    hold the kernel to, as the fp32 FMA products were."""
    c = dict(case)
    q, k, v = (torch.as_tensor(a) for a in _qkv(c["B"], c["S"], c["T"], c["H"], c["KV"],
                                               c["hd"], seed=c["S"] + c["hd"]))
    kw = dict(causal=c["causal"], window=c["window"], softcap=c["softcap"])
    got = _attention_tf32(q, k, v, passes=3, **kw)
    torch.testing.assert_close(got, flash_attention_ref(q, k, v, **kw), **TOL)


def test_plain_tf32_attention_misses_the_fp32_bar():
    """One TF32 product each (no lo terms) on phi4-mini's long-prompt shape
    (S = T = 2048, hd 128; two heads) is about 1e-3 off: plain TF32 cannot
    hold the 1e-5 bar, which is why the kernel splits every operand."""
    q, k, v = (torch.as_tensor(a) for a in _qkv(1, 2048, 2048, 2, 1, 128, seed=11))
    want = flash_attention_ref(q, k, v)
    err1 = float((_attention_tf32(q, k, v, causal=True, window=0, softcap=0.0, passes=1)
                  - want).abs().max())
    assert err1 > 1e-4, err1


# ---------------------------------------------------------------------------
# RoPE and the gated MLP
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hd,theta,partial", [(64, 1e4, 1.0), (16, 1e4, 1.0), (16, 1e4, 0.75),
                                              (128, 1e4, 0.75), (80, 1e4, 1.0),
                                              (128, 1e6, 1.0)])
def test_rope_freqs_are_bit_equal_to_the_reference(hd, theta, partial):
    want = np.asarray(jax_layers.rope_freqs(hd, theta, partial))
    got = layers.rope_freqs(hd, theta, partial).numpy()
    assert got.dtype == np.float32 and np.array_equal(got, want)


@pytest.mark.parametrize("partial", [1.0, 0.75])
def test_apply_rope_matches_reference_up_to_position_511(partial):
    """Interleaved pairs, partial rotary (the rest passed through), angles in
    fp32 at positions up to 511: an ulp off in a frequency grows with the
    position, so this is where it would show."""
    r = np.random.default_rng(7)
    x = r.normal(size=(2, 512, 3, 128)).astype(np.float32)
    pos = np.stack([np.arange(512), np.arange(512)[::-1]]).astype(np.int32)
    want = jax_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4, partial)
    got = layers.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), 1e4, partial)
    _close(got, want)
    rot = int(128 * partial)
    assert torch.equal(got[..., rot:], torch.as_tensor(x)[..., rot:])


@pytest.mark.parametrize("gated,act", [(True, "silu"), (False, "gelu"), (True, "tanh")])
def test_mlp_apply_matches_reference(gated, act):
    p_j = jax_layers.mlp_params(jax.random.PRNGKey(3), 24, 40, gated, jnp.float32)
    p = tree_map(lambda a: torch.as_tensor(np.array(a)), jax.tree.map(np.asarray, p_j))
    x = np.random.default_rng(4).normal(size=(2, 5, 24)).astype(np.float32)
    _close(layers.mlp_apply(p, torch.as_tensor(x), act),
           jax_layers.mlp_apply(p_j, jnp.asarray(x), act))
    shapes = tree_map(lambda t: tuple(t.shape),
                      layers.mlp_params(torch.Generator().manual_seed(0), 24, 40, gated,
                                        torch.float32))
    assert shapes == jax.tree.map(lambda a: tuple(a.shape), p_j)


# ---------------------------------------------------------------------------
# the GQA block
# ---------------------------------------------------------------------------

def _gqa(arch="smollm-135m", **overrides):
    jcfg = dataclasses.replace(jax_configs.get_smoke_config(arch), **overrides)
    cfg = dataclasses.replace(get_smoke_config(arch), **overrides)
    p_j = jax_attn.gqa_params(jax.random.PRNGKey(0), jcfg)
    p = tree_map(lambda a: torch.as_tensor(np.array(a)), jax.tree.map(np.asarray, p_j))
    return jcfg, cfg, p_j, p


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("arch,overrides", [
    ("smollm-135m", {}),
    ("phi4-mini-3.8b", {}),                        # partial rotary 0.75, GQA 6/2
    ("smollm-135m", {"qk_norm": True, "attn_logit_softcap": 30.0}),
], ids=["smollm", "phi4", "smollm_qknorm_softcap"])
def test_gqa_prefill_matches_reference(arch, overrides, use_pallas):
    """Both sides with the same ``use_pallas``: the reference's Pallas kernel
    in interpret mode against the port's wrapper (its plain version here)."""
    jcfg, cfg, p_j, p = _gqa(arch, use_pallas=use_pallas, **overrides)
    x = np.random.default_rng(1).normal(size=(2, 24, cfg.d_model)).astype(np.float32)
    out_j, (k_j, v_j) = jax_attn.gqa_prefill(p_j, jcfg, jnp.asarray(x))
    out, (k, v) = attention.gqa_prefill(p, cfg, torch.as_tensor(x))
    _close(out, out_j)
    _close(k, k_j)
    _close(v, v_j)
    for window in (0, 5):       # a window as a local layer would pass it
        _close(attention.gqa_prefill(p, cfg, torch.as_tensor(x), window=window)[0],
               jax_attn.gqa_prefill(p_j, jcfg, jnp.asarray(x), window=window)[0])


@pytest.mark.parametrize("S", [1, 5])
@pytest.mark.parametrize("arch", ["smollm-135m", "phi4-mini-3.8b"])
def test_gqa_decode_at_ragged_positions_matches_reference(arch, S):
    """S query tokens per row at per-row positions against a cache holding
    random history: the scatter into the cache and the attention over it."""
    jcfg, cfg, p_j, p = _gqa(arch)
    B, S_max = 3, 24
    r = np.random.default_rng(2 + S)
    shape = (B, S_max, cfg.n_kv_heads, cfg.head_dim)
    cache_np = {"k": r.normal(size=shape).astype(np.float32),
                "v": r.normal(size=shape).astype(np.float32)}
    x = r.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    pos = np.array([0, 7, 17], np.int32)
    out_j, c_j = jax_attn.gqa_decode(p_j, jcfg, jnp.asarray(x),
                                     jax.tree.map(jnp.asarray, cache_np), jnp.asarray(pos))
    cache = tree_map(torch.as_tensor, cache_np)
    out, c = attention.gqa_decode(p, cfg, torch.as_tensor(x), cache, torch.as_tensor(pos))
    _close(out, out_j)
    for name in ("k", "v"):
        _close(c[name], c_j[name])
        assert np.array_equal(cache[name].numpy(), cache_np[name])   # the input is not written
    # a scalar position broadcasts to every row, as the reference's _posv does
    out_s, _ = attention.gqa_decode(p, cfg, torch.as_tensor(x), cache, 4)
    _close(out_s, jax_attn.gqa_decode(p_j, jcfg, jnp.asarray(x),
                                      jax.tree.map(jnp.asarray, cache_np), 4)[0])


def test_causal_mask_matches_reference():
    for kw in (dict(), dict(offset=3), dict(window=4), dict(causal=False, window=2)):
        got = attention.causal_mask(6, 9, **kw).numpy()
        assert np.array_equal(got, np.asarray(jax_attn.causal_mask(6, 9, **kw))), kw


def test_unported_attention_variants_raise():
    """Every attention variant is ported now: cross-attention (item 13)
    draws the reference's shapes (``test_torch_cross_attention.py`` holds
    its numbers), and so do MLA and the LoRA / qk-norm branches."""
    cfg = get_smoke_config("smollm-135m")
    gen = torch.Generator().manual_seed(0)
    vcfg = get_smoke_config("llama-3.2-vision-90b")
    want = jax.tree.map(lambda a: tuple(a.shape), jax_attn.cross_attn_params(
        jax.random.PRNGKey(0), jax_configs.get_smoke_config("llama-3.2-vision-90b")))
    assert tree_map(lambda t: tuple(t.shape), attention.cross_attn_params(gen, vcfg)) == want
    # MLA is ported (item 10): its parameters have the reference's shapes
    dcfg = get_smoke_config("deepseek-v2-lite-16b")
    want = jax.tree.map(lambda a: tuple(a.shape), jax_attn.mla_params(
        jax.random.PRNGKey(0), jax_configs.get_smoke_config("deepseek-v2-lite-16b")))
    assert tree_map(lambda t: tuple(t.shape), attention.mla_params(gen, dcfg)) == want
    # the LoRA and qk-norm branches draw the reference's shapes
    jcfg = dataclasses.replace(jax_configs.get_smoke_config("smollm-135m"), qk_norm=True)
    want = jax.tree.map(lambda a: tuple(a.shape),
                        jax_attn.gqa_params(jax.random.PRNGKey(0), jcfg, lora_rank=4))
    got = tree_map(lambda t: tuple(t.shape),
                   attention.gqa_params(gen, dataclasses.replace(cfg, qk_norm=True),
                                        lora_rank=4))
    assert got == want
