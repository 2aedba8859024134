"""The port's cross-attention (``repro_torch.models.attention.cross_attn``)
and the last helpers of ``models/layers.py`` (``layernorm``, ``unembed``,
``apply_rope`` at ``partial_rotary=0``) on the CPU against the reference's.

Inputs are drawn by numpy from a seed; parameters are drawn by the
reference and carried across as arrays.  The cross ``gate`` is set nonzero
on the numpy tree before either side sees it (the reference opens with a
closed gate, which would make every check pass on zeros).  Bar: 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jax_configs  # noqa: E402
from repro.models import attention as jax_attn  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro_torch._tree import tree_map  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import attention, layers  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
ARCH = "llama-3.2-vision-90b"


def _close(pt, ref):
    np.testing.assert_allclose(pt.detach().numpy(), np.asarray(ref), **TOL)


def _cross_case(seed: int, S: int, M: int, gate: float, **overrides):
    jcfg = dataclasses.replace(jax_configs.get_smoke_config(ARCH), **overrides)
    cfg = dataclasses.replace(get_smoke_config(ARCH), **overrides)
    p_np = jax.tree.map(np.asarray, jax_attn.cross_attn_params(jax.random.PRNGKey(seed), jcfg))
    p_np = dict(p_np, gate=np.full((1,), gate, np.float32))
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((2, M, cfg.frontend_dim)).astype(np.float32)
    want = jax_attn.cross_attn(jax.tree.map(jnp.asarray, p_np), jcfg, jnp.asarray(x),
                               jnp.asarray(mem))
    got = attention.cross_attn(tree_map(torch.as_tensor, p_np), cfg, torch.as_tensor(x),
                               torch.as_tensor(mem))
    return got, want


@pytest.mark.parametrize("S,M,heads", [(8, 17, (4, 2)), (1, 17, (4, 2)), (13, 5, (4, 1)),
                                       (6, 9, (4, 4))],
                         ids=["gqa_S8_M17", "decode_S1", "mqa_S13_M5", "mha_S6_M9"])
def test_cross_attn_matches_reference(S, M, heads):
    """GQA (2 query heads a KV head), MQA and MHA, S != M, one query row
    (the decode shape), with an open gate."""
    got, want = _cross_case(S + M, S, M, 0.5, n_heads=heads[0], n_kv_heads=heads[1])
    assert got.shape == (2, S, get_smoke_config(ARCH).d_model)
    assert float(got.abs().max()) > 1e-2          # the open gate lets the product through
    _close(got, want)


def test_cross_attention_gate_starts_closed():
    """tanh(0) = 0: a fresh cross block adds nothing (the reference's
    test_cross_attention_gate_starts_closed), on the port's own parameters
    and on the reference's carried across."""
    cfg = get_smoke_config(ARCH)
    p = attention.cross_attn_params(torch.Generator().manual_seed(0), cfg)
    assert torch.equal(p["gate"], torch.zeros(1))
    x = torch.randn(2, 8, cfg.d_model)
    mem = torch.randn(2, cfg.frontend_tokens, cfg.frontend_dim)
    assert float(attention.cross_attn(p, cfg, x, mem).abs().max()) == 0.0
    got, want = _cross_case(3, 8, cfg.frontend_tokens, 0.0)
    assert float(got.abs().max()) == 0.0
    _close(got, want)


def test_cross_attn_params_have_the_reference_shapes():
    cfg, jcfg = get_smoke_config(ARCH), jax_configs.get_smoke_config(ARCH)
    got = tree_map(lambda t: (tuple(t.shape), str(t.dtype)),
                   attention.cross_attn_params(torch.Generator().manual_seed(0), cfg))
    want = jax.tree.map(lambda a: (tuple(a.shape), "torch." + str(a.dtype)),
                        jax_attn.cross_attn_params(jax.random.PRNGKey(0), jcfg))
    assert got == want
    assert got["wk"][0] == (cfg.frontend_dim, cfg.n_kv_heads * cfg.head_dim)
    assert got["gate"][0] == (1,)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_reference(dtype):
    rng = np.random.default_rng(7)
    x = (3.0 + 2.0 * rng.standard_normal((2, 5, 48))).astype(np.float32)
    p_np = {"scale": rng.standard_normal(48).astype(np.float32),
            "bias": rng.standard_normal(48).astype(np.float32)}
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = jax_layers.layernorm(jax.tree.map(lambda a: jnp.asarray(a, jdt), p_np),
                                jnp.asarray(x, jdt), 1e-5)
    got = layers.layernorm(tree_map(lambda a: torch.as_tensor(a).to(tdt), p_np),
                           torch.as_tensor(x).to(tdt), 1e-5)
    assert got.dtype == tdt
    if dtype == "float32":
        _close(got, want)
    else:   # the same fp32 arithmetic, one bf16 rounding at the end
        assert np.array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    # the fresh parameters are the identity affine map
    fresh = layers.layernorm_params(48, torch.float32, "cpu")
    want_fresh = jax.tree.map(np.asarray, jax_layers.layernorm_params(48, jnp.float32))
    for k in ("scale", "bias"):
        assert np.array_equal(fresh[k].numpy(), want_fresh[k])


def test_unembed_matches_reference():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 3, 16)).astype(np.float32)
    w = rng.standard_normal((16, 40)).astype(np.float32)
    table = rng.standard_normal((40, 16)).astype(np.float32)
    _close(layers.unembed({"w": torch.as_tensor(w)}, torch.as_tensor(x)),
           jax_layers.unembed({"w": jnp.asarray(w)}, jnp.asarray(x)))
    _close(layers.unembed({}, torch.as_tensor(x), torch.as_tensor(table)),
           jax_layers.unembed({}, jnp.asarray(x), jnp.asarray(table)))


def test_apply_rope_at_partial_zero_is_a_pass_through():
    """hubert's ``partial_rotary=0.0``: no channel rotates, on both sides."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 6, 4, 80)).astype(np.float32)
    pos = np.arange(6)[None, :].repeat(2, 0)
    got = layers.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), 10_000.0, 0.0)
    want = jax_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0, 0.0)
    assert np.array_equal(got.numpy(), x)
    assert np.array_equal(np.asarray(want), x)
