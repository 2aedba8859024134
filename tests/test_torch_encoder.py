"""hubert-xlarge (the audio encoder: a linear frontend from frame
embeddings, non-causal MHA without RoPE, a plain GELU MLP, no decode) at its
smoke widths on the CPU against the reference.

Parameters are drawn by the reference and bridged; frame embeddings and
labels come from numpy with a seed.  Bars: logits at 1e-5; ``train_loss``
and every gradient leaf at ``test_torch_train_loss.py``'s 1e-5; the
non-causal ``flash_attention_ref`` at hd 80 (hubert's head width) against
the reference's Pallas kernel in interpret mode at 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jax_configs  # noqa: E402
from repro.kernels.flash_attention import ops as jax_fa_ops  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.checkpoint.checkpoint import flatten_with_names  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim.adamw import value_and_grad  # noqa: E402
from repro_torch.runtime.server import DecodeServer  # noqa: E402

ARCH = "hubert-xlarge"
TOL = dict(atol=1e-5, rtol=1e-5)
B, S = 2, 16


def _close(pt, ref):
    np.testing.assert_allclose(pt.detach().numpy(), np.asarray(ref), **TOL)


def _bridged(**overrides):
    jcfg = dataclasses.replace(jax_configs.get_smoke_config(ARCH), **overrides)
    cfg = dataclasses.replace(get_smoke_config(ARCH), **overrides)
    p_np = jax.tree.map(np.asarray, jax_lm.init_params(jcfg, jax.random.PRNGKey(0)))
    return jcfg, cfg, jax.tree.map(jnp.asarray, p_np), bridge.params_from_jax(p_np, cfg, "cpu")


@pytest.fixture(scope="module")
def hubert():
    return _bridged()


def _embeds(cfg, seed: int, n: int = S) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((B, n, cfg.frontend_dim)).astype(
        np.float32)


def test_layout_matches_reference(hubert):
    jcfg, cfg, p_j, params = hubert
    assert (cfg.family, cfg.causal, cfg.gated_mlp, cfg.partial_rotary) == \
        ("encoder", False, False, 0.0)
    mine = lm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), mine) == \
        jax.tree.map(lambda a: tuple(a.shape), p_j)
    assert set(mine["embed"]) == {"proj"}
    assert tuple(mine["embed"]["proj"].shape) == (cfg.frontend_dim, cfg.d_model)
    assert lm.param_count(mine) == jax_lm.param_count(p_j)


def test_full_width_param_count():
    """hubert-xlarge at its published widths, counted from shapes: 48 layers
    of MHA (4 · 1280²) and a GELU MLP (2 · 1280 · 5120) with their two norms,
    the 512 → 1280 frontend, the final norm and the 1280 → 504 head."""
    cfg = get_config(ARCH)
    D, F, V = cfg.d_model, cfg.d_ff, cfg.vocab
    per_layer = 4 * D * D + 2 * D * F + 2 * D
    total = cfg.n_layers * per_layer + cfg.frontend_dim * D + D + D * V
    assert (cfg.n_layers, D, cfg.n_heads, cfg.head_dim, F, V) == (48, 1280, 16, 80, 5120, 504)
    assert total == 945_143_040


@pytest.mark.parametrize("use_pallas", [False, True])
def test_forward_and_prefill_match_reference(hubert, use_pallas):
    """Both sides with ``use_pallas``: the reference's flash kernel in
    interpret mode (non-causal), the port's wrapper on its plain version."""
    jcfg, cfg, p_j, params = hubert
    jcfg, cfg = (dataclasses.replace(c, use_pallas=use_pallas) for c in (jcfg, cfg))
    x = _embeds(cfg, 1)
    lg_j, _ = jax_lm.forward(p_j, jcfg, jnp.asarray(x))
    lg, aux = lm.forward(params, cfg, torch.as_tensor(x))
    assert lg.shape == (B, S, cfg.vocab) and float(aux) == 0.0
    _close(lg, lg_j)
    pl_j, pc_j = jax_lm.prefill(p_j, jcfg, jnp.asarray(x))
    pl, pc = lm.prefill(params, cfg, torch.as_tensor(x))
    _close(pl, pl_j)
    assert jax.tree.map(lambda t: tuple(t.shape), pc) == \
        jax.tree.map(lambda a: tuple(a.shape), pc_j)
    jax.tree.map(lambda t, a: _close(t, a), pc, pc_j)


def test_attention_is_not_causal(hubert):
    """Changing the last frame moves the first position's logits."""
    _, cfg, _, params = hubert
    x = torch.as_tensor(_embeds(cfg, 2))
    lg, _ = lm.forward(params, cfg, x)
    x2 = x.clone()
    x2[:, -1] += 1.0
    lg2, _ = lm.forward(params, cfg, x2)
    assert float((lg2[:, 0] - lg[:, 0]).abs().max()) > 1e-4


@pytest.mark.parametrize("S_,H", [(40, 4), (97, 2)])
def test_noncausal_flash_attention_at_hd80_matches_reference_kernel(S_, H):
    """hubert's attention core: H = KV heads of hd 80, no mask."""
    rng = np.random.default_rng(S_)
    q, k, v = (rng.standard_normal((1, S_, H, 80)).astype(np.float32) for _ in range(3))
    want = jax_fa_ops.flash_attention(*(jnp.asarray(a) for a in (q, k, v)), causal=False,
                                      bq=32, bk=32, interpret=True)
    got = fa_ops.flash_attention(*(torch.as_tensor(a) for a in (q, k, v)), causal=False)
    _close(got, want)


def test_prefill_at_hd80_with_the_reference_kernel(hubert):
    """The smoke config at hubert's head width (4 heads of 80): the
    reference's prefill through its Pallas kernel in interpret mode, the
    port's through ``flash_attention``'s plain version."""
    jcfg, cfg, p_j, params = _bridged(head_dim=80, use_pallas=True)
    x = _embeds(cfg, 3, n=24)
    pl_j, _ = jax_lm.prefill(p_j, jcfg, jnp.asarray(x))
    pl, _ = lm.prefill(params, cfg, torch.as_tensor(x))
    _close(pl, pl_j)


def _jax_names(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path): np.asarray(x)
            for path, x in flat}


def test_train_loss_on_embeds_and_grads_match_reference(hubert):
    jcfg, cfg, p_j, params = hubert
    rng = np.random.default_rng(4)
    labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels[-1, -2:] = -1
    batch = {"embeds": _embeds(cfg, 5), "labels": labels}
    f = jax.jit(jax.value_and_grad(lambda p, b: jax_lm.train_loss(p, jcfg, b), has_aux=True))
    (l_j, m_j), g_j = f(p_j, jax.tree.map(jnp.asarray, batch))
    (loss, metrics), grads = value_and_grad(
        lambda p, b: lm.train_loss(p, cfg, b), params,
        {k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(loss.numpy(), np.asarray(l_j), rtol=1e-5)
    for k in m_j:
        np.testing.assert_allclose(metrics[k].numpy(), np.asarray(m_j[k]), rtol=1e-5, atol=1e-7)
    got, want = flatten_with_names(grads), _jax_names(g_j)
    assert set(got) == set(want) and "embed/proj" in want
    for name, w in want.items():
        assert got[name].shape == w.shape, name
        gap = float(np.abs(got[name] - w).max()) / max(float(np.abs(w).max()), 1e-30)
        assert gap <= 1e-5, (name, gap)


def test_decode_server_refuses_an_encoder(hubert):
    _, cfg, _, params = hubert
    with pytest.raises(NotImplementedError, match="an encoder has no decode"):
        DecodeServer(cfg, params, num_slots=2, max_seq=32, device="cpu")
