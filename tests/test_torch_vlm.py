"""llama-3.2-vision-90b (the VLM: four ``attn`` blocks and one gated
``cross`` block a group, the cross block reading a ``memory``) at its smoke
widths, on the CPU against the reference, at 5 layers (one group) and 10
(two: the group loop and the ``[G, ...]`` cache stacking at G > 1).

Parameters are drawn by the reference and bridged; every cross ``gate`` is
set nonzero on the numpy tree first (the reference opens with a closed
gate, under which the cross blocks add nothing).  Tokens and memory come
from numpy with a seed.  Bars: logits at 1e-5; every cache leaf's shape
equal and its values at 1e-5 (the cross block's dummy leaf is ``[G]`` after
a one-shot prefill, ``[G, 1]`` from ``init_cache`` and the chunk chain, as
the reference stores it); ``train_loss`` and every gradient leaf at
``test_torch_train_loss.py``'s 1e-5.
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
from repro_torch.checkpoint.checkpoint import flatten_with_names  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim.adamw import value_and_grad  # noqa: E402
from repro_torch.runtime.server import DecodeServer  # noqa: E402

ARCH = "llama-3.2-vision-90b"
TOL = dict(atol=1e-5, rtol=1e-5)
B, S, CHUNK, NEW = 2, 12, 4, 3


def _shapes(tree):
    return jax.tree.map(lambda a: tuple(a.shape), tree)


def _close(pt, ref):
    np.testing.assert_allclose(pt.detach().numpy(), np.asarray(ref), **TOL)


def _caches_close(c_pt, c_j):
    """The same tree, leaf for leaf in shape, and the same values."""
    assert jax.tree.map(lambda t: tuple(t.shape), c_pt) == _shapes(c_j)
    jax.tree.map(lambda t, a: _close(t, a), c_pt, c_j)


@pytest.fixture(scope="module", params=[5, 10], ids=["5_layers", "10_layers"])
def vlm(request):
    n = request.param
    jcfg = dataclasses.replace(jax_configs.get_smoke_config(ARCH), n_layers=n)
    cfg = dataclasses.replace(get_smoke_config(ARCH), n_layers=n)
    p_np = jax.tree.map(np.asarray, jax_lm.init_params(jcfg, jax.random.PRNGKey(0)))
    G = cfg.n_groups
    cross = p_np["groups"]["b4_cross"]["cross"]
    assert cross["gate"].shape == (G, 1) and not cross["gate"].any()
    cross["gate"] = np.linspace(0.5, -0.7, G, dtype=np.float32)[:, None]
    p_j = jax.tree.map(jnp.asarray, p_np)
    params = bridge.params_from_jax(p_np, cfg, "cpu")
    rng = np.random.default_rng(n)
    toks = rng.integers(0, cfg.vocab, (B, S + NEW)).astype(np.int32)
    mem = rng.standard_normal((B, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    return jcfg, cfg, p_j, params, toks, mem


def test_layout_and_param_count(vlm):
    jcfg, cfg, p_j, params, _, _ = vlm
    assert cfg.layer_pattern == ("attn",) * 4 + ("cross",)
    assert cfg.n_groups == cfg.n_layers // 5
    mine = lm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), mine) == _shapes(p_j)
    assert lm.param_count(mine) == jax_lm.param_count(p_j) == lm.param_count(params)


def test_forward_and_prefill_match_reference(vlm):
    jcfg, cfg, p_j, params, toks, mem = vlm
    x, m = toks[:, :S], mem
    lg_j, aux_j = jax_lm.forward(p_j, jcfg, jnp.asarray(x), memory=jnp.asarray(m))
    lg, aux = lm.forward(params, cfg, torch.as_tensor(x), memory=torch.as_tensor(m))
    _close(lg, lg_j)
    assert float(aux) == float(aux_j) == 0.0
    pl_j, pc_j = jax_lm.prefill(p_j, jcfg, jnp.asarray(x), memory=jnp.asarray(m))
    pl, pc = lm.prefill(params, cfg, torch.as_tensor(x), memory=torch.as_tensor(m))
    _close(pl, pl_j)
    _caches_close(pc, pc_j)
    # the trap: a one-shot prefill stores a scalar per group for the cross block
    assert tuple(pc["groups"]["b4_cross"].shape) == (cfg.n_groups,)
    # the memory is on the path: zero memory moves the logits
    pl0, _ = lm.prefill(params, cfg, torch.as_tensor(x), memory=torch.zeros_like(
        torch.as_tensor(m)))
    assert float((pl0 - pl).abs().max()) > 1e-3 * float(pl.abs().max())


def test_use_pallas_prefill_matches_reference(vlm):
    """``use_pallas`` on both sides: the reference's flash kernel in
    interpret mode, the port's wrapper on its plain version."""
    jcfg, cfg, p_j, params, toks, mem = vlm
    x = toks[:1, :S]
    pl_j, _ = jax_lm.prefill(p_j, dataclasses.replace(jcfg, use_pallas=True), jnp.asarray(x),
                             memory=jnp.asarray(mem[:1]))
    pl, _ = lm.prefill(params, dataclasses.replace(cfg, use_pallas=True), torch.as_tensor(x),
                       memory=torch.as_tensor(mem[:1]))
    _close(pl, pl_j)


def test_chunk_chain_and_decode_match_reference(vlm):
    """``prefill_chunk`` in chunks of 4 from ``init_cache``, then
    ``decode_step`` token by token with the memory; each step's logits and
    caches against the reference's."""
    jcfg, cfg, p_j, params, toks, mem = vlm
    max_seq = S + NEW + 1
    c_j = jax_lm.init_cache(jcfg, B, max_seq)
    c = lm.init_cache(cfg, B, max_seq, "cpu")
    _caches_close(c, c_j)
    assert tuple(c["groups"]["b4_cross"].shape) == (cfg.n_groups, 1)
    m_j, m = jnp.asarray(mem), torch.as_tensor(mem)
    for s in range(0, S, CHUNK):
        x = toks[:, s:s + CHUNK]
        lg_j, c_j = jax_lm.prefill_chunk(p_j, jcfg, jnp.asarray(x), c_j, s, memory=m_j)
        lg, c = lm.prefill_chunk(params, cfg, torch.as_tensor(x), c, s, memory=m)
        _close(lg, lg_j)
        _caches_close(c, c_j)
    assert tuple(c["groups"]["b4_cross"].shape) == (cfg.n_groups, 1)
    # the chain reproduces the one-shot prefill (the reference's chunk bar)
    pl, _ = lm.prefill(params, cfg, torch.as_tensor(toks[:, :S]), memory=m)
    torch.testing.assert_close(lg, pl, atol=1e-4, rtol=1e-4)
    for t in range(S, S + NEW):
        x = toks[:, t:t + 1]
        lg_j, c_j = jax_lm.decode_step(p_j, jcfg, jnp.asarray(x), c_j, jnp.int32(t), memory=m_j)
        lg, c = lm.decode_step(params, cfg, torch.as_tensor(x), c, t, memory=m)
        _close(lg, lg_j)
        _caches_close(c, c_j)


def _jax_names(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path): np.asarray(x)
            for path, x in flat}


def test_train_loss_and_grads_match_reference(vlm):
    jcfg, cfg, p_j, params, toks, mem = vlm
    labels = np.random.default_rng(5).integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels[0, :3] = -1
    batch = {"tokens": toks[:, :S], "labels": labels, "memory": mem}
    f = jax.jit(jax.value_and_grad(lambda p, b: jax_lm.train_loss(p, jcfg, b), has_aux=True))
    (l_j, m_j), g_j = f(p_j, jax.tree.map(jnp.asarray, batch))
    (loss, metrics), grads = value_and_grad(
        lambda p, b: lm.train_loss(p, cfg, b), params,
        {k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(loss.numpy(), np.asarray(l_j), rtol=1e-5)
    for k in m_j:
        np.testing.assert_allclose(metrics[k].numpy(), np.asarray(m_j[k]), rtol=1e-5, atol=1e-7)
    got, want = flatten_with_names(grads), _jax_names(g_j)
    assert set(got) == set(want)
    for name, w in want.items():
        assert got[name].shape == w.shape, name
        gap = float(np.abs(got[name] - w).max()) / max(float(np.abs(w).max()), 1e-30)
        assert gap <= 1e-5, (name, gap)
    # the open gates take a gradient, and so do the memory's projections
    assert float(np.abs(want["groups/b4_cross/cross/gate"]).max()) > 0
    assert float(np.abs(want["groups/b4_cross/cross/wk"]).max()) > 0


def test_decode_server_refuses_a_vlm(vlm):
    _, cfg, _, params, _, _ = vlm
    with pytest.raises(NotImplementedError, match="cross-attention memory"):
        DecodeServer(cfg, params, num_slots=2, max_seq=32, device="cpu")
