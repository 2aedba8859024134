"""The port's AdamW (``repro_torch.optim``) against the reference's: the
warmup-cosine schedule, the global norm (summed in the reference's leaf
order) and clipping, three ``apply`` steps fed the reference's own
gradients through ``bridge`` (fp32 and bf16 params), the optimizer state
crossing over with ``bridge.adamw_state_from_jax``, and gradient
accumulation over two microbatches.

Bar: 1e-6 of each leaf's max |value| for fp32 params and every fp32 state
leaf; bf16 params within one bf16 rounding step (2^-8 relative), since the
fp32 update may round to either neighbour when the two packages' fp32
results differ in the last bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jax_configs  # noqa: E402
from repro import optim as jax_optim  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro_torch import bridge, optim  # noqa: E402
from repro_torch._tree import tree_map  # noqa: E402
from repro_torch.checkpoint.checkpoint import flatten_with_names  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import lm  # noqa: E402

REL = 1e-6
OCFG = optim.AdamWConfig(lr_peak=3e-3, warmup_steps=2, total_steps=10)
JOCFG = jax_optim.AdamWConfig(lr_peak=3e-3, warmup_steps=2, total_steps=10)


def _names(tree):
    """Leaf name → float64 numpy array, for a port or a reference tree."""
    if isinstance(jax.tree.leaves(tree)[0], torch.Tensor):
        return {k: v.astype(np.float64) for k, v in flatten_with_names(tree).items()}
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", getattr(p, "name", p))))
                     for p in path): np.asarray(leaf, np.float64) for path, leaf in flat}


def _close_tree(got, want, rel=REL):
    g, w = _names(got), _names(want)
    assert set(g) == set(w)
    for k in w:
        assert g[k].shape == w[k].shape, k
        scale = max(np.abs(w[k]).max(), 1e-30)
        assert np.abs(g[k] - w[k]).max() <= rel * scale, (k, np.abs(g[k] - w[k]).max(), scale)


@pytest.mark.parametrize("warmup,total", [(100, 10_000), (0, 50), (5, 5)])
def test_lr_schedule_matches_reference(warmup, total):
    cfg = optim.AdamWConfig(warmup_steps=warmup, total_steps=total)
    jcfg = jax_optim.AdamWConfig(warmup_steps=warmup, total_steps=total)
    for step in sorted({0, 1, warmup // 2, warmup - 1, warmup, warmup + 1, total // 2,
                        total - 1, total, total + 7}):
        step = max(step, 0)
        got = optim.lr_schedule(cfg, torch.tensor(step, dtype=torch.int32))
        want = np.asarray(jax_optim.lr_schedule(jcfg, jnp.int32(step)))
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(got.numpy(), want, rtol=REL, atol=0)
    # warm-up rises to the peak, cosine decays to lr_min_ratio of it
    assert float(optim.lr_schedule(cfg, torch.tensor(total + 1))) == pytest.approx(
        cfg.lr_min_ratio * cfg.lr_peak, rel=1e-6)


def test_global_norm_sums_in_the_references_leaf_order_and_clips():
    rng = np.random.default_rng(0)
    # insertion order differs from sorted order; leaves of very different scale
    tree = {"z": rng.normal(size=(64, 33)).astype(np.float32) * 1e3,
            "a": {"y": rng.normal(size=(7,)).astype(np.float32) * 1e-3,
                  "b": rng.normal(size=(5, 5)).astype(np.float32)},
            "m": (rng.normal(size=(3,)).astype(np.float32),)}
    port = jax.tree.map(torch.as_tensor, tree)
    jtree = jax.tree.map(jnp.asarray, tree)
    np.testing.assert_allclose(optim.global_norm(port).numpy(),
                               np.asarray(jax_optim.global_norm(jtree)), rtol=REL)
    for max_norm in (1.0, 1e9):
        clipped, gn = optim.clip_by_global_norm(port, max_norm)
        jclipped, jgn = jax_optim.clip_by_global_norm(jtree, max_norm)
        np.testing.assert_allclose(gn.numpy(), np.asarray(jgn), rtol=REL)
        _close_tree(clipped, jclipped)
    assert float(optim.global_norm(optim.clip_by_global_norm(port, 1.0)[0])) == pytest.approx(
        1.0, rel=1e-5)


@pytest.fixture(scope="module")
def smollm():
    jcfg = jax_configs.get_smoke_config("smollm-135m")
    cfg = get_smoke_config("smollm-135m")
    p_j = jax_lm.init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    batches = [{"tokens": rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32),
                "labels": rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32)}
               for _ in range(3)]
    return jcfg, cfg, p_j, batches


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_three_apply_steps_on_the_references_gradients(smollm, dtype):
    jcfg, cfg, p_j, batches = smollm
    jcfg = dataclasses.replace(jcfg, param_dtype=dtype)
    cfg = dataclasses.replace(cfg, param_dtype=dtype)
    p_j = jax.tree.map(lambda x: x.astype(jnp.dtype(dtype)), p_j)
    grad_fn = jax.jit(jax.grad(lambda p, b: jax_lm.train_loss(p, jcfg, b)[0]))
    s_j = jax_optim.init(p_j)
    params = bridge.params_from_jax(jax.tree.map(np.asarray, p_j), cfg, "cpu")
    state = optim.init(params)
    _close_tree(state, s_j)
    for batch in batches:
        g_j = grad_fn(p_j, jax.tree.map(jnp.asarray, batch))
        grads = bridge.params_from_jax(jax.tree.map(np.asarray, g_j), cfg, "cpu")
        p_j, s_j, om_j = jax_optim.apply(JOCFG, g_j, s_j, p_j)
        params, state, om = optim.apply(OCFG, grads, state, params)
        assert int(state.step) == int(s_j.step) and state.step.dtype == torch.int32
        np.testing.assert_allclose(om["lr"].numpy(), np.asarray(om_j["lr"]), rtol=REL)
        np.testing.assert_allclose(om["grad_norm"].numpy(), np.asarray(om_j["grad_norm"]),
                                   rtol=REL)
        _close_tree(state.m, s_j.m)
        _close_tree(state.v, s_j.v)
        assert {p.dtype for p in jax.tree.leaves(params)} == {getattr(torch, dtype)}
        _close_tree(params, p_j, rel=REL if dtype == "float32" else 2.0 ** -8)
    moved = tree_map(torch.clone, state)        # a NamedTuple maps to its own type
    assert isinstance(moved, optim.AdamWState) and torch.equal(moved.step, state.step)
    # the reference's state crosses over onto the port's, leaf for leaf
    crossed = bridge.adamw_state_from_jax(jax.tree.map(np.asarray, s_j), cfg, "cpu")
    assert isinstance(crossed, optim.AdamWState) and int(crossed.step) == 3
    assert all(t.dtype == torch.float32 for t in jax.tree.leaves((crossed.m, crossed.v)))
    _close_tree(crossed, s_j, rel=0.0)


def test_accumulate_grads_two_microbatches(smollm):
    jcfg, cfg, p_j, batches = smollm
    params = bridge.params_from_jax(jax.tree.map(np.asarray, p_j), cfg, "cpu")
    batch = {k: v.copy() for k, v in batches[0].items()}
    batch["labels"][0, :5] = -1
    j_loss, j_grads, j_metrics = jax_optim.accumulate_grads(
        lambda p, b: jax_lm.train_loss(p, jcfg, b), p_j, jax.tree.map(jnp.asarray, batch), 2)
    loss, grads, metrics = optim.accumulate_grads(
        lambda p, b: lm.train_loss(p, cfg, b), params,
        {k: torch.as_tensor(v) for k, v in batch.items()}, 2)
    np.testing.assert_allclose(loss.numpy(), np.asarray(j_loss), rtol=1e-6)
    for k in ("ce", "z_loss", "router_aux"):
        np.testing.assert_allclose(metrics[k].numpy(), np.asarray(j_metrics[k]),
                                   rtol=1e-6, atol=1e-7)
    _close_tree(grads, j_grads, rel=1e-5)
    assert all(g.dtype == torch.float32 and not g.requires_grad
               for g in jax.tree.leaves(grads))
    assert all(not p.requires_grad for p in jax.tree.leaves(params))
