"""The port's training objective (``repro_torch.models.lm.train_loss``) and
its gradients on the CPU against ``jax.value_and_grad(lm.train_loss,
has_aux=True)`` of the reference, on the same bridged parameters and batch
(labels with some −1), for the smoke configs of the dense, recurrent and
Mamba-1 families; and ``cfg.remat`` (``torch.utils.checkpoint`` per group)
giving the same gradients as no remat.  ``test_torch_train_loss_moe.py``
holds the MoE, MLA and hybrid families.

Bars: the loss and its three parts within 1e-5 relative; every gradient
leaf within 1e-5 of that leaf's max |g| (1e-4 on zamba2, the SSD's bar).
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


def _batch(vocab: int, B: int = 2, S: int = 16, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels[0, :3] = -1
    labels[-1, -2:] = -1
    return {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32), "labels": labels}


def _jax_names(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path): np.asarray(x)
            for path, x in flat}


def check_train_loss(arch: str, tol: float) -> dict:
    """Loss, parts and every gradient leaf of the port against the
    reference; returns the worst gradient gap by leaf."""
    jcfg = jax_configs.get_smoke_config(arch)
    cfg = get_smoke_config(arch)
    p_j = jax_lm.init_params(jcfg, jax.random.PRNGKey(0))
    params = bridge.params_from_jax(jax.tree.map(np.asarray, p_j), cfg, "cpu")
    batch = _batch(cfg.vocab)
    f = jax.jit(jax.value_and_grad(lambda p, b: jax_lm.train_loss(p, jcfg, b), has_aux=True))
    (l_j, m_j), g_j = f(p_j, jax.tree.map(jnp.asarray, batch))
    (loss, metrics), grads = value_and_grad(
        lambda p, b: lm.train_loss(p, cfg, b), params,
        {k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(loss.numpy(), np.asarray(l_j), rtol=tol)
    assert set(metrics) == set(m_j) == {"ce", "z_loss", "router_aux"}
    for k in m_j:
        np.testing.assert_allclose(metrics[k].numpy(), np.asarray(m_j[k]), rtol=tol, atol=1e-7)
    got, want = flatten_with_names(grads), _jax_names(g_j)
    assert set(got) == set(want)
    gaps = {}
    for name, w in want.items():
        assert got[name].shape == w.shape and got[name].dtype == w.dtype, name
        scale = max(float(np.abs(w).max()), 1e-30)
        gaps[name] = float(np.abs(got[name] - w).max()) / scale
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= tol, (arch, worst, gaps[worst])
    return gaps


@pytest.mark.parametrize("arch", ["smollm-135m", "paper-lstm", "falcon-mamba-7b",
                                  "gemma3-27b"])
def test_train_loss_and_grads_match_reference(arch):
    check_train_loss(arch, 1e-5)


def _grads(cfg, params, batch):
    return value_and_grad(lambda p, b: lm.train_loss(p, cfg, b), params, batch)


@pytest.mark.parametrize("arch", ["smollm-135m", "zamba2-1.2b"])
def test_remat_gives_the_same_grads(arch, monkeypatch):
    cfg = get_smoke_config(arch)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in _batch(cfg.vocab, seed=1).items()}
    calls = []
    real = lm.checkpoint
    monkeypatch.setattr(lm, "checkpoint", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    (l_on, m_on), g_on = _grads(dataclasses.replace(cfg, remat=True), params, batch)
    assert len(calls) == cfg.n_groups          # one recomputed region a group
    (l_off, m_off), g_off = _grads(dataclasses.replace(cfg, remat=False), params, batch)
    assert len(calls) == cfg.n_groups
    assert torch.equal(l_on, l_off)
    for k in m_on:
        assert torch.equal(m_on[k], m_off[k])
    for name, g in flatten_with_names(g_on).items():
        np.testing.assert_array_equal(g, flatten_with_names(g_off)[name], err_msg=name)
    # no recompute without gradients: the forward alone does not checkpoint
    with torch.no_grad():
        loss, _ = lm.train_loss(params, cfg, batch)
    assert len(calls) == cfg.n_groups and torch.equal(loss, l_on)


def test_use_pallas_trains_on_the_plain_path_on_the_cpu():
    """On the CPU the kernel wrappers take their plain versions, which
    autograd differentiates: the same loss and grads as use_pallas=False."""
    cfg = get_smoke_config("smollm-135m")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in _batch(cfg.vocab, seed=2).items()}
    (l_k, _), g_k = _grads(dataclasses.replace(cfg, use_pallas=True), params, batch)
    (l_p, _), g_p = _grads(cfg, params, batch)
    assert torch.equal(l_k, l_p)
    for name, g in flatten_with_names(g_k).items():
        np.testing.assert_array_equal(g, flatten_with_names(g_p)[name], err_msg=name)
