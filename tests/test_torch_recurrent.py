"""The port's recurrent cells and block on the CPU against the JAX reference.

Weights are drawn by the reference and cross over as numpy arrays; inputs
are made with numpy from a seed.  Bar: 1e-5 in fp32 (tests/test_recurrent.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.recurrent import block as jax_block  # noqa: E402
from repro.recurrent import cells as jax_cells  # noqa: E402
from repro_torch._tree import tree_map  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.recurrent import block as pt_block  # noqa: E402
from repro_torch.recurrent import cells as pt_cells  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)


def _to_pt(tree):
    return tree_map(lambda a: torch.as_tensor(np.array(a)), jax.tree.map(np.asarray, tree))


def _perturbed(params, seed):
    """Reference params plus noise, so the forget-gate +1 init and zero
    biases do not hide sign or gate-order errors."""
    r = np.random.default_rng(seed)
    return jax.tree.map(lambda x: x + 0.1 * jnp.asarray(r.normal(size=x.shape), x.dtype), params)


def _close(pt, ref):
    np.testing.assert_allclose(pt.detach().numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("B,D,H", [(1, 4, 6), (3, 8, 12)])
def test_lstm_and_gru_steps_match_reference(B, D, H):
    r = np.random.default_rng(B * 10 + D)
    u, h, c = (r.normal(size=s).astype(np.float32) for s in ((B, D), (B, H), (B, H)))
    p_l = _perturbed(jax_cells.lstm_params(jax.random.PRNGKey(1), D, H), 1)
    p_g = _perturbed(jax_cells.gru_params(jax.random.PRNGKey(2), D, H), 2)
    h_pt, c_pt = pt_cells.lstm_step(_to_pt(p_l), (torch.as_tensor(h), torch.as_tensor(c)),
                                    torch.as_tensor(u))
    h_j, c_j = jax_cells.lstm_step(p_l, (jnp.asarray(h), jnp.asarray(c)), jnp.asarray(u))
    _close(h_pt, h_j)
    _close(c_pt, c_j)
    _close(pt_cells.gru_step(_to_pt(p_g), torch.as_tensor(h), torch.as_tensor(u)),
           jax_cells.gru_step(p_g, jnp.asarray(h), jnp.asarray(u)))


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_cell_seq_matches_reference(cell):
    ctor = jax_cells.lstm_params if cell == "lstm" else jax_cells.gru_params
    p = _perturbed(ctor(jax.random.PRNGKey(3), 5, 7), 3)
    x = np.random.default_rng(4).normal(size=(2, 9, 5)).astype(np.float32)
    y_pt, carry_pt = pt_cells.cell_seq(cell, _to_pt(p), torch.as_tensor(x))
    y_j, carry_j = jax_cells.cell_seq(cell, p, jnp.asarray(x))
    _close(y_pt, y_j)
    for a, b in zip(jax.tree.leaves(carry_pt), jax.tree.leaves(carry_j)):
        _close(a, b)


def test_cell_params_shapes_and_forget_bias():
    gen = torch.Generator().manual_seed(0)
    p = pt_cells.lstm_params(gen, 5, 7)
    ref = jax_cells.lstm_params(jax.random.PRNGKey(0), 5, 7)
    assert {k: tuple(v.shape) for k, v in p.items()} == {k: v.shape for k, v in ref.items()}
    np.testing.assert_array_equal(p["b"].numpy(), np.asarray(ref["b"]))  # +1 on [H:2H]
    g = pt_cells.gru_params(gen, 5, 7)
    assert set(g) == set(jax_cells.gru_params(jax.random.PRNGKey(0), 5, 7))
    assert pt_cells.cell_hidden_size(g, "gru") == 7


def _block_case(cell, seed=0):
    jcfg = jax_smoke("paper-lstm")
    cfg = get_smoke_config("paper-lstm")
    if cell == "gru":
        jcfg = dataclasses.replace(jcfg, rnn_cell="gru")
        cfg = dataclasses.replace(cfg, rnn_cell="gru")
    p = _perturbed(jax_block.recurrent_params(jax.random.PRNGKey(seed), jcfg), seed)
    u = np.random.default_rng(seed).normal(size=(2, 8, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, p, _to_pt(p), u


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_block_prefill_resume_decode_match_reference(cell, use_pallas):
    """Block prefill, resumed prefill (chunk) and decode against the JAX
    block, with the port's ``use_pallas`` path (the kernel module's plain
    version on the CPU) and its plain path."""
    jcfg, cfg, p_j, p_pt, u = _block_case(cell)
    cfg = dataclasses.replace(cfg, use_pallas=use_pallas)
    y_j, st_j = jax_block.recurrent_prefill(p_j, jcfg, jnp.asarray(u))
    y_pt, st_pt = pt_block.recurrent_prefill(p_pt, cfg, torch.as_tensor(u))
    _close(y_pt, y_j)
    for k in st_j:
        _close(st_pt[k], st_j[k])

    # resume: prefill [0:3], then [3:6] from the carried state, then decode
    ys = []
    y_a, st = pt_block.recurrent_prefill(p_pt, cfg, torch.as_tensor(u[:, :3]))
    ys.append(y_a)
    y_b, st = pt_block.recurrent_prefill(p_pt, cfg, torch.as_tensor(u[:, 3:6]), state=st)
    ys.append(y_b)
    for t in range(6, 8):
        y_t, st = pt_block.recurrent_decode(p_pt, cfg, torch.as_tensor(u[:, t:t + 1]), st)
        ys.append(y_t)
    _close(torch.cat(ys, 1), y_j)
    for k in st_j:
        _close(st[k], st_j[k])


def test_block_init_state_layout_and_codegen_refused():
    cfg = get_smoke_config("paper-lstm")
    st = pt_block.recurrent_init_state(cfg, 3, "cpu")
    ref = jax_block.recurrent_init_state(jax_smoke("paper-lstm"), 3)
    assert {k: tuple(v.shape) for k, v in st.items()} == {k: v.shape for k, v in ref.items()}
    assert all(v.dtype == torch.float32 for v in st.values())
    gen = torch.Generator().manual_seed(0)
    p = pt_block.recurrent_params(gen, cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pt_block.recurrent_prefill(p, dataclasses.replace(cfg, use_codegen=True),
                                   torch.zeros((1, 2, cfg.d_model)))
