"""The port's ``CheckpointManager`` (``repro_torch.checkpoint``): the
reference's six checkpoint tests (round trip, async save, pruning, a crash
mid-save, a missing leaf, restoring onto a bf16 template), the on-disk
names, and restoring across the two packages both ways: the reference
writes and the port restores the same arrays, and the port writes and the
reference restores them."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import optim as jax_optim  # noqa: E402
from repro.checkpoint import CheckpointManager as JaxCheckpointManager  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402


@pytest.fixture
def tree():
    g = torch.Generator().manual_seed(0)
    return {
        "params": {"w": torch.randn((8, 4), generator=g), "b": torch.zeros(4)},
        "opt": {"m": torch.randn((8, 4), generator=g), "step": torch.tensor(7, dtype=torch.int32)},
    }


def _assert_tree_equal(a, b):
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _assert_tree_equal(a[k], b[k])
    elif isinstance(a, tuple):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_tree_equal(x, y)
    else:
        assert a.dtype == b.dtype and a.device == b.device
        assert torch.equal(a, b)


def test_roundtrip(tmp_path, tree):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(10, tree, {"note": "x"})
    restored, meta = mgr.restore(tree)
    _assert_tree_equal(restored, tree)
    assert meta["step"] == 10 and meta["note"] == "x"
    d = tmp_path / "step_10"
    assert sorted(os.listdir(d)) == ["arrays.npz", "metadata.json"]
    assert sorted(np.load(d / "arrays.npz").files) == ["opt/m", "opt/step", "params/b",
                                                       "params/w"]
    assert json.loads((tmp_path / "MANIFEST.json").read_text()) == {"steps": [10]}


def test_async_save_snapshots_at_the_call(tmp_path, tree):
    mgr = CheckpointManager(str(tmp_path))
    want = {k: {kk: vv.clone() for kk, vv in v.items()} for k, v in tree.items()}
    fut = mgr.save_async(3, tree)
    tree["params"]["w"].add_(1.0)      # a later update must not reach the snapshot
    fut.result(timeout=30)
    mgr.wait()
    restored, meta = mgr.restore(want)
    _assert_tree_equal(restored, want)
    assert meta["step"] == 3


def test_prune_keeps_newest(tmp_path, tree):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, tree)
    assert mgr.latest_step() == 4
    assert sorted(int(d[5:]) for d in os.listdir(tmp_path) if d.startswith("step_")) == [3, 4]


def test_crash_mid_save_preserves_last_valid(tmp_path, tree):
    """A leftover tmp dir (simulated crash) must not corrupt restore."""
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, tree)
    os.makedirs(tmp_path / "tmp.2")
    with open(tmp_path / "tmp.2" / "arrays.npz", "w") as f:
        f.write("garbage")
    assert mgr.latest_step() == 1
    restored, _ = mgr.restore(tree)
    _assert_tree_equal(restored, tree)


def test_restore_missing_leaf_raises(tmp_path, tree):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree)
    bigger = dict(tree)
    bigger["extra"] = torch.zeros(3)
    with pytest.raises(KeyError, match="extra"):
        mgr.restore(bigger)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(tree)


def test_restore_casts_dtype(tmp_path, tree):
    """Restore onto a bf16 template re-casts (mixed-precision resume)."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree)
    template = {k: {kk: vv.to(torch.bfloat16) if vv.dtype == torch.float32 else vv
                    for kk, vv in v.items()} for k, v in tree.items()}
    restored, _ = mgr.restore(template)
    assert restored["params"]["w"].dtype == torch.bfloat16
    assert restored["opt"]["step"].dtype == torch.int32
    assert torch.equal(restored["params"]["w"], tree["params"]["w"].to(torch.bfloat16))
    # a bf16 leaf is stored as its exact fp32 value and comes back as it was
    mgr.save(2, template)
    again, _ = mgr.restore(template, 2)
    _assert_tree_equal(again, template)


def _opt_tree(seed: int):
    rng = np.random.default_rng(seed)
    params = {"embed": {"table": rng.normal(size=(16, 8)).astype(np.float32)},
              "groups": {"b0_attn": {"wq": rng.normal(size=(2, 8, 8)).astype(np.float32)}},
              "layers": [rng.normal(size=(3,)).astype(np.float32),
                         rng.normal(size=(2,)).astype(np.float32)]}
    m = jax.tree.map(lambda x: x * 0.5, params)
    v = jax.tree.map(np.square, params)
    return params, m, v


def test_reference_writes_the_port_restores(tmp_path):
    params, m, v = _opt_tree(1)
    jtree = {"params": jax.tree.map(jnp.asarray, params),
             "opt": jax_optim.AdamWState(jnp.int32(5), jax.tree.map(jnp.asarray, m),
                                         jax.tree.map(jnp.asarray, v))}
    JaxCheckpointManager(str(tmp_path)).save(5, jtree, {"note": "ref"})
    t = lambda tr: jax.tree.map(lambda x: torch.zeros(x.shape), tr)
    template = {"params": t(params),
                "opt": optim.AdamWState(torch.zeros((), dtype=torch.int32), t(m), t(v))}
    restored, meta = CheckpointManager(str(tmp_path)).restore(template)
    assert meta == {"step": 5, "note": "ref"}
    assert isinstance(restored["opt"], optim.AdamWState)
    assert int(restored["opt"].step) == 5 and restored["opt"].step.dtype == torch.int32
    want = {"params": params, "opt": (np.int32(5), m, v)}
    for got, ref in zip(jax.tree.leaves(restored), jax.tree.leaves(want)):
        np.testing.assert_array_equal(got.numpy(), ref)
    assert isinstance(restored["params"]["layers"], list)


def test_port_writes_the_reference_restores(tmp_path):
    params, m, v = _opt_tree(2)
    tt = lambda tr: jax.tree.map(torch.as_tensor, tr)
    tree = {"params": tt(params),
            "opt": optim.AdamWState(torch.tensor(9, dtype=torch.int32), tt(m), tt(v))}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_async(9, tree, {"note": "port"})
    mgr.wait()
    jt = lambda tr: jax.tree.map(lambda x: jnp.zeros(x.shape, jnp.float32), tr)
    template = {"params": jt(params),
                "opt": jax_optim.AdamWState(jnp.zeros((), jnp.int32), jt(m), jt(v))}
    restored, meta = JaxCheckpointManager(str(tmp_path)).restore(template)
    assert meta == {"step": 9, "note": "port"}
    assert int(restored["opt"].step) == 9
    want = {"params": params, "opt": (np.int32(9), m, v)}
    for got, ref in zip(jax.tree.leaves(restored), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(got), ref)


def test_bf16_leaves_cross_both_ways(tmp_path):
    """The reference stores a bf16 leaf as its 2-byte pattern (numpy has no
    bfloat16); the port stores its exact fp32 value.  Each restores the
    other's onto a bf16 template bit for bit."""
    vals = np.random.default_rng(4).normal(size=(5, 3)).astype(np.float32)
    JaxCheckpointManager(str(tmp_path / "ref")).save(1, {"w": jnp.asarray(vals, jnp.bfloat16)})
    got, _ = CheckpointManager(str(tmp_path / "ref")).restore(
        {"w": torch.zeros((5, 3), dtype=torch.bfloat16)})
    want = torch.as_tensor(vals).to(torch.bfloat16)
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"], want)
    CheckpointManager(str(tmp_path / "port")).save(1, {"w": want})
    back, _ = JaxCheckpointManager(str(tmp_path / "port")).restore(
        {"w": jnp.zeros((5, 3), jnp.bfloat16)})
    np.testing.assert_array_equal(np.asarray(back["w"], np.float32), want.float().numpy())
