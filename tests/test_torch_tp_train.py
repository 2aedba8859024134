"""``Trainer(mesh=)`` computing on its model shard, on gloo CPU ranks,
against the reference's unsharded ``Trainer`` on bridged weights.

internlm2-20b, falcon-mamba-7b, smollm-135m and gemma3-27b (its tail
included) smoke configs, three steps
of eight rows, on the meshes (1, 1, 2) (ranks 0 and 1) and (1, 2, 2) (four
ranks), one spawn of four ranks:

* step 0's loss and grad norm within 1e-5 of the reference's, later
  steps within 1e-4 (the marginal-checks rule of ROADMAP.md, Queue 3);
* every step takes the model-shard path (``train_step.model_shard``), and
  ``comm``'s counters show no gather over the ``model`` group inside it
  (no ``gather_exact``; a ``gather_data`` only where a data axis has two
  ranks);
* each leaf replicated along ``model`` (norm scales, smollm's attention,
  the AdamW moments of those) is bit-identical across the model ranks of
  one data shard after every step;
* checkpoints move across tp = 2 and ``mesh=None`` bit for bit, both ways.

The reference runs in the parent while the ranks (``launch.spawn``) run;
they import no JAX.
"""

import hashlib
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch.spawn import run_ranks  # noqa: E402

ARCHS = ("internlm2-20b", "falcon-mamba-7b", "smollm-135m", "gemma3-27b")
MESHES = {"1x1x2": (1, 2), "1x2x2": (2, 2)}
DATA = dict(vocab=256, branching=3, seq_len=16)
TRAIN = dict(total_steps=3, ckpt_every=100, log_every=1, ckpt_async=False, microbatches=1)
OPTIM = dict(lr_peak=3e-3, warmup_steps=2, total_steps=10)
BATCH = 8
CKPT_ARCH = "internlm2-20b"


def _trainer(arch, p0, ckpt_dir, mesh):
    from repro_torch import bridge, optim
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import DataConfig
    from repro_torch.runtime import Trainer, TrainerConfig

    cfg = get_smoke_config(arch)
    t = Trainer(cfg, TrainerConfig(ckpt_dir=str(ckpt_dir), **TRAIN), optim.AdamWConfig(**OPTIM),
                DataConfig(global_batch=BATCH, **DATA), mesh, device="cpu")
    t.load_full(bridge.params_from_jax(p0, cfg, "cpu"))
    return t


def _replicated_digests(t):
    """``{path: sha}`` of this rank's blocks of every leaf of the state
    that no spec cuts over ``model``."""
    from repro_torch.checkpoint.checkpoint import flatten_with_names

    state = flatten_with_names({"params": t.params, "opt": t.opt_state})
    out, flat_specs = {}, {}

    def walk(tree, prefix):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{prefix}/{k}")
        elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
            for k in tree._fields:
                walk(getattr(tree, k), f"{prefix}/{k}")
        else:
            flat_specs[prefix.lstrip("/")] = tree.entries

    walk(t.layout.specs, "")
    for path, arr in state.items():
        entries = flat_specs[path]
        if not any("model" in (e if isinstance(e, tuple) else (e,)) for e in entries
                   if e is not None):
            out[path] = hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()
    return out


def _ranks(rank, world, p0s, tmp):
    import sys

    import torch.distributed as dist

    from repro_torch.checkpoint.checkpoint import flatten_with_names
    from repro_torch.launch.mesh import make_local_mesh, model_index, local_shard
    from repro_torch.parallel import comm

    tmp = Path(tmp)
    meshes = {name: make_local_mesh(*shape) for name, shape in MESHES.items()}
    out = {"runs": {}, "jax": False}
    for name, mesh in meshes.items():
        if mesh.get_coordinate() is None:
            continue
        for arch in ARCHS:
            t = _trainer(arch, p0s[arch], tmp / f"{arch}_{name}", mesh)
            inner, steps = t._step_fn, []

            def step(params, opt, batch, inner=inner, t=t, steps=steps):
                comm.reset_counts()
                res = inner(params, opt, batch)
                counts = comm.counters()
                t.params, t.opt_state = res[0], res[1]
                steps.append((counts, _replicated_digests(t)))
                return res

            t._step_fn = step
            res = t.run()
            out["runs"][name, arch] = {
                "metrics": [(m["loss"], m["grad_norm"]) for m in res["metrics"]],
                "steps": steps, "model_shard": inner.model_shard,
                "coord": (local_shard(mesh), model_index(mesh))}
            if name == "1x1x2" and arch == CKPT_ARCH:
                out["tp_state"] = flatten_with_names(t.full_state())
    # tp = 2 -> mesh=None: a one-device trainer resumes the (1, 1, 2) run's
    # checkpoint; mesh=None -> tp = 2: the (1, 1, 2) ranks resume a
    # one-device run's
    none_dir = tmp / "none_ck"
    if rank == 0:
        t = _trainer(CKPT_ARCH, p0s[CKPT_ARCH], tmp / f"{CKPT_ARCH}_1x1x2", None)
        assert t.run()["losses"] == []             # resumed at the last step
        out["restored_at_none"] = flatten_with_names(t.full_state())
        t = _trainer(CKPT_ARCH, p0s[CKPT_ARCH], none_dir, None)
        t.run()
        out["none_state"] = flatten_with_names(t.full_state())
    dist.barrier()
    mesh = meshes["1x1x2"]
    if mesh.get_coordinate() is not None:
        t = _trainer(CKPT_ARCH, p0s[CKPT_ARCH], none_dir, mesh)
        assert t.run()["losses"] == []
        out["restored_at_tp"] = flatten_with_names(t.full_state())
    out["jax"] = "jax" in sys.modules
    return out


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The reference Trainer's three steps on each config, from its own
    initial parameters (numpy, for the ranks), computed while the ranks
    run; and the ranks' results."""
    import threading

    import jax

    from repro import optim as jax_optim
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.data import DataConfig as JaxDataConfig
    from repro.runtime import Trainer as JaxTrainer
    from repro.runtime import TrainerConfig as JaxTrainerConfig

    trainers = {arch: JaxTrainer(jax_smoke_config(arch), JaxTrainerConfig(
        ckpt_dir=str(tmp_path_factory.mktemp(arch)), **TRAIN), jax_optim.AdamWConfig(**OPTIM),
        JaxDataConfig(global_batch=BATCH, **DATA)) for arch in ARCHS}
    p0s = {arch: jax.tree.map(np.asarray, jt.params) for arch, jt in trainers.items()}
    got = {}

    def spawn():
        try:
            got["ranks"] = run_ranks(_ranks, 4, (p0s, str(tmp_path_factory.mktemp("tp_train"))),
                                     timeout_s=240)
        except BaseException as e:  # noqa: BLE001 - raised below
            got["ranks"] = e

    thread = threading.Thread(target=spawn)
    thread.start()
    out = {arch: [(m["loss"], m["grad_norm"]) for m in jt.run()["metrics"]]
           for arch, jt in trainers.items()}
    thread.join()
    if isinstance(got["ranks"], BaseException):
        raise got["ranks"]
    return out, got["ranks"]


@pytest.fixture(scope="module")
def reference(both):
    return both[0]


@pytest.fixture(scope="module")
def ranks(both):
    return both[1]


def _members(ranks, name):
    return [r for r in ranks if any(k[0] == name for k in r["runs"])]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_losses_and_grad_norms_match_the_reference(reference, ranks, mesh, arch):
    want = np.array(reference[arch])
    members = _members(ranks, mesh)
    assert len(members) == MESHES[mesh][0] * MESHES[mesh][1]
    for r in members:
        run = r["runs"][mesh, arch]
        assert run["model_shard"]
        got = np.array(run["metrics"])
        assert got.shape == want.shape == (TRAIN["total_steps"], 2)
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
        np.testing.assert_allclose(got[1:], want[1:], rtol=1e-4)
        assert run["metrics"] == members[0]["runs"][mesh, arch]["metrics"]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_no_gather_crosses_the_model_group_in_a_step(ranks, mesh, arch):
    dp = MESHES[mesh][0]
    for r in _members(ranks, mesh):
        for counts, _ in r["runs"][mesh, arch]["steps"]:
            assert "gather_exact" not in counts, counts
            assert ("gather_data" in counts) == (dp > 1), counts
            assert counts["all_reduce"]["count"] > 0


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_replicated_leaves_are_bit_identical_across_model_ranks(ranks, mesh, arch):
    by_shard = {}
    for r in _members(ranks, mesh):
        run = r["runs"][mesh, arch]
        by_shard.setdefault(run["coord"][0], []).append(run["steps"])
    for shard, runs in by_shard.items():
        assert len(runs) == MESHES[mesh][1]
        for step in range(TRAIN["total_steps"]):
            digests = [steps[step][1] for steps in runs]
            assert digests[0] and all(d == digests[0] for d in digests), (shard, step)


def test_checkpoints_move_between_tp2_and_one_device_bit_for_bit(ranks):
    tp_state = ranks[0]["tp_state"]
    for name, got in (("restored_at_none", ranks[0]["restored_at_none"]),):
        assert got.keys() == tp_state.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], tp_state[k], err_msg=(name, k))
    none_state = ranks[0]["none_state"]
    for r in ranks[:2]:
        got = r["restored_at_tp"]
        assert got.keys() == none_state.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], none_state[k], err_msg=k)
    assert not any(r["jax"] for r in ranks)
