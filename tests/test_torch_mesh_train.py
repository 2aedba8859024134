"""``Trainer(mesh=)`` on gloo ranks on the CPU against the reference's
single-device ``Trainer``.

The reference's sharded train step is its single-device step laid out by
XLA's partitioner, so the port's ``Trainer(mesh=)`` is held to the
reference ``Trainer`` on the same bridged initial parameters and the same
global batches (``tests/test_torch_trainer.py``'s five-step case,
microbatches 2): per-step losses, ``lr`` and ``grad_norm`` within 1e-5
relative, at dp = 2, dp = 4 and (data, model) = (2, 2), on the smollm smoke
config (vocab 64) and the paper's own family (``paper-lstm`` smoke).  The
mesh at dp = 1 gives parameters bit-identical to the port's ``mesh=None``.

Elastic restore: ``run_elastic.py``'s case (``w`` on ``("data",
"model")``, ``b`` on ``"model"``) saved on (1, 2, 2) and restored on (1, 4,
1), bit for bit; the same checkpoint in the reference's
``CheckpointManager``, bit for bit; a trainer's checkpoint from (1, 2, 2)
resumed on dp = 4.  The activation pins: unchanged outside their context, a
wrong batch share refused inside it.  The launcher under torchrun on two
CPU ranks.

The reference runs here, in the parent; its parameters cross to the ranks
as numpy arrays, and the ranks (one spawn of four, ``launch.spawn``)
import no JAX.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch.spawn import run_ranks  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
RTOL = 1e-5
MESHES = {"dp2": (2, 1), "dp4": (4, 1), "dp2_tp2": (2, 2)}
# the data of each config (paper-lstm's cell loop runs a step per token: 16)
CASES = {"smollm-135m": dict(vocab=64, branching=3, seq_len=32),
         "paper-lstm": dict(vocab=256, branching=3, seq_len=16)}
TRAIN = dict(total_steps=5, ckpt_every=100, log_every=1, ckpt_async=False, microbatches=2)
OPTIM = dict(lr_peak=3e-3, warmup_steps=2, total_steps=10)
BATCH = 8
ELASTIC_SPECS = {"w": ("data", "model"), "b": ("model",)}


def _cfg(arch):
    from repro_torch.configs import get_smoke_config

    return dataclasses.replace(get_smoke_config(arch), vocab=CASES[arch]["vocab"])


def _trainer(arch, p0, ckpt_dir, mesh, **tkw):
    from repro_torch import bridge, optim
    from repro_torch.data import DataConfig
    from repro_torch.runtime import Trainer, TrainerConfig

    cfg = _cfg(arch)
    t = Trainer(cfg, TrainerConfig(ckpt_dir=str(ckpt_dir), **{**TRAIN, **tkw}),
                optim.AdamWConfig(**OPTIM),
                DataConfig(global_batch=BATCH, **CASES[arch]), mesh, device="cpu")
    t.load_full(bridge.params_from_jax(p0, cfg, "cpu"))
    return t


def _numpy(tree):
    from repro_torch.checkpoint.checkpoint import flatten_with_names

    return flatten_with_names(tree)


def _ranks_train(rank, world, p0s, tmp):
    """One rank: every (config, mesh) run's logged metrics, the dp = 1
    parameters beside ``mesh=None``'s, the elastic cases and the pins."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.parallel import zero
    from repro_torch.parallel.sharding import activation_constraints, constrain_activation

    tmp = Path(tmp)
    # every rank builds every mesh (DeviceMesh makes its groups collectively)
    meshes = {name: make_local_mesh(*shape) for name, shape in MESHES.items()}
    dp1 = make_local_mesh(1, 1)
    out = {"runs": {}, "jax": False}
    for arch, p0 in p0s.items():
        for name, mesh in meshes.items():
            if mesh.get_coordinate() is None:
                continue
            t = _trainer(arch, p0, tmp / f"{arch}_{name}", mesh)
            res = t.run()
            out["runs"][arch, name] = [(m["loss"], m["lr"], m["grad_norm"])
                                       for m in res["metrics"]]
            if name == "dp2_tp2":
                # the (1, 2, 2) checkpoint of step 5, resumed on dp = 4
                saved = _numpy(t.full_state())
                t4 = _trainer(arch, p0, tmp / f"{arch}_{name}", meshes["dp4"])
                again = t4.run()
                restored = _numpy(t4.full_state())
                out["runs"][arch, "resumed_dp4"] = (
                    len(again["losses"]), all(np.array_equal(saved[k], restored[k])
                                              for k in saved) and saved.keys() == restored.keys())
        if rank < 2:    # the (1, 1, 1) mesh on rank 0, mesh=None on rank 1
            t = _trainer(arch, p0, tmp / f"{arch}_dp1_{rank}", None if rank else dp1)
            t.run()
            out["dp1", arch] = _numpy(t.full_state())

    # run_elastic.py's case: saved on (1, 2, 2), restored on (1, 4, 1)
    full = {"w": torch.randn(16, 8, generator=torch.Generator().manual_seed(0)),
            "b": torch.arange(8.0)}
    lay_a = zero.ShardLayout(meshes["dp2_tp2"], ELASTIC_SPECS)
    mgr = CheckpointManager(str(tmp / "elastic"))
    mgr.save(1, lay_a.shard(full), layout=lay_a)
    lay_a.barrier()
    lay_b = zero.ShardLayout(meshes["dp4"], ELASTIC_SPECS)
    template = lay_b.shard({k: torch.zeros_like(v) for k, v in full.items()})
    restored, meta = CheckpointManager(str(tmp / "elastic")).restore(template, layout=lay_b)
    out["elastic"] = ({k: v.numpy() for k, v in full.items()},
                      {k: v.numpy() for k, v in restored.items()},
                      {k: v.numpy() for k, v in lay_b.gather(restored).items()},
                      meta["step"], lay_b.sizes["data"])

    # the activation pins: the (data 2) mesh's share of 8 rows is 4
    pins = {}
    with activation_constraints(meshes["dp2_tp2"], global_batch=8):
        pins["share"] = tuple(constrain_activation(torch.zeros(4, 3, 2)).shape)
        try:
            constrain_activation(torch.zeros(8, 3, 2))
        except ValueError as e:
            pins["wrong"] = str(e)
    out["pins"] = pins
    out["jax"] = "jax" in sys.modules
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference Trainer's five steps on each config, from its own
    initial parameters (numpy, for the ranks)."""
    import jax

    from repro import optim as jax_optim
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.data import DataConfig as JaxDataConfig
    from repro.runtime import Trainer as JaxTrainer
    from repro.runtime import TrainerConfig as JaxTrainerConfig

    out = {}
    for arch, dkw in CASES.items():
        jcfg = dataclasses.replace(jax_smoke_config(arch), vocab=dkw["vocab"])
        jt = JaxTrainer(jcfg, JaxTrainerConfig(ckpt_dir=str(tmp_path_factory.mktemp(arch)),
                                               **TRAIN),
                        jax_optim.AdamWConfig(**OPTIM),
                        JaxDataConfig(global_batch=BATCH, **dkw))
        p0 = jax.tree.map(np.asarray, jt.params)
        res = jt.run()
        out[arch] = (p0, [(m["loss"], m["lr"], m["grad_norm"]) for m in res["metrics"]])
    return out


@pytest.fixture(scope="module")
def ranks(reference, tmp_path_factory):
    """The four ranks' results, their directory, and the launcher's run
    under torchrun (started first: it runs beside the ranks)."""
    tmp = tmp_path_factory.mktemp("mesh_train")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    launcher = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node=2",
         "--standalone", "-m", "repro_torch.launch.train", "--smoke", "--device", "cpu",
         "--steps", "3", "--seq", "16", "--batch", "4", "--ckpt-dir", str(tmp / "launch_ck"),
         "--metrics-out", str(tmp / "launch_m.jsonl")],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        p0s = {arch: p0 for arch, (p0, _) in reference.items()}
        results = run_ranks(_ranks_train, WORLD, (p0s, str(tmp)), timeout_s=240)
        out, err = launcher.communicate(timeout=180)
    finally:
        if launcher.poll() is None:
            launcher.kill()
            launcher.communicate()
    return results, tmp, (launcher.returncode, out, err)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list(CASES))
def test_mesh_trainer_matches_the_reference_trainer(reference, ranks, arch, mesh):
    results = ranks[0]
    want = np.array(reference[arch][1])
    members = [out["runs"][arch, mesh] for out in results if (arch, mesh) in out["runs"]]
    assert len(members) == MESHES[mesh][0] * MESHES[mesh][1]
    for got in members:
        assert np.array(got).shape == want.shape == (TRAIN["total_steps"], 3)
        np.testing.assert_allclose(np.array(got), want, rtol=RTOL)  # loss, lr, grad_norm
        assert got == members[0]                                   # every rank logs alike


@pytest.mark.parametrize("arch", list(CASES))
def test_dp1_mesh_is_bit_identical_to_mesh_none(ranks, arch):
    got, want = ranks[0][0]["dp1", arch], ranks[0][1]["dp1", arch]
    assert sorted(got) == sorted(want) and len(want) > 3
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("arch", list(CASES))
def test_a_checkpoint_of_one_mesh_resumes_on_another(ranks, arch):
    for out in ranks[0]:
        steps, identical = out["runs"][arch, "resumed_dp4"]
        assert steps == 0 and identical        # resumed at the last step, state bit for bit


def test_elastic_restore_across_meshes_is_bit_identical(ranks):
    for rank, out in enumerate(ranks[0]):
        full, local, gathered, step, data = out["elastic"]
        assert step == 1 and data == 4
        # (1, 4, 1): w's rows over data (4 × 4 rows), b whole on every rank
        np.testing.assert_array_equal(local["w"], full["w"][4 * rank:4 * rank + 4])
        np.testing.assert_array_equal(local["b"], full["b"])
        for k in full:
            np.testing.assert_array_equal(gathered[k], full[k])


def test_a_mesh_checkpoint_restores_in_the_reference_manager(ranks):
    import jax.numpy as jnp

    from repro.checkpoint import CheckpointManager as JaxCheckpointManager

    results, tmp, _ = ranks
    full = results[0]["elastic"][0]
    template = {k: jnp.zeros(v.shape, jnp.float32) for k, v in full.items()}
    restored, meta = JaxCheckpointManager(str(tmp / "elastic")).restore(template)
    assert meta["step"] == 1
    for k in full:
        np.testing.assert_array_equal(np.asarray(restored[k]), full[k])


def test_activation_pin_is_the_identity_outside_its_context():
    from repro_torch.parallel.sharding import activation_spec, constrain_activation

    x = torch.randn(3, 5, 7)
    assert constrain_activation(x) is x
    assert activation_spec(None, ("pod", "data"), None) == (("pod", "data"), None)


def test_activation_pin_refuses_a_wrong_batch_share(ranks):
    for out in ranks[0]:
        assert out["pins"]["share"] == (4, 3, 2)
        assert "this rank's share" in out["pins"]["wrong"] and "is 4" in out["pins"]["wrong"]
        assert not out["jax"]


def test_train_launcher_under_torchrun_on_two_cpu_ranks(ranks):
    _, tmp, (rc, out, err) = ranks
    assert rc == 0, err[-3000:]
    lines = (out + err).splitlines()
    assert sum("final_loss=" in ln for ln in lines) == 1, lines[-10:]   # rank 0 logs
    assert len((tmp / "launch_m.jsonl").read_text().splitlines()) == 2  # steps 0 and 2
    assert sorted(os.listdir(tmp / "launch_ck")) == ["MANIFEST.json", "step_3"]
