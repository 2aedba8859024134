"""The port's ``Trainer`` (``repro_torch.runtime``) on the CPU: the loss
falls toward the data's entropy floor within the reference's thresholds
(``tests/test_trainer_server.py``), a failure at step 25 and a resume give
the uninterrupted run's parameters, the straggler monitor flags a slow
host, five steps from the reference's initial parameters give the
reference ``Trainer``'s losses, MoE on a data axis is refused, and
``python -m repro_torch.launch.train`` runs."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import optim as jax_optim  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.data import DataConfig as JaxDataConfig  # noqa: E402
from repro.runtime import Trainer as JaxTrainer  # noqa: E402
from repro.runtime import TrainerConfig as JaxTrainerConfig  # noqa: E402
from repro_torch import bridge, optim  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data import DataConfig  # noqa: E402
from repro_torch.runtime import (  # noqa: E402
    SimulatedFailure,
    StragglerMonitor,
    Trainer,
    TrainerConfig,
)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """A smoke step is ~100 small ops: on one thread it takes ~20 ms, on
    eight threads that share their cores with other test workers ~0.5 s."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(ckpt_dir):
    cfg = dataclasses.replace(get_smoke_config("smollm-135m"), vocab=64)
    tcfg = TrainerConfig(total_steps=40, ckpt_every=10, ckpt_dir=str(ckpt_dir),
                         log_every=10, ckpt_async=False)
    ocfg = optim.AdamWConfig(lr_peak=3e-3, warmup_steps=5, total_steps=40)
    dcfg = DataConfig(vocab=64, seq_len=32, global_batch=8, branching=3)
    return cfg, tcfg, ocfg, dcfg


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    cfg, tcfg, ocfg, dcfg = _setup(tmp_path_factory.mktemp("ref"))
    trainer = Trainer(cfg, tcfg, ocfg, dcfg, device="cpu")
    return trainer, trainer.run()


def test_loss_decreases_toward_floor(uninterrupted):
    _, res = uninterrupted
    assert res["losses"][0] > res["final_loss"]
    # 40 steps: must clearly beat the ln(64)=4.16 random floor on its way down
    assert res["final_loss"] < 0.85 * res["losses"][0]
    assert res["final_loss"] < 3.6
    assert res["final_loss"] > res["entropy_floor"] * 0.9  # can't beat the floor
    assert [m["step"] for m in res["metrics"]] == [0, 10, 20, 30, 39]
    assert all(np.isfinite([m["lr"], m["grad_norm"], m["sec"]]).all() for m in res["metrics"])


def test_failure_restart_is_deterministic(uninterrupted, tmp_path):
    """Uninterrupted run == (fail at 25 → restart → finish)."""
    ref, _ = uninterrupted
    cfg, tcfg, ocfg, dcfg = _setup(tmp_path)
    t1 = Trainer(cfg, dataclasses.replace(tcfg, fail_at_step=25, ckpt_async=True), ocfg, dcfg,
                 device="cpu")
    with pytest.raises(SimulatedFailure):
        t1.run()
    t1.ckpt.wait()
    assert t1.ckpt.latest_step() == 20
    t2 = Trainer(cfg, tcfg, ocfg, dcfg, device="cpu")
    res = t2.run()
    assert len(res["losses"]) == 20                 # steps 20..39 after the resume
    assert int(t2.opt_state.step) == 40
    for want, got in ((ref.params, t2.params), (ref.opt_state, t2.opt_state)):
        for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got), strict=True):
            np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), atol=1e-6)


def test_straggler_monitor_flags_slow_host():
    mon = StragglerMonitor(factor=3.0, patience=2)
    flagged = []
    for step in range(10):
        for host in range(4):
            t = 1.0 if host != 2 or step < 5 else 10.0
            if mon.observe(host, t, step):
                flagged.append((step, host))
    assert flagged and flagged[0][1] == 2
    assert mon.events[0]["host"] == 2


def test_five_steps_match_the_reference_trainer(tmp_path):
    """The reference's initial parameters, bridged, and a fresh optimizer
    state: step-by-step losses within 1e-5 relative."""
    jcfg = dataclasses.replace(jax_smoke_config("smollm-135m"), vocab=64)
    kw = dict(total_steps=5, ckpt_every=100, log_every=1, ckpt_async=False)
    okw = dict(lr_peak=3e-3, warmup_steps=2, total_steps=10)
    dkw = dict(vocab=64, seq_len=32, global_batch=8, branching=3)
    jt = JaxTrainer(jcfg, JaxTrainerConfig(ckpt_dir=str(tmp_path / "ref"), microbatches=2, **kw),
                    jax_optim.AdamWConfig(**okw), JaxDataConfig(**dkw))
    p0 = jax.tree.map(np.asarray, jt.params)
    want = jt.run()
    cfg = dataclasses.replace(get_smoke_config("smollm-135m"), vocab=64)
    pt = Trainer(cfg, TrainerConfig(ckpt_dir=str(tmp_path / "port"), microbatches=2, **kw),
                 optim.AdamWConfig(**okw), DataConfig(**dkw), device="cpu")
    pt.params = bridge.params_from_jax(p0, cfg, "cpu")
    pt.opt_state = optim.init(pt.params)
    got = pt.run()
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    for a, b in zip(got["metrics"], want["metrics"]):
        assert a["step"] == b["step"]
        np.testing.assert_allclose([a["lr"], a["grad_norm"]], [b["lr"], b["grad_norm"]],
                                   rtol=1e-5)
    assert got["entropy_floor"] == want["entropy_floor"]


def test_a_mesh_needs_an_initialised_group(tmp_path):
    """MoE on a data axis > 1 trains (its groups and aux loss span the
    global batch: tests/test_torch_moe_mesh.py), so an MoE config on an
    AbstractMesh gets as far as asking for the process group, as a dense
    config does."""
    from repro_torch.launch.mesh import AXES, AbstractMesh

    cfg, tcfg, ocfg, dcfg = _setup(tmp_path)
    moe_cfg = get_smoke_config("olmoe-1b-7b")
    mesh = AbstractMesh((1, 2, 1), AXES)
    with pytest.raises(RuntimeError, match="needs a DeviceMesh over an initialised"):
        Trainer(moe_cfg, tcfg, ocfg, dataclasses.replace(dcfg, vocab=moe_cfg.vocab), mesh=mesh,
                device="cpu")
    with pytest.raises(RuntimeError, match="needs a DeviceMesh over an initialised"):
        Trainer(cfg, tcfg, ocfg, dcfg, mesh=mesh, device="cpu")


def test_train_launcher_runs_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = tmp_path / "metrics.jsonl"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke", "--device", "cpu",
         "--steps", "3", "--ckpt-dir", str(tmp_path / "ck"), "--metrics-out", str(out)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "final_loss=" in proc.stdout and "entropy_floor=" in proc.stdout
    assert len(out.read_text().splitlines()) == 2     # steps 0 and 2 are logged
    assert sorted(os.listdir(tmp_path / "ck")) == ["MANIFEST.json", "step_3"]
