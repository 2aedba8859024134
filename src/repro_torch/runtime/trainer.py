"""Training runtime: the control path (the paper's FSM state controller);
the port's counterpart of ``repro/runtime/trainer.py``.

Responsibilities:
  * the train step (loss → grads → AdamW, ``launch.steps.make_train_step``)
    on the trainer's device (the card unless the caller asks for the CPU),
    or over a mesh with the parameters and AdamW moments stored as this
    rank's ZeRO/FSDP shards (``parallel.zero``);
  * checkpoint/restart: atomic async checkpoints every N steps, auto-resume
    from the latest valid one — deterministic continuation is covered by
    tests (same data pipeline step counter, same parameters from the seed);
  * failure injection: ``fail_at_step`` raises mid-run to exercise the
    restart path;
  * straggler monitoring: per-step wall-times feed the monitor; steps slower
    than ``straggler_factor``× the median trigger work reassignment in the
    data pipeline (simulated-host model) and are logged;
  * elastic restarts: checkpoints hold full arrays (written once, by the
    mesh's first rank), so a run restores onto another mesh by cutting
    its own shards.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time
from typing import Any

import numpy as np
import torch

from repro_torch import optim
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import zero

PyTree = Any


class SimulatedFailure(RuntimeError):
    """Raised by failure injection to exercise checkpoint/restart."""


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 20                  # 0: no checkpoint is written
    ckpt_dir: str = dataclasses.field(   # under $TMPDIR
        default_factory=lambda: os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ckpt_async: bool = True
    keep_ckpts: int = 3
    log_every: int = 10
    microbatches: int = 1
    fail_at_step: int | None = None       # failure injection
    straggler_factor: float = 3.0
    straggler_patience: int = 3
    seed: int = 0


class StragglerMonitor:
    """Flags hosts whose step times exceed factor× the running median.

    The trainer feeds (host, seconds) samples.  After ``patience``
    consecutive slow steps a host's data work is reassigned (and the event
    is logged for the operator)."""

    def __init__(self, factor: float, patience: int):
        self.factor = factor
        self.patience = patience
        self.history: dict[int, list[float]] = {}
        self.slow_counts: dict[int, int] = {}
        self.reassigned: set[int] = set()
        self.events: list[dict] = []

    def observe(self, host: int, seconds: float, step: int) -> bool:
        """Returns True if ``host`` was just declared a straggler."""
        self.history.setdefault(host, []).append(seconds)
        all_times = [t for ts in self.history.values() for t in ts[-20:]]
        med = float(np.median(all_times))
        if seconds > self.factor * med and len(all_times) >= 5:
            self.slow_counts[host] = self.slow_counts.get(host, 0) + 1
        else:
            self.slow_counts[host] = 0
        if self.slow_counts.get(host, 0) >= self.patience and host not in self.reassigned:
            self.reassigned.add(host)
            self.events.append({"step": step, "host": host, "median": med, "t": seconds})
            return True
        return False


class Trainer:
    """``params`` and ``opt_state`` are public: a caller may replace them
    (with bridged reference parameters and a fresh ``optim.init``) before
    ``run``; on a mesh they are this rank's shards, and :meth:`load_full`
    sets them from full tensors.

    ``mesh`` is a ``DeviceMesh`` over an initialised process group
    (``launch.mesh.make_local_mesh``): every rank draws the same initial
    parameters from the seed and keeps its shards, and trains its rows of
    each global batch, on its model shard where the family computes there
    (``launch.steps.make_train_step``)."""

    def __init__(
        self,
        cfg: ModelConfig,
        tcfg: TrainerConfig,
        ocfg: optim.AdamWConfig,
        dcfg: DataConfig,
        mesh: Any = None,
        *,
        device: str | torch.device | None = None,
    ):
        self.layout = None if mesh is None else zero.state_layout(cfg, mesh)
        self.device = resolve_device(device)
        self.cfg, self.tcfg, self.ocfg, self.mesh = cfg, tcfg, ocfg, mesh
        self.data = TokenPipeline(dcfg)
        self.ckpt = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.keep_ckpts)
        self.monitor = StragglerMonitor(tcfg.straggler_factor, tcfg.straggler_patience)
        self.metrics_log: list[dict] = []
        gen = torch.Generator(device=self.device).manual_seed(tcfg.seed)
        if self.layout is None:
            self.load_full(lm.init_params(cfg, gen, device=self.device))
        else:
            # this rank's shards of the seeded draw, cut leaf by leaf (the
            # whole tree is never held); fresh moments are zeros either way
            params = self.layout.draw(cfg, gen, self.device, key="params")
            self.params, self.opt_state = params, optim.init(params)
        self._step_fn = make_train_step(cfg, ocfg, tcfg.microbatches, mesh)

    def load_full(self, params: PyTree, opt_state: optim.AdamWState | None = None) -> None:
        """Set the parameters and the optimizer state (a fresh
        ``optim.init`` unless given) from full tensors; on a mesh each rank
        keeps its shards."""
        opt_state = optim.init(params) if opt_state is None else opt_state
        state = {"params": params, "opt": opt_state}
        if self.layout is not None:
            state = self.layout.shard(state)
        self.params, self.opt_state = state["params"], state["opt"]

    def full_state(self) -> dict:
        """``{"params", "opt"}`` as full tensors (on a mesh, a collective:
        every rank of the mesh calls it)."""
        state = {"params": self.params, "opt": self.opt_state}
        return state if self.layout is None else self.layout.gather(state)

    # ------------------------------------------------------------------
    def _resume(self) -> int:
        if self.layout is not None:     # the writer's last checkpoint is on disk
            self.layout.barrier()
        last = self.ckpt.latest_step()
        if last is None:
            return 0
        tree = {"params": self.params, "opt": self.opt_state}
        restored, meta = self.ckpt.restore(tree, last, layout=self.layout)
        self.params = restored["params"]
        self.opt_state = restored["opt"]
        return int(meta["step"])

    def run(self, resume: bool = True) -> dict:
        start = self._resume() if resume else 0
        tcfg = self.tcfg
        losses = []
        for step in range(start, tcfg.total_steps):
            if tcfg.fail_at_step is not None and step == tcfg.fail_at_step:
                raise SimulatedFailure(f"injected failure at step {step}")
            t0 = time.perf_counter()
            batch = self.data.global_batch_at(step)
            batch = {k: torch.from_numpy(v).to(self.device) for k, v in batch.items()}
            self.params, self.opt_state, metrics = self._step_fn(
                self.params, self.opt_state, batch
            )
            loss = float(metrics["loss"])     # waits for the step
            dt = time.perf_counter() - t0
            losses.append(loss)
            if self.monitor.observe(host=0, seconds=dt, step=step):
                # single-process simulation: host 0 can only reassign to itself
                self.data.reassign(0, 0)
            if step % tcfg.log_every == 0 or step == tcfg.total_steps - 1:
                # the rate this step's update used (apply advanced the step)
                lr = optim.lr_schedule(self.ocfg, self.opt_state.step)
                rec = {"step": step, "loss": loss, "sec": dt,
                       "lr": float(lr), "grad_norm": float(metrics["grad_norm"])}
                self.metrics_log.append(rec)
            if tcfg.ckpt_every and ((step + 1) % tcfg.ckpt_every == 0
                                    or step == tcfg.total_steps - 1):
                tree = {"params": self.params, "opt": self.opt_state}
                save = self.ckpt.save_async if tcfg.ckpt_async else self.ckpt.save
                save(step + 1, tree, {"step": step + 1}, layout=self.layout)
        self.ckpt.wait()
        if self.layout is not None:
            self.layout.barrier()
        return {
            "final_loss": losses[-1] if losses else None,
            "losses": losses,
            "entropy_floor": self.data.entropy_floor,
            "straggler_events": self.monitor.events,
            "metrics": self.metrics_log,
        }

    def dump_metrics(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            for rec in self.metrics_log:
                f.write(json.dumps(rec) + "\n")
