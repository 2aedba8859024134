"""Training runtime: the control path (the paper's FSM state controller);
the port's counterpart of ``repro/runtime/trainer.py``, on one device.

Responsibilities:
  * the train step (loss → grads → AdamW, ``launch.steps.make_train_step``)
    on the trainer's device: the card unless the caller asks for the CPU;
  * checkpoint/restart: atomic async checkpoints every N steps, auto-resume
    from the latest valid one — deterministic continuation is covered by
    tests (same data pipeline step counter, same parameters from the seed);
  * failure injection: ``fail_at_step`` raises mid-run to exercise the
    restart path;
  * straggler monitoring: per-step wall-times feed the monitor; steps slower
    than ``straggler_factor``× the median trigger work reassignment in the
    data pipeline (simulated-host model) and are logged.

Meshes (the reference's sharded train step and elastic re-sharding) are not
ported yet (ROADMAP.md, Queue 1 item 12b).
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

PyTree = Any


class SimulatedFailure(RuntimeError):
    """Raised by failure injection to exercise checkpoint/restart."""


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 20
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
    ``run``."""

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
        if mesh is not None:
            raise NotImplementedError(
                "Trainer(mesh): sharded training (FSDP/ZeRO specs, elastic "
                "re-sharding on restore) is not ported to repro_torch yet (ROADMAP.md, "
                "Queue 1 item 12b: Multi-device training and the dry run)")
        self.device = resolve_device(device)
        self.cfg, self.tcfg, self.ocfg = cfg, tcfg, ocfg
        self.data = TokenPipeline(dcfg)
        self.ckpt = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.keep_ckpts)
        self.monitor = StragglerMonitor(tcfg.straggler_factor, tcfg.straggler_patience)
        self.metrics_log: list[dict] = []
        gen = torch.Generator(device=self.device).manual_seed(tcfg.seed)
        self.params = lm.init_params(cfg, gen, device=self.device)
        self.opt_state = optim.init(self.params)
        self._step_fn = make_train_step(cfg, ocfg, tcfg.microbatches)

    # ------------------------------------------------------------------
    def _resume(self) -> int:
        last = self.ckpt.latest_step()
        if last is None:
            return 0
        tree = {"params": self.params, "opt": self.opt_state}
        restored, meta = self.ckpt.restore(tree, last)
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
            if (step + 1) % tcfg.ckpt_every == 0 or step == tcfg.total_steps - 1:
                tree = {"params": self.params, "opt": self.opt_state}
                if tcfg.ckpt_async:
                    self.ckpt.save_async(step + 1, tree, {"step": step + 1})
                else:
                    self.ckpt.save(step + 1, tree, {"step": step + 1})
        self.ckpt.wait()
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
