"""Step functions; the port's counterpart of the step half of
``repro/launch/steps.py``.

  * train   → ``train_step(params, opt_state, batch)`` (fwd + bwd + AdamW)
  * prefill → ``prefill_step(params, batch)`` → (last logits, caches)
  * decode  → ``serve_step(params, batch, caches, pos)`` (one new token
    against the caches)

The reference's ``input_specs``, ``param_structs``, ``plan_shardings`` and
``lower_cell`` (shape structs, sharding plans and lowering of one
arch × shape × mesh cell) are the dry run's half and are not ported yet
(ROADMAP.md, Queue 1 item 12b); the sharding rules they read are
(:mod:`repro_torch.parallel.sharding`).
"""

from __future__ import annotations

from repro_torch import optim
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig


def make_train_step(cfg: ModelConfig, ocfg: optim.AdamWConfig, microbatches: int = 1):
    def train_step(params, opt_state, batch):
        loss_fn = lambda p, b: lm.train_loss(p, cfg, b)
        loss, grads, _ = optim.accumulate_grads(loss_fn, params, batch, microbatches)
        new_params, new_opt, om = optim.apply(ocfg, grads, opt_state, params)
        return new_params, new_opt, {"loss": loss, "grad_norm": om["grad_norm"]}

    return train_step


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, batch):
        return lm.prefill(params, cfg, batch["tokens"])

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    def serve_step(params, batch, caches, pos):
        return lm.decode_step(params, cfg, batch["tokens"], caches, pos)

    return serve_step


__all__ = ["make_prefill_step", "make_serve_step", "make_train_step"]
