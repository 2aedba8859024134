"""Step functions; the port's counterpart of the step half of
``repro/launch/steps.py``.

  * train   → ``train_step(params, opt_state, batch)`` (fwd + bwd + AdamW),
    on one device or, given a mesh, on this rank's shards
  * prefill → ``prefill_step(params, batch)`` → (last logits, caches)
  * decode  → ``serve_step(params, batch, caches, pos)`` (one new token
    against the caches)

The reference's ``input_specs``, ``param_structs``, ``plan_shardings`` and
``lower_cell`` (shape structs, sharding plans and lowering of one
arch × shape × mesh cell) are the dry run's half and are not ported yet
(ROADMAP.md, Queue 1 item 12c); the sharding rules they read are
(:mod:`repro_torch.parallel.sharding`).
"""

from __future__ import annotations

import torch

from repro_torch import optim
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig


def make_train_step(cfg: ModelConfig, ocfg: optim.AdamWConfig, microbatches: int = 1,
                    mesh=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"})`` on the global ``batch``.

    With a ``mesh`` (a ``DeviceMesh`` this rank is in), ``params`` and
    ``opt_state`` are this rank's shards (``parallel.zero.param_layout``)
    and the step is the reference's sharded train step: the parameters are
    gathered whole, ``accumulate_grads`` runs on this rank's rows of each
    microbatch (``zero.local_rows``) with the global microbatch's label
    count as the loss's denominator, the gradients and the loss are summed
    over the data axes and cut to this rank's shards, and AdamW updates
    the shards with the mesh-wide grad norm.  Ranks along ``model`` train
    the same rows on the whole parameters."""
    if mesh is None:
        def train_step(params, opt_state, batch):
            loss_fn = lambda p, b: lm.train_loss(p, cfg, b)
            loss, grads, _ = optim.accumulate_grads(loss_fn, params, batch, microbatches)
            new_params, new_opt, om = optim.apply(ocfg, grads, opt_state, params)
            return new_params, new_opt, {"loss": loss, "grad_norm": om["grad_norm"]}

        return train_step

    from repro_torch.launch.mesh import local_shard, mesh_dp
    from repro_torch.parallel import zero
    from repro_torch.parallel.sharding import activation_constraints

    zero.refuse_moe_on_data(cfg, mesh)
    layout = zero.param_layout(cfg, mesh)
    dp, shard = mesh_dp(mesh), local_shard(mesh)

    def loss_fn(p, b):
        count = layout.data_sum((b["labels"] >= 0).to(torch.float32).sum())
        return lm.train_loss(p, cfg, b, count=count)

    def train_step(params, opt_state, batch):
        rows = batch["tokens"].shape[0] // microbatches     # a global microbatch
        full = layout.gather(params)
        with activation_constraints(mesh, global_batch=rows):
            loss, grads, _ = optim.accumulate_grads(
                loss_fn, full, zero.local_rows(batch, microbatches, dp, shard), microbatches)
        del full
        loss = layout.data_sum(loss)
        grads = layout.reduce_grads(grads)
        new_params, new_opt, om = optim.apply(ocfg, grads, opt_state, params, layout=layout)
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
