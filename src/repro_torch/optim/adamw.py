"""AdamW with mixed precision, global-norm clipping, a warmup-cosine schedule
and gradient accumulation; the port's counterpart of ``repro/optim/adamw.py``.

The optimizer state is a tree mirroring the params (``m`` and ``v`` in fp32)
plus an int32 step.  Every scalar of the update (the learning rate, the bias
corrections, the clip scale) is a float32 tensor on the params' device, as
in the reference, never a Python float: a Python float computes in float64,
and PyTorch divides a CUDA tensor by a Python scalar as a product with its
reciprocal, so either would round differently from the reference.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch._tree import tree_leaves, tree_leaves_sorted, tree_map

PyTree = Any


class AdamWState(NamedTuple):
    step: torch.Tensor     # scalar int32
    m: PyTree              # first moment (f32)
    v: PyTree              # second moment (f32)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    lr_min_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def lr_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup → cosine decay to ``lr_min_ratio``·peak, in float32."""
    step = torch.as_tensor(step).to(torch.float32)
    f = lambda x: _f32(x, step)
    warm = cfg.lr_peak * step / f(max(cfg.warmup_steps, 1))
    t = (step - cfg.warmup_steps) / f(max(cfg.total_steps - cfg.warmup_steps, 1))
    t = torch.clamp(t, 0.0, 1.0)
    cos = cfg.lr_min_ratio + (1 - cfg.lr_min_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr_peak * cos)


def init(params: PyTree) -> AdamWState:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    first = tree_leaves(params)[0]
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=first.device),
        m=tree_map(zeros, params),
        v=tree_map(zeros, params),
    )


def global_norm(tree: PyTree, layout=None) -> torch.Tensor:
    """sqrt of the sum of squares, the leaves summed in ``jax.tree.leaves``
    order (dict keys sorted), as the reference sums them.  With a
    ``layout`` (``parallel.zero.ShardLayout``) the tree holds this rank's
    shards: each distinct shard is squared once and the sums are reduced
    across the mesh."""
    if layout is not None:
        return torch.sqrt(layout.square_sum(tree))
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in tree_leaves_sorted(tree)))


def clip_by_global_norm(grads: PyTree, max_norm: float, layout=None):
    gn = global_norm(grads, layout)
    scale = torch.clamp(_f32(max_norm, gn) / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), gn


@torch.no_grad()
def apply(
    cfg: AdamWConfig,
    grads: PyTree,
    state: AdamWState,
    params: PyTree,
    *,
    layout=None,
) -> tuple[PyTree, AdamWState, dict]:
    """One AdamW update.  Params may be bf16; the update math is f32 and the
    new params are cast back to the param dtype (mixed-precision master-less
    scheme; for true master weights keep params f32).  Given the
    ``layout`` of sharded ``grads``, ``state`` and ``params``, only the
    global norm crosses ranks; the rest is elementwise on the shards."""
    grads = tree_map(lambda g: g.to(torch.float32), grads)
    if cfg.clip_norm > 0:
        grads, gn = clip_by_global_norm(grads, cfg.clip_norm, layout)
    else:
        gn = global_norm(grads, layout)

    step = state.step + 1
    lr = lr_schedule(cfg, step)
    step_f = step.to(torch.float32)
    b1c = 1 - torch.pow(_f32(cfg.b1, step_f), step_f)
    b2c = 1 - torch.pow(_f32(cfg.b2, step_f), step_f)

    new_m = tree_map(lambda m, g: cfg.b1 * m + (1 - cfg.b1) * g, state.m, grads)
    new_v = tree_map(lambda v, g: cfg.b2 * v + (1 - cfg.b2) * g * g, state.v, grads)

    def upd(p, m, v):
        mhat = m / b1c
        vhat = v / b2c
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * delta).to(p.dtype)

    new_params = tree_map(upd, params, new_m, new_v)
    return new_params, AdamWState(step, new_m, new_v), {"lr": lr, "grad_norm": gn}


# ---------------------------------------------------------------------------
# gradient accumulation (microbatching; the C-slow stream count in time)
# ---------------------------------------------------------------------------

def value_and_grad(loss_fn: Callable[[PyTree, PyTree], tuple[torch.Tensor, dict]],
                   params: PyTree, batch: PyTree):
    """``(loss, metrics), grads`` of ``loss_fn(params, batch)``, as
    ``jax.value_and_grad(loss_fn, has_aux=True)`` gives them: the grads a
    tree like ``params`` in each leaf's dtype (zeros for a leaf the loss does
    not reach), everything returned detached."""
    with torch.enable_grad():
        live = tree_map(lambda t: t.detach().requires_grad_(True), params)
        loss, metrics = loss_fn(live, batch)
        leaves = tree_leaves(live)
        gs = iter(torch.autograd.grad(loss, leaves, allow_unused=True,
                                      materialize_grads=True))
    grads = tree_map(lambda _: next(gs), live)
    return (loss.detach(), tree_map(torch.Tensor.detach, metrics)), grads


def accumulate_grads(
    loss_fn: Callable[[PyTree, PyTree], tuple[torch.Tensor, dict]],
    params: PyTree,
    batch: PyTree,
    num_microbatches: int,
):
    """Split the leading batch dim into microbatches and accumulate grads in
    fp32, one microbatch's activations alive at a time (the reference's
    ``lax.scan``, here a Python loop).

    Returns (mean_loss, mean_grads, last_metrics).
    """
    if num_microbatches <= 1:
        (loss, metrics), grads = value_and_grad(loss_fn, params, batch)
        return loss, grads, metrics

    n = num_microbatches
    first = tree_leaves(params)[0]
    tot_loss = torch.zeros((), dtype=torch.float32, device=first.device)
    tot_g = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                     params)
    metrics = None
    for i in range(n):
        mb = tree_map(lambda x: x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))[i], batch)
        (loss, metrics), grads = value_and_grad(loss_fn, params, mb)
        tot_g = tree_map(lambda a, g: a + g.to(torch.float32), tot_g, grads)
        del grads
        tot_loss = tot_loss + loss
    div = _f32(n, tot_loss)
    return tot_loss / div, tree_map(lambda g: g / div, tot_g), metrics
