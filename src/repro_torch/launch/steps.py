"""Step functions and the dry run's shape structs for every (arch × shape);
the port's counterpart of ``repro/launch/steps.py``.

  * train   → ``train_step(params, opt_state, batch)`` (fwd + bwd + AdamW),
    on one device or, given a mesh, on this rank's shards
  * prefill → ``prefill_step(params, batch)`` → (last logits, caches)
  * decode  → ``serve_step(params, batch, caches, pos)`` (one new token
    against a seq_len-deep cache/SSM state)

``input_specs(cfg, shape)`` gives every step input as a meta tensor (shape
and dtype, no storage: built under ``FakeTensorMode``), ``plan_shardings``
the specs that lay them out on a mesh, and ``lower_cell`` traces one
arch × shape × mesh cell on fake tensors through these step functions, the
port's counterpart of lowering it (``launch/dryrun.py`` records it).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import torch

from repro_torch import optim
from repro_torch._tree import tree_map
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig, ShapeSpec
from repro_torch.parallel.sharding import computes_on_model_shard

PyTree = Any


def dryrun_config(cfg: ModelConfig, **overrides) -> ModelConfig:
    """bf16 weights/activations for production realism."""
    return dataclasses.replace(cfg, dtype="bfloat16", param_dtype="bfloat16", **overrides)


# ---------------------------------------------------------------------------
# shape structs (no allocation anywhere): meta tensors
# ---------------------------------------------------------------------------

def _struct(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _meta(build) -> PyTree:
    """``build(device)``'s tree as meta tensors, built on fake tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        fake = build("cpu")
    return tree_map(lambda t: _struct(t.shape, t.dtype), fake)


def param_structs(cfg: ModelConfig) -> PyTree:
    from repro_torch.parallel import zero

    return zero.param_shapes(cfg)


def opt_structs(params: PyTree) -> optim.AdamWState:
    return optim.AdamWState(step=_struct((), torch.int32),
                            m=tree_map(lambda p: _struct(p.shape, torch.float32), params),
                            v=tree_map(lambda p: _struct(p.shape, torch.float32), params))


def cache_structs(cfg: ModelConfig, batch: int, max_seq: int) -> PyTree:
    return _meta(lambda dev: lm.init_cache(cfg, batch, max_seq, dev))


def batch_structs(cfg: ModelConfig, shape: ShapeSpec) -> PyTree:
    B, S = shape.global_batch, shape.seq_len
    bs: dict[str, Any] = {}
    if cfg.family == "encoder":
        bs["embeds"] = _struct((B, S, cfg.frontend_dim), cfg.act_dtype)
    else:
        bs["tokens"] = _struct((B, S), torch.int32)
    if shape.kind == "train":
        bs["labels"] = _struct((B, S), torch.int32)
    if cfg.family == "vlm":
        bs["memory"] = _struct((B, cfg.frontend_tokens, cfg.frontend_dim), cfg.act_dtype)
    return bs


def decode_batch_structs(cfg: ModelConfig, batch: int) -> PyTree:
    """A decode step's batch: one token a row, and a VLM's memory."""
    toks = {"tokens": _struct((batch, 1), torch.int32)}
    if cfg.family == "vlm":
        toks["memory"] = _struct((batch, cfg.frontend_tokens, cfg.frontend_dim), cfg.act_dtype)
    return toks


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict[str, PyTree]:
    """All step inputs as meta tensors, keyed by argument name."""
    if shape.kind == "train":
        params = param_structs(cfg)
        return {"params": params, "opt_state": opt_structs(params),
                "batch": batch_structs(cfg, shape)}
    if shape.kind == "prefill":
        return {"params": param_structs(cfg), "batch": batch_structs(cfg, shape)}
    # decode: one token against a seq_len-deep cache
    B = shape.global_batch
    return {"params": param_structs(cfg), "batch": decode_batch_structs(cfg, B),
            "caches": cache_structs(cfg, B, shape.seq_len), "pos": _struct((), torch.int32)}


# ---------------------------------------------------------------------------
# step functions
# ---------------------------------------------------------------------------

def make_train_step(cfg: ModelConfig, ocfg: optim.AdamWConfig, microbatches: int = 1,
                    mesh=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"})`` on the global ``batch``.

    With a ``mesh`` (a ``DeviceMesh`` this rank is in), ``params`` and
    ``opt_state`` are this rank's shards (``parallel.zero.param_layout``)
    and the step is the reference's sharded train step: the parameters are
    gathered along the data axes, ``accumulate_grads`` runs on this rank's
    rows of each microbatch (``zero.local_rows``) with the global
    microbatch's label count as the loss's denominator, the gradients and
    the loss are summed over the data axes and cut to this rank's shards,
    and AdamW updates the shards with the mesh-wide grad norm.

    Where ``sharding.computes_on_model_shard`` holds (the dense, Mamba-1,
    MoE, VLM and encoder families on a ``model`` axis of size > 1), each
    leaf keeps its ``model`` block and the step computes on this rank's
    heads (a ``cross`` block's too; where heads do not cut whole, the
    query heads that cover its ``wo`` rows, K and V joined whole), FFN
    columns, inner channels, experts and vocabulary rows
    (``parallel.tensor_parallel``); no TP'd leaf, no expert block and no
    ``[B, S, V]`` logits cross the ``model`` group.  Otherwise (the
    recurrent and hybrid families) the parameters are gathered whole and
    the ranks along ``model`` train the same rows on the whole network
    (ROADMAP.md, Queue 1 item 12c(c)).
    ``train_step.model_shard`` says which path the step takes.  MoE layers form their groups over the
    global microbatch (``models.moe.moe_apply``)."""
    if mesh is None:
        def train_step(params, opt_state, batch):
            loss_fn = lambda p, b: lm.train_loss(p, cfg, b)
            loss, grads, _ = optim.accumulate_grads(loss_fn, params, batch, microbatches)
            new_params, new_opt, om = optim.apply(ocfg, grads, opt_state, params)
            return new_params, new_opt, {"loss": loss, "grad_norm": om["grad_norm"]}

        train_step.model_shard = False
        return train_step

    from repro_torch.launch.mesh import local_shard, mesh_dp
    from repro_torch.parallel import zero
    from repro_torch.parallel.sharding import activation_constraints

    layout = zero.param_layout(cfg, mesh)
    dp, shard = mesh_dp(mesh), local_shard(mesh)
    tp = computes_on_model_shard(cfg, mesh)

    def loss_fn(p, b):
        count = layout.data_sum((b["labels"] >= 0).to(torch.float32).sum())
        return lm.train_loss(p, cfg, b, count=count)

    def train_step(params, opt_state, batch):
        # a global microbatch's rows (of the tokens, or an encoder's embeds)
        rows = batch.get("embeds", batch.get("tokens")).shape[0] // microbatches
        full = layout.gather(params, keep_model=tp)
        with activation_constraints(mesh, global_batch=rows), _shard_ctx(tp, mesh):
            loss, grads, _ = optim.accumulate_grads(
                loss_fn, full, zero.local_rows(batch, microbatches, dp, shard), microbatches)
        del full
        loss = layout.data_sum(loss)
        grads = layout.reduce_grads(grads, keep_model=tp)
        new_params, new_opt, om = optim.apply(ocfg, grads, opt_state, params, layout=layout)
        return new_params, new_opt, {"loss": loss, "grad_norm": om["grad_norm"]}

    train_step.model_shard = tp
    return train_step


def _shard_ctx(tp: bool, mesh):
    """The model-shard context of ``mesh`` where the step computes on it."""
    from repro_torch.parallel.sharding import model_shard

    return model_shard(mesh) if tp else contextlib.nullcontext()


def _whole(cfg: ModelConfig, mesh):
    """``(params -> the tree the step computes on, on the model shard?)``:
    itself without a mesh; with one, the gather of this rank's shards
    (``zero.param_layout``), along the data axes only where the step
    computes on its model shard."""
    if mesh is None:
        return (lambda params: params), False
    from repro_torch.parallel import zero

    tp = computes_on_model_shard(cfg, mesh)
    gather = zero.param_layout(cfg, mesh).gather
    return (lambda params: gather(params, keep_model=tp)), tp


def make_prefill_step(cfg: ModelConfig, mesh=None):
    """``prefill_step(params, batch)`` on ``batch``'s rows; with a ``mesh``,
    ``params`` are this rank's shards and ``batch`` is this rank's rows:
    on its model shard where ``computes_on_model_shard`` holds (the logits
    the rank's vocabulary slice, the caches its heads or channels), else
    on the shards gathered whole."""
    whole, tp = _whole(cfg, mesh)

    def prefill_step(params, batch):
        inputs = batch.get("embeds", batch.get("tokens"))
        with _shard_ctx(tp, mesh):
            return lm.prefill(whole(params), cfg, inputs, memory=batch.get("memory"))

    prefill_step.model_shard = tp
    return prefill_step


def make_serve_step(cfg: ModelConfig, mesh=None):
    """``serve_step(params, batch, caches, pos)``; with a ``mesh``, as
    :func:`make_prefill_step`: this rank's rows and their caches, on its
    model shard or on the shards gathered whole."""
    whole, tp = _whole(cfg, mesh)

    def serve_step(params, batch, caches, pos):
        with _shard_ctx(tp, mesh):
            return lm.decode_step(whole(params), cfg, batch["tokens"], caches, pos,
                                  memory=batch.get("memory"))

    serve_step.model_shard = tp
    return serve_step


# ---------------------------------------------------------------------------
# sharding plans per step
# ---------------------------------------------------------------------------

def plan_shardings(cfg: ModelConfig, shape: ShapeSpec, mesh, specs: dict) -> dict:
    """Spec trees matching ``input_specs`` for this cell (the reference's
    ``NamedSharding`` trees, as spec tuples: ``parallel.sharding``)."""
    from repro_torch.launch.mesh import axis_sizes
    from repro_torch.parallel import sharding as shd

    pspec = shd.param_specs(cfg, specs["params"], mesh)
    out: dict[str, Any] = {"params": pspec}
    if shape.kind == "train":
        out["opt_state"] = optim.AdamWState(step=(), m=pspec, v=pspec)
    out["batch"] = shd.batch_specs(cfg, shape, mesh, specs["batch"])
    if shape.kind == "decode":
        shard_seq = shape.global_batch < axis_sizes(mesh).get("data", 1)
        out["caches"] = shd.cache_specs(cfg, specs["caches"], mesh, shard_seq=shard_seq)
        out["pos"] = ()
    return out


def local_shape(spec: tuple, shape, mesh) -> tuple[int, ...]:
    """One rank's block of a leaf of ``shape`` under ``spec``."""
    from repro_torch.launch.mesh import axis_sizes

    sizes = axis_sizes(mesh)
    out = []
    for d, n in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        axes = () if entry is None else (entry if isinstance(entry, tuple) else (entry,))
        for a in axes:
            n //= sizes[a]
        out.append(n)
    return tuple(out)


@dataclasses.dataclass
class LoweredCell:
    """One traced arch × shape × mesh cell (``lower_cell``)."""

    rows: int                   # the batch rows this rank computes
    stats: Any                  # trace_analysis.TraceStats, per rank
    model_shard: bool = False   # the step computed on this rank's model shard


def lower_cell(cfg: ModelConfig, shape: ShapeSpec, mesh,
               ocfg: optim.AdamWConfig | None = None, microbatches: int = 1,
               constrain_acts: bool = False, seq_axis: str | None = None, *,
               device: str | torch.device = "cuda") -> LoweredCell:
    """Trace one (arch × shape × mesh) cell on fake tensors: the port's
    counterpart of lowering it.  Returns a :class:`LoweredCell` whose
    ``stats`` are rank 0's (``launch.trace_analysis``).

    ``mesh`` is None (one device) or a ``DeviceMesh``, usually rank 0's of
    ``launch.mesh.make_fake_mesh``.  The inputs are fake tensors on
    ``device`` of the shapes this rank holds: for train, its parameter and
    AdamW shards (``plan_shardings``) and the global batch, as the step
    takes them; for prefill and decode, its parameter shards and its rows
    of the batch and the caches, the caches of this rank's heads or
    channels where the step computes on its model shard
    (``computes_on_model_shard``; every position: the port shards no
    sequence, item 12c(c)).  The port's real step functions run on them,
    with their collectives on the fake group.

    The trace runs with ``use_pallas=False``: a kernel launch through
    ``ctypes`` cannot take fake tensors, and training reaches no kernel in
    either package.  ``constrain_acts`` pins prefill and decode activations
    to this rank's rows as a check (a train step on a mesh always pins);
    ``seq_axis`` of size > 1 raises, as the port shards no sequence (ROADMAP
    Queue 1 item 12c(c))."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch import trace_analysis
    from repro_torch.launch.mesh import axis_sizes, mesh_dp
    from repro_torch.parallel.sharding import activation_constraints

    if seq_axis is not None and (mesh is None or axis_sizes(mesh).get(seq_axis, 1) > 1):
        raise NotImplementedError(
            f"lower_cell(seq_axis={seq_axis!r}): sequence-sharded activations are not ported "
            "to repro_torch yet (ROADMAP.md, Queue 1 item 12c(c))")
    if cfg.pure_dp:
        raise NotImplementedError(
            "lower_cell: a pure_dp plan cuts the batch over the model axis, which the port's "
            "steps do not (ROADMAP.md, Queue 1 item 12c(c): the model axis's compute)")
    cfg = dataclasses.replace(cfg, use_pallas=False, use_codegen=False)
    tp = mesh is not None and computes_on_model_shard(cfg, mesh)
    specs = input_specs(cfg, shape)
    sh = plan_shardings(cfg, shape, mesh, specs) if mesh is not None else None
    dev = torch.device(device)

    def fake(tree, spec_tree=None):
        if spec_tree is None:
            return tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype, device=dev), tree)
        return tree_map(lambda t, s: torch.zeros(local_shape(s, t.shape, mesh), dtype=t.dtype,
                                                 device=dev), tree, spec_tree)

    with FakeTensorMode():
        rows = shape.global_batch
        if mesh is not None and shape.kind != "train":
            lead = "embeds" if "embeds" in specs["batch"] else "tokens"
            rows = local_shape(sh["batch"][lead], specs["batch"][lead].shape, mesh)[0]
        if shape.kind == "train":
            step = make_train_step(cfg, ocfg or optim.AdamWConfig(), microbatches, mesh)
            if mesh is not None:
                rows //= mesh_dp(mesh)
            args = (fake(specs["params"], sh and sh["params"]),
                    fake(specs["opt_state"], sh and sh["opt_state"]), fake(specs["batch"]))
            _, stats = trace_analysis.trace(step, args)
        else:
            local = dataclasses.replace(shape, global_batch=rows)
            params = fake(specs["params"], sh and sh["params"])
            batch = fake(batch_structs(cfg, local) if shape.kind == "prefill"
                         else decode_batch_structs(cfg, rows))
            pin = (activation_constraints(mesh, global_batch=shape.global_batch)
                   if constrain_acts and mesh is not None else contextlib.nullcontext())
            with pin:
                if shape.kind == "prefill":
                    _, stats = trace_analysis.trace(make_prefill_step(cfg, mesh),
                                                    (params, batch))
                else:
                    with _shard_ctx(tp, mesh):
                        caches = fake(cache_structs(cfg, rows, shape.seq_len))
                    pos = torch.zeros((), dtype=torch.int32, device=dev)
                    _, stats = trace_analysis.trace(make_serve_step(cfg, mesh),
                                                    (params, batch, caches, pos))
    return LoweredCell(rows=rows, stats=stats, model_shard=tp)


__all__ = ["LoweredCell", "batch_structs", "cache_structs", "decode_batch_structs",
           "dryrun_config", "input_specs",
           "local_shape", "lower_cell", "make_prefill_step", "make_serve_step",
           "make_train_step", "opt_structs", "param_structs", "plan_shardings"]
