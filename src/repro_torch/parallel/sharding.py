"""Sharding rules: DP/FSDP/TP/EP plans for every architecture; the port's
counterpart of ``repro/parallel/sharding.py``.

Parameters are plain nested dicts; rules map parameter *paths* to specs over
the mesh

    single pod : ("data", "model")            = (16, 16)
    multi pod  : ("pod", "data", "model")     = (2, 16, 16)

A spec is a tuple with one entry per tensor dim, as a ``PartitionSpec``
reads: an axis name, a tuple of axis names, or ``None`` (replicated along
that dim).  :func:`placements` turns one into DTensor ``Shard(d)`` /
``Replicate()`` placements, one per mesh dim.

Conventions (the reference's):

* batch/DP: activations shard batch over ``("pod", "data")``.
* FSDP/ZeRO: parameters and AdamW moments shard one non-TP dim over
  ``"data"``; gradients reduce over ``"pod"``.
* TP: attention head dims / FFN hidden dims shard over ``"model"``; MoE
  experts shard over ``"model"`` (EP); Mamba inner channels over ``"model"``.
* Every rule passes through a **divisibility guard**: an axis that does not
  divide the dimension is dropped.

The rules read only axis names and sizes, so they run on an
:class:`~repro_torch.launch.mesh.AbstractMesh` and on leaves that carry only
a ``.shape`` (fake or meta tensors, shape structs).

The activation pins (``activation_constraints``, ``constrain_activation``,
``activation_spec``) check, inside the context, that each group's input
holds this rank's share of the batch rows.  The model-shard context
(``model_shard``) tells the model code which part of ``model`` this rank
computes (``parallel/tensor_parallel.py``), where
``computes_on_model_shard`` admits the config.
"""

from __future__ import annotations

import contextlib
import math
import re
import threading
from typing import TYPE_CHECKING, Any, Callable, NamedTuple

from repro_torch.launch.mesh import axis_names, axis_sizes, dp_axes, is_device_mesh

if TYPE_CHECKING:
    from repro_torch.models.config import ModelConfig

PyTree = Any
Spec = tuple


def fsdp_axis(mesh) -> str | None:
    return "data" if "data" in axis_names(mesh) else None


def map_with_path(fn: Callable[[str, Any], Any], tree: PyTree, prefix: str = "") -> PyTree:
    """Apply ``fn(path, leaf)`` over a nested dict/list/tuple; the path is
    the reference's ``_path_str``: keys and indices joined by ``/``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [map_with_path(fn, v, f"{prefix}/{i}" if prefix else str(i))
               for i, v in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)
    return fn(prefix, tree)


# ---------------------------------------------------------------------------
# divisibility guard
# ---------------------------------------------------------------------------

def _guard(spec: Spec, shape: tuple[int, ...], mesh) -> Spec:
    """Drop axes that don't divide their dim, exceed rank, or repeat."""
    sizes = axis_sizes(mesh)
    out = []
    used: set[str] = set()
    for i, entry in enumerate(spec):
        if i >= len(shape) or entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        if any(a in used for a in axes):
            out.append(None)
            continue
        total = math.prod(sizes[a] for a in axes)
        if shape[i] % total == 0:
            out.append(entry)
            used.update(axes)
        else:
            out.append(None)
    return tuple(out)


# ---------------------------------------------------------------------------
# parameter rules
# ---------------------------------------------------------------------------

def _param_rules(cfg: ModelConfig, mesh, *, fsdp: bool = True) -> list[tuple[str, Spec]]:
    """Ordered (regex, spec) rules, the reference's in its order.  'G' in
    comments = stacked group axis.

    ``fsdp=False`` drops the "data" factor from every rule (parameters
    replicate over DP, TP factors stay): the *serving* layout, where the
    data axis carries decode slots.
    """
    f = fsdp_axis(mesh) if fsdp else None
    tp = None if cfg.pure_dp else "model"
    atp = tp if cfg.attn_tp else None
    return [
        # --- embeddings / head ---
        (r"embed/table$",            (tp, f)),            # [V, D]
        (r"embed/proj$",             (None, f)),          # [F_in, D] (encoder stub)
        (r"head/w$",                 (f, tp)),            # [D, V]
        # --- attention (stacked [G, ...] unless shared) ---
        (r"shared/attn/w[qkv]$",     (f, atp)),
        (r"shared/attn/wo$",         (atp, f)),
        (r".*(attn|cross)/w[qkv]$",  (None, f, atp)),     # [G, D, H*hd]
        (r".*(attn|cross)/wo$",      (None, atp, f)),     # [G, H*hd, D]
        (r".*lora/[qkv]A$",          (None, f, None)),
        (r".*lora/[qkv]B$",          (None, None, atp)),
        # --- MLA ---
        (r".*attn/w_dkv$",           (None, f, None)),    # [G, D, r]
        (r".*attn/w_krope$",         (None, f, None)),
        (r".*attn/w_uk$",            (None, None, atp)),  # [G, r, H*dn]
        (r".*attn/w_uv$",            (None, None, atp)),
        # --- dense MLP ---
        (r"shared/mlp/w_(in|gate)$", (f, tp)),
        (r"shared/mlp/w_out$",       (tp, f)),
        (r".*mlp/w_(in|gate)$",      (None, f, tp)),      # [G, D, F]
        (r".*mlp/w_out$",            (None, tp, f)),      # [G, F, D]
        # --- MoE (EP over experts) ---
        (r".*moe/router$",           (None, f, None)),    # [G, D, E]
        (r".*moe/w_(in|gate)$",      (None, tp, f, None)),  # [G, E, D, F]
        (r".*moe/w_out$",            (None, tp, None, f)),  # [G, E, F, D]
        (r".*moe/shared/w_(in|gate)$", (None, f, tp)),
        (r".*moe/shared/w_out$",     (None, tp, f)),
        # --- Mamba (split-aligned projections) ---
        (r".*mamba/w_[xz]$",         (None, f, tp)),      # [G, D, DI]
        (r".*mamba/w_bc$",           (None, f, None)),    # [G, D, 2N] (tiny)
        (r".*mamba/w_dt$",           (None, f, None)),    # [G, D, H]
        (r".*mamba/conv_w(_x)?$",    (None, None, tp)),   # [G, k, DI]
        (r".*mamba/conv_b(_x)?$",    (None, tp)),         # [G, DI]
        (r".*mamba/conv_[wb]_bc$",   ()),                 # replicated (tiny)
        (r".*mamba/x_proj$",         (None, tp, None)),   # [G, DI, R+2N]
        (r".*mamba/dt_proj$",        (None, None, tp)),   # [G, R, DI]
        (r".*mamba/dt_bias$",        (None, tp)),
        (r".*mamba/A_log$",          (None, tp, None)),   # [G, DI, N]
        (r".*mamba/D$",              (None, tp)),
        (r".*mamba/out_proj$",       (None, tp, f)),      # [G, DI, D]
        (r".*mamba/norm/scale$",     (None, tp)),
        # --- recurrent cells (LSTM/GRU): fused 4H/3H gate dim over TP ---
        (r".*rnn/cell/w_[xh]$",      (None, f, tp)),      # [G, D|H, 4H/3H]
        (r".*rnn/cell/b(h_n)?$",     (None, tp)),         # [G, 4H/3H]
        (r".*rnn/w_out$",            (None, tp, f)),      # [G, H, D]
        # --- norms & leftovers: replicated ---
        (r".*",                      ()),
    ]


def _spec_for_path(path: str, shape, rules, mesh) -> Spec:
    for pat, spec in rules:
        if re.search(pat, path):
            # pad spec to rank
            entries = list(spec) + [None] * (len(shape) - len(spec))
            return _guard(tuple(entries[: len(shape)]), shape, mesh)
    return ()


def param_specs(cfg: ModelConfig, params_tree: PyTree, mesh, *, fsdp: bool = True) -> PyTree:
    """Spec tree matching ``params_tree`` (any leaves with a ``.shape``)."""
    rules = _param_rules(cfg, mesh, fsdp=fsdp)
    return map_with_path(
        lambda path, leaf: _spec_for_path(path, tuple(leaf.shape), rules, mesh),
        params_tree)


def opt_state_specs(cfg: ModelConfig, params_tree: PyTree, mesh) -> PyTree:
    """AdamW moments shard exactly like their parameters (ZeRO)."""
    return param_specs(cfg, params_tree, mesh)


# ---------------------------------------------------------------------------
# batch / cache specs
# ---------------------------------------------------------------------------

def batch_specs(cfg: ModelConfig, shape, mesh, batch_shapes: PyTree) -> PyTree:  # noqa: ARG001
    """Input specs for a shape cell: batch over all DP axes when divisible;
    ``pure_dp`` plans also spread the batch over "model"."""
    dp = dp_axes(mesh)
    if cfg.pure_dp and "model" in axis_names(mesh):
        dp = dp + ("model",)

    def one(_path, leaf):
        spec = [None] * len(leaf.shape)
        if len(leaf.shape) >= 1:
            spec[0] = dp
        return _guard(tuple(spec), tuple(leaf.shape), mesh)

    return map_with_path(one, batch_shapes)


def cache_specs(cfg: ModelConfig, cache_tree: PyTree, mesh, *, shard_seq: bool) -> PyTree:
    """Decode-cache specs.  Leaves are [G, B, S, heads, hd] (KV), [G, B, S, r]
    (MLA latent) or [G, B, ...] (SSM and recurrent states); tail leaves have
    no G axis.  The batch dim shards over DP when divisible; with
    ``shard_seq`` the sequence dim of attention caches shards over ``data``
    instead (flash-decode partitioning); SSM states shard their channel dims
    over ``model``."""
    dp = dp_axes(mesh)
    tp = "model"

    def one(p, leaf):
        shp = tuple(leaf.shape)
        spec = [None] * len(shp)
        # leaves under "groups/" are stacked [G, B, ...]; "tail/" are [B, ...]
        off = 1 if p.startswith("groups") else 0

        def put(i, axis):
            if 0 <= off + i < len(spec):
                spec[off + i] = axis

        if "conv" in p:                     # [B, k-1, C]
            put(0, dp)
            put(2, tp)
        elif re.search(r"/[hc]$", p):       # mamba [B,DI,N] / rnn carry [B,H]
            put(0, dp)
            put(1, tp)
        elif re.search(r"(c_kv|k_rope)$", p):  # MLA latent [B,S,r]
            put(0, dp)
            if shard_seq:
                put(1, "data")
        elif re.search(r"/[kv]$", p):       # KV [B,S,KV,hd]
            put(0, dp)
            if shard_seq:
                put(1, "data")
            else:
                put(2, tp if cfg.attn_tp else None)
        return _guard(tuple(spec), shp, mesh)

    return map_with_path(one, cache_tree)


def placements(spec: Spec, mesh) -> list:
    """DTensor placements of a spec, one per mesh dim: ``Shard(d)`` on every
    mesh axis that tensor dim ``d``'s entry names, ``Replicate()`` on the
    others."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in axis_names(mesh):
        dim = next((d for d, entry in enumerate(spec) if entry is not None
                    and name in (entry if isinstance(entry, tuple) else (entry,))), None)
        out.append(Replicate() if dim is None else Shard(dim))
    return out


# ---------------------------------------------------------------------------
# activation pins
# ---------------------------------------------------------------------------
#
# The reference pins each group's activations to P(dp, ...) so that XLA's
# propagation cannot lose the batch sharding.  A rank of the port holds a
# plain tensor of its own rows, so a pin here is a check: inside the
# context, the batch dim must be this rank's share of the global batch.  A
# wrong share raises; nothing is ever resharded.  Thread-local, so tests and
# single-device runs are untouched.

_ACT = threading.local()


@contextlib.contextmanager
def activation_constraints(mesh, *, seq_axis: str | None = None,
                           batch_axes: tuple[str, ...] | None = None,
                           global_batch: int | None = None):
    """Enable the batch-dim pin (and the sequence-dim spec) of
    :func:`constrain_activation`.  ``global_batch`` is the rows the pinned
    activations carry across the whole mesh (a plain tensor does not know
    it); without it only the spec is formed.  The port shards no sequence,
    so a ``seq_axis`` of size > 1 raises (ROADMAP.md, Queue 1 item 12c)."""
    if seq_axis is not None and axis_sizes(mesh).get(seq_axis, 1) > 1:
        raise NotImplementedError(
            f"activation_constraints(seq_axis={seq_axis!r}): sequence-sharded activations "
            "are not ported to repro_torch yet (ROADMAP.md, Queue 1 item 12c)")
    with _pins((mesh, seq_axis, batch_axes, global_batch)):
        yield


@contextlib.contextmanager
def _pins(cfg):
    prev = getattr(_ACT, "cfg", None)
    _ACT.cfg = cfg
    try:
        yield
    finally:
        _ACT.cfg = prev


def recompute_contexts():
    """``torch.utils.checkpoint``'s ``context_fn``: the pins and the model
    shard in force at a group's forward, put back around its recompute.
    Autograd may run the backward, and so the recompute, on a thread of its
    own (it does for CUDA tensors), where the thread-local contexts would be
    missing; a recompute repeats the forward's collectives over ``model``."""
    return contextlib.nullcontext(), _restored(getattr(_ACT, "cfg", None),
                                               getattr(_ACT, "shard", None))


@contextlib.contextmanager
def _restored(pins, shard):
    with _pins(pins), _shard_ctx(shard):
        yield


def constrain_activation(x):
    """Pin ``[B, S, D]`` (or ``[B, ...]``) activations to batch-over-DP.

    Outside an :func:`activation_constraints` context (or for a tensor of
    rank < 2) ``x`` comes back unchanged.  Inside it, on a DeviceMesh with a
    ``global_batch``, ``x``'s batch dim must be this rank's share: the
    global batch over the DP axes' size when that divides it (the
    reference's divisibility guard), else the whole batch.  Any other size
    raises ``ValueError``.  ``x`` is returned as it is."""
    ctx = getattr(_ACT, "cfg", None)
    if ctx is None or not hasattr(x, "shape") or x.ndim < 2:
        return x
    mesh, _, batch_axes, global_batch = ctx
    if global_batch is None or not is_device_mesh(mesh):
        return x
    # the reference's spec's batch entry, through its divisibility guard
    [entry] = _guard((batch_axes or dp_axes(mesh),), (int(global_batch),), mesh)
    axes = () if entry is None else (entry if isinstance(entry, tuple) else (entry,))
    share = int(global_batch) // math.prod(axis_sizes(mesh)[a] for a in axes)
    if x.shape[0] != share:
        raise ValueError(
            f"constrain_activation: a batch dim of {x.shape[0]} rows, but this rank's share "
            f"of the global batch {global_batch} over {axes or 'no axis'} is {share} "
            "(activations are never resharded)")
    return x


def data_share(rows: int):
    """Where a batch of ``rows`` rows is this rank's share of a global
    batch cut over the data axes (inside :func:`activation_constraints`
    with a ``global_batch``, on a DeviceMesh whose data axes hold dp > 1
    ranks): ``(group over the data axes, this rank's data shard, dp)``;
    else None.  The MoE layer reads it to form its groups over the global
    batch."""
    ctx = getattr(_ACT, "cfg", None)
    if ctx is None:
        return None
    mesh, _, _, global_batch = ctx
    if global_batch is None or not is_device_mesh(mesh):
        return None
    from repro_torch.launch.mesh import data_group, local_shard, mesh_dp

    dp = mesh_dp(mesh)
    if dp == 1 or rows * dp != int(global_batch):
        return None
    return data_group(mesh), local_shard(mesh), dp


# ---------------------------------------------------------------------------
# tensor-parallel compute along ``model``
# ---------------------------------------------------------------------------
#
# The reference's partitioner splits attention heads, FFN columns, Mamba's
# inner channels, MoE experts and the vocabulary over ``model`` from the
# rules above.  The port computes on its model shard for the families whose
# split falls between kernels (``parallel/tensor_parallel.py`` holds the
# collectives): the dense transformer, Mamba-1, MoE (its experts cut over
# ``model`` on tokens that every model rank holds, the router replicated;
# with GQA or MLA attention, MLA cut by heads and its latent whole), the
# VLM (its ``cross`` blocks cut by heads like self-attention, the memory
# whole on every rank and projected onto a rank's KV columns; the gate and
# the q/k norms replicated) and the encoder (its ``embed/proj`` replicated,
# its output whole on every rank).  Attention computes on a rank's part
# where the rules cut ``wq``/``wk``/``wv``'s columns into part of a head
# too (8 KV heads over 16: half a head a rank): the columns are joined
# whole exactly, the cache holds every KV head (``cache_specs``' guard
# drops ``model`` there), and a rank attends with the query heads that
# cover its ``wo`` rows.  Everything else keeps its parameters whole along
# ``model`` (ROADMAP.md, Queue 1 item 12c(c)): the recurrent and hybrid
# families and ``pure_dp``.

TP_FAMILIES = ("dense", "ssm", "moe", "vlm", "encoder")


def model_shard_refusal(cfg: ModelConfig) -> str | None:
    """Why ``cfg`` cannot compute on a model shard of any width > 1, or
    None when it can (its attention split may still depend on the width:
    :func:`computes_on_model_shard`)."""
    if cfg.pure_dp:
        return ("a pure_dp plan spreads the batch over the model axis instead "
                "(ROADMAP.md, Queue 1 item 12c(c))")
    if cfg.family not in TP_FAMILIES:
        return (f"tensor-parallel compute for the {cfg.family} family ({cfg.name}) is not "
                "ported yet (ROADMAP.md, Queue 1 item 12c(c))")
    return None


def computes_on_model_shard(cfg: ModelConfig, mesh) -> bool:
    """Whether a step of ``cfg`` on ``mesh`` computes on this rank's model
    shard: a ``model`` axis of size > 1, a family of :data:`TP_FAMILIES`,
    ``pure_dp`` off, and attention either replicated (``attn_tp=False``)
    or with ``wq``'s and ``wk``/``wv``'s columns cut over ``model`` (those
    of a ``cross`` block too), in whole heads or not (internlm2-20b's and
    llama-3.2-vision-90b's 8 KV heads over 16 ranks: half a head each);
    under MLA whole query heads, its latent whole.  Otherwise the
    parameters are gathered whole along ``model`` and every model rank
    computes the whole network."""
    tp = 1 if mesh is None else axis_sizes(mesh).get("model", 1)
    if tp <= 1 or model_shard_refusal(cfg) is not None:
        return False
    if cfg.family == "ssm" or not cfg.attn_tp:
        return True
    if cfg.use_mla:
        return cfg.n_heads % tp == 0
    return not (cfg.n_heads * cfg.head_dim % tp or cfg.n_kv_heads * cfg.head_dim % tp)


class ModelShard(NamedTuple):
    """This rank's place on ``model``: the group, its index there, the
    axis's size."""

    group: Any
    index: int
    tp: int


@contextlib.contextmanager
def _shard_ctx(shard: ModelShard | None):
    prev = getattr(_ACT, "shard", None)
    _ACT.shard = shard
    try:
        yield
    finally:
        _ACT.shard = prev


def model_shard(mesh):
    """The model-shard context of ``mesh`` (a DeviceMesh this rank is in):
    inside it the model code computes on this rank's heads, FFN columns,
    inner channels and vocabulary rows, with the collectives of
    ``parallel.tensor_parallel`` between its kernels.  Thread-local, like
    the pins."""
    from repro_torch.launch.mesh import model_group, model_index, mesh_tp

    tp = mesh_tp(mesh)
    return _shard_ctx(ModelShard(model_group(mesh), model_index(mesh), tp) if tp > 1 else None)


def current_model_shard() -> ModelShard | None:
    """The :class:`ModelShard` in force on this thread, or None."""
    return getattr(_ACT, "shard", None)


def activation_spec(mesh, *dims) -> Spec:  # noqa: ARG001 - the reference's signature
    """The spec of ``dims`` as a tuple (:func:`placements` turns it into
    DTensor placements on ``mesh``)."""
    return tuple(dims)


__all__ = ["TP_FAMILIES", "ModelShard", "activation_constraints", "activation_spec",
           "batch_specs", "cache_specs", "computes_on_model_shard", "constrain_activation",
           "current_model_shard", "data_share", "dp_axes", "fsdp_axis", "map_with_path",
           "model_shard", "model_shard_refusal", "opt_state_specs", "param_specs",
           "placements", "recompute_contexts"]
