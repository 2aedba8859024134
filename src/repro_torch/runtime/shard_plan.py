"""ShardPlan: how the serving stack maps onto a device mesh; the port's
counterpart of ``repro/runtime/shard_plan.py``.

The paper's C-slow lever (Sec. V, Fig. 5) multiplexes C independent streams
through one datapath by widening the *batch* axis; a mesh scales the same
axis out, so ``c_slow × data_shards`` compose on one batch dimension:

====================  =========================  ==========================
paper / single-chip    mesh axis                  serving meaning
====================  =========================  ==========================
C-slow streams         ``data`` (DP)              decode slots, one shard's
                                                  slot pool per data index
gate MACC lanes        ``model`` (TP)             the ``[D+H, 4H]`` gate
                                                  contraction, all-reduce at
                                                  the gate nonlinearity
j-step unroll          (within-device)            ``block_k`` decode blocks
====================  =========================  ==========================

A :class:`ShardPlan` answers what the :class:`~repro_torch.runtime.server.DecodeServer`
asks:

* **placement**: which shard owns slot ``b`` (contiguous blocks);
* **specs**: the decode caches' (batch over DP) and the serving
  parameters' (replicated over DP, TP factors over ``model``, FSDP off), as
  spec tuples or as DTensor placements, and this rank's block of the
  parameters (:meth:`ShardPlan.local_params`);
* **identity**: a hashable :meth:`key` for synthesis memo keys and a
  :meth:`describe` dict for ``stats()`` and ``health()``.

Two layouts share one logical topology:

* ``fold_data=False`` (default): the DP shards are ranks of a
  ``torch.distributed`` group, one slot shard each, on a ``DeviceMesh``
  (:func:`repro_torch.launch.mesh.make_local_mesh`).  Every rank runs the
  same host logic and computes only its own shard's slots.
* ``fold_data=True``: the DP shards are logical (per-shard slot pools,
  prefix caches, quarantine, metrics) and run as interleaved streams
  through one datapath in one process: the mesh may be an
  :class:`~repro_torch.launch.mesh.AbstractMesh` that carries only axis
  names and sizes.

``plan=None`` everywhere means the single-device behaviour, bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch._tree import tree_leaves, tree_map
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.mesh import axis_names, axis_sizes, mesh_ranks
from repro_torch.parallel import comm
from repro_torch.parallel.sharding import cache_specs, param_specs, placements

PyTree = Any


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """Decode-stack placement over ``mesh`` (axes ``pod``/``data``/``model``,
    any subset; missing axes count as size 1)."""

    mesh: Any
    fold_data: bool = False

    def __post_init__(self):
        axis_names(self.mesh)       # a mesh of either kind, or TypeError
        if self.fold_data and self.tp > 1:
            raise ValueError(
                "ShardPlan(fold_data=True) folds all DP shards through one "
                "datapath; tensor parallelism needs the physical layout "
                f"(got tp={self.tp})")

    @property
    def dp(self) -> int:
        """Data-parallel shard count: the product of the DP axes."""
        return mesh_lib.mesh_dp(self.mesh)

    @property
    def tp(self) -> int:
        return mesh_lib.mesh_tp(self.mesh)

    @property
    def dp_axes(self) -> tuple[str, ...]:
        return mesh_lib.dp_axes(self.mesh)

    # -- placement ---------------------------------------------------------

    def validate_slots(self, num_slots: int) -> int:
        """Slots per shard; raises unless the pool divides evenly."""
        if num_slots % self.dp:
            raise ValueError(
                f"ShardPlan: num_slots={num_slots} must divide evenly over "
                f"dp={self.dp} data shards ({num_slots % self.dp} left over)")
        return num_slots // self.dp

    def shard_of_slot(self, b: int, num_slots: int) -> int:
        return b // self.validate_slots(num_slots)

    def slots_of_shard(self, shard: int, num_slots: int) -> range:
        k = self.validate_slots(num_slots)
        return range(shard * k, (shard + 1) * k)

    # -- specs -------------------------------------------------------------

    def _as(self, specs: PyTree, as_placements: bool) -> PyTree:
        """The spec tree as it is, or with each spec (a tuple leaf) turned
        into its placements."""
        if not as_placements:
            return specs
        if isinstance(specs, dict):
            return {k: self._as(v, True) for k, v in specs.items()}
        if isinstance(specs, list):
            return [self._as(v, True) for v in specs]
        return placements(specs, self.mesh)

    def cache_shardings(self, cfg, cache_tree: PyTree, *, as_placements: bool = False) -> PyTree:
        """Decode-cache specs: batch (slot) dim over the DP axes."""
        return self._as(cache_specs(cfg, cache_tree, self.mesh, shard_seq=False), as_placements)

    def param_shardings(self, cfg, params_tree: PyTree, *, as_placements: bool = False) -> PyTree:
        """Serving parameter specs: TP over ``model`` where divisible,
        replicated over DP (``fsdp=False``)."""
        return self._as(param_specs(cfg, params_tree, self.mesh, fsdp=False), as_placements)

    def local_params(self, cfg, params: PyTree) -> PyTree:
        """This rank's serving parameters: each leaf that
        :meth:`param_shardings` cuts over ``model`` as this rank's block (a
        contiguous copy), the others as they are.  A leaf already of its
        block's shape is kept, so a caller may make the cut itself.  The
        sharded layout only (a DeviceMesh this rank is in)."""
        from repro_torch.parallel.zero import ShardLayout, param_shapes

        shapes = param_shapes(cfg)
        layout = ShardLayout(self.mesh, self.param_shardings(cfg, shapes))

        def one(t, full, spec):
            box = layout._box(spec, full.shape)
            if tuple(t.shape) == tuple(b.stop - b.start for b in box):
                return t
            if tuple(t.shape) != tuple(full.shape):
                raise ValueError(f"a parameter of shape {tuple(t.shape)} is neither "
                                 f"{tuple(full.shape)} nor this rank's block of it")
            return t[box].clone()

        return tree_map(one, params, shapes, layout.specs)

    def draw_local(self, cfg, gen: torch.Generator, device=None) -> PyTree:
        """This rank's serving parameters drawn from ``gen`` on ``device``:
        the values of :meth:`local_params` of ``lm.init_params(cfg, gen)``,
        each leaf (a stacked leaf group by group) cut to this rank's block
        as soon as it is drawn, so the whole tree is never held (the peak is
        this rank's blocks and one group of the whole)."""
        from repro_torch.parallel.zero import ShardLayout, param_shapes

        return ShardLayout(self.mesh, self.param_shardings(cfg, param_shapes(cfg))).draw(
            cfg, gen, device)

    def replicated(self, *, as_placements: bool = False):
        """The fully replicated spec (splice sources, prefix checkpoints)."""
        return placements((), self.mesh) if as_placements else ()

    def batch_sharding(self, ndim: int = 1, *, as_placements: bool = False):
        """Per-slot vector/matrix spec ([B] or [B, ...]): leading dim over DP."""
        spec = (self.dp_axes or None,) + (None,) * (ndim - 1)
        return placements(spec, self.mesh) if as_placements else spec

    def to_mesh(self, tree: PyTree) -> PyTree:
        """Replicate ``tree`` onto every rank of the mesh: each tensor leaf is
        overwritten in place with the mesh's first rank's copy.  The folded
        layout holds one copy already and returns the tree as it is."""
        if self.fold_data:
            return tree
        self.require_group()
        src, group = mesh_ranks(self.mesh)[0], self.control_group()
        for leaf in tree_leaves(tree):
            if isinstance(leaf, torch.Tensor):
                comm.broadcast(leaf, src, group)
        return tree

    # -- ranks (the sharded layout; launch.mesh's rank grid) ----------------

    def require_group(self) -> None:
        """Raise unless this process is a rank of the mesh's initialised
        process group: a sharded plan never falls back to one device."""
        mesh_lib.require_group(self.mesh)

    def shard_rank(self, shard: int, model: int = 0) -> int:
        """Global rank that holds data shard ``shard`` at model index ``model``."""
        return mesh_lib.shard_rank(self.mesh, shard, model)

    @property
    def local_shard(self) -> int:
        """This rank's data shard."""
        return mesh_lib.local_shard(self.mesh)

    def control_group(self):
        """The gloo group over the mesh's ranks: the serving control plane."""
        return comm.control_group(mesh_lib.mesh_ranks(self.mesh))

    # -- identity ----------------------------------------------------------

    def key(self) -> tuple:
        """Hashable descriptor for memo keys: two plans build the same
        program iff their meshes have the same axis names, shape and ranks,
        and their layouts agree."""
        return (axis_names(self.mesh), tuple(axis_sizes(self.mesh).values()),
                mesh_ranks(self.mesh), self.fold_data)

    def describe(self) -> dict:
        sizes = axis_sizes(self.mesh)
        devices = 1
        for s in sizes.values():
            devices *= s
        return {"dp": self.dp, "tp": self.tp,
                "axes": dict(sizes),
                "devices": int(devices),
                "layout": "folded" if self.fold_data else "sharded"}


def make_shard_plan(mesh) -> ShardPlan | None:
    """``None``-propagating constructor (the server/CLI entry point)."""
    return None if mesh is None else ShardPlan(mesh)


__all__ = ["ShardPlan", "make_shard_plan"]
