"""Sharded training state (ZeRO/FSDP): the port's counterpart of the
``in_shardings`` that the reference hands ``jax.jit`` for its train step
(``repro/runtime/trainer.py``).

A :class:`ShardLayout` pairs a tree of specs (``param_specs(cfg, params,
mesh, fsdp=True)``, ``opt_state_specs``, or any spec tree) with a
``DeviceMesh``.  Each rank keeps, of every leaf, the block that its mesh
coordinate selects, as a ``NamedSharding`` places it: dim ``d`` whose spec
entry names axes ``(a, b)`` is cut in ``size(a)·size(b)`` equal blocks and
this rank keeps block ``coord(a)·size(b) + coord(b)``; along the axes the
spec does not name the block is replicated.  From there the layout gives

* :meth:`~ShardLayout.shard`: this rank's blocks of a tree of full tensors;
* :meth:`~ShardLayout.gather`: the full tensors from the blocks, bit for
  bit, on every rank (one integer ``all_reduce`` per mesh axis of size > 1,
  each block from one replica and zeros elsewhere; gloo has no
  ``all_gather`` for CUDA tensors);
* :meth:`~ShardLayout.reduce_grads`: a tree of full gradients summed over
  the data axes and cut to this rank's blocks;
* both in a ``keep_model`` form for a step that computes on its model
  shard (``parallel.tensor_parallel``): the gather runs along the data
  axes only and keeps each leaf's ``model`` block (heads, FFN columns,
  an MoE layer's ``[G, E/tp, ...]`` experts), and the gradients of those
  blocks are cut along the data axes only;
* :meth:`~ShardLayout.square_sum`: the sum of squares of a sharded tree,
  each distinct block counted once (a replica along an axis adds nothing:
  a leaf replicated along ``model``, such as the router, the norms or
  MLA's down projections, counts on its first model rank only),
  the leaves summed in ``jax.tree.leaves`` order as the reference's
  ``global_norm`` sums them.

The data rows of a step (:func:`local_rows`) follow the reference's split:
the global batch is cut into microbatches first, and each microbatch's
rows over the data ranks.
"""

from __future__ import annotations

import functools
import math
from typing import Any

import torch
import torch.distributed as dist

from repro_torch._tree import tree_leaves, tree_leaves_sorted, tree_map
from repro_torch.launch.mesh import axis_names, axis_sizes, dp_axes, mesh_ranks, require_group
from repro_torch.parallel import comm

PyTree = Any

_ALIGN = 64     # elements: every leaf of a packed buffer starts 256-byte aligned


class _Spec:
    """A spec tuple held as a tree leaf (the tree helpers walk tuples)."""

    __slots__ = ("entries",)

    def __init__(self, entries: tuple):
        self.entries = tuple(entries)


def _wrap(specs: PyTree) -> PyTree:
    """Spec tree → the same tree with each spec tuple a :class:`_Spec` leaf:
    dicts and NamedTuples (the optimizer state) are containers, a plain
    tuple is a spec."""
    if isinstance(specs, dict):
        return {k: _wrap(v) for k, v in specs.items()}
    if isinstance(specs, tuple) and hasattr(specs, "_fields"):
        return type(specs)(*(_wrap(v) for v in specs))
    if isinstance(specs, tuple):
        return _Spec(specs)
    raise TypeError(f"not a spec tree node: {specs!r}")


@functools.lru_cache(maxsize=16)
def param_shapes(cfg) -> PyTree:
    """``cfg``'s parameter tree as meta tensors: the full shapes and dtypes
    with no storage (drawn under ``FakeTensorMode``; one tree per config,
    shared by its callers)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models import lm

    with FakeTensorMode():
        fake = lm.init_params(cfg, torch.Generator(), device="cpu")
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), fake)


def local_rows(batch: PyTree, microbatches: int, dp: int, shard: int) -> PyTree:
    """This data shard's rows of a global batch: of each of the
    ``microbatches`` consecutive microbatches, the ``shard``-th of ``dp``
    equal slices, the slices in microbatch order (so ``accumulate_grads``
    with ``microbatches`` gives microbatch ``i``'s slice as its ``i``-th)."""
    def one(x):
        n = microbatches
        if x.shape[0] % (n * dp):
            raise ValueError(f"a global batch of {x.shape[0]} rows does not split into "
                             f"{n} microbatches over {dp} data shards")
        per = x.shape[0] // (n * dp)
        return x.reshape((n, dp, per) + tuple(x.shape[1:]))[:, shard].reshape(
            (n * per,) + tuple(x.shape[1:]))

    return tree_map(one, batch)


class ShardLayout:
    """``specs`` (a spec tree: dicts, NamedTuples, spec tuples) on a
    ``DeviceMesh`` of an initialised process group that this rank is in."""

    def __init__(self, mesh, specs: PyTree):
        require_group(mesh)
        self.mesh = mesh
        self.specs = _wrap(specs)
        self.sizes = axis_sizes(mesh)
        self.coord = dict(zip(axis_names(mesh), mesh.get_coordinate()))
        self.groups = {a: mesh.get_group(a) for a in axis_names(mesh) if self.sizes[a] > 1}
        self.data_groups = [self.groups[a] for a in dp_axes(mesh) if a in self.groups]

    # -- one leaf ----------------------------------------------------------------
    def _axes(self, entry) -> tuple[str, ...]:
        return () if entry is None else (entry if isinstance(entry, tuple) else (entry,))

    def _named(self, spec: _Spec, d: int, over: tuple[str, ...] | None) -> tuple[str, ...]:
        """The axes dim ``d``'s entry names, of ``over`` only when given
        (the data-axis forms keep the ``model`` block: an entry must then
        name axes of ``over`` only, or none of them)."""
        axes = self._axes(spec.entries[d]) if d < len(spec.entries) else ()
        if over is None:
            return axes
        mine = tuple(a for a in axes if a in over)
        if mine and len(mine) != len(axes):
            raise ValueError(f"spec entry {axes} mixes the axes {over} with others")
        return mine

    def _box(self, spec: _Spec, shape, over: tuple[str, ...] | None = None) -> tuple[slice, ...]:
        box = []
        for d, n in enumerate(shape):
            axes = self._named(spec, d, over)
            count = math.prod(self.sizes[a] for a in axes)
            index = 0
            for a in axes:
                index = index * self.sizes[a] + self.coord[a]
            if n % count:
                raise ValueError(f"dim {d} of {tuple(shape)} does not split over {axes}")
            box.append(slice(index * (n // count), (index + 1) * (n // count)))
        return tuple(box)

    def _owner(self, spec: _Spec, over: tuple[str, ...] | None = None) -> bool:
        """Whether this rank is the first replica of its block: its
        coordinate is 0 along every axis the spec does not name (of
        ``over`` only, when given)."""
        named = {a for e in spec.entries for a in self._axes(e)}
        return all(self.coord[a] == 0 for a in self.coord
                   if a not in named and (over is None or a in over))

    # -- trees -------------------------------------------------------------------
    def _leaves(self, tree: PyTree, order=tree_leaves) -> tuple[list, list]:
        """``tree``'s leaves and their specs, in ``order``."""
        return order(tree), order(tree_map(lambda _, s: s, tree, self.specs))

    def shard(self, full: PyTree) -> PyTree:
        """This rank's blocks of ``full``, each a contiguous copy."""
        return tree_map(lambda t, s: t[self._box(s, t.shape)].clone(), full, self.specs)

    def draw(self, cfg, gen: torch.Generator, device=None, *, key: str | None = None) -> PyTree:
        """This rank's blocks of ``lm.init_params(cfg, gen, device=)``, each
        leaf (a stacked leaf group by group) cut as soon as it is drawn: the
        values of :meth:`shard` of the whole draw, which is never held (the
        peak is this rank's blocks and one group's leaf of the whole).
        ``key``: where the parameters' specs sit in this layout's tree (a
        state layout's ``"params"``)."""
        from repro_torch.models import lm

        shapes = param_shapes(cfg)
        specs = self.specs if key is None else self.specs[key]

        def cut(path, t):
            full, spec = shapes, specs
            for k in path.split("/"):
                full, spec = full[k], spec[k]
            box = self._box(spec, full.shape)
            return t[box[len(box) - t.dim():]]    # a stacked leaf's group: no G axis

        return lm.init_params(cfg, gen, device=device, cut=cut)

    def _full_shape(self, spec: _Spec, shape, over: tuple[str, ...] | None = None
                    ) -> tuple[int, ...]:
        return tuple(n * math.prod(self.sizes[a] for a in self._named(spec, d, over))
                     for d, n in enumerate(shape))

    def gather(self, local: PyTree, *, keep_model: bool = False) -> PyTree:
        """The full tensors of a tree of this rank's blocks, on every rank,
        bit for bit (counted as one ``gather_exact``): each element size's
        leaves packed in one flat integer buffer, each block placed by its
        first replica, zeros elsewhere, summed over every mesh axis of size
        > 1.  The returned leaves are views of that buffer, each starting
        256-byte aligned.  Its payload is every buffer once per axis it is
        summed over.

        ``keep_model``: gather along the data axes only, each leaf whole
        along them and still this rank's block along ``model`` (counted as
        one ``gather_data``; nothing crosses the ``model`` group): the
        parameters of a step that computes on its model shard."""
        over = dp_axes(self.mesh) if keep_model else None
        groups = [g for a, g in self.groups.items() if over is None or a in over]
        if keep_model and not groups:       # no data axis of size > 1: the blocks as they are
            return tree_map(lambda t: t, local)
        leaves, specs = self._leaves(local)
        payload = 0
        out: list = [None] * len(leaves)
        for es in sorted({t.element_size() for t in leaves}):
            store = {4: torch.int32, 8: torch.int64}.get(es, torch.uint8)
            units = es // store.itemsize
            idx = [i for i, t in enumerate(leaves) if t.element_size() == es]
            shapes = {i: self._full_shape(specs[i], leaves[i].shape, over) for i in idx}
            offs, total = {}, 0
            for i in idx:
                offs[i] = total
                total += -(-math.prod(shapes[i]) // _ALIGN) * _ALIGN
            flat = torch.zeros(total * units, dtype=store, device=leaves[idx[0]].device)
            for i in idx:
                n = math.prod(shapes[i])
                out[i] = flat[offs[i] * units:(offs[i] + n) * units].view(
                    leaves[i].dtype).view(shapes[i])
                if self._owner(specs[i], over):
                    out[i][self._box(specs[i], shapes[i], over)] = leaves[i]
            for g in groups:
                comm.sum_exact(flat, g)
                payload += flat.numel() * flat.element_size()
        comm.record("gather_data" if keep_model else "gather_exact", payload)
        it = iter(out)
        return tree_map(lambda _: next(it), local)

    def barrier(self) -> None:
        """Every rank of the mesh waits for every other (one barrier per
        axis of size > 1: together a barrier over the whole mesh)."""
        for g in self.groups.values():
            dist.barrier(group=g)

    @property
    def writer(self) -> bool:
        """Whether this rank writes what the mesh saves: its first rank."""
        return dist.get_rank() == mesh_ranks(self.mesh)[0]

    def data_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the data axes (in place when there are any)."""
        for g in self.data_groups:
            comm.all_reduce(t, g)
        return t

    def reduce_grads(self, grads: PyTree, *, keep_model: bool = False) -> PyTree:
        """Full gradients (this rank's rows) summed over the data axes in
        fp32, in one flat buffer, then cut to this rank's blocks.
        ``keep_model``: the gradients are already this rank's ``model``
        blocks (of :meth:`gather`'s ``keep_model`` form) and are cut along
        the data axes only."""
        over = dp_axes(self.mesh) if keep_model else None
        leaves, specs = self._leaves(grads)
        flat = self.data_sum(torch.cat([g.reshape(-1).to(torch.float32) for g in leaves]))
        parts = flat.split([g.numel() for g in leaves])
        it = iter(p.view(g.shape)[self._box(s, g.shape, over)].clone()
                  for p, g, s in zip(parts, leaves, specs, strict=True))
        return tree_map(lambda _: next(it), grads)

    def square_sum(self, tree: PyTree) -> torch.Tensor:
        """Σ of squares over a sharded tree: each leaf's block squared and
        summed on its first replica only, the per-leaf sums reduced over the
        mesh, then added in ``jax.tree.leaves`` order."""
        leaves, specs = self._leaves(tree, tree_leaves_sorted)
        sq = torch.stack([torch.sum(torch.square(g.to(torch.float32))) for g in leaves])
        sq = sq * torch.tensor([float(self._owner(s)) for s in specs], device=sq.device)
        for g in self.groups.values():
            comm.all_reduce(sq, g)
        total = 0
        for i in range(len(leaves)):
            total = total + sq[i]
        return total


def param_layout(cfg, mesh) -> ShardLayout:
    """The layout of ``cfg``'s parameters on ``mesh``: the reference
    Trainer's ``param_specs(cfg, params, mesh)`` (FSDP over ``data``)."""
    from repro_torch.parallel.sharding import param_specs

    return ShardLayout(mesh, param_specs(cfg, param_shapes(cfg), mesh, fsdp=True))


def state_layout(cfg, mesh) -> ShardLayout:
    """The layout of ``{"params": ..., "opt": AdamWState}``: the moments
    shard like their parameters (``opt_state_specs``), the step is
    replicated."""
    from repro_torch.optim import AdamWState
    from repro_torch.parallel.sharding import opt_state_specs, param_specs

    shapes = param_shapes(cfg)
    ospecs = opt_state_specs(cfg, shapes, mesh)
    return ShardLayout(mesh, {"params": param_specs(cfg, shapes, mesh, fsdp=True),
                              "opt": AdamWState((), ospecs, ospecs)})


__all__ = ["ShardLayout", "local_rows", "param_layout", "param_shapes", "state_layout"]
