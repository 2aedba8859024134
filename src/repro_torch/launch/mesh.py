"""Meshes; the port's counterpart of ``repro/launch/mesh.py``.

A mesh has the axes ``("pod", "data", "model")``, any subset of them; a
missing axis counts as size 1.  The port knows two kinds:

* a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of an
  initialised process group: one rank per mesh position, the counterpart of
  the reference's ``jax.sharding.Mesh`` over devices.  The sharded serving
  layout, ``synthesize(mesh=)`` and ``ep_moe_apply`` run on it.
* an :class:`AbstractMesh`: axis names and sizes, no ranks and no devices.
  The sharding rules read only that, ``ShardPlan(fold_data=True)`` runs all
  of its logical shards in one process, and the production meshes are
  described this way.

Building a mesh never initialises a process group: :func:`make_local_mesh`
refuses when there is none (start the ranks under ``torchrun``, or give
``init_process_group`` an address, a world size and a rank).  The one
exception is the dry run's :func:`make_fake_mesh`: rank 0's DeviceMesh of a
mesh shape over torch's ``"fake"`` process group, whose collectives return
at once, so that one process traces a step of the production meshes.  A
fake group never reaches a real step: :func:`require_group` accepts it only
while a ``FakeTensorMode`` is active, and :func:`make_local_mesh` refuses
it.

The rank arithmetic that serving and synthesis share lives here too: a
DeviceMesh's ranks as a ``[dp, tp]`` grid (:func:`rank_grid`), this rank's
data shard and model index, and the ``model`` and data groups.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.distributed as dist

AXES = ("pod", "data", "model")


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh described by its axis sizes and names only."""

    axis_sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    def __post_init__(self):
        object.__setattr__(self, "axis_sizes", tuple(int(s) for s in self.axis_sizes))
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"AbstractMesh: {len(self.axis_sizes)} sizes for "
                             f"{len(self.axis_names)} axis names")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"AbstractMesh: repeated axis name in {self.axis_names}")
        if any(s < 1 for s in self.axis_sizes):
            raise ValueError(f"AbstractMesh: axis sizes {self.axis_sizes} must be >= 1")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def is_device_mesh(mesh) -> bool:
    return not isinstance(mesh, AbstractMesh) and hasattr(mesh, "mesh_dim_names")


def axis_names(mesh) -> tuple[str, ...]:
    if isinstance(mesh, AbstractMesh):
        return mesh.axis_names
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        raise TypeError(f"expected an AbstractMesh or a DeviceMesh with named "
                        f"dims, got {type(mesh).__name__}")
    return tuple(names)


def axis_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` in the mesh's axis order."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(axis_names(mesh), (int(s) for s in mesh.shape)))


def _host(fn):
    """Run ``fn`` with no dispatch mode active: a DeviceMesh's rank map is
    host metadata, which a trace's ``FakeTensorMode`` must not take in."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        from torch.utils._python_dispatch import _disable_current_modes

        with _disable_current_modes():
            return fn(*args, **kwargs)

    return wrapper


@_host
def mesh_ranks(mesh) -> tuple[int, ...] | None:
    """The global ranks of a DeviceMesh in row-major mesh order; None for an
    :class:`AbstractMesh`."""
    if isinstance(mesh, AbstractMesh):
        return None
    axis_names(mesh)
    return tuple(int(r) for r in mesh.mesh.flatten().tolist())


def dp_axes(mesh) -> tuple[str, ...]:
    """The data-parallel axes of ``mesh``, pod first."""
    names = axis_names(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def mesh_dp(mesh) -> int:
    """Data-parallel shard count: the product of the DP axes' sizes."""
    s = axis_sizes(mesh)
    return int(s.get("pod", 1) * s.get("data", 1))


def mesh_tp(mesh) -> int:
    """Tensor-parallel width: the ``model`` axis's size."""
    return int(axis_sizes(mesh).get("model", 1))


# -- the ranks of a DeviceMesh as a [dp, tp] grid -----------------------------

_DATA_GROUPS: dict[tuple, list] = {}


def _fake_group() -> bool:
    return dist.is_available() and dist.is_initialized() and dist.get_backend() == "fake"


def require_group(mesh) -> None:
    """Raise unless this process is a rank of ``mesh``'s initialised process
    group: a sharded layout never falls back to one device.  A ``"fake"``
    group (:func:`make_fake_mesh`) passes only while a ``FakeTensorMode``
    is active: its collectives move nothing, so only shapes may meet it."""
    if not is_device_mesh(mesh):
        raise RuntimeError(
            "the sharded layout needs a DeviceMesh over an initialised process group "
            f"of dp*tp = {mesh_dp(mesh) * mesh_tp(mesh)} ranks "
            "(repro_torch.launch.mesh.make_local_mesh under torchrun); an "
            "AbstractMesh serves only with ShardPlan(fold_data=True)")
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("the sharded layout: no torch.distributed process group "
                           "is initialised")
    if mesh.get_coordinate() is None:
        raise RuntimeError(f"the sharded layout: rank {dist.get_rank()} is not in the "
                           f"mesh {mesh_ranks(mesh)}")
    if _fake_group():
        from torch._guards import detect_fake_mode

        if detect_fake_mode() is None:
            raise RuntimeError("the sharded layout: the process group is the dry run's fake "
                               "group, whose collectives move nothing; it takes fake tensors "
                               "only (launch.steps.lower_cell)")


@_host
def rank_grid(mesh) -> torch.Tensor:
    """The mesh's global ranks as a ``[dp, tp]`` grid (pod-major shards)."""
    names = axis_names(mesh)
    present = [a for a in AXES if a in names]
    return mesh.mesh.permute([names.index(a) for a in present]).reshape(
        mesh_dp(mesh), mesh_tp(mesh))


@_host
def shard_rank(mesh, shard: int, model: int = 0) -> int:
    """Global rank that holds data shard ``shard`` at model index ``model``."""
    return int(rank_grid(mesh)[shard, model])


@_host
def local_shard(mesh) -> int:
    """This rank's data shard."""
    return int((rank_grid(mesh) == dist.get_rank()).nonzero()[0, 0])


@_host
def model_index(mesh) -> int:
    """This rank's index on the ``model`` axis."""
    return int((rank_grid(mesh) == dist.get_rank()).nonzero()[0, 1])


def model_group(mesh):
    """The mesh's ``model`` group (TP collectives), None without one."""
    return mesh.get_group("model") if "model" in axis_names(mesh) else None


@_host
def data_group(mesh):
    """The ranks of this rank's model index over the DP axes, on the mesh's
    backend."""
    big = [a for a in dp_axes(mesh) if axis_sizes(mesh)[a] > 1]
    if len(big) <= 1:
        return mesh.get_group(big[0] if big else dp_axes(mesh)[0])
    grid = rank_grid(mesh)
    cols = tuple(tuple(grid[:, m].tolist()) for m in range(mesh_tp(mesh)))
    if cols not in _DATA_GROUPS:    # new_group is collective: every column
        _DATA_GROUPS[cols] = [dist.new_group(list(c)) for c in cols]
    return _DATA_GROUPS[cols][model_index(mesh)]


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """The reference's production mesh as a shape: 16 × 16 per pod, 2 pods
    for ``multi_pod``.  The sharding rules read it, and the dry run traces
    its rank 0 (:func:`make_fake_mesh`); nothing of the port runs on it."""
    if multi_pod:
        return AbstractMesh((2, 16, 16), AXES)
    return AbstractMesh((16, 16), ("data", "model"))


def make_fake_mesh(shape: AbstractMesh):
    """Rank 0's ``DeviceMesh`` of ``shape`` (an :class:`AbstractMesh`, such
    as :func:`make_production_mesh`'s) over torch's ``"fake"`` process group
    at ``shape``'s world size: the dry run's mesh (``launch/dryrun.py``).

    It starts this process's default group (a process has one), so call it
    in a process of its own: the dry run's CLI, or ``dryrun.spawn_cell``.
    An earlier fake group is replaced; a real one is refused."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if not _fake_group():
            raise RuntimeError("make_fake_mesh: this process already belongs to a "
                               f"{dist.get_backend()} process group; the dry run's fake "
                               "group needs a process of its own")
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=shape.size)
    ranks = torch.arange(shape.size).reshape(shape.axis_sizes)
    return DeviceMesh("cpu", ranks, mesh_dim_names=shape.axis_names)


def make_local_mesh(dp: int | None = None, tp: int | None = None):
    """A ``DeviceMesh`` with axes ``("pod", "data", "model")`` over the
    initialised process group.

    With no arguments every rank goes on the model axis, ``(1, 1, world)``,
    as the reference's default does.  An explicit ``(dp, tp)`` gives
    ``(1, dp, tp)`` over the first ``dp·tp`` ranks.  Either both or neither
    of ``dp``/``tp`` must be given.  The mesh's device type is ``"cuda"``
    under NCCL and ``"cpu"`` otherwise.
    """
    if (dp is None) != (tp is None):
        raise ValueError("make_local_mesh: pass both dp and tp, or neither")
    if dp is not None:
        dp, tp = int(dp), int(tp)
        if dp < 1 or tp < 1:
            raise ValueError(f"make_local_mesh: dp={dp} and tp={tp} must be >= 1")
    if not (dist.is_available() and dist.is_initialized()):
        need = "dp*tp" if dp is None else str(dp * tp)
        raise RuntimeError(
            "make_local_mesh: no torch.distributed process group is initialised; "
            f"start {need} ranks with `torchrun --nproc-per-node={need} ...` (or "
            "init_process_group with an address, a world size and a rank), or "
            "describe a one-process folded mesh with AbstractMesh((1, dp, 1), AXES)")
    if _fake_group():
        raise RuntimeError("make_local_mesh: the process group is the dry run's fake group, "
                           "whose collectives move nothing; start real ranks")
    from torch.distributed.device_mesh import DeviceMesh

    world = dist.get_world_size()
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if dp is None:
        dp, tp = 1, world
    need = dp * tp
    if need > world:
        raise ValueError(
            f"make_local_mesh: dp*tp = {dp}*{tp} = {need} exceeds the {world} "
            f"rank(s) of the process group; start {need} ranks "
            f"(torchrun --nproc-per-node={need}) or shrink the mesh")
    ranks = torch.arange(need).reshape(1, dp, tp)
    return DeviceMesh(device_type, ranks, mesh_dim_names=AXES)


__all__ = ["AXES", "AbstractMesh", "axis_names", "axis_sizes", "data_group", "dp_axes",
           "is_device_mesh", "local_shard", "make_fake_mesh", "make_local_mesh", "make_production_mesh",
           "mesh_dp", "mesh_ranks", "mesh_tp", "model_group", "model_index", "rank_grid",
           "require_group", "shard_rank"]
