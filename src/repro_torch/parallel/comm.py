"""The port's collectives, each a thin counted wrapper over
``torch.distributed``.

Every collective that the mesh code issues goes through here, and each call
adds one to :data:`COUNTS` under its name, so a test or ``chip_smoke.py``
can hold a forward to its schedule (one ``all_reduce`` per gate contraction
under TP, two ``all_to_all_single`` per MoE layer under EP) the way the
reference counts collectives in its compiled HLO.

Two kinds of group carry them:

* the mesh's own groups (``DeviceMesh.get_group(axis)``): device
  collectives on the mesh's backend, NCCL on cards and gloo on the CPU;
* a gloo group over the mesh's ranks (:func:`control_group`): the serving
  control plane, host tensors only.
"""

from __future__ import annotations

from collections import Counter

import torch
import torch.distributed as dist

COUNTS: Counter = Counter()

_CONTROL_GROUPS: dict[tuple[int, ...], object] = {}


def reset_counts() -> None:
    COUNTS.clear()


def all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """In-place sum over ``group``."""
    COUNTS["all_reduce"] += 1
    dist.all_reduce(t, group=group)
    return t


def all_to_all_single(out: torch.Tensor, inp: torch.Tensor, group=None) -> torch.Tensor:
    """Equal splits of ``inp``'s dim 0 to every rank of ``group``."""
    COUNTS["all_to_all_single"] += 1
    dist.all_to_all_single(out, inp, group=group)
    return out


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """``[n, ...]`` from every rank → ``[world·n, ...]`` in rank order."""
    COUNTS["all_gather"] += 1
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts)


def broadcast(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """In place from global rank ``src``."""
    COUNTS["broadcast"] += 1
    dist.broadcast(t, src, group=group)
    return t


def _join_exact(local: torch.Tensor, index: int, count: int, group) -> torch.Tensor:
    """``count`` equal row blocks, block ``index`` from this rank, joined
    along dim 0, bit for bit (:func:`sum_exact` of the blocks, each rank's
    in its place and zeros elsewhere)."""
    n = local.shape[0]
    full = torch.zeros((count * n,) + tuple(local.shape[1:]), dtype=local.dtype,
                       device=local.device)
    full[index * n:(index + 1) * n] = local
    sum_exact(full, group)
    return full


def sum_exact(t: torch.Tensor, group=None) -> torch.Tensor:
    """In-place integer sum of ``t``'s bit patterns over ``group`` (not
    counted: the callers count what it carries).  Where at most one rank
    holds a nonzero value at each element, every rank ends with that
    value's bits: every backend sums integers on every device (gloo has no
    ``all_gather`` and no ``send``/``recv`` for CUDA tensors), and an
    integer sum with zeros returns the bits it was given."""
    bits = {4: torch.int32, 8: torch.int64}.get(t.element_size(), torch.uint8)
    dist.all_reduce(t.view(-1).view(bits), group=group)
    return t


def gather_rows_exact(local: torch.Tensor, index: int, count: int, group=None) -> torch.Tensor:
    """``count`` equal row blocks, block ``index`` from this rank, joined
    along dim 0 on every rank, bit for bit (counted as ``gather_rows``)."""
    COUNTS["gather_rows"] += 1
    return _join_exact(local, index, count, group)


def ppermute(t: torch.Tensor, shift: int = 1, group=None) -> torch.Tensor:
    """The ring transfer of ``group`` (counted as ``ppermute``): rank ``i``'s
    ``t`` arrives at rank ``(i + shift) % n``, and this rank gets rank
    ``(i - shift) % n``'s, bit for bit."""
    COUNTS["ppermute"] += 1
    n, r = dist.get_world_size(group), dist.get_rank(group)
    return _join_exact(t[None], r, n, group)[(r - shift) % n]


def all_reduce_max(t: torch.Tensor, group=None) -> torch.Tensor:
    """The elementwise max of ``t`` over ``group`` (counted as
    ``all_reduce_max``): every rank's values joined bit for bit, then the
    max taken locally, so no backend's ``MAX`` on device tensors is
    needed."""
    COUNTS["all_reduce_max"] += 1
    n, r = dist.get_world_size(group), dist.get_rank(group)
    return _join_exact(t.reshape(1, -1), r, n, group).amax(0).reshape(t.shape)


def all_reduce_typed(t: torch.Tensor, group=None) -> torch.Tensor:
    """In-place sum over ``group``, counted as ``all_reduce_<dtype>``: the
    count names the type that crossed the wire (the compressed all-reduce's
    int32 codes)."""
    COUNTS["all_reduce_" + str(t.dtype).removeprefix("torch.")] += 1
    dist.all_reduce(t, group=group)
    return t


def control_group(ranks: tuple[int, ...]):
    """A gloo group over ``ranks`` for host tensors: the default group when
    it is gloo and holds exactly these ranks, else one made once per rank
    set.  ``new_group`` is collective over the default group, so every rank
    reaches the first call for a rank set at the same point."""
    ranks = tuple(ranks)
    if dist.get_backend() == "gloo" and ranks == tuple(range(dist.get_world_size())):
        return None
    if ranks not in _CONTROL_GROUPS:
        _CONTROL_GROUPS[ranks] = dist.new_group(list(ranks), backend="gloo")
    return _CONTROL_GROUPS[ranks]


__all__ = ["COUNTS", "all_gather", "all_reduce", "all_reduce_max", "all_reduce_typed",
           "all_to_all_single", "broadcast", "control_group", "gather_rows_exact", "ppermute",
           "reset_counts", "sum_exact"]
