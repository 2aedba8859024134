"""The port's collectives, each a thin counted wrapper over
``torch.distributed``.

Every collective that the mesh code issues goes through here, and each call
adds one to :data:`COUNTS` under its name and its payload to :data:`BYTES`
under the same name, so a test or ``chip_smoke.py`` can hold a forward to
its schedule (one ``all_reduce`` per gate contraction under TP, two
``all_to_all_single`` per MoE layer under EP) the way the reference counts
collectives in its compiled HLO.  A payload is the bytes of the result this
rank gets, as the reference's ``collective_stats`` sums an HLO
collective's result shape: the reduced tensor, the joined rows, the
exchanged slots.  The dry run (``launch/dryrun.py``) reads the same two
counters, so its collectives and a real run's are one measurement.

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
BYTES: Counter = Counter()

_CONTROL_GROUPS: dict[tuple[int, ...], object] = {}


def reset_counts() -> None:
    COUNTS.clear()
    BYTES.clear()


def record(kind: str, nbytes: int) -> None:
    """Count one collective of ``kind`` carrying ``nbytes`` to this rank."""
    COUNTS[kind] += 1
    BYTES[kind] += int(nbytes)


def counters() -> dict[str, dict[str, int]]:
    """``{kind: {"count", "bytes"}}`` of what the counters hold."""
    return {k: {"count": int(COUNTS[k]), "bytes": int(BYTES[k])} for k in sorted(COUNTS)}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """In-place sum over ``group``."""
    record("all_reduce", _nbytes(t))
    dist.all_reduce(t, group=group)
    return t


def all_to_all_single(out: torch.Tensor, inp: torch.Tensor, group=None) -> torch.Tensor:
    """Equal splits of ``inp``'s dim 0 to every rank of ``group``."""
    record("all_to_all_single", _nbytes(out))
    dist.all_to_all_single(out, inp, group=group)
    return out


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """``[n, ...]`` from every rank → ``[world·n, ...]`` in rank order."""
    record("all_gather", _nbytes(t) * dist.get_world_size(group))
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts)


def broadcast(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """In place from global rank ``src``."""
    record("broadcast", _nbytes(t))
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


def gather_rows_exact(local: torch.Tensor, index: int, count: int, group=None, *,
                      kind: str = "gather_rows") -> torch.Tensor:
    """``count`` equal row blocks, block ``index`` from this rank, joined
    along dim 0 on every rank, bit for bit (counted as ``kind``)."""
    full = _join_exact(local, index, count, group)
    record(kind, _nbytes(full))
    return full


class _GatherRows(torch.autograd.Function):
    """:func:`gather_rows_exact` with its adjoint as the backward."""

    @staticmethod
    def forward(ctx, local, index, count, group):
        ctx.rows, ctx.index, ctx.group = local.shape[0], index, group
        return gather_rows_exact(local, index, count, group)

    @staticmethod
    def backward(ctx, grad):
        total = all_reduce(grad.contiguous().clone(), ctx.group)
        n, i = ctx.rows, ctx.index
        return total[i * n:(i + 1) * n], None, None, None


def gather_rows_grad(local: torch.Tensor, index: int, count: int, group=None) -> torch.Tensor:
    """:func:`gather_rows_exact` on the autograd path: its backward sums
    the incoming gradient over the ranks (an ``all_reduce``) and keeps this
    rank's rows, the adjoint of the join."""
    return _GatherRows.apply(local, index, count, group)


def ppermute(t: torch.Tensor, shift: int = 1, group=None) -> torch.Tensor:
    """The ring transfer of ``group`` (counted as ``ppermute``): rank ``i``'s
    ``t`` arrives at rank ``(i + shift) % n``, and this rank gets rank
    ``(i - shift) % n``'s, bit for bit."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    full = _join_exact(t[None], r, n, group)
    record("ppermute", _nbytes(full))
    return full[(r - shift) % n]


def all_reduce_max(t: torch.Tensor, group=None) -> torch.Tensor:
    """The elementwise max of ``t`` over ``group`` (counted as
    ``all_reduce_max``): every rank's values joined bit for bit, then the
    max taken locally, so no backend's ``MAX`` on device tensors is
    needed."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    full = _join_exact(t.reshape(1, -1), r, n, group)
    record("all_reduce_max", _nbytes(full))
    return full.amax(0).reshape(t.shape)


def all_reduce_typed(t: torch.Tensor, group=None) -> torch.Tensor:
    """In-place sum over ``group``, counted as ``all_reduce_<dtype>``: the
    count names the type that crossed the wire (the compressed all-reduce's
    int32 codes)."""
    record("all_reduce_" + str(t.dtype).removeprefix("torch."), _nbytes(t))
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


__all__ = ["BYTES", "COUNTS", "all_gather", "all_reduce", "all_reduce_max", "all_reduce_typed",
           "all_to_all_single", "broadcast", "control_group", "counters", "gather_rows_exact", "gather_rows_grad", "ppermute",
           "record", "reset_counts", "sum_exact"]
