"""What one traced step costs; the port's counterpart of the role of
``repro/launch/hlo_analysis.py``.

The reference compiles a step and parses its optimized HLO: it splits the
module into computations, multiplies each by its while loops' trip counts,
counts dot and convolution FLOPs from operand shapes, models HBM traffic as
the operand and result bytes of the ops a TPU compiler would not fuse, and
sums the collectives' payloads by kind.  The port has no HLO: a step runs
eagerly, and the dry run runs it on fake tensors (``FakeTensorMode``:
shapes, dtypes and devices, no storage and no arithmetic).  :func:`trace`
watches the ops that one call dispatches, so nothing is parsed:

* **FLOPs** from ``torch.utils.flop_counter.FlopCounterMode``, which
  counts the matmul-class ops (``mm``, ``bmm``, ``addmm``, ``baddbmm``,
  convolution, attention), as ``hlo_analysis._dot_flops`` counts dot and
  convolution only;
* **bytes accessed**: input plus output bytes of every op that is not a
  view, an empty allocation or a collective (eager PyTorch fuses nothing,
  so this is the traffic of the eager step); **memory traffic**: the same
  without the pointwise ops, the ones ``hlo_analysis._FUSIBLE_OPS`` leaves
  out because a compiler fuses them into their neighbours;
* **the peak of live bytes** from ``torch.distributed._tools.mem_tracker.
  MemTracker`` (which runs under ``FakeTensorMode``), the step's arguments
  included;
* **collectives by kind**, with count and bytes per rank, from
  ``parallel.comm``'s counters: the same counters a real run reads.

What does not carry over: an eager trace is unrolled, so there are no
while loops and no trip counts (the reference's ``while_trips``), and no
HLO text, generated code or aliasing to measure.
"""

from __future__ import annotations

import dataclasses
import time
from fractions import Fraction
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch._tree import tree_leaves
from repro_torch.parallel import comm

_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided",
               "detach", "alias", "lift_fresh", "_local_scalar_dense", "set_", "resize_"}


def tensor_bytes(tree: Any) -> int:
    """The bytes of the tensors of a tree (dicts, lists, tuples)."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _op_bytes(values) -> int:
    total = 0
    for v in values:
        if isinstance(v, torch.Tensor):
            total += v.numel() * v.element_size()
        elif isinstance(v, (list, tuple)):
            total += _op_bytes(v)
    return total


class _Traffic(TorchDispatchMode):
    """Input plus output bytes of each dispatched op that moves memory."""

    def __init__(self):
        super().__init__()
        self.bytes_accessed = 0
        self.memory_traffic = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        schema = func._schema
        view = any(r.alias_info is not None and not r.alias_info.is_write
                   for r in schema.returns)
        if view or func.namespace == "c10d" or func.name().split("::")[-1].split(".")[0] \
                in _NO_TRAFFIC:
            return out
        n = _op_bytes(args) + _op_bytes(kwargs.values()) + _op_bytes(
            out if isinstance(out, (list, tuple)) else (out,))
        self.bytes_accessed += n
        if torch.Tag.pointwise not in func.tags:
            self.memory_traffic += n
        return out


@dataclasses.dataclass
class TraceStats:
    """One traced call, per rank."""

    flops: float                # matmul-class FLOPs (FlopCounterMode)
    bytes_accessed: float       # every non-view op's inputs + outputs
    memory_traffic: float       # the same without the pointwise ops
    peak_bytes: int             # the most bytes live at once, arguments included
    argument_bytes: int
    output_bytes: int
    collectives: dict           # kind -> {"count", "bytes"}
    seconds: float              # the trace's wall time

    @property
    def temp_bytes(self) -> int:
        """The peak beyond the arguments and the outputs, as XLA's
        ``memory_analysis`` splits its peak into the three."""
        return max(0, self.peak_bytes - self.argument_bytes - self.output_bytes)


def extrapolate(stats: list[TraceStats], lengths: list[int], x: int) -> TraceStats:
    """The stats at length ``x`` of a call whose figures are polynomials in
    its length of degree < ``len(lengths)``, from traces at ``lengths``
    (Lagrange's form, in exact rationals): the port's counterpart of
    multiplying a loop body by its trip count.  A Python loop over time
    makes FLOPs linear in the length and, through the
    backward of each step's slice (a zero-filled gradient of the whole
    sequence), memory traffic quadratic.  The peak is a max over the
    call's moments, not a polynomial: it is extended along the line
    through the two longest traces, which is exact once the bytes that
    grow with the length lead at both, and low where they overtake the
    fixed bytes only past the traced lengths."""
    def weights(xs):
        out = []
        for i, xi in enumerate(xs):
            w = Fraction(1)
            for j, xj in enumerate(xs):
                if j != i:
                    w *= Fraction(x - xj, xi - xj)
            out.append(w)
        return out

    def at(values, ws=weights(lengths)) -> int:
        return int(round(sum(w * int(v) for w, v in zip(ws, values))))

    field = lambda name: at([getattr(st, name) for st in stats])  # noqa: E731
    kinds = sorted({k for st in stats for k in st.collectives})
    zero = {"count": 0, "bytes": 0}
    return TraceStats(
        flops=float(field("flops")), bytes_accessed=float(field("bytes_accessed")),
        memory_traffic=float(field("memory_traffic")),
        peak_bytes=at([st.peak_bytes for st in stats[-2:]], weights(lengths[-2:])),
        argument_bytes=field("argument_bytes"), output_bytes=field("output_bytes"),
        collectives={k: {f: at([st.collectives.get(k, zero)[f] for st in stats])
                         for f in ("count", "bytes")} for k in kinds},
        seconds=sum(st.seconds for st in stats))


def trace(fn: Callable, args: tuple) -> tuple[Any, TraceStats]:
    """``fn(*args)`` once, watched: its result and its :class:`TraceStats`.
    The collectives are those counted during the call (the counters are
    reset first).  Run it on fake tensors for a dry run, or on real ones."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode

    arg_tensors = [t for t in tree_leaves(args) if isinstance(t, torch.Tensor)]
    mem = MemTracker()
    mem.track_external(*arg_tensors)
    flops = FlopCounterMode(display=False)
    traffic = _Traffic()
    comm.reset_counts()
    t0 = time.perf_counter()
    with flops, mem, traffic:
        out = fn(*args)
    seconds = time.perf_counter() - t0
    peak = sum(int(v["Total"]) for v in mem.get_tracker_snapshot("peak").values())
    return out, TraceStats(
        flops=float(flops.get_total_flops()), bytes_accessed=float(traffic.bytes_accessed),
        memory_traffic=float(traffic.memory_traffic), peak_bytes=peak,
        argument_bytes=tensor_bytes(args), output_bytes=tensor_bytes(out),
        collectives=comm.counters(), seconds=seconds)


__all__ = ["TraceStats", "extrapolate", "tensor_bytes", "trace"]
