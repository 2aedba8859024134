"""Span tracing with Chrome-trace-event / Perfetto JSON export.

The tracer records *host-side* structure only: dispatch boundaries, device
syncs, compile phases, per-request lifecycles.  Spans wrap the launch of
device work, never the math: the host clock only sees when work was
enqueued, and a ``device_sync`` span marks where the host waited for it.
(A copy of the JAX package's ``obs/trace.py``; the event format is the same.)

Disabled (the default) is a near-no-op: ``span()`` returns a shared null
context manager after one attribute check, and every other record method
returns after the same check — no allocation, no locking, no clock read.

Export is the Chrome trace-event JSON array format (``{"traceEvents":
[...]}``), loadable in Perfetto (https://ui.perfetto.dev) and
``chrome://tracing``.  Track conventions:

* ``tid 0`` — the server/process track: ``decode_step`` / ``decode_block``
  ticks, ``prefill_chunk``, ``device_sync``, compile spans;
* ``tid uid+1`` — one track per request, written retroactively at retire
  time (the host cannot observe a request's inner ticks without the very
  syncs the persistent path removes): a ``request`` span containing
  ``queue_wait`` → ``prefill`` → ``decode`` children.  Parent/child nesting
  is by timestamp containment on the same track, per the trace-event spec.

Timestamps are microseconds on the ``time.perf_counter`` clock, zeroed at
tracer construction; ``to_us()`` converts ``perf_counter()`` stamps taken
elsewhere (e.g. ``Request.submitted_at``) onto the same axis.
"""

from __future__ import annotations

import json
import threading
import time


class _NullSpan:
    """Reusable, reentrant no-op context manager."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


class _Span:
    __slots__ = ("_tr", "name", "cat", "tid", "args", "t0")

    def __init__(self, tr: "Tracer", name: str, cat: str, tid: int, args):
        self._tr, self.name, self.cat, self.tid, self.args = \
            tr, name, cat, tid, args

    def __enter__(self):
        self.t0 = self._tr.now_us()
        return self

    def __exit__(self, *exc):
        tr = self._tr
        tr.complete(self.name, self.t0, tr.now_us() - self.t0,
                    cat=self.cat, tid=self.tid, args=self.args)
        return False


class Tracer:
    def __init__(self, enabled: bool = False, pid: int = 1):
        self.enabled = enabled
        self.pid = pid
        self._lock = threading.Lock()
        self._events: list[dict] = []
        self._t0_ns = time.perf_counter_ns()
        self._named_tids: set[int] = set()

    # -- clock -------------------------------------------------------------

    def now_us(self) -> float:
        return (time.perf_counter_ns() - self._t0_ns) / 1e3

    def to_us(self, t_s: float) -> float:
        """Map a ``time.perf_counter()`` stamp (seconds) onto this tracer's
        microsecond axis (both use the same monotonic clock)."""
        return t_s * 1e6 - self._t0_ns / 1e3

    # -- recording ---------------------------------------------------------

    def _emit(self, ev: dict) -> None:
        with self._lock:
            self._events.append(ev)

    def span(self, name: str, *, cat: str = "repro", tid: int = 0,
             args: dict | None = None):
        """Context manager recording one complete ('X') event."""
        if not self.enabled:
            return _NULL
        return _Span(self, name, cat, tid, args)

    def complete(self, name: str, ts_us: float, dur_us: float, *,
                 cat: str = "repro", tid: int = 0,
                 args: dict | None = None) -> None:
        """Record a complete event with explicit (possibly retroactive)
        timestamps."""
        if not self.enabled:
            return
        ev = {"name": name, "cat": cat, "ph": "X", "pid": self.pid,
              "tid": tid, "ts": ts_us, "dur": max(dur_us, 0.0)}
        if args:
            ev["args"] = args
        self._emit(ev)

    def instant(self, name: str, *, cat: str = "repro", tid: int = 0,
                args: dict | None = None, ts_us: float | None = None) -> None:
        if not self.enabled:
            return
        ev = {"name": name, "cat": cat, "ph": "i", "s": "t", "pid": self.pid,
              "tid": tid, "ts": self.now_us() if ts_us is None else ts_us}
        if args:
            ev["args"] = args
        self._emit(ev)

    def counter(self, name: str, values: dict, *, tid: int = 0,
                ts_us: float | None = None) -> None:
        """Counter ('C') event — Perfetto renders these as stacked series."""
        if not self.enabled:
            return
        self._emit({"name": name, "ph": "C", "pid": self.pid, "tid": tid,
                    "ts": self.now_us() if ts_us is None else ts_us,
                    "args": dict(values)})

    def thread_name(self, tid: int, name: str) -> None:
        """Label a track (idempotent per tid)."""
        if not self.enabled or tid in self._named_tids:
            return
        self._named_tids.add(tid)
        self._emit({"name": "thread_name", "ph": "M", "pid": self.pid,
                    "tid": tid, "ts": 0, "args": {"name": name}})

    # -- lifecycle / export ------------------------------------------------

    def reset(self) -> None:
        with self._lock:
            self._events.clear()
            self._named_tids.clear()
        self._t0_ns = time.perf_counter_ns()

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def export(self, path: str | None = None) -> dict:
        """Chrome-trace JSON document; written to ``path`` when given."""
        doc = {"traceEvents": self.events(), "displayTimeUnit": "ms"}
        if path is not None:
            with open(path, "w") as fh:
                json.dump(doc, fh)
        return doc


__all__ = ["Tracer"]
