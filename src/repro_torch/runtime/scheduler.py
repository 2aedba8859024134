"""Request scheduler: priority classes, fairness aging, admission control;
the port's copy of ``repro/runtime/scheduler.py`` (pure Python).

* **priority classes** — smaller = more urgent; each class keeps FIFO order,
  so the per-class head is always that class's best candidate;
* **fairness aging** — a request's effective priority improves linearly with
  queue wait (``aging_rate`` classes/second), so batch traffic cannot starve
  behind a stream of interactive requests, and vice versa;
* **admission control** — bounded queue depth and prompt-length validation
  (reject or truncate, with the reason recorded on the request) at submit
  time, before any device work is spent; optional load shedding.

The scheduler is synchronous and tick-driven: the server asks for the next
admissible request whenever a slot frees up.  :class:`AsyncServer` wraps a
``DecodeServer`` into an asyncio front-end whose ticks run on a background
thread of its own: ``await generate(req)`` resolves when the request retires.
Mesh placement (``record_placement``) is not ported yet.
"""

from __future__ import annotations

import asyncio
import dataclasses
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import TYPE_CHECKING

from repro_torch.obs import MetricsRegistry

if TYPE_CHECKING:  # pragma: no cover
    from .server import DecodeServer, Request


REJECT_QUEUE_FULL = "queue_full"
REJECT_EMPTY_PROMPT = "empty_prompt"
REJECT_PROMPT_TOO_LONG = "prompt_too_long"
REJECT_SHED = "shed"
REJECT_DUPLICATE_UID = "duplicate_uid"

# dispatch-interval samples kept for the load-shedding service-rate estimate
_RATE_WINDOW = 32


@dataclasses.dataclass
class SchedulerConfig:
    policy: str = "priority"        # "priority" | "fifo"
    max_queue: int = 0              # admission bound; 0 = unbounded
    aging_rate: float = 1.0         # priority classes gained per second waited
    overflow: str = "reject"        # over-length prompts: "reject" | "truncate"
    max_prompt_tokens: int = 0      # 0 = use the server's max_seq - 1
    # Load shedding: when True, (a) a full queue evicts the lowest-priority
    # queued request instead of bouncing a more urgent newcomer, and (b) a
    # deadline-carrying request whose predicted queue wait already exceeds
    # its deadline is rejected at admission.
    shed: bool = False


class Scheduler:
    """Priority/aging queue with admission control.  Counters live in a
    :class:`~repro_torch.obs.MetricsRegistry` (pass the owning server's to
    share one accounting scope); :meth:`telemetry` is a view over it."""

    def __init__(self, cfg: SchedulerConfig | None = None,
                 prompt_limit: int = 0,
                 metrics: MetricsRegistry | None = None):
        self.cfg = cfg or SchedulerConfig()
        self.prompt_limit = self.cfg.max_prompt_tokens or prompt_limit
        self._queues: dict[int, deque] = {}
        self._size = 0
        self._evicted: list = []            # shed victims awaiting retirement
        self._dispatch_marks: deque = deque(maxlen=_RATE_WINDOW)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        m = self.metrics
        self._c_submitted = m.counter("sched_submitted", "requests offered")
        self._c_admitted = m.counter("sched_admitted", "requests enqueued")
        self._c_truncated = m.counter("sched_truncated",
                                      "over-length prompts cut to the limit")
        self._c_dispatched = m.counter("sched_dispatched",
                                       "requests handed to a slot")
        self._g_max_wait = m.gauge("sched_max_wait_s",
                                   "worst queue wait since reset")
        self._g_pending = m.gauge("sched_pending", "requests queued")

    # -- admission ---------------------------------------------------------

    def admit(self, req: "Request", now: float | None = None) -> tuple[bool, str | None]:
        """Validate and enqueue.  Returns (admitted, reject_reason)."""
        now = now if now is not None else time.perf_counter()
        if req.deadline_s is not None and req.deadline_at is None:
            req.deadline_at = now + req.deadline_s
        self._c_submitted.inc()
        reason = None
        if not req.prompt:
            reason = REJECT_EMPTY_PROMPT
        elif self.cfg.max_queue and self._size >= self.cfg.max_queue:
            if not (self.cfg.shed and self._shed_for(req, now)):
                reason = REJECT_QUEUE_FULL
        elif self.cfg.shed and self._unserviceable(req, now):
            reason = REJECT_SHED
        if reason is None and self.prompt_limit \
                and len(req.prompt) > self.prompt_limit:
            if self.cfg.overflow == "truncate":
                req.prompt = req.prompt[: self.prompt_limit]
                req.truncated = True
                self._c_truncated.inc()
            else:
                reason = REJECT_PROMPT_TOO_LONG
        if reason is not None:
            self.metrics.counter("sched_rejected", "admission rejections",
                                 reason=reason).inc()
            req.finish_reason = f"rejected:{reason}"
            return False, reason
        self._c_admitted.inc()
        req.submitted_at = now
        self._queues.setdefault(int(req.priority), deque()).append(req)
        self._size += 1
        self._g_pending.set(self._size)
        return True, None

    # -- load shedding ------------------------------------------------------

    def service_estimate_s(self) -> float | None:
        """Observed mean dispatch interval (None until 2+ dispatches)."""
        marks = self._dispatch_marks
        if len(marks) < 2:
            return None
        return (marks[-1] - marks[0]) / (len(marks) - 1)

    def _unserviceable(self, req: "Request", now: float) -> bool:
        """The newcomer's predicted queue wait (requests ahead × observed
        dispatch interval) already exceeds its remaining deadline."""
        if req.deadline_at is None:
            return False
        est = self.service_estimate_s()
        if est is None:
            return False
        return now + self._size * est > req.deadline_at

    def _shed_for(self, req: "Request", now: float) -> bool:
        """Queue full: evict the least-urgent queued request iff the
        newcomer is strictly more urgent (aging-adjusted).  Returns True
        when a place was made."""
        victim_cls = max((c for c, q in self._queues.items() if q),
                         default=None)
        if victim_cls is None:
            return False
        victim = self._queues[victim_cls][-1]   # youngest of the worst class
        if self._effective(req, now) >= self._effective(victim, now):
            return False
        self._queues[victim_cls].pop()
        self._size -= 1
        victim.finish_reason = f"rejected:{REJECT_SHED}"
        self.metrics.counter("sched_rejected", "admission rejections",
                             reason=REJECT_SHED).inc()
        self._evicted.append(victim)
        return True

    def drain_evicted(self) -> list:
        """Shed victims since the last drain — the owner retires them."""
        out, self._evicted = self._evicted, []
        return out

    # -- deadline reaping / cancellation ------------------------------------

    def reap_expired(self, now: float | None = None) -> list:
        """Remove and return every queued request whose deadline passed."""
        now = now if now is not None else time.perf_counter()
        reaped: list = []
        for q in self._queues.values():
            keep = []
            for r in q:
                if r.deadline_at is not None and now >= r.deadline_at:
                    reaped.append(r)
                else:
                    keep.append(r)
            if len(keep) != len(q):
                q.clear()
                q.extend(keep)
        if reaped:
            self._size -= len(reaped)
            self._g_pending.set(self._size)
        return reaped

    def remove(self, uid: int) -> "Request | None":
        """Pull a queued request by uid; None if the uid is not queued."""
        for q in self._queues.values():
            for r in q:
                if r.uid == uid:
                    q.remove(r)
                    self._size -= 1
                    self._g_pending.set(self._size)
                    return r
        return None

    # -- dispatch ----------------------------------------------------------

    def _effective(self, req: "Request", now: float) -> float:
        if self.cfg.policy == "fifo":
            return req.submitted_at
        return req.priority - self.cfg.aging_rate * (now - req.submitted_at)

    def next_request(self, now: float | None = None) -> "Request | None":
        """Pop the best head across classes (aging-adjusted priority; FIFO
        within a class, and FIFO overall under policy="fifo")."""
        if not self._size:
            return None
        now = now if now is not None else time.perf_counter()
        best_cls = min(
            (c for c, q in self._queues.items() if q),
            key=lambda c: (self._effective(self._queues[c][0], now),
                           self._queues[c][0].submitted_at),
        )
        req = self._queues[best_cls].popleft()
        self._size -= 1
        self._g_pending.set(self._size)
        self._c_dispatched.inc()
        self._g_max_wait.set_max(now - req.submitted_at)
        self._dispatch_marks.append(now)
        req.dispatched_at = now
        return req

    def __len__(self) -> int:
        return self._size

    @property
    def stats(self) -> dict:
        return {
            "submitted": self._c_submitted.value,
            "admitted": self._c_admitted.value,
            "rejected": {c.labels["reason"]: c.value
                         for c in self.metrics.children("sched_rejected")
                         if c.value},
            "truncated": self._c_truncated.value,
            "dispatched": self._c_dispatched.value,
            "max_wait_s": self._g_max_wait.value,
        }

    def telemetry(self) -> dict:
        return dict(self.stats, pending=self._size,
                    policy=self.cfg.policy, aging_rate=self.cfg.aging_rate)

    def reset_stats(self) -> None:
        """Zero the counters (queue contents are untouched)."""
        self.metrics.reset()
        self._g_pending.set(self._size)


class AsyncServer:
    """asyncio front-end over a :class:`DecodeServer`; the port's
    counterpart of the reference's ``AsyncServer``.

    Submissions arrive concurrently (``await generate(req)``).  One drive
    task advances the server one tick at a time; a tick is one bounded unit
    of device work (at most the prefill chunks of a tick and one decode
    dispatch).  Every call into the server (``submit``, ``cancel``, ``tick``)
    runs on one background tick thread of this front-end's own, which keeps
    the server to one thread and the event loop free while the card works:
    a ``generate()`` that arrives during a tick awaits it, and never blocks
    the loop.  Kernel host round-trips are counted per thread, so each
    server's ``prefill_kernel_syncs`` stays its own when several front-ends
    run at once.

    Cancellation: :meth:`cancel` retires an in-flight request with
    ``finish_reason="cancelled"``, and cancelling the task awaiting
    ``generate()`` cancels the request in the server too.  A uid already
    awaited fails fast with ``rejected:duplicate_uid`` and never reaches the
    server.  :meth:`close` stops the tick thread.
    """

    def __init__(self, server: "DecodeServer", idle_sleep: float = 0.001):
        self.server = server
        self.idle_sleep = idle_sleep
        # uid -> (future, the exact Request it awaits): _collect checks the
        # identity, so a request reusing a retired uid never resolves a
        # stranger's future
        self._futures: dict[int, tuple[asyncio.Future, "Request"]] = {}
        self._drained = 0            # completed-list watermark
        self._drive_task: asyncio.Task | None = None
        self._thread = ThreadPoolExecutor(max_workers=1, thread_name_prefix="decode-ticks")

    def _collect(self) -> None:
        """Resolve the futures of newly retired requests (event-loop thread).
        The tick thread only appends to ``completed``, and a slice of a list
        is taken whole, so nothing retired is skipped."""
        new = self.server.completed[self._drained:]
        self._drained += len(new)
        for req in new:
            pair = self._futures.get(req.uid)
            if pair is not None and pair[1] is req:
                self._futures.pop(req.uid)
                if not pair[0].done():
                    pair[0].set_result(req)

    async def _on_thread(self, fn, *args):
        """Run a call into the server on the tick thread, then collect."""
        out = await asyncio.get_running_loop().run_in_executor(self._thread, fn, *args)
        self._collect()
        return out

    async def generate(self, req: "Request") -> "Request":
        if req.uid in self._futures:
            now = time.perf_counter()
            req.submitted_at = req.submitted_at or now
            req.done_at = req.retired_at = now
            req.finish_reason = f"rejected:{REJECT_DUPLICATE_UID}"
            self.server.obs.metrics.counter(
                "requests_completed", "retired requests by finish reason",
                reason="rejected").inc()
            return req
        fut = asyncio.get_running_loop().create_future()
        self._futures[req.uid] = (fut, req)
        try:
            await self._on_thread(self.server.submit, req)  # an instant rejection resolves
            if self._drive_task is None or self._drive_task.done():
                self._drive_task = asyncio.ensure_future(self._drive())
            return await fut
        except asyncio.CancelledError:
            # the awaiting task's cancellation reaches the server: free the
            # slot or queue entry now instead of decoding to max_tokens
            await self._on_thread(self.server.cancel, req.uid)
            raise

    def cancel(self, uid: int) -> bool:
        """Cancel an in-flight request by uid.  Returns True if found; the
        awaiting ``generate()`` resolves with the retired request
        (``finish_reason="cancelled"``).  The answer needs the server, so
        this waits for a running tick to end."""
        found = self._thread.submit(self.server.cancel, uid).result()
        self._collect()
        return found

    async def _drive(self) -> None:
        try:
            while self._futures:
                busy = await self._on_thread(self.server.tick)
                await asyncio.sleep(0 if busy else self.idle_sleep)
        except BaseException as exc:  # noqa: BLE001 — every waiter learns that the ticks died
            for fut, _req in self._futures.values():
                if not fut.done():
                    fut.set_exception(exc)
            self._futures.clear()
            raise

    def close(self) -> None:
        """Stop the tick thread (after the tick it may be running)."""
        self._thread.shutdown(wait=True)


__all__ = [
    "AsyncServer",
    "REJECT_DUPLICATE_UID",
    "REJECT_EMPTY_PROMPT",
    "REJECT_PROMPT_TOO_LONG",
    "REJECT_QUEUE_FULL",
    "REJECT_SHED",
    "Scheduler",
    "SchedulerConfig",
]
