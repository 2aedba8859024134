"""Seeded fault injection and the stall watchdog; the port's copy of
``repro/runtime/faults.py`` (standard library only).

A :class:`FaultPlan` is a seeded, replayable schedule of failures wired
through named fault points across the stack, so a chaos test reproduces the
same failure sequence on every run.  The points (:data:`FAULT_POINTS`) and
their semantics are the reference's, letter for letter:

* ``synth.compile``   — transient build failure in ``synthesize()`` (the
  retry/backoff and kernel → eager → ref fallback chain);
* ``decode.dispatch`` — transient dispatch error in the decode tick (the
  server retries the tick; the watchdog bounds a livelock);
* ``decode.nan_logits`` / ``decode.nan_carry`` — NaN/Inf written into one
  live slot's logits or cache carry (per-slot detection and quarantine);
* ``prefix.splice``   — a prefix-cache checkpoint corrupted at splice time;
* ``tick.slow``       — wall-clock delay injected into a tick;
* ``rtlsim.seu``      — a single-event-upset bit flip in an rtlsim state
  register (``codegen/rtlsim.simulate`` consults it once a step).

Determinism: each point owns a ``random.Random`` stream derived from
``(plan.seed, point name)``, and rules fire on a per-point opportunity
counter, so the same workload against the same plan injects the same faults
as the reference's plan does.

Only an injected fault (a :class:`FaultError`) may degrade or quarantine
anything: a real build or launch failure on the card always raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
import zlib

# ---------------------------------------------------------------------------
# Fault-point registry: name -> (layer, injected effect, expected outcome)
# ---------------------------------------------------------------------------

FAULT_POINTS: dict[str, tuple[str, str, str]] = {
    "synth.compile": (
        "core/synthesis",
        "raise TransientFault from the backend compile step",
        "bounded retry/backoff, then fallback down the kernel->eager->ref "
        "chain (synth_retries / synth_fallback counters)"),
    "decode.dispatch": (
        "runtime/server",
        "raise TransientFault at the decode dispatch",
        "tick aborted and retried next tick (decode_dispatch_retries); "
        "a permanent fault is bounded by the stall watchdog"),
    "decode.nan_logits": (
        "runtime/server",
        "NaN/Inf written into one live slot's logits",
        "that slot quarantined with finish_reason='error:nonfinite'; "
        "all other slots bit-identical to a fault-free run"),
    "decode.nan_carry": (
        "runtime/server",
        "NaN/Inf written into one live slot's cache/recurrent carry",
        "non-finite logits detected next dispatch; slot quarantined and "
        "scrubbed; survivors bit-identical"),
    "prefix.splice": (
        "runtime/server + prefix_cache",
        "spliced prefix-cache checkpoint corrupted with NaN/Inf",
        "the admitted slot is quarantined by non-finite detection"),
    "tick.slow": (
        "runtime/server",
        "wall-clock sleep injected into the scheduling tick",
        "latency only; a stall beyond the bound trips the watchdog"),
    "rtlsim.seu": (
        "codegen/rtlsim",
        "single-event-upset bit flip in a state register word",
        "output words diverge from the fixed-point golden model; the flip "
        "is recorded in RtlSimResult.seu_flips"),
}


class FaultError(RuntimeError):
    """Base class for injected (and injected-style) failures."""


class TransientFault(FaultError):
    """A failure the caller is expected to retry or degrade around."""


@dataclasses.dataclass
class FaultSpec:
    """One injection rule.  ``prob`` fires per *opportunity* (a call site
    consulting the point), ``after`` skips the first N opportunities, and
    ``times`` bounds total fires (None = unlimited — pair with a watchdog)."""

    point: str
    prob: float = 1.0
    times: int | None = 1
    after: int = 0
    delay_s: float = 0.0        # tick.slow: injected sleep
    mode: str = "nan"           # poison points: "nan" | "inf"
    payload: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.point not in FAULT_POINTS:
            raise ValueError(
                f"unknown fault point '{self.point}'; registered points: "
                f"{sorted(FAULT_POINTS)}")


class FaultPlan:
    """A seeded, replayable schedule of failures.

    >>> plan = FaultPlan([FaultSpec("decode.nan_logits", after=2)], seed=7)
    >>> with faults.active(plan): server.run_until_drained()

    Thread-safe; per-point deterministic RNG streams; ``report()`` returns
    the opportunity/fire counts the chaos harness asserts on ("every fault
    class >= 1 hit").
    """

    def __init__(self, specs: list[FaultSpec] | None = None, seed: int = 0):
        self.seed = int(seed)
        self.specs = list(specs or [])
        self._by_point: dict[str, list[FaultSpec]] = {}
        for s in self.specs:
            self._by_point.setdefault(s.point, []).append(s)
        self._lock = threading.Lock()
        self._opportunities: dict[str, int] = {}
        self._fires: dict[str, int] = {}
        self._rngs: dict[str, "_Random"] = {}

    # -- deterministic per-point randomness ---------------------------------

    def rng(self, point: str):
        """The point's private ``random.Random`` (payload choices — target
        slot, bit index — draw from here so they replay too)."""
        r = self._rngs.get(point)
        if r is None:
            import random

            r = self._rngs[point] = random.Random(
                (self.seed << 32) ^ zlib.crc32(point.encode()))
        return r

    # -- firing -------------------------------------------------------------

    def watches(self, point: str) -> bool:
        """True if any rule targets ``point`` (cheap pre-check for hot
        paths — e.g. the rtlsim inner loop skips fire() entirely)."""
        return point in self._by_point

    def fire(self, point: str) -> FaultSpec | None:
        """Consult the plan at an opportunity.  Returns the matched rule if
        a fault fires here, else None.  Counts either way."""
        rules = self._by_point.get(point)
        with self._lock:
            n = self._opportunities[point] = \
                self._opportunities.get(point, 0) + 1
            if not rules:
                return None
            for spec in rules:
                fired = self._fires.get(id(spec), 0)
                if n <= spec.after:
                    continue
                if spec.times is not None and fired >= spec.times:
                    continue
                if spec.prob < 1.0 and self.rng(point).random() >= spec.prob:
                    continue
                self._fires[id(spec)] = fired + 1
                self._fires[point] = self._fires.get(point, 0) + 1
                return spec
        return None

    def maybe_raise(self, point: str,
                    exc: type[FaultError] = TransientFault) -> None:
        spec = self.fire(point)
        if spec is not None:
            raise exc(f"injected fault at '{point}' "
                      f"(plan seed={self.seed})")

    # -- accounting ---------------------------------------------------------

    @property
    def hits(self) -> dict[str, int]:
        """point -> total fires (points with rules only)."""
        with self._lock:
            return {p: self._fires.get(p, 0) for p in self._by_point}

    def report(self) -> dict:
        with self._lock:
            return {
                "seed": self.seed,
                "points": {
                    p: {"opportunities": self._opportunities.get(p, 0),
                        "fires": self._fires.get(p, 0)}
                    for p in sorted(set(self._by_point)
                                    | set(self._opportunities))},
            }


# ---------------------------------------------------------------------------
# Ambient plan: process-global, context-manager scoped
# ---------------------------------------------------------------------------

_ACTIVE: FaultPlan | None = None


def install(plan: FaultPlan | None) -> None:
    """Set (or clear, with None) the process-ambient fault plan.  Components
    without an explicit ``faults=`` argument consult this one."""
    global _ACTIVE
    _ACTIVE = plan


def get_plan() -> FaultPlan | None:
    return _ACTIVE


@contextlib.contextmanager
def active(plan: FaultPlan | None):
    """Scoped ``install()`` — the chaos-test idiom."""
    prev = _ACTIVE
    install(plan)
    try:
        yield plan
    finally:
        install(prev)


def fire(point: str, plan: FaultPlan | None = None) -> FaultSpec | None:
    """Fire against ``plan`` or, when None, the ambient plan.  Free (one
    ``is None`` check) when no plan is installed — the fault-machinery-off
    hot path."""
    p = plan if plan is not None else _ACTIVE
    return p.fire(point) if p is not None else None


def maybe_raise(point: str, plan: FaultPlan | None = None,
                exc: type[FaultError] = TransientFault) -> None:
    p = plan if plan is not None else _ACTIVE
    if p is not None:
        p.maybe_raise(point, exc)


# ---------------------------------------------------------------------------
# Stall watchdog
# ---------------------------------------------------------------------------

class Watchdog:
    """Tick-progress watchdog: fires when wall-clock ``bound_s`` passes with
    work in flight but no retire/decode/prefill progress.

    The owner calls :meth:`progress` whenever forward progress is observed
    and :meth:`stalled` each tick; the *owner* decides the recovery action
    (the DecodeServer does a structured abort of in-flight requests so the
    process never hangs and every request retires with a finish_reason)."""

    def __init__(self, bound_s: float, now: float | None = None):
        if bound_s <= 0:
            raise ValueError(f"watchdog bound must be > 0, got {bound_s}")
        self.bound_s = float(bound_s)
        self.last_progress = time.perf_counter() if now is None else now
        self.fired = 0

    def progress(self, now: float | None = None) -> None:
        self.last_progress = time.perf_counter() if now is None else now

    def idle_s(self, now: float | None = None) -> float:
        return (time.perf_counter() if now is None else now) \
            - self.last_progress

    def stalled(self, now: float | None = None) -> bool:
        return self.idle_s(now) > self.bound_s


__all__ = [
    "FAULT_POINTS",
    "FaultError",
    "FaultPlan",
    "FaultSpec",
    "TransientFault",
    "Watchdog",
    "active",
    "fire",
    "get_plan",
    "install",
    "maybe_raise",
]
