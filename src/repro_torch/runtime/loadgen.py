"""Seeded trace-driven load generator for the serving stack; the port's
counterpart of ``repro/runtime/loadgen.py``.

Deterministic open-loop traffic: Poisson arrivals in *tick* units (so a
replay does not depend on the device's speed), a mix of short and long
prompts, and shared-prefix "fleets" (groups of prompts with a common prefix,
the traffic the radix prefix cache exists for), replayed against a
:class:`~repro_torch.runtime.DecodeServer`.  :func:`make_trace` draws from
numpy's ``default_rng`` with the reference's calls in the reference's
order, so a spec gives the reference's trace.

The replay report (``schema: repro.loadgen/v1``, checked by
``python -m repro_torch.obs.check``):

    {"schema": "repro.loadgen/v1",
     "spec": {...TraceSpec...}, "requests": N, "completed": N,
     "by_reason": {"max_tokens": ...}, "ticks": T, "wall_s": s,
     "decoded_tokens": n, "throughput_tok_s": n/s,
     "tokens_digest": "…",            # stable hash over (uid, tokens)
     "mesh": None,                    # single-device server
     "per_shard": [{"shard": 0, "decoded_tokens": …, "dispatched": …,
                    "quarantined": …}]}

``tokens_digest`` makes greedy parity a one-string comparison: across
``step()`` and ``step_block()``, prefill paths, the prefix cache on or off,
and the reference server on the same weights.  ``replay(..., uid_offset=...)`` re-submits the same
prompts under fresh uids: the warm and timed two-pass pattern.
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import asdict, dataclass
from typing import Sequence

import numpy as np
import torch

from .server import DecodeServer, Request

SCHEMA = "repro.loadgen/v1"


@dataclass(frozen=True)
class TraceSpec:
    """Knobs of the synthetic traffic mix.  All randomness flows from
    ``seed``; arrival times are Poisson with mean inter-arrival
    ``mean_interarrival_ticks`` (server ticks, not seconds)."""

    num_requests: int = 32
    mean_interarrival_ticks: float = 0.25
    short_len: tuple[int, int] = (2, 5)      # inclusive-exclusive
    long_len: tuple[int, int] = (12, 20)
    long_frac: float = 0.2
    fleet_frac: float = 0.3                  # share drawn from prefix fleets
    num_fleets: int = 2
    fleet_prefix_len: int = 6
    fleet_suffix_len: tuple[int, int] = (1, 4)
    max_new_tokens: int = 8
    vocab: int = 128
    seed: int = 0


@dataclass(frozen=True)
class TraceItem:
    uid: int
    arrival_tick: int
    prompt: tuple[int, ...]
    max_new_tokens: int
    kind: str                                # "short" | "long" | "fleet"


@dataclass(frozen=True)
class Trace:
    spec: TraceSpec
    items: tuple[TraceItem, ...]


def make_trace(spec: TraceSpec) -> Trace:
    """Deterministic trace from the spec: same spec → same trace."""
    rng = np.random.default_rng(spec.seed)
    fleets = [rng.integers(1, spec.vocab, size=spec.fleet_prefix_len).tolist()
              for _ in range(spec.num_fleets)]
    arrivals = np.floor(np.cumsum(
        rng.exponential(spec.mean_interarrival_ticks,
                        size=spec.num_requests))).astype(int)
    items = []
    for i in range(spec.num_requests):
        u = rng.random()
        if spec.num_fleets and u < spec.fleet_frac:
            kind = "fleet"
            prefix = fleets[int(rng.integers(0, spec.num_fleets))]
            suffix = rng.integers(1, spec.vocab, size=int(
                rng.integers(*spec.fleet_suffix_len))).tolist()
            prompt = prefix + suffix
        elif u < spec.fleet_frac + spec.long_frac:
            kind = "long"
            prompt = rng.integers(1, spec.vocab, size=int(
                rng.integers(*spec.long_len))).tolist()
        else:
            kind = "short"
            prompt = rng.integers(1, spec.vocab, size=int(
                rng.integers(*spec.short_len))).tolist()
        items.append(TraceItem(uid=i, arrival_tick=int(arrivals[i]),
                               prompt=tuple(prompt),
                               max_new_tokens=spec.max_new_tokens, kind=kind))
    return Trace(spec=spec, items=tuple(items))


def tokens_digest(outs: dict[int, Sequence[int]]) -> str:
    """Order-independent stable hash over ``{uid: tokens}``."""
    h = hashlib.sha256()
    for uid in sorted(outs):
        h.update(f"{uid}:{','.join(map(str, outs[uid]))};".encode())
    return h.hexdigest()[:16]


def replay(server: DecodeServer, trace: Trace, *, uid_offset: int = 0,
           max_ticks: int = 100_000) -> dict:
    """Open-loop replay: submit each item at its arrival tick, step the
    server (``step_block()`` when ``server.persistent``), drain, and report.
    The wall clock stops after the card has finished the run's work.

    Counters are read from the server's registry, so run ``stats(reset=
    True)`` beforehand if the server already served a warm window: the
    report's ``decoded_tokens`` and ``per_shard`` rows are window totals.
    """
    items = sorted(trace.items, key=lambda it: (it.arrival_tick, it.uid))
    uids = {it.uid + uid_offset for it in items}
    step = server.step_block if server.persistent else server.step
    tick = i = 0
    t0 = time.perf_counter()
    while True:
        while i < len(items) and items[i].arrival_tick <= tick:
            it = items[i]
            server.submit(Request(uid=it.uid + uid_offset, prompt=list(it.prompt),
                                  max_new_tokens=it.max_new_tokens))
            i += 1
        pending = len(server.scheduler) or server._jobs or server.live.any()
        if i >= len(items) and not pending:
            break
        step()
        tick += 1
        if tick >= max_ticks:
            break
    if server.device.type == "cuda":
        torch.cuda.synchronize(server.device)
    wall = time.perf_counter() - t0

    stats = server.stats()
    done = [r for r in server.completed if r.uid in uids]
    outs = {r.uid - uid_offset: list(r.out_tokens) for r in done}
    by_reason: dict[str, int] = {}
    for r in done:
        reason = r.finish_reason or "ok"
        by_reason[reason] = by_reason.get(reason, 0) + 1
    decoded = int(stats["decoded_tokens"])
    per_shard = [{"shard": 0, "decoded_tokens": decoded, "dispatched": len(done),
                  "quarantined": int(server.obs.metrics.value("slots_quarantined"))}]
    return {"schema": SCHEMA,
            "spec": asdict(trace.spec),
            "requests": len(items),
            "completed": len(done),
            "by_reason": by_reason,
            "ticks": tick,
            "wall_s": wall,
            "decoded_tokens": decoded,
            "throughput_tok_s": decoded / max(wall, 1e-9),
            "tokens_digest": tokens_digest(outs),
            "mesh": None,
            "per_shard": per_shard}


__all__ = ["SCHEMA", "Trace", "TraceItem", "TraceSpec", "make_trace", "replay", "tokens_digest"]
