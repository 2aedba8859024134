"""Observability for the port: metrics registry, span tracing, the
predicted-vs-measured ledger, leveled logging.

The port keeps its own copy of the JAX package's ``obs`` modules (which are
pure Python) so that it never imports the reference package.  Metric names,
snapshot layout, the ledger's row schema and the trace-event format are
identical, so the port's ``DecodeServer.stats()`` and exported documents
compare key for key with the reference's.  ``python -m repro_torch.obs.check``
validates exported documents as the reference's checker does; ``python -m
repro_torch.obs.report`` writes the predicted-vs-measured ledger.

* :class:`~repro_torch.obs.metrics.MetricsRegistry` — counters / gauges /
  histograms (p50/p95/p99), labeled, thread-safe, snapshot + Prometheus text.
* :class:`~repro_torch.obs.trace.Tracer` — Chrome-trace/Perfetto spans,
  disabled by default and near-free when disabled.
* :class:`~repro_torch.obs.ledger.Ledger` — predicted cost (the FSM cycle
  model, MACC flops, peak bytes) joined against measured wall clock per
  synthesized program.
* :mod:`~repro_torch.obs.log` — ``REPRO_LOG=quiet|info|debug`` logging.

Scoping: each ``DecodeServer`` owns an :class:`Observability`; process-wide
work (the synthesis memo, generated-kernel compiles) records into the
module-global :data:`OBS`.
"""

from __future__ import annotations

import json

from . import log
from .ledger import Ledger
from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .trace import Tracer

METRICS_SCHEMA = "repro.metrics/v1"


class Observability:
    """One scope of accounting: a registry + tracer + ledger that reset and
    export together."""

    def __init__(self, *, trace: bool = False):
        self.metrics = MetricsRegistry()
        self.tracer = Tracer(enabled=trace)
        self.ledger = Ledger()

    @property
    def tracing(self) -> bool:
        return self.tracer.enabled

    def reset(self) -> None:
        self.metrics.reset()
        self.tracer.reset()
        self.ledger.reset()

    # -- export ------------------------------------------------------------

    def export_trace(self, path: str | None = None) -> dict:
        """Chrome-trace JSON (Perfetto-loadable); written when ``path``."""
        return self.tracer.export(path)

    def export_metrics(self, path: str | None = None, *,
                       stats: dict | None = None,
                       ledger: "Ledger | None" = None) -> dict:
        """Metrics document: registry snapshot + predicted-vs-measured
        ledger (+ an optional server ``stats()`` view for cross-checking).
        ``ledger`` defaults to this scope's; pass :data:`OBS.ledger <OBS>`
        to export the process-wide synthesis ledger instead."""
        led = self.ledger if ledger is None else ledger
        doc = {"schema": METRICS_SCHEMA,
               "metrics": self.metrics.snapshot(),
               "ledger": led.report()}
        if stats is not None:
            doc["stats"] = stats
        if path is not None:
            with open(path, "w") as fh:
                json.dump(doc, fh, indent=1, default=str)
        return doc


# Process-global scope: synthesis/codegen instrumentation (mirrors the
# process-wide synthesize() memo).  Serving components keep their own scope.
OBS = Observability()


def get() -> Observability:
    return OBS


__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Ledger",
    "METRICS_SCHEMA",
    "MetricsRegistry",
    "OBS",
    "Observability",
    "Tracer",
    "get",
    "log",
]
