"""Observability for the port: metrics registry, span tracing, leveled logging.

The port keeps its own copy of the JAX package's ``obs`` modules (which are
pure Python) so that it never imports the reference package.  Metric names,
snapshot layout and the trace-event format are identical, so the port's
``DecodeServer.stats()`` and exported documents compare key for key with the
reference's.  The predicted-vs-measured ledger and the ``check``/``report``
tools are not ported yet: an exported metrics document carries an empty
``ledger`` list.

* :class:`~repro_torch.obs.metrics.MetricsRegistry` — counters / gauges /
  histograms (p50/p95/p99), labeled, thread-safe, snapshot + Prometheus text.
* :class:`~repro_torch.obs.trace.Tracer` — Chrome-trace/Perfetto spans,
  disabled by default and near-free when disabled.
* :mod:`~repro_torch.obs.log` — ``REPRO_LOG=quiet|info|debug`` logging.
"""

from __future__ import annotations

import json

from . import log
from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .trace import Tracer

METRICS_SCHEMA = "repro.metrics/v1"


class Observability:
    """One scope of accounting: a registry + tracer that reset and export
    together."""

    def __init__(self, *, trace: bool = False):
        self.metrics = MetricsRegistry()
        self.tracer = Tracer(enabled=trace)

    @property
    def tracing(self) -> bool:
        return self.tracer.enabled

    def reset(self) -> None:
        self.metrics.reset()
        self.tracer.reset()

    # -- export ------------------------------------------------------------

    def export_trace(self, path: str | None = None) -> dict:
        """Chrome-trace JSON (Perfetto-loadable); written when ``path``."""
        return self.tracer.export(path)

    def export_metrics(self, path: str | None = None, *,
                       stats: dict | None = None) -> dict:
        """Metrics document: registry snapshot (+ an optional server
        ``stats()`` view for cross-checking)."""
        doc = {"schema": METRICS_SCHEMA,
               "metrics": self.metrics.snapshot(),
               "ledger": []}
        if stats is not None:
            doc["stats"] = stats
        if path is not None:
            with open(path, "w") as fh:
                json.dump(doc, fh, indent=1, default=str)
        return doc


__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "METRICS_SCHEMA",
    "MetricsRegistry",
    "Observability",
    "Tracer",
    "log",
]
