"""Metrics registry: labeled counters / gauges / histograms with snapshots.

A copy of the JAX package's ``obs/metrics.py``: metric names and snapshot
layout are identical, so the port's ``stats()`` compares key for key with the
reference server's.  One registry is one *scope* of accounting — a
:class:`~repro_torch.runtime.server.DecodeServer` owns one, so tests and
back-to-back scenarios never see each other's counts.

Design constraints, in order:

* **cheap on the hot path** — a counter ``inc()`` is one lock acquire and one
  add; callers cache the child-metric handle at init time so the registry
  dict lookup is off the per-tick path;
* **thread-safe** — the async serving front-end and trainer threads may
  record concurrently; every mutation holds the owning registry's lock;
* **resettable** — ``reset()`` zeroes values but keeps the registered
  families, so long-lived servers and back-to-back ``perf_suite`` scenarios
  can account per-window instead of per-process;
* **exportable** — ``snapshot()`` (nested dict), ``to_prometheus()``
  (text exposition format; histograms exported as summaries), and the JSON
  document written by :meth:`repro_torch.obs.Observability.export_metrics`.
"""

from __future__ import annotations

import json
import random
import threading

# Histogram reservoir: exact percentiles up to this many observations, then
# uniform reservoir sampling (deterministic RNG — reproducible snapshots).
RESERVOIR = 4096

QUANTILES = (("p50", 0.50), ("p95", 0.95), ("p99", 0.99))


def _label_key(labels: dict) -> str:
    """Canonical child id: '' for the bare metric, '{k=v,...}' sorted else."""
    if not labels:
        return ""
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return "{" + inner + "}"


class Counter:
    """Monotonic (between resets) float/int accumulator."""

    kind = "counter"
    __slots__ = ("name", "labels", "_lock", "value")

    def __init__(self, name: str, labels: dict, lock: threading.RLock):
        self.name, self.labels, self._lock = name, dict(labels), lock
        self.value = 0

    def inc(self, n: float = 1) -> None:
        with self._lock:
            self.value += n

    def _reset(self) -> None:
        self.value = 0

    def _snapshot(self):
        return self.value


class Gauge:
    """Last-written value; ``set_max`` keeps a running maximum (used for
    high-watermarks like ``max_prompt_steps_per_tick``)."""

    kind = "gauge"
    __slots__ = ("name", "labels", "_lock", "value")

    def __init__(self, name: str, labels: dict, lock: threading.RLock):
        self.name, self.labels, self._lock = name, dict(labels), lock
        self.value = 0

    def set(self, v: float) -> None:
        with self._lock:
            self.value = v

    def add(self, n: float) -> None:
        with self._lock:
            self.value += n

    def set_max(self, v: float) -> None:
        with self._lock:
            if v > self.value:
                self.value = v

    def _reset(self) -> None:
        self.value = 0

    def _snapshot(self):
        return self.value


class Histogram:
    """Distribution with count/sum/min/max and reservoir percentiles."""

    kind = "histogram"
    __slots__ = ("name", "labels", "_lock", "count", "total", "vmin", "vmax",
                 "_values", "_rng")

    def __init__(self, name: str, labels: dict, lock: threading.RLock):
        self.name, self.labels, self._lock = name, dict(labels), lock
        self.count = 0
        self.total = 0.0
        self.vmin = self.vmax = None
        self._values: list[float] = []
        self._rng = random.Random(0)

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.total += v
            self.vmin = v if self.vmin is None else min(self.vmin, v)
            self.vmax = v if self.vmax is None else max(self.vmax, v)
            if len(self._values) < RESERVOIR:
                self._values.append(v)
            else:  # uniform reservoir replacement
                j = self._rng.randrange(self.count)
                if j < RESERVOIR:
                    self._values[j] = v

    def percentile(self, q: float) -> float | None:
        """Nearest-rank percentile over the reservoir (q in [0, 1])."""
        with self._lock:
            if not self._values:
                return None
            vals = sorted(self._values)
        idx = min(len(vals) - 1, max(0, int(-(-q * len(vals) // 1)) - 1))
        return vals[idx]

    def summary(self) -> dict:
        out = {"count": self.count, "sum": self.total,
               "min": self.vmin, "max": self.vmax}
        for name, q in QUANTILES:
            out[name] = self.percentile(q)
        return out

    def _reset(self) -> None:
        self.count = 0
        self.total = 0.0
        self.vmin = self.vmax = None
        self._values.clear()
        self._rng = random.Random(0)

    def _snapshot(self):
        return self.summary()


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Get-or-create registry of metric families; children keyed by labels."""

    def __init__(self):
        self._lock = threading.RLock()
        # name -> {"kind": str, "help": str, "children": {label_key: metric}}
        self._families: dict[str, dict] = {}

    # -- registration ------------------------------------------------------

    def _metric(self, kind: str, name: str, help: str, labels: dict):
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = {
                    "kind": kind, "help": help, "children": {}}
            elif fam["kind"] != kind:
                raise ValueError(
                    f"metric '{name}' already registered as {fam['kind']}, "
                    f"requested {kind}")
            key = _label_key(labels)
            child = fam["children"].get(key)
            if child is None:
                child = fam["children"][key] = _KINDS[kind](
                    name, labels, self._lock)
            return child

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._metric("counter", name, help, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._metric("gauge", name, help, labels)

    def histogram(self, name: str, help: str = "", **labels) -> Histogram:
        return self._metric("histogram", name, help, labels)

    # -- introspection -----------------------------------------------------

    def get(self, name: str, **labels):
        """Existing child metric or None (never creates)."""
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                return None
            return fam["children"].get(_label_key(labels))

    def children(self, name: str) -> list:
        """All child metrics of a family (e.g. every ``reason=`` counter)."""
        with self._lock:
            fam = self._families.get(name)
            return list(fam["children"].values()) if fam else []

    def value(self, name: str, default=0, **labels):
        m = self.get(name, **labels)
        return default if m is None else m.value

    # -- lifecycle ---------------------------------------------------------

    def reset(self) -> None:
        """Zero every metric; families and children stay registered."""
        with self._lock:
            for fam in self._families.values():
                for child in fam["children"].values():
                    child._reset()

    # -- export ------------------------------------------------------------

    def snapshot(self) -> dict:
        """{"counters": {...}, "gauges": {...}, "histograms": {...}} with
        flattened 'name{label=value}' keys."""
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        with self._lock:
            for name, fam in sorted(self._families.items()):
                bucket = out[fam["kind"] + "s"]
                for key, child in sorted(fam["children"].items()):
                    bucket[name + key] = child._snapshot()
        return out

    def to_json(self, indent: int | None = None) -> str:
        return json.dumps(self.snapshot(), indent=indent)

    def to_prometheus(self) -> str:
        """Prometheus text exposition; histograms exported as summaries."""
        lines: list[str] = []
        with self._lock:
            for name, fam in sorted(self._families.items()):
                kind = fam["kind"]
                ptype = "summary" if kind == "histogram" else kind
                if fam["help"]:
                    lines.append(f"# HELP {name} {fam['help']}")
                lines.append(f"# TYPE {name} {ptype}")
                for child in fam["children"].values():
                    lbl = ",".join(f'{k}="{v}"'
                                   for k, v in sorted(child.labels.items()))
                    if kind == "histogram":
                        for _, q in QUANTILES:
                            v = child.percentile(q)
                            if v is None:
                                continue
                            qlbl = (lbl + "," if lbl else "") + f'quantile="{q}"'
                            lines.append(f"{name}{{{qlbl}}} {v}")
                        sfx = "{" + lbl + "}" if lbl else ""
                        lines.append(f"{name}_sum{sfx} {child.total}")
                        lines.append(f"{name}_count{sfx} {child.count}")
                    else:
                        sfx = "{" + lbl + "}" if lbl else ""
                        lines.append(f"{name}{sfx} {child.value}")
        return "\n".join(lines) + "\n"


__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "QUANTILES",
           "RESERVOIR"]
