"""Prometheus-style metrics: counters, gauges, histograms, exposition.

The serving tier's operational surface: queue depth, slab fill
fraction, packing-group slab counts, plan-cache hit/miss/evictions,
fault reissues and per-ticket latency percentiles all live in a
:class:`Registry` that renders the standard text exposition format
(``# TYPE`` headers + ``name{label="v"} value`` samples), so
``Service.metrics()`` can be scraped, diffed in CI, or parsed back
with :func:`parse_exposition`.

This is deliberately dependency-free and host-side (a copy of
``repro.obs.metrics``): metrics are updated from ordinary Python control
flow (scheduler ticks, sink deliveries), never from inside a kernel.
"""
from __future__ import annotations

import math
import threading
from collections import deque
from typing import Callable, Dict, Iterable, List, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "parse_exposition",
           "DEFAULT_BUCKETS"]

# latency-ish default bucket bounds in seconds (upper-inclusive, +Inf last)
DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0)


def _fmt_labels(labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Dict[str, str]] = None):
        self.name = name
        self.help = help
        self.labels = tuple(sorted((labels or {}).items()))

    def samples(self) -> Iterable[Tuple[str, Tuple[Tuple[str, str], ...], float]]:
        raise NotImplementedError


class Counter(_Metric):
    """Monotonically increasing count."""
    kind = "counter"

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Dict[str, str]] = None):
        super().__init__(name, help, labels)
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError(f"counter {self.name} cannot decrease (inc {v})")
        self.value += v

    def samples(self):
        yield self.name, self.labels, self.value


class Gauge(_Metric):
    """Point-in-time value; ``fn`` makes it a callback gauge whose
    value is read at render time (live queue depths, cache sizes)."""
    kind = "gauge"

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Dict[str, str]] = None,
                 fn: Optional[Callable[[], float]] = None):
        super().__init__(name, help, labels)
        self._value = 0.0
        self.fn = fn

    def set(self, v: float) -> None:
        self._value = float(v)

    def inc(self, v: float = 1.0) -> None:
        self._value += v

    def dec(self, v: float = 1.0) -> None:
        self._value -= v

    @property
    def value(self) -> float:
        return float(self.fn()) if self.fn is not None else self._value

    def samples(self):
        yield self.name, self.labels, self.value


class Histogram(_Metric):
    """Cumulative-bucket histogram plus a bounded reservoir for
    percentiles (the exposition carries the buckets; ``percentile`` is
    a host-side convenience over the most recent observations)."""
    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Dict[str, str]] = None,
                 buckets: Tuple[float, ...] = DEFAULT_BUCKETS,
                 reservoir: int = 8192):
        super().__init__(name, help, labels)
        self.bounds = tuple(sorted(buckets))
        self.counts = [0] * (len(self.bounds) + 1)   # +Inf last
        self.sum = 0.0
        self.count = 0
        self._recent: deque = deque(maxlen=reservoir)

    def observe(self, v: float) -> None:
        v = float(v)
        self.sum += v
        self.count += 1
        self._recent.append(v)
        for i, b in enumerate(self.bounds):
            if v <= b:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def percentile(self, q: float) -> Optional[float]:
        """q in [0, 1] over the retained reservoir (None when empty)."""
        if not self._recent:
            return None
        vals = sorted(self._recent)
        idx = min(len(vals) - 1, max(0, int(round(q * (len(vals) - 1)))))
        return vals[idx]

    def samples(self):
        cum = 0
        for b, c in zip(self.bounds + (math.inf,), self.counts):
            cum += c
            yield (f"{self.name}_bucket",
                   self.labels + (("le", _fmt_value(b)),), float(cum))
        yield f"{self.name}_sum", self.labels, self.sum
        yield f"{self.name}_count", self.labels, float(self.count)


class Registry:
    """A named set of metrics rendering one text exposition.

    ``counter``/``gauge``/``histogram`` are get-or-create (idempotent
    per (name, labels)), so instrumentation sites don't need wiring
    order guarantees.
    """

    def __init__(self, prefix: str = ""):
        self.prefix = prefix
        self._metrics: "Dict[Tuple[str, tuple], _Metric]" = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, help: str, labels, **kw) -> _Metric:
        name = self.prefix + name
        key = (name, tuple(sorted((labels or {}).items())))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = self._metrics[key] = cls(name, help, labels, **kw)
            return m

    def counter(self, name: str, help: str = "", labels=None) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", labels=None,
              fn: Optional[Callable[[], float]] = None) -> Gauge:
        g = self._get(Gauge, name, help, labels, fn=fn)
        if fn is not None:
            g.fn = fn
        return g

    def histogram(self, name: str, help: str = "", labels=None,
                  buckets: Tuple[float, ...] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, labels, buckets=buckets)

    def collect(self) -> List[_Metric]:
        with self._lock:
            return list(self._metrics.values())

    def render(self) -> str:
        """The Prometheus text exposition (format version 0.0.4)."""
        lines: List[str] = []
        seen_headers = set()
        for m in sorted(self.collect(), key=lambda m: (m.name, m.labels)):
            if m.name not in seen_headers:
                seen_headers.add(m.name)
                if m.help:
                    lines.append(f"# HELP {m.name} {m.help}")
                lines.append(f"# TYPE {m.name} {m.kind}")
            for sample_name, labels, value in m.samples():
                lines.append(
                    f"{sample_name}{_fmt_labels(labels)} {_fmt_value(value)}")
        return "\n".join(lines) + "\n"

    def to_dict(self) -> Dict[str, float]:
        """Flat ``{sample_name{labels}: value}`` view (tests, JSON)."""
        out: Dict[str, float] = {}
        for m in self.collect():
            for sample_name, labels, value in m.samples():
                out[f"{sample_name}{_fmt_labels(labels)}"] = value
        return out


def parse_exposition(text: str) -> Dict[str, float]:
    """Parse a text exposition back into ``{name{labels}: value}``.

    Strict enough to be the CI assertion that ``Service.metrics()``
    stays well-formed: every non-comment line must be
    ``name[{labels}] value`` with a float-parseable value, and every
    sample must be preceded by a ``# TYPE`` header for its family.
    """
    out: Dict[str, float] = {}
    typed: set = set()
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 3 and parts[1] == "TYPE":
                typed.add(parts[2])
            continue
        name_part, _, value_part = line.rpartition(" ")
        if not name_part:
            raise ValueError(f"line {lineno}: no value in {line!r}")
        value = math.inf if value_part == "+Inf" else float(value_part)
        family = name_part.split("{")[0]
        base = family
        for suffix in ("_bucket", "_sum", "_count"):
            if family.endswith(suffix):
                base = family[: -len(suffix)]
        if family not in typed and base not in typed:
            raise ValueError(f"line {lineno}: sample {family!r} has no "
                             f"# TYPE header")
        out[name_part] = value
    return out
