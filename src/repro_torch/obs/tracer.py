"""Host-side span tracer: phase-attributed timing for plan -> wave -> serve
(port of ``repro.obs.tracer``).

Every layer opens named spans (``plan/gnm``, ``wave/dispatch``,
``serve/deliver``, ...) tagged with a coarse *phase* (``plan`` /
``exec`` / ``sink``), and :meth:`Tracer.phase_totals` folds them into
the ``plan_s``/``exec_s``/``sink_s`` breakdown.

Design constraints, in order:

* **Zero overhead when disabled.**  Tracing is off by default;
  :func:`trace` then returns one shared no-op context manager: no span
  object, no event record, no clock read, one attribute read per site.
* **Host-side only.**  Spans never enter a kernel.  Device time is
  attributed by closing a span after ``torch.cuda.synchronize`` at the
  call site, which the runtime does only while tracing is enabled (the
  kernels otherwise return before the card finishes).
* **Monotonic clocks, thread-safe, nestable.**  Spans use
  ``time.perf_counter_ns``, keep a per-thread stack for parent
  attribution, and append finished records under a lock.

Export targets the Chrome trace-event JSON schema (``chrome://tracing``
and Perfetto load it).  With ``profiler_annotations`` on, each span is
also a ``torch.profiler.record_function`` range (so it shows under its
own name in a :func:`profiler_trace`) and, where a card is present, an
NVTX range pushed and popped on the span's own thread.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Tuple

__all__ = [
    "Span", "SpanRecord", "Tracer", "trace", "event", "enable", "disable",
    "is_enabled", "tracer", "capture", "phase_totals", "export_chrome",
    "profiler_trace", "PHASES",
]

# the canonical phase names benchmark records report
PHASES = ("plan", "exec", "sink")


@dataclass(frozen=True)
class SpanRecord:
    """One finished span (or instant event, when ``dur_ns`` is 0 and
    ``instant`` is set)."""
    name: str
    t0_ns: int                  # perf_counter_ns at entry
    dur_ns: int
    tid: int                    # python thread ident
    span_id: int
    parent_id: int              # 0 = top level
    attrs: Dict[str, Any] = field(default_factory=dict)
    instant: bool = False

    @property
    def seconds(self) -> float:
        return self.dur_ns / 1e9

    @property
    def phase(self) -> Optional[str]:
        p = self.attrs.get("phase")
        return p if isinstance(p, str) else None


class _NullSpan:
    """The shared disabled-path context manager: no state, no clock."""
    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


NULL_SPAN = _NullSpan()


class Span:
    """One live span; created by :meth:`Tracer.span` only while the
    tracer is enabled.  Context-manager protocol: the clock starts at
    ``__enter__`` and the record is appended at ``__exit__``."""
    __slots__ = ("_tracer", "name", "attrs", "_t0", "_id", "_parent", "_ann")

    def __init__(self, tracer: "Tracer", name: str, attrs: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self._t0 = 0
        self._id = 0
        self._parent = 0
        self._ann = None

    def set(self, **attrs) -> None:
        """Attach attributes after entry (e.g. counts known at exit)."""
        self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        tr = self._tracer
        stack = tr._stack()
        self._parent = stack[-1] if stack else 0
        self._id = tr._next_id()
        stack.append(self._id)
        if tr.profiler_annotations:
            self._ann = _Annotation(self.name)
            self._ann.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        dur = time.perf_counter_ns() - self._t0
        if self._ann is not None:
            self._ann.__exit__(*exc)
        tr = self._tracer
        stack = tr._stack()
        if stack and stack[-1] == self._id:
            stack.pop()
        tr._record(SpanRecord(self.name, self._t0, dur,
                              threading.get_ident(), self._id, self._parent,
                              self.attrs))
        return False


class _Annotation:
    """A span mirrored into the device profilers: a
    ``torch.profiler.record_function`` range and, where a card is present,
    an NVTX range (pushed and popped on the entering thread, which is the
    span's own: spans are context managers)."""
    __slots__ = ("name", "_rf", "_nvtx")

    def __init__(self, name: str):
        self.name = name
        self._rf = None
        self._nvtx = False

    def __enter__(self) -> "_Annotation":
        import torch

        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        if torch.cuda.is_available():
            torch.cuda.nvtx.range_push(self.name)
            self._nvtx = True
        return self

    def __exit__(self, *exc) -> bool:
        if self._nvtx:
            import torch

            torch.cuda.nvtx.range_pop()
        self._rf.__exit__(*exc)
        return False


class Tracer:
    """Collects spans + instant events; one module-global instance is
    the default target of :func:`trace` / :func:`event`.

    ``enabled`` is the single hot-path check: every instrumentation
    point reads it (via :func:`trace`) and gets :data:`NULL_SPAN` back
    when tracing is off.
    """

    def __init__(self, enabled: bool = False, profiler_annotations: bool = False):
        self.enabled = bool(enabled)
        self.profiler_annotations = bool(profiler_annotations)
        self._records: List[SpanRecord] = []
        self._lock = threading.Lock()
        self._local = threading.local()
        self._counter = 0

    # ------------------------------------------------------------ plumbing

    def _stack(self) -> List[int]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _next_id(self) -> int:
        with self._lock:
            self._counter += 1
            return self._counter

    def _record(self, rec: SpanRecord) -> None:
        with self._lock:
            self._records.append(rec)

    # ------------------------------------------------------------ recording

    def span(self, name: str, **attrs) -> Span:
        """An *unconditional* span (records even when ``enabled`` is
        False is NOT the contract — callers go through :func:`trace`;
        this constructor assumes the enabled check already happened)."""
        return Span(self, name, attrs)

    def instant(self, name: str, **attrs) -> None:
        """Record an instant event (compile-cache hit, fault reissue)."""
        stack = self._stack()
        self._record(SpanRecord(name, time.perf_counter_ns(), 0,
                                threading.get_ident(), self._next_id(),
                                stack[-1] if stack else 0, attrs,
                                instant=True))

    def clear(self) -> None:
        with self._lock:
            self._records = []
            self._counter = 0

    # ------------------------------------------------------------ reading

    def spans(self) -> List[SpanRecord]:
        """Finished records, in completion order (leaf-before-parent)."""
        with self._lock:
            return list(self._records)

    def phase_totals(self) -> Dict[str, float]:
        """Seconds per phase: ``{"plan_s": .., "exec_s": .., "sink_s": ..}``.

        Nesting-aware: a span whose *ancestor* already carries the same
        phase contributes nothing (its time is inside the ancestor), so
        e.g. a reseed emitter that re-enters a cold ``plan/...`` span
        never double-counts.
        """
        recs = self.spans()
        by_id = {r.span_id: r for r in recs}
        totals = {p: 0.0 for p in PHASES}
        for r in recs:
            p = r.phase
            if p not in totals or r.instant:
                continue
            anc = by_id.get(r.parent_id)
            shadowed = False
            while anc is not None:
                if anc.phase == p:
                    shadowed = True
                    break
                anc = by_id.get(anc.parent_id)
            if not shadowed:
                totals[p] += r.seconds
        return {f"{p}_s": t for p, t in totals.items()}

    def summary(self) -> Dict[str, Any]:
        """Aggregate view: per-name counts/totals plus the phase fold."""
        agg: Dict[str, Dict[str, float]] = {}
        for r in self.spans():
            a = agg.setdefault(r.name, {"count": 0, "total_s": 0.0})
            a["count"] += 1
            a["total_s"] += r.seconds
        return {"phases": self.phase_totals(), "spans": agg}

    # ------------------------------------------------------------ export

    def export_chrome(self, path: Optional[str] = None) -> dict:
        """Chrome trace-event JSON (Perfetto-loadable).

        Complete ``X`` (duration) events for spans, ``i`` (instant)
        events for counters; timestamps in microseconds per the schema.
        Writes to ``path`` when given; always returns the dict.
        """
        tids = {}
        events = []
        for r in self.spans():
            tid = tids.setdefault(r.tid, len(tids) + 1)
            ev = {
                "name": r.name,
                "cat": r.phase or "span",
                "ph": "i" if r.instant else "X",
                "ts": r.t0_ns / 1e3,
                "pid": 1,
                "tid": tid,
                "args": {k: _jsonable(v) for k, v in r.attrs.items()},
            }
            if r.instant:
                ev["s"] = "t"
            else:
                ev["dur"] = r.dur_ns / 1e3
            events.append(ev)
        out = {
            "traceEvents": sorted(events, key=lambda e: e["ts"]),
            "displayTimeUnit": "ms",
            "otherData": {"producer": "repro_torch.obs", "phases": self.phase_totals()},
        }
        if path is not None:
            with open(path, "w") as f:
                json.dump(out, f, indent=1)
                f.write("\n")
        return out


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


# --------------------------------------------------------------------------
# module-global tracer + the hot-path entry points
# --------------------------------------------------------------------------

_TRACER = Tracer()


def tracer() -> Tracer:
    """The current global tracer."""
    return _TRACER


def is_enabled() -> bool:
    return _TRACER.enabled


def enable(profiler_annotations: bool = False, clear: bool = False) -> Tracer:
    """Turn tracing on (optionally mirroring spans into
    ``torch.profiler`` and NVTX ranges); returns the tracer."""
    if clear:
        _TRACER.clear()
    _TRACER.profiler_annotations = bool(profiler_annotations)
    _TRACER.enabled = True
    return _TRACER


def disable() -> Tracer:
    _TRACER.enabled = False
    return _TRACER


def trace(name: str, **attrs):
    """Open a span (context manager) — THE instrumentation entry point.

    Disabled path: returns the shared :data:`NULL_SPAN` singleton —
    nothing is allocated by this module and no clock is read."""
    if not _TRACER.enabled:
        return NULL_SPAN
    return _TRACER.span(name, **attrs)


def event(name: str, **attrs) -> None:
    """Record an instant event (no-op while disabled)."""
    if _TRACER.enabled:
        _TRACER.instant(name, **attrs)


def phase_totals() -> Dict[str, float]:
    return _TRACER.phase_totals()


def export_chrome(path: Optional[str] = None) -> dict:
    return _TRACER.export_chrome(path)


@contextlib.contextmanager
def capture(profiler_annotations: bool = False) -> Iterator[Tracer]:
    """Scoped tracing: install a *fresh* enabled tracer for the block,
    restore the previous one after.

        with obs.capture() as tr:
            generate(spec, P)
        print(tr.phase_totals())
    """
    global _TRACER
    prev = _TRACER
    _TRACER = Tracer(enabled=True, profiler_annotations=profiler_annotations)
    try:
        yield _TRACER
    finally:
        _TRACER = prev


@contextlib.contextmanager
def profiler_trace(logdir: str) -> Iterator[object]:
    """A ``torch.profiler.profile`` of the block (CPU, and CUDA where a
    card is present) whose Chrome trace is written to
    ``logdir/trace.json`` at exit; yields the profile.  Spans recorded
    with ``profiler_annotations`` appear in it under their own names."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
