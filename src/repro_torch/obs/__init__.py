"""repro_torch.obs — spans, metrics and phase-attributed tracing.

Zero-overhead-when-disabled, host-side-only observability for the
whole stack: plan emitters open ``plan/*`` spans, the runtime opens
``wave``/``run``/``slab`` spans (with device time split out at
``torch.cuda.synchronize`` boundaries while tracing) and emits
compile-cache events (the slot-function cache), and
the serving tier keeps queue/slab/cache/latency metrics in a
Prometheus-style registry.

    from repro_torch import obs

    with obs.capture() as tr:
        generate(spec, P=8)
    print(tr.phase_totals())          # {'plan_s': .., 'exec_s': .., 'sink_s': ..}
    tr.export_chrome("trace.json")    # load in ui.perfetto.dev

A port of ``repro.obs``: the JAX profiler bridge becomes
``torch.profiler`` / NVTX ranges (``profiler_annotations``,
:func:`profiler_trace`).
"""
from .metrics import (Counter, Gauge, Histogram, Registry, parse_exposition,
                      DEFAULT_BUCKETS)
from .tracer import (NULL_SPAN, PHASES, Span, SpanRecord, Tracer, capture,
                     disable, enable, event, export_chrome, is_enabled,
                     profiler_trace, phase_totals, trace, tracer)

__all__ = [
    # tracer
    "NULL_SPAN", "PHASES", "Span", "SpanRecord", "Tracer", "capture",
    "disable", "enable", "event", "export_chrome", "is_enabled",
    "profiler_trace", "phase_totals", "trace", "tracer",
    # metrics
    "Counter", "Gauge", "Histogram", "Registry", "parse_exposition",
    "DEFAULT_BUCKETS",
]
