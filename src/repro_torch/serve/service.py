"""Generation as a service: concurrent GraphSpec requests on the local
cards (port of ``repro.serve.service``).

:class:`Service` is the front door of the serving tier:

* ``submit(spec)`` resolves the request's plan through the reseeding
  :class:`~repro_torch.serve.plancache.PlanCache` (a warm shape costs a
  reseed, not a host recursion), hands its slots to the slab
  :class:`~repro_torch.serve.scheduler.Scheduler`, and returns a
  :class:`Ticket`.
* Requests may be submitted at any time: between ticks, mid-drain, from
  a streaming consumer's loop.  Their slots join partially drained
  queues and ride the next slab beside older requests' remainders
  (continuous batching).
* ``Ticket.result()`` / ``Ticket.chunks()`` drive the scheduler just far
  enough for the caller, so streaming and the batch drain share one path.

Every delivered request equals ``generate(spec, P)`` bit for bit (same
edges, same order): packing never changes what a slot computes.  A
ticket is stamped complete only once its results exist on the card: a
tick that completes tickets synchronizes the device once before
stamping them (the kernels return before the card finishes).
"""
from __future__ import annotations

import time
from typing import Iterable, List, Optional, Sequence

import torch

from .. import obs
from ..api import DEFAULT_RNG, plan_emitter
from ..distrib import runtime
from ..distrib.world import LocalMesh
from .plancache import PlanCache
from .scheduler import Scheduler
from .sinks import ChunkSink, GraphSink, Sink, StatsSink

__all__ = ["Service", "Ticket", "serve"]


class Ticket:
    """Handle of one submitted request."""

    def __init__(self, service: "Service", sink: Sink, submitted: float):
        self._service = service
        self.sink = sink
        self.submitted = submitted
        self.completed: Optional[float] = None

    @property
    def done(self) -> bool:
        return self.sink.done

    @property
    def latency(self) -> Optional[float]:
        """Submit-to-completion wall seconds (None while in flight)."""
        if self.completed is None:
            return None
        return self.completed - self.submitted

    def result(self):
        """Tick the scheduler until this request completes, then return
        the sink's result."""
        self._service.drain_until(self)
        return self.sink.result()

    def chunks(self):
        """Stream this request's edge chunks in plan order, ticking the
        scheduler between yields (requires a :class:`ChunkSink`)."""
        if not isinstance(self.sink, ChunkSink):
            raise TypeError("chunks() requires a ChunkSink request; "
                            "submit with sink='chunks'")
        while True:
            while self.sink.ready:
                yield self.sink.ready.popleft()
            if self.sink.done:
                return
            if not self._service.tick() and not self.sink.done:
                raise RuntimeError("scheduler idle but request incomplete")


class Service:
    """Multi-tenant batched graph generation on the local cards.

    ``P`` is the virtual PE count every request's plan is emitted for (the
    generated instance is a function of the spec and P, as in
    ``generate``).  ``mesh`` is what slabs are spread over, as in the
    reference: by default ``runtime.mesh_for(P)``, the most local cards
    that divide P (one row on ``device`` when it names the CPU or one
    card); on a :class:`~repro_torch.distrib.world.LocalMesh` of several
    rows, row ``d`` of each slab runs on row ``d``'s device, and a fault's
    lost slots recompute on the surviving rows' devices.  ``D`` is instead
    a row count of slabs on one card (every row in one launch, e.g. to
    exercise fault reissue there).  Planning and the graph and stats
    sinks' results are on ``device`` (CUDA unless ``"cpu"``; a mesh's
    first device by default).  ``slab_batch`` and ``slab_bytes`` size the
    slabs (see :class:`~repro_torch.serve.scheduler.Scheduler`).

    ``check`` scans each new slab signature once, on its first slab,
    for the contracts of :mod:`repro_torch.analyze` (a collective first):
    ``runtime.run_slab(check=True)``.
    """

    def __init__(self, P: int = 1, *, mesh=None, D: Optional[int] = None, device=None,
                 rng_impl: str = DEFAULT_RNG, slab_batch: int = 8,
                 slab_bytes: Optional[int] = None, cache_capacity: int = 64,
                 check: bool = True):
        self.P = int(P)
        self.rng_impl = rng_impl
        if D is not None:
            if mesh is not None:
                raise ValueError("give a Service a mesh or a row count D, not both")
            rows, self.device = int(D), runtime.resolve_device(device)
        else:
            rows, self.device = runtime.placement(self.P, mesh, device)
        self.mesh = rows
        self.cache = PlanCache(cache_capacity)
        self.registry = obs.Registry("repro_serve_")
        mesh_kw = {"mesh": rows} if isinstance(rows, LocalMesh) else {"D": rows}
        self.scheduler = Scheduler(slab_batch=slab_batch, slab_bytes=slab_bytes, **mesh_kw,
                                   registry=self.registry, device=self.device,
                                   check=check)
        self._inflight: List[Ticket] = []
        self.submitted = 0
        self.completed = 0
        self.syncs = 0      # device synchronizations made to stamp tickets
        r = self.registry
        self._m_submitted = r.counter(
            "requests_submitted_total", "requests admitted")
        self._m_completed = r.counter(
            "requests_completed_total", "requests fully delivered")
        self._m_latency = r.histogram(
            "ticket_latency_seconds", "submit-to-completion wall seconds")
        r.gauge("inflight_requests", "admitted but incomplete requests",
                fn=lambda: float(len(self._inflight)))
        for key in ("hits", "misses", "evictions", "entries"):
            r.gauge(f"plan_cache_{key}", f"plan cache {key}",
                    fn=(lambda k=key: float(self.cache.stats[k])))

    # ------------------------------------------------------------ requests

    def submit(self, spec, sink: object = "graph", *, overlap: int = 0) -> Ticket:
        """Admit one request; returns its :class:`Ticket` at once.

        ``sink`` selects the consumer: ``"graph"`` (materialize),
        ``"chunks"`` (streaming), ``"stats"`` (edge count and degrees
        only), or any :class:`~repro_torch.serve.sinks.Sink`.

        ``overlap > 0`` admits the request as a lazily segmented plan
        (:func:`repro_torch.api.plan_emitter` with that many segments):
        its PE-range segments are built on a background planner thread
        and join the queues as they land, so early slots ride slabs while
        later ranges are still planned.  Results are the cached path's;
        the plan cache is bypassed (segments are not reseedable plans).
        """
        t0 = time.perf_counter()
        with obs.trace("serve/admit", phase="plan", family=type(spec).__name__):
            if overlap:
                plan = plan_emitter(spec, self.P, segments=int(overlap),
                                    rng_impl=self.rng_impl, device=self.device)
            else:
                plan = self.cache.plan(spec, self.P, self.rng_impl, self.device)
        self.submitted += 1
        self._m_submitted.inc()
        if sink == "graph":
            sink = GraphSink(spec.num_vertices, spec.directed, self.device)
        elif sink == "chunks":
            sink = ChunkSink()
        elif sink == "stats":
            sink = StatsSink(spec.num_vertices, spec.directed, self.device,
                             self.mesh.devices if isinstance(self.mesh, LocalMesh) else ())
        elif not isinstance(sink, Sink):
            raise TypeError(f"unknown sink {sink!r}")
        ticket = Ticket(self, sink, t0)
        self.scheduler.enqueue(plan, sink)
        self._inflight.append(ticket)
        if ticket.done:  # zero-slot request (e.g. m == 0)
            self._settle()
        return ticket

    # ------------------------------------------------------------ progress

    def _settle(self) -> None:
        """Stamp the tickets that completed, after one synchronization of
        the card (their results are then on it)."""
        finished = [t for t in self._inflight if t.done]
        if not finished:
            return
        if self.device.type == "cuda":
            if isinstance(self.mesh, LocalMesh):
                self.mesh.sync()
            torch.cuda.synchronize(self.device)
            self.syncs += 1
        now = time.perf_counter()
        for t in finished:
            t.completed = now
            self.completed += 1
            self._m_completed.inc()
            self._m_latency.observe(t.latency)
        self._inflight = [t for t in self._inflight if not t.done]

    def tick(self) -> bool:
        """Make progress: execute one slab, or (queues empty while a
        background planner still emits segments) wait for the next
        segment.  False when nothing is pending.  A request may complete
        without a slab (its planner's end admitted), so every tick settles."""
        ran = self.scheduler.tick()
        if not ran and self.scheduler.emitting:
            self.scheduler.wait_segment()
            ran = True
        self._settle()
        return ran

    def drain(self) -> None:
        """Run until every admitted request has completed."""
        while self.tick():
            pass

    def drain_until(self, ticket: Ticket) -> None:
        while not ticket.done:
            if not self.tick() and not ticket.done:
                raise RuntimeError("scheduler idle but request incomplete")

    def serve(self, specs: Iterable) -> List[object]:
        """Submit every spec, drain, and return the results in submission
        order (Graphs, for the default sink)."""
        tickets = [self.submit(s) for s in specs]
        self.drain()
        return [t.result() for t in tickets]

    # ------------------------------------------------------------ metrics

    def inject_fault(self, dead_rows: Sequence[int],
                     at_slab: Optional[int] = None) -> None:
        """Test hook: the given slab rows die during one upcoming slab (see
        :meth:`repro_torch.serve.scheduler.Scheduler.inject_fault`)."""
        self.scheduler.inject_fault(dead_rows, at_slab)

    @property
    def stats(self) -> dict:
        return {
            "cache": self.cache.stats,
            "slabs": self.scheduler.slabs,
            "slots": self.scheduler.slots,
            "reissued": self.scheduler.reissued,
            "pending_slots": self.scheduler.pending,
            "submitted": self.submitted,
            "completed": self.completed,
            "inflight": len(self._inflight),
            "queue_depth": self.scheduler.pending,
        }

    def metrics(self) -> str:
        """The service's Prometheus text exposition: request counters,
        in-flight and queue gauges, the latency histogram, slab fill,
        slabs by packing group, plan-cache and fault-reissue counters (see
        :func:`repro_torch.obs.parse_exposition`)."""
        return self.registry.render()

    def latency_percentile(self, q: float) -> Optional[float]:
        """q-th ticket-latency percentile over recent completions."""
        return self._m_latency.percentile(q)


def serve(specs: Iterable, P: int = 1, **kwargs) -> List[object]:
    """One-shot convenience: serve ``specs`` on a fresh :class:`Service`.

    The same graphs, bit for bit, as ``[generate(s, P) for s in specs]``,
    with plan-cache reseeds and packed mixed-request slabs doing the
    work.  Keyword arguments go to :class:`Service`.
    """
    return Service(P, **kwargs).serve(list(specs))
