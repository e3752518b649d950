"""repro_torch.serve: multi-tenant batched generation as a service on one
card (port of ``repro.serve``).

Many concurrent GraphSpec requests (mixed families, seeds, sizes) are
served from one device: plans resolve through a reseeding
:class:`PlanCache` (structure cached by spec shape, seeds swapped in),
ready slots of different requests pack into shared ``[D, B]`` slabs run
by the port's kernels, and per-request sinks reassemble streams equal to
``generate(spec, P)`` bit for bit.

    >>> from repro_torch.api import GNM, BA
    >>> from repro_torch.serve import Service
    >>> svc = Service(P=4, slab_batch=16, device="cpu")
    >>> a = svc.submit(GNM(n=1000, m=8000, seed=1))
    >>> b = svc.submit(BA(n=500, d=4, seed=2), sink="stats")
    >>> svc.drain()
    >>> a.result().m, b.result()["num_edges"]
    (8000, 2000)
"""
from .plancache import PlanCache, spec_shape
from .scheduler import Scheduler, SlabProgram, program_of
from .service import Service, Ticket, serve
from .sinks import ChunkSink, GraphSink, Sink, StatsSink

__all__ = [
    "PlanCache", "spec_shape",
    "Scheduler", "SlabProgram", "program_of",
    "Service", "Ticket", "serve",
    "Sink", "GraphSink", "ChunkSink", "StatsSink",
]
