"""``GraphSpec -> plan -> run`` front door of the PyTorch/CUDA port (the
Erdős-Rényi slice of ``repro.api``).

1. **Spec**: :class:`GNM` / :class:`GNP`, frozen dataclasses carrying the
   seed and the model parameters.
2. **Plan**: ``spec.plan(P, rng_impl=...)`` runs the host recursion and
   emits the ``[P, C]`` ChunkPlan table, equal field by field to the
   reference's.
3. **Run / stream**: :func:`generate` executes the whole table and
   returns a :class:`Graph`; :func:`iter_edge_chunks` yields one chunk's
   fixed-capacity buffer at a time.  :func:`collect` measures degrees
   while streaming (:mod:`repro_torch.stats`).

Every entry point takes ``device``: the work runs on CUDA unless the
caller passes ``device="cpu"`` (the plain PyTorch versions of the
kernels), and asking for CUDA without a GPU raises.  ``generate(spec,
P)`` gives the same edges, bit for bit, as ``repro.api.generate(spec,
P)``, for every P.

    >>> from repro_torch.api import GNM, generate
    >>> g = generate(GNM(n=1000, m=8000, seed=1), P=4, device="cpu")
    >>> g.m, g.n
    (8000, 1000)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

import torch

from .core import er as _er
from .core import graph as _graph
from .core.prng import THREEFRY
from .distrib import engine, runtime

DEFAULT_RNG = THREEFRY

# default virtual chunk-grid size: any P <= 16 generates the identical
# instance; larger machines grow the grid (chunks >= PEs)
DEFAULT_CHUNKS = 16


def _virtual_chunks(chunks: Optional[int], P: int) -> int:
    return chunks if chunks else max(P, DEFAULT_CHUNKS)


@dataclass(frozen=True)
class Graph:
    """Generated edge list plus the metadata needed to interpret it."""
    edges: torch.Tensor             # int64 [m, 2] on the run's device
    n: int
    directed: bool = False

    @property
    def m(self) -> int:
        return len(self.edges)

    def degrees(self) -> torch.Tensor:
        return _graph.degrees(self.edges, self.n, self.directed)


@dataclass(frozen=True)
class EdgeChunk:
    """One streamed chunk: a fixed-capacity device buffer + validity.

    ``mask`` is the validity (``[cap]``, or ``[b, cap]`` for batched
    buffers ``[b, cap, 2]``); ``count`` is the host-known number of valid
    edges; ``pe`` the virtual PE that owns the chunk."""
    buffer: torch.Tensor            # int64 [cap, 2] / [b, cap, 2]
    mask: torch.Tensor              # bool [cap] / [b, cap]
    count: int
    pe: int

    def edges(self) -> torch.Tensor:
        """The chunk's valid edges, on its device."""
        return self.buffer[self.mask]


@dataclass(frozen=True)
class GNM:
    """Erdős-Rényi G(n, m): exactly m distinct edges (paper §4)."""
    n: int
    m: int
    directed: bool = False
    seed: int = 0
    chunks: Optional[int] = None

    @property
    def num_vertices(self) -> int:
        return self.n

    def plan(self, P: int, *, rng_impl: str = DEFAULT_RNG):
        k = _virtual_chunks(self.chunks, P)
        f = _er.gnm_directed_plan if self.directed else _er.gnm_undirected_plan
        return engine.deal_plan(f(self.seed, self.n, self.m, k, rng_impl), P)


@dataclass(frozen=True)
class GNP:
    """Erdős-Rényi G(n, p): Bernoulli(p) per vertex pair (paper §4.3)."""
    n: int
    p: float
    directed: bool = False
    seed: int = 0
    chunks: Optional[int] = None

    @property
    def num_vertices(self) -> int:
        return self.n

    def plan(self, P: int, *, rng_impl: str = DEFAULT_RNG):
        k = _virtual_chunks(self.chunks, P)
        f = _er.gnp_directed_plan if self.directed else _er.gnp_undirected_plan
        return engine.deal_plan(f(self.seed, self.n, self.p, k, rng_impl), P)


def generate(spec, P: int = 1, *, device=None, rng_impl: str = DEFAULT_RNG) -> Graph:
    """Generate ``spec`` across P virtual PEs on ``device`` (CUDA unless
    ``"cpu"``); returns a :class:`Graph` whose edges are the
    reference's, in the reference's order."""
    dev = runtime.resolve_device(device)
    payload, valid = runtime.run(spec.plan(P, rng_impl=rng_impl), dev)
    return Graph(edges=payload[valid], n=spec.num_vertices, directed=spec.directed)


def iter_edge_chunks(spec, P: int = 1, *, device=None,
                     rng_impl: str = DEFAULT_RNG, batch: int = 1,
                     prefetch: int = 2) -> Iterator[EdgeChunk]:
    """Stream ``spec``'s edges as :class:`EdgeChunk` rows, pe-major.

    Grouping the chunks by ``pe`` and concatenating ``chunk.edges()``
    reproduces ``generate(spec, P).edges``; on one device the stream
    order is generate order.  ``batch > 1`` yields batched buffers."""
    dev = runtime.resolve_device(device)
    plan = spec.plan(P, rng_impl=rng_impl)
    for pe, slots, payload, valid in runtime.stream_slots(
            plan, batch=batch, prefetch=prefetch, device=dev):
        count = int(plan.count[pe, slots].sum())
        if batch <= 1:
            yield EdgeChunk(buffer=payload[0], mask=valid[0], count=count, pe=int(pe))
        else:
            yield EdgeChunk(buffer=payload, mask=valid, count=count, pe=int(pe))


def collect(spec, P: int = 1, **kwargs):
    """Streaming degree statistics of ``spec``:
    :func:`repro_torch.stats.collect` (re-export)."""
    from .stats import collect as _collect

    return _collect(spec, P, **kwargs)
