"""Per-request result sinks: demux targets of the slab scheduler (port of
``repro.serve.sinks``).

The scheduler delivers runs of consecutive slots: ``(seq, payload [k,
...], mask [k, L], pe [k])`` for slots ``seq .. seq + k - 1`` of one
request, possibly out of order when a fault reissues retired slots.
Every sink reassembles by sequence number, so the consumed stream is
always the plan's stream order whatever the packing, the admission
timing or the failures: concatenating the masked rows reproduces
``generate(spec, P)`` bit for bit.  Payloads stay on the device their
slab row ran on; the graph and stats sinks gather onto their own.

* :class:`GraphSink` materializes the request into the port's
  :class:`repro_torch.api.Graph` (the ``serve()`` default), its edges on
  the device;
* :class:`ChunkSink` buffers :class:`repro_torch.api.EdgeChunk` objects
  for streaming (``Ticket.chunks()`` drives the scheduler between
  yields);
* :class:`StatsSink` folds each run into an edge count and a degree
  array on the card it ran on (through ``hist``'s ``bincount_ids``),
  drops the buffers, and sums the cards' counts once, at the end.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ["Sink", "GraphSink", "ChunkSink", "StatsSink"]


class Sink:
    """Base sink: in-order reassembly of delivered runs of slots.

    Subclasses override ``_consume(seq, payload, mask, pe)`` (called in
    strict sequence order, once a run) and ``_finish()`` (called once,
    after the last slot).  ``expect(total)`` arrives at admission; a
    request with zero slots finishes at once.
    """

    def __init__(self):
        self._pending: Dict[int, Tuple[int, torch.Tensor, torch.Tensor, np.ndarray]] = {}
        self._next = 0
        self._total: Optional[int] = None
        self.done = False

    def expect(self, total: int) -> None:
        self._total = int(total)
        self._maybe_finish()

    def deliver(self, seq: int, payload: torch.Tensor, mask: torch.Tensor,
                pe: np.ndarray) -> None:
        """Slots ``seq .. seq + len(pe) - 1``: their payload rows, masks
        and owning PEs."""
        if self.done:
            raise RuntimeError(f"delivery after completion (seq {seq})")
        self._pending[int(seq)] = (len(pe), payload, mask, pe)
        while self._next in self._pending:
            k, p, m, e = self._pending.pop(self._next)
            self._consume(self._next, p, m, e)
            self._next += k
        self._maybe_finish()

    def _maybe_finish(self) -> None:
        if not self.done and self._total is not None and self._next == self._total:
            self.done = True
            self._finish()

    def _consume(self, seq: int, payload, mask, pe) -> None:
        raise NotImplementedError

    def _finish(self) -> None:
        pass


class GraphSink(Sink):
    """Materialize the request into a :class:`repro_torch.api.Graph`: the
    edges ``generate(spec, P)`` returns, on ``device``."""

    def __init__(self, n: int, directed: bool, device):
        super().__init__()
        self.n = int(n)
        self.directed = bool(directed)
        self.device = torch.device(device)
        self._parts = []
        self.graph = None

    def _consume(self, seq: int, payload, mask, pe) -> None:
        self._parts.append(payload[mask].to(self.device))

    def _finish(self) -> None:
        from ..api import Graph

        edges = (torch.cat(self._parts) if self._parts
                 else torch.zeros((0, 2), dtype=torch.int64, device=self.device))
        self._parts = []
        self.graph = Graph(edges=edges, n=self.n, directed=self.directed)

    def result(self):
        if not self.done:
            raise RuntimeError("request not complete; drain the service")
        return self.graph


class ChunkSink(Sink):
    """Buffer per-slot edge chunks for streaming.

    ``ready`` holds :class:`repro_torch.api.EdgeChunk` objects in stream
    order (``count`` is ``None``: ``mask`` is authoritative, as on the
    overlapped stream); :meth:`repro_torch.serve.service.Ticket.chunks`
    pops them while ticking the scheduler.
    """

    def __init__(self):
        super().__init__()
        self.ready: deque = deque()

    def _consume(self, seq: int, payload, mask, pe) -> None:
        from ..api import EdgeChunk

        for i in range(len(pe)):
            self.ready.append(EdgeChunk(buffer=payload[i], mask=mask[i], count=None,
                                        pe=int(pe[i])))

    def result(self):
        if not self.done:
            raise RuntimeError("request not complete; drain the service")
        return list(self.ready)


class StatsSink(Sink):
    """Accumulate the edge count and the degree array without
    materializing the edges.

    Each run's masked-out slots become id -1, which ``bincount_ids``
    drops, so one :func:`repro_torch.core.graph.degrees` fold a run adds
    exactly the valid edges' endpoints: ``degrees`` equals the
    materialized graph's (degrees add over any partition of the edges).
    A run is counted on the card it lies on, one of ``device`` and
    ``cards`` (a run on another raises), into that card's edge count and
    degree array (:class:`repro_torch.stats.accumulate.Partials`); no
    payload crosses cards, and :meth:`result` sums the cards' counts
    once, onto ``device``.
    """

    def __init__(self, n: int, directed: bool, device, cards=()):
        from ..stats.accumulate import Partials

        super().__init__()
        self.n = int(n)
        self.directed = bool(directed)
        self.device = torch.device(device)
        places = {c: c for c in dict.fromkeys((self.device, *map(torch.device, cards)))}
        self._count = Partials(torch.zeros((), dtype=torch.int64, device=self.device), places)
        self._degrees = Partials(torch.zeros(self.n, dtype=torch.int64, device=self.device),
                                 places)
        self._result = None

    def _consume(self, seq: int, payload, mask, pe) -> None:
        from ..core import graph as _graph

        card = payload.device
        self._count.on(card, card).add_(mask.sum())
        ids = torch.where(mask[..., None], payload, -1).reshape(-1, 2)
        _graph.degrees(ids, self.n, self.directed, out=self._degrees.on(card, card))

    @property
    def num_edges(self) -> int:
        if self._result is not None:
            return self._result["num_edges"]
        return sum(int(count) for count in self._count.parts.values())

    def result(self):
        if not self.done:
            raise RuntimeError("request not complete; drain the service")
        if self._result is None:
            self._result = {"num_edges": int(self._count.sum()),
                            "degrees": self._degrees.sum()}
        return self._result
