"""Fault tolerance & straggler mitigation for communication-free
generation (and the data pipeline built on it).

The paper's paradigm makes fault tolerance almost free: a chunk is a
*pure function* of (seed, chunk id), so recovery = recomputation, never
state transfer.  We exploit this three ways:

* **Over-decomposition**: generate k = c * P_virtual chunks and map
  virtual chunks -> physical workers.  The virtual chunk count is fixed
  at job creation (it determines the graph), the physical worker set is
  elastic.

* **Elastic reassignment**: when workers die (or join), the chunk->worker
  map is recomputed deterministically from the surviving roster — every
  survivor agrees without coordination beyond roster membership.

* **Straggler mitigation**: chunks carry deterministic cost estimates
  (expected edges from the plan); LPT (longest-processing-time-first)
  assignment bounds makespan at (4/3 - 1/(3P)) * OPT, and any idle
  worker may *steal* a pending chunk by recomputing it — no data motion.

The live consumer of this module is the serving scheduler
(:mod:`repro_torch.serve.scheduler`): slab slots are placed by a
:class:`ChunkAssignment` over the slab's D rows, and when rows die
mid-slab the lost slots retire and reissue onto the surviving rows given
by :func:`reassign_after_failure`, with delivered output bit-identical
to the failure-free run (tests/test_torch_serve.py).  A copy of
``repro.distrib.fault``, plus :meth:`ChunkAssignment.workers_of`.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class ChunkAssignment:
    """Deterministic chunk -> worker map over a (possibly degraded) roster."""
    num_chunks: int
    workers: Tuple[int, ...]          # surviving physical worker ids, sorted
    costs: Tuple[float, ...] | None = None

    def worker_of(self, chunk: int) -> int:
        if self.costs is None:
            return self.workers[chunk % len(self.workers)]
        return self._lpt_map()[chunk]

    def workers_of(self, chunks) -> np.ndarray:
        """:meth:`worker_of` of every chunk id in ``chunks``, as an array
        (the port's addition: the serving scheduler places a slab's slots
        at once)."""
        chunks = np.asarray(chunks, np.int64)
        if self.costs is None:
            return np.asarray(self.workers, np.int64)[chunks % len(self.workers)]
        lpt = self._lpt_map()
        return np.fromiter((lpt[c] for c in chunks.tolist()), np.int64, len(chunks))

    def chunks_of(self, worker: int) -> List[int]:
        return [c for c in range(self.num_chunks) if self.worker_of(c) == worker]

    def _lpt_map(self) -> Dict[int, int]:
        # deterministic LPT: ties broken by chunk id then worker id
        order = sorted(range(self.num_chunks), key=lambda c: (-self.costs[c], c))
        heap = [(0.0, w) for w in self.workers]
        heapq.heapify(heap)
        out: Dict[int, int] = {}
        for c in order:
            load, w = heapq.heappop(heap)
            out[c] = w
            heapq.heappush(heap, (load + self.costs[c], w))
        return out

    def makespan(self) -> float:
        loads: Dict[int, float] = {w: 0.0 for w in self.workers}
        for c in range(self.num_chunks):
            loads[self.worker_of(c)] += (self.costs[c] if self.costs else 1.0)
        return max(loads.values())


def reassign_after_failure(
    assignment: ChunkAssignment, dead: Sequence[int]
) -> ChunkAssignment:
    """New deterministic map over survivors.  Lost chunks are recomputed
    from (seed, chunk id) — zero state transfer."""
    survivors = tuple(w for w in assignment.workers if w not in set(dead))
    if not survivors:
        raise RuntimeError("no survivors")
    return ChunkAssignment(assignment.num_chunks, survivors, assignment.costs)
