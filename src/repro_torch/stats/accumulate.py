"""Per-PE degree accumulators (port of the degree half of
``repro.stats.accumulate``).

The engine streams each owned chunk exactly once, so the stream is the
exact global edge multiset and accumulation is pure addition.  Vertex v
belongs to exactly one PE's contiguous section (the generators' own
vertex partition); that PE's :class:`SectionDegrees` counts it, and the
per-PE results merge additively -- each vertex counted once, for any P.

The sections of one pass are contiguous and cover ``[0, n)``, so
:func:`section_views` makes them views of one int64 ``[n]`` degree array
and a chunk's endpoint ids take one ``bincount_ids`` launch into it:
that is the reference's host split (``VertexOwnership.split``) without
the host round trip, and without a launch per section.  A standalone
:class:`SectionDegrees` owns its array and counts only its own ids,
through the hist kernel's drop rule.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from ..core.chunking import section_bounds
from ..kernels.hist.ops import LOG2_BINS, bincount_ids, log2_histogram


class VertexOwnership:
    """Canonical vertex -> PE map: the contiguous section split."""

    def __init__(self, n: int, P: int):
        self.n, self.P = n, P
        self.bounds = [section_bounds(n, P, i)[0] for i in range(P)] + [n]


class SectionDegrees:
    """One PE's degree accumulator over its vertex section ``[lo, hi)``:
    an int64 device array the chunks' endpoint ids are added into (its
    own, or ``deg``, a view of a whole pass's array)."""

    def __init__(self, lo: int, hi: int, device, deg: Optional[torch.Tensor] = None):
        self.lo, self.hi = int(lo), int(hi)
        self.size = self.hi - self.lo
        self.deg = (torch.zeros(self.size, dtype=torch.int64, device=device)
                    if deg is None else deg)

    def add(self, global_ids: torch.Tensor) -> None:
        """Count the ids that fall in this section; others are dropped."""
        if global_ids.numel():
            bincount_ids(global_ids - self.lo, self.size, out=self.deg)

    def log2_hist(self) -> torch.Tensor:
        return log2_histogram(self.deg)

    def moments(self) -> List[int]:
        """[sum, sum of squares, max, number of zeros] of the section."""
        d = self.deg
        if not self.size:
            return [0, 0, 0, 0]
        m = torch.stack([d.sum(), (d * d).sum(), d.max(), (d == 0).sum()])
        return [int(x) for x in m.tolist()]


def section_views(bounds: List[int], device) -> Tuple[torch.Tensor, List[SectionDegrees]]:
    """One int64 ``[n]`` degree array for the contiguous sections
    ``bounds`` (``VertexOwnership.bounds``) and a :class:`SectionDegrees`
    viewing each section of it."""
    deg = torch.zeros(bounds[-1], dtype=torch.int64, device=device)
    return deg, [SectionDegrees(lo, hi, device, deg[lo:hi])
                 for lo, hi in zip(bounds, bounds[1:])]


@dataclass
class DegreeSummary:
    """Merged (cross-PE) degree statistics for one orientation.

    ``degrees`` is only present in exact mode; the log2 histogram and
    moments are always exact."""
    log2_hist: torch.Tensor         # int64 [LOG2_BINS]
    deg_sum: int
    deg_sumsq: int
    deg_max: int
    num_isolated: int
    degrees: Optional[torch.Tensor] = None   # int64 [n], exact mode only

    @property
    def mean(self) -> float:
        return self.deg_sum / max(1, int(self.log2_hist.sum()))

    @property
    def variance(self) -> float:
        n = max(1, int(self.log2_hist.sum()))
        mu = self.deg_sum / n
        return self.deg_sumsq / n - mu * mu


def merge_sections(accs: List[SectionDegrees], exact: bool) -> DegreeSummary:
    """Additive cross-PE merge: histograms and moments sum; the exact
    path concatenates the per-PE sections (vertex-id order)."""
    hist = torch.zeros(LOG2_BINS, dtype=torch.int64, device=accs[0].deg.device)
    total, total_sq, deg_max, isolated = 0, 0, 0, 0
    for a in accs:
        hist += a.log2_hist()
        s, sq, mx, zeros = a.moments()
        total, total_sq, isolated = total + s, total_sq + sq, isolated + zeros
        deg_max = max(deg_max, mx)
    degrees = torch.cat([a.deg for a in accs]) if exact else None
    return DegreeSummary(log2_hist=hist, deg_sum=total, deg_sumsq=total_sq,
                         deg_max=deg_max, num_isolated=isolated, degrees=degrees)
