"""Per-PE streaming accumulators (port of ``repro.stats.accumulate``):
degree sections and the sampled clustering counters.

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

:class:`ClusteringSampler` counts, for a hashed vertex sample, each
sampled vertex's degree and the edges among its neighbours, in two
streaming passes; its second pass runs ``close_wedges`` on the stream's
device buffers, against the union of the sample rows (its
``WedgeTable``, built once).

On a mesh of several rows (``runtime.mesh_for(P)``, a ``LocalMesh``)
every chunk arrives on its row's card and is counted there:
:class:`Partials` keeps one degree array and one triangle-count vector a
row, on the row's card, and sums them once, onto the gathering card, at
the end; the sampler keeps its sample and wedge table once a card.
Integer sums are exact and do not depend on the order in which the rows'
chunks arrive, so the report is the one-device report.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.chunking import section_bounds
from ..core.prng import host_rng
from ..kernels.hist.ops import LOG2_BINS, bincount_ids, log2_histogram
from ..kernels.wedges.ops import WedgeTable, close_wedges, wedge_table

_TAG_SAMPLE = 71  # hashed stream for the clustering vertex sample
_NB_SENTINEL = 1 << 62  # neighbor-table padding: larger than any vertex id


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


class Partials:
    """Integer accumulators summed once: ``total`` on the gathering device,
    and one partial a key of ``places`` (a mesh row, or a card), on the
    device that key's chunks arrive on.  The first key on ``total``'s
    device counts into ``total`` itself; every other key has a zeroed
    partial of its own, so rows that share a card each keep theirs.
    :meth:`on` raises for a key ``places`` does not have or a device other
    than the key's; :meth:`sum` adds the partials onto ``total``, once.
    Integer sums are exact, so the sum does not depend on the order in
    which the keys' chunks were counted.  ``places=None`` is one key, 0,
    on ``total``'s device."""

    def __init__(self, total: torch.Tensor, places: Optional[dict] = None):
        self.total = total
        self.parts: Dict[object, torch.Tensor] = {}
        for key, dev in ({0: total.device} if places is None else places).items():
            own = torch.device(dev) == total.device and not any(
                p is total for p in self.parts.values())
            self.parts[key] = total if own else torch.zeros_like(total, device=dev)

    def on(self, key, device: torch.device) -> torch.Tensor:
        """The accumulator of ``key``, which must lie on ``device``."""
        part = self.parts.get(key)
        if part is None or part.device != device:
            raise ValueError(f"a chunk of {key!r} on {device}: no accumulator there (the "
                             f"places are {({k: str(p.device) for k, p in self.parts.items()})})")
        return part

    def sum(self) -> torch.Tensor:
        """``total`` with every other partial added in (once; later calls
        return it as it is, and :meth:`on` then raises)."""
        for part in self.parts.values():
            if part is not self.total:
                self.total += part.to(self.total.device)
        self.parts = {}
        return self.total


def _on_card(per_card: dict, card: torch.device, what: str):
    """The entry of ``card``; raises for a card the mesh does not have."""
    acc = per_card.get(card)
    if acc is None:
        raise ValueError(f"a chunk on {card}: no {what} there (the mesh's cards "
                         f"are {[str(c) for c in per_card]})")
    return acc


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


# --------------------------------------------------------------------------
# sampled clustering (wedge / triangle counters)
# --------------------------------------------------------------------------

def _in_sorted(sorted_vals: torch.Tensor, q: torch.Tensor):
    """(position, membership) of each ``q`` in the sorted unique
    ``sorted_vals`` (non-empty); the position is clamped into it."""
    pos = torch.searchsorted(sorted_vals, q.contiguous()).clamp(max=sorted_vals.numel() - 1)
    return pos, sorted_vals[pos] == q


class ClusteringSampler:
    """Exact local clustering for a hashed deterministic vertex sample.

    Two streaming passes: pass 1 (:meth:`observe`) collects each sampled
    vertex's neighbours, pass 2 (:meth:`count_triangles_chunk`) counts the
    edges closing its wedges.  The sample is ``host_rng(seed, 71).choice(n,
    samples, replace=False)``, a pure function of (seed, n), so reports
    are P-invariant and equal the reference's.

    Memory: O(samples * neighbor_cap + chunk).  The moment a sampled
    vertex's neighbour count passes ``neighbor_cap`` its stored
    neighbours are dropped (only the count keeps growing); it is left out
    of the estimate (``valid`` False) with its exact degree reported.
    Whether it overflows depends only on its final count, so it is P- and
    order-invariant too.

    ``places`` maps each mesh row to its card (``None``: one row, 0, on
    ``device``).  Each card holds the sample and, from pass 2 on, the
    wedge table (built once on the host, copied to the card at its first
    use there); each row counts its chunks' triangles on its card
    (:class:`Partials`), and :meth:`report` sums the rows' counts once,
    onto ``device``."""

    def __init__(self, n: int, seed: int, samples: int, neighbor_cap: int, device,
                 places: Optional[dict] = None):
        rng = host_rng(seed, _TAG_SAMPLE)
        self.sample = np.sort(rng.choice(n, size=min(max(samples, 0), n), replace=False))
        self.neighbor_cap = neighbor_cap
        self.device = torch.device(device)
        S = len(self.sample)
        self._triangles = Partials(torch.zeros(max(1, S), dtype=torch.int64,
                                               device=self.device), places)
        sample = torch.from_numpy(self.sample.astype(np.int64))
        # card -> [the sample, the wedge table (pass 2)]
        self._cards: Dict[torch.device, list] = {
            part.device: [sample.to(part.device), None]
            for part in self._triangles.parts.values()}
        self._parts: List[List[np.ndarray]] = [[] for _ in range(S)]
        self._count = np.zeros(S, np.int64)
        self._overflow = np.zeros(S, bool)
        self.neighbors: Optional[List[np.ndarray]] = None
        self._table: Optional[WedgeTable] = None

    def observe(self, e: torch.Tensor) -> None:
        """Pass 1: record the neighbours of sampled endpoints of one
        chunk's edges ``e`` (``[k, 2]``).  The endpoints are matched
        against the sample on ``e``'s device; only the hits come to the
        host.  The exact-union stream has no duplicate undirected edges,
        so occurrence counts are degrees."""
        if not len(self.sample) or not e.numel():
            return
        sample = _on_card(self._cards, e.device, "clustering sample")[0]
        pos, hit = zip(*(_in_sorted(sample, e[:, col]) for col in (0, 1)))
        p = torch.cat([pos[0][hit[0]], pos[1][hit[1]]]).cpu().numpy()
        o = torch.cat([e[hit[0], 1], e[hit[1], 0]]).cpu().numpy()
        if not len(p):
            return
        self._count += np.bincount(p, minlength=len(self.sample))
        over = (self._count > self.neighbor_cap) & ~self._overflow
        for si in np.nonzero(over)[0]:    # a hub: drop its storage, keep counting
            self._parts[si] = []
        self._overflow |= over
        for si in np.unique(p):  # repro: allow(no-numpy-unique) O(samples) host loop over sampled vertex ids
            if not self._overflow[si]:
                self._parts[si].append(o[p == si])

    def finalize_neighbors(self) -> None:
        """End pass 1: each sample's sorted, distinct neighbours."""
        self.neighbors = [
            np.unique(np.concatenate(parts)) if parts else np.zeros(0, np.int64)  # repro: allow(no-numpy-unique) O(neighbor_cap) per sampled vertex, host side
            for parts in self._parts]
        self._parts = []

    @property
    def has_work(self) -> bool:
        """Whether pass 2 could count anything: an eligible sample with a
        wedge to close.  False means the second pass can be skipped."""
        return any(not self._overflow[si] and len(nb) >= 2
                   for si, nb in enumerate(self.neighbors))

    def _neighbor_table(self) -> torch.Tensor:
        """Sorted, sentinel-padded ``[S, NB]`` neighbour matrix on the
        host; overflowed samples have empty (all-sentinel) rows."""
        nb_max = max((len(nb) for nb in self.neighbors), default=0)
        tbl = np.full((max(1, len(self.sample)), max(1, nb_max)), _NB_SENTINEL, np.int64)
        for i, nb in enumerate(self.neighbors):
            tbl[i, : len(nb)] = nb
        return torch.from_numpy(tbl)

    def _wedge_table(self, card: torch.device) -> WedgeTable:
        """The union of the neighbour rows as ``close_wedges`` probes it,
        on ``card``: built once on the host, at the first call of pass 2,
        and copied to each card at its first use there."""
        entry = _on_card(self._cards, card, "clustering sample")
        if entry[1] is None:
            if self._table is None:
                self._table = wedge_table(self._neighbor_table(), device="cpu")
            entry[1] = WedgeTable(self._table.samples, *(t.to(card) for t in self._table[1:]))
        return entry[1]

    def count_triangles_chunk(self, buffer: torch.Tensor, count: Optional[int] = None,
                              mask: Optional[torch.Tensor] = None, row=0) -> None:
        """Pass 2: close sampled wedges against one stream buffer of mesh
        row ``row``, on its card (``close_wedges``).  ``mask`` is a
        scattered validity mask (pair buffers, batched ``[b, cap^2, 2]``
        ones flatten), ``count`` a validity prefix (a chunk buffer);
        ``mask`` wins when both are given, and with neither every slot is
        valid."""
        if self.neighbors is None:
            raise RuntimeError("finalize_neighbors() must run before pass 2")
        if not len(self.sample) or not max((len(nb) for nb in self.neighbors), default=0):
            return
        buf = buffer.reshape(-1, 2)
        out = self._triangles.on(row, buf.device)
        close_wedges(buf, self._wedge_table(buf.device),
                     mask=None if mask is None else mask.reshape(-1), count=count, out=out)

    def report(self) -> "ClusteringReport":
        """The report; the rows' triangle counts are summed here, once."""
        deg = self._count.copy()
        valid = (deg >= 2) & ~self._overflow
        tri = self._triangles.sum()
        return ClusteringReport(sample=self.sample, degree=deg,
                                triangles=tri.cpu().numpy()[: len(self.sample)],
                                wedges=deg * (deg - 1) // 2, valid=valid)


@dataclass
class ClusteringReport:
    """Exact wedge/triangle counts over the deterministic vertex sample
    (host arrays, as the sample is drawn on the host)."""
    sample: np.ndarray      # sampled vertex ids, sorted
    degree: np.ndarray      # exact degree of each sampled vertex
    triangles: np.ndarray   # edges among its neighbors (== closed wedges)
    wedges: np.ndarray      # C(degree, 2)
    valid: np.ndarray       # bool: in-estimate (2 <= degree <= cap)

    @property
    def global_cc(self) -> float:
        """sum(closed) / sum(wedges) over the sample (transitivity-style)."""
        w = int(self.wedges[self.valid].sum())
        return float(self.triangles[self.valid].sum() / w) if w else 0.0

    @property
    def mean_local_cc(self) -> float:
        v = self.valid
        if not v.any():
            return 0.0
        return float((self.triangles[v] / self.wedges[v]).mean())
