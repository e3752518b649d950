"""``collect(spec, P) -> StatsReport``: streaming degree statistics (port
of the degree path of ``repro.stats.collect``).

Drives :func:`repro_torch.api.iter_edge_chunks` once and adds every
chunk's endpoints into the per-PE section accumulators on the device.
Peak memory is the accumulators plus one chunk buffer, never the edge
list; the report is identical for every P and equal to the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

import torch

from ..kernels.hist.ops import bincount_ids
from .accumulate import DegreeSummary, SectionDegrees, VertexOwnership, merge_sections

# above this the exact per-vertex degree array is no longer returned;
# log2 histograms + moments remain exact at any scale
EXACT_N_LIMIT = 1 << 22

DEFAULT_METRICS = ("degree",)
KNOWN_METRICS = ("degree", "clustering")


@dataclass(frozen=True)
class StatsReport:
    """What one streaming pass measures; every field is exact and
    P-invariant."""
    n: int
    P: int
    directed: bool
    mode: str                           # 'exact' | 'binned'
    num_edges: int
    degree: DegreeSummary               # undirected / out-degree view
    in_degree: Optional[DegreeSummary] = None   # directed only
    metrics: Tuple[str, ...] = field(default=DEFAULT_METRICS)

    @property
    def mean_degree(self) -> float:
        """Average (out-)degree over all n vertices."""
        return self.degree.deg_sum / max(1, self.n)

    def degree_counts(self) -> torch.Tensor:
        """Exact degree-value histogram counts[0 .. deg_max] (exact mode
        only), through the hist kernel."""
        if self.degree.degrees is None:
            raise ValueError("degree_counts needs mode='exact'")
        return bincount_ids(self.degree.degrees, self.degree.deg_max + 1)


def collect(
    spec,
    P: int = 1,
    *,
    metrics: Sequence[str] = DEFAULT_METRICS,
    mode: Optional[str] = None,
    device=None,
    rng_impl: str = "threefry2x32",
) -> StatsReport:
    """Stream ``spec`` on P virtual PEs and measure its degrees.

    mode: 'exact' keeps the full per-vertex degree array (default for
    n <= 2^22), 'binned' keeps only log2 histograms + exact moments.
    Chunks stream one at a time, so one chunk's ``[capacity, 2]``
    buffer is the peak beyond the accumulators."""
    from .. import api
    from ..distrib.runtime import resolve_device

    unknown = set(metrics) - set(KNOWN_METRICS)
    if unknown:
        raise ValueError(f"unknown metrics {sorted(unknown)}; know {KNOWN_METRICS}")
    if "clustering" in metrics:
        raise NotImplementedError(
            "the clustering sampler is not ported yet: it is the next "
            "item of the port (ROADMAP queue 1, item 8, stats/)")
    dev = resolve_device(device)
    n, directed = spec.num_vertices, spec.directed
    mode = mode or ("exact" if n <= EXACT_N_LIMIT else "binned")
    if mode not in ("exact", "binned"):
        raise ValueError(f"unknown mode {mode!r}")

    bounds = VertexOwnership(n, P).bounds
    out_acc = [SectionDegrees(bounds[pe], bounds[pe + 1], dev) for pe in range(P)]
    in_acc = ([SectionDegrees(bounds[pe], bounds[pe + 1], dev) for pe in range(P)]
              if directed else None)

    num_edges = 0
    for chunk in api.iter_edge_chunks(spec, P, device=dev, rng_impl=rng_impl):
        e = chunk.edges()
        num_edges += chunk.count
        for acc in out_acc:
            acc.add(e[:, 0] if directed else e)
        if directed:
            for acc in in_acc:
                acc.add(e[:, 1])

    exact = mode == "exact"
    return StatsReport(
        n=n, P=P, directed=directed, mode=mode, num_edges=num_edges,
        degree=merge_sections(out_acc, exact),
        in_degree=merge_sections(in_acc, exact) if directed else None,
        metrics=tuple(metrics),
    )
