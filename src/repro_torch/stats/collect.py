"""``collect(spec, P) -> StatsReport``: streaming graph analytics (port of
``repro.stats.collect``).

Drives :func:`repro_torch.api.iter_edge_chunks` once (twice with
clustering: the second pass regenerates, it does not store) and adds
every chunk's endpoints into the per-PE section accumulators on the
device: the sections are views of one degree array, so a chunk is one
hist launch whatever P is.  Peak memory is the accumulators plus one
chunk buffer, never the edge list; the report is identical for every P
and equal to the reference's.

Like the reference's, it streams on the default mesh
(``runtime.mesh_for(P)``: every local card that divides P) unless
``device`` names the CPU or one card.  On a mesh of several rows each
chunk is counted on the card of the row that streamed it
(``runtime.stream_row``), into that row's partial accumulators
(:class:`.accumulate.Partials`: its degree arrays and triangle counts);
no chunk buffer crosses cards, and the partial counts are summed once,
on the gathering card, at the end.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

import torch

from ..kernels.hist.ops import bincount_ids
from .accumulate import (ClusteringReport, ClusteringSampler, DegreeSummary, Partials,
                         VertexOwnership, merge_sections, section_views)

# above this the exact per-vertex degree array is no longer returned;
# log2 histograms + moments remain exact at any scale
EXACT_N_LIMIT = 1 << 22

DEFAULT_METRICS = ("degree",)
KNOWN_METRICS = ("degree", "clustering")


@dataclass(frozen=True)
class StatsReport:
    """What one streaming pass measures.  Every non-sampled field is
    exact and P-invariant; clustering is exact on its (deterministic)
    vertex sample."""
    n: int
    P: int
    directed: bool
    mode: str                           # 'exact' | 'binned'
    num_edges: int
    degree: DegreeSummary               # undirected / out-degree view
    in_degree: Optional[DegreeSummary] = None   # directed only
    clustering: Optional[ClusteringReport] = None
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
    mesh=None,
    rng_impl: str = "threefry2x32",
    batch: int = 256,
    cluster_samples: int = 64,
    neighbor_cap: int = 8192,
) -> StatsReport:
    """Stream ``spec`` on P virtual PEs and measure it.

    metrics: subset of {'degree', 'clustering'}; clustering costs a
    second streaming pass and requires an undirected family.
    mode: 'exact' keeps the full per-vertex degree array (default for
    n <= 2^22), 'binned' keeps only log2 histograms + exact moments.
    batch: candidate pairs per wave for the geometric (PairPlan)
    families, whose rows are small (``capacity^2`` slots); ChunkPlan
    chunks stream one at a time, so one chunk's ``[capacity, 2]``
    buffer is the peak beyond the accumulators.
    cluster_samples, neighbor_cap: the clustering sample's size and the
    neighbour count past which a sampled vertex leaves the estimate.
    device, mesh: as in :func:`repro_torch.api.generate`: ``mesh=None`` is
    ``runtime.mesh_for(P)`` unless ``device`` is the CPU or an indexed
    card (one row there, the one-device path); on a
    :class:`~repro_torch.distrib.world.LocalMesh` the report is gathered
    on ``device``, by default the mesh's first.  A
    :class:`~repro_torch.distrib.world.World` raises: a report of one
    rank's PEs would need a reduction across processes, which the
    reference does not have either."""
    from .. import api
    from ..distrib.runtime import placement, stream_row
    from ..distrib.world import LocalMesh, World

    unknown = set(metrics) - set(KNOWN_METRICS)
    if unknown:
        raise ValueError(f"unknown metrics {sorted(unknown)}; know {KNOWN_METRICS}")
    if isinstance(mesh, World):
        raise ValueError("collect and validate run in one process, on a LocalMesh of its "
                         "local devices, not on a World of ranks: a report needs every PE, "
                         "and the reference has no cross-process reduction for one")
    rows, dev = placement(P, mesh, device)
    # each mesh row's card; a row count on one device is one place
    places = dict(enumerate(rows.devices)) if isinstance(rows, LocalMesh) else None
    n, directed = spec.num_vertices, spec.directed
    mode = mode or ("exact" if n <= EXACT_N_LIMIT else "binned")
    if mode not in ("exact", "binned"):
        raise ValueError(f"unknown mode {mode!r}")
    if "clustering" in metrics and directed:
        raise ValueError("clustering is defined for undirected families only")

    bounds = VertexOwnership(n, P).bounds
    out_deg, out_acc = section_views(bounds, dev)
    in_deg, in_acc = section_views(bounds, dev) if directed else (None, None)
    out_deg = Partials(out_deg, places)
    in_deg = Partials(in_deg, places) if directed else None
    sampler = (ClusteringSampler(n, spec.seed, cluster_samples, neighbor_cap, dev, places)
               if "clustering" in metrics else None)

    def row(chunk) -> int:
        return 0 if places is None else stream_row(P, len(places), chunk.pe)

    # PairPlan rows are O(capacity^2) with tiny capacities; ChunkPlan
    # buffers are O(capacity) with large ones
    batch = batch if isinstance(spec, (api.RGG, api.RHG, api.RDG)) else 1
    num_edges = 0
    for chunk in api.iter_edge_chunks(spec, P, device=dev, mesh=rows, rng_impl=rng_impl,
                                      batch=batch):
        e = chunk.edges()
        num_edges += len(e)
        if len(e):
            r = row(chunk)
            bincount_ids(e[:, 0] if directed else e, n, out=out_deg.on(r, e.device))
            if directed:
                bincount_ids(e[:, 1], n, out=in_deg.on(r, e.device))
            if sampler is not None:
                sampler.observe(e)

    clustering = None
    if sampler is not None:
        sampler.finalize_neighbors()
        if sampler.has_work:  # else the regeneration pass would count nothing
            for chunk in api.iter_edge_chunks(spec, P, device=dev, mesh=rows,
                                              rng_impl=rng_impl, batch=batch):
                # a chunk buffer's valid slots are the prefix of its count
                prefix = chunk.count is not None and chunk.buffer.dim() == 2
                sampler.count_triangles_chunk(
                    chunk.buffer, count=chunk.count if prefix else None,
                    mask=None if prefix else chunk.mask, row=row(chunk))
        clustering = sampler.report()

    out_deg.sum()
    if directed:
        in_deg.sum()
    exact = mode == "exact"
    return StatsReport(
        n=n, P=P, directed=directed, mode=mode, num_edges=num_edges,
        degree=merge_sections(out_acc, exact),
        in_degree=merge_sections(in_acc, exact) if directed else None,
        clustering=clustering, metrics=tuple(metrics),
    )
