"""repro_torch.stats: streaming degree and sampled clustering statistics
of generated graphs (port of ``repro.stats``'s ``collect``)."""
from .accumulate import (ClusteringReport, ClusteringSampler, DegreeSummary, SectionDegrees,
                         VertexOwnership, merge_sections, section_views)
from .collect import EXACT_N_LIMIT, StatsReport, collect

__all__ = ["ClusteringReport", "ClusteringSampler", "DegreeSummary", "SectionDegrees",
           "VertexOwnership", "merge_sections", "section_views",
           "EXACT_N_LIMIT", "StatsReport", "collect"]
