"""repro_torch.stats: streaming degree statistics of generated graphs
(the degree path of ``repro.stats``)."""
from .accumulate import (DegreeSummary, SectionDegrees, VertexOwnership, merge_sections,
                         section_views)
from .collect import EXACT_N_LIMIT, StatsReport, collect

__all__ = ["DegreeSummary", "SectionDegrees", "VertexOwnership", "merge_sections",
           "section_views",
           "EXACT_N_LIMIT", "StatsReport", "collect"]
