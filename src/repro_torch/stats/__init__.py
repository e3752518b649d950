"""repro_torch.stats: streaming graph analytics and model validation (port
of ``repro.stats``).

``collect(spec, P)`` streams a spec's edge chunks through the per-PE
degree sections on the device (and the sampled clustering counters);
``validate(spec, P)`` gates the result against the family's closed-form
law (Binomial degree distributions, RHG's 2 alpha + 1 tail exponent,
BA's exponent 3, exact edge counts) with the reference's statistics.

    >>> from repro_torch.stats import validate
    >>> from repro_torch.api import GNP
    >>> validate(GNP(n=4096, p=16 / 4096, seed=1), P=8, device="cpu").passed
    True

``python -m repro_torch.stats`` runs the ER + RHG smoke validation.
"""
from .accumulate import (ClusteringReport, ClusteringSampler, DegreeSummary, SectionDegrees,
                         VertexOwnership, merge_sections, section_views)
from .collect import EXACT_N_LIMIT, StatsReport, collect
from .expected import ExpectedModel, expected_model
from .gof import GofResult, chi_square_gof, hill_tail_exponent, ks_discrete
from .validate import ValidationCheck, ValidationReport, validate

__all__ = ["ClusteringReport", "ClusteringSampler", "DegreeSummary", "SectionDegrees",
           "VertexOwnership", "merge_sections", "section_views",
           "EXACT_N_LIMIT", "StatsReport", "collect",
           "ExpectedModel", "expected_model",
           "GofResult", "chi_square_gof", "hill_tail_exponent", "ks_discrete",
           "ValidationCheck", "ValidationReport", "validate"]
