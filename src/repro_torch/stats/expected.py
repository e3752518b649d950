"""Closed-form model expectations per family (port of
``repro.stats.expected``; the paper's §7 verification targets), resolved
from a spec of :mod:`repro_torch.api`.

Each family maps to an :class:`ExpectedModel`: the degree law to test
against (a pmf where one exists in closed form), the expected mean
degree, and the power-law tail exponent where the model has one.  The
family constants live beside their generators
(:func:`repro_torch.core.er.expected_degree_law`,
:func:`repro_torch.core.rhg.expected_tail_exponent`); this module only
dispatches and assembles, on the host, with the reference's constants,
tolerances and scipy calls.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
from scipy import stats as sps

from ..core import er as _er
from ..core import rhg as _rhg


@dataclass(frozen=True)
class ExpectedModel:
    family: str
    mean_degree: Optional[float] = None       # expected average (out-)degree
    degree_pmf: Optional[np.ndarray] = None   # P[deg = k], k = 0..kmax
    tail_exponent: Optional[float] = None     # power-law gamma, if the model has one
    exact_edges: Optional[int] = None         # families with a fixed edge count
    mean_rel_tol: float = 0.05                # gate width on mean degree
    notes: str = ""


def unit_ball_volume(dim: int) -> float:
    """Volume of the unit L2 ball (RGG expected degree n*V(r))."""
    return math.pi ** (dim / 2.0) / math.gamma(dim / 2.0 + 1.0)


def _binomial_model(family: str, trials: int, p: float, kmax: int,
                    exact_edges: Optional[int] = None, notes: str = "") -> ExpectedModel:
    pmf = sps.binom.pmf(np.arange(kmax + 1), trials, p)
    return ExpectedModel(family=family, mean_degree=trials * p, degree_pmf=pmf,
                         exact_edges=exact_edges, notes=notes)


def expected_model(spec, kmax: int = 0) -> ExpectedModel:
    """Closed-form expectations for ``spec``; ``kmax`` sizes the pmf
    support (pass the observed max degree plus slack)."""
    from .. import api

    kmax = max(kmax, 8)
    if isinstance(spec, api.GNP):
        t, p = _er.expected_degree_law(spec.n, p=spec.p, directed=spec.directed)
        return _binomial_model("GNP", t, p, kmax,
                               notes="deg ~ Binomial(n-1, p), exact marginal")
    if isinstance(spec, api.GNM):
        t, p = _er.expected_degree_law(spec.n, m=spec.m, directed=spec.directed)
        return _binomial_model(
            "GNM", t, p, kmax, exact_edges=spec.m,
            notes="Binomial approximation; fixed edge total under-disperses")
    if isinstance(spec, api.SBM):
        nb = spec.n // spec.blocks
        pmf_in = sps.binom.pmf(np.arange(kmax + 1), nb - 1, spec.p_in)
        pmf_out = sps.binom.pmf(np.arange(kmax + 1), spec.n - nb, spec.p_out)
        pmf = np.convolve(pmf_in, pmf_out)[: kmax + 1]
        return ExpectedModel(
            family="SBM", degree_pmf=pmf,
            mean_degree=(nb - 1) * spec.p_in + (spec.n - nb) * spec.p_out,
            notes="deg = Bin(n_b-1, p_in) + Bin(n-n_b, p_out), equal blocks")
    if isinstance(spec, api.RGG):
        v = unit_ball_volume(spec.dim) * spec.radius ** spec.dim
        return ExpectedModel(
            family="RGG", mean_degree=(spec.n - 1) * v, mean_rel_tol=0.15,
            notes="interior law (n-1)*V(r); [0,1)^d boundary loses O(r) mass")
    if isinstance(spec, api.RHG):
        return ExpectedModel(
            family="RHG",
            mean_degree=_rhg.expected_avg_degree(spec.params),
            tail_exponent=_rhg.expected_tail_exponent(spec.params),
            mean_rel_tol=0.3,
            notes="mean from Eq. 4 calibration (slow o(1) convergence); "
                  "tail exponent 2*alpha + 1 = gamma")
    if isinstance(spec, api.BA):
        return ExpectedModel(
            family="BA", mean_degree=float(spec.d), exact_edges=spec.n * spec.d,
            tail_exponent=3.0, mean_rel_tol=0.0,
            notes="out-degree exactly d per vertex; in-degree tail exponent 3")
    if isinstance(spec, api.RMAT):
        return ExpectedModel(
            family="RMAT", mean_degree=spec.m / spec.num_vertices,
            exact_edges=spec.m, mean_rel_tol=0.0,
            notes="Graph500 semantics (loops+dups kept); heavy tail fitted, "
                  "no agreed closed-form exponent")
    if isinstance(spec, api.RDG):
        if spec.dim == 2:
            return ExpectedModel(
                family="RDG", mean_degree=6.0, mean_rel_tol=0.01,
                notes="torus triangulation: E = 3V, avg degree exactly 6")
        return ExpectedModel(
            family="RDG", mean_degree=15.54, mean_rel_tol=0.1,
            notes="3d Poisson-Delaunay asymptotic mean degree ~ 15.54")
    raise TypeError(f"no closed-form expectations for {type(spec).__name__}")
