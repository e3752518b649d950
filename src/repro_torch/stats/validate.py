"""``validate(spec, P) -> ValidationReport``: measured vs closed form (port
of ``repro.stats.validate``).

The paper's §7 verification loop as a library call: stream the graph on
the device (:func:`repro_torch.stats.collect`, degrees through the hist
kernel), resolve the family's closed-form law (:mod:`.expected`), and run
the goodness-of-fit gates (:mod:`.gof`) on the host.  Only O(bins)
summaries leave the device: the ``[deg_max + 1]`` degree counts, the
log2 histogram, and for the Hill fit the exact degree array, copied
once.  Every gate is a :class:`ValidationCheck` with its evidence
attached, equal to the reference's report on the same spec and P.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np

from .collect import StatsReport, collect
from .expected import ExpectedModel, expected_model
from .gof import chi_square_gof, hill_tail_exponent, tail_exponent_from_log2_hist


@dataclass(frozen=True)
class ValidationCheck:
    name: str
    passed: bool
    observed: float
    expected: float
    detail: str = ""
    pvalue: Optional[float] = None

    def __str__(self) -> str:
        mark = "PASS" if self.passed else "FAIL"
        p = f" p={self.pvalue:.4g}" if self.pvalue is not None else ""
        return (f"[{mark}] {self.name}: observed={self.observed:.6g} "
                f"expected={self.expected:.6g}{p}  {self.detail}")


@dataclass(frozen=True)
class ValidationReport:
    family: str
    P: int
    passed: bool
    checks: Tuple[ValidationCheck, ...]
    stats: StatsReport
    model: ExpectedModel = field(repr=False, default=None)

    def __str__(self) -> str:
        head = (f"{self.family}: n={self.stats.n} m={self.stats.num_edges} "
                f"P={self.P} mode={self.stats.mode} -> "
                f"{'PASS' if self.passed else 'FAIL'}")
        return "\n".join([head] + [f"  {c}" for c in self.checks])


def validate(spec, P: int = 1, *, alpha: float = 1e-3, device=None, mesh=None,
             **collect_kwargs) -> ValidationReport:
    """Generate-and-measure ``spec`` on P PEs on ``device`` (CUDA unless
    ``"cpu"``) and ``mesh`` (as :func:`collect`: by default every local
    card that divides P), gate against its law.

    ``alpha`` is the significance level of the distributional (chi-
    square) gates; scale/tail gates use the model's tolerance.  Extra
    kwargs forward to :func:`collect`.  The degree counts are histogrammed
    on the gathering card, where :func:`collect` summed the partials.
    """
    stats = collect(spec, P, device=device, mesh=mesh, **collect_kwargs)
    model = expected_model(spec, kmax=stats.degree.deg_max + 1)
    checks = []

    if model.exact_edges is not None:
        checks.append(ValidationCheck(
            name="edge-count", passed=stats.num_edges == model.exact_edges,
            observed=float(stats.num_edges), expected=float(model.exact_edges),
            detail="exact by construction"))

    if model.mean_degree is not None:
        mean = stats.mean_degree
        tol = model.mean_rel_tol
        rel = abs(mean - model.mean_degree) / max(model.mean_degree, 1e-12)
        checks.append(ValidationCheck(
            name="mean-degree", passed=rel <= tol + 1e-9,
            observed=mean, expected=model.mean_degree,
            detail=f"rel err {rel:.3g} <= tol {tol:.3g}; {model.notes}"))

    if model.degree_pmf is not None and stats.mode == "exact":
        obs = stats.degree_counts().cpu().numpy()
        kmax = len(obs) - 1
        exp = stats.n * model.degree_pmf[: kmax + 1]
        gof = chi_square_gof(obs, exp)
        checks.append(ValidationCheck(
            name="degree-chi2", passed=gof.pvalue > alpha,
            observed=gof.stat, expected=float(gof.dof),
            pvalue=gof.pvalue,
            detail=f"chi2 on pooled degree counts, dof={gof.dof}"))

    if model.tail_exponent is not None:
        checks.append(_tail_check(stats, model))

    return ValidationReport(
        family=model.family, P=P, passed=all(c.passed for c in checks),
        checks=tuple(checks), stats=stats, model=model)


def _tail_check(stats: StatsReport, model: ExpectedModel) -> ValidationCheck:
    """Fitted power-law tail exponent vs the model's closed form.

    Exact mode uses the Hill estimator on the heavy-tailed orientation
    (in-degrees for BA), on the degree array copied to the host once;
    binned mode fits the log2 histogram slope, the O(bins) path that
    survives any n.  The gate width folds in the fit's own standard
    error: tail estimates converge slowly, and a gate tighter than the
    estimator is noise, not rigor.
    """
    summary = stats.in_degree if stats.directed else stats.degree
    if stats.mode == "exact" and summary.degrees is not None:
        got, se = hill_tail_exponent(summary.degrees.cpu().numpy())
        how = "hill"
    else:
        got, se = tail_exponent_from_log2_hist(summary.log2_hist.cpu().numpy())
        how = "log2-slope"
    tol = 0.35 + 3.0 * min(se, 1.0)
    ok = np.isfinite(got) and abs(got - model.tail_exponent) <= tol
    return ValidationCheck(
        name="tail-exponent", passed=bool(ok), observed=float(got),
        expected=float(model.tail_exponent),
        detail=f"{how} fit, se={se:.3g}, tol={tol:.3g}")
