"""Goodness-of-fit machinery: chi-square, KS, power-law tail fits (port
of ``repro.stats.gof``).

Small, numpy/scipy-only, on the host: these run on O(bins)-sized merged
summaries, not on edge lists, so they are free at any graph scale.  The
operations are the reference's, in the reference's order, so a report
built on the same counts is equal to the reference's bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
from scipy import stats as sps


@dataclass(frozen=True)
class GofResult:
    stat: float
    dof: int
    pvalue: float


def pool_bins(observed: np.ndarray, expected: np.ndarray,
              min_expected: float = 5.0) -> Tuple[np.ndarray, np.ndarray]:
    """Merge adjacent bins until every pooled bin has expected mass >=
    ``min_expected`` (the classical chi-square validity rule).  The last
    pool absorbs any underweight remainder."""
    obs_p, exp_p = [], []
    o_acc = e_acc = 0.0
    for o, e in zip(observed, expected):
        o_acc += o
        e_acc += e
        if e_acc >= min_expected:
            obs_p.append(o_acc)
            exp_p.append(e_acc)
            o_acc = e_acc = 0.0
    if e_acc > 0 or o_acc > 0:
        if exp_p:
            obs_p[-1] += o_acc
            exp_p[-1] += e_acc
        else:
            obs_p, exp_p = [o_acc], [e_acc]
    return np.asarray(obs_p, np.float64), np.asarray(exp_p, np.float64)


def chi_square_gof(observed: np.ndarray, expected: np.ndarray, *,
                   min_expected: float = 5.0, ddof: int = 0) -> GofResult:
    """Pearson chi-square of observed counts vs expected counts.

    ``expected`` is rescaled to the observed total (tiny truncated tail
    mass must not read as misfit), then adjacent bins are pooled to the
    min-expected rule."""
    observed = np.asarray(observed, np.float64)
    expected = np.asarray(expected, np.float64)
    expected = expected * (observed.sum() / expected.sum())
    obs, exp = pool_bins(observed, expected, min_expected)
    if len(obs) < 2:
        return GofResult(stat=0.0, dof=0, pvalue=1.0)
    stat = float(((obs - exp) ** 2 / exp).sum())
    dof = max(1, len(obs) - 1 - ddof)
    return GofResult(stat=stat, dof=dof, pvalue=float(sps.chi2.sf(stat, dof)))


def ks_discrete(degrees: np.ndarray, cdf: np.ndarray) -> GofResult:
    """Conservative KS test of integer samples vs a discrete CDF.

    cdf[k] = P(X <= k).  The Kolmogorov asymptotic p-value is
    conservative for discrete laws (true p is larger), so a pass is
    trustworthy and a marginal fail is soft — use chi-square as the
    primary gate."""
    degrees = np.asarray(degrees, np.int64)
    n = len(degrees)
    kmax = len(cdf) - 1
    counts = np.bincount(np.clip(degrees, 0, kmax), minlength=kmax + 1)
    ecdf = np.cumsum(counts) / n
    d = float(np.abs(ecdf - cdf).max())
    return GofResult(stat=d, dof=n, pvalue=float(sps.kstwobign.sf(d * np.sqrt(n))))


# --------------------------------------------------------------------------
# power-law tails
# --------------------------------------------------------------------------

def hill_tail_exponent(degrees: np.ndarray, k: int = 0) -> Tuple[float, float]:
    """Hill estimator of the tail exponent gamma (P[deg >= d] ~ d^(1-gamma)).

    Uses the k largest degrees (default ~sqrt(#positive), the classic
    bias/variance compromise).  Returns (gamma_hat, stderr); stderr is
    the asymptotic (gamma-1)/sqrt(k).
    """
    d = np.sort(np.asarray(degrees, np.float64))
    d = d[d > 0]
    if k <= 0:
        k = max(10, int(np.sqrt(len(d))))
    k = min(k, len(d) - 1)
    if k < 2:
        return float("nan"), float("inf")
    tail = d[-k:]
    ref = d[-k - 1]
    # +0.5 continuity shift: degrees are integers, Hill assumes continuity
    logs = np.log((tail + 0.5) / (ref + 0.5))
    mean_log = float(logs.mean())
    if mean_log <= 0:
        return float("nan"), float("inf")
    alpha_inv = 1.0 / mean_log          # Pareto index of the tail
    gamma = 1.0 + alpha_inv
    return float(gamma), float(alpha_inv / np.sqrt(k))


def tail_exponent_from_log2_hist(hist: np.ndarray,
                                 min_count: int = 16) -> Tuple[float, float]:
    """Power-law exponent from a log2-binned degree histogram.

    For counts[b] ~ integral of c * d^-gamma over bin b (width 2^(b-1)),
    log2(counts[b] / width[b]) is linear in the bin's log2 center with
    slope -gamma.  Fits the tail bins (past the histogram mode) with at
    least ``min_count`` mass; returns (gamma_hat, stderr of the slope).
    This is the huge-n path — O(bins) input, no per-vertex data.
    """
    hist = np.asarray(hist, np.float64)
    centers = np.array([0.0] + [1.5 * 2 ** (b - 1) for b in range(1, len(hist))])
    widths = np.array([1.0] + [max(1.0, 2 ** (b - 1)) for b in range(1, len(hist))])
    mode = int(np.argmax(hist))
    sel = np.arange(len(hist)) > mode
    sel &= hist >= min_count
    if sel.sum() < 3:
        return float("nan"), float("inf")
    x = np.log2(centers[sel])
    y = np.log2(hist[sel] / widths[sel])
    A = np.stack([x, np.ones_like(x)], axis=1)
    coef, res, *_ = np.linalg.lstsq(A, y, rcond=None)
    dof = max(1, sel.sum() - 2)
    resid = y - A @ coef
    s2 = float((resid ** 2).sum()) / dof
    cov = s2 * np.linalg.inv(A.T @ A)
    return float(-coef[0]), float(np.sqrt(cov[0, 0]))
