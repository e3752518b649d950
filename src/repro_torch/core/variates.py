"""Random variates for the divide-and-conquer splits (paper §2.2).

Hypergeometric (G(n,m) splits), binomial (G(n,p) / spatial cell counts)
and multinomial (RHG annuli) variates, each drawn from a generator seeded
by the recursion-tree hash — see :mod:`repro.core.prng`.

Exact sampling is used whenever parameters fit the int64-exact regime
(universe <= 2^60, i.e. graphs up to ~2^30 vertices); beyond that we
switch to a clamped normal approximation.  The paper's C++ code makes the
same trade (stocc's exact samplers below 64 bit, GMP + asymptotics above);
at universes > 2^60 the approximation error is far below statistical
resolution.
"""
from __future__ import annotations

import numpy as np

_EXACT_LIMIT = 10**9 - 1   # numpy's Generator.hypergeometric hard limit
_BINOM_LIMIT = 1 << 62


def hypergeometric(rng: np.random.Generator, ngood: int, nbad: int, nsample: int) -> int:
    """# of 'good' elements in a uniform nsample-subset of ngood+nbad.

    Three regimes (paper: stocc exact below 64 bit, GMP+asymptotics above):
      exact     max(ngood, nbad) < 1e9       (numpy's limit)
      binomial  nsample^2 << total           (without ~= with replacement;
                TV error O(nsample^2/total))
      normal    everything huge              (CLT; relative error -> 0)
    """
    ngood, nbad, nsample = int(ngood), int(nbad), int(nsample)
    total = ngood + nbad
    if not 0 <= nsample <= total:
        raise ValueError(f"nsample {nsample} out of range for total {total}")
    lo, hi = max(0, nsample - nbad), min(nsample, ngood)
    if lo == hi:
        return lo
    if max(ngood, nbad) <= _EXACT_LIMIT:
        return int(rng.hypergeometric(ngood, nbad, nsample))
    if nsample * nsample <= total // 100 and nsample <= _BINOM_LIMIT:
        return int(np.clip(rng.binomial(nsample, ngood / total), lo, hi))
    p = ngood / total
    mean = nsample * p
    var = nsample * p * (1.0 - p) * (total - nsample) / (total - 1.0)
    return int(np.clip(round(rng.normal(mean, np.sqrt(max(var, 0.0)))), lo, hi))


def binomial(rng: np.random.Generator, n: int, p: float) -> int:
    """Binomial(n, p) with large-n normal fallback."""
    n = int(n)
    if p <= 0.0 or n == 0:
        return 0
    if p >= 1.0:
        return n
    if n <= _EXACT_LIMIT:
        return int(rng.binomial(n, p))
    mean, var = n * p, n * p * (1.0 - p)
    return int(np.clip(round(rng.normal(mean, np.sqrt(var))), 0, n))


def multinomial_split(rng: np.random.Generator, n: int, probs: np.ndarray) -> np.ndarray:
    """Multinomial(n, probs) via dependent binomials (paper §7.1).

    Drawn as the paper does for annuli: iteratively condition on the
    remaining mass, so prefix counts agree between PEs that only need a
    prefix of the outcome vector.
    """
    probs = np.asarray(probs, dtype=np.float64)
    out = np.zeros(len(probs), dtype=np.int64)
    remaining, mass = int(n), 1.0
    for i, pi in enumerate(probs[:-1]):
        if remaining == 0:
            break
        q = 0.0 if mass <= 0 else min(1.0, pi / mass)
        out[i] = binomial(rng, remaining, q)
        remaining -= out[i]
        mass -= pi
    out[len(probs) - 1] += remaining
    return out
