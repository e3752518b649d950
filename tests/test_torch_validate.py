"""``repro_torch.stats`` model validation against ``repro.stats``: the
goodness-of-fit functions, the closed-form models, ``validate`` and the
CLI.

Every comparison is exact (tolerance 0): the gate statistics are the
reference's numpy/scipy calls on integer degree counts that the port
reproduces bit for bit, so reports are compared as float64 values, flags
and text with ``==``.  The port runs on the CPU (``device="cpu"``).
"""
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import api as japi
from repro import stats as jstats
from repro.stats import gof as jgof
from repro_torch import api as tapi
from repro_torch import stats as tstats
from repro_torch.stats import gof as tgof

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def same(a, b) -> bool:
    """Equal as float64 values, NaN equal to NaN (tolerance 0)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return a.shape == b.shape and np.array_equal(a, b, equal_nan=True)


def fields(g) -> tuple:
    """A GofResult as a tuple: the two packages' dataclasses differ."""
    return (g.stat, g.dof, g.pvalue)


def same_report(port, ref) -> None:
    assert (port.family, port.P, port.passed) == (ref.family, ref.P, ref.passed)
    assert len(port.checks) == len(ref.checks)
    for c, r in zip(port.checks, ref.checks):
        assert (c.name, c.passed, c.detail) == (r.name, r.passed, r.detail)
        assert same(c.observed, r.observed) and same(c.expected, r.expected), c.name
        assert (c.pvalue is None) == (r.pvalue is None), c.name
        assert c.pvalue is None or same(c.pvalue, r.pvalue), c.name
    assert str(port).splitlines() == str(ref).splitlines()


# --------------------------------------------------------------- gof

POOL_CASES = {
    "random": (np.random.default_rng(1).poisson(6, 40), np.random.default_rng(2).gamma(2, 3, 40)),
    "underweight-tail": (np.array([9, 8, 7, 1, 0, 1]), np.array([9.0, 8.0, 7.0, 1.0, 0.5, 0.25])),
    "all-underweight": (np.array([1, 2, 0]), np.array([0.5, 1.0, 2.0])),
    "empty-tail-mass": (np.array([6, 7, 0, 0]), np.array([6.0, 7.0, 0.0, 0.0])),
}


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pool_bins_and_chi_square_match_reference(case):
    obs, exp = POOL_CASES[case]
    for f in (tgof.pool_bins, jgof.pool_bins):
        assert len(f(obs, exp)) == 2
    po, pe = tgof.pool_bins(obs, exp)
    ro, re = jgof.pool_bins(obs, exp)
    assert same(po, ro) and same(pe, re)
    for ddof in (0, 1):
        assert same(fields(tgof.chi_square_gof(obs, exp, ddof=ddof)),
                    fields(jgof.chi_square_gof(obs, exp, ddof=ddof)))


def test_chi_square_single_pool_returns_the_reference_default():
    got = tgof.chi_square_gof([3, 1], [1.0, 1.0])
    assert got == tgof.GofResult(0.0, 0, 1.0)
    assert fields(got) == fields(jgof.chi_square_gof([3, 1], [1.0, 1.0]))


def test_ks_discrete_matches_reference():
    from scipy import stats as sps

    deg = np.random.default_rng(3).binomial(400, 0.02, 5000)
    for p in (0.02, 0.03):
        cdf = sps.binom.cdf(np.arange(deg.max() + 1), 400, p)
        assert fields(tgof.ks_discrete(deg, cdf)) == fields(jgof.ks_discrete(deg, cdf))


HILL_CASES = {
    "pareto": (np.floor(np.random.default_rng(4).pareto(1.7, 20000) * 3).astype(np.int64), 0),
    "pareto-k50": (np.floor(np.random.default_rng(5).pareto(1.2, 5000) * 2).astype(np.int64), 50),
    "too-few": (np.array([0, 0, 3, 5]), 0),                 # k < 2: (nan, inf)
    "flat-tail": (np.full(400, 7, np.int64), 0),            # mean log 0: (nan, inf)
}


@pytest.mark.parametrize("case", sorted(HILL_CASES))
def test_hill_tail_exponent_matches_reference(case):
    deg, k = HILL_CASES[case]
    got, want = tgof.hill_tail_exponent(deg, k), jgof.hill_tail_exponent(deg, k)
    assert same(got, want), (got, want)
    if case in ("too-few", "flat-tail"):
        assert math.isnan(got[0]) and got[1] == math.inf


LOG2_CASES = {
    "power-law": np.round(1e6 * 2.0 ** (-1.6 * np.arange(18))).astype(np.int64),
    "noisy": np.random.default_rng(6).poisson(1e5 * 2.0 ** (-1.2 * np.arange(16))),
    "short": np.array([5, 900, 40, 20, 3, 0, 0]),          # fewer than 3 tail bins: (nan, inf)
}


@pytest.mark.parametrize("case", sorted(LOG2_CASES))
def test_tail_exponent_from_log2_hist_matches_reference(case):
    h = LOG2_CASES[case]
    got, want = tgof.tail_exponent_from_log2_hist(h), jgof.tail_exponent_from_log2_hist(h)
    assert same(got, want), (got, want)
    if case == "short":
        assert math.isnan(got[0]) and got[1] == math.inf


# --------------------------------------------------------------- expected

MODEL_SPECS = [
    ("GNP", dict(n=3000, p=0.004, seed=1)),
    ("GNP", dict(n=3000, p=0.004, directed=True, seed=1)),
    ("GNM", dict(n=2048, m=8192, seed=5)),
    ("GNM", dict(n=2048, m=8192, directed=True, seed=5)),
    ("SBM", dict(n=1500, blocks=5, p_in=0.03, p_out=0.003, seed=3)),
    ("RGG", dict(n=4096, radius=0.03, seed=1)),
    ("RGG", dict(n=4096, radius=0.08, dim=3, seed=1)),
    ("RHG", dict(n=4096, avg_deg=8, gamma=2.7, seed=1)),
    ("BA", dict(n=2048, d=4, seed=7)),
    ("RMAT", dict(log_n=11, m=16000, seed=1)),
    ("RDG", dict(n=4096, dim=2, seed=1)),
    ("RDG", dict(n=4096, dim=3, seed=1)),
]


@pytest.mark.parametrize("family,params", MODEL_SPECS,
                         ids=[f"{f}-{i}" for i, (f, _) in enumerate(MODEL_SPECS)])
def test_expected_model_matches_reference(family, params):
    for kmax in (0, 60):
        got = tstats.expected_model(getattr(tapi, family)(**params), kmax=kmax)
        want = jstats.expected_model(getattr(japi, family)(**params), kmax=kmax)
        for f in ("family", "mean_degree", "tail_exponent", "exact_edges",
                  "mean_rel_tol", "notes"):
            assert getattr(got, f) == getattr(want, f), f
        assert (got.degree_pmf is None) == (want.degree_pmf is None)
        if want.degree_pmf is not None:
            assert same(got.degree_pmf, want.degree_pmf)


def test_expected_model_refuses_unknown_specs_and_ball_volume_matches():
    from repro.stats import expected as jexp
    from repro_torch.stats import expected as texp

    with pytest.raises(TypeError):
        tstats.expected_model(object())
    for d in (1, 2, 3, 7):
        assert texp.unit_ball_volume(d) == jexp.unit_ball_volume(d)


def test_closed_forms_match_reference():
    from repro.core import er as jer
    from repro.core import rhg as jrhg
    from repro_torch.core import er as ter
    from repro_torch.core import rhg as trhg

    for n, d in ((1000, False), (1000, True), (1 << 24, False)):
        assert ter.expected_gnm_universe(n, d) == jer.expected_gnm_universe(n, d)
        assert ter.expected_degree_law(n, m=5 * n, directed=d) == \
            jer.expected_degree_law(n, m=5 * n, directed=d)
        assert ter.expected_degree_law(n, p=0.01) == jer.expected_degree_law(n, p=0.01)
    for g in (2.2, 2.7, 3.0):
        tp, jp = trhg.RHGParams(1 << 12, 8.0, g, 1), jrhg.RHGParams(1 << 12, 8.0, g, 1)
        assert trhg.expected_tail_exponent(tp) == jrhg.expected_tail_exponent(jp)
        assert trhg.expected_avg_degree(tp) == jrhg.expected_avg_degree(jp)


# --------------------------------------------------------------- validate

VALIDATE_SPECS = [
    ("GNP", dict(n=4096, p=16 / 4096, seed=1)),
    ("RHG", dict(n=4096, avg_deg=8, gamma=2.7, seed=1)),
    ("GNM", dict(n=2048, m=8192, seed=5)),
    ("BA", dict(n=2048, d=4, seed=7)),
    ("SBM", dict(n=1500, blocks=5, p_in=0.03, p_out=0.003, seed=3)),
    ("RMAT", dict(log_n=11, m=16000, seed=1)),
]


@pytest.mark.parametrize("P", [1, 4])
@pytest.mark.parametrize("family,params", VALIDATE_SPECS, ids=[f for f, _ in VALIDATE_SPECS])
def test_validate_report_equals_reference(family, params, P):
    port = tstats.validate(getattr(tapi, family)(**params), P, device="cpu")
    ref = jstats.validate(getattr(japi, family)(**params), P)
    same_report(port, ref)
    assert port.passed
    assert port.stats.num_edges == ref.stats.num_edges


def test_validate_binned_mode_uses_the_log2_slope():
    """mode='binned' (what n > 2^22 takes) gates the BA tail on the log2
    histogram, as the reference does."""
    spec = dict(n=2048, d=4, seed=7)
    port = tstats.validate(tapi.BA(**spec), 2, device="cpu", mode="binned")
    ref = jstats.validate(japi.BA(**spec), 2, mode="binned")
    same_report(port, ref)
    assert "log2-slope" in port.checks[-1].detail


def test_chi_square_rejects_wrong_law():
    """Power, not just level, on the port's own counts: the right Binomial
    law passes and a 1.3x-off one rejects."""
    from scipy import stats as sps

    spec = tapi.GNP(n=4096, p=0.004, seed=3)
    obs = tapi.collect(spec, 4, device="cpu").degree_counts().numpy()
    k = np.arange(len(obs))
    right = spec.n * sps.binom.pmf(k, spec.n - 1, spec.p)
    wrong = spec.n * sps.binom.pmf(k, spec.n - 1, 1.3 * spec.p)
    assert tgof.chi_square_gof(obs, right).pvalue > 1e-3
    assert tgof.chi_square_gof(obs, wrong).pvalue < 1e-6
    assert fields(tgof.chi_square_gof(obs, right)) == fields(jgof.chi_square_gof(obs, right))


def test_api_reexports_validate():
    spec = tapi.GNP(n=256, p=0.03, seed=2)
    rep = tapi.validate(spec, 2, device="cpu")
    assert isinstance(rep, tstats.ValidationReport) and rep.passed
    same_report(rep, japi.validate(japi.GNP(n=256, p=0.03, seed=2), 2))
    assert set(jstats.__all__) <= set(tstats.__all__)


def test_cli_gate_lines_equal_the_reference_cli(capsys):
    from repro.stats.__main__ import main as jmain

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.stats", "--device", "cpu",
                        "--n", "4096", "--pes", "4"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "all gates passed" in r.stderr
    assert jmain(["--n", "4096", "--pes", "4"]) == 0
    assert r.stdout.splitlines() == capsys.readouterr().out.splitlines()
