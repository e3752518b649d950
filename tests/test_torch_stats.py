"""``repro_torch.stats.collect`` against ``repro.stats.collect``.

Every comparison is exact: integer moments and counts with ``==``,
histograms and degree arrays with ``np.array_equal``.  The port runs on
the CPU (``device="cpu"``), where the hist wrapper computes its plain
PyTorch version.
"""
import importlib

import numpy as np
import pytest
import torch

from repro import api as japi
from repro import stats as jstats
from repro_torch import api as tapi
from repro_torch import stats as tstats

# one intra-op thread: the suite runs in several worker processes at once,
# and a pool of one thread per core in each of them oversubscribes the CPU
torch.set_num_threads(1)

SPECS = [
    ("GNP", dict(n=3000, p=10 / 3000, directed=False, seed=31)),
    ("GNM", dict(n=2500, m=15000, directed=True, seed=32)),
]
IDS = ["GNP-u", "GNM-d"]


def same_summary(port, ref, tag):
    np.testing.assert_array_equal(port.log2_hist.numpy(), np.asarray(ref.log2_hist),
                                  err_msg=f"{tag}: log2_hist")
    for f in ("deg_sum", "deg_sumsq", "deg_max", "num_isolated"):
        assert getattr(port, f) == getattr(ref, f), (tag, f)
    if ref.degrees is None:
        assert port.degrees is None, tag
    else:
        np.testing.assert_array_equal(port.degrees.numpy(), np.asarray(ref.degrees),
                                      err_msg=f"{tag}: degrees")
    assert port.mean == ref.mean and port.variance == ref.variance, tag


@pytest.mark.parametrize("P", [1, 2, 8])
@pytest.mark.parametrize("family,kw", SPECS, ids=IDS)
def test_collect_matches_reference(family, kw, P):
    ref = jstats.collect(getattr(japi, family)(**kw), P)
    port = tstats.collect(getattr(tapi, family)(**kw), P, device="cpu")
    assert (port.n, port.P, port.directed, port.mode, port.num_edges) == (
        ref.n, ref.P, ref.directed, ref.mode, ref.num_edges)
    same_summary(port.degree, ref.degree, f"{family} P={P}")
    if kw["directed"]:
        same_summary(port.in_degree, ref.in_degree, f"{family} P={P} in")
    else:
        assert port.in_degree is None
    assert port.mean_degree == ref.mean_degree
    np.testing.assert_array_equal(port.degree_counts().numpy(), ref.degree_counts())


def test_binned_mode_matches_reference():
    kw = dict(n=2000, p=0.004, seed=33)
    ref = jstats.collect(japi.GNP(**kw), 2, mode="binned")
    port = tapi.collect(tapi.GNP(**kw), 2, mode="binned", device="cpu")
    assert port.mode == "binned" and port.num_edges == ref.num_edges
    same_summary(port.degree, ref.degree, "binned")
    with pytest.raises(ValueError, match="exact"):
        port.degree_counts()


def test_unsupported_metrics_raise():
    """Clustering is ported (tests/test_torch_clustering.py) and refused,
    as in the reference, for directed families; unknown metrics and
    modes raise."""
    spec = tapi.GNP(n=100, p=0.1, seed=1)
    with pytest.raises(ValueError, match="undirected"):
        tstats.collect(tapi.GNP(n=100, p=0.1, directed=True, seed=1), 1,
                       metrics=("degree", "clustering"), device="cpu")
    with pytest.raises(ValueError):
        tstats.collect(spec, 1, metrics=("nope",), device="cpu")
    with pytest.raises(ValueError):
        tstats.collect(spec, 1, mode="nope", device="cpu")


def test_sections_drop_foreign_ids():
    """Each section counts only its own vertices: the device-side split."""
    import torch

    own = tstats.VertexOwnership(10, 3)
    assert own.bounds == [0, 3, 6, 10]
    accs = [tstats.SectionDegrees(lo, hi, "cpu") for lo, hi in zip(own.bounds, own.bounds[1:])]
    ids = torch.tensor([0, 2, 3, 3, 5, 6, 9, 9, 9])
    for a in accs:
        a.add(ids)
    assert [a.deg.tolist() for a in accs] == [[1, 0, 1], [2, 0, 1], [1, 0, 0, 3]]
    s = tstats.merge_sections(accs, exact=True)
    assert s.degrees.tolist() == [1, 0, 1, 2, 0, 1, 1, 0, 0, 3]
    assert (s.deg_sum, s.deg_max, s.num_isolated) == (9, 3, 4)


@pytest.mark.parametrize("P", [1, 3, 16])
@pytest.mark.parametrize("family,kw", SPECS, ids=IDS)
def test_collect_with_section_views_matches_reference(family, kw, P, monkeypatch):
    """The P sections are views of one degree array and every chunk is one
    scatter into it (two for a directed spec); the report is the
    reference's."""
    tcollect = importlib.import_module("repro_torch.stats.collect")
    calls = []
    real = tcollect.bincount_ids
    monkeypatch.setattr(tcollect, "bincount_ids",
                        lambda ids, n, out=None: calls.append(n) or real(ids, n, out=out))
    spec = getattr(tapi, family)(**kw)
    nonempty = sum(len(c.edges()) > 0 for c in tapi.iter_edge_chunks(spec, P, device="cpu"))
    ref = jstats.collect(getattr(japi, family)(**kw), P)
    port = tstats.collect(spec, P, device="cpu")
    sides = 2 if kw["directed"] else 1
    assert calls == [kw["n"]] * (sides * nonempty)
    assert port.num_edges == ref.num_edges
    same_summary(port.degree, ref.degree, f"{family} P={P}")
    if kw["directed"]:
        same_summary(port.in_degree, ref.in_degree, f"{family} P={P} in")


def test_section_views_share_one_array():
    deg, accs = tstats.section_views([0, 3, 6, 10], "cpu")
    assert deg.shape == (10,) and [a.size for a in accs] == [3, 3, 4]
    deg[4] = 7
    assert accs[1].deg.tolist() == [0, 7, 0]
    s = tstats.merge_sections(accs, exact=True)
    assert s.degrees.tolist() == deg.tolist() and s.deg_max == 7


def test_standalone_section_counts_only_its_own_ids():
    """A SectionDegrees made alone owns its array and drops every id
    outside its section, negative ids and ids past n included."""
    acc = tstats.SectionDegrees(4, 9, "cpu")
    acc.add(torch.tensor([-3, 0, 3, 4, 4, 8, 9, 12, 6]))
    assert acc.deg.tolist() == [2, 0, 1, 0, 1]
    acc.add(torch.tensor([[5, 8], [2, 100]]))
    assert acc.deg.tolist() == [2, 1, 1, 0, 2]
    assert acc.moments() == [6, 10, 2, 1]
