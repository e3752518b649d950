"""``repro_torch.stats.collect`` against ``repro.stats.collect``.

Every comparison is exact: integer moments and counts with ``==``,
histograms and degree arrays with ``np.array_equal``.  The port runs on
the CPU (``device="cpu"``), where the hist wrapper computes its plain
PyTorch version.
"""
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
    spec = tapi.GNP(n=100, p=0.1, seed=1)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tstats.collect(spec, 1, metrics=("degree", "clustering"), device="cpu")
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
