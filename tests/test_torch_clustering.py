"""Sampled clustering in the port's ``collect`` against ``repro.stats``.

``close_wedges_ref`` (the plain version of the ``close_wedges`` kernel)
is held against the reference's ``_close_wedges`` on chunk and pair
buffers, and ``collect(..., metrics=("degree", "clustering"))`` against
the reference's report.  Every comparison is exact.  The port runs on
the CPU (``device="cpu"``), where the wrappers compute their plain
versions.  Also: the port's ``collect`` streams RDG in waves of
``batch`` candidate rows, as the reference does.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro import stats as jstats
from repro.stats import accumulate as jacc
from repro_torch import api as tapi
from repro_torch import stats as tstats
from repro_torch.distrib import runtime as trt
from repro_torch.kernels.wedges import ops as wops
from repro_torch.kernels.wedges.ref import close_wedges_ref
from repro_torch.stats import accumulate as tacc

# one intra-op thread: the suite runs in several worker processes at once,
# and a pool of one thread per core in each of them oversubscribes the CPU
torch.set_num_threads(1)

REPORT = ("sample", "degree", "triangles", "wedges", "valid")
SPECS = {
    "GNP": dict(n=300, p=0.05, seed=9),
    "RHG": dict(n=1000, avg_deg=8.0, gamma=2.6, seed=3),
    "RDG": dict(n=1000, dim=2, seed=4),
    "SBM": dict(n=300, blocks=6, p_in=0.2, p_out=0.01, seed=5),
}


def _table(rng, S: int, NB: int, n: int, empty_rows=()):
    """A sorted ``[S, NB]`` neighbour table, rows of random lengths padded
    with the sentinel; ``empty_rows`` all sentinel (overflowed samples)."""
    tbl = np.full((S, NB), tacc._NB_SENTINEL, np.int64)
    for s in range(S):
        if s in empty_rows:
            continue
        k = int(rng.integers(0, NB + 1))
        tbl[s, :k] = np.sort(rng.choice(n, size=k, replace=False))
    return tbl


@pytest.mark.parametrize("S,NB", [(1, 1), (5, 40), (64, 300)], ids=str)
def test_close_wedges_ref_matches_reference(S, NB):
    """Chunk buffers (a validity prefix) and batched pair buffers (a
    scattered mask), with empty and all-sentinel rows."""
    rng = np.random.default_rng(S * 1000 + NB)
    n = 400
    tbl = _table(rng, S, NB, n, empty_rows=(0,) if S > 1 else ())
    edges = rng.integers(0, n, (3, 500, 2))
    mask = rng.random((3, 500)) < 0.3
    want = jacc._close_wedges(jnp.asarray(edges.reshape(-1, 2)), jnp.asarray(mask.reshape(-1)),
                              jnp.asarray(tbl))
    got = close_wedges_ref(torch.from_numpy(edges.reshape(-1, 2)), torch.from_numpy(tbl),
                           mask=torch.from_numpy(mask.reshape(-1)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    k = 700
    want = jacc._close_wedges(jnp.asarray(edges[0]), jnp.arange(500) < k, jnp.asarray(tbl))
    got = close_wedges_ref(torch.from_numpy(edges[0]), torch.from_numpy(tbl), count=k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_close_wedges_wrapper_adds_into_out():
    rng = np.random.default_rng(11)
    tbl = torch.from_numpy(_table(rng, 4, 30, 100))
    table = wops.wedge_table(tbl)
    edges = torch.from_numpy(rng.integers(0, 100, (256, 2)))
    out = torch.full((4,), 5, dtype=torch.int64)
    assert wops.close_wedges(edges, table, count=100, out=out) is out
    np.testing.assert_array_equal(out.numpy(), 5 + close_wedges_ref(edges, tbl, count=100).numpy())
    np.testing.assert_array_equal(wops.close_wedges(edges, table).numpy(),
                                  close_wedges_ref(edges, tbl, count=256).numpy())


def same_report(port, ref, tag):
    for f in REPORT:
        a, b = getattr(port, f), getattr(ref, f)
        assert a.dtype == b.dtype, (tag, f)
        np.testing.assert_array_equal(a, b, err_msg=f"{tag}: {f}")
    assert port.global_cc == ref.global_cc and port.mean_local_cc == ref.mean_local_cc, tag


@pytest.mark.parametrize("P", [1, 3])
@pytest.mark.parametrize("family", sorted(SPECS))
def test_clustering_matches_reference(family, P):
    kw = SPECS[family]
    ref = jstats.collect(getattr(japi, family)(**kw), P, metrics=("degree", "clustering"))
    port = tstats.collect(getattr(tapi, family)(**kw), P, metrics=("degree", "clustering"),
                          device="cpu")
    assert port.metrics == ref.metrics and port.num_edges == ref.num_edges
    same_report(port.clustering, ref.clustering, f"{family} P={P}")
    np.testing.assert_array_equal(port.degree.degrees.numpy(), np.asarray(ref.degree.degrees))
    assert port.clustering.triangles.sum() > 0 and port.clustering.valid.any()


@pytest.mark.parametrize("family,cap", [("GNP", 15), ("RHG", 10)])
def test_neighbor_cap_overflow_matches_reference(family, cap):
    """Samples past the cap keep their exact degree and leave the estimate
    with nothing counted, as in the reference."""
    kw = SPECS[family]
    ref = jstats.collect(getattr(japi, family)(**kw), 2, metrics=("degree", "clustering"),
                         cluster_samples=48, neighbor_cap=cap)
    port = tstats.collect(getattr(tapi, family)(**kw), 2, metrics=("degree", "clustering"),
                          cluster_samples=48, neighbor_cap=cap, device="cpu")
    same_report(port.clustering, ref.clustering, family)
    cc = port.clustering
    assert (cc.degree > cap).any() and (cc.triangles[cc.degree > cap] == 0).all()


def test_empty_sample_and_directed_families():
    spec = dict(n=128, p=0.05, seed=1)
    ref = jstats.collect(japi.GNP(**spec), 2, metrics=("degree", "clustering"),
                         cluster_samples=0)
    port = tstats.collect(tapi.GNP(**spec), 2, metrics=("degree", "clustering"),
                          cluster_samples=0, device="cpu")
    same_report(port.clustering, ref.clustering, "empty")
    assert len(port.clustering.sample) == 0 and port.clustering.global_cc == 0.0
    for spec in (tapi.BA(n=64, d=2, seed=1), tapi.RMAT(log_n=6, m=100, seed=1),
                 tapi.GNM(n=64, m=100, directed=True, seed=1)):
        with pytest.raises(ValueError, match="undirected"):
            tstats.collect(spec, 2, metrics=("degree", "clustering"), device="cpu")


def test_sampler_needs_pass_one_first():
    s = tacc.ClusteringSampler(100, 1, 8, 16, "cpu")
    with pytest.raises(RuntimeError, match="finalize_neighbors"):
        s.count_triangles_chunk(torch.zeros((4, 2), dtype=torch.int64), count=4)


def test_collect_streams_rdg_in_waves_of_batch(monkeypatch):
    """The RDG candidate rows stream ``batch`` at a time (the reference
    batches RGG, RHG and RDG alike), with the reference's degrees."""
    spec = tapi.RDG(n=2000, dim=2, seed=4)
    seen = []
    real = tapi.iter_edge_chunks

    def counting(*a, **k):
        for ch in real(*a, **k):
            seen.append((k["batch"], ch.buffer.shape[0] if ch.buffer.dim() == 3 else 1))
            yield ch

    monkeypatch.setattr(tapi, "iter_edge_chunks", counting)
    port = tstats.collect(spec, 2, device="cpu", batch=64)
    waves = trt.wave_schedule(spec.plan(2, device="cpu"), 1, 64)
    assert {b for b, _ in seen} == {64}
    assert len(seen) == waves.num_waves < waves.valid.sum()
    assert max(rows for _, rows in seen) == 64
    ref = jstats.collect(japi.RDG(n=2000, dim=2, seed=4), 2, batch=64)
    np.testing.assert_array_equal(port.degree.degrees.numpy(), np.asarray(ref.degree.degrees))
