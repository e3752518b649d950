"""The LM data pipeline's graphs and batches against the JAX package,
exactly: ``er.gnm_undirected_pe`` and ``rhg.rhg_pe`` edges (and
``rhg_pe``'s local vertices) for several (n, P, pe), the RHG feature
rows and their padding, ``make_batch`` tokens, labels and positions for
both corpora at 1 and 4 shards, and the reference test's determinism,
elasticity and label-shift checks on the port.
"""
import numpy as np
import pytest
import torch

from repro.core import er as jer
from repro.core import rhg as jrhg
from repro.data import pipeline as JD
from repro.kernels.hypdist import ops as jhyp
from repro_torch.core import er as ter
from repro_torch.core import rhg as trhg
from repro_torch.data import pipeline as TD
from repro_torch.kernels.hypdist import ops as thyp

torch.set_num_threads(1)


@pytest.mark.parametrize("n,m,P,pe", [(4096, 32768, 1, 0), (4096, 32768, 4, 0),
                                      (4096, 32768, 4, 3), (1000, 5000, 3, 1),
                                      (37, 100, 5, 4)])
def test_gnm_undirected_pe_matches_the_reference(n, m, P, pe):
    want = jer.gnm_undirected_pe(7, n, m, P, pe)
    got = ter.gnm_undirected_pe(7, n, m, P, pe, device="cpu")
    assert got.dtype == np.int64 and want.shape == got.shape
    np.testing.assert_array_equal(got, want)
    assert (got[:, 0] > got[:, 1]).all()


@pytest.mark.parametrize("n,avg_deg,gamma,P,pe,batch", [
    (4096, 16.0, 2.6, 1, 0, 512), (4096, 16.0, 2.6, 4, 1, 512), (2000, 8.0, 2.8, 3, 2, 512),
    (1500, 12.0, 2.4, 2, 0, 64), (300, 6.0, 3.0, 8, 7, 512)])
def test_rhg_pe_matches_the_reference(n, avg_deg, gamma, P, pe, batch):
    want = jrhg.rhg_pe(jrhg.RHGParams(n, avg_deg, gamma, 11), P, pe, batch=batch)
    got = trhg.rhg_pe(trhg.RHGParams(n, avg_deg, gamma, 11), P, pe, batch=batch, device="cpu")
    assert len(got) == 4
    for w, g in zip(want, got):
        assert w.shape == g.shape
        np.testing.assert_array_equal(g, w)
    assert len(got[0]) > 0


def test_rhg_pe_calls_pair_mask_on_padded_blocks(monkeypatch):
    """``rhg_pe`` makes one ``hyp_edges`` call (and no ``pair_mask``
    call) whose segments are the reference's ``_adjacency`` calls, one
    for one and in order: each segment's query and candidate rows equal
    that call's inputs before their padding to 128-row blocks."""
    from repro_torch.kernels.pairmask import ops as tops

    seen, ref_calls = [], []
    real = trhg.hyp_edges

    def spy(q, c, q_gid, c_gid, segments, cosh_r):
        seen.append((q, c, segments))
        return real(q, c, q_gid, c_gid, segments, cosh_r)

    real_ref = jrhg._adjacency

    def ref_spy(q_feat, c_feat, *a, **k):
        ref_calls.append((np.array(q_feat), np.array(c_feat)))
        return real_ref(q_feat, c_feat, *a, **k)

    monkeypatch.setattr(trhg, "hyp_edges", spy)
    monkeypatch.setattr(tops, "pair_mask", None)    # a call would fail
    monkeypatch.setattr(jrhg, "_adjacency", ref_spy)
    want = jrhg.rhg_pe(jrhg.RHGParams(2000, 8.0, 2.8, 5), 2, 1)
    got = trhg.rhg_pe(trhg.RHGParams(2000, 8.0, 2.8, 5), 2, 1, device="cpu")
    np.testing.assert_array_equal(got[0], want[0])
    assert len(seen) == 1
    q, c, segments = seen[0]
    assert q.shape[1] == c.shape[1] == 4
    assert len(segments) == len(ref_calls) > 10
    for (qo, ql, co, cl), (qf, cf) in zip(segments.tolist(), ref_calls):
        assert ql == len(qf) and cl == len(cf) and qf.shape[1] == cf.shape[1] == thyp.FEAT
        np.testing.assert_array_equal(q[qo:qo + ql].numpy(), qf[:, :4])
        np.testing.assert_array_equal(c[co:co + cl].numpy(), cf[:, :4])


def test_range_counter_matches_the_reference():
    a = jrhg.RangeCounter(3, 32, 1, 40, 500)
    b = trhg.RangeCounter(3, 32, 1, 40, 500)
    assert [a.cell_count(i) for i in range(40)] == [b.cell_count(i) for i in range(40)]
    assert [a.cell_offset(i) for i in range(40)] == [b.cell_offset(i) for i in range(40)]
    plan_j = jrhg.RHGPlan(jrhg.RHGParams(3000, 10.0, 2.5, 4), 3)
    plan_t = trhg.RHGPlan(trhg.RHGParams(3000, 10.0, 2.5, 4), 3)
    assert plan_j.n_core == plan_t.n_core
    assert [(x.idx, x.lo, x.hi, x.count, x.cells, x.gid0) for x in plan_j.annuli] == \
        [(x.idx, x.lo, x.hi, x.count, x.cells, x.gid0) for x in plan_t.annuli]
    for ann in plan_t.annuli:
        b_, cell = ann.idx, ann.cells - 1
        for w, g in zip(plan_j.cell_vertices(b_, cell), plan_t.cell_vertices(b_, cell)):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_features_and_padding_match_the_reference():
    rng = np.random.default_rng(0)
    r = np.concatenate([[0.0, 1e-13], rng.uniform(0, 20, 300)])
    theta = rng.uniform(0, 2 * np.pi, len(r))
    want = jhyp.precompute_features(r, theta)
    got = thyp.precompute_features(r, theta)
    np.testing.assert_array_equal(got, want)
    assert thyp.FEAT == jhyp.FEAT
    np.testing.assert_array_equal(thyp._PAD_ROW, jhyp._PAD_ROW)
    for n in (0, 5, 128, 302):
        for rows in (None, n, 200 + n, 257 + n):
            np.testing.assert_array_equal(thyp.pad_features(got[:n], rows),
                                          jhyp.pad_features(want[:n], rows))


BATCHES = [dict(kind="rhg_walk", num_shards=1), dict(kind="rhg_walk", num_shards=4),
           dict(kind="er_walk", num_shards=1), dict(kind="er_walk", num_shards=4)]


@pytest.mark.parametrize("kw", BATCHES, ids=lambda k: f"{k['kind']}-{k['num_shards']}")
def test_make_batch_matches_the_reference(kw):
    cfgs = [M.DataConfig(n_vertices=2048, vocab=500, seq_len=64, batch_per_shard=3, seed=5,
                         **kw) for M in (JD, TD)]
    for step in (0, 1):
        for shard in range(kw["num_shards"]):
            want = JD.make_batch(cfgs[0], step, shard)
            got = TD.make_batch(cfgs[1], step, shard, device="cpu")
            assert set(got) == set(want)
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])
        want = JD.make_global_batch(cfgs[0], step)
        got = TD.make_global_batch(cfgs[1], step, device="cpu")
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_data_pipeline_determinism_and_elasticity():
    dc = TD.DataConfig(num_shards=4, seed=9)
    a = TD.make_batch(dc, 5, 2, device="cpu")
    b = TD.make_batch(dc, 5, 2, device="cpu")
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    c = TD.make_batch(dc, 6, 2, device="cpu")
    assert not np.array_equal(a["tokens"], c["tokens"])
    # labels are next-token shifted
    np.testing.assert_array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert a["tokens"].min() >= 0 and a["tokens"].max() < dc.vocab
    # elastic: the same step at another shard count is another pure function
    d = TD.make_global_batch(TD.DataConfig(num_shards=2, seed=9), 5, device="cpu")
    assert d["tokens"].shape == (8, dc.seq_len)
    np.testing.assert_array_equal(
        d["tokens"], JD.make_global_batch(JD.DataConfig(num_shards=2, seed=9), 5)["tokens"])


def test_the_pipeline_runs_on_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TD.make_batch(TD.DataConfig(n_vertices=64, seed=1), 0, 0)
