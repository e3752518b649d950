"""``repro_torch.api`` against ``repro.api``: the same edges, bit for bit.

Every comparison is exact (``np.array_equal`` on int64 edge lists in
order).  The port runs on the CPU (``device="cpu"``), where each kernel
wrapper computes its plain PyTorch version.
"""
import numpy as np
import pytest
import torch

from repro import api as japi
from repro_torch import api as tapi
from repro_torch.distrib import runtime as trt

# one intra-op thread: the suite runs in several worker processes at once,
# and a pool of one thread per core in each of them oversubscribes the CPU
torch.set_num_threads(1)

SPECS = [
    ("GNM", dict(n=1 << 12, m=1 << 15, directed=False, seed=21)),
    ("GNM", dict(n=1 << 12, m=1 << 15, directed=True, seed=22)),
    ("GNP", dict(n=1 << 12, p=6 / (1 << 12), directed=False, seed=23)),
    ("GNP", dict(n=1 << 11, p=8 / (1 << 11), directed=True, seed=24)),
]
IDS = [f"{f}-{'d' if kw['directed'] else 'u'}" for f, kw in SPECS]

_REF_CACHE: dict = {}


def ref_edges(family, kw, P) -> np.ndarray:
    key = (family, tuple(sorted(kw.items())), P)
    if key not in _REF_CACHE:
        _REF_CACHE[key] = np.asarray(japi.generate(getattr(japi, family)(**kw), P).edges)
    return _REF_CACHE[key]


@pytest.mark.parametrize("P", [1, 2, 8])
@pytest.mark.parametrize("family,kw", SPECS, ids=IDS)
def test_generate_matches_reference(family, kw, P):
    g = tapi.generate(getattr(tapi, family)(**kw), P, device="cpu")
    want = ref_edges(family, kw, P)
    assert g.edges.dtype == torch.int64 and g.edges.device.type == "cpu"
    assert (g.n, g.directed, g.m) == (kw["n"], kw["directed"], len(want))
    np.testing.assert_array_equal(g.edges.numpy(), want)


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("family,kw", SPECS, ids=IDS)
def test_stream_regrouped_by_pe_equals_generate(family, kw, batch):
    P = 2
    spec = getattr(tapi, family)(**kw)
    per_pe: dict = {}
    for ch in tapi.iter_edge_chunks(spec, P, device="cpu", batch=batch):
        e = ch.edges()
        assert len(e) == ch.count
        if batch == 1:
            assert ch.buffer.shape == (spec.plan(P).capacity, 2) and ch.mask.ndim == 1
        else:
            assert ch.buffer.ndim == 3 and ch.mask.shape == ch.buffer.shape[:2]
        per_pe.setdefault(ch.pe, []).append(e)
    got = torch.cat([torch.cat(per_pe[pe]) for pe in sorted(per_pe)])
    np.testing.assert_array_equal(got.numpy(), ref_edges(family, kw, P))


def test_graph_degrees_and_validation_helpers():
    from repro.core import graph as jgraph
    from repro_torch.core import graph as tgraph

    for family, kw in SPECS[:2]:
        g = tapi.generate(getattr(tapi, family)(**kw), 2, device="cpu")
        e = g.edges.numpy()
        np.testing.assert_array_equal(g.degrees().numpy(),
                                      np.asarray(jgraph.degrees(e, g.n, g.directed)))
        assert tgraph.has_self_loops(g.edges) == jgraph.has_self_loops(e) is False
        assert tgraph.has_duplicates(g.edges) == jgraph.has_duplicates(e) is False
    mixed = torch.tensor([[1, 2], [2, 1], [5, 3], [3, 5], [4, 4]])
    np.testing.assert_array_equal(tgraph.canonical_undirected(mixed).numpy(),
                                  jgraph.canonical_undirected(mixed.numpy()))
    assert tgraph.has_self_loops(mixed) and not tgraph.has_duplicates(mixed)
    assert tgraph.has_duplicates(torch.tensor([[1, 2], [1, 2]]))


def test_cuda_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = tapi.GNM(n=100, m=200, seed=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        tapi.generate(spec, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        tapi.generate(spec, 1, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        next(tapi.iter_edge_chunks(spec, 1))
    with pytest.raises(RuntimeError, match="CUDA"):
        tapi.collect(spec, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        trt.run(spec.plan(1))


def test_rbg_raises():
    spec = tapi.GNP(n=100, p=0.1, seed=1)
    with pytest.raises(ValueError, match="rbg"):
        tapi.generate(spec, 1, device="cpu", rng_impl="rbg")
    with pytest.raises(ValueError, match="rbg"):
        next(tapi.iter_edge_chunks(spec, 1, device="cpu", rng_impl="rbg"))


def test_p_invariance():
    """Any P up to the default virtual chunk grid gives the same edge set."""
    spec = tapi.GNM(n=500, m=3000, seed=5)

    def edge_set(P):
        e = tapi.generate(spec, P, device="cpu").edges
        return torch.sort(e[:, 0] * spec.n + e[:, 1]).values

    want = edge_set(1)
    for P in (3, tapi.DEFAULT_CHUNKS):
        assert torch.equal(edge_set(P), want)
