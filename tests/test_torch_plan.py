"""The port's ER plan emitters and plan dealing against the reference.

Every comparison is exact: the port's ``gnm_/gnp_ directed_/undirected_
plan`` tables, and those of ``deal_plan`` / the specs' ``plan(P)``, must
equal the reference's field by field (``np.array_equal`` on every
table, ``==`` on ``n``, ``capacity`` and ``rng_impl``), at P in {1, 2,
8}.  Reseeded plans must equal cold emissions.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import er as jer
from repro.distrib import engine as jeng
from repro_torch import api as tapi
from repro_torch.core import er as ter
from repro_torch.distrib import engine as teng

# one intra-op thread: the suite runs in several worker processes at once,
# and a pool of one thread per core in each of them oversubscribes the CPU
torch.set_num_threads(1)

PS = (1, 2, 8)
FIELDS = ("kind", "key_data", "universe", "count", "params", "fparams", "owned")


def same_plan(port, ref, tag):
    for f in FIELDS:
        a, b = getattr(port, f), getattr(ref, f)
        assert a.dtype == b.dtype and a.shape == b.shape, (tag, f, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"{tag}:{f}")
    assert (port.n, port.capacity, port.rng_impl) == (ref.n, ref.capacity, ref.rng_impl), tag


# (seed, n, m or p), the sizes of tests/test_plan_vectorized.py
EMITTERS = {
    "gnm_directed": (5, 4096, 30000),
    "gnm_undirected": (5, 4096, 30000),
    "gnp_directed": (5, 4096, 0.003),
    "gnp_undirected": (5, 4096, 0.003),
}


@pytest.mark.parametrize("P", PS)
@pytest.mark.parametrize("family", sorted(EMITTERS))
def test_plan_tables_match_reference(family, P):
    args = EMITTERS[family]
    ref = getattr(jer, f"{family}_plan")(*args, P)
    port = getattr(ter, f"{family}_plan")(*args, P)
    same_plan(port, ref, f"{family} P={P}")
    same_plan(teng.deal_plan(port, 3), jeng.deal_plan(ref, 3), f"{family} P={P} dealt")


@pytest.mark.parametrize("P", PS)
@pytest.mark.parametrize("spec", [
    dict(family="GNM", n=1 << 12, m=1 << 15, directed=False, seed=3),
    dict(family="GNM", n=1 << 12, m=1 << 15, directed=True, seed=3),
    dict(family="GNP", n=1 << 12, p=8 / (1 << 12), directed=False, seed=4),
    dict(family="GNP", n=1 << 12, p=8 / (1 << 12), directed=True, seed=4),
])
def test_spec_plan_matches_reference(spec, P):
    """``spec.plan(P)``: the virtual-chunk emission dealt onto P PEs."""
    kw = dict(spec)
    fam = kw.pop("family")
    port = getattr(tapi, fam)(**kw).plan(P)
    ref = getattr(japi, fam)(**kw).plan(P)
    same_plan(port, ref, f"{spec} P={P}")
    np.testing.assert_array_equal(teng.owned_chunk_index(port), jeng.owned_chunk_index(ref))
    assert port.total_edges == ref.total_edges


@pytest.mark.parametrize("family", sorted(EMITTERS))
def test_reseed_equals_cold_emission(family):
    args = EMITTERS[family]
    emit = getattr(ter, f"{family}_plan")
    warm = emit(*args, 8)
    for s in (6, 123):
        cold = emit(s, *args[1:], 8)
        same_plan(warm.reseed(s), cold, f"{family} reseed {s}")
        same_plan(teng.deal_plan(warm, 2).reseed(s), teng.deal_plan(cold, 2),
                  f"{family} dealt reseed {s}")
        same_plan(warm.reseed(s), getattr(jer, f"{family}_plan")(s, *args[1:], 8),
                  f"{family} reseed {s} vs reference")


def test_reseed_needs_an_emitter():
    plan = teng.chunk_plan_from_arrays(
        {f: getattr(jer.gnm_directed_plan(1, 256, 500, 2), f) for f in FIELDS}, 256, 320)
    with pytest.raises(ValueError):
        plan.reseed(2)


def test_chunk_key_data_matches_reference():
    """Chunk-id columns are int64 (``er._chunk_key_data``)."""
    rng = np.random.default_rng(1)
    cols = [rng.integers(0, 2 ** 33, 50).astype(np.int64), np.arange(50, dtype=np.int64)]
    for seed in (0, 2 ** 31 + 3):
        np.testing.assert_array_equal(ter._chunk_key_data(seed, cols),
                                      np.asarray(jer._chunk_key_data(seed, cols)))
        np.testing.assert_array_equal(ter._chunk_key_data(seed, cols[:1]),
                                      np.asarray(jer._chunk_key_data(seed, cols[:1])))


def test_make_chunk_plan_matches_reference():
    """Per-chunk specs padded into the tables, with keys given as the
    port's int64 key words or the reference's uint32 key data."""
    keys = [ter.device_key(7, 11, i) for i in range(5)]
    rows = [[(teng.KIND_TRI, 0, 45, 10, (0, 0, 0), True),
             (teng.KIND_RECT, 1, 100, 30, (10, 10, 0), False)],
            [],
            [(teng.KIND_DIRECTED, 2, 90, 7, (0, 10, 0), True),
             (teng.KIND_RECT, 3, 50, 49, (5, 20, 10), True),
             (teng.KIND_TRI, 4, 6, 6, (16, 0, 0), True)]]
    port = teng.make_chunk_plan(
        [[teng.ChunkSpec(k, keys[i], u, c, p, o) for k, i, u, c, p, o in r] for r in rows], 30)
    ref = jeng.make_chunk_plan(
        [[jeng.ChunkSpec(k, keys[i].numpy().astype(np.uint32), u, c, p, o)
          for k, i, u, c, p, o in r] for r in rows], 30)
    same_plan(port, ref, "make_chunk_plan")


@pytest.mark.parametrize("lo,hi", [(0, 1), (1, 3), (0, 4)])
def test_slice_plan_matches_reference(lo, hi):
    port = ter.gnm_undirected_plan(2, 1024, 4000, 4)
    ref = jer.gnm_undirected_plan(2, 1024, 4000, 4)
    same_plan(teng.slice_plan(port, lo, hi), jeng.slice_plan(ref, lo, hi), f"slice {lo}:{hi}")
    assert teng.slice_plan(port, lo, hi).reseed_fn is None
    with pytest.raises(ValueError):
        teng.slice_plan(port, 2, 2)


def test_plan_protocol():
    plan = ter.gnp_undirected_plan(1, 512, 0.01, 2)
    assert [a.dtype for a in plan.input_arrays()] == [
        np.int32, np.uint32, np.int64, np.int64, np.int64, np.float64, bool]
    assert plan.signature() == dataclasses.replace(plan, reseed_fn=None).signature()
    assert plan.kinds_present == (teng.KIND_TRI, teng.KIND_RECT)
    assert isinstance(ter.device_key(1), torch.Tensor)
