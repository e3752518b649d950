"""The port's batched chunk program against the reference's engine.

``chunk_plan_from_arrays`` carries the reference plan's own tables into
the port, so both engines execute the identical ``[P, C]`` table.  Every
comparison is exact: the keep masks must be equal, and so must the
edges on every kept entry (the padding slots past a chunk's count hold
decoded sentinels in both engines and are not part of the output).
"""
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.distrib import engine as jeng
from repro.distrib import runtime as jrt
from repro_torch.distrib import engine as teng
from repro_torch.distrib import runtime as trt

# one intra-op thread: the suite runs in several worker processes at once,
# and a pool of one thread per core in each of them oversubscribes the CPU
torch.set_num_threads(1)

FIELDS = ("kind", "key_data", "universe", "count", "params", "fparams", "owned")

SPECS = {
    "directed": japi.GNM(n=3000, m=20000, directed=True, seed=11),       # KIND_DIRECTED
    "undirected": japi.GNM(n=3000, m=20000, seed=12),                    # KIND_TRI + KIND_RECT
    "gnp-undirected": japi.GNP(n=2000, p=0.004, seed=13),
}


def port_plan_of(ref):
    return teng.chunk_plan_from_arrays({f: getattr(ref, f) for f in FIELDS},
                                       ref.n, ref.capacity)


@pytest.mark.parametrize("P", [1, 2, 8])
@pytest.mark.parametrize("name", sorted(SPECS))
def test_run_matches_reference_on_its_tables(name, P):
    ref = SPECS[name].plan(P)
    payload, valid, _ = jrt.run(ref)
    payload, valid = np.asarray(payload), np.asarray(valid)
    port = port_plan_of(ref)
    assert port.kinds_present == ref.kinds_present
    tp, tv = trt.run(port, "cpu")
    assert tp.dtype == torch.int64 and tv.dtype == torch.bool
    assert tuple(tp.shape) == payload.shape and tuple(tv.shape) == valid.shape
    np.testing.assert_array_equal(tv.numpy(), valid)
    np.testing.assert_array_equal(tp.numpy()[valid], payload[valid])


def test_all_sampled_kinds_are_covered():
    kinds = set()
    for spec in SPECS.values():
        kinds |= set(spec.plan(2).kinds_present)
    assert kinds == {teng.KIND_DIRECTED, teng.KIND_TRI, teng.KIND_RECT}


def test_chunk_plan_from_arrays_keeps_the_tables():
    ref = SPECS["undirected"].plan(2)
    port = port_plan_of(ref)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(port, f), getattr(ref, f))
        assert getattr(port, f).dtype == getattr(ref, f).dtype
    assert (port.n, port.capacity, port.rng_impl) == (ref.n, ref.capacity, ref.rng_impl)


@pytest.mark.parametrize("batch", [1, 3, 100])
def test_wave_schedule_matches_reference(batch):
    ref = SPECS["undirected"].plan(4)
    want = jrt.wave_schedule(ref, 1, batch)
    got = trt.wave_schedule(port_plan_of(ref), 1, batch)
    np.testing.assert_array_equal(got.sched, want.sched)
    np.testing.assert_array_equal(got.valid, want.valid)
    assert got.batch == want.batch and got.num_waves == want.num_waves
    for gw, ww in zip(got.rows, want.rows):
        for g, w in zip(gw, ww):
            assert g[0] == w[0]
            np.testing.assert_array_equal(g[1], w[1])


@pytest.mark.parametrize("batch,prefetch", [(1, 1), (4, 2)])
def test_stream_regrouped_by_pe_equals_run(batch, prefetch):
    ref = SPECS["gnp-undirected"].plan(4)
    plan = port_plan_of(ref)
    payload, valid = trt.run(plan, "cpu")
    want = {pe: payload[pe][valid[pe]] for pe in range(plan.num_pes)}
    got = {pe: [] for pe in range(plan.num_pes)}
    for pe, slots, buf, ok in trt.stream_slots(plan, batch=batch, prefetch=prefetch,
                                               device="cpu"):
        assert buf.shape[0] == ok.shape[0] <= batch
        got[pe].append(buf[ok])
    for pe in range(plan.num_pes):
        assert torch.equal(torch.cat(got[pe]) if got[pe] else want[pe][:0], want[pe])


def test_unported_kinds_raise():
    """Every kind of the reference has a program now (R-MAT and BA rows:
    tests/test_torch_families.py); a code that is no kind raises."""
    ref = SPECS["directed"].plan(1)
    tables = {f: getattr(ref, f).copy() for f in FIELDS}
    tables["kind"][0, 0] = jeng.KIND_RMAT
    assert teng.chunk_plan_from_arrays(tables, ref.n, ref.capacity).kinds_present == (
        teng.KIND_DIRECTED, teng.KIND_RMAT)
    tables["kind"][0, 0] = 9
    with pytest.raises(ValueError, match="unknown chunk kinds"):
        teng.chunk_plan_from_arrays(tables, ref.n, ref.capacity).slot_fn()


def test_resolve_device():
    assert trt.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        trt.resolve_device("meta")
