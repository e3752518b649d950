"""Plan/execute overlap of the port against the JAX package:
``PlanEmitter`` and its planner thread, ``slice_plan`` over both table
plans, the native SBM and RDG segments and ``iter_edge_chunks(overlap=)``.

Every comparison is exact: plan tables field by field with
``np.array_equal`` (``capacity`` aside, which a segment may narrow:
then a common prefix and a dead tail), edges with ``np.array_equal``.
The port runs on the CPU (``device="cpu"``).
"""
import dataclasses
import gc
import threading
import time

import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import rdg as jrdg
from repro.core import sbm as jsbm
from repro_torch import api as tapi
from repro_torch.core import rdg as trdg
from repro_torch.core import sbm as tsbm
from repro_torch.distrib import engine as teng
from repro_torch.distrib import runtime as trt

torch.set_num_threads(1)


def same_plan(a, b, what: str) -> None:
    """Every field equal; ``reseed_fn`` and ``capacity`` aside, and a
    narrower table width read as a common prefix plus a dead tail
    (``active``/``kind`` false or zero there)."""
    assert type(a).__name__ == type(b).__name__, what
    for f in dataclasses.fields(a):
        if f.name in ("reseed_fn", "capacity"):
            continue
        x, y = getattr(a, f.name), getattr(b, f.name)
        if not isinstance(x, np.ndarray):
            assert x == y, (what, f.name, x, y)
            continue
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape[0] == y.shape[0], (what, f.name)
        C = min(x.shape[1], y.shape[1])
        np.testing.assert_array_equal(x[:, :C], y[:, :C], err_msg=f"{what}: {f.name}")
        live = getattr(a if x.shape[1] > C else b, "active", None)
        if live is None:
            live = getattr(a if x.shape[1] > C else b, "kind")
        assert not np.asarray(live)[:, C:].any(), (what, f.name, "tail")


def regroup(chunks, P):
    per = [[] for _ in range(P)]
    for c in chunks:
        per[c.pe].append(c.edges())
    return torch.cat([e for pe in per for e in pe]).numpy()


# --------------------------------------------------------------- emitter

def test_segment_bounds_cover_align_and_refuse():
    for P, segs in ((16, 5), (8, 4), (7, 0), (3, 8)):
        em = trt.PlanEmitter(P, lambda lo, hi: None, segments=segs)
        for D in [d for d in (1, 2, 4) if P % d == 0]:
            bounds = em.segment_bounds(D)
            assert bounds[0][0] == 0 and bounds[-1][1] == P
            assert all(hi == lo2 for (_, hi), (lo2, _) in zip(bounds, bounds[1:]))
            assert all((hi - lo) % D == 0 and hi > lo for lo, hi in bounds)
            assert len(bounds) == max(1, min(segs or trt.DEFAULT_SEGMENTS, P // D))
    with pytest.raises(ValueError):
        trt.PlanEmitter(6, lambda lo, hi: None).segment_bounds(4)


def test_slice_plan_is_generic_and_equals_the_reference():
    from repro.distrib import engine as jeng

    plans = [(tapi.GNM(n=1024, m=4096, seed=7).plan(4), japi.GNM(n=1024, m=4096, seed=7).plan(4)),
             (tapi.RHG(n=800, avg_deg=6, gamma=2.8, seed=1).plan(4),
              japi.RHG(n=800, avg_deg=6, gamma=2.8, seed=1).plan(4))]
    for tp, jp in plans:
        for lo, hi in ((0, 4), (1, 3), (3, 4)):
            got = teng.slice_plan(tp, lo, hi)
            assert got.num_pes == hi - lo and got.reseed_fn is None
            same_plan(got, jeng.slice_plan(jp, lo, hi), f"{type(tp).__name__}[{lo}:{hi}]")
        with pytest.raises(ValueError):
            teng.slice_plan(tp, 2, 2)


@pytest.mark.parametrize("P,B,n,seed", [(8, 16, 4000, 3), (4, 10, 1000, 0)])
def test_sbm_plan_segment_matches_reference_and_slice(P, B, n, seed):
    full = tsbm.sbm_plan(seed, n, B, 0.02, 0.001, P)
    for lo, hi in ((0, P), (0, P // 2), (P // 2, P), (1, 2)):
        seg = tsbm.sbm_plan_segment(seed, n, B, 0.02, 0.001, P, lo, hi)
        ref = jsbm.sbm_plan_segment(seed, n, B, 0.02, 0.001, P, lo, hi)
        same_plan(seg, ref, f"ref[{lo}:{hi}]")
        assert seg.capacity == ref.capacity
        same_plan(seg, teng.slice_plan(full, lo, hi), f"slice[{lo}:{hi}]")


@pytest.mark.parametrize("P,n,dim,seed", [(8, 400, 2, 3), (4, 300, 3, 1)])
def test_rdg_plan_segment_matches_reference_and_slice(P, n, dim, seed):
    trdg.rdg_structure.cache_clear()
    full = trdg.rdg_pair_plan(seed, n, P, dim, device="cpu")
    for lo, hi in ((0, P), (0, P // 2), (P // 2, P), (1, 2)):
        seg = tapi.RDG(n=n, dim=dim, seed=seed).plan_segment(P, lo, hi, device="cpu")
        same_plan(seg, jrdg.rdg_plan_segment(seed, n, P, lo, hi, dim), f"ref[{lo}:{hi}]")
        same_plan(seg, teng.slice_plan(full, lo, hi), f"slice[{lo}:{hi}]")


def test_emitter_from_plan_regroups_to_the_plan_stream():
    plan = tsbm.sbm_plan(3, 2000, 16, 0.02, 0.001, 8)

    def per_pe(stream):
        out = [[] for _ in range(8)]
        for pe, slots, payload, valid in stream:
            out[pe].append((np.asarray(slots).copy(), payload.numpy(), valid.numpy()))
        return out

    want = per_pe(trt.stream_slots(plan, device="cpu"))
    got = per_pe(trt.stream_slots(trt.PlanEmitter.from_plan(plan, 4), device="cpu"))
    assert [len(x) for x in got] == [len(x) for x in want]
    for a, b in zip(got, want):
        for (sa, pa, va), (sb, pb, vb) in zip(a, b):
            np.testing.assert_array_equal(sa, sb)
            np.testing.assert_array_equal(pa, pb)
            np.testing.assert_array_equal(va, vb)


# --------------------------------------------------------------- streams

OVERLAP_SPECS = [
    ("SBM", dict(n=600, blocks=6, p_in=0.05, p_out=0.005, seed=2)),
    ("GNM", dict(n=1024, m=4096, seed=7)),
    ("RGG", dict(n=600, radius=0.07, seed=3)),
    ("RDG", dict(n=400, dim=2, seed=4)),
]


@pytest.mark.parametrize("family,params", OVERLAP_SPECS, ids=[f for f, _ in OVERLAP_SPECS])
def test_overlapped_stream_equals_generate_of_both_packages(family, params):
    P = 8
    chunks = list(tapi.iter_edge_chunks(getattr(tapi, family)(**params), P, device="cpu",
                                        overlap=4))
    assert all(c.count is None for c in chunks)
    got = regroup(chunks, P)
    np.testing.assert_array_equal(got, np.asarray(japi.generate(getattr(japi, family)(**params),
                                                                P).edges))
    np.testing.assert_array_equal(
        got, tapi.generate(getattr(tapi, family)(**params), P, device="cpu").edges.numpy())


def test_overlapped_batched_stream_keeps_per_pe_order():
    spec = dict(n=600, blocks=6, p_in=0.05, p_out=0.005, seed=2)
    got = regroup(tapi.iter_edge_chunks(tapi.SBM(**spec), 8, device="cpu", overlap=3, batch=4), 8)
    np.testing.assert_array_equal(got, tapi.generate(tapi.SBM(**spec), 8, device="cpu").edges.numpy())


class PlannerFault(RuntimeError):
    pass


def test_planner_exception_reaches_the_consumer():
    plan = tsbm.sbm_plan(3, 600, 6, 0.05, 0.005, 4)
    fault = PlannerFault("segment 2 failed")

    def build(lo, hi):
        if lo >= 2:
            raise fault
        return teng.slice_plan(plan, lo, hi)

    seen = []
    with pytest.raises(PlannerFault) as info:
        for pe, *_ in trt.stream_slots(trt.PlanEmitter(4, build, 4), device="cpu"):
            seen.append(pe)
    assert info.value is fault
    assert seen and set(seen) <= {0, 1}


def _planner_threads():
    return [t for t in threading.enumerate()
            if t.name == "repro-torch-plan-emitter" and t.is_alive()]


def test_abandoned_overlapped_stream_stops_its_planner():
    """A consumer that takes one chunk and drops the stream leaves no
    planner thread behind (it would otherwise wait on a full queue)."""
    calls = []
    plan = tsbm.sbm_plan(3, 600, 6, 0.05, 0.005, 8)

    def build(lo, hi):
        calls.append(lo)
        return teng.slice_plan(plan, lo, hi)

    it = trt.stream_slots(trt.PlanEmitter(8, build, 8), device="cpu")
    next(it)
    del it
    gc.collect()
    deadline = time.monotonic() + 10
    while _planner_threads() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not _planner_threads()
    assert len(calls) < 8           # it stopped before planning every segment


def test_column_cache_computes_a_seed_once_across_threads():
    """The planner thread and the consumer may ask for one seed's columns
    at once: one computes them, the others wait and get the same object."""
    import sys

    st = trdg.RdgStructure(400, 2, 2)
    calls = []

    def compute(seed, device):
        calls.append(seed)
        time.sleep(0.01)
        return (seed,)

    st._compute_columns = compute
    got = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: got.append(st._columns(5, "cpu")))
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert calls == [5] and len(got) == 16 and all(g is got[0] for g in got)
    st.clear_columns()
    st._columns(5, "cpu")
    assert calls == [5, 5]
