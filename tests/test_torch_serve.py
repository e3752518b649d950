"""The port's serving tier against the JAX package: plan-cache reseeds,
packed mixed-request slabs, continuous batching and fault reissue, every
served request equal to ``repro.api.generate``'s edges in order.

The port runs on the CPU (``device="cpu"``, the kernels' plain
versions); ``D`` is the slab's row count (the reference's mesh rows).
Comparisons are exact: edges with ``np.array_equal``, plan tables and
slab tables field by field.
"""
import dataclasses
from functools import lru_cache

import numpy as np
import pytest
import torch

from repro import api as japi
from repro.serve import program_of as jprogram_of
from repro_torch import api as tapi
from repro_torch import obs
from repro_torch.distrib import engine
from repro_torch.serve import PlanCache, Service, program_of, spec_shape

torch.set_num_threads(1)

CPU = torch.device("cpu")
FAMILIES = ("GNM", "GNP", "BA", "RMAT", "SBM", "RGG", "RHG", "RDG")


def both(name, **kw):
    """The same spec in the port and in the JAX package."""
    return getattr(tapi, name)(**kw), getattr(japi, name)(**kw)


def mixed_specs():
    """Eight families, distinct seeds: one of each shape, GNM twice."""
    return [
        both("GNM", n=128, m=400, seed=11),
        both("GNM", n=128, m=400, seed=12),            # same shape, new seed
        both("GNM", n=128, m=400, directed=True, seed=13),
        both("GNP", n=100, p=0.06, seed=5),
        both("BA", n=90, d=2, seed=3),
        both("RMAT", log_n=6, m=120, seed=9),
        both("SBM", n=96, blocks=3, p_in=0.2, p_out=0.02, seed=4),
        both("RGG", n=80, radius=0.2, seed=2),
        both("RHG", n=70, avg_deg=4.0, gamma=2.7, seed=8),
        both("RDG", n=40, seed=6),
    ]


@lru_cache(maxsize=None)
def ref_edges(jspec, P: int) -> np.ndarray:
    return np.asarray(japi.generate(jspec, P).edges)


def assert_graph_equal(got, jspec, P: int) -> None:
    assert got.n == jspec.num_vertices and got.directed == jspec.directed
    assert got.edges.device.type == "cpu"
    np.testing.assert_array_equal(got.edges.numpy(), ref_edges(jspec, P),
                                  err_msg=f"{jspec} P={P}")


# ------------------------------------------------------- serve == generate

@pytest.mark.parametrize("P,D", [(1, 1), (2, 4), (8, 1), (8, 4)])
def test_serve_matches_reference_generate_mixed_families(P, D):
    """Concurrent mixed-family requests == the reference's generate(),
    edge for edge, at several virtual PE counts and slab row counts."""
    specs = mixed_specs()
    svc = Service(P, D=D, device=CPU)
    for (tspec, jspec), g in zip(specs, svc.serve([t for t, _ in specs])):
        assert_graph_equal(g, jspec, P)
    assert svc.stats["cache"]["hits"] >= 1  # the repeated GNM shape


def test_serve_64_concurrent_requests():
    """64 concurrent requests of four families with distinct seeds,
    packed into shared slabs."""
    shapes = [
        lambda s: both("GNM", n=256, m=700, seed=s, chunks=8),
        lambda s: both("GNP", n=256, p=0.01, seed=s, chunks=8),
        lambda s: both("BA", n=128, d=2, seed=s),
        lambda s: both("RGG", n=96, radius=0.15, seed=s),
    ]
    specs = [shapes[i % 4](1000 + i) for i in range(64)]
    svc = Service(2, slab_batch=16, device=CPU)
    graphs = svc.serve([t for t, _ in specs])
    for (_, jspec), g in zip(specs, graphs):
        assert_graph_equal(g, jspec, 2)
    st = svc.stats
    assert st["cache"]["hits"] == 60 and st["cache"]["misses"] == 4
    # packing really shares slabs: far fewer launches than slots
    assert st["slabs"] < st["slots"] / 4


def test_serve_function_front_door():
    specs = [both("GNM", n=64, m=100, seed=1), both("RGG", n=50, radius=0.25, seed=2)]
    for (_, jspec), g in zip(specs, tapi.serve([t for t, _ in specs], 2, device="cpu")):
        assert_graph_equal(g, jspec, 2)
    svc = tapi.make_service(2, device="cpu", slab_batch=4)
    assert isinstance(svc, Service) and svc.P == 2 and svc.scheduler.B == 4


def test_service_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        Service(1)


# ------------------------------------------------------------- plan cache

def test_spec_shape_excludes_seed():
    a, b = tapi.GNM(n=64, m=100, seed=1), tapi.GNM(n=64, m=100, seed=999)
    assert spec_shape(a) == spec_shape(b)
    assert spec_shape(a) != spec_shape(tapi.GNM(n=64, m=101, seed=1))
    assert spec_shape(a) != spec_shape(tapi.GNP(n=64, p=0.1, seed=1))
    from repro.serve import spec_shape as jspec_shape
    assert spec_shape(a) == jspec_shape(japi.GNM(n=64, m=100, seed=1))
    with pytest.raises(TypeError):
        spec_shape(object())


def plans_equal(a, b) -> None:
    assert type(a).__name__ == type(b).__name__
    for f in dataclasses.fields(a):
        if f.name in ("reseed_fn", "gid0"):
            continue
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, np.asarray(y), err_msg=f.name)
            assert x.dtype == np.asarray(y).dtype, f.name
        else:
            assert x == y, (f.name, x, y)


MAKERS = {
    "gnm": lambda s: both("GNM", n=128, m=300, seed=s),
    "gnm-dir": lambda s: both("GNM", n=128, m=300, directed=True, seed=s),
    "gnp": lambda s: both("GNP", n=100, p=0.05, seed=s),
    "ba": lambda s: both("BA", n=90, d=2, seed=s),
    "rmat": lambda s: both("RMAT", log_n=6, m=120, seed=s),
    "sbm": lambda s: both("SBM", n=96, blocks=3, p_in=0.2, p_out=0.02, seed=s),
    "rgg": lambda s: both("RGG", n=80, radius=0.2, seed=s),
    "rhg": lambda s: both("RHG", n=70, avg_deg=4.0, gamma=2.7, seed=s),
    "rdg": lambda s: both("RDG", n=40, seed=s),
}


@pytest.mark.parametrize("make", list(MAKERS.values()), ids=list(MAKERS))
def test_plan_cache_hit_reseed_equals_cold(make):
    """A cache hit reseeded to the request's seed == the cold plan for
    that seed, field by field, and == the reference's cold plan."""
    cache = PlanCache()
    cache.plan(make(7)[0], 3, "threefry2x32", CPU)            # cold (miss)
    hot = cache.plan(make(8)[0], 3, "threefry2x32", CPU)      # hit -> reseed
    assert cache.hits == 1 and cache.misses == 1
    plans_equal(hot, make(8)[0].plan(3, device=CPU))
    plans_equal(hot, make(8)[1].plan(3))


def test_plan_cache_lru_eviction():
    cache = PlanCache(capacity=2)
    for m in (100, 110, 120):
        cache.plan(tapi.GNM(n=64, m=m, seed=1), 1, "threefry2x32")
    assert cache.evictions == 1 and len(cache) == 2
    cache.plan(tapi.GNM(n=64, m=100, seed=2), 1, "threefry2x32")  # evicted: miss
    assert cache.misses == 4 and cache.hits == 0
    cache.plan(tapi.GNM(n=64, m=120, seed=3), 1, "threefry2x32")  # still warm
    assert cache.hits == 1
    with pytest.raises(ValueError):
        PlanCache(capacity=0)


def test_plan_cache_events_and_reseed_spans():
    cache = PlanCache()
    with obs.capture() as tr:
        cache.plan(tapi.GNM(n=64, m=100, seed=1), 2, "threefry2x32")
        cache.plan(tapi.GNM(n=64, m=100, seed=2), 2, "threefry2x32")
    evs = [r.attrs["hit"] for r in tr.spans() if r.name == "plan_cache"]
    assert evs == [False, True]
    assert "plan/reseed" in {r.name for r in tr.spans()}


# -------------------------------------------------- packing & mixed slabs

def test_chunk_families_share_a_packing_group():
    """G(n,m) and BA rows run under one slab program (kind dispatch is
    per row), as do RGG and RHG rows."""
    a = program_of(tapi.GNM(n=128, m=300, seed=1).plan(2))
    b = program_of(tapi.BA(n=150, d=2, seed=2).plan(2))
    if a.capacity == b.capacity:  # same capacity class -> same program
        assert a.signature() == b.signature()
    assert a.kinds == b.kinds  # both run the sampled + BA dispatch
    g = program_of(tapi.RGG(n=80, radius=0.2, seed=1).plan(2))
    h = program_of(tapi.RHG(n=70, avg_deg=4.0, gamma=2.7, seed=2).plan(2))
    assert g.kinds == h.kinds  # HYP + TORUS in one program
    cert = program_of(tapi.RDG(n=40, seed=3).plan(2, device=CPU))
    assert cert.kinds != g.kinds  # CERT packs only with exact-capacity peers
    with pytest.raises(TypeError):
        program_of(tapi.RGG(n=80, radius=0.2, seed=1).point_plan(2))


SLAB_SPECS = [both("GNM", n=256, m=900, seed=3), both("GNP", n=100, p=0.06, seed=5),
              both("BA", n=90, d=2, seed=3), both("RMAT", log_n=6, m=120, seed=9),
              both("SBM", n=96, blocks=3, p_in=0.2, p_out=0.02, seed=4),
              both("RGG", n=80, radius=0.2, seed=2),
              both("RHG", n=70, avg_deg=4.0, gamma=2.7, seed=8),
              both("RDG", n=40, seed=6)]


@pytest.mark.parametrize("tspec,jspec", SLAB_SPECS, ids=[t for t in FAMILIES])
def test_slab_program_tables_equal_the_reference(tspec, jspec):
    """``program_of(plan)``'s signature, ``slab_arrays`` and
    ``gather_rows`` equal the reference's for the same spec, field by
    field (dtypes included)."""
    tprog = program_of(tspec.plan(4, device=CPU))
    jprog = jprogram_of(jspec.plan(4))
    assert tprog.signature() == jprog.signature()
    for a, b in zip(tprog.slab_arrays(3, 5), jprog.slab_arrays(3, 5)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    got = tprog.gather_rows(tspec.plan(4, device=CPU))
    want = jprog.gather_rows(jspec.plan(4))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_peek_slab_is_what_tick_runs():
    svc = Service(2, D=2, slab_batch=3, device=CPU)
    svc.submit(tapi.GNM(n=256, m=900, seed=1, chunks=8))
    prog, valid, rows = svc.scheduler.peek_slab()
    before = svc.scheduler.pending
    assert valid.shape == (2, 3) and valid.sum() == min(before, 6)
    assert (rows[0][~valid] == 0).all()          # padding rows are EMPTY
    assert svc.scheduler.pending == before       # nothing dequeued
    svc.drain()
    with pytest.raises(RuntimeError):
        svc.scheduler.peek_slab()


def test_pair_slab_stages_its_own_counts():
    """A pair slab passes each kind's largest count as ``stage``: the class
    capacity sits above every row's own."""
    plan = tapi.RGG(n=80, radius=0.2, seed=2).plan(2)
    prog = program_of(plan)
    rows = prog.gather_rows(plan)
    kw = prog.slot_kwargs([r[None] for r in rows])
    most = max(int(rows[3].max()), int(rows[4].max()))
    assert kw["stage"] == {engine.GEOM_HYP: 0, engine.GEOM_TORUS: most}
    assert most <= plan.capacity <= prog.capacity
    assert prog.kinds == (engine.GEOM_HYP, engine.GEOM_TORUS)
    # the staged launch == the program's whole launch (plain versions)
    t = [torch.from_numpy(r.view(np.int32) if r.dtype == np.uint32 else r) for r in rows]
    fn = prog.slot_fn()
    a, b = fn(*t, **kw), fn(*t)
    assert torch.equal(a[0][a[1]], b[0][b[1]]) and torch.equal(a[1], b[1])
    assert program_of(tapi.GNM(n=64, m=100, seed=1).plan(1)).slot_kwargs([]) == {}


@pytest.mark.parametrize("kind_name", ["HYP", "TORUS"])
def test_plain_pair_edges_refuses_a_count_past_its_stage(kind_name):
    """``stage`` is a precondition: the plain version raises where an
    active row of the kind holds more points than its bound, as the
    kernel's assertion refuses the launch; a bound at the count runs, and
    equals the launch without one."""
    from repro_torch.kernels.geom import ops as G
    from torch_geom_rows import pair_rows

    k = getattr(engine, f"GEOM_{kind_name}")
    rows = pair_rows(3, 40, 2, seed=3000, kinds=(k,))     # three rows of kind k
    rows[-1][:] = True
    most = int(torch.maximum(rows[3], rows[4]).max())
    kw = dict(capacity=64, dim=2, kinds=(k,))
    with pytest.raises(ValueError):
        G.pair_edges(*rows, stage={k: most - 1}, **kw)
    with pytest.raises(ValueError):
        G.pair_edges(*rows, stage={k: 65}, **kw)
    a, b = G.pair_edges(*rows, stage={k: most}, **kw), G.pair_edges(*rows, **kw)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    rows[-1][:] = False                     # inactive rows stage nothing
    G.pair_edges(*rows, stage={k: 0}, **kw)


@pytest.mark.parametrize("take,workers,B", [(7, (0, 1, 2), 3), (12, (0, 1), 4),
                                            (9, (1, 3), 2), (5, (0,), 8)])
def test_placement_equals_the_reference(take, workers, B):
    """The vectorized placement is the reference's loop: slot k to
    ``worker_of(k)``, columns in slot order, at most B a row; also for a
    survivors' remap over lost slots."""
    import types

    from repro.distrib import fault as jfault
    from repro.serve.scheduler import Scheduler as JScheduler
    from repro_torch.distrib import fault
    from repro_torch.serve.scheduler import Scheduler

    for ids in (np.arange(take), np.arange(take)[::2]):
        a = fault.ChunkAssignment(take, workers)
        ks, d, b = Scheduler._place(ids, a, B)
        want = JScheduler._place(types.SimpleNamespace(B=B), ids.tolist(),
                                 jfault.ChunkAssignment(take, workers).worker_of)
        assert dict(zip(ks.tolist(), zip(d.tolist(), b.tolist()))) == want


@pytest.mark.parametrize("costs", [None, (3.0, 1.0, 4.0, 1.0, 5.0, 9.0, 2.0)])
def test_workers_of_equals_worker_of(costs):
    from repro_torch.distrib import fault

    a = fault.ChunkAssignment(7, (0, 2, 5), costs)
    for dead in ((), (2,)):
        b = fault.reassign_after_failure(a, dead) if dead else a
        assert b.workers_of(np.arange(7)).tolist() == [b.worker_of(k) for k in range(7)]
        assert b.workers_of(np.array([6, 1])).tolist() == [b.worker_of(6), b.worker_of(1)]


def test_slab_bytes_widens_small_slots():
    """With ``slab_bytes`` a group of small slots takes more of them a row
    (never fewer than ``slab_batch``): fewer slabs, the same edges."""
    specs = mixed_specs()
    narrow = Service(2, slab_batch=2, device=CPU)
    wide = Service(2, slab_batch=2, slab_bytes=1 << 16, device=CPU)
    for svc in (narrow, wide):
        tickets = [svc.submit(t) for t, _ in specs]
        svc.drain()
        for t, (_, jspec) in zip(tickets, specs):
            assert_graph_equal(t.result(), jspec, 2)
    widths = {g.program.signature(): g.B for g in wide.scheduler._groups.values()}
    assert min(widths.values()) >= 2 and max(widths.values()) > 2
    for g in wide.scheduler._groups.values():
        assert g.B == max(2, (1 << 16) // g.program.slot_bytes)
    assert wide.stats["slabs"] < narrow.stats["slabs"]


def test_continuous_batching_preserves_chunk_order():
    """A request admitted mid-drain rides partially drained slabs, and
    both requests' chunk streams stay in their own plan order."""
    first, jfirst = both("GNM", n=256, m=900, seed=1, chunks=16)
    second, jsecond = both("GNM", n=256, m=900, seed=2, chunks=16)
    svc = Service(2, slab_batch=4, device=CPU)
    t1 = svc.submit(first, sink="chunks")
    parts, t2 = [], None
    for i, chunk in enumerate(t1.chunks()):
        parts.append(chunk.edges())
        if i == 1:  # admit mid-stream, into partially drained queues
            t2 = svc.submit(second)
    np.testing.assert_array_equal(torch.cat(parts).numpy(), ref_edges(jfirst, 2))
    assert_graph_equal(t2.result(), jsecond, 2)


def test_chunk_sink_equals_iter_edge_chunks_with_overlap():
    """The chunks sink of an overlapped admission == ``iter_edge_chunks``
    chunk by chunk (edges and PE), and the plan cache is bypassed."""
    spec = tapi.SBM(n=96, blocks=3, p_in=0.2, p_out=0.02, seed=4)
    svc = Service(4, slab_batch=2, device=CPU)
    got = list(svc.submit(spec, sink="chunks", overlap=2).chunks())
    want = list(tapi.iter_edge_chunks(spec, 4, device="cpu"))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.pe == b.pe and a.count is None
        assert torch.equal(a.edges(), b.edges())
    assert svc.cache.stats["misses"] == 0


def test_overlapped_graph_admission_equals_reference():
    tspec, jspec = both("RDG", n=40, seed=6)
    svc = Service(4, slab_batch=3, device=CPU)
    t = svc.submit(tspec, overlap=3)
    assert_graph_equal(t.result(), jspec, 4)


def test_stats_sink_matches_graph():
    tspec, jspec = both("SBM", n=96, blocks=3, p_in=0.2, p_out=0.02, seed=4)
    svc = Service(2, device=CPU)
    r = svc.submit(tspec, sink="stats").result()
    g = tapi.generate(tspec, 2, device="cpu")
    assert r["num_edges"] == g.m == len(ref_edges(jspec, 2))
    assert torch.equal(r["degrees"], g.degrees())
    np.testing.assert_array_equal(r["degrees"].numpy(),
                                  np.asarray(japi.generate(jspec, 2).degrees()))


def test_stats_sink_directed_and_pair_families():
    for tspec in (tapi.BA(n=90, d=2, seed=3), tapi.RHG(n=70, avg_deg=4.0, gamma=2.7, seed=8)):
        svc = Service(2, D=4, slab_batch=3, device=CPU)
        r = svc.submit(tspec, sink="stats").result()
        g = tapi.generate(tspec, 2, device="cpu")
        assert r["num_edges"] == g.m and torch.equal(r["degrees"], g.degrees())


def test_empty_request_yields_empty_graph():
    # m = 0 still queues its (count-0) chunk rows; the sink must still
    # give a well-formed empty edge list
    svc = Service(1, device=CPU)
    g = svc.submit(tapi.GNM(n=16, m=0, seed=1)).result()
    assert g.m == 0 and g.edges.shape == (0, 2) and g.edges.dtype == torch.int64
    t = svc.submit(tapi.GNM(n=16, m=0, seed=2), sink="stats")
    assert t.result()["num_edges"] == 0 and t.latency is not None


# ----------------------------------------------------------- fault model

@pytest.mark.parametrize("D,dead", [(4, [0, 1]), (2, [1]), (3, [0, 2])])
def test_fault_reissue_parity_multirow(D, dead):
    """Killing slab rows mid-slab reissues their slots onto survivors
    (``reassign_after_failure``) with unchanged delivery."""
    specs = [both("GNM", n=256, m=800, seed=s, chunks=16) for s in range(3)] + \
            [both("RGG", n=96, radius=0.15, seed=9)]
    svc = Service(4, D=D, slab_batch=4, device=CPU)
    tickets = [svc.submit(t) for t, _ in specs]
    with obs.capture() as tr:
        svc.inject_fault(dead, at_slab=1)
        svc.drain()
    assert svc.scheduler.reissued > 0
    assert svc.stats["reissued"] == svc.scheduler.reissued
    evs = [r for r in tr.spans() if r.name == "fault_reissue"]
    assert len(evs) == 1 and evs[0].attrs["dead"] == sorted(dead)
    for (_, jspec), t in zip(specs, tickets):
        assert_graph_equal(t.result(), jspec, 4)


def test_fault_of_every_row_raises():
    svc = Service(2, D=2, slab_batch=2, device=CPU)
    svc.submit(tapi.GNM(n=256, m=800, seed=1, chunks=16))
    svc.inject_fault([0, 1])
    with pytest.raises(RuntimeError):
        svc.drain()


# ------------------------------------------------- stats & observability

def test_stats_counts_requests_and_queue():
    svc = Service(2, slab_batch=4, device=CPU)
    st = svc.stats
    assert st["submitted"] == 0 and st["completed"] == 0
    assert st["inflight"] == 0 and st["queue_depth"] == 0

    tickets = [svc.submit(tapi.GNM(n=128, m=400, seed=s, chunks=8)) for s in range(3)]
    st = svc.stats
    assert st["submitted"] == 3 and st["completed"] == 0
    assert st["inflight"] == 3 and st["queue_depth"] > 0

    svc.drain()
    st = svc.stats
    assert st["completed"] == 3 and st["inflight"] == 0
    assert st["queue_depth"] == 0
    assert all(t.done for t in tickets)
    assert svc.syncs == 0       # the CPU has nothing to wait for


def test_metrics_exposition_parses_and_counts():
    svc = Service(2, slab_batch=4, device=CPU)
    specs = [t for t, _ in mixed_specs()]
    svc.serve(specs)
    parsed = obs.parse_exposition(svc.metrics())
    n = len(specs)
    assert parsed["repro_serve_requests_submitted_total"] == n
    assert parsed["repro_serve_requests_completed_total"] == n
    assert parsed["repro_serve_inflight_requests"] == 0
    assert parsed["repro_serve_slabs_total"] == svc.stats["slabs"]
    assert parsed["repro_serve_slots_total"] == svc.stats["slots"]
    assert parsed["repro_serve_plan_cache_hits"] == svc.stats["cache"]["hits"]
    assert parsed["repro_serve_ticket_latency_seconds_count"] == n
    assert parsed['repro_serve_group_slabs_total{group="chunk"}'] + \
        parsed['repro_serve_group_slabs_total{group="pair"}'] == svc.stats["slabs"]
    assert svc.latency_percentile(0.5) is not None


def test_ticket_latency_stamped_under_mid_drain_admission():
    """Latency is admission to completion per ticket, also for a request
    admitted into a partially drained queue."""
    svc = Service(2, slab_batch=4, device=CPU)
    t1 = svc.submit(tapi.GNM(n=256, m=900, seed=1, chunks=16), sink="chunks")
    t2 = None
    for i, _ in enumerate(t1.chunks()):
        if i == 0:  # admit mid-stream
            t2 = svc.submit(tapi.GNM(n=128, m=300, seed=2, chunks=8))
    svc.drain()
    assert t2 is not None and t2.done
    assert t1.latency is not None and t1.latency >= 0
    assert t2.latency is not None and t2.latency >= 0
    assert t2.submitted > t1.submitted
    assert svc.stats["completed"] == 2


def test_traced_drain_attributes_phases():
    from repro_torch.distrib import runtime

    runtime.cache_clear()
    svc = Service(2, slab_batch=4, device=CPU)
    with obs.capture() as tr:
        svc.serve([tapi.GNM(n=128, m=400, seed=1), tapi.RGG(n=80, radius=0.2, seed=2)])
    names = {r.name for r in tr.spans()}
    assert {"serve/admit", "slab/exec", "serve/deliver", "compile_cache"} <= names
    totals = tr.phase_totals()
    assert totals["plan_s"] > 0 and totals["exec_s"] > 0 and totals["sink_s"] > 0
    slab_events = [r.attrs["hit"] for r in tr.spans()
                   if r.name == "compile_cache" and r.attrs["kind"] == "slab"]
    assert slab_events.count(False) == 2     # one slot function a packing group


# ---------------------------------------------------- errors

def test_unknown_sink_rejected():
    with pytest.raises(TypeError):
        Service(1, device=CPU).submit(tapi.GNM(n=16, m=10, seed=1), sink="bogus")
    svc = Service(1, device=CPU)
    t = svc.submit(tapi.GNM(n=16, m=10, seed=1))
    with pytest.raises(TypeError):
        next(t.chunks())
    with pytest.raises(ValueError):
        Service(1, D=0, device=CPU)
