"""The port's ``obs`` (tracer, metrics) and the spans on its paths,
against ``repro.obs`` and the JAX package's own spans.

The tracer and metrics cases are the reference's (``tests/test_obs.py``)
run against ``repro_torch.obs``; then every family's ``plan/<family>``
span, the reseed, deal, run, wave, overlap and extract spans, the
``compile_cache`` events of the slot-function cache, the bridge into
``torch.profiler``, and the (span, phase) sequence of ``generate`` in both
packages.  The port runs on the CPU.
"""
import json
import threading

import pytest
import torch

from repro import api as japi
from repro import obs as jobs
from repro_torch import api as tapi
from repro_torch import obs
from repro_torch.distrib import runtime

torch.set_num_threads(1)

CPU = torch.device("cpu")


# ---------------------------------------------------------------- tracer

def test_disabled_trace_is_shared_null_singleton():
    obs.disable()
    obs.tracer().clear()
    s1 = obs.trace("anything", phase="plan")
    s2 = obs.trace("else")
    assert s1 is obs.NULL_SPAN and s2 is obs.NULL_SPAN
    with s1:
        s1.set(ignored=True)
    obs.event("also-ignored", hit=True)
    assert obs.tracer().spans() == []


def test_spans_nest_with_parent_ids():
    with obs.capture() as tr:
        with obs.trace("outer", phase="plan"):
            with obs.trace("inner", phase="exec"):
                pass
        with obs.trace("sibling"):
            pass
    recs = {r.name: r for r in tr.spans()}
    assert recs["inner"].parent_id == recs["outer"].span_id
    assert recs["outer"].parent_id == 0
    assert recs["sibling"].parent_id == 0
    assert recs["inner"].dur_ns <= recs["outer"].dur_ns


def test_phase_totals_shadow_same_phase_descendants():
    with obs.capture() as tr:
        with obs.trace("plan/outer", phase="plan"):
            # a reseed emitter re-entering its cold emitter: the nested
            # plan span must not count twice
            with obs.trace("plan/inner", phase="plan"):
                pass
            with obs.trace("exec/inner", phase="exec"):
                pass
    totals = tr.phase_totals()
    recs = {r.name: r for r in tr.spans()}
    assert totals["plan_s"] == pytest.approx(recs["plan/outer"].seconds)
    assert totals["exec_s"] == pytest.approx(recs["exec/inner"].seconds)
    assert totals["sink_s"] == 0.0
    assert tr.summary()["spans"]["plan/inner"]["count"] == 1


def test_span_set_attaches_attrs_and_events_nest():
    with obs.capture() as tr:
        with obs.trace("work", phase="exec") as sp:
            sp.set(rows=7)
            obs.event("marker", hit=True)
    recs = {r.name: r for r in tr.spans()}
    assert recs["work"].attrs["rows"] == 7
    assert recs["marker"].instant
    assert recs["marker"].parent_id == recs["work"].span_id
    assert recs["marker"].seconds == 0.0


def test_tracer_thread_safety_separate_stacks():
    with obs.capture() as tr:
        def worker(i):
            with obs.trace(f"t{i}", phase="exec"):
                pass
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
        with obs.trace("main-span", phase="plan"):
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
                assert not t.is_alive()
    recs = {r.name: r for r in tr.spans()}
    # spans on other threads must not parent under the main thread's span
    for i in range(4):
        assert recs[f"t{i}"].parent_id == 0
    assert len({r.span_id for r in tr.spans()}) == len(tr.spans())


def test_export_chrome_schema(tmp_path):
    path = tmp_path / "trace.json"
    with obs.capture() as tr:
        with obs.trace("span", phase="exec", n=3, dev=CPU):
            obs.event("evt", hit=False)
        tr.export_chrome(str(path))
    data = json.loads(path.read_text())
    evs = data["traceEvents"]
    assert {e["ph"] for e in evs} == {"X", "i"}
    x = next(e for e in evs if e["ph"] == "X")
    i = next(e for e in evs if e["ph"] == "i")
    assert x["name"] == "span" and x["cat"] == "exec" and x["dur"] >= 0
    assert set(x) >= {"name", "cat", "ph", "ts", "dur", "pid", "tid", "args"}
    assert x["args"]["n"] == 3 and x["args"]["dev"] == "cpu"
    assert i["s"] == "t"
    assert "phases" in data["otherData"]


def test_capture_restores_previous_tracer():
    obs.disable()
    before = obs.tracer()
    with obs.capture() as tr:
        assert obs.tracer() is tr and obs.is_enabled()
    assert obs.tracer() is before and not obs.is_enabled()


def test_enable_disable_and_module_totals():
    obs.disable()
    try:
        tr = obs.enable(clear=True)
        with obs.trace("x", phase="sink"):
            pass
        assert obs.phase_totals()["sink_s"] > 0
        assert obs.export_chrome()["traceEvents"][0]["name"] == "x"
    finally:
        obs.disable()
        tr.clear()
    assert not obs.is_enabled()


# ---------------------------------------------------- the profiler bridge

def test_profiler_annotations_show_spans_in_a_torch_profile(tmp_path):
    """With ``profiler_annotations`` each span is a ``record_function``
    range: it shows under its own name in :func:`obs.profiler_trace`,
    whose Chrome trace lands in the log directory."""
    logdir = tmp_path / "prof"
    with obs.profiler_trace(str(logdir)) as prof:
        with obs.capture(profiler_annotations=True) as tr:
            with obs.trace("serve/bridge-test", phase="exec"):
                torch.ones(8).sum()
    names = {e.key for e in prof.key_averages()}
    assert "serve/bridge-test" in names
    assert [r.name for r in tr.spans()] == ["serve/bridge-test"]
    trace = json.loads((logdir / "trace.json").read_text())
    assert any(e.get("name") == "serve/bridge-test" for e in trace["traceEvents"])


def test_annotations_off_by_default():
    with obs.capture() as tr:
        assert not tr.profiler_annotations
    assert obs.enable().profiler_annotations is False
    obs.disable()


# ---------------------------------------------------------------- metrics

def test_counter_monotonic():
    c = obs.Counter("c")
    c.inc()
    c.inc(2)
    assert c.value == 3
    with pytest.raises(ValueError):
        c.inc(-1)


def test_gauge_callback_reads_live():
    box = [1.0]
    g = obs.Gauge("g", fn=lambda: box[0])
    assert g.value == 1.0
    box[0] = 5.0
    assert g.value == 5.0
    h = obs.Gauge("h")
    h.set(2)
    h.inc(3)
    h.dec()
    assert h.value == 4


def test_histogram_buckets_and_percentile():
    h = obs.Histogram("h", buckets=(1.0, 10.0))
    for v in (0.5, 2.0, 20.0):
        h.observe(v)
    samples = dict(((n, labels), v) for n, labels, v in h.samples())
    assert samples[("h_bucket", (("le", "1"),))] == 1
    assert samples[("h_bucket", (("le", "10"),))] == 2
    assert samples[("h_bucket", (("le", "+Inf"),))] == 3
    assert samples[("h_count", ())] == 3
    assert h.percentile(0.5) == 2.0
    assert h.percentile(1.0) == 20.0
    assert obs.Histogram("e").percentile(0.5) is None


def test_registry_render_parse_round_trip():
    r = obs.Registry("x_")
    r.counter("reqs_total", "requests").inc(4)
    r.gauge("depth").set(2)
    r.histogram("lat_seconds", buckets=(0.1, 1.0)).observe(0.05)
    text = r.render()
    parsed = obs.parse_exposition(text)
    assert parsed["x_reqs_total"] == 4
    assert parsed["x_depth"] == 2
    assert parsed['x_lat_seconds_bucket{le="0.1"}'] == 1
    assert parsed["x_lat_seconds_count"] == 1
    # the port renders what the reference renders
    rj = jobs.Registry("x_")
    rj.counter("reqs_total", "requests").inc(4)
    rj.gauge("depth").set(2)
    rj.histogram("lat_seconds", buckets=(0.1, 1.0)).observe(0.05)
    assert text == rj.render()
    assert r.to_dict() == rj.to_dict()


def test_parse_exposition_rejects_untyped_samples():
    with pytest.raises(ValueError):
        obs.parse_exposition("mystery_metric 1\n")
    with pytest.raises(ValueError):
        obs.parse_exposition("# TYPE a counter\na\n")


def test_registry_get_or_create_idempotent():
    r = obs.Registry()
    assert r.counter("a") is r.counter("a")
    assert r.counter("a", labels={"k": "v"}) is not r.counter("a")


# ------------------------------------------------- spans on the port's paths

def test_generate_traced_has_all_three_phases():
    spec = tapi.GNM(n=128, m=300, seed=1)
    with obs.capture() as tr:
        tapi.generate(spec, 2, device=CPU)
    names = {r.name for r in tr.spans()}
    assert {"plan/gnm", "plan/deal", "run/exec", "extract"} <= names
    totals = tr.phase_totals()
    assert totals["plan_s"] > 0 and totals["exec_s"] > 0 and totals["sink_s"] > 0


FAMILY_SPECS = [
    (tapi.GNM(n=64, m=100, seed=1), "plan/gnm"),
    (tapi.GNM(n=64, m=100, directed=True, seed=1), "plan/gnm"),
    (tapi.GNP(n=64, p=0.05, seed=1), "plan/gnp"),
    (tapi.GNP(n=64, p=0.05, directed=True, seed=1), "plan/gnp"),
    (tapi.BA(n=32, d=2, seed=1), "plan/ba"),
    (tapi.RMAT(log_n=5, m=64, seed=1), "plan/rmat"),
    (tapi.SBM(n=48, blocks=2, p_in=0.2, p_out=0.05, seed=1), "plan/sbm"),
    (tapi.RGG(n=80, radius=0.2, seed=1), "plan/rgg"),
    (tapi.RHG(n=70, avg_deg=4.0, gamma=2.7, seed=1), "plan/rhg"),
    (tapi.RDG(n=40, seed=1), "plan/rdg"),
]


@pytest.mark.parametrize("spec,span", FAMILY_SPECS,
                         ids=[f"{type(s).__name__}-{i}" for i, (s, _) in enumerate(FAMILY_SPECS)])
def test_every_family_opens_its_plan_span(spec, span):
    with obs.capture() as tr:
        spec.plan(2, device=CPU)
    recs = [r for r in tr.spans() if r.name == span]
    assert recs and all(r.phase == "plan" and r.attrs["reseed"] is False for r in recs)
    assert recs[0].attrs["family"] == span.split("/")[1]


@pytest.mark.parametrize("spec", [tapi.RGG(n=80, radius=0.2, seed=1),
                                  tapi.RHG(n=70, avg_deg=4.0, gamma=2.7, seed=1),
                                  tapi.RDG(n=40, seed=1)], ids=["rgg", "rhg", "rdg"])
def test_point_plans_open_their_plan_span(spec):
    fam = type(spec).__name__.lower()
    with obs.capture() as tr:
        spec.point_plan(2)
    assert f"plan/{fam}" in {r.name for r in tr.spans()}


@pytest.mark.parametrize("spec", [tapi.GNM(n=128, m=300, seed=1),
                                  tapi.RGG(n=80, radius=0.2, seed=1),
                                  tapi.RHG(n=70, avg_deg=4.0, gamma=2.7, seed=1)],
                         ids=["chunk", "rgg", "rhg"])
def test_reseed_span_shadows_inner_plan_span(spec):
    plan = spec.plan(2, device=CPU)
    with obs.capture() as tr:
        plan.reseed(2)
    recs = [r for r in tr.spans() if r.name == "plan/reseed"]
    outer = next(r for r in recs if r.parent_id == 0)
    assert outer.attrs["reseed"] is True and outer.phase == "plan"
    assert tr.phase_totals()["plan_s"] == pytest.approx(outer.seconds)


def test_disabled_tracing_records_nothing_through_generate():
    obs.disable()
    obs.tracer().clear()
    tapi.generate(tapi.GNM(n=64, m=100, seed=3), 2, device=CPU)
    list(tapi.iter_edge_chunks(tapi.SBM(n=48, blocks=2, p_in=0.2, p_out=0.05, seed=1), 4,
                               device=CPU, overlap=2))
    assert obs.tracer().spans() == []


def test_compile_cache_events_hit_and_miss():
    spec = tapi.GNM(n=64, m=128, seed=5)
    runtime.cache_clear()
    try:
        with obs.capture() as tr:
            tapi.generate(spec, 2, device=CPU)
            tapi.generate(spec, 2, device=CPU)
            list(tapi.iter_edge_chunks(spec, 2, device=CPU))
            list(tapi.iter_edge_chunks(spec, 2, device=CPU))
        evs = [(e.attrs["kind"], e.attrs["hit"]) for e in tr.spans()
               if e.name == "compile_cache"]
        assert evs == [("run", False), ("run", True), ("wave", False), ("wave", True)]
    finally:
        runtime.cache_clear()


def test_wave_spans_and_device_attribution():
    spec = tapi.GNM(n=256, m=900, seed=2, chunks=8)
    with obs.capture() as tr:
        chunks = list(tapi.iter_edge_chunks(spec, 4, device=CPU, prefetch=2))
    names = [r.name for r in tr.spans()]
    waves = names.count("wave/dispatch")
    assert waves == len(chunks)
    assert names.count("wave/device") == waves and names.count("wave/sink") == waves
    assert names.count("wave/schedule") == 1
    assert {r.phase for r in tr.spans() if r.name.startswith("wave/")} == {"exec", "sink"}


def test_overlap_spans_one_per_segment_on_the_planner_thread():
    spec = tapi.SBM(n=96, blocks=3, p_in=0.2, p_out=0.02, seed=4)
    with obs.capture() as tr:
        chunks = list(tapi.iter_edge_chunks(spec, 8, device=CPU, overlap=4))
    segs = [r for r in tr.spans() if r.name == "plan/overlap"]
    assert sorted(r.attrs["segment"] for r in segs) == [0, 1, 2, 3]
    assert all(r.attrs["segments"] == 4 and r.phase == "plan" for r in segs)
    main = threading.get_ident()
    assert {r.tid for r in segs} != {main} and len({r.tid for r in segs}) == 1
    # the native SBM segment's own span nests under its overlap span
    inner = [r for r in tr.spans() if r.name == "plan/sbm"]
    assert {r.parent_id for r in inner} == {r.span_id for r in segs}
    waits = [r for r in tr.spans() if r.name == "plan/overlap/wait"]
    assert len(waits) == 5 and all(r.tid == main and r.phase is None for r in waits)
    assert len(chunks) > 0


def test_generate_span_sequence_equals_the_reference():
    """The same spec traced through both packages' ``generate`` gives the
    same sequence of (span name, phase) for the plan and sink spans."""
    def seq(tr):
        return [(r.name, r.phase) for r in tr.spans()
                if not r.instant and r.phase in ("plan", "sink")]

    for kw, P in ((dict(n=128, m=300, seed=1), 2), (dict(n=96, m=200, directed=True, seed=2), 3)):
        japi.generate(japi.GNM(**kw), P)        # the reference's compile, outside the trace
        with jobs.capture() as jt:
            japi.generate(japi.GNM(**kw), P)
        with obs.capture() as tt:
            tapi.generate(tapi.GNM(**kw), P, device=CPU)
        assert seq(tt) == seq(jt) and seq(tt)
    for name, kw in (("SBM", dict(n=96, blocks=3, p_in=0.2, p_out=0.02, seed=4)),
                     ("RGG", dict(n=80, radius=0.2, seed=2)),
                     ("BA", dict(n=90, d=2, seed=3))):
        japi.generate(getattr(japi, name)(**kw), 2)
        with jobs.capture() as jt:
            japi.generate(getattr(japi, name)(**kw), 2)
        with obs.capture() as tt:
            tapi.generate(getattr(tapi, name)(**kw), 2, device=CPU)
        assert seq(tt) == seq(jt), name
