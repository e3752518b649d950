"""One process over several local devices (``repro_torch.distrib.world.
LocalMesh``, the reference's default mesh ``runtime.mesh_for(P)``)
against the JAX package, on the CPU.

Meshes of 2 and 4 CPU rows (each row on its own device entry, the rows'
work uploaded, run and left there) at P = 8, for all eight families:

* ``generate``'s edges (and points) equal ``repro.api.generate(spec, 8)``
  bit for bit;
* each row's wave batches equal the reference's rows: on a real 4-device
  CPU mesh (``stream_waves(mesh=jax.make_mesh((4,), ("pe",)))`` in a JAX
  subprocess with ``--xla_force_host_platform_device_count=4``), and row
  ``d`` of ``wave_schedule(plan, 2, batch)`` for two rows;
* ``iter_edge_chunks`` (also with ``overlap=2``) and ``iter_points``
  regroup to the reference's by PE, and yield the integer ``mesh=D``
  stream's chunks in its order;
* ``default_mesh``/``mesh_for`` pick the reference's divisor for each
  device count;
* a one-row mesh runs exactly the one-device path (the same op census);
* a 4-row ``Service`` with row 3 dead at slab 0 gives the reference's
  ``Service`` results on its 4-device mesh with the same fault;
* ``check=True`` refuses a slot function planted with a collective on
  every row, and ``verify_contracts`` scans every row's program.

Every kernel binding launches through ``build.launch``, which makes the
tensors' card current for the launch.
"""
import ast
import dataclasses
import itertools
import os
import pickle
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_world_worker as W
from repro import api as japi
from repro.distrib import runtime as jrt
from repro_torch import api as tapi
from repro_torch.analyze import opscan
from repro_torch.distrib import engine, runtime
from repro_torch.distrib.world import LocalMesh
from repro_torch.serve import Service

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
FAMILIES = sorted(W.SPECS)
GEOMETRIC = ("rdg", "rgg", "rhg")
SIZES = (2, 4)
P = W.P
BATCH = W.BATCH
FLEET = ("gnm", "sbm", "rhg", "ba", "rgg")
OVERLAP = 2


def mesh(D: int) -> LocalMesh:
    return LocalMesh(["cpu"] * D)


def tspec(name: str):
    cls, kw = W.SPECS[name]
    return getattr(tapi, cls)(**kw)


_REF: dict = {}


def reference(name: str) -> dict:
    """The reference's plan, edges, per-PE stream and points of ``name``."""
    if name not in _REF:
        cls, kw = W.SPECS[name]
        spec = getattr(japi, cls)(**kw)
        per: dict = {}
        for c in japi.iter_edge_chunks(spec, P):
            per.setdefault(c.pe, []).append(np.asarray(c.edges()))
        g = japi.generate(spec, P, return_points=name in GEOMETRIC)
        ref = {"plan": spec.plan(P), "edges": np.asarray(g.edges),
               "per_pe": {pe: np.concatenate(es) for pe, es in per.items()}}
        if name in GEOMETRIC:
            ref["points"] = np.asarray(g.points)
            pts: dict = {}
            for c in japi.iter_points(spec, P):
                pts.setdefault(c.pe, []).append(np.asarray(c.points()))
            ref["iter_points"] = {pe: np.concatenate(ps) for pe, ps in pts.items()}
        _REF[name] = ref
    return _REF[name]


REF_MESH = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import numpy as np
import repro  # noqa: F401
import jax
from repro import api
from repro.distrib import engine, runtime
from repro.serve import Service
specs, fleet, P, batch, overlap, out = pickle.loads(bytes.fromhex(sys.argv[1]))
mesh = jax.make_mesh((4,), ("pe",))
res = {"rows": {}, "overlap_rows": {}, "divisor": {}}


def mesh_rows(plan):
    rows = [[] for _ in range(4)]
    for w in runtime.stream_waves(plan, mesh=mesh, batch=batch):
        payload, valid = np.asarray(w.payload), np.asarray(w.valid)
        for d, row in enumerate(w.rows):
            if row is not None:
                pe, slots = row
                rows[d].append((int(pe), np.asarray(slots).tolist(), payload[d][valid[d]]))
    return rows


for name, (cls, kw) in specs.items():
    plan = getattr(api, cls)(**kw).plan(P)
    res["rows"][name] = mesh_rows(plan)
    res["overlap_rows"][name] = mesh_rows(runtime.PlanEmitter.from_plan(plan, overlap))
real = jax.devices
for k in range(1, 5):
    jax.devices = lambda *a, k=k: real()[:k]
    res["divisor"][k] = {p: engine.default_mesh(p).devices.size for p in range(1, 17)}
jax.devices = real
svc = Service(P, mesh=mesh, slab_batch=2)
tickets = [svc.submit(getattr(api, specs[n][0])(**specs[n][1])) for n in fleet]
svc.inject_fault([3], at_slab=0)
svc.drain()
res["service"] = {"edges": [np.asarray(t.result().edges) for t in tickets],
                  "reissued": svc.scheduler.reissued, "slabs": svc.scheduler.slabs}
with open(out, "wb") as f:
    pickle.dump(res, f)
"""

_MESH: dict = {}


def reference_mesh() -> dict:
    """The reference on a real 4-device CPU mesh (one JAX subprocess):
    each family's stream per mesh row (also of its plan emitted in
    ``OVERLAP`` segments), ``default_mesh``'s row count for
    1..4 devices and P in 1..16, and the faulted fleet's results."""
    if not _MESH:
        with tempfile.TemporaryDirectory() as d:
            out = os.path.join(d, "mesh.pkl")
            arg = pickle.dumps((W.SPECS, FLEET, P, BATCH, OVERLAP, out)).hex()
            env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
            r = subprocess.run([sys.executable, "-c", REF_MESH, arg], env=env,
                               capture_output=True, text=True, timeout=600)
            assert r.returncode == 0, r.stderr[-3000:]
            with open(out, "rb") as f:
                _MESH.update(pickle.load(f))
    return _MESH


def _per_pe(chunks) -> dict:
    out: dict = {}
    for c in chunks:
        out.setdefault(c.pe, []).append(c.edges())
    return {pe: torch.cat(es).numpy() for pe, es in out.items()}


def _same_per_pe(got: dict, want: dict, what: str) -> None:
    for pe in range(P):
        g = got.get(pe, np.zeros((0, 2), np.int64))
        w = want.get(pe, np.zeros((0, 2), np.int64))
        np.testing.assert_array_equal(g, w, err_msg=f"{what}: PE {pe}")


# --------------------------------------------------------------------------
# generate, waves, streams, points
# --------------------------------------------------------------------------

@pytest.mark.parametrize("D", SIZES)
@pytest.mark.parametrize("name", FAMILIES)
def test_generate_on_a_local_mesh_equals_the_reference(name, D):
    ref = reference(name)
    g = tapi.generate(tspec(name), P, mesh=mesh(D), return_points=name in GEOMETRIC)
    assert g.edges.device == torch.device("cpu")
    np.testing.assert_array_equal(g.edges.numpy(), ref["edges"])
    if name in GEOMETRIC:
        np.testing.assert_array_equal(g.points.numpy(), ref["points"])


def _row_waves(name: str, D: int) -> list:
    """Per row: its ``(pe, slots, edges)`` batches of the local mesh's
    waves, and checks that each wave holds a tensor a row with a batch."""
    rows = [[] for _ in range(D)]
    plan = tspec(name).plan(P, device="cpu")
    for w in runtime.stream_waves(plan, batch=BATCH, mesh=mesh(D)):
        assert isinstance(w.payload, tuple) and len(w.payload) == D
        for d, row in enumerate(w.rows):
            assert (row is None) == (w.payload[d] is None)
            if row is not None:
                pe, slots = row
                assert D * pe // P == d, "a batch runs on the row that holds its PE"
                rows[d].append((pe, np.asarray(slots).tolist(),
                                w.payload[d][w.valid[d]].numpy()))
    return rows


@pytest.mark.parametrize("D", SIZES)
@pytest.mark.parametrize("name", FAMILIES)
def test_row_waves_equal_the_reference_mesh_rows(name, D):
    """Four rows: each row's batches and edges equal the reference's row
    on its real 4-device mesh.  Two rows: row ``d`` of the reference's
    ``wave_schedule(plan, 2, batch)``, the edges regrouped by PE."""
    got = _row_waves(name, D)
    if D == 4:
        for d, want in enumerate(reference_mesh()["rows"][name]):
            assert [(pe, s) for pe, s, _ in got[d]] == [(pe, s) for pe, s, _ in want]
            for (_, _, g), (_, _, w) in zip(got[d], want):
                np.testing.assert_array_equal(g, w)
        return
    ref = reference(name)
    ws = jrt.wave_schedule(ref["plan"], D, BATCH)
    per: dict = {}
    for d in range(D):
        want = [ws.rows[w][d] for w in range(ws.num_waves) if ws.rows[w][d] is not None]
        assert [(pe, s) for pe, s, _ in got[d]] == [(pe, np.asarray(s).tolist())
                                                    for pe, s in want]
        for pe, _, e in got[d]:
            per.setdefault(pe, []).append(e)
    _same_per_pe({pe: np.concatenate(es) for pe, es in per.items()}, ref["per_pe"],
                 f"{name} waves")


@pytest.mark.parametrize("D", SIZES)
@pytest.mark.parametrize("name", FAMILIES)
def test_overlapped_row_waves_equal_the_reference_mesh_rows(name, D):
    """With plan/execute overlap every segment is spread over all the rows,
    as in the reference: each row's batches equal the reference's row (on
    its real 4-device mesh for four rows; row ``d`` of each segment's
    ``wave_schedule(segment, 2, batch)`` for two), and ``stream_row``
    names the row of every batch's PE, which is not always row
    ``D pe / P``."""
    from repro.distrib.engine import slice_plan

    assert any(runtime.stream_row(P, D, pe, OVERLAP) != D * pe // P for pe in range(P))
    got = [[] for _ in range(D)]
    emitter = runtime.PlanEmitter.from_plan(tspec(name).plan(P, device="cpu"), OVERLAP)
    for w in runtime.stream_waves(emitter, batch=BATCH, mesh=mesh(D)):
        for d, row in enumerate(w.rows):
            if row is not None:
                pe, slots = row
                assert runtime.stream_row(P, D, pe, OVERLAP) == d, (pe, d)
                got[d].append((pe, np.asarray(slots).tolist(),
                               w.payload[d][w.valid[d]].numpy()))
    if D == 4:
        for d, want in enumerate(reference_mesh()["overlap_rows"][name]):
            assert [(pe, s) for pe, s, _ in got[d]] == [(pe, s) for pe, s, _ in want]
            for (_, _, g), (_, _, w) in zip(got[d], want):
                np.testing.assert_array_equal(g, w)
        return
    plan = reference(name)["plan"]
    for d in range(D):
        want = []
        for lo, hi in jrt.PlanEmitter.from_plan(plan, OVERLAP).segment_bounds(D):
            ws = jrt.wave_schedule(slice_plan(plan, lo, hi), D, BATCH)
            rows = (ws.rows[w][d] for w in range(ws.num_waves))
            want += [(pe + lo, np.asarray(s).tolist()) for pe, s in filter(None, rows)]
        assert [(pe, s) for pe, s, _ in got[d]] == want


@pytest.mark.parametrize("overlap", [0, 2])
@pytest.mark.parametrize("D", SIZES)
@pytest.mark.parametrize("name", FAMILIES)
def test_streams_regroup_to_the_reference_and_follow_the_row_count(name, D, overlap):
    spec = tspec(name)
    got = list(tapi.iter_edge_chunks(spec, P, mesh=mesh(D), batch=BATCH, overlap=overlap))
    _same_per_pe(_per_pe(got), reference(name)["per_pe"], f"{name} overlap={overlap}")
    same = list(tapi.iter_edge_chunks(spec, P, mesh=D, device="cpu", batch=BATCH,
                                      overlap=overlap))
    assert [c.pe for c in got] == [c.pe for c in same]
    for a, b in zip(got, same):
        assert torch.equal(a.edges(), b.edges()) and a.count == b.count


@pytest.mark.parametrize("D", SIZES)
@pytest.mark.parametrize("name", GEOMETRIC)
def test_points_stream_regroups_to_the_reference(name, D):
    got: dict = {}
    for c in tapi.iter_points(tspec(name), P, mesh=mesh(D), batch=BATCH):
        got.setdefault(c.pe, []).append(c.points())
    want = reference(name)["iter_points"]
    assert sorted(got) == sorted(want)
    for pe, ps in got.items():
        np.testing.assert_array_equal(torch.cat(ps).numpy(), want[pe])


# --------------------------------------------------------------------------
# the default mesh and the one-row path
# --------------------------------------------------------------------------

@pytest.mark.parametrize("cards", [1, 2, 3, 4])
def test_default_mesh_picks_the_reference_divisor(cards, monkeypatch):
    want = reference_mesh()["divisor"][cards]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    runtime.mesh_for.cache_clear()
    try:
        for p, n in want.items():
            m = engine.default_mesh(p)
            assert m.devices == tuple(torch.device("cuda", i) for i in range(n)), (p, m)
            assert runtime.mesh_for(p) == m and runtime.mesh_size(runtime.mesh_for(p)) == n
            # an indexed card or the CPU is one row there
            assert engine.default_mesh(p, "cuda:0").devices == (torch.device("cuda", 0),)
            assert engine.default_mesh(p, "cpu").devices == (torch.device("cpu"),)
            assert runtime.placement(p, None, None)[0] == (1 if n == 1 else m)
    finally:
        runtime.mesh_for.cache_clear()


def test_default_mesh_without_a_card_raises():
    runtime.mesh_for.cache_clear()
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.default_mesh(8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.generate(tspec("gnm"), P)
    assert runtime.placement(P, None, "cpu") == (1, torch.device("cpu"))


@pytest.mark.parametrize("name", ["gnm", "rgg", "rdg", "rmat"])
def test_a_one_row_mesh_is_the_one_device_path(name):
    """``mesh=None`` on the CPU, a one-row ``LocalMesh`` and the row count
    1 make the same ops (the same launches among them) and the same
    edges: the one-row mesh takes the one-device path."""
    spec = tspec(name)
    tapi.generate(spec, P, device="cpu")     # RDG's planning structure, cached a seed
    runs = []
    for m in (None, LocalMesh(["cpu"]), 1):
        with opscan.trace() as census:     # unchecked: a scan is a trace of its own
            edges = tapi.generate(spec, P, mesh=m, device="cpu", check=False).edges
        runs.append((dict(census), edges))
        with opscan.trace() as census:
            chunks = list(tapi.iter_edge_chunks(spec, P, mesh=m, device="cpu", batch=BATCH))
        runs.append((dict(census), [c.edges() for c in chunks]))
    for i in range(2, len(runs)):
        census, out = runs[i]
        assert census == runs[i % 2][0]
        want = runs[i % 2][1]
        if isinstance(out, list):
            assert len(out) == len(want) and all(torch.equal(a, b) for a, b in zip(out, want))
        else:
            assert torch.equal(out, want)
    assert any(k.startswith(opscan.KERNEL_PREFIX) for k in runs[0][0])


def test_local_mesh_refuses_what_it_cannot_run():
    with pytest.raises(ValueError, match="P % devices"):
        tapi.generate(tspec("gnm"), P, mesh=mesh(3))
    with pytest.raises(ValueError, match="P % devices"):
        next(tapi.iter_edge_chunks(tspec("gnm"), P, mesh=mesh(3)))
    with pytest.raises(ValueError, match="at least one device"):
        LocalMesh([])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            LocalMesh(["cpu", "cuda:0"])
    m = mesh(2)
    assert m == mesh(2) and hash(m) == hash(mesh(2)) and m != mesh(4) and m.size == 2
    with pytest.raises(AttributeError):
        m.devices = ()
    assert m.stream(0) is None and m.fence(1) is None and m.pes(8, 1) == (4, 8)


def test_row_device_must_exist(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(RuntimeError, match="mesh row 1: no device cuda:3"):
        LocalMesh(["cuda:1", "cuda:3"])
    with pytest.raises(ValueError, match="all CUDA or all CPU"):
        LocalMesh(["cpu", "cuda:1"])


def test_run_on_a_local_mesh_concatenates_the_rows():
    plan = tspec("sbm").plan(P, device="cpu")
    want = runtime.run(plan, "cpu", check=False)
    for D in SIZES:
        got = runtime.run(plan, check=False, mesh=mesh(D))
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        parts = runtime.run_rows(plan, mesh(D), check=False, only=(1,))
        assert parts[0] is None and parts[1][0].shape[0] == P // D
        assert torch.equal(parts[1][0], want[0][P // D: 2 * P // D])


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def test_faulted_service_on_four_rows_equals_the_reference_service():
    """Row 3 dies during slab 0: its slots recompute on rows 0-2 (which,
    on distinct cards, are the surviving cards); every ticket equals the
    reference's ``Service`` on its 4-device mesh with the same fault, and
    so does the number of reissued slots and slabs."""
    want = reference_mesh()["service"]
    svc = Service(P, mesh=mesh(4), slab_batch=2, check=True)
    tickets = [svc.submit(tspec(n)) for n in FLEET]
    svc.inject_fault([3], at_slab=0)
    svc.drain()
    assert svc.scheduler.reissued == want["reissued"] > 0
    assert svc.scheduler.slabs == want["slabs"]
    for t, e, n in zip(tickets, want["edges"], FLEET):
        np.testing.assert_array_equal(t.result().edges.numpy(), e, err_msg=n)


@pytest.mark.parametrize("D", SIZES)
def test_service_sinks_on_a_local_mesh_equal_generate(D):
    """Graph, chunks and stats sinks, and an overlapped admission, on a
    local mesh: each equals ``generate``/``iter_edge_chunks`` at P."""
    svc = Service(P, mesh=mesh(D), slab_batch=3)
    assert svc.mesh == mesh(D) and svc.scheduler.D == D
    specs = [tspec(n) for n in ("gnm", "rhg", "rdg")]
    graphs = [svc.submit(s) for s in specs]
    chunks = svc.submit(tspec("sbm"), sink="chunks", overlap=2)
    stats = svc.submit(tspec("rgg"), sink="stats")
    svc.drain()
    for t, s in zip(graphs, specs):
        assert torch.equal(t.result().edges, tapi.generate(s, P, device="cpu").edges)
    want = list(tapi.iter_edge_chunks(tspec("sbm"), P, device="cpu"))
    got = chunks.result()
    assert [c.pe for c in got] == [c.pe for c in want]
    assert all(torch.equal(a.edges(), b.edges()) for a, b in zip(got, want))
    g = tapi.generate(tspec("rgg"), P, device="cpu")
    assert stats.result()["num_edges"] == g.m
    assert torch.equal(stats.result()["degrees"], g.degrees())
    with pytest.raises(ValueError, match="not both"):
        Service(P, mesh=mesh(D), D=2)


# --------------------------------------------------------------------------
# contracts
# --------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def gloo_group():
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            rank=0, world_size=1)
    yield dist
    dist.destroy_process_group()


@pytest.mark.parametrize("row", [0, 1, 2, 3])
def test_a_planted_collective_is_refused_on_every_row(gloo_group, row):
    """The slot function all-reduces on its ``row``-th call only: the run
    and the wave stream on four rows with ``check=True`` scan each row's
    program, and refuse the plant on whichever row it sits."""
    plan = tapi.GNM(n=200, m=800, seed=3).plan(P, device="cpu")
    for mode in ("run", "wave"):
        calls = itertools.count()

        @dataclasses.dataclass(frozen=True)
        class Planted(engine.ChunkPlan):
            def signature(self):
                return ("all-reduced", mode, row) + super().signature()

            def slot_fn(self):
                inner = super().slot_fn()

                def rows(*tables):
                    if next(calls) == row:
                        gloo_group.all_reduce(torch.ones(1))
                    return inner(*tables)
                return rows

        planted = Planted(**{f.name: getattr(plan, f.name) for f in dataclasses.fields(plan)})
        with pytest.raises(AssertionError, match="collectives"):
            if mode == "run":
                runtime.run(planted, check=True, mesh=mesh(4))
            else:
                list(runtime.stream_waves(planted, batch=P, mesh=mesh(4), check=True))


@pytest.mark.parametrize("name", ["gnm", "rgg"])
def test_verify_contracts_scans_every_row(name):
    reports = tapi.verify_contracts(tspec(name), P, mesh=mesh(4))
    kinds = 2 if name == "rgg" else 1
    assert len(reports) == kinds * 2 * 4
    assert sorted({r.name.rsplit("/", 1)[1] for r in reports}) == [f"row{d}" for d in range(4)]
    assert all(r.ok and not r.scan.collectives for r in reports)
    assert all(sum(r.launches.values()) > 0 for r in reports if r.mode == "run")


# --------------------------------------------------------------------------
# the kernel bindings' launch path; the launcher without torchrun
# --------------------------------------------------------------------------

def _library_calls(tree) -> list:
    """Calls of a loaded library's entry point in a module: ``_lib().f(...)``,
    ``build.library(...).f(...)`` or ``_entry()(...)``."""
    found = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Call):
            inner = f.value.func
            name = inner.attr if isinstance(inner, ast.Attribute) else getattr(inner, "id", "")
            if name in ("_lib", "library"):
                found.append(ast.unparse(node)[:60])
        if isinstance(f, ast.Call) and getattr(f.func, "id", "") == "_entry":
            found.append(ast.unparse(node)[:60])
    return found


def test_every_kernel_binding_launches_through_the_guarded_path():
    """No binding in ``kernels/*/ops.py`` calls a library entry point or
    reads the raw stream itself: each hands the entry point to
    ``build.launch`` (or ``build.query``), which makes the tensors' card
    current for the call."""
    kernels = REPO / "src" / "repro_torch" / "kernels"
    launched = set()
    for path in sorted(kernels.glob("*/ops.py")):
        tree = ast.parse(path.read_text())
        assert not _library_calls(tree), (path.name, _library_calls(tree))
        assert "stream_arg" not in path.read_text(), path
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "launch"
                    and isinstance(node.args[0], ast.Constant)):
                launched.add(node.args[0].value)
    from repro_torch.kernels import build
    assert set(build.LAUNCHES) <= launched, set(build.LAUNCHES) - launched


def test_launch_makes_the_tensors_card_current(monkeypatch):
    """``build.launch`` enters the device's context around the entry point
    and passes that device's current stream; on the current card it enters
    none."""
    from repro_torch.kernels import build

    seen = []

    class Guard:
        def __init__(self, index):
            seen.append(("enter", index))

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            seen.append(("exit",))

    monkeypatch.setattr(torch.cuda, "device", Guard)
    monkeypatch.setattr(build, "stream_arg", lambda dev: 1000 + dev.index)
    monkeypatch.setattr(build, "current_index", lambda: 0)
    build.launch("hist", torch.device("cuda", 3), lambda *a: seen.append(("call", a)) or 0,
                 7, 8)
    assert seen == [("enter", 3), ("call", (7, 8, 1003)), ("exit",)]
    seen.clear()
    build.launch("hist", torch.device("cuda", 0), lambda *a: seen.append(("call", a)) or 0, 5)
    assert seen == [("call", (5, 1000))]
    with pytest.raises(RuntimeError, match="hist: CUDA launch failed with error 9"):
        build.launch("hist", torch.device("cuda", 1), lambda *a: 9)
    assert build.query(torch.device("cuda", 2), lambda *a: sum(a), 1, 2) == 3


def test_launcher_without_torchrun_is_one_process(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env.update(PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    cls, kw = W.SPECS["rgg"]
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.generate", "--device", "cpu",
                        cls, *[f"{k}={v}" for k, v in kw.items()], "--pes", str(P),
                        "--out", str(tmp_path)], capture_output=True, text=True, timeout=600,
                       env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.startswith(f"one process on cpu: PEs [0, {P}) of {P}"), r.stdout
    np.testing.assert_array_equal(np.load(tmp_path / "edges.0.npy"), reference("rgg")["edges"])
