"""Generation across ranks (``repro_torch.distrib.world``) against the JAX
package, on the CPU.

Each world (2 and 4 ranks) is spawned once, from
``tests/torch_world_worker.py``, every family's cases in it; each rank
plans, uploads and runs its own PEs with no process group.  For all
eight families at P = 8:

* the ranks' edges, concatenated in rank order, equal
  ``repro.api.generate(spec, 8).edges`` bit for bit;
* each rank's plan rows equal the reference plan's rows ``[lo, hi)``
  field by field (``capacity`` aside where a family plans a range
  natively: a common prefix and a dead tail);
* each rank's ``(pe, slots)`` wave batches on the whole plan equal row
  ``d`` of ``repro.distrib.runtime.wave_schedule(plan, D, batch)``, and
  on a real 4-device CPU mesh (a JAX subprocess) the reference streams
  the same rows PE by PE;
* ``iter_edge_chunks``, also with ``overlap=2``, and the rank's points
  regroup to the reference's by PE;
* a slot function planted with ``all_reduce`` is refused by
  ``check=True`` on both ranks of a ``gloo`` world.

The paper's per-PE generators of ``repro_torch.core`` equal the
reference's functions bit for bit for several (P, pe), and
``World.from_env`` reads torchrun's variables.
"""
import dataclasses
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import textwrap
import time

import numpy as np
import pytest
import torch

import torch_world_worker as W
from repro import api as japi
from repro.core import ba as jba
from repro.core import er as jer
from repro.core import rmat as jrmat
from repro.core import sbm as jsbm
from repro.distrib import engine as jeng
from repro.distrib import runtime as jrt
from repro_torch import api as tapi
from repro_torch.core import ba as tba
from repro_torch.core import er as ter
from repro_torch.core import rmat as trmat
from repro_torch.core import sbm as tsbm
from repro_torch.distrib.world import World

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = sorted(W.SPECS)
GEOMETRIC = ("rdg", "rgg", "rhg")
SIZES = (2, 4)
P = W.P


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


_WORLDS: dict = {}


def world(size: int) -> list:
    """Every rank's results of the world of ``size`` ranks (spawned once)."""
    if size not in _WORLDS:
        with tempfile.TemporaryDirectory() as d:
            out = os.path.join(d, "rank")
            ctx = torch.multiprocessing.start_processes(
                W.run, args=(size, out, _free_port()), nprocs=size, join=False,
                start_method="spawn")
            deadline = time.monotonic() + 600
            try:
                while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
                    if time.monotonic() > deadline:
                        pytest.fail(f"a world of {size}: no result within 600 s")
            finally:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
            _WORLDS[size] = [torch.load(f"{out}.{r}", weights_only=False)
                             for r in range(size)]
    return _WORLDS[size]


_REF: dict = {}


def reference(name: str) -> dict:
    """The reference's spec, plan, edges and per-PE stream of ``name``."""
    if name not in _REF:
        cls, kw = W.SPECS[name]
        spec = getattr(japi, cls)(**kw)
        per: dict = {}
        for c in japi.iter_edge_chunks(spec, P):
            per.setdefault(c.pe, []).append(np.asarray(c.edges()))
        ref = {"spec": spec, "plan": spec.plan(P),
               "edges": np.asarray(japi.generate(spec, P).edges),
               "per_pe": {pe: np.concatenate(es) for pe, es in per.items()}}
        if name in GEOMETRIC:
            pts: dict = {}
            for c in japi.iter_points(spec, P):
                pts.setdefault(c.pe, []).append(np.asarray(c.points()))
            ref["points"] = pts
        _REF[name] = ref
    return _REF[name]


def _pes_of(res) -> range:
    return range(*res["pes"])


def _same_per_pe(got: dict, want: dict, pes, what: str) -> None:
    for pe in pes:
        g = got.get(pe, np.zeros((0, 2), np.int64))
        w = want.get(pe, np.zeros((0, 2), np.int64))
        np.testing.assert_array_equal(g, w, err_msg=f"{what}: PE {pe}")
    assert set(got) <= set(pes), what


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("name", FAMILIES)
def test_ranks_concatenate_to_the_reference_edges(name, size):
    ranks = world(size)
    assert [r["pes"] for r in ranks] == [(d * P // size, (d + 1) * P // size)
                                         for d in range(size)]
    got = np.concatenate([r["families"][name]["edges"] for r in ranks])
    np.testing.assert_array_equal(got, reference(name)["edges"])


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("name", FAMILIES)
def test_rank_plan_rows_equal_the_reference_rows(name, size):
    """Field by field against ``slice_plan`` of the reference's plan; a
    family that plans its range natively (SBM, RDG) may narrow the
    table's width (a common prefix, then a dead tail) and its capacity."""
    ref = reference(name)["plan"]
    native = hasattr(reference(name)["spec"], "plan_segment")
    for res in world(size):
        lo, hi = res["pes"]
        want = jeng.slice_plan(ref, lo, hi)
        got = res["families"][name]["plan"]
        assert set(got) == {f.name for f in dataclasses.fields(want)} - {"reseed_fn"}
        for field, x in got.items():
            y = getattr(want, field)
            if field == "capacity":
                assert x == y if not native else x <= y, (field, x, y)
                continue
            if not isinstance(x, np.ndarray):
                assert x == y, (field, x, y)
                continue
            y = np.asarray(y)
            assert x.dtype == y.dtype and x.shape[0] == y.shape[0] == hi - lo, field
            C = min(x.shape[1], y.shape[1])
            np.testing.assert_array_equal(x[:, :C], y[:, :C], err_msg=f"{name} {field}")
            assert native or x.shape == y.shape, field
            live = np.asarray(got.get("active", got.get("kind")) if x.shape[1] > C else
                              getattr(want, "active", getattr(want, "kind", None)))
            assert not live[:, C:].any(), (field, "tail")


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("name", FAMILIES)
def test_rank_waves_are_row_d_of_the_reference_schedule(name, size):
    ref = reference(name)
    ws = jrt.wave_schedule(ref["plan"], size, W.BATCH)
    for d, res in enumerate(world(size)):
        waves = res["families"][name]["waves"]
        want = [ws.rows[w][d] for w in range(ws.num_waves) if ws.rows[w][d] is not None]
        assert [(pe, s.tolist()) for pe, s, _ in waves] == [(pe, np.asarray(s).tolist())
                                                             for pe, s in want]
        per: dict = {}
        for pe, _, e in waves:
            per.setdefault(pe, []).append(e)
        _same_per_pe({pe: np.concatenate(es) for pe, es in per.items()}, ref["per_pe"],
                     _pes_of(res), f"{name} waves")


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("name", FAMILIES)
def test_rank_streams_regroup_to_the_reference_chunks(name, size, overlap):
    ref = reference(name)
    for res in world(size):
        got = res["families"][name]["overlap" if overlap else "chunks"]
        _same_per_pe(got, ref["per_pe"], _pes_of(res), f"{name} overlap={overlap}")


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("name", GEOMETRIC)
def test_rank_points_are_its_own_cells(name, size):
    """``generate(return_points=True)`` and ``iter_points`` on a rank give
    its own cells' positions, the reference's ``iter_points`` of its PEs."""
    want = reference(name)["points"]
    for res in world(size):
        fam = res["families"][name]
        pes = [pe for pe in _pes_of(res) if pe in want]
        cells = [p for pe in pes for p in want[pe]]
        assert [pe for pe, _ in fam["iter_points"]] == [pe for pe in pes for _ in want[pe]]
        for (_, g), w in zip(fam["iter_points"], cells):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(fam["points"], np.concatenate(cells))


REF_MESH = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import numpy as np
import repro  # noqa: F401
import jax
from repro import api
from repro.distrib import runtime
specs, P, batch, out = pickle.loads(bytes.fromhex(sys.argv[1]))
mesh = jax.make_mesh((4,), ("pe",))
res = {}
for name, (cls, kw) in specs.items():
    rows = [[] for _ in range(4)]
    for w in runtime.stream_waves(getattr(api, cls)(**kw).plan(P), mesh=mesh, batch=batch):
        payload, valid = np.asarray(w.payload), np.asarray(w.valid)
        assert payload.shape[0] == 4
        for d, row in enumerate(w.rows):
            if row is not None:
                pe, slots = row
                e = payload[d][valid[d]]
                rows[d].append((int(pe), np.asarray(slots).tolist(), e))
    res[name] = rows
with open(out, "wb") as f:
    pickle.dump(res, f)
"""

_MESH: dict = {}


def reference_mesh() -> dict:
    """Each family's reference stream on a real 4-device CPU mesh: per mesh
    row, its ``(pe, slots, edges)`` batches (one JAX subprocess)."""
    if not _MESH:
        with tempfile.TemporaryDirectory() as d:
            out = os.path.join(d, "mesh.pkl")
            arg = pickle.dumps((W.SPECS, P, W.BATCH, out)).hex()
            env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
            r = subprocess.run([sys.executable, "-c", REF_MESH, arg], env=env,
                               capture_output=True, text=True, timeout=600)
            assert r.returncode == 0, r.stderr[-3000:]
            with open(out, "rb") as f:
                _MESH.update(pickle.load(f))
    return _MESH


@pytest.mark.parametrize("name", FAMILIES)
def test_reference_four_device_mesh_streams_the_ranks_rows(name):
    rows = reference_mesh()[name]
    for d, res in enumerate(world(4)):
        waves = res["families"][name]["waves"]
        assert [(pe, s.tolist()) for pe, s, _ in waves] == [(pe, s) for pe, s, _ in rows[d]]
        for (_, _, g), (_, _, w) in zip(waves, rows[d]):
            np.testing.assert_array_equal(g, w)


def test_planted_all_reduce_is_refused_on_every_rank():
    for res in world(2):
        run_err, wave_err = res["planted"]
        for err in (run_err, wave_err):
            assert err is not None and "collectives" in err, err


# --------------------------------------------------------------------------
# the world itself
# --------------------------------------------------------------------------

def test_from_env_reads_the_torchrun_variables(monkeypatch):
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("LOCAL_RANK", "1")
    w = World.from_env(device="cpu")
    assert (w.rank, w.size, w.device) == (3, 4, torch.device("cpu"))
    assert w.pes(16) == (12, 16) and w.pes(4) == (3, 4)
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var)
    assert (World.from_env(device="cpu").rank, World.from_env(device="cpu").size) == (0, 1)


def test_world_refuses_what_it_cannot_shard():
    w = World(1, 3, "cpu")
    with pytest.raises(ValueError, match="P % devices"):
        w.pes(8)
    spec = tapi.GNM(n=100, m=300, seed=1)
    with pytest.raises(ValueError, match="P % devices"):
        tapi.generate(spec, 8, mesh=w)
    with pytest.raises(ValueError, match="P % devices"):
        next(tapi.iter_edge_chunks(spec, 8, mesh=w))
    for rank, size in ((2, 2), (-1, 2), (0, 0)):
        with pytest.raises(ValueError):
            World(rank, size, "cpu")
    with pytest.raises(ValueError, match="runs on cpu"):
        tapi.generate(spec, 2, mesh=World(0, 2, "cpu"), device="cuda")


def test_a_world_of_one_is_the_one_process_run():
    spec = tapi.RGG(n=300, radius=0.1, seed=2)
    w = World(0, 1, "cpu")
    one = tapi.generate(spec, 4, device="cpu")
    assert torch.equal(tapi.generate(spec, 4, mesh=w).edges, one.edges)
    assert tapi.verify_contracts(spec, 4, mesh=w) and tapi.verify_contracts(
        spec, 4, mesh=World(1, 2, "cpu"))


# --------------------------------------------------------------------------
# the paper's per-PE generators
# --------------------------------------------------------------------------

PE_CASES = [(1, 0), (4, 1), (7, 6), (8, 3)]
GENERATORS = {
    "gnm_directed_pe": (lambda P, pe, **kw: ter.gnm_directed_pe(3, 500, 3000, P, pe, **kw),
                        lambda P, pe: jer.gnm_directed_pe(3, 500, 3000, P, pe)),
    "gnp_directed_pe": (lambda P, pe, **kw: ter.gnp_directed_pe(4, 400, 0.02, P, pe, **kw),
                        lambda P, pe: jer.gnp_directed_pe(4, 400, 0.02, P, pe)),
    "gnp_undirected_pe": (lambda P, pe, **kw: ter.gnp_undirected_pe(5, 400, 0.03, P, pe, **kw),
                          lambda P, pe: jer.gnp_undirected_pe(5, 400, 0.03, P, pe)),
    "ba_pe": (lambda P, pe, **kw: tba.ba_pe(6, 300, 4, P, pe, **kw),
              lambda P, pe: jba.ba_pe(6, 300, 4, P, pe)),
    "rmat_pe": (lambda P, pe, **kw: trmat.rmat_pe(7, 10, 5000, P, pe, **kw),
                lambda P, pe: jrmat.rmat_pe(7, 10, 5000, P, pe)),
    "sbm_pe": (lambda P, pe, **kw: tsbm.sbm_pe(8, 600, 6, 0.05, 0.005, P, pe, **kw),
               lambda P, pe: jsbm.sbm_pe(8, 600, 6, 0.05, 0.005, P, pe)),
}


@pytest.mark.parametrize("P,pe", PE_CASES)
@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_per_pe_generator_equals_the_reference(name, P, pe):
    port, ref = GENERATORS[name]
    got = port(P, pe, device="cpu")
    want = np.asarray(ref(P, pe))
    assert got.dtype == torch.int64 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("P,pe", PE_CASES)
def test_gnp_chunks_for_pe_equal_the_reference(P, pe):
    got = ter.gnp_chunks_for_pe(5, 400, 0.03, P, pe)
    want = jer.gnp_chunks_for_pe(5, 400, 0.03, P, pe)
    assert [(dataclasses.astuple(c), k) for c, k in got] == [
        (dataclasses.astuple(c), k) for c, k in want]


@pytest.mark.parametrize("i,j", [(0, 0), (3, 1), (5, 5), (5, 0)])
def test_sbm_region_edges_equal_the_reference(i, j):
    got = tsbm.sbm_region_edges(8, 600, 6, i, j, 0.05, 0.005, device="cpu")
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jsbm.sbm_region_edges(8, 600, 6, i, j, 0.05, 0.005)))
    with pytest.raises(ValueError):
        tsbm.sbm_region_edges(8, 600, 6, 1, 3, 0.05, 0.005, device="cpu")


def test_per_pe_generators_concatenate_to_generate():
    """A PE's per-PE generator is its rows of the engine's plan:
    ``gnm_directed_pe``, ``ba_pe`` and ``rmat_pe`` over every PE concatenate
    to ``generate`` at that P."""
    for spec, fn in ((tapi.GNM(n=500, m=3000, directed=True, seed=3, chunks=4),
                      lambda pe: ter.gnm_directed_pe(3, 500, 3000, 4, pe, device="cpu")),
                     (tapi.BA(n=300, d=4, seed=6), lambda pe: tba.ba_pe(6, 300, 4, 4, pe,
                                                                          device="cpu")),
                     (tapi.RMAT(log_n=10, m=5000, seed=7),
                      lambda pe: trmat.rmat_pe(7, 10, 5000, 4, pe, device="cpu"))):
        assert torch.equal(torch.cat([fn(pe) for pe in range(4)]),
                           tapi.generate(spec, 4, device="cpu").edges), spec


def test_torchrun_generates_a_spec_rank_by_rank(tmp_path):
    """``torchrun -m repro_torch.launch.generate`` on two CPU processes:
    each rank writes its edges, which concatenate to the reference's."""
    cls, kw = W.SPECS["rgg"]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
                        "--master-addr", "127.0.0.1", "--master-port", str(_free_port()),
                        "-m", "repro_torch.launch.generate", "--device", "cpu", cls,
                        *[f"{k}={v}" for k, v in kw.items()], "--pes", str(P),
                        "--out", str(tmp_path)], capture_output=True, text=True, timeout=600,
                       env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    assert sorted(line.split(" on ")[0] for line in r.stdout.splitlines()
                  if line.startswith("rank")) == ["rank 0 of 2", "rank 1 of 2"]
    got = np.concatenate([np.load(tmp_path / f"edges.{d}.npy") for d in range(2)])
    np.testing.assert_array_equal(got, reference("rgg")["edges"])


def test_processes_starting_together_build_each_library_once(tmp_path):
    """Three processes building the same two libraries at once run the
    compiler once a library (a stand-in ``nvcc`` that takes a second and
    logs each output it writes): the others wait on the file lock and
    load what it built."""
    from repro_torch.kernels import build

    log, fake = tmp_path / "compiled", tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    f'sleep 1\necho "$2" >> {log}\ntouch "$2"\n')
    fake.chmod(0o755)
    names = ["hist", "sampler"]
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=W.build_with, args=(str(tmp_path / "b"), str(fake), names))
             for _ in range(3)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
        assert p.exitcode == 0
    assert len(log.read_text().split()) == len(names)
    for name in names:
        assert (tmp_path / "b" / build.library_path(name).name).exists()
