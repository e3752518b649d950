"""A world whose ranks own several mesh rows each (``World(rank, size,
devices)``, ``World.from_env(cards=...)``) against the JAX package, on the
CPU.

A world of two ranks with two CPU rows each is spawned once, from
``tests/torch_world_cards_worker.py``; the world has four mesh rows, rank
r holds rows ``[2r, 2r+2)`` and PEs ``[4r, 4r+4)`` of P = 8.  For every
family:

* the ranks' edges, concatenated in rank order, equal
  ``repro.api.generate(spec, 8).edges``, each rank's generated over both
  its rows;
* rank r's ``(pe, slots)`` batches on world row ``2r + j`` equal row
  ``2r + j`` of ``repro.distrib.runtime.wave_schedule(plan, 4, batch)``,
  and, edges included, the reference's stream on a real 4-device CPU mesh
  (a JAX subprocess, run once);
* ``iter_edge_chunks`` (also with ``overlap=2``) and ``iter_points``
  regroup to the reference's by PE, and ``verify_contracts`` scans one
  case a world row.

``World.from_env`` gives each rank its share of the host's cards under a
patched ``LOCAL_WORLD_SIZE`` and card count, one card a rank where the
ranks outnumber the cards.
"""
import os
import pickle
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest
import torch

import torch_world_cards_worker as WC
import torch_world_worker as W
from repro import api as japi
from repro.distrib import runtime as jrt
from repro_torch.distrib import world as tworld
from repro_torch.distrib.world import World

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = sorted(W.SPECS)
GEOMETRIC = ("rdg", "rgg", "rhg")
P, RANKS, CARDS = W.P, 2, WC.CARDS
ROWS = RANKS * CARDS

_WORLD: list = []


def world() -> list:
    """Every rank's results of the world of two ranks of two rows (spawned once)."""
    if not _WORLD:
        with tempfile.TemporaryDirectory() as d:
            out = os.path.join(d, "rank")
            ctx = torch.multiprocessing.start_processes(
                WC.run, args=(RANKS, out), nprocs=RANKS, join=False, start_method="spawn")
            deadline = time.monotonic() + 600
            try:
                while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
                    if time.monotonic() > deadline:
                        pytest.fail("the world: no result within 600 s")
            finally:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
            _WORLD.extend(torch.load(f"{out}.{r}", weights_only=False) for r in range(RANKS))
    return _WORLD


_REF: dict = {}


def reference(name: str) -> dict:
    """The reference's plan, edges, per-PE stream and points of ``name``."""
    if name not in _REF:
        cls, kw = W.SPECS[name]
        spec = getattr(japi, cls)(**kw)
        per: dict = {}
        for c in japi.iter_edge_chunks(spec, P):
            per.setdefault(c.pe, []).append(np.asarray(c.edges()))
        ref = {"plan": spec.plan(P), "edges": np.asarray(japi.generate(spec, P).edges),
               "per_pe": {pe: np.concatenate(es) for pe, es in per.items()}}
        if name in GEOMETRIC:
            pts: dict = {}
            for c in japi.iter_points(spec, P):
                pts.setdefault(c.pe, []).append(np.asarray(c.points()))
            ref["points"] = pts
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
from repro.distrib import runtime
specs, P, batch, out = pickle.loads(bytes.fromhex(sys.argv[1]))
mesh = jax.make_mesh((4,), ("pe",))
res = {}
for name, (cls, kw) in specs.items():
    rows = [[] for _ in range(4)]
    for w in runtime.stream_waves(getattr(api, cls)(**kw).plan(P), mesh=mesh, batch=batch):
        payload, valid = np.asarray(w.payload), np.asarray(w.valid)
        for d, row in enumerate(w.rows):
            if row is not None:
                pe, slots = row
                rows[d].append((int(pe), np.asarray(slots).tolist(), payload[d][valid[d]]))
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


def _same_per_pe(got: dict, want: dict, pes, what: str) -> None:
    for pe in pes:
        g = got.get(pe, np.zeros((0, 2), np.int64))
        w = want.get(pe, np.zeros((0, 2), np.int64))
        np.testing.assert_array_equal(g, w, err_msg=f"{what}: PE {pe}")
    assert set(got) <= set(pes), what


@pytest.mark.parametrize("name", FAMILIES)
def test_ranks_of_two_rows_concatenate_to_the_reference_edges(name):
    ranks = world()
    assert [r["pes"] for r in ranks] == [(0, 4), (4, 8)]
    assert [r["rows"] for r in ranks] == [(0, 2), (2, 4)]
    assert all(r["devices"] == ["cpu"] * CARDS for r in ranks)
    for r in ranks:
        assert r["families"][name]["generate_rows"] == [0, 1], name
    got = np.concatenate([r["families"][name]["edges"] for r in ranks])
    np.testing.assert_array_equal(got, reference(name)["edges"])


@pytest.mark.parametrize("name", FAMILIES)
def test_rank_rows_are_rows_of_the_reference_schedule_and_mesh(name):
    ref = reference(name)
    ws = jrt.wave_schedule(ref["plan"], ROWS, W.BATCH)
    mesh_rows = reference_mesh()[name]
    for res in world():
        waves = res["families"][name]["waves"]
        assert sorted(waves) == list(range(*res["rows"]))
        per: dict = {}
        for d, batches in waves.items():
            want = [ws.rows[w][d] for w in range(ws.num_waves) if ws.rows[w][d] is not None]
            assert [(pe, s.tolist()) for pe, s, _ in batches] == [
                (pe, np.asarray(s).tolist()) for pe, s in want], (name, d)
            assert [(pe, s.tolist()) for pe, s, _ in batches] == [
                (pe, s) for pe, s, _ in mesh_rows[d]], (name, d)
            for (pe, _, g), (_, _, w) in zip(batches, mesh_rows[d]):
                np.testing.assert_array_equal(g, w, err_msg=f"{name} row {d}")
                per.setdefault(pe, []).append(g)
        _same_per_pe({pe: np.concatenate(es) for pe, es in per.items()}, ref["per_pe"],
                     range(*res["pes"]), f"{name} waves")


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("name", FAMILIES)
def test_rank_streams_regroup_to_the_reference_chunks(name, overlap):
    ref = reference(name)
    for res in world():
        got = res["families"][name]["overlap" if overlap else "chunks"]
        _same_per_pe(got, ref["per_pe"], range(*res["pes"]), f"{name} overlap={overlap}")


@pytest.mark.parametrize("name", GEOMETRIC)
def test_rank_points_are_its_own_cells(name):
    want = reference(name)["points"]
    for res in world():
        fam = res["families"][name]
        pes = [pe for pe in range(*res["pes"]) if pe in want]
        cells = [p for pe in pes for p in want[pe]]
        assert sorted(pe for pe, _ in fam["iter_points"]) == [pe for pe in pes for _ in want[pe]]
        by_pe: dict = {}
        for pe, g in fam["iter_points"]:
            by_pe.setdefault(pe, []).append(g)
        for pe in pes:
            for g, w in zip(by_pe[pe], want[pe]):
                np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(fam["points"], np.concatenate(cells))


@pytest.mark.parametrize("name", FAMILIES)
def test_verify_contracts_scans_one_case_a_world_row(name):
    for res in world():
        names = res["families"][name]["contracts"]
        rows = {n.rsplit("/", 1)[1] for n in names}
        assert rows == {f"row{d}" for d in range(*res["rows"])}, names
        kinds = 2 if name in GEOMETRIC else 1
        assert len(names) == kinds * 2 * CARDS, names


@pytest.fixture
def cards(monkeypatch):
    """``World.from_env`` on a host of ``count`` cards, without one: the
    card count and device resolution patched."""
    def host(count: int):
        monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
        monkeypatch.setattr(tworld, "resolve_device", lambda d=None: torch.device(
            "cuda", 0) if torch.device(d or "cuda").index is None and torch.device(
            d or "cuda").type == "cuda" else torch.device(d))
        for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
            monkeypatch.delenv(var, raising=False)
    return host


@pytest.mark.parametrize("count,env,cards_arg,want", [
    (8, dict(RANK=1, WORLD_SIZE=2, LOCAL_RANK=1, LOCAL_WORLD_SIZE=2), None, [4, 5, 6, 7]),
    (8, dict(RANK=2, WORLD_SIZE=3, LOCAL_RANK=2, LOCAL_WORLD_SIZE=3), None, [4, 5]),
    (8, dict(RANK=0, WORLD_SIZE=2, LOCAL_RANK=0), None, [0, 1, 2, 3]),
    (8, dict(RANK=5, WORLD_SIZE=8, LOCAL_RANK=1, LOCAL_WORLD_SIZE=4), None, [2, 3]),
    (1, dict(RANK=3, WORLD_SIZE=4, LOCAL_RANK=3, LOCAL_WORLD_SIZE=4), None, [0]),
    (2, dict(RANK=3, WORLD_SIZE=4, LOCAL_RANK=3, LOCAL_WORLD_SIZE=4), None, [1]),
    (1, dict(RANK=1, WORLD_SIZE=2, LOCAL_RANK=1, LOCAL_WORLD_SIZE=2), 2, [0, 0]),
    (4, dict(RANK=1, WORLD_SIZE=2, LOCAL_RANK=1, LOCAL_WORLD_SIZE=2), 1, [1]),
], ids=["8-cards-2-ranks", "8-cards-3-ranks", "no-local-world-size", "two-hosts",
        "1-card-4-ranks", "2-cards-4-ranks", "cards-2-on-1-card", "cards-1"])
def test_from_env_gives_each_rank_its_share_of_the_cards(cards, monkeypatch, count, env,
                                                         cards_arg, want):
    cards(count)
    for k, v in env.items():
        monkeypatch.setenv(k, str(v))
    w = World.from_env(cards=cards_arg)
    assert (w.rank, w.size) == (env["RANK"], env["WORLD_SIZE"])
    assert w.devices == tuple(torch.device("cuda", i) for i in want)
    assert w.device == torch.device("cuda", want[0]) and w.cards == len(want)
    assert w.row_range() == (w.rank * len(want), (w.rank + 1) * len(want))


def test_from_env_on_the_cpu_or_one_card(cards, monkeypatch):
    cards(8)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    assert World.from_env(device="cpu").devices == (torch.device("cpu"),)
    assert World.from_env(device="cpu", cards=3).devices == (torch.device("cpu"),) * 3
    assert World.from_env(device="cuda:5").devices == (torch.device("cuda", 5),)


def test_a_rank_of_several_rows_refuses_what_it_cannot_shard():
    w = World(0, 2, ["cpu"] * 3)
    assert w.cards == 3 and w.row_range() == (0, 3)
    with pytest.raises(ValueError, match="P % devices"):
        w.pes(8)
    assert World(1, 2, ["cpu"] * 2).pes(8) == (4, 8)
    with pytest.raises(ValueError, match="all CUDA or all CPU"):
        World(0, 1, [])
