"""``collect`` and ``validate`` on one process's local mesh (the reference's
default ``runtime.mesh_for(P)``) against the JAX package, on the CPU.

On meshes of 2 and 4 CPU rows (``LocalMesh(["cpu"] * D)``) at P = 8, for
all eight families (degree and sampled clustering for the undirected
ones, degree and in-degree for BA, R-MAT and a directed GNM; exact mode,
and binned mode through ``mode="binned"``), every ``StatsReport`` equals,
field by field and exactly:

* the reference's ``repro.stats.collect(spec, 8)`` on a real 4-device
  JAX CPU mesh (its default mesh in a subprocess with
  ``--xla_force_host_platform_device_count=4``, run once for the module),
* and the port's one-device report.

``validate``'s reports equal ``repro.stats.validate``'s there, text
included.  Each chunk is counted where its row streamed it, into that
row's partial counts (one a row, also where rows share a device), and
the report does not depend on the order in which the rows' chunks
arrive.
With no device and no mesh, ``collect``, ``validate`` and ``python -m
repro_torch.stats`` take ``runtime.mesh_for(P)``; a ``World`` is refused.
A stats-sink fleet on two rows, one of them dead at a slab, counts what
one device counts.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_world_worker as W
from repro_torch import api as tapi
from repro_torch import stats as tstats
from repro_torch.distrib import runtime
from repro_torch.distrib.world import LocalMesh, World
from repro_torch.serve import Service, StatsSink
from repro_torch.stats.accumulate import Partials

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
P = W.P
SIZES = (2, 4)
CLUSTERING = ("degree", "clustering")
SPECS = dict(W.SPECS, gnm_d=("GNM", dict(n=300, m=2000, directed=True, seed=19)))
#: name -> (spec of SPECS, metrics, mode)
CASES = {
    **{name: (name, CLUSTERING, "exact") for name in ("gnm", "gnp", "rgg", "rhg", "rdg", "sbm")},
    **{name: (name, ("degree",), "exact") for name in ("ba", "rmat", "gnm_d")},
    "rhg_binned": ("rhg", CLUSTERING, "binned"),
    "gnm_d_binned": ("gnm_d", ("degree",), "binned"),
}
VALIDATED = sorted(W.SPECS)


def tspec(name: str):
    cls, kw = SPECS[name]
    return getattr(tapi, cls)(**kw)


def mesh(D: int) -> LocalMesh:
    return LocalMesh(["cpu"] * D)


def plain(x):
    """A report as nested dicts of host values: dataclasses by field (and
    the properties the reports derive), arrays as numpy."""
    if dataclasses.is_dataclass(x):
        out = {f.name: plain(getattr(x, f.name)) for f in dataclasses.fields(x)
               if f.name != "model"}
        for prop in ("mean_degree", "mean", "variance", "global_cc", "mean_local_cc", "m"):
            if hasattr(type(x), prop):
                out[prop] = plain(getattr(x, prop))
        if hasattr(x, "degree_counts") and getattr(x, "mode", None) == "exact":
            out["degree_counts"] = plain(x.degree_counts())
        if hasattr(x, "checks"):
            out["text"] = str(x)
        return out
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    if hasattr(x, "__array__") and not isinstance(x, (bool, int, float, str)):
        return np.asarray(x)
    return x


def same(a, b, where: str = "report") -> None:
    """``a == b`` field by field: arrays by value (NaN equal to NaN),
    floats exactly."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), (where, sorted(a), sorted(b))
        for k in a:
            same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), where
    elif isinstance(a, float) and isinstance(b, float) and a != a:
        assert b != b, where
    else:
        assert a == b, (where, a, b)


REF_MESH = r"""
import dataclasses, os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import numpy as np
import repro  # noqa: F401
import jax
from repro import api, stats
from repro.distrib import runtime
specs, cases, validated, P, out = pickle.loads(bytes.fromhex(sys.argv[1]))
assert len(jax.devices()) == 4 and runtime.mesh_for(P).devices.size == 4


def plain(x):
    if dataclasses.is_dataclass(x):
        res = {f.name: plain(getattr(x, f.name)) for f in dataclasses.fields(x)
               if f.name != "model"}
        for prop in ("mean_degree", "mean", "variance", "global_cc", "mean_local_cc", "m"):
            if hasattr(type(x), prop):
                res[prop] = plain(getattr(x, prop))
        if hasattr(x, "degree_counts") and getattr(x, "mode", None) == "exact":
            res["degree_counts"] = plain(x.degree_counts())
        if hasattr(x, "checks"):
            res["text"] = str(x)
        return res
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if hasattr(x, "__array__") and not isinstance(x, (bool, int, float, str)):
        return np.asarray(x)
    return x


def spec(name):
    cls, kw = specs[name]
    return getattr(api, cls)(**kw)


res = {"collect": {}, "validate": {}}
for case, (name, metrics, mode) in cases.items():
    res["collect"][case] = plain(stats.collect(spec(name), P, metrics=metrics, mode=mode))
for name in validated:
    res["validate"][name] = plain(stats.validate(spec(name), P))
with open(out, "wb") as f:
    pickle.dump(res, f)
"""

_REF: dict = {}


def reference() -> dict:
    """Every case's reference report on its default 4-device CPU mesh (one
    JAX subprocess for the module)."""
    if not _REF:
        with tempfile.TemporaryDirectory() as d:
            out = os.path.join(d, "ref.pkl")
            arg = pickle.dumps((SPECS, CASES, VALIDATED, P, out)).hex()
            env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
            r = subprocess.run([sys.executable, "-c", REF_MESH, arg], env=env,
                               capture_output=True, text=True, timeout=600)
            assert r.returncode == 0, r.stderr[-3000:]
            with open(out, "rb") as f:
                _REF.update(pickle.load(f))
    return _REF


_ONE: dict = {}


def one_device(case: str):
    """The port's one-device report of ``case``."""
    if case not in _ONE:
        name, metrics, mode = CASES[case]
        _ONE[case] = tstats.collect(tspec(name), P, metrics=metrics, mode=mode, device="cpu")
    return _ONE[case]


@pytest.fixture
def rows_used(monkeypatch):
    """The mesh rows whose context was entered (every row's work runs in
    its ``LocalMesh.row``)."""
    seen = set()
    real = LocalMesh.row

    def row(self, d):
        seen.add(d)
        return real(self, d)

    monkeypatch.setattr(LocalMesh, "row", row)
    return seen


@pytest.mark.parametrize("D", SIZES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_collect_on_a_local_mesh_equals_the_reference_and_one_device(case, D, rows_used):
    name, metrics, mode = CASES[case]
    got = tstats.collect(tspec(name), P, metrics=metrics, mode=mode, mesh=mesh(D))
    assert rows_used == set(range(D))
    assert got.mode == mode and (got.degree.degrees is None) == (mode == "binned")
    assert (got.in_degree is not None) == got.directed
    assert (got.clustering is not None) == ("clustering" in metrics)
    same(plain(got), plain(one_device(case)), f"{case} D={D} vs one device")
    same(plain(got), reference()["collect"][case], f"{case} D={D} vs the reference")


@pytest.mark.parametrize("D", SIZES)
@pytest.mark.parametrize("name", VALIDATED)
def test_validate_on_a_local_mesh_equals_the_reference(name, D):
    got = tstats.validate(tspec(name), P, mesh=mesh(D))
    same(plain(got), reference()["validate"][name], f"validate {name} D={D}")
    one = tstats.validate(tspec(name), P, device="cpu")
    assert str(got) == str(one)


@pytest.mark.parametrize("case", ["sbm", "rhg", "gnm_d"])
def test_the_report_does_not_depend_on_the_chunks_order(case, monkeypatch):
    """The rows' chunks reversed (both passes) give the same report: the
    per-row sums, the sample's counts and its neighbour lists are
    order-free."""
    real = tapi.iter_edge_chunks

    def reversed_chunks(*a, **k):
        return iter(list(real(*a, **k))[::-1])

    monkeypatch.setattr(tapi, "iter_edge_chunks", reversed_chunks)
    name, metrics, mode = CASES[case]
    got = tstats.collect(tspec(name), P, metrics=metrics, mode=mode, mesh=mesh(4))
    same(plain(got), plain(one_device(case)), f"{case} reversed")


@pytest.mark.parametrize("D", SIZES)
@pytest.mark.parametrize("case", ["sbm", "rhg", "gnm_d"])
def test_each_row_counts_its_own_chunks_into_its_partials(case, D, monkeypatch):
    """On D rows of one device, collect sums D partial degree arrays (and
    D triangle-count vectors), each holding exactly the degrees of the
    chunks of its row's PEs (``runtime.stream_row``)."""
    one = one_device(case)
    sums = []
    real_sum = Partials.sum

    def summed(self):
        sums.append([p.clone() for p in self.parts.values()])
        return real_sum(self)

    monkeypatch.setattr(Partials, "sum", summed)
    name, metrics, mode = CASES[case]
    spec = tspec(name)
    got = tstats.collect(spec, P, metrics=metrics, mode=mode, mesh=mesh(D))
    same(plain(got), plain(one), f"{case} D={D}")
    assert len(sums) == (2 if spec.directed else 1) + ("clustering" in metrics)
    assert all(len(parts) == D for parts in sums)
    n = spec.num_vertices
    want = [torch.zeros(n, dtype=torch.int64) for _ in range(D)]
    for ch in tapi.iter_edge_chunks(spec, P, device="cpu"):
        e = ch.edges()
        want[runtime.stream_row(P, D, ch.pe)] += torch.bincount(
            (e[:, 0] if spec.directed else e).reshape(-1), minlength=n)
    out = next(parts for parts in sums if parts[0].numel() == n)   # summed before in-degrees
    for r in range(D):
        assert torch.equal(out[r], want[r]), (case, D, r)
    assert torch.equal(sum(out), got.degree.degrees)


def test_partials_keep_one_accumulator_a_key_and_sum_once():
    total = torch.zeros(4, dtype=torch.int64)
    acc = Partials(total, {0: "cpu", 1: "cpu", "x": "cpu"})
    assert acc.on(0, torch.device("cpu")) is total
    assert len({id(p) for p in acc.parts.values()}) == 3
    for key, v in ((0, 1), (1, 10), ("x", 100)):
        acc.on(key, torch.device("cpu"))[1 if key == "x" else 0] += v
    with pytest.raises(ValueError, match="no accumulator"):
        acc.on(2, torch.device("cpu"))
    with pytest.raises(ValueError, match="no accumulator"):
        acc.on(1, torch.device("meta"))
    assert acc.sum() is total and total.tolist() == [11, 100, 0, 0]
    assert acc.sum().tolist() == [11, 100, 0, 0]          # once
    with pytest.raises(ValueError, match="no accumulator"):
        acc.on(0, torch.device("cpu"))
    one = Partials(torch.zeros(2, dtype=torch.int64))
    assert list(one.parts) == [0] and one.on(0, torch.device("cpu")) is one.total


def test_a_stats_sink_refuses_a_run_off_its_cards():
    sink = StatsSink(8, False, "cpu")
    sink.expect(1)
    payload = torch.zeros((1, 4, 2), dtype=torch.int64, device="meta")
    mask = torch.zeros((1, 4), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="no accumulator"):
        sink.deliver(0, payload, mask, np.zeros(1, np.int64))


def test_no_device_and_no_mesh_is_mesh_for(monkeypatch, rows_used, capsys):
    """``collect``, ``validate`` and the CLI without a device stream on
    ``runtime.mesh_for(P)`` (here two CPU rows in its place); the CPU
    named as the device is one row, the one-device path."""
    asked = []

    def mesh_for(p):
        asked.append(p)
        return mesh(2)

    monkeypatch.setattr(runtime, "mesh_for", mesh_for)
    spec = tspec("gnp")
    rep = tstats.collect(spec, P, metrics=CLUSTERING)
    assert asked == [P] and rows_used == {0, 1}
    same(plain(rep), plain(one_device("gnp")), "mesh_for")
    assert str(tapi.validate(spec, P)) == str(tstats.validate(spec, P, device="cpu"))
    assert asked == [P, P]
    rows_used.clear()
    tapi.collect(spec, P, device="cpu")
    assert asked == [P, P] and not rows_used
    from repro_torch.stats.__main__ import main
    assert main(["--n", "512", "--pes", "4"]) == 0
    assert asked[2:] == [4, 4] and rows_used == {0, 1}
    assert "PASS" in capsys.readouterr().out


def test_collect_and_validate_refuse_a_world():
    spec = tspec("gnm")
    for fn in (tstats.collect, tstats.validate, tapi.collect, tapi.validate):
        with pytest.raises(ValueError, match="not on a World"):
            fn(spec, P, mesh=World(0, 2, "cpu"))
    with pytest.raises(ValueError, match="P % devices"):
        tstats.collect(spec, 6, mesh=mesh(4))


def test_stats_sinks_on_two_rows_equal_one_device():
    """A fleet of stats requests on two rows with row 1 dead at slab 0
    (its slots reissued on row 0) counts the edges and degrees of one
    device's fleet and of ``generate``."""
    names = ("gnm", "rhg", "ba", "sbm")
    counts = {}
    for label, m in (("rows", mesh(2)), ("one", None)):
        svc = Service(P, mesh=m, device="cpu", slab_batch=8, check=False)
        tickets = [svc.submit(tspec(n), sink="stats") for n in names]
        if m is not None:
            svc.inject_fault([1], at_slab=0)
        svc.drain()
        if m is not None:
            assert svc.scheduler.reissued > 0
        counts[label] = [t.result() for t in tickets]
    for name, a, b in zip(names, counts["rows"], counts["one"]):
        g = tapi.generate(tspec(name), P, device="cpu")
        assert a["num_edges"] == b["num_edges"] == g.m, name
        assert torch.equal(a["degrees"], b["degrees"]) and torch.equal(a["degrees"],
                                                                       g.degrees()), name
