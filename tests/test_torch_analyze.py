"""``repro_torch.analyze`` against ``repro.analyze``, proven with planted
violations.

Lint: the reference's planted sources give the same ``(rule, line)``
findings from both linters for every rule the two share; each rule with
a PyTorch spelling has a planted hit and a clean case; the port lints
clean.  Op scan: each rule fires exactly once on a planted slot function
and a collective in a census raises the reference's error text.  The
registry's programs map one to one onto the reference's, and every case
is clean on the CPU.  ``check=`` and ``mesh=`` leave the edges as the
reference's ``generate`` gives them.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro import api as japi
from repro.analyze import lint as jlint
from repro.analyze import programs as jprograms
from repro_torch import api as tapi
from repro_torch.analyze import lint, opscan, programs
from repro_torch.analyze.__main__ import main as analyze_main
from repro_torch.distrib import engine, runtime
from torch_planted import Planted

torch.set_num_threads(1)

# --------------------------------------------------------------------------
# Pass 2: the linter
# --------------------------------------------------------------------------

ROLES = {"emitter": ("src/repro/core/planted.py", "src/repro_torch/core/planted.py"),
         "kernels": ("src/repro/kernels/planted.py", "src/repro_torch/kernels/planted.py"),
         "support": ("src/repro/launch/planted.py", "src/repro_torch/serve/planted.py"),
         "obs": ("src/repro/obs/planted.py", "src/repro_torch/obs/planted.py"),
         "tests": ("tests/test_planted.py", "tests/test_planted.py")}

# the reference's planted sources (tests/test_analyze.py) for the rules
# both linters share, each in every role
SHARED = [
    "import numpy as np\nedges = np.unique(e, axis=0)\n",
    "import numpy as np\nedges = np.unique(e, axis=0)  # repro: allow(no-numpy-unique) oracle\n",
    "import numpy as np\nedges = np.unique(e, axis=0)  # repro: allow(no-raw-prngkey)\n",
    "import numpy as np\nx = np.unique(y)\n",
    "import random\nx = random.random()\n",
    "import time\nimport numpy as np\nseed = time.time_ns()\nrng = np.random.default_rng()\n",
    "import numpy as np\nrng = np.random.default_rng(42)\n",
    "from repro.core.er import gnm_directed\ne = gnm_directed(0, 8, 4)\n",
    "def gnm_directed(seed, n, m, P=1):\n    return gnm_directed_impl(seed, n, m, P)\n",
    "from repro.api import RGG, generate\ng = generate(RGG(n=64, radius=0.1), 4, rng_impl='rbg')\n",
    "spec = RHG(n=64, avg_deg=4, gamma=2.7)\nplan = spec.plan(4, rng_impl='rbg')\n",
    "plan = make_pair_plan(rows, rng_impl='rbg')\n",
    "spec = RDG(n=64)\nfor c in iter_edge_chunks(spec, 8, rng_impl='rbg'):\n    pass\n",
    "g = generate(RGG(n=64, radius=0.1), 4, rng_impl='threefry2x32')\n",
    "g = generate(GNM(n=64, m=32), 4, rng_impl='rbg')\n",
    "from repro.core.prng import host_rng\ndef plan(seed, P):\n    for pe in range(P):\n"
    "        c = host_rng(seed, 1, pe)\n",
    "from repro.distrib.engine import ChunkSpec\nspecs = [ChunkSpec(k, kd, u, c, p) for k in ks]\n",
    "from repro.core.prng import host_rng\nfor v in host_rng(seed, 1, 0).permutation(8):\n"
    "    use(v)\n",
    "from repro.core.variates import binomial\nfor k, h in enumerate(hashes):\n"
    "    out[k] = binomial(rep.at(h), int(U[k]), float(p[k]))\n",
    "from repro.core.prng import host_rng\nfor pe in range(P):\n    c = host_rng(seed, 1, pe)"
    "  # repro: allow(no-per-chunk-host-loop) oracle\n",
    "from scipy.spatial import Delaunay\ndef plan(chunks):\n    for pts in chunks:\n"
    "        tri = Delaunay(pts)\n",
    "from repro.core.rdg import circumspheres\nwhile pending:\n"
    "    c, r = circumspheres(pts[sel])\n",
    "from scipy.spatial import Delaunay\ntri = Delaunay(pts)\n",
]
SHARED_RULES = {lint.RULE_NP_UNIQUE, lint.RULE_PY_RANDOM, lint.RULE_WALLCLOCK,
                lint.RULE_DEPRECATED, lint.RULE_NONCOUNTER_PAIR, lint.RULE_PER_CHUNK_LOOP}


def _found(findings):
    return sorted((f.rule, f.line) for f in findings if f.rule in SHARED_RULES)


@pytest.mark.parametrize("role", sorted(ROLES))
@pytest.mark.parametrize("i", range(len(SHARED)))
def test_shared_rules_match_the_reference(i, role):
    src = SHARED[i]
    ref_path, port_path = ROLES[role]
    assert lint.role_of(port_path) == jlint.role_of(ref_path) == role
    assert _found(lint.lint_source(src, port_path)) == _found(jlint.lint_source(src, ref_path))


def test_shared_tables_match_the_reference():
    assert lint.COUNTER_RNGS == jlint.COUNTER_RNGS == engine.COUNTER_RNGS
    for name in ("PAIR_PLAN_FAMILIES", "PAIR_PLAN_EMITTERS", "SPEC_CONSUMERS",
                 "DEPRECATED_SHIMS", "PER_CHUNK_CALLS", "LINT_RULES"):
        assert getattr(lint, name) == getattr(jlint, name), name


KERNEL, EMITTER, SUPPORT = (ROLES[r][1] for r in ("kernels", "emitter", "support"))

TORCH_SPELLED = [
    # (rule, role path, planted source, lines of the findings)
    (lint.RULE_KERNEL_COLLECTIVE, KERNEL,
     "import torch.distributed as dist\ndist.all_reduce(x)\n", [1, 2]),
    (lint.RULE_KERNEL_COLLECTIVE, KERNEL, "from torch import distributed\n", [1]),
    (lint.RULE_KERNEL_COLLECTIVE, KERNEL, "import torch\ntorch.distributed.barrier()\n", [2]),
    (lint.RULE_KERNEL_COLLECTIVE, KERNEL, "from repro_torch.distrib import engine\n", [1]),
    (lint.RULE_KERNEL_COLLECTIVE, KERNEL, "from ...distrib.runtime import run\n", [1]),
    (lint.RULE_RAW_PRNGKEY, EMITTER, "import torch\nx = torch.rand(4)\n", [2]),
    (lint.RULE_RAW_PRNGKEY, KERNEL, "import torch\nx = torch.randint(0, 9, (4,))\n", [2]),
    (lint.RULE_RAW_PRNGKEY, EMITTER, "import torch as T\nx = T.randperm(8)\n", [2]),
    (lint.RULE_RAW_PRNGKEY, EMITTER, "import torch\ng = torch.Generator().manual_seed(0)\n", [2]),
    (lint.RULE_RAW_PRNGKEY, EMITTER, "import torch\ntorch.manual_seed(0)\n", [2]),
    (lint.RULE_RAW_PRNGKEY, KERNEL, "y = x.uniform_()\n", [1]),
    (lint.RULE_RAW_PRNGKEY, EMITTER, "import torch\ny = torch.normal(m, s)\n", [2]),
    (lint.RULE_RAW_PRNGKEY, EMITTER, "import torch\ny = torch.bernoulli(p)\n", [2]),
]
TORCH_CLEAN = [
    # the same sources where the rule does not apply, and near misses
    (EMITTER, "import torch.distributed as dist\ndist.all_reduce(x)\n"),
    (KERNEL, "import torch\ny = torch.cumsum(x, 0)\n"),
    (KERNEL, "from ..build import check\n"),
    (SUPPORT, "import torch\nx = torch.rand(4)\n"),
    ("src/repro_torch/core/prng.py", "import torch\nx = torch.rand(4)\n"),
    (EMITTER, "import torch\nx = torch.empty(4).fill_(0)\n"),
    (EMITTER, "import torch\nx = torch.rand(4)  # repro: allow(no-raw-prngkey) oracle\n"),
]


@pytest.mark.parametrize("rule,path,src,lines", TORCH_SPELLED,
                         ids=[f"{r}-{k}" for k, (r, *_) in enumerate(TORCH_SPELLED)])
def test_torch_spelled_rule_fires(rule, path, src, lines):
    found = lint.lint_source(src, path)
    assert [(f.rule, f.line) for f in found] == [(rule, ln) for ln in lines]


@pytest.mark.parametrize("path,src", TORCH_CLEAN, ids=[str(k) for k in range(len(TORCH_CLEAN))])
def test_torch_spelled_rule_clean_case(path, src):
    assert lint.lint_source(src, path) == []


def test_allow_is_rule_specific_for_torch_rules():
    src = "import torch\nx = torch.rand(4)  # repro: allow(no-numpy-unique)\n"
    assert [f.rule for f in lint.lint_source(src, EMITTER)] == [lint.RULE_RAW_PRNGKEY]


def test_port_is_clean():
    """The shipping port and the card check pass their own gate."""
    found = lint.lint_paths(["src/repro_torch", "chip_smoke.py"])
    assert found == [], "\n".join(f.format() for f in found)


# --------------------------------------------------------------------------
# Pass 1: the op scan
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gnm_plan():
    return tapi.GNM(n=64, m=128, seed=1, chunks=4).plan(4)


PLANTED = [("host-callback", opscan.RULE_HOST_CALLBACK, opscan.GENERATOR_CONTRACT),
           ("dynamic-shape", opscan.RULE_DYNAMIC_SHAPE, opscan.GENERATOR_CONTRACT),
           ("dynamic-shape/bool-index", opscan.RULE_DYNAMIC_SHAPE, opscan.GENERATOR_CONTRACT),
           ("nondeterministic-rng", opscan.RULE_NONDET_RNG, opscan.GENERATOR_CONTRACT),
           ("f64-op", opscan.RULE_F64, opscan.FLOAT32_KERNEL_CONTRACT)]


@pytest.mark.parametrize("plant,rule,contract", PLANTED, ids=[p for p, *_ in PLANTED])
def test_each_rule_fires_exactly_once_on_a_planted_slot_function(gnm_plan, plant, rule,
                                                                 contract):
    planted = Planted(gnm_plan, plant, tag="scan")
    _, rep = opscan.scan_call(runtime.run, planted, "cpu", check=False, contract=contract)
    assert [f.rule for f in rep.findings] == [rule]
    assert rep.findings[0].count == 1
    _, clean = opscan.scan_call(runtime.run, gnm_plan, "cpu", check=False, contract=contract)
    assert clean.ok and clean.counts[rule] == 0


def test_f64_is_counted_but_allowed_outside_float32_paths(gnm_plan):
    _, rep = opscan.scan_call(runtime.run, Planted(gnm_plan, "f64-op", tag="f64"), "cpu",
                              check=False)
    assert rep.ok and rep.counts[opscan.RULE_F64] == 1


def test_a_collective_in_a_census_raises_the_reference_text():
    census = {"c10d::allreduce_": 1, "aten::add.Tensor": 2, "kernel::pair_edges": 1}
    rep = opscan.scan_census(census)
    assert [f.rule for f in rep.findings] == [opscan.RULE_COLLECTIVE]
    assert rep.collectives == ["c10d::allreduce_"] and rep.launches == {"pair_edges": 1}
    with pytest.raises(AssertionError, match="generator lowering contains collectives"):
        opscan.assert_communication_free(census)
    with pytest.raises(AssertionError, match="generator lowering contains collectives"):
        opscan.assert_contract(census)
    opscan.assert_communication_free({"aten::add.Tensor": 1})
    assert opscan.classify("_c10d_functional::all_gather_into_tensor") == [opscan.RULE_COLLECTIVE]


def test_an_opaque_kernel_call_is_one_launch(gnm_plan):
    calls = []
    with opscan.trace(calls=calls) as census:
        runtime.run(gnm_plan, "cpu", check=False)
    assert census["kernel::chunk_sample"] == 1 and census["kernel::chunk_decode"] == 1
    assert not any(k.startswith("aten::sort") for k in census)    # the plain version's
    assert [c[0] for c in calls] == ["chunk_sample", "chunk_decode"]
    with opscan.trace(opaque=False) as inside:
        runtime.run(gnm_plan, "cpu", check=False)
    assert inside["kernel::chunk_sample"] == 1
    assert any(k.startswith("aten::sort") for k in inside)


def test_opaque_outside_a_trace_is_the_plain_call():
    from repro_torch.kernels.sampler import ops as S

    assert S.chunk_sample.__wrapped__ is not None
    key = torch.zeros((2, 2), dtype=torch.int32)
    u, c = torch.tensor([10, 5]), torch.tensor([3, 5])
    assert torch.equal(S.chunk_sample(key, u, c, 8), S.chunk_sample.__wrapped__(key, u, c, 8))


# --------------------------------------------------------------------------
# the registry
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cpu_reports():
    return programs.scan_programs(device="cpu")


def test_every_registry_case_is_clean_on_the_cpu(cpu_reports):
    bad = [(r.name, r.error, [f.to_json() for f in r.scan.findings])
           for r in cpu_reports if not r.ok]
    assert not bad, bad
    assert len(cpu_reports) == 27
    assert all(r.flops and r.bytes for r in cpu_reports)
    launched = {k for r in cpu_reports for k in r.launches}
    assert {"chunk_sample", "chunk_decode", "chunk_ba", "chunk_rmat", "pair_edges",
            "cell_points", "pair_mask", "triangulate"} <= launched
    for r in cpu_reports:
        js = r.to_json()
        assert js["ok"] and js["violations"] == [] and json.dumps(js)


def test_registry_names_map_onto_the_reference():
    ref = [(c.name, c.plan_kind, c.mode)
           for c in jprograms.iter_programs(P=4, batch=4, kernels=False)]
    port = [(c.name, c.plan_kind, c.mode)
            for c in programs.iter_programs(P=4, batch=4, kernels=False, device="cpu")]
    assert port == ref
    assert programs.FAMILIES == jprograms.FAMILIES
    kernels = [c.name for c in programs.iter_programs(["kernels"], device="cpu")]
    assert kernels == ["kernels/pairmask/euclid", "kernels/delaunay/triangulate2d",
                       "kernels/delaunay/triangulate3d"]


def test_registry_signatures_are_the_plans():
    specs = programs.small_specs()
    for case in programs.iter_programs(["gnm", "rgg"], device="cpu"):
        fam = specs[case.family]
        plan = fam.plan(4) if case.plan_kind != "point" else fam.point_plan(4)
        assert case.signature == plan.signature()


def test_verify_contracts_front_door():
    spec = tapi.RGG(n=32, radius=0.3, seed=2, chunks=4)
    reports = tapi.verify_contracts(spec, 4, device="cpu")
    assert {r.plan_kind for r in reports} == {"pair", "point"}
    assert {r.mode for r in reports} == {"run", "wave"}
    assert all(r.ok for r in reports)
    ref = japi.verify_contracts(japi.RGG(n=32, radius=0.3, seed=2, chunks=4), 4)
    assert [(r.name, r.plan_kind, r.mode) for r in reports] == \
        [(r.name, r.plan_kind, r.mode) for r in ref]
    assert set(ref[0].to_json()) - {"rng_algorithms"} <= set(reports[0].to_json())


def test_verify_contracts_raises_on_a_violation(monkeypatch, gnm_plan):
    spec = tapi.GNM(n=64, m=128, seed=1, chunks=4)
    monkeypatch.setattr(tapi.GNM, "plan",
                        lambda self, P, **kw: Planted(gnm_plan, "host-callback", tag="vc"))
    monkeypatch.setattr(programs, "_plan_kind", lambda plan: "chunk")
    with pytest.raises(AssertionError, match="host-callback|host reads"):
        tapi.verify_contracts(spec, 4, device="cpu")
    reports = tapi.verify_contracts(spec, 4, device="cpu", raise_on_violation=False)
    assert [r.ok for r in reports] == [False, False]


# --------------------------------------------------------------------------
# check= and mesh=
# --------------------------------------------------------------------------

_REF: dict = {}


def _ref_edges(name: str, P: int) -> np.ndarray:
    if (name, P) not in _REF:
        _REF[name, P] = np.asarray(japi.generate(jprograms.small_specs()[name], P,
                                                 check=False).edges)
    return _REF[name, P]


@pytest.mark.parametrize("check", [True, False])
@pytest.mark.parametrize("name", sorted(programs.small_specs()))
def test_generate_with_and_without_check_matches_the_reference(name, check):
    spec = programs.small_specs()[name]
    runtime.cache_clear()
    g = tapi.generate(spec, 4, device="cpu", check=check)
    np.testing.assert_array_equal(g.edges.numpy(), _ref_edges(name, 4))
    assert bool(runtime._CHECKED) == check


def test_check_scans_an_entry_once(monkeypatch, gnm_plan):
    runtime.cache_clear()
    traced = []
    real = opscan.trace

    def counting(**kw):
        traced.append(1)
        return real(**kw)

    monkeypatch.setattr(opscan, "trace", counting)
    a = runtime.run(gnm_plan, "cpu", check=True)
    b = runtime.run(gnm_plan, "cpu", check=True)
    runtime.run(gnm_plan, "cpu", check=False)
    assert len(traced) == 1
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    list(runtime.stream_waves(gnm_plan, batch=2, device="cpu", check=True))
    list(runtime.stream_waves(gnm_plan, batch=2, device="cpu", check=True))
    assert len(traced) == 2


@pytest.mark.parametrize("plant", ["host-callback", "dynamic-shape", "nondeterministic-rng"])
def test_a_planted_violation_raises_naming_its_rule(gnm_plan, plant):
    runtime.cache_clear()
    planted = Planted(gnm_plan, plant, tag="check")
    with pytest.raises(AssertionError, match=plant):
        runtime.run(planted, "cpu", check=True)
    # a failed scan is not cached as clean: the next checked call scans again
    with pytest.raises(AssertionError, match=plant):
        runtime.run(planted, "cpu", check=True)
    with pytest.raises(AssertionError, match=plant):
        list(runtime.stream_waves(planted, batch=2, device="cpu", check=True))
    runtime.run(planted, "cpu", check=False)        # unchecked, it runs
    list(runtime.stream_slots(planted, device="cpu"))


def test_a_planted_violation_in_a_slab_raises():
    from repro_torch.serve.scheduler import Scheduler
    from repro_torch.serve.sinks import Sink

    runtime.cache_clear()
    sch = Scheduler(1, slab_batch=4, device="cpu")
    sch.enqueue(tapi.GNM(n=64, m=128, seed=3, chunks=4).plan(4), Sink())
    prog, valid, rows = sch.peek_slab()
    bad = Planted(prog, "dynamic-shape", tag="slab")
    with pytest.raises(AssertionError, match="dynamic-shape"):
        runtime.run_slab(bad.slot_fn, bad.signature(), valid, rows, "cpu", check=True)
    runtime.run_slab(prog.slot_fn, prog.signature(), valid, rows, "cpu", check=True)
    assert ("slab", prog.signature()) in {k[:2] for k in runtime._CHECKED}


@pytest.mark.parametrize("name", ["gnm", "rgg", "rdg"])
def test_mesh_rows_leave_the_edges_alone(name):
    spec = programs.small_specs()[name]
    want = _ref_edges(name, 4)
    for D in (1, 2, 4):
        g = tapi.generate(spec, 4, device="cpu", mesh=D)
        np.testing.assert_array_equal(g.edges.numpy(), want)
        per_pe: dict = {}
        for ch in tapi.iter_edge_chunks(spec, 4, device="cpu", mesh=D, batch=2, check=True):
            per_pe.setdefault(ch.pe, []).append(ch.edges())
        got = torch.cat([torch.cat(per_pe[pe]) for pe in sorted(per_pe)])
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="P % devices"):
        tapi.generate(spec, 4, device="cpu", mesh=3)
    with pytest.raises(ValueError, match="P % devices"):
        next(tapi.iter_edge_chunks(spec, 4, device="cpu", mesh=3))


def test_mesh_rows_of_points_and_overlap():
    spec = programs.small_specs()["rhg"]
    base = [(c.pe, c.points()) for c in tapi.iter_points(spec, 4, device="cpu")]
    for D in (2, 4):
        got = sorted(((c.pe, c.points()) for c in tapi.iter_points(spec, 4, device="cpu",
                                                                     mesh=D, check=True)),
                     key=lambda x: x[0])
        assert [p for p, _ in got] == [p for p, _ in base]
        assert all(torch.equal(a, b) for (_, a), (_, b) in zip(got, base))
    sbm = programs.small_specs()["sbm"]
    want = tapi.generate(sbm, 4, device="cpu").edges
    per_pe: dict = {}
    for ch in tapi.iter_edge_chunks(sbm, 4, device="cpu", mesh=2, overlap=2):
        per_pe.setdefault(ch.pe, []).append(ch.edges())
    assert torch.equal(torch.cat([torch.cat(per_pe[pe]) for pe in sorted(per_pe)]), want)


def test_service_with_check_serves_a_fleet_equal_to_generate():
    specs = [tapi.GNM(n=200, m=600, seed=1), tapi.BA(n=150, d=2, seed=2),
             tapi.RGG(n=200, radius=0.15, seed=3), tapi.RHG(n=200, avg_deg=5.0, gamma=2.7,
                                                             seed=4),
             tapi.SBM(n=120, blocks=2, p_in=0.1, p_out=0.01, seed=5),
             tapi.RMAT(log_n=7, m=300, seed=6)]
    runtime.cache_clear()
    graphs = tapi.serve(specs, 4, device="cpu", check=True, slab_batch=4)
    slabs = {k for k in runtime._CHECKED if k[0] == "slab"}
    assert len(slabs) >= 2                   # chunk and pair slab programs, each once
    for spec, g in zip(specs, graphs):
        assert torch.equal(g.edges, tapi.generate(spec, 4, device="cpu").edges), spec


# --------------------------------------------------------------------------
# the CLI gate
# --------------------------------------------------------------------------

def test_cli_fails_on_planted_lint_violation(tmp_path):
    planted = tmp_path / "src" / "repro_torch" / "core"
    planted.mkdir(parents=True)
    (planted / "bad.py").write_text("import numpy as np\ne = np.unique(e, axis=0)\n")
    report = tmp_path / "report.json"
    rc = analyze_main(["--lint", str(planted), "--json", str(report), "--fail-on-violation"])
    assert rc == 1
    data = json.loads(report.read_text())
    assert data["summary"]["violations"] == 1
    assert data["lint"][0]["rule"] == lint.RULE_NP_UNIQUE
    assert not data["summary"]["ok"]


def test_cli_passes_on_the_port_and_writes_a_report(tmp_path):
    report = tmp_path / "report.json"
    rc = analyze_main(["--device", "cpu", "--all-programs", "--lint", "src/repro_torch",
                       "chip_smoke.py", "--json", str(report), "--fail-on-violation"])
    assert rc == 0
    data = json.loads(report.read_text())
    assert data["summary"]["ok"] and data["summary"]["programs_scanned"] == 27
    assert data["lint"] == []


def test_cli_one_family_without_cost():
    assert analyze_main(["--device", "cpu", "--families", "gnm", "--no-cost", "--lint"]) == 0


def test_layering_scanner_and_linter_import_neither_engine_nor_api():
    """``opscan`` and ``lint`` load without the engine or the API (the
    kernels import the scanner); ``programs`` loads lazily."""
    code = ("import sys, repro_torch.analyze as a\n"
            "bad = sorted(m for m in sys.modules if m.startswith('repro_torch.') and "
            "not m.startswith('repro_torch.analyze'))\n"
            "assert not bad and 'repro_torch.analyze.programs' not in sys.modules, bad\n"
            "a.programs\n"
            "assert 'repro_torch.analyze.programs' in sys.modules\nprint('layered')")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env={**os.environ, "PYTHONPATH": "src"}, timeout=120)
    assert r.returncode == 0 and "layered" in r.stdout, r.stderr
