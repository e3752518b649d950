"""The golden values that ``chip_smoke.py`` holds the card against.

``src/repro_torch/golden/er.json`` records, from the JAX package on the
CPU, SHA-256 digests of ``generate(spec, P).edges`` and the exact degree
statistics of one ``collect``; ``geom.json`` the RGG and RHG edge
digests, ``iter_points`` digests and a sample of RHG features;
``rdg.json`` the RDG edge, plan-table and point digests and each spec's
planning path; ``families.json`` the BA, R-MAT and SBM edge digests and
two sampled clustering reports; ``stats.json`` six ``validate`` reports
(floats as hex, compared exactly); ``data.json`` the LM data pipeline's
batch digests (tokens, labels, positions).  The JAX
package must still reproduce every entry except the mid-size ones (the
command is in the files), and the port on the CPU must reproduce the
small ones.  Digests, integers and the port's RHG features are compared
exactly.
"""
import json

import numpy as np
import pytest
import torch

import torch_golden
from repro_torch import api as tapi

# one intra-op thread: the suite runs in several worker processes at once,
# and a pool of one thread per core in each of them oversubscribes the CPU
torch.set_num_threads(1)

DOC = json.loads(torch_golden.GOLDEN.read_text())
SMALL = [e for e in DOC["generate"] if e["size"] == "small"]
GEOM = json.loads(torch_golden.GEOM.read_text())
GEOM_SMALL = [e for e in GEOM["generate"] if e["size"] == "small"]
RDG = json.loads(torch_golden.RDG.read_text())
RDG_SMALL = [e for e in RDG["generate"] if e["size"] == "small"]
FAM = json.loads(torch_golden.FAMILIES.read_text())
FAM_SMALL = [e for e in FAM["generate"] if e["size"] == "small"]
STATS = json.loads(torch_golden.STATS.read_text())
STATS_SMALL = [e for e in STATS["validate"] if e["size"] == "small"]


def _id(e):
    return f"{e['family']}-{'d' if e['params']['directed'] else 'u'}-P{e['P']}"


def _geom_id(e):
    return f"{e['family']}-{e['params'].get('dim', 2)}d-P{e['P']}"


def test_the_file_names_its_command_and_entries():
    assert DOC["command"] == torch_golden.COMMAND
    assert [(e["family"], e["params"], e["P"]) for e in SMALL] == [
        (f, p, P) for f, p in torch_golden.SMALL for P in torch_golden.SMALL_PES]
    mid = [e for e in DOC["generate"] if e["size"] == "mid"]
    assert [(e["family"], e["params"]) for e in mid] == [torch_golden.MID]
    assert mid[0]["m"] == torch_golden.MID[1]["m"]


@pytest.mark.parametrize("entry", SMALL, ids=_id)
def test_reference_reproduces_generate_digest(entry):
    assert torch_golden.generate_entry(entry["family"], entry["params"], entry["P"],
                                       "small") == entry


@pytest.mark.parametrize("entry", SMALL, ids=_id)
def test_port_reproduces_generate_digest_on_cpu(entry):
    spec = getattr(tapi, entry["family"])(**entry["params"])
    edges = tapi.generate(spec, entry["P"], device="cpu").edges.numpy()
    assert len(edges) == entry["m"]
    assert torch_golden.edges_sha256(edges) == entry["sha256"]


def test_reference_reproduces_collect():
    (entry,) = DOC["collect"]
    assert torch_golden.collect_entry(entry["family"], entry["params"], entry["P"]) == entry


def test_the_geom_file_names_its_command_and_entries():
    assert GEOM["command"] == torch_golden.COMMAND
    assert [(e["family"], e["params"], e["P"]) for e in GEOM_SMALL] == [
        (f, p, P) for f, p in torch_golden.GEOM_SMALL for P in torch_golden.SMALL_PES]
    mid = [e for e in GEOM["generate"] if e["size"] == "mid"]
    assert [(e["family"], e["params"]) for e in mid] == [torch_golden.GEOM_MID]
    assert [(e["family"], e["params"]) for e in GEOM["points"]] == torch_golden.GEOM_SMALL


@pytest.mark.parametrize("entry", GEOM_SMALL, ids=_geom_id)
def test_reference_reproduces_geom_digest(entry):
    assert torch_golden.generate_entry(entry["family"], entry["params"], entry["P"],
                                       "small") == entry


@pytest.mark.parametrize("entry", GEOM_SMALL, ids=_geom_id)
def test_port_reproduces_geom_digest_on_cpu(entry):
    spec = getattr(tapi, entry["family"])(**entry["params"])
    edges = tapi.generate(spec, entry["P"], device="cpu").edges.numpy()
    assert len(edges) == entry["m"]
    assert torch_golden.edges_sha256(edges) == entry["sha256"]


@pytest.mark.parametrize("entry", GEOM["points"], ids=lambda e: e["family"] + str(
    e["params"].get("dim", 2)))
def test_points_digests(entry):
    assert torch_golden.points_entry(entry["family"], entry["params"], entry["P"]) == entry
    spec = getattr(tapi, entry["family"])(**entry["params"])
    pts = torch.cat([c.points() for c in tapi.iter_points(spec, entry["P"], device="cpu",
                                                          batch=64)]).numpy()
    assert len(pts) == entry["n"]
    got = pts[:, 1] if entry["what"] == "theta" else pts
    assert torch_golden.floats_sha256(got) == entry["sha256"]


def test_rhg_features_sample():
    """The reference still gives the stored features and radii, and the
    port's plain version gives them bit for bit."""
    from repro import api as japi
    from repro_torch.kernels.geom.ref import hyp_features, hyp_radius_theta

    e = GEOM["rhg_features"]
    assert torch_golden.features_entry(e["family"], e["params"]) == e
    plan = getattr(japi, e["family"])(**e["params"]).plan(1)
    idx = np.asarray(e["rows"])
    key, geom, alpha = (torch.from_numpy(x) for x in (
        plan.key_a[0, idx].astype(np.int64), plan.geom_a[0, idx], plan.fparams[0, idx, 0]))
    N = plan.capacity
    got = torch.cat([hyp_features(key, geom, alpha, N),
                     hyp_radius_theta(key, geom, alpha, N)[0][..., None]], dim=-1).numpy()
    valid = np.arange(N)[None, :] < plan.count_a[0, idx][:, None]
    want = [[float.fromhex(x) for x in slot] for row in e["values"] for slot in row]
    assert [[float(x).hex() for x in slot] for slot in got[valid]] == [
        [float(x).hex() for x in slot] for slot in want]


def port_rdg_entry(family: str, params: dict, P: int, size: str) -> dict:
    """:func:`torch_golden.rdg_entry` computed by the port on the CPU."""
    from repro_torch.core import rdg

    rdg.rdg_structure.cache_clear()
    spec = getattr(tapi, family)(**params)
    plan = spec.plan(P, device="cpu")
    st = rdg.rdg_structure(spec.n, P, spec.dim, "threefry2x32", 0, 8)
    g = tapi.generate(spec, P, device="cpu", return_points=True)
    return {"family": family, "params": params, "P": P, "size": size, "m": int(len(g.edges)),
            "sha256": torch_golden.edges_sha256(g.edges.numpy()),
            "points_sha256": torch_golden.floats_sha256(g.points.numpy()),
            "tables": {f: torch_golden.array_sha256(getattr(plan, f))
                       for f in torch_golden.PAIR_FIELDS},
            "pairs_per_pe": int(plan.pairs_per_pe),
            "path": {"batched_rounds": st.last_rounds, "ok_rows": st.last_ok_rows,
                     "qhull_chunks": st.last_qhull_chunks}}


def test_the_rdg_file_names_its_command_and_entries():
    assert RDG["command"] == torch_golden.COMMAND
    assert [(e["family"], e["params"], e["P"]) for e in RDG_SMALL] == [
        (*torch_golden.RDG_SMALL, P) for P in torch_golden.SMALL_PES]
    mid = [e for e in RDG["generate"] if e["size"] == "mid"]
    assert [(e["family"], e["params"]) for e in mid] == [torch_golden.RDG_MID]
    for e in RDG["generate"]:
        assert e["m"] == 3 * e["params"]["n"] or e["params"]["dim"] == 3
        assert set(e["tables"]) == set(torch_golden.PAIR_FIELDS)
    assert mid[0]["path"]["batched_rounds"] >= 1          # the 3-D spec runs the kernel


@pytest.mark.parametrize("entry", RDG_SMALL, ids=lambda e: f"P{e['P']}")
def test_reference_reproduces_rdg_entry(entry):
    assert torch_golden.rdg_entry(entry["family"], entry["params"], entry["P"],
                                  "small") == entry


@pytest.mark.parametrize("entry", RDG_SMALL, ids=lambda e: f"P{e['P']}")
def test_port_reproduces_rdg_entry_on_cpu(entry):
    assert port_rdg_entry(entry["family"], entry["params"], entry["P"], "small") == entry


def _fam_spec(api, e):
    p = e["params"]
    return getattr(api, e["family"])(**(dict(p, probs=tuple(p["probs"])) if "probs" in p else p))


def test_the_families_file_names_its_command_and_entries():
    assert FAM["command"] == torch_golden.COMMAND
    assert [(e["family"], e["params"], e["P"]) for e in FAM_SMALL] == [
        (f, p, P) for f, p in torch_golden.FAM_SMALL for P in torch_golden.FAM_PES]
    mid = [e for e in FAM["generate"] if e["size"] == "mid"]
    assert [(e["family"], e["params"]) for e in mid] == torch_golden.FAM_MID
    assert [(e["family"], e["params"], e["P"]) for e in FAM["clustering"]] == [
        (f, p, torch_golden.CLUSTER_P) for f, p in torch_golden.CLUSTER]


@pytest.mark.parametrize("entry", FAM_SMALL, ids=lambda e: f"{e['family']}-P{e['P']}")
def test_reference_and_port_reproduce_family_digest(entry):
    assert torch_golden.family_entry(entry["family"], entry["params"], entry["P"],
                                     "small") == entry
    edges = tapi.generate(_fam_spec(tapi, entry), entry["P"], device="cpu").edges.numpy()
    assert len(edges) == entry["m"]
    assert torch_golden.edges_sha256(edges) == entry["sha256"]


@pytest.mark.parametrize("entry", FAM["clustering"], ids=lambda e: e["family"])
def test_reference_and_port_reproduce_clustering(entry):
    assert torch_golden.cluster_entry(entry["family"], entry["params"], entry["P"]) == entry
    rep = tapi.collect(getattr(tapi, entry["family"])(**entry["params"]), entry["P"],
                       metrics=("degree", "clustering"), device="cpu")
    assert rep.num_edges == entry["num_edges"]
    for f in torch_golden.CLUSTER_FIELDS:
        assert [int(x) for x in getattr(rep.clustering, f)] == entry[f], f


def test_the_stats_file_names_its_command_and_entries():
    assert STATS["command"] == torch_golden.COMMAND
    assert [(e["family"], e["params"], e["P"], e["kwargs"], e["size"])
            for e in STATS["validate"]] == [tuple(v) for v in torch_golden.VALIDATE]
    for e in STATS["validate"]:
        assert e["passed"] and all(c["passed"] for c in e["checks"])
        assert len(e["str"]) == 1 + len(e["checks"])


@pytest.mark.parametrize("entry", STATS_SMALL, ids=lambda e: f"{e['family']}-P{e['P']}")
def test_reference_and_port_reproduce_validate_report(entry):
    assert torch_golden.validate_entry(entry["family"], entry["params"], entry["P"],
                                       entry["kwargs"], "small") == entry
    rep = tapi.validate(getattr(tapi, entry["family"])(**entry["params"]), entry["P"],
                        device="cpu", **entry["kwargs"])
    got = {"params": entry["params"], "kwargs": entry["kwargs"], "size": "small",
           **torch_golden.report_entry(rep)}
    assert got == entry


DATA = json.loads(torch_golden.DATA.read_text())


def _data_id(e):
    p = e["params"]
    return f"{p['kind']}-shards{p['num_shards']}-step{e['step']}"


def test_the_data_file_names_its_command_and_entries():
    assert DATA["command"] == torch_golden.COMMAND
    assert [(e["params"], e["step"]) for e in DATA["batches"]] == [
        (p, s) for p, steps in torch_golden.DATA_CONFIGS for s in steps]
    for e in DATA["batches"]:
        p = e["params"]
        assert e["shape"] == [p["batch_per_shard"] * p["num_shards"], p["seq_len"]]


@pytest.mark.parametrize("entry", DATA["batches"], ids=_data_id)
def test_reference_reproduces_data_digest(entry):
    assert torch_golden.data_entry(entry["params"], entry["step"]) == entry


@pytest.mark.parametrize("entry", DATA["batches"], ids=_data_id)
def test_port_reproduces_data_digest_on_cpu(entry):
    from repro_torch.data import pipeline

    batch = pipeline.make_global_batch(pipeline.DataConfig(**entry["params"]), entry["step"],
                                       device="cpu")
    assert list(batch["tokens"].shape) == entry["shape"]
    assert torch_golden.batch_digests(batch) == {k: entry[k] for k in
                                                 ("tokens", "labels", "positions")}
