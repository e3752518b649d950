"""Golden values of the JAX package for the PyTorch port's card check.

The machine with the card has no JAX, so ``chip_smoke.py`` holds the
port against values that the JAX package computed on the CPU and that
this script writes into ``src/repro_torch/golden/er.json``:

* SHA-256 digests of ``repro.api.generate(spec, P).edges`` (little-endian
  int64, C order) for small G(n, m) / G(n, p) specs, directed and
  undirected, at P in {1, 8}, and for one mid-size spec at P = 1;
* the exact degree statistics of ``repro.stats.collect`` for one G(n, p);

and, into ``src/repro_torch/golden/geom.json``:

* edge digests of small RGG (2-D, 3-D) and RHG specs at P in {1, 8} and
  of one mid-size RGG (n = 2^16) at P = 1;
* digests of ``repro.api.iter_points`` (float64 positions in stream
  order; for RHG the radii and the angles);
* the reference's hyperbolic features ``[cos θ, sin θ, coth r, 1/sinh r]``
  and radii of a few RHG candidate-pair rows, as hex floats;
and, into ``src/repro_torch/golden/rdg.json``:
* for one 2-D RDG spec (at P in {1, 8}) and one 3-D RDG spec (P = 1,
  mid-size), the digests of the edges, of every table of the plan
  (``spec.plan(P)``) and of ``generate(..., return_points=True).points``,
  and the path the spec's planning takes: the batched triangulation's
  halo rounds, the rows of each round that came back ``ok``, and the
  chunks that ran Qhull because their region wraps the torus;
and, into ``src/repro_torch/golden/families.json``:
* edge digests of small BA, R-MAT and SBM specs at P in {1, 3} and of
  one mid-size spec of each at P = 1;
* the sampled clustering reports of ``collect(..., metrics=("degree",
  "clustering"))`` for a G(n, p) and a small RHG;
and, into ``src/repro_torch/golden/data.json``:
* SHA-256 digests of the LM data pipeline's batches
  (``repro.data.pipeline.make_global_batch``: tokens, labels and
  positions as little-endian int32) at the data config of
  ``repro.launch.train`` (``rhg_walk``, n = 4096, sequences of 256,
  four a shard, seed 11, Qwen3-0.6B's vocabulary) with 1 and 4 shards,
  steps 0 to 3, and of one ``er_walk`` batch;
and, into ``src/repro_torch/golden/stats.json``:
* the ``repro.stats.validate`` reports of the reference's two acceptance
  gates (G(n, p) and RHG at n = 2^18, P = 8; mid-size) and of its four
  smoke families (P = 4; small): every check's name, flag, detail and
  ``observed``/``expected``/``pvalue`` as hex floats, and ``str(report)``.

Run from the root of the repository (the mid-size specs take about a
minute of CPU)::

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_golden.py

``tests/test_torch_golden.py`` checks that the JAX package still
reproduces every entry except the mid-size ones.
"""
from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np

GOLDEN = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "golden" / "er.json"
GEOM = GOLDEN.with_name("geom.json")
RDG = GOLDEN.with_name("rdg.json")
FAMILIES = GOLDEN.with_name("families.json")
STATS = GOLDEN.with_name("stats.json")
DATA = GOLDEN.with_name("data.json")
COMMAND = "PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_golden.py"

SMALL = [
    ("GNM", dict(n=1 << 12, m=1 << 15, directed=False, seed=7)),
    ("GNM", dict(n=1 << 12, m=1 << 15, directed=True, seed=7)),
    ("GNP", dict(n=1 << 12, p=8 / (1 << 12), directed=False, seed=9)),
    ("GNP", dict(n=1 << 12, p=8 / (1 << 12), directed=True, seed=9)),
]
SMALL_PES = (1, 8)
MID = ("GNM", dict(n=1 << 20, m=1 << 24, directed=False, seed=1))
COLLECT = ("GNP", dict(n=1 << 14, p=16 / (1 << 14), directed=False, seed=3))


GEOM_SMALL = [
    ("RGG", dict(n=1 << 12, radius=0.03, dim=2, seed=17)),
    ("RGG", dict(n=1 << 12, radius=0.08, dim=3, seed=18)),
    ("RHG", dict(n=1 << 12, avg_deg=16.0, gamma=2.8, seed=19)),
]
GEOM_MID = ("RGG", dict(n=1 << 16, radius=0.55 * (np.log(1 << 16) / (1 << 16)) ** 0.5,
                        dim=2, seed=4))
RDG_SMALL = ("RDG", dict(n=1 << 13, dim=2, seed=21))
RDG_MID = ("RDG", dict(n=1 << 13, dim=3, seed=22))
FAM_SMALL = [
    ("BA", dict(n=1 << 10, d=4, seed=31)),
    ("RMAT", dict(log_n=12, m=1 << 14, probs=[0.57, 0.19, 0.19, 0.05], seed=32)),
    ("SBM", dict(n=1 << 11, blocks=8, p_in=0.02, p_out=0.001, seed=33)),
]
FAM_PES = (1, 3)
FAM_MID = [
    ("BA", dict(n=1 << 16, d=8, seed=9)),
    ("RMAT", dict(log_n=18, m=1 << 22, probs=[0.57, 0.19, 0.19, 0.05], seed=8)),
    ("SBM", dict(n=1 << 16, blocks=16, p_in=2.0 ** -9, p_out=2.0 ** -13, seed=10)),
]
CLUSTER = [
    ("GNP", dict(n=300, p=0.05, directed=False, seed=9)),
    ("RHG", dict(n=1 << 11, avg_deg=8.0, gamma=2.6, seed=23)),
]
CLUSTER_P = 2
CLUSTER_FIELDS = ("sample", "degree", "triangles", "wedges", "valid")
PAIR_FIELDS = ("kind", "key_a", "key_b", "count_a", "count_b", "gid_a", "gid_b",
               "geom_a", "geom_b", "fparams", "self_pair", "active")
# (family, spec params, P, validate kwargs, size): tests/test_stats.py's
# acceptance gates (mid) and smoke families (small)
VALIDATE = [
    ("GNP", dict(n=1 << 18, p=20.0 / (1 << 18), seed=11), 8, {}, "mid"),
    ("RHG", dict(n=1 << 18, avg_deg=6.0, gamma=2.7, seed=2), 8, dict(batch=512), "mid"),
    ("GNM", dict(n=2048, m=8192, seed=5), 4, {}, "small"),
    ("BA", dict(n=2048, d=4, seed=7), 4, {}, "small"),
    ("SBM", dict(n=1500, blocks=5, p_in=0.03, p_out=0.003, seed=3), 4, {}, "small"),
    ("RMAT", dict(log_n=11, m=16000, seed=1), 4, {}, "small"),
]
# launch/train.py's DataConfig at qwen3_0p6b's vocabulary: (params, steps)
DATA_BASE = dict(kind="rhg_walk", n_vertices=4096, vocab=151936, seq_len=256,
                 batch_per_shard=4, seed=11)
DATA_CONFIGS = [(dict(DATA_BASE, num_shards=1), (0, 1, 2, 3)),
                (dict(DATA_BASE, num_shards=4), (0, 1, 2, 3)),
                (dict(DATA_BASE, kind="er_walk", num_shards=4), (0,))]
POINTS_P = 3
FEATURE_ROWS = 16     # RHG candidate-pair rows whose side-a features are kept


def edges_sha256(edges: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(edges, "<i8").tobytes()).hexdigest()


def generate_entry(family: str, params: dict, P: int, size: str) -> dict:
    from repro import api

    edges = api.generate(getattr(api, family)(**params), P).edges
    return {"family": family, "params": params, "P": P, "size": size,
            "m": int(len(edges)), "sha256": edges_sha256(edges)}


def collect_entry(family: str, params: dict, P: int) -> dict:
    from repro import api, stats

    rep = stats.collect(getattr(api, family)(**params), P)
    d = rep.degree
    return {"family": family, "params": params, "P": P,
            "num_edges": int(rep.num_edges), "log2_hist": [int(x) for x in d.log2_hist],
            "deg_sum": int(d.deg_sum), "deg_sumsq": int(d.deg_sumsq),
            "deg_max": int(d.deg_max), "num_isolated": int(d.num_isolated),
            "degrees_sha256": edges_sha256(d.degrees),
            "degree_counts": [int(x) for x in rep.degree_counts()]}


def floats_sha256(x: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(x, "<f8").tobytes()).hexdigest()


def points_entry(family: str, params: dict, P: int) -> dict:
    """Digest of ``iter_points`` in stream order."""
    from repro import api

    pts = np.concatenate([c.points() for c in api.iter_points(
        getattr(api, family)(**params), P, batch=64)])
    return {"family": family, "params": params, "P": P, "n": int(len(pts)),
            "what": "points", "sha256": floats_sha256(pts)}


def jax_hyp_features(kd, geom, scale, N):
    """The reference engine's feature decode (``_pair_fn``'s
    ``hyp_features``), with the radius appended: ``[N, 5]``."""
    import jax
    import jax.numpy as jnp
    from repro.core.prng import counter_uniform

    key = jax.random.wrap_key_data(kd, impl="threefry2x32")
    u = counter_uniform(key, N, 2)
    clo, chi, ci, w = geom[0], geom[1], geom[2], geom[3]
    r = jnp.arccosh(clo + u[:, 0] * (chi - clo)) / scale
    theta = (ci + u[:, 1]) * w
    r = jnp.maximum(r, 1e-12)
    sh = jnp.sinh(r)
    return jnp.stack([jnp.cos(theta), jnp.sin(theta), jnp.cosh(r) / sh, 1.0 / sh, r],
                     axis=-1)


def feature_rows(plan, rows: int):
    """(row indices, key_a, geom_a, alpha, count_a) of ``rows`` active
    rows of PE 0 of a GEOM_HYP pair plan, spread evenly over the plan
    (so over the rings)."""
    act = np.argwhere(plan.active[0])[:, 0]
    idx = act[np.linspace(0, len(act) - 1, rows).astype(np.int64)]
    return (idx, plan.key_a[0, idx], plan.geom_a[0, idx], plan.fparams[0, idx, 0],
            plan.count_a[0, idx])


FEATURE_NAMES = ["cos", "sin", "coth", "1/sinh", "r"]


def features_entry(family: str, params: dict) -> dict:
    import jax
    from repro import api

    plan = getattr(api, family)(**params).plan(1)
    idx, kd, geom, alpha, cnt = feature_rows(plan, FEATURE_ROWS)
    N = plan.capacity
    want = np.asarray(jax.jit(jax.vmap(lambda k, g, s: jax_hyp_features(k, g, s, N)))(
        kd, geom, alpha))
    valid = np.arange(N)[None, :] < cnt[:, None]
    return {"family": family, "params": params, "P": 1, "rows": [int(i) for i in idx],
            "features": FEATURE_NAMES,
            "values": [[[float(x).hex() for x in want[k, i]] for i in range(N) if valid[k, i]]
                       for k in range(len(idx))]}


def geom_doc() -> dict:
    entries = [generate_entry(f, p, P, "small") for f, p in GEOM_SMALL for P in SMALL_PES]
    entries.append(generate_entry(*GEOM_MID, 1, "mid"))
    return {"command": COMMAND,
            "digest": "sha256 of edges as little-endian int64 [m, 2] / of points as "
                      "little-endian float64, C order",
            "generate": entries,
            "points": [points_entry(f, p, POINTS_P) for f, p in GEOM_SMALL],
            "rhg_features": features_entry(*GEOM_SMALL[2])}


def array_sha256(a: np.ndarray) -> str:
    """Digest of an array as stored: its dtype in little-endian, C order."""
    a = np.ascontiguousarray(a)
    return hashlib.sha256(a.astype(a.dtype.newbyteorder("<")).tobytes()).hexdigest()


def rdg_entry(family: str, params: dict, P: int, size: str) -> dict:
    """Edge, table and point digests of one RDG spec, and its planning
    path (halo rounds of the batched triangulation, chunks on Qhull)."""
    from repro import api
    from repro.core import rdg
    from repro.kernels import delaunay

    path = {"batched_rounds": 0, "ok_rows": [], "qhull_chunks": 0}
    batched, certified = delaunay.batched_delaunay, rdg._certified_triangulation

    def count_round(points, counts, **k):
        path["batched_rounds"] += 1
        out = batched(points, counts, **k)
        path["ok_rows"].append(int(np.asarray(out[2])[np.asarray(counts) > 0].sum()))
        return out

    def count_qhull(*a, **k):
        path["qhull_chunks"] += 1
        return certified(*a, **k)

    rdg.rdg_structure.cache_clear()
    delaunay.batched_delaunay, rdg._certified_triangulation = count_round, count_qhull
    try:
        spec = getattr(api, family)(**params)
        plan = spec.plan(P)
    finally:
        delaunay.batched_delaunay, rdg._certified_triangulation = batched, certified
    g = api.generate(spec, P, return_points=True)
    return {"family": family, "params": params, "P": P, "size": size,
            "m": int(len(g.edges)), "sha256": edges_sha256(np.asarray(g.edges)),
            "points_sha256": floats_sha256(np.asarray(g.points)),
            "tables": {f: array_sha256(getattr(plan, f)) for f in PAIR_FIELDS},
            "pairs_per_pe": int(plan.pairs_per_pe), "path": path}


def rdg_doc() -> dict:
    entries = [rdg_entry(*RDG_SMALL, P, "small") for P in SMALL_PES]
    entries.append(rdg_entry(*RDG_MID, 1, "mid"))
    return {"command": COMMAND,
            "digest": "sha256 of edges as little-endian int64 [m, 2], of points as "
                      "little-endian float64 [n, dim], of each plan table as stored "
                      "(little-endian, C order)",
            "generate": entries}


def family_entry(family: str, params: dict, P: int, size: str) -> dict:
    """:func:`generate_entry` with ``probs`` as the tuple the spec takes."""
    from repro import api

    kw = dict(params, probs=tuple(params["probs"])) if "probs" in params else params
    edges = api.generate(getattr(api, family)(**kw), P).edges
    return {"family": family, "params": params, "P": P, "size": size,
            "m": int(len(edges)), "sha256": edges_sha256(edges)}


def cluster_entry(family: str, params: dict, P: int) -> dict:
    """The clustering report of ``collect`` at the default sample."""
    from repro import api, stats

    rep = stats.collect(getattr(api, family)(**params), P, metrics=("degree", "clustering"))
    c = rep.clustering
    return {"family": family, "params": params, "P": P, "num_edges": int(rep.num_edges),
            **{f: [int(x) for x in getattr(c, f)] for f in CLUSTER_FIELDS}}


def families_doc() -> dict:
    entries = [family_entry(f, p, P, "small") for f, p in FAM_SMALL for P in FAM_PES]
    entries += [family_entry(f, p, 1, "mid") for f, p in FAM_MID]
    return {"command": COMMAND,
            "digest": "sha256 of edges as little-endian int64 [m, 2], C order",
            "generate": entries,
            "clustering": [cluster_entry(f, p, CLUSTER_P) for f, p in CLUSTER]}


def hex_or_none(x):
    return None if x is None else float(x).hex()


def report_entry(report) -> dict:
    """A validation report as stored: each check's floats as hex, and the
    report's text line by line."""
    return {"family": report.family, "P": int(report.P), "passed": bool(report.passed),
            "num_edges": int(report.stats.num_edges), "mode": report.stats.mode,
            "checks": [{"name": c.name, "passed": bool(c.passed),
                        "observed": float(c.observed).hex(),
                        "expected": float(c.expected).hex(),
                        "pvalue": hex_or_none(c.pvalue), "detail": c.detail}
                       for c in report.checks],
            "str": str(report).splitlines()}


def validate_entry(family: str, params: dict, P: int, kwargs: dict, size: str) -> dict:
    from repro import api, stats

    rep = stats.validate(getattr(api, family)(**params), P, **kwargs)
    return {"params": params, "kwargs": kwargs, "size": size, **report_entry(rep)}


def stats_doc() -> dict:
    return {"command": COMMAND,
            "floats": "float.hex() of float64",
            "validate": [validate_entry(*v) for v in VALIDATE]}


def batch_digests(batch: dict) -> dict:
    """SHA-256 of each array of a batch as little-endian int32, C order."""
    return {k: hashlib.sha256(np.ascontiguousarray(batch[k], "<i4").tobytes()).hexdigest()
            for k in ("tokens", "labels", "positions")}


def data_entry(params: dict, step: int) -> dict:
    from repro.data import pipeline

    batch = pipeline.make_global_batch(pipeline.DataConfig(**params), step)
    return {"params": params, "step": step, "shape": list(batch["tokens"].shape),
            **batch_digests(batch)}


def data_doc() -> dict:
    return {"command": COMMAND,
            "digest": "sha256 of tokens, labels, positions as little-endian int32 [B, S], "
                      "C order",
            "batches": [data_entry(p, s) for p, steps in DATA_CONFIGS for s in steps]}


def main() -> None:
    entries = [generate_entry(f, p, P, "small") for f, p in SMALL for P in SMALL_PES]
    entries.append(generate_entry(*MID, 1, "mid"))
    doc = {"command": COMMAND,
           "digest": "sha256 of edges as little-endian int64 [m, 2], C order",
           "generate": entries,
           "collect": [collect_entry(*COLLECT, 1)]}
    GOLDEN.write_text(json.dumps(doc, indent=1) + "\n")
    print(f"wrote {GOLDEN}")
    GEOM.write_text(json.dumps(geom_doc(), indent=1) + "\n")
    print(f"wrote {GEOM}")
    RDG.write_text(json.dumps(rdg_doc(), indent=1) + "\n")
    print(f"wrote {RDG}")
    FAMILIES.write_text(json.dumps(families_doc(), indent=1) + "\n")
    print(f"wrote {FAMILIES}")
    STATS.write_text(json.dumps(stats_doc(), indent=1) + "\n")
    print(f"wrote {STATS}")
    DATA.write_text(json.dumps(data_doc(), indent=1) + "\n")
    print(f"wrote {DATA}")


if __name__ == "__main__":
    main()
