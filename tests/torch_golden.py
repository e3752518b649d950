"""Golden values of the JAX package for the PyTorch port's card check.

The machine with the card has no JAX, so ``chip_smoke.py`` holds the
port against values that the JAX package computed on the CPU and that
this script writes into ``src/repro_torch/golden/er.json``:

* SHA-256 digests of ``repro.api.generate(spec, P).edges`` (little-endian
  int64, C order) for small G(n, m) / G(n, p) specs, directed and
  undirected, at P in {1, 8}, and for one mid-size spec at P = 1;
* the exact degree statistics of ``repro.stats.collect`` for one G(n, p).

Run from the root of the repository (the mid-size spec takes about ten
seconds of CPU)::

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_golden.py

``tests/test_torch_golden.py`` checks that the JAX package still
reproduces every entry except the mid-size one.
"""
from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np

GOLDEN = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "golden" / "er.json"
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


def main() -> None:
    entries = [generate_entry(f, p, P, "small") for f, p in SMALL for P in SMALL_PES]
    entries.append(generate_entry(*MID, 1, "mid"))
    doc = {"command": COMMAND,
           "digest": "sha256 of edges as little-endian int64 [m, 2], C order",
           "generate": entries,
           "collect": [collect_entry(*COLLECT, 1)]}
    GOLDEN.write_text(json.dumps(doc, indent=1) + "\n")
    print(f"wrote {GOLDEN}")


if __name__ == "__main__":
    main()
