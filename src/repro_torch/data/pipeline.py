"""Communication-free data pipeline (port of ``repro.data.pipeline``):
every data-parallel shard synthesizes its own token stream from a graph
it generates locally, so any batch is a pure function of (seed, step,
shard):

* deterministic resume: a restart needs only ``step``;
* elastic: a change of shard count re-maps streams without moving data;
* infinite: the graph families scale far past any corpus.

Corpus: random walks over the shard's local RHG or ER subgraph,
tokenized by vertex id (mod vocab) with a separator token between walks.
The graph is generated on the card (``rhg_pe`` tests adjacency with
``hyp_edges``; ``gnm_undirected_pe`` samples with ``chunk_sample`` and
decodes with ``chunk_decode``); the walks are host numpy over
:func:`repro_torch.core.prng.host_rng`, so the tokens equal the
reference's bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, Tuple

import numpy as np

from ..core import er, rhg
from ..core.prng import host_rng
from ..kernels.build import resolve_device


@dataclass(frozen=True)
class DataConfig:
    kind: str = "rhg_walk"      # rhg_walk | er_walk
    n_vertices: int = 4096
    avg_deg: float = 16.0
    gamma: float = 2.6
    vocab: int = 256
    seq_len: int = 128
    batch_per_shard: int = 4
    num_shards: int = 1         # virtual DP shards (elastic-safe)
    seed: int = 0


@lru_cache(maxsize=64)
def _local_graph(cfg: DataConfig, shard: int, device: str) -> Tuple[np.ndarray, np.ndarray]:
    """CSR adjacency of the shard's locally generated subgraph."""
    if cfg.kind == "rhg_walk":
        params = rhg.RHGParams(cfg.n_vertices, cfg.avg_deg, cfg.gamma, cfg.seed)
        edges, _, _, _ = rhg.rhg_pe(params, cfg.num_shards, shard, device=device)
    else:
        m = int(cfg.n_vertices * cfg.avg_deg / 2)
        edges = er.gnm_undirected_pe(cfg.seed, cfg.n_vertices, m, cfg.num_shards, shard,
                                     device=device)
    # symmetrize -> CSR over the vertices present locally
    both = np.concatenate([edges, edges[:, ::-1]], axis=0)
    order = np.lexsort((both[:, 1], both[:, 0]))
    both = both[order]
    indptr = np.zeros(cfg.n_vertices + 1, np.int64)
    np.add.at(indptr, both[:, 0] + 1, 1)
    indptr = np.cumsum(indptr)
    return indptr, both[:, 1]


def make_batch(cfg: DataConfig, step: int, shard: int, device=None) -> Dict[str, np.ndarray]:
    """Pure function (seed, step, shard) -> {tokens, labels, positions};
    the shard's graph is generated on ``device`` (CUDA unless the caller
    passes ``"cpu"``) once and cached."""
    indptr, nbrs = _local_graph(cfg, shard, str(resolve_device(device)))
    rng = host_rng(cfg.seed, 71, step, shard)
    B, S = cfg.batch_per_shard, cfg.seq_len
    deg = np.diff(indptr)
    starts_pool = np.nonzero(deg > 0)[0]
    toks = np.zeros((B, S + 1), np.int64)
    sep = cfg.vocab - 1
    for b in range(B):
        t = 0
        while t < S + 1:
            v = int(starts_pool[rng.integers(len(starts_pool))])
            walk_len = min(S + 1 - t, int(rng.integers(8, 64)))
            for _ in range(walk_len):
                toks[b, t] = v % (cfg.vocab - 1)
                t += 1
                d = indptr[v + 1] - indptr[v]
                if d == 0 or t >= S + 1:
                    break
                v = int(nbrs[indptr[v] + rng.integers(d)])
            if t < S + 1:
                toks[b, t] = sep
                t += 1
    return {
        "tokens": toks[:, :S].astype(np.int32),
        "labels": toks[:, 1:].astype(np.int32),
        "positions": np.tile(np.arange(S, dtype=np.int32), (B, 1)),
    }


def make_global_batch(cfg: DataConfig, step: int, device=None) -> Dict[str, np.ndarray]:
    """Concatenated over shards (single-host convenience)."""
    parts = [make_batch(cfg, step, s, device) for s in range(cfg.num_shards)]
    return {k: np.concatenate([p[k] for p in parts], axis=0) for k in parts[0]}
