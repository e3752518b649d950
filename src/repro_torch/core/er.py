"""Erdős-Rényi plan emitters: G(n,m) and G(n,p), directed and undirected
(port of the plan half of ``repro.core.er``, paper §4).

Every emitter runs the host divide-and-conquer recursion and packs the
resulting (key, universe, count, decode params) rows into a ChunkPlan
that equals the reference's field by field: the counts come from the
same numpy Philox streams, and the chunk keys from the port's Threefry
(:mod:`.prng`), which draws JAX's words.

Edges of undirected graphs are canonically (u, v) with u > v.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import List

import numpy as np
import torch

from ..distrib.engine import (
    KIND_DIRECTED,
    KIND_RECT,
    KIND_TRI,
    chunk_plan_from_columns,
    reseedable_chunk_plan,
)
from .chunking import directed_split_tree, undirected_split_tree
from .prng import THREEFRY, PhiloxReplayer, device_key, fold_in, fold_in_many, hash_paths
from .variates import binomial

_CHUNK_TAG = 11  # mixed into per-chunk hashes


def _chunk_key_data(seed: int, path_cols: List[np.ndarray],
                    rng_impl: str = THREEFRY) -> np.ndarray:
    """uint32 [k, 2] key data for hash paths (seed, _CHUNK_TAG, *cols),
    on the host: one batched fold_in per path component."""
    keys = fold_in_many(device_key(seed, _CHUNK_TAG, impl=rng_impl),
                        torch.from_numpy(np.asarray(path_cols[0], np.int64)))
    for col in path_cols[1:]:
        keys = fold_in(keys, torch.from_numpy(np.asarray(col, np.int64)))
    return keys.numpy().astype(np.uint32)


def _sections(n: int, P: int) -> np.ndarray:
    """All P + 1 section boundaries at once (== section_bounds columns)."""
    return n * np.arange(P + 1, dtype=np.int64) // P


@dataclass(frozen=True)
class _CrossLayout:
    """Seed-independent flat layout of the P x P triangular cross.

    One row per (PE, chunk) table entry, in pe-major / within-PE
    emission order: ``I``/``J`` are each row's chunk-matrix coordinates,
    ``leaf`` its full-DFS leaf index."""
    pe: np.ndarray          # int64 [k]
    I: np.ndarray           # int64 [k]
    J: np.ndarray           # int64 [k]
    leaf: np.ndarray        # int64 [k]
    owned: np.ndarray       # bool  [k]
    kind: np.ndarray        # int32 [k]
    universe: np.ndarray    # int64 [k]
    params: np.ndarray      # int64 [k, 3]


def _cross_layout_from(I: np.ndarray, J: np.ndarray, leaf: np.ndarray,
                       pe: np.ndarray, owned: np.ndarray,
                       n: int, P: int) -> _CrossLayout:
    sec = _sections(n, P)
    ra, rb = sec[I], sec[I + 1]
    ca, cb = sec[J], sec[J + 1]
    tri = I == J
    kind = np.where(tri, KIND_TRI, KIND_RECT).astype(np.int32)
    universe = np.where(tri, (rb - ra) * (rb - ra - 1) // 2,
                        (rb - ra) * (cb - ca))
    z = np.zeros_like(ra)
    params = np.where(tri[:, None],
                      np.stack([ra, z, z], axis=1),
                      np.stack([cb - ca, ra, ca], axis=1))
    return _CrossLayout(pe, I, J, leaf, owned, kind, universe, params)


@lru_cache(maxsize=32)
def _gnm_cross_layout(n: int, P: int) -> _CrossLayout:
    """Undirected G(n,m) cross: each leaf appears on PE I (owned) and --
    when off-diagonal -- mirrored on PE J, in full-DFS leaf order per PE."""
    tree = undirected_split_tree(n, P)
    I, J = tree.leaf_I, tree.leaf_J
    L = tree.num_leaves
    lid = np.arange(L, dtype=np.int64)
    mirror = I != J
    pe = np.concatenate([I, J[mirror]])
    leaf = np.concatenate([lid, lid[mirror]])
    owned = np.concatenate([np.ones(L, bool), np.zeros(int(mirror.sum()), bool)])
    order = np.lexsort((leaf, pe))  # pe-major, DFS-leaf-minor
    pe, leaf, owned = pe[order], leaf[order], owned[order]
    return _cross_layout_from(I[leaf], J[leaf], leaf, pe, owned, n, P)


@lru_cache(maxsize=32)
def _gnp_cross_layout(n: int, P: int) -> _CrossLayout:
    """Undirected G(n,p) cross: PE pe's row j walks chunk
    (max(pe, j), min(pe, j)) for j in [0, P), the row PE owning."""
    peg = np.repeat(np.arange(P, dtype=np.int64), P)
    j = np.tile(np.arange(P, dtype=np.int64), P)
    I, J = np.maximum(peg, j), np.minimum(peg, j)
    return _cross_layout_from(I, J, I * P + J, peg, I == peg, n, P)


def _gnp_counts(seed: int, I: np.ndarray, J, universe: np.ndarray,
                p: float) -> np.ndarray:
    """Binomial(U, p) per chunk from the chunk-id hash -- one batched
    ``hash_paths`` pass + replayed draws."""
    cols = [np.full(len(I), _CHUNK_TAG, np.int64)] + (
        [I, J] if J is not None else [I])
    hashes = hash_paths(seed, np.stack(cols, axis=1))
    rep = PhiloxReplayer()
    out = np.empty(len(hashes), np.int64)
    for k, h in enumerate(hashes):
        out[k] = binomial(rep.at(h), int(universe[k]), p)
    return out


def _cross_plan(seed: int, n: int, lay: _CrossLayout, count_fn,
                P: int, rng_impl: str = THREEFRY):
    """Column-build a re-seedable ChunkPlan from a cross layout; reseed
    re-runs only the count and key columns."""
    key_fn = lambda s: _chunk_key_data(s, [lay.I, lay.J], rng_impl)
    plan = chunk_plan_from_columns(
        P, lay.pe, lay.kind, key_fn(seed), lay.universe, count_fn(seed),
        lay.params, lay.owned, n, rng_impl=rng_impl)
    return reseedable_chunk_plan(plan, key_fn=key_fn, count_fn=count_fn)


def _directed_plan(seed: int, n: int, counts_of, P: int,
                   rng_impl: str = THREEFRY):
    sec = _sections(n, P)
    lo, hi = sec[:-1], sec[1:]
    ids = np.arange(P, dtype=np.int64)
    # n rides in params: the decode is table data
    params = np.stack([lo, np.full(P, n, np.int64), np.zeros(P, np.int64)],
                      axis=1)
    key_fn = lambda s: _chunk_key_data(s, [ids], rng_impl)
    count_fn = lambda s: np.asarray(counts_of(s), np.int64)
    plan = chunk_plan_from_columns(
        P, ids, np.full(P, KIND_DIRECTED, np.int32), key_fn(seed),
        (hi - lo) * (n - 1), count_fn(seed), params, np.ones(P, bool), n,
        rng_impl=rng_impl)
    return reseedable_chunk_plan(plan, key_fn=key_fn, count_fn=count_fn)


def gnm_directed_plan(seed: int, n: int, m: int, P: int, rng_impl: str = THREEFRY):
    """ChunkPlan: one row chunk per PE (Fig. 1 left)."""
    tree = directed_split_tree(n, P)
    return _directed_plan(seed, n, lambda s: tree.counts(s, m), P, rng_impl)


def gnm_undirected_plan(seed: int, n: int, m: int, P: int, rng_impl: str = THREEFRY):
    """ChunkPlan: PE i's row + column cross of the triangular chunk
    matrix (Fig. 1 right), owned bits on the row chunks."""
    lay = _gnm_cross_layout(n, P)
    tree = undirected_split_tree(n, P)
    return _cross_plan(seed, n, lay, lambda s: tree.counts(s, m)[lay.leaf],
                       P, rng_impl)


def gnp_directed_plan(seed: int, n: int, p: float, P: int, rng_impl: str = THREEFRY):
    """ChunkPlan: row chunks with independent Binomial(U, p) counts."""
    sec = _sections(n, P)
    universe = (sec[1:] - sec[:-1]) * (n - 1)
    ids = np.arange(P, dtype=np.int64)
    return _directed_plan(
        seed, n, lambda s: _gnp_counts(s, ids, None, universe, p), P, rng_impl)


def gnp_undirected_plan(seed: int, n: int, p: float, P: int, rng_impl: str = THREEFRY):
    """ChunkPlan for undirected G(n,p) (§4.3), owned bits on row chunks."""
    lay = _gnp_cross_layout(n, P)
    return _cross_plan(
        seed, n, lay, lambda s: _gnp_counts(s, lay.I, lay.J, lay.universe, p),
        P, rng_impl)
