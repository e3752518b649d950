"""Random geometric graphs in [0,1)^d, d in {2,3} (paper §5): the host
planning half of ``repro.core.rgg``, ported.

The unit cube is cut into a uniform cell grid (cell side >= r when
possible), cells are grouped into 2^(d*b) >= P Morton-ordered chunks, and
per-cell vertex counts come from a divide-and-conquer binomial recursion
whose nodes are hashed, so any PE can recompute any cell's vertices.
Vertex ids are assigned in recursion order.  The plans built here are
equal, field by field, to the reference's; the device regenerates every
cell's points from its hashed key (``kernels/geom``).
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from dataclasses import dataclass
from functools import lru_cache
from typing import List, Tuple

import numpy as np
import torch

from .. import obs
from ..distrib.engine import (GEOM_TORUS, POINTS_CUBE, PairPlan, make_pair_plan,
                              make_point_plan, require_counter_rng)
from .chunking import chunks_per_dim, cube_chunks_for_pe
from .prng import THREEFRY, PhiloxReplayer, device_key, fold_in_many, hash_paths
from .sampling import round_up_capacity
from .variates import binomial

_TAG_SPLIT, _TAG_PTS = 21, 22

Box = Tuple[Tuple[int, int], ...]  # ((lo, hi), ...) in cell coordinates
Cell = Tuple[int, ...]


@dataclass(frozen=True)
class CellGrid:
    """Uniform cell grid aligned with the Morton chunk decomposition."""
    dim: int
    g: int          # cells per dimension
    cpd: int        # chunks per dimension (power of two)
    rho: int        # neighbor search range in cells (ceil(r * g))

    @property
    def cells_per_chunk_dim(self) -> int:
        return self.g // self.cpd

    @property
    def num_cells(self) -> int:
        return self.g ** self.dim

    def cell_id(self, cell: Cell) -> int:
        cid = 0
        for c in cell:
            cid = cid * self.g + int(c)
        return cid

    def chunk_cells(self, chunk: Cell) -> List[Cell]:
        """The cells of one chunk, first coordinate outermost."""
        cc = self.cells_per_chunk_dim
        return [tuple(c) for c in itertools.product(*(range(x * cc, (x + 1) * cc)
                                                       for x in chunk))]


def make_grid(n: int, radius: float, P: int, dim: int) -> CellGrid:
    """Cell side = max(r, n^-1/d) rounded to tile the chunk grid (§5)."""
    cpd = chunks_per_dim(P, dim)
    target = max(radius, n ** (-1.0 / dim))
    per_chunk = max(1, int(1.0 / (target * cpd)))
    g = cpd * per_chunk
    rho = max(1, math.ceil(radius * g - 1e-9))
    return CellGrid(dim=dim, g=g, cpd=cpd, rho=rho)


def _volume(box: Box) -> int:
    v = 1
    for lo, hi in box:
        v *= hi - lo
    return v


def _split(box: Box) -> Tuple[Box, Box]:
    """Halve the largest dim (ties -> lowest index); chunk-aligned."""
    widths = [hi - lo for lo, hi in box]
    d = int(np.argmax(widths))
    lo, hi = box[d]
    mid = (lo + hi) // 2
    return box[:d] + ((lo, mid),) + box[d + 1:], box[:d] + ((mid, hi),) + box[d + 1:]


class CellSplitTree:
    """The hashed binomial split recursion over the cell grid, flattened
    for replay.

    The split *tree* (which boxes exist, their hash paths, their volume
    ratios, which leaf is which cell) is a pure function of the grid.
    Replaying the binomial draws in preorder gives every cell's count
    and vertex-id offset for any seed, with the reference's per-node
    draws."""

    def __init__(self, grid: CellGrid):
        self.grid = grid
        boxes: List[Box] = []
        left: List[int] = []
        right: List[int] = []

        def build(box: Box) -> int:
            i = len(boxes)
            boxes.append(box)
            left.append(-1)
            right.append(-1)
            if _volume(box) > 1:
                lo, hi = _split(box)
                left[i] = build(lo)
                right[i] = build(hi)
            return i

        build(tuple((0, grid.g) for _ in range(grid.dim)))
        self._num_nodes = len(boxes)
        # internal nodes in preorder (index order): parent before children
        self._internal = [i for i in range(len(boxes)) if left[i] >= 0]
        self._left = left
        self._right = right
        # fixed-width hash paths (_TAG_SPLIT, *flattened box) per internal node
        self._path = np.array(
            [(_TAG_SPLIT,) + tuple(x for lohi in boxes[i] for x in lohi)
             for i in self._internal], np.int64).reshape(len(self._internal),
                                                         1 + 2 * grid.dim)
        self._ratio = [_volume(boxes[left[i]]) / _volume(boxes[i])
                       for i in self._internal]
        # leaf node of each cell, indexed by row-major cell id
        leaf = np.zeros(grid.num_cells, np.int64)
        for i, box in enumerate(boxes):
            if left[i] < 0:
                leaf[grid.cell_id(tuple(lo for lo, _ in box))] = i
        self._leaf = leaf

    def counts_offsets(self, seed: int, n: int) -> Tuple[np.ndarray, np.ndarray]:
        """(counts, vertex-id offsets) per cell, by row-major cell id."""
        hashes = hash_paths(seed, self._path)
        replayer = PhiloxReplayer()
        cnt = np.zeros(self._num_nodes, np.int64)
        off = np.zeros(self._num_nodes, np.int64)
        cnt[0] = n
        left, right, ratio = self._left, self._right, self._ratio
        for k, i in enumerate(self._internal):
            c = int(cnt[i])
            # binomial(rng, 0, p) == 0 without consuming draws
            cl = binomial(replayer.at(hashes[k]), c, ratio[k]) if c else 0
            lt, rt = left[i], right[i]
            cnt[lt], cnt[rt] = cl, c - cl
            off[lt], off[rt] = off[i], off[i] + cl
        return cnt[self._leaf], off[self._leaf]


def local_cells_for_pe(grid: CellGrid, P: int, pe: int) -> List[Cell]:
    """Cells of PE ``pe``: the grid's Morton chunks dealt round-robin (the
    chunk grid is ``grid.cpd``, so any P deals the same instance)."""
    cells: List[Cell] = []
    for ch in cube_chunks_for_pe(P, grid.dim, pe, cpd=grid.cpd):
        cells.extend(grid.chunk_cells(ch))
    return cells


def cell_keys(seed: int, cell_ids: np.ndarray, rng_impl: str = THREEFRY) -> np.ndarray:
    """uint32 ``[k, 2]`` keys of the given row-major cell ids: the hashed
    streams every point plan and pair plan regenerates."""
    base = device_key(seed, _TAG_PTS, impl=rng_impl)
    ids = torch.as_tensor(np.asarray(cell_ids, np.int64))
    return fold_in_many(base, ids).numpy().astype(np.uint32).reshape(len(ids), 2)


def grid_point_plan(seed: int, grid: CellGrid, n: int, P: int, rng_impl: str = THREEFRY,
                    tree: "CellSplitTree | None" = None):
    """Cube PointPlan over a cell grid: every cell once, dealt to PEs by
    Morton chunk (paper §5.1), keyed by cell id; each cell's first vertex
    id in ``gid0``.  Shared by RGG and RDG (which differ only in the cell
    side).  The counts come from the split-tree replay."""
    tree = tree or CellSplitTree(grid)
    counts, offsets = tree.counts_offsets(seed, n)
    per_pe, gid0 = [], []
    for pe in range(P):
        cells = local_cells_for_pe(grid, P, pe)
        coords = np.asarray(cells, np.int64).reshape(len(cells), grid.dim)
        ids = np.array([grid.cell_id(c) for c in cells], np.int64)
        per_pe.append((cell_keys(seed, ids, rng_impl), counts[ids], coords,
                       np.ones((len(cells), 1), np.float64)))
        gid0.append(offsets[ids])
    plan = make_point_plan(per_pe, POINTS_CUBE, scale=float(grid.g), dim=grid.dim,
                           rng_impl=rng_impl, gid0=gid0)
    return dataclasses.replace(
        plan, reseed_fn=lambda s: grid_point_plan(s, grid, n, P, rng_impl, tree))


def _neighbor_offsets(dim: int, rho: int) -> List[Cell]:
    rng = range(-rho, rho + 1)
    if dim == 2:
        return [(a, b) for a in rng for b in rng]
    return [(a, b, c) for a in rng for b in rng for c in rng]


def _is_forward(delta: Cell) -> bool:
    for x in delta:
        if x != 0:
            return x > 0
    return False  # zero offset


class RggStructure:
    """Seed-independent half of the RGG plan emitters: the split tree,
    the forward-canonical candidate-pair list, the Morton PE deal and
    the per-PE cell lists, all pure functions of (n, radius, chunk grid,
    P, dim).  :meth:`emit` / :meth:`emit_points` fill in the
    seed-dependent half (counts, offsets, cell keys) with numpy
    scatters."""

    def __init__(self, n: int, radius: float, P: int, dim: int = 2,
                 rng_impl: str = THREEFRY, chunk_P: int = 0):
        require_counter_rng(rng_impl)
        self.n, self.radius, self.P, self.dim = int(n), float(radius), int(P), int(dim)
        self.rng_impl = rng_impl
        grid = make_grid(n, radius, chunk_P or P, dim)
        self.grid = grid
        self.tree = CellSplitTree(grid)
        g = grid.g
        # row-major cell coordinates (== np.ndindex order)
        coords = np.stack(np.meshgrid(*[np.arange(g, dtype=np.int64)] * dim,
                                      indexing="ij"), -1).reshape(g ** dim, dim)
        self._coords = coords
        self._coords_f = coords.astype(np.float64)
        cc = grid.cells_per_chunk_dim
        bits = grid.cpd.bit_length() - 1
        # Morton code of each cell's chunk, bit-plane at a time
        chunk_of = coords // cc
        code = np.zeros(len(coords), np.int64)
        for b in range(bits):
            for d in range(dim):
                code |= ((chunk_of[:, d] >> b) & 1) << (b * dim + d)
        pe_of_cell = code % P
        # candidate pairs: cells row-major, self pair first, then forward
        # deltas in _neighbor_offsets order
        forward = np.array(
            [d for d in _neighbor_offsets(dim, grid.rho) if _is_forward(d)],
            np.int64).reshape(-1, dim)
        deltas = np.concatenate([np.zeros((1, dim), np.int64), forward])
        nb = coords[:, None, :] + deltas[None, :, :]          # [N, D, dim]
        ok = ((nb >= 0) & (nb < g)).all(axis=-1)              # [N, D]
        strides = g ** np.arange(dim - 1, -1, -1, dtype=np.int64)
        nb_id = (nb * strides).sum(axis=-1)                   # row-major cell id
        N, D = ok.shape
        flat = ok.ravel()  # cell-major, delta-minor
        self._pa_i = np.repeat(np.arange(N, dtype=np.int64), D)[flat]
        self._pa_j = nb_id.ravel()[flat]
        self._pa_self = np.tile(np.arange(D) == 0, N)[flat]
        self._pa_pe = pe_of_cell[self._pa_i]
        self._fp = np.array([float(g), self.radius * self.radius], np.float64)
        # per-PE cell ids in PointPlan order: chunks round-robin in Morton
        # code order, cells row-major within
        codes = np.arange(grid.cpd ** dim, dtype=np.int64)
        ch = np.zeros((len(codes), dim), np.int64)
        for b in range(bits):
            for d in range(dim):
                ch[:, d] |= ((codes >> (b * dim + d)) & 1) << b
        bc = np.stack(np.meshgrid(*[np.arange(cc, dtype=np.int64)] * dim,
                                  indexing="ij"), -1).reshape(cc ** dim, dim)
        cid = ((ch[:, None, :] * cc + bc[None, :, :]) * strides).sum(-1)
        self._local_ids = [cid[pe::P].reshape(-1) for pe in range(P)]

    def _keys(self, seed: int) -> np.ndarray:
        """uint32 [num_cells, 2] cell keys, by row-major cell id."""
        return cell_keys(seed, np.arange(self.grid.num_cells), self.rng_impl)

    def emit(self, seed: int) -> PairPlan:
        """The GEOM_TORUS PairPlan for ``seed``."""
        counts, offsets = self.tree.counts_offsets(seed, self.n)
        ca = counts[self._pa_i]
        inc = (ca > 0) & np.where(self._pa_self, ca > 1, counts[self._pa_j] > 0)
        if not inc.any():
            plan = make_pair_plan([[] for _ in range(self.P)],
                                  rng_impl=self.rng_impl, dim=self.dim)
            return dataclasses.replace(plan, reseed_fn=self.emit)
        kd = self._keys(seed)
        ci, cj = self._pa_i[inc], self._pa_j[inc]
        selfp, pe = self._pa_self[inc], self._pa_pe[inc]
        k = ci.size
        # stable rank within each PE group = the per-PE append order
        order = np.argsort(pe, kind="stable")
        sorted_pe = pe[order]
        start = np.searchsorted(sorted_pe, np.arange(self.P))
        col = np.empty(k, np.int64)
        col[order] = np.arange(k, dtype=np.int64) - start[sorted_pe]
        P, dim = self.P, self.dim
        C = int(np.bincount(pe, minlength=P).max())
        W = kd.shape[-1]
        kind = np.zeros((P, C), np.int32)
        key_a = np.zeros((P, C, W), np.uint32)
        key_b = np.zeros((P, C, W), np.uint32)
        count_a = np.zeros((P, C), np.int64)
        count_b = np.zeros((P, C), np.int64)
        gid_a = np.zeros((P, C, 1), np.int64)
        gid_b = np.zeros((P, C, 1), np.int64)
        geom_a = np.ones((P, C, dim), np.float64)  # 1s: make_pair_plan padding
        geom_b = np.ones((P, C, dim), np.float64)
        fparams = np.zeros((P, C, 2), np.float64)
        self_pair = np.zeros((P, C), bool)
        active = np.zeros((P, C), bool)
        kind[pe, col] = GEOM_TORUS
        key_a[pe, col] = kd[ci]
        key_b[pe, col] = kd[cj]
        count_a[pe, col] = counts[ci]
        count_b[pe, col] = counts[cj]
        gid_a[pe, col, 0] = offsets[ci]
        gid_b[pe, col, 0] = offsets[cj]
        geom_a[pe, col] = self._coords_f[ci]
        geom_b[pe, col] = self._coords_f[cj]
        fparams[pe, col] = self._fp
        self_pair[pe, col] = selfp
        active[pe, col] = True
        cap = round_up_capacity(
            max(int(counts[ci].max()), int(counts[cj].max())), mult=8)
        return PairPlan(kind, key_a, key_b, count_a, count_b, gid_a, gid_b,
                        geom_a, geom_b, fparams, self_pair, active, cap,
                        dim, self.rng_impl, reseed_fn=self.emit)

    def emit_points(self, seed: int):
        """The cube PointPlan for ``seed``, with each cell's first vertex
        id in ``gid0``."""
        counts, offsets = self.tree.counts_offsets(seed, self.n)
        kd = self._keys(seed)
        per_pe = [(kd[ids], counts[ids], self._coords[ids],
                   np.ones((len(ids), 1), np.float64))
                  for ids in self._local_ids]
        plan = make_point_plan(per_pe, POINTS_CUBE, scale=float(self.grid.g),
                               dim=self.dim, rng_impl=self.rng_impl,
                               gid0=[offsets[ids] for ids in self._local_ids])
        return dataclasses.replace(plan, reseed_fn=self.emit_points)


@lru_cache(maxsize=8)
def rgg_structure(n: int, radius: float, P: int, dim: int = 2,
                  rng_impl: str = THREEFRY, chunk_P: int = 0) -> RggStructure:
    """Cached seed-independent :class:`RggStructure`."""
    return RggStructure(n, radius, P, dim, rng_impl, chunk_P)


def rgg_point_plan(seed: int, n: int, radius: float, P: int, dim: int = 2,
                   rng_impl: str = THREEFRY, chunk_P: int = 0):
    """Cube PointPlan over the RGG cell grid: every cell once, dealt to
    PEs by Morton chunk, keyed by cell id (the stream the pair plan
    regenerates)."""
    with obs.trace("plan/rgg", phase="plan", family="rgg", reseed=False, P=P):
        return rgg_structure(n, radius, P, dim, rng_impl, chunk_P).emit_points(seed)


def rgg_pair_plan(seed: int, n: int, radius: float, P: int, dim: int = 2,
                  rng_impl: str = THREEFRY, chunk_P: int = 0) -> PairPlan:
    """GEOM_TORUS PairPlan: every candidate cell pair exactly once.

    Each cell pairs with itself and with its forward neighbors within
    ``rho`` rings, so every unordered cell pair within reach appears
    once; rows are dealt to PEs by the Morton chunk of the pair's first
    cell.  The device regenerates both cells' points from their hashed
    keys and runs the float32 r^2 test.  Empty cells emit no rows."""
    with obs.trace("plan/rgg", phase="plan", family="rgg", reseed=False, P=P):
        return rgg_structure(n, radius, P, dim, rng_impl, chunk_P).emit(seed)
