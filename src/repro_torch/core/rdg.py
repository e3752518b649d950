"""Random Delaunay graphs on the unit torus [0,1)^d, d in {2,3} (paper
§6): the planning half of ``repro.core.rdg``, ported.

Points come from the RGG cell grid with cell side c ≈ ((d+1)/n)^(1/d).
Each virtual chunk triangulates its cells plus an expanding halo of
recomputed neighbour cells, and accepts the result only when

  (a) no alive simplex joins a chunk-local point to a super-simplex
      vertex (no chunk-local point is on the hull), and
  (b) every super-free simplex touching a chunk-local point has its
      circumsphere inside the region's box,

which makes those simplices simplices of the global periodic Delaunay
triangulation; otherwise the halo grows by one cell ring.  Halo cells are
unwrapped: a cell may enter under several ±1 lattice shifts.

Every halo round triangulates all pending chunks in one launch of the
``triangulate`` kernel and certifies them in one launch of
``circumspheres`` (:mod:`repro_torch.kernels.delaunay`).  A region that
wraps the torus on two axes holds exact periodic ties the kernel cannot
resolve; it runs scipy's Qhull instead, as the reference does (tiny grids
only).  The certified simplices that designate an edge become GEOM_CERT
rows of a PairPlan; the engine re-certifies each row on the device with
the same Cramer predicate and emits its masked edges.

The plan tables equal the reference's field by field: the slot layout of
the triangulation decides which simplex designates each edge.  The
columns cached per seed are host numpy arrays and do not depend on the
device that computed them.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from scipy.spatial import Delaunay

from .. import obs
from ..distrib.engine import (GEOM_CERT, POINTS_CUBE, pair_plan_from_columns,
                              pair_slot_index)
from ..distrib.runtime import resolve_device
from ..kernels.delaunay.ops import batched_delaunay
from ..kernels.delaunay.ops import circumspheres as circumspheres_kernel
from ..kernels.geom.ops import cell_points
from .prng import THREEFRY
from .rgg import (CellGrid, CellSplitTree, cell_keys, grid_point_plan, local_cells_for_pe,
                  make_grid)

Cell = Tuple[int, ...]


def rdg_grid(n: int, P: int, dim: int) -> CellGrid:
    c = ((dim + 1) / n) ** (1.0 / dim)
    return make_grid(n, c, P, dim)


def default_chunk_P(P: int, dim: int) -> int:
    """Default virtual-chunk count of the RDG grid: 16 in 2-D, 8 in 3-D
    (fewer, fatter chunks cut the halo duplication), never below P."""
    return max(P, 16 if dim == 2 else 8)


def rdg_point_plan(seed: int, n: int, P: int, dim: int = 2, rng_impl: str = THREEFRY,
                   chunk_P: int = 0):
    """Cube PointPlan over the RDG cell grid."""
    with obs.trace("plan/rdg", phase="plan", family="rdg", reseed=False, P=P):
        grid = rdg_grid(n, chunk_P or default_chunk_P(P, dim), dim)
        return grid_point_plan(seed, grid, n, P, rng_impl)


def _torus_canonical(cell: Cell, g: int) -> Tuple[Cell, Tuple[int, ...]]:
    canon = tuple(c % g for c in cell)
    shift = tuple((c - cc) // g for c, cc in zip(cell, canon))
    return canon, shift


def _ring(cells: set, dim: int) -> set:
    """All unwrapped cells adjacent to the given set (excluded)."""
    out = set()
    offs = [o for o in itertools.product((-1, 0, 1), repeat=dim) if any(o)]
    for c in cells:
        for o in offs:
            nb = tuple(a + b for a, b in zip(c, o))
            if nb not in cells:
                out.add(nb)
    return out


def circumspheres(simp: np.ndarray, device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Circumcenters and radii of ``[S, d+1, d]`` simplices, from the
    ``circumspheres`` kernel on ``device`` (the shared Cramer predicate):
    numpy ``(center [S, d], rad [S])``, with ``rad = inf`` for a
    degenerate simplex, which fails every containment test."""
    dev = resolve_device(device)
    S = len(simp)
    if S == 0:
        d = simp.shape[2] if simp.ndim == 3 else 2
        return np.zeros((0, d), simp.dtype), np.zeros(0, simp.dtype)
    t = torch.from_numpy(np.ascontiguousarray(simp, np.float64)).to(dev)
    out = circumspheres_kernel(t)
    center, r2, nondeg = (x.cpu().numpy() for x in out)
    return center, np.where(nondeg, np.sqrt(r2), np.inf)


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


class _GridBank:
    """Whole-grid point bank: one ``cell_points`` launch per seed draws
    every canonical cell's points at once (the reference's whole-grid
    draw, bit for bit); unwrapped halo images are a numpy lattice shift
    of the canonical row."""

    def __init__(self, seed: int, grid: CellGrid, n: int, tree: CellSplitTree,
                 rng_impl: str = THREEFRY, device=None):
        dev = resolve_device(device)
        self.seed, self.grid = seed, grid
        counts, offsets = tree.counts_offsets(seed, n)
        cap = _round_up(max(1, int(counts.max())), 8)
        g, dim = grid.g, grid.dim
        coords = np.stack(np.meshgrid(*([np.arange(g)] * dim), indexing="ij"),
                          axis=-1).reshape(-1, dim)
        keys = cell_keys(seed, np.arange(g ** dim), rng_impl).view(np.int32)
        pos, _ = cell_points(torch.from_numpy(keys).to(dev),
                             torch.from_numpy(counts).to(dev),
                             torch.from_numpy(coords.astype(np.int64)).to(dev),
                             torch.ones((g ** dim, 1), dtype=torch.float64, device=dev),
                             kind=POINTS_CUBE, scale=float(g), capacity=cap, dim=dim)
        self._pos = pos.cpu().numpy()
        self._counts, self._offsets = counts, offsets
        self._cache: Dict[Cell, Tuple[np.ndarray, np.ndarray]] = {}

    def get(self, cell: Cell) -> Tuple[np.ndarray, np.ndarray]:
        """(positions (k, d) unwrapped, gids (k,)) of one unwrapped cell."""
        hit = self._cache.get(cell)
        if hit is None:
            canon, shift = _torus_canonical(cell, self.grid.g)
            cid = self.grid.cell_id(canon)
            k = int(self._counts[cid])
            hit = self._cache[cell] = (
                self._pos[cid, :k] + np.asarray(shift, np.float64),
                self._offsets[cid] + np.arange(k))
        return hit

    def region(self, cells: Sequence[Cell], local: set) -> \
            Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(pts, gids, is_local) of a cell sequence in one numpy gather, in
        the order of per-cell :meth:`get` calls."""
        g, dim = self.grid.g, self.grid.dim
        arr = np.asarray(cells, np.int64)
        canon = np.mod(arr, g)
        shift = ((arr - canon) // g).astype(np.float64)
        cid = canon[:, 0]
        for a in range(1, dim):
            cid = cid * g + canon[:, a]
        k = self._counts[cid]
        cap = self._pos.shape[1]
        sel = np.arange(cap)[None, :] < k[:, None]
        pts = (self._pos[cid] + shift[:, None, :])[sel]
        gids = (self._offsets[cid][:, None] + np.arange(cap)[None, :])[sel]
        is_local = np.fromiter((c in local for c in cells), bool, len(arr))
        return pts, gids, np.repeat(is_local, k)


def _certified_triangulation(bank: _GridBank, local_cells: set, dim: int, max_expand: int,
                             region: Optional[set] = None, device=None):
    """The halo protocol for one cell set on scipy's Qhull, until the
    triangulation is certified: (pts, gids, loc, simplices, box_lo,
    box_hi, expansions).  The reference runs it for regions that wrap the
    torus; certificates come from the ``circumspheres`` kernel."""
    grid = bank.grid
    if region is None:
        region = set(local_cells)
        region |= _ring(region, dim)
    else:
        region = set(region)
    expansions = 0
    while True:
        pts_list, gid_list, is_local = [], [], []
        for cell in sorted(region):
            p, g = bank.get(cell)
            pts_list.append(p)
            gid_list.append(g)
            is_local.append(np.full(len(g), cell in local_cells))
        pts = np.concatenate(pts_list)
        gids = np.concatenate(gid_list)
        loc = np.concatenate(is_local)
        if len(pts) < dim + 2:
            raise ValueError("too few points for a Delaunay triangulation")
        tri = Delaunay(pts)  # repro: allow(no-per-chunk-host-loop) retained Qhull oracle
        cells_arr = np.array(sorted(region))
        box_lo = cells_arr.min(axis=0) / grid.g
        box_hi = (cells_arr.max(axis=0) + 1) / grid.g
        ok = not loc[tri.convex_hull.ravel()].any()
        if ok:
            sel = tri.simplices[loc[tri.simplices].any(axis=1)]
            if len(sel):
                center, rad = circumspheres(pts[sel], device)  # repro: allow(no-per-chunk-host-loop) retained Qhull oracle
                ok = bool(((center - rad[:, None] >= box_lo).all()
                           & (center + rad[:, None] <= box_hi).all()))
        if ok:
            return pts, gids, loc, tri.simplices, box_lo, box_hi, expansions
        expansions += 1
        if expansions > max_expand:
            raise RuntimeError("halo did not converge")
        region |= _ring(region, dim)


def _designated_rows(simplices: np.ndarray, loc: np.ndarray, gids: np.ndarray,
                     n: int, dim: int, cap: int) -> Tuple[np.ndarray, np.ndarray]:
    """Edge designation of one chunk's certified simplices: (ascending
    simplex indices that emit, per-simplex edge bitmask).  An edge is
    designated by its first simplex in (simplex, vertex pair) order, and
    only by the chunk owning its larger gid; periodic self-images drop."""
    S = len(simplices)
    lg = np.sort(gids[loc])
    if S == 0 or len(lg) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    combos = [(i, j) for i in range(dim + 1) for j in range(i + 1, dim + 1)]
    ci = np.array([i for i, _ in combos])
    cj = np.array([j for _, j in combos])
    bits = np.array([1 << pair_slot_index(i, j, cap) for i, j in combos], np.int64)
    M = len(combos)
    ls = loc[simplices]
    gs = gids[simplices]
    a, b = gs[:, ci], gs[:, cj]
    hi, lo = np.maximum(a, b), np.minimum(a, b)
    keep = ls.any(axis=1)[:, None] & (ls[:, ci] | ls[:, cj]) & (a != b)
    pos = np.minimum(np.searchsorted(lg, hi), len(lg) - 1)
    keep &= lg[pos] == hi
    idx = np.nonzero(keep.ravel())[0]
    code = hi.ravel()[idx] * np.int64(n) + lo.ravel()[idx]
    order = np.argsort(code, kind="stable")
    sc = code[order]
    first = np.ones(len(sc), bool)
    first[1:] = sc[1:] != sc[:-1]
    chosen = idx[order[first]]
    mask = np.zeros(S, np.int64)
    np.bitwise_or.at(mask, chosen // M, bits[chosen % M])
    rows = np.nonzero(mask)[0]
    return rows, mask[rows]


class RdgStructure:
    """Seed-independent RDG planning structure: the cell grid, each
    virtual chunk's cells and its initial region (chunk + two rings);
    :meth:`emit` runs the halo protocol for a seed, one batched
    triangulation per round across every pending chunk."""

    def __init__(self, n: int, P: int, dim: int = 2, rng_impl: str = THREEFRY,
                 chunk_P: int = 0, max_expand: int = 8):
        self.n, self.P, self.dim = int(n), int(P), int(dim)
        if self.n < self.dim + 2:
            raise ValueError("too few points for a Delaunay triangulation")
        self.rng_impl, self.max_expand = rng_impl, int(max_expand)
        self.grid = rdg_grid(n, chunk_P or default_chunk_P(P, dim), dim)
        self.K = self.grid.cpd ** self.dim
        self.chunk_cells: List[set] = [
            set(local_cells_for_pe(self.grid, self.K, v)) for v in range(self.K)]
        self._tree = CellSplitTree(self.grid)
        # start at chunk + two rings: a one-ring halo (one cell side ~ the
        # (d+1)-NN distance) almost never certifies
        self._init_regions: List[set] = []
        for c in self.chunk_cells:
            r = set(c) | _ring(c, self.dim)
            self._init_regions.append(r | _ring(r, self.dim))
        self._col_cache: Dict[int, tuple] = {}
        # a stream's planner thread and its consumer may both ask for the
        # columns of a seed; one computes them, the other waits for them
        self._col_lock = threading.Lock()
        #: the last triangulation's path: halo rounds of the batched kernel,
        #: each round's rows that came back ok, and chunks that ran Qhull
        #: because their region wraps the torus
        self.last_rounds = self.last_qhull_chunks = 0
        self.last_ok_rows: List[int] = []

    def _wraps(self, region: set) -> bool:
        """True when the region's periodic images can be exactly
        degenerate: it spans more than the torus on two axes, or more than
        two turns on one."""
        arr = np.array(sorted(region))
        span = arr.max(axis=0) - arr.min(axis=0) + 1
        return bool(((span > self.grid.g).sum() >= 2) or (span > 2 * self.grid.g).any())

    def _triangulate_chunks(self, seed: int, device) -> List[tuple]:
        """(pts, gids, loc, interior simplices, box_lo, box_hi) per virtual
        chunk."""
        dim, grid = self.dim, self.grid
        bank = _GridBank(seed, grid, self.n, self._tree, self.rng_impl, device)
        regions = [set(r) for r in self._init_regions]
        pending = list(range(self.K))
        expansions = [0] * self.K
        done: Dict[int, tuple] = {}
        rounds = qhull = 0
        ok_rows: List[int] = []
        while pending:
            wrapped = [v for v in pending if self._wraps(regions[v])]
            for v in wrapped:
                pts, gids, loc, simplices, box_lo, box_hi, _ = _certified_triangulation(
                    bank, self.chunk_cells[v], dim, self.max_expand, region=regions[v],
                    device=device)
                done[v] = (pts, gids, loc, simplices, box_lo, box_hi)
            qhull += len(wrapped)
            if wrapped:
                pending = [v for v in pending if v not in set(wrapped)]
                if not pending:
                    break
            rows, boxes = [], []
            for v in pending:
                cells = sorted(regions[v])
                rows.append(bank.region(cells, self.chunk_cells[v]))
                cells_arr = np.array(cells)
                boxes.append((cells_arr.min(axis=0) / grid.g,
                              (cells_arr.max(axis=0) + 1) / grid.g))
            if min(len(r[0]) for r in rows) < dim + 2:
                raise ValueError("too few points for a Delaunay triangulation")
            # pad to (power-of-two rows) x (128-multiple points), as the
            # reference buckets its rounds
            N = _round_up(max(len(r[0]) for r in rows), 128)
            B = 1 << max(0, len(pending) - 1).bit_length()
            ptsb = np.zeros((B, N, dim))
            cnt = np.zeros(B, np.int64)
            for i, (p, _, _) in enumerate(rows):
                ptsb[i, : len(p)] = p
                cnt[i] = len(p)
            simp, alive, ok = (t.cpu().numpy() for t in
                               batched_delaunay(ptsb, cnt, dim=dim, device=device))
            rounds += 1
            ok_rows.append(int(ok[:len(pending)].sum()))

            # every pending chunk's local-touching interior simplices,
            # certified in one circumsphere batch
            per_chunk, seg_pts, offs = [], [], [0]
            for i, v in enumerate(pending):
                pts, gids, loc = rows[i]
                nb = int(cnt[i])
                live = simp[i][alive[i]]
                sup = (live >= nb).any(axis=1)
                lv = np.where(live < nb, loc[np.minimum(live, nb - 1)], False)
                hull_ok = bool(ok[i]) and not (lv.any(axis=1) & sup).any()
                interior = live[~sup]
                sel = interior[loc[interior].any(axis=1)] if len(interior) else interior
                per_chunk.append((v, hull_ok, interior, sel))
                seg_pts.append(pts[sel] if len(sel) else np.zeros((0, dim + 1, dim)))
                offs.append(offs[-1] + len(sel))
            allsimp = np.concatenate(seg_pts)
            center, rad = (circumspheres(allsimp, device) if len(allsimp)  # repro: allow(no-per-chunk-host-loop) one batch per halo round, never per chunk
                           else (np.zeros((0, dim)), np.zeros(0)))
            inside = np.ones(len(allsimp), bool)
            for i in range(len(per_chunk)):
                lo, hi = boxes[i]
                s = slice(offs[i], offs[i + 1])
                inside[s] = ((center[s] - rad[s, None] >= lo).all(axis=1)
                             & (center[s] + rad[s, None] <= hi).all(axis=1))
            still = []
            for i, (v, hull_ok, interior, _) in enumerate(per_chunk):
                if hull_ok and inside[offs[i]:offs[i + 1]].all():
                    pts, gids, loc = rows[i]
                    done[v] = (pts, gids, loc, interior) + boxes[i]
                    continue
                expansions[v] += 1
                if expansions[v] > self.max_expand:
                    raise RuntimeError("halo did not converge")
                regions[v] |= _ring(regions[v], dim)
                still.append(v)
            pending = still
        self.last_rounds, self.last_qhull_chunks, self.last_ok_rows = rounds, qhull, ok_rows
        return [done[v] for v in range(self.K)]

    def _columns(self, seed: int, device=None) -> tuple:
        """(k, gid_a, gid_b, geom_a, geom_b) of the plan's rows, cached per
        seed (host numpy)."""
        with self._col_lock:
            if seed not in self._col_cache:
                cols = self._compute_columns(seed, device)
                if len(self._col_cache) >= 4:
                    self._col_cache.pop(next(iter(self._col_cache)))
                self._col_cache[seed] = cols
            return self._col_cache[seed]

    def clear_columns(self) -> None:
        """Forget every seed's cached columns (the next plan runs the
        device passes again)."""
        with self._col_lock:
            self._col_cache.clear()

    def _compute_columns(self, seed: int, device) -> tuple:
        n, dim, cap = self.n, self.dim, 4
        G = (dim + 1) * dim
        vg_l: List[np.ndarray] = []
        bits_l: List[np.ndarray] = []
        geom_l: List[np.ndarray] = []
        box_l: List[np.ndarray] = []
        for pts, gids, loc, simplices, box_lo, box_hi in \
                self._triangulate_chunks(seed, resolve_device(device)):
            rows, mask = _designated_rows(simplices, loc, gids, n, dim, cap)
            if not len(rows):
                continue
            sel = simplices[rows]
            vg = np.zeros((len(rows), cap), np.int64)
            vg[:, : dim + 1] = gids[sel]
            vg_l.append(vg)
            bits_l.append(mask)
            geom_l.append(pts[sel].reshape(len(rows), G))
            box_l.append(np.broadcast_to(np.concatenate([box_lo, box_hi]),
                                         (len(rows), 2 * dim)))
        k = sum(len(v) for v in vg_l)
        gid_a = np.concatenate(vg_l) if k else np.zeros((0, cap), np.int64)
        gid_b = np.zeros((k, cap), np.int64)
        gid_b[:, 0] = np.concatenate(bits_l) if k else 0
        geom_a = np.concatenate(geom_l) if k else np.zeros((0, G))
        geom_b = np.ones((k, G))
        geom_b[:, : 2 * dim] = np.concatenate(box_l) if k else 0
        return (k, gid_a, gid_b, geom_a, geom_b)

    def _emit(self, P_out: int, pe: np.ndarray, cols: tuple):
        k = len(pe)
        _, gid_a, gid_b, geom_a, geom_b = cols
        dpl = np.full(k, self.dim + 1, np.int64)
        return pair_plan_from_columns(
            P_out, pe, np.full(k, GEOM_CERT, np.int32),
            np.zeros((k, 2), np.uint32), np.zeros((k, 2), np.uint32),
            dpl, dpl, gid_a, gid_b, geom_a, geom_b,
            np.zeros((k, 1)), np.ones(k, bool),
            capacity=4, rng_impl=self.rng_impl, dim=self.dim)

    def emit(self, seed: int, device=None):
        """The GEOM_CERT PairPlan of this structure's (P, grid) for
        ``seed``; its ``reseed_fn`` re-runs only the device passes, on the
        same device."""
        with obs.trace("plan/rdg", phase="plan", family="rdg", reseed=False, P=self.P):
            cols = self._columns(seed, device)
            out = self._emit(self.P, np.arange(cols[0], dtype=np.int64) % self.P, cols)
        return dataclasses.replace(out, reseed_fn=functools.partial(self.emit, device=device))

    def segment(self, seed: int, lo: int, hi: int, device=None):
        """The ``PlanEmitter`` segment of global PEs [lo, hi), re-indexed to
        [0, hi - lo); the segments in order reproduce :meth:`emit`'s per-PE
        row order (rows are dealt round-robin in global row order)."""
        with obs.trace("plan/rdg", phase="plan", family="rdg", reseed=False, P=self.P,
                       lo=lo, hi=hi):
            k, gid_a, gid_b, geom_a, geom_b = self._columns(seed, device)
            pe = np.arange(k, dtype=np.int64) % self.P
            sel = (pe >= lo) & (pe < hi)
            sub = (int(sel.sum()), gid_a[sel], gid_b[sel], geom_a[sel], geom_b[sel])
            return self._emit(hi - lo, pe[sel] - lo, sub)


@functools.lru_cache(maxsize=None)
def rdg_structure(n: int, P: int, dim: int = 2, rng_impl: str = THREEFRY,
                  chunk_P: int = 0, max_expand: int = 8) -> RdgStructure:
    return RdgStructure(n, P, dim, rng_impl, chunk_P, max_expand)


def rdg_pair_plan(seed: int, n: int, P: int, dim: int = 2, rng_impl: str = THREEFRY,
                  chunk_P: int = 0, max_expand: int = 8, device=None):
    """GEOM_CERT PairPlan: every certified simplex that designates an
    edge, with its certificate inputs and edge bitmask, dealt to PEs
    round-robin by row (the same rows for every P)."""
    return rdg_structure(n, P, dim, rng_impl, chunk_P, max_expand).emit(seed, device)


def rdg_plan_segment(seed: int, n: int, P: int, lo: int, hi: int, dim: int = 2,
                     rng_impl: str = THREEFRY, chunk_P: int = 0, max_expand: int = 8,
                     device=None):
    """Segment [lo, hi) of :func:`rdg_pair_plan`: the device passes run
    once per seed (cached on the structure), and each segment deals its
    slice of the rows."""
    return rdg_structure(n, P, dim, rng_impl, chunk_P, max_expand).segment(
        seed, lo, hi, device)
