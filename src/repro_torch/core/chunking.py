"""Chunk geometry + divide-and-conquer sample-count recursion (paper §4).

The adjacency matrix is partitioned into *chunks*; the number of edges in
each chunk is derived by recursively splitting the universe and drawing
hypergeometric variates from recursion-node-hashed generators
(:func:`repro.core.prng.host_rng`).  Every PE runs only its own
log-depth descent (``*_for_pe``); a vectorized full recursion
(``*_all``) exists for tests/benchmarks and must agree exactly.

Directed  G(n,m): chunks = row blocks (Fig. 1 left).
Undirected G(n,m): chunks = P x P lower-triangular block matrix; PE i owns
row i and column i so the shared chunk (i, j) is recomputed identically
by PE i and PE j (Fig. 1 right).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, List, Tuple

import numpy as np

from .prng import PhiloxReplayer, hash_paths, host_rng
from .variates import hypergeometric

# region-type tags mixed into the recursion-node hash
_TRI, _RECT, _ROWS = 1, 2, 3


def section_bounds(n: int, P: int, i: int) -> Tuple[int, int]:
    """Vertex range of section i when [0, n) is split evenly into P."""
    return n * i // P, n * (i + 1) // P


def tri_size(w: int) -> int:
    """# of strictly-lower-triangular entries of a w x w block."""
    return w * (w - 1) // 2


# --------------------------------------------------------------------------
# directed G(n,m): 1-D recursion over row sections
# --------------------------------------------------------------------------

def _dir_universe(n: int, P: int, lo: int, hi: int) -> int:
    a, _ = section_bounds(n, P, lo)
    _, b = section_bounds(n, P, hi - 1)
    return (b - a) * (n - 1)


def directed_counts_for_pe(seed: int, n: int, m: int, P: int, pe: int) -> int:
    """Edge count of PE `pe`'s chunk — O(log P) variates, no communication."""
    lo, hi, mm = 0, P, m
    while hi - lo > 1:
        mid = (lo + hi) // 2
        u_left = _dir_universe(n, P, lo, mid)
        u_right = _dir_universe(n, P, mid, hi)
        rng = host_rng(seed, _ROWS, lo, hi)  # repro: allow(no-per-chunk-host-loop) O(log P) oracle descent
        m_left = hypergeometric(rng, u_left, u_right, mm)
        if pe < mid:
            hi, mm = mid, m_left
        else:
            lo, mm = mid, mm - m_left
    return mm


def directed_counts_all(seed: int, n: int, m: int, P: int) -> np.ndarray:
    """All chunk counts via the same recursion (test/benchmark oracle)."""
    out = np.zeros(P, dtype=np.int64)

    def rec(lo: int, hi: int, mm: int) -> None:
        if hi - lo == 1:
            out[lo] = mm
            return
        mid = (lo + hi) // 2
        u_left = _dir_universe(n, P, lo, mid)
        u_right = _dir_universe(n, P, mid, hi)
        rng = host_rng(seed, _ROWS, lo, hi)
        m_left = hypergeometric(rng, u_left, u_right, mm)
        rec(lo, mid, m_left)
        rec(mid, hi, mm - m_left)

    rec(0, P, m)
    return out


# --------------------------------------------------------------------------
# undirected G(n,m): 2-D recursion over the triangular chunk matrix
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class Chunk:
    """One block of the lower-triangular adjacency matrix.

    ``kind == 'tri'``: strictly-lower triangle of vertex rows/cols
    [rlo, rhi);  ``kind == 'rect'``: full block rows [rlo, rhi) x cols
    [clo, chi) with chi <= rlo (strictly below the diagonal).
    """
    kind: str
    rlo: int
    rhi: int
    clo: int
    chi: int
    row_sec: int  # chunk-matrix coordinates (I, J)
    col_sec: int

    @property
    def universe(self) -> int:
        if self.kind == "tri":
            return tri_size(self.rhi - self.rlo)
        return (self.rhi - self.rlo) * (self.chi - self.clo)


def _tri_universe(n, P, lo, hi):
    a, _ = section_bounds(n, P, lo)
    _, b = section_bounds(n, P, hi - 1)
    return tri_size(b - a)


def _rect_universe(n, P, rlo, rhi, clo, chi):
    ra, _ = section_bounds(n, P, rlo)
    _, rb = section_bounds(n, P, rhi - 1)
    ca, _ = section_bounds(n, P, clo)
    _, cb = section_bounds(n, P, chi - 1)
    return (rb - ra) * (cb - ca)


def _make_chunk(n, P, I, J) -> Chunk:
    ra, rb = section_bounds(n, P, I)
    ca, cb = section_bounds(n, P, J)
    if I == J:
        return Chunk("tri", ra, rb, ra, rb, I, J)
    return Chunk("rect", ra, rb, ca, cb, I, J)


def undirected_chunks_for_pe(
    seed: int, n: int, m: int, P: int, pe: int
) -> List[Tuple[Chunk, int]]:
    """All (chunk, edge-count) pairs PE `pe` must generate.

    PE i owns chunk-matrix row i (chunks (i, j), j <= i) and column i
    (chunks (j, i), j >= i): exactly P chunks.  The descent prunes any
    region not intersecting that cross, so work is O(P) with O(log P)
    depth — the paper's Theorem 2 recursion.
    """
    out: List[Tuple[Chunk, int]] = []

    def want_tri(lo, hi):  # tri region intersects PE's cross iff it contains pe
        return lo <= pe < hi

    def want_rect(rlo, rhi, clo, chi):
        return (rlo <= pe < rhi) or (clo <= pe < chi)

    def rec_tri(lo, hi, mm):
        if mm < 0:
            raise AssertionError("negative edge count")
        if hi - lo == 1:
            out.append((_make_chunk(n, P, lo, lo), mm))
            return
        mid = (lo + hi) // 2
        uA = _tri_universe(n, P, lo, mid)
        uB = _rect_universe(n, P, mid, hi, lo, mid)
        uC = _tri_universe(n, P, mid, hi)
        rng = host_rng(seed, _TRI, lo, hi)
        mA = hypergeometric(rng, uA, uB + uC, mm)
        mB = hypergeometric(rng, uB, uC, mm - mA)
        mC = mm - mA - mB
        if want_tri(lo, mid):
            rec_tri(lo, mid, mA)
        if want_rect(mid, hi, lo, mid):
            rec_rect(mid, hi, lo, mid, mB)
        if want_tri(mid, hi):
            rec_tri(mid, hi, mC)

    def rec_rect(rlo, rhi, clo, chi, mm):
        if rhi - rlo == 1 and chi - clo == 1:
            out.append((_make_chunk(n, P, rlo, clo), mm))
            return
        # split the longer side (in sections) to keep depth logarithmic
        if rhi - rlo >= chi - clo:
            mid = (rlo + rhi) // 2
            uT = _rect_universe(n, P, rlo, mid, clo, chi)
            uB = _rect_universe(n, P, mid, rhi, clo, chi)
            rng = host_rng(seed, _RECT, rlo, rhi, clo, chi)
            mT = hypergeometric(rng, uT, uB, mm)
            if want_rect(rlo, mid, clo, chi):
                rec_rect(rlo, mid, clo, chi, mT)
            if want_rect(mid, rhi, clo, chi):
                rec_rect(mid, rhi, clo, chi, mm - mT)
        else:
            mid = (clo + chi) // 2
            uL = _rect_universe(n, P, rlo, rhi, clo, mid)
            uR = _rect_universe(n, P, rlo, rhi, mid, chi)
            rng = host_rng(seed, _RECT, rlo, rhi, clo, chi)
            mL = hypergeometric(rng, uL, uR, mm)
            if want_rect(rlo, rhi, clo, mid):
                rec_rect(rlo, rhi, clo, mid, mL)
            if want_rect(rlo, rhi, mid, chi):
                rec_rect(rlo, rhi, mid, chi, mm - mL)

    rec_tri(0, P, m)
    return out


def undirected_counts_all(seed: int, n: int, m: int, P: int) -> Dict[Tuple[int, int], int]:
    """Full chunk-count matrix (oracle; O(P^2) leaves)."""
    out: Dict[Tuple[int, int], int] = {}

    def rec_tri(lo, hi, mm):
        if hi - lo == 1:
            out[(lo, lo)] = mm
            return
        mid = (lo + hi) // 2
        uA = _tri_universe(n, P, lo, mid)
        uB = _rect_universe(n, P, mid, hi, lo, mid)
        uC = _tri_universe(n, P, mid, hi)
        rng = host_rng(seed, _TRI, lo, hi)
        mA = hypergeometric(rng, uA, uB + uC, mm)
        mB = hypergeometric(rng, uB, uC, mm - mA)
        rec_tri(lo, mid, mA)
        rec_rect(mid, hi, lo, mid, mB)
        rec_tri(mid, hi, mm - mA - mB)

    def rec_rect(rlo, rhi, clo, chi, mm):
        if rhi - rlo == 1 and chi - clo == 1:
            out[(rlo, clo)] = mm
            return
        if rhi - rlo >= chi - clo:
            mid = (rlo + rhi) // 2
            uT = _rect_universe(n, P, rlo, mid, clo, chi)
            uB = _rect_universe(n, P, mid, rhi, clo, chi)
            rng = host_rng(seed, _RECT, rlo, rhi, clo, chi)
            mT = hypergeometric(rng, uT, uB, mm)
            rec_rect(rlo, mid, clo, chi, mT)
            rec_rect(mid, rhi, clo, chi, mm - mT)
        else:
            mid = (clo + chi) // 2
            uL = _rect_universe(n, P, rlo, rhi, clo, mid)
            uR = _rect_universe(n, P, rlo, rhi, mid, chi)
            rng = host_rng(seed, _RECT, rlo, rhi, clo, chi)
            mL = hypergeometric(rng, uL, uR, mm)
            rec_rect(rlo, rhi, clo, mid, mL)
            rec_rect(rlo, rhi, mid, chi, mm - mL)

    rec_tri(0, P, m)
    return out


# --------------------------------------------------------------------------
# flattened split trees — vectorized replay of the D&C recursions
# --------------------------------------------------------------------------
#
# The recursion *structure* (which regions split, their universes, the
# hashed node positions) depends only on (n, P) — never the seed — so it
# is precomputed once into flat preorder arrays and cached.  A count
# pass for a seed is then one batched ``hash_paths`` call plus a tight
# loop drawing the identical hypergeometric variates through a reusable
# ``PhiloxReplayer``: bit-identical to the per-node ``host_rng``
# recursions above (same generators, same draw order) at a fraction of
# the cost, because the per-node ``Generator(Philox(key=...))``
# construction and scalar splitmix64 chains are gone.  The recursions
# above are retained as test oracles.

_NODE_LEAF, _NODE_TRI, _NODE_RECT = 0, 1, 2


class DirectedSplitTree:
    """Flattened 1-D row recursion for directed G(n, m).

    ``counts(seed, m)`` replays :func:`directed_counts_all`
    bit-identically: preorder node order is the oracle's visit order,
    and each internal node draws its one hypergeometric from the same
    ``(seed, _ROWS, lo, hi)``-hashed generator."""

    def __init__(self, n: int, P: int):
        self.n, self.P = n, P
        is_leaf: List[bool] = []
        leaf_pe: List[int] = []
        ul: List[int] = []
        ur: List[int] = []
        left: List[int] = []
        right: List[int] = []
        paths: List[Tuple[int, int, int]] = []

        def build(lo: int, hi: int) -> int:
            k = len(is_leaf)
            is_leaf.append(hi - lo == 1)
            leaf_pe.append(lo)
            ul.append(0)
            ur.append(0)
            left.append(-1)
            right.append(-1)
            paths.append((_ROWS, lo, hi))
            if hi - lo == 1:
                return k
            mid = (lo + hi) // 2
            ul[k] = _dir_universe(n, P, lo, mid)
            ur[k] = _dir_universe(n, P, mid, hi)
            left[k] = build(lo, mid)
            right[k] = build(mid, hi)
            return k

        build(0, P)
        self._is_leaf = np.asarray(is_leaf, bool)
        self._leaf_pe = np.asarray(leaf_pe, np.int64)
        self._ul = np.asarray(ul, np.int64)
        self._ur = np.asarray(ur, np.int64)
        self._left = np.asarray(left, np.int32)
        self._right = np.asarray(right, np.int32)
        self._paths = np.asarray(paths, np.int64).reshape(-1, 3)

    def counts(self, seed: int, m: int) -> np.ndarray:
        """Per-PE chunk edge counts; == ``directed_counts_all``."""
        num = len(self._is_leaf)
        hashes = hash_paths(seed, self._paths)
        mm = np.zeros(num, np.int64)
        mm[0] = m
        out = np.zeros(self.P, np.int64)
        rep = PhiloxReplayer()
        is_leaf, leaf_pe = self._is_leaf, self._leaf_pe
        ul, ur, lt, rt = self._ul, self._ur, self._left, self._right
        for k in range(num):
            cur = int(mm[k])
            if is_leaf[k]:
                out[leaf_pe[k]] = cur
            else:
                ml = (hypergeometric(rep.at(hashes[k]), ul[k], ur[k], cur)
                      if cur else 0)
                mm[lt[k]] = ml
                mm[rt[k]] = cur - ml
        return out


class UndirectedSplitTree:
    """Flattened 2-D triangular recursion for undirected G(n, m).

    Leaves are stored in full-DFS order — the visit order of
    ``undirected_counts_all``, and (filtered to ``leaf_I == pe or
    leaf_J == pe``) the exact emission order of
    ``undirected_chunks_for_pe``: the per-PE descent prunes subtrees
    but never reorders the survivors.  Tri nodes draw *two*
    hypergeometrics from one node generator (mA then mB), matching the
    oracle draw-for-draw."""

    def __init__(self, n: int, P: int):
        self.n, self.P = n, P
        typ: List[int] = []
        hidx: List[int] = []
        u1: List[int] = []
        u2: List[int] = []
        u3: List[int] = []
        c1: List[int] = []
        c2: List[int] = []
        c3: List[int] = []
        leaf_slot: List[int] = []
        leaf_I: List[int] = []
        leaf_J: List[int] = []
        tri_paths: List[Tuple[int, int, int]] = []
        rect_paths: List[Tuple[int, int, int, int, int]] = []

        def new_node(t: int) -> int:
            k = len(typ)
            typ.append(t)
            hidx.append(-1)
            u1.append(0)
            u2.append(0)
            u3.append(0)
            c1.append(-1)
            c2.append(-1)
            c3.append(-1)
            leaf_slot.append(-1)
            return k

        def leaf(I: int, J: int) -> int:
            k = new_node(_NODE_LEAF)
            leaf_slot[k] = len(leaf_I)
            leaf_I.append(I)
            leaf_J.append(J)
            return k

        def rec_tri(lo: int, hi: int) -> int:
            if hi - lo == 1:
                return leaf(lo, lo)
            k = new_node(_NODE_TRI)
            hidx[k] = len(tri_paths)
            tri_paths.append((_TRI, lo, hi))
            mid = (lo + hi) // 2
            u1[k] = _tri_universe(n, P, lo, mid)
            u2[k] = _rect_universe(n, P, mid, hi, lo, mid)
            u3[k] = _tri_universe(n, P, mid, hi)
            c1[k] = rec_tri(lo, mid)
            c2[k] = rec_rect(mid, hi, lo, mid)
            c3[k] = rec_tri(mid, hi)
            return k

        def rec_rect(rlo: int, rhi: int, clo: int, chi: int) -> int:
            if rhi - rlo == 1 and chi - clo == 1:
                return leaf(rlo, clo)
            k = new_node(_NODE_RECT)
            hidx[k] = len(rect_paths)
            rect_paths.append((_RECT, rlo, rhi, clo, chi))
            if rhi - rlo >= chi - clo:
                mid = (rlo + rhi) // 2
                u1[k] = _rect_universe(n, P, rlo, mid, clo, chi)
                u2[k] = _rect_universe(n, P, mid, rhi, clo, chi)
                c1[k] = rec_rect(rlo, mid, clo, chi)
                c2[k] = rec_rect(mid, rhi, clo, chi)
            else:
                mid = (clo + chi) // 2
                u1[k] = _rect_universe(n, P, rlo, rhi, clo, mid)
                u2[k] = _rect_universe(n, P, rlo, rhi, mid, chi)
                c1[k] = rec_rect(rlo, rhi, clo, mid)
                c2[k] = rec_rect(rlo, rhi, mid, chi)
            return k

        rec_tri(0, P)
        self._typ = np.asarray(typ, np.int8)
        self._hidx = np.asarray(hidx, np.int32)
        self._u1 = np.asarray(u1, np.int64)
        self._u2 = np.asarray(u2, np.int64)
        self._u3 = np.asarray(u3, np.int64)
        self._c1 = np.asarray(c1, np.int32)
        self._c2 = np.asarray(c2, np.int32)
        self._c3 = np.asarray(c3, np.int32)
        self._leaf_slot = np.asarray(leaf_slot, np.int32)
        self._tri_paths = np.asarray(tri_paths, np.int64).reshape(-1, 3)
        self._rect_paths = np.asarray(rect_paths, np.int64).reshape(-1, 5)
        #: chunk-matrix coordinates of leaf l, in full-DFS leaf order
        self.leaf_I = np.asarray(leaf_I, np.int64)
        self.leaf_J = np.asarray(leaf_J, np.int64)

    @property
    def num_leaves(self) -> int:
        return len(self.leaf_I)

    def counts(self, seed: int, m: int) -> np.ndarray:
        """Edge count per leaf (full-DFS leaf order); bit-identical to
        ``undirected_counts_all``'s ``(leaf_I[l], leaf_J[l])`` entry."""
        num = len(self._typ)
        h_tri = hash_paths(seed, self._tri_paths)
        h_rect = hash_paths(seed, self._rect_paths)
        mm = np.zeros(num, np.int64)
        mm[0] = m
        out = np.zeros(self.num_leaves, np.int64)
        rep = PhiloxReplayer()
        typ, hidx, leaf_slot = self._typ, self._hidx, self._leaf_slot
        u1, u2, u3 = self._u1, self._u2, self._u3
        c1, c2, c3 = self._c1, self._c2, self._c3
        for k in range(num):
            cur = int(mm[k])
            t = typ[k]
            if t == _NODE_LEAF:
                out[leaf_slot[k]] = cur
            elif t == _NODE_TRI:
                if cur:
                    rng = rep.at(h_tri[hidx[k]])
                    mA = hypergeometric(rng, u1[k], u2[k] + u3[k], cur)
                    mB = hypergeometric(rng, u2[k], u3[k], cur - mA)
                else:
                    mA = mB = 0
                mm[c1[k]] = mA
                mm[c2[k]] = mB
                mm[c3[k]] = cur - mA - mB
            else:
                mx = (hypergeometric(rep.at(h_rect[hidx[k]]), u1[k],
                                     u2[k], cur) if cur else 0)
                mm[c1[k]] = mx
                mm[c2[k]] = cur - mx
        return out


@lru_cache(maxsize=32)
def directed_split_tree(n: int, P: int) -> DirectedSplitTree:
    """Seed-independent flattened recursion structure (cached)."""
    return DirectedSplitTree(n, P)


@lru_cache(maxsize=32)
def undirected_split_tree(n: int, P: int) -> UndirectedSplitTree:
    """Seed-independent flattened recursion structure (cached)."""
    return UndirectedSplitTree(n, P)


# --------------------------------------------------------------------------
# d-dimensional cube chunks (RGG / RDG) with Z-order assignment (paper §5.1)
# --------------------------------------------------------------------------

def morton_decode(code: int, dim: int, bits: int) -> Tuple[int, ...]:
    """Z-order curve index -> grid coordinates."""
    coords = [0] * dim
    for b in range(bits):
        for d in range(dim):
            coords[d] |= ((code >> (b * dim + d)) & 1) << b
    return tuple(coords)


def morton_encode(coords: Tuple[int, ...], dim: int, bits: int) -> int:
    code = 0
    for b in range(bits):
        for d in range(dim):
            code |= ((coords[d] >> b) & 1) << (b * dim + d)
    return code


def cube_chunks_for_pe(P: int, dim: int, pe: int, cpd: int = 0) -> List[Tuple[int, ...]]:
    """Locality-aware chunk->PE assignment via the Z-order curve.

    Generates k = 2^(dim*b) >= P chunks and deals them round-robin in
    Morton order, so each PE's chunks are spatially clustered.  The grid
    has ``chunks_per_dim(P, dim)`` chunks along each axis by default;
    passing ``cpd`` explicitly decouples the chunk grid (and hence the
    generated instance) from the PE count.
    """
    cpd = cpd or chunks_per_dim(P, dim)
    b = cpd.bit_length() - 1
    return [morton_decode(c, dim, b) for c in range(cpd ** dim) if c % P == pe]


def chunks_per_dim(P: int, dim: int) -> int:
    """Chunk-grid side length: smallest power of two with 2^(dim*b) >= P."""
    b = 0
    while (1 << (dim * b)) < P:
        b += 1
    return 1 << b
