"""Threshold random hyperbolic graphs (paper §7): the host planning half
of the engine layout of ``repro.core.rhg``, ported.

A central core disk [0, R/2] plus equal-height annuli over [R/2, R];
per-annulus counts are a multinomial drawn by dependent binomials (§7.1)
and per-cell counts come from a hashed 1-D binomial recursion.  The
engine layout is P-independent: the same rings and cells for every P,
with the core as one more cell, so ``generate`` yields the identical
edge set on any number of PEs.  Candidate cell pairs come from the
cell-level Δθ bound (Eq. 8); the device regenerates both cells' points
and evaluates the trig-free Eq. 9 test (``kernels/geom``).  The plans
built here are equal, field by field, to the reference's.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from .. import obs
from ..distrib.engine import (GEOM_HYP, POINTS_POLAR, make_point_plan,
                              pair_plan_from_columns)
from ..kernels.build import resolve_device
from ..kernels.hypdist.ops import precompute_features
from ..kernels.pairmask.ops import hyp_edges
from .prng import THREEFRY, PhiloxReplayer, device_key, fold_in, fold_in_many, hash_paths, host_rng
from .variates import binomial, multinomial_split

_TAG_ANN = 31
_TAG_CELLS, _TAG_V = 32, 33  # per-PE cell layout of rhg_pe (the data pipeline's graph)
_TAG_V_ENG = 35       # device vertex stream of the engine cell layout
_TAG_CELLS_ENG = 36   # range-recursion streams of the engine cell layout
_CELL_OCC = 8         # expected vertices per cell (paper's tuning constant)
# cosh overflows float64 just past this point (cosh(x) ~ e^x / 2)
_COSH_OVERFLOW_R = 700.0


def cosh_threshold(R: float) -> float:
    """cosh(R) for the Eq. 9 threshold, overflow-free (port of
    ``repro.kernels.hypdist.ops.cosh_threshold``).

    Above the float64 overflow point the comparison is evaluated in the
    log domain (log cosh R = R - log 2 + log1p(e^-2R)) and clamped to
    the largest finite float64, so every real feature product still
    compares on the correct side."""
    R = abs(float(R))
    if R < _COSH_OVERFLOW_R:
        return math.cosh(R)
    log_cosh = R - math.log(2.0) + math.log1p(math.exp(-2.0 * R))
    if log_cosh >= math.log(np.finfo(np.float64).max):
        return float(np.finfo(np.float64).max)
    return math.exp(log_cosh)


@dataclass(frozen=True)
class RHGParams:
    n: int
    avg_deg: float
    gamma: float
    seed: int

    @property
    def alpha(self) -> float:
        return (self.gamma - 1.0) / 2.0

    @property
    def C(self) -> float:
        xi = self.alpha / (self.alpha - 0.5)
        return -2.0 * math.log(self.avg_deg * math.pi / (2.0 * xi * xi))

    @property
    def R(self) -> float:
        return 2.0 * math.log(self.n) + self.C


def expected_tail_exponent(params: RHGParams) -> float:
    """Power-law exponent of the degree distribution: 2 alpha + 1, which
    the alpha = (gamma - 1) / 2 parametrization pins to gamma
    (Gugelmann et al.; the law ``stats.validate`` fits against)."""
    return 2.0 * params.alpha + 1.0


def expected_avg_degree(params: RHGParams) -> float:
    """Expected average degree: C (Eq. 4) is calibrated as the inverse of
    the asymptotic mean-degree formula, so the model's expectation is the
    requested ``avg_deg`` (up to o(1) finite-size terms)."""
    return float(params.avg_deg)


def _cdf(params: RHGParams, r: float) -> float:
    """mu(B_r(0)) = (cosh(alpha r) - 1)/(cosh(alpha R) - 1)  (Eq. A.2)."""
    a = params.alpha
    return (math.cosh(a * r) - 1.0) / (math.cosh(a * params.R) - 1.0)


def _inv_cdf_interval(params: RHGParams, lo: float, hi: float, u: np.ndarray) -> np.ndarray:
    """Inverse radial CDF restricted to [lo, hi)."""
    a = params.alpha
    clo, chi = np.cosh(a * lo), np.cosh(a * hi)
    return np.arccosh(clo + u * (chi - clo)) / a


def annuli_boundaries(params: RHGParams) -> np.ndarray:
    """[R/2 = l_0 < l_1 < ... < l_k = R], constant height ~ ln2/alpha."""
    half = params.R / 2.0
    k = max(1, int(params.alpha * half / math.log(2.0)))
    return half + np.arange(k + 1) * (half / k)


def region_counts(params: RHGParams) -> Tuple[int, np.ndarray, np.ndarray]:
    """(core count, per-annulus counts, boundaries), identical on all PEs."""
    bounds = annuli_boundaries(params)
    probs = [_cdf(params, bounds[0])]
    for i in range(len(bounds) - 1):
        probs.append(_cdf(params, bounds[i + 1]) - _cdf(params, bounds[i]))
    probs = np.asarray(probs)
    counts = multinomial_split(host_rng(params.seed, _TAG_ANN), params.n, probs)
    return int(counts[0]), counts[1:], bounds


def _range_table(seed: int, tag: int, annulus: int, units: int,
                 total: int) -> Tuple[np.ndarray, np.ndarray]:
    """Level-synchronous replay of the hashed 1-D binomial recursion over
    [0, units): (per-cell counts, per-cell vertex-id offsets).  Every
    interval draws from ``host_rng(seed, tag, annulus, lo, hi)``."""
    cnt_cells = np.zeros(units, np.int64)
    off_cells = np.zeros(units, np.int64)
    lo = np.array([0], np.int64)
    hi = np.array([units], np.int64)
    cnt = np.array([total], np.int64)
    off = np.array([0], np.int64)
    rep = PhiloxReplayer()
    while True:
        leaf = (hi - lo) == 1
        if leaf.any():
            cnt_cells[lo[leaf]] = cnt[leaf]
            off_cells[lo[leaf]] = off[leaf]
        keep = ~leaf
        if not keep.any():
            return cnt_cells, off_cells
        plo, phi = lo[keep], hi[keep]
        pc, po = cnt[keep], off[keep]
        mid = (plo + phi) // 2
        m = len(plo)
        paths = np.stack([np.full(m, tag, np.int64),
                          np.full(m, annulus, np.int64), plo, phi], axis=1)
        hashes = hash_paths(seed, paths)
        cl = np.empty(m, np.int64)
        for i in range(m):
            c = int(pc[i])
            # binomial(rng, 0, p) == 0 without consuming draws
            cl[i] = binomial(rep.at(hashes[i]), c,
                             (int(mid[i]) - int(plo[i])) / (int(phi[i]) - int(plo[i]))
                             ) if c else 0
        lo = np.empty(2 * m, np.int64)
        hi = np.empty(2 * m, np.int64)
        cnt = np.empty(2 * m, np.int64)
        off = np.empty(2 * m, np.int64)
        lo[0::2], hi[0::2], cnt[0::2], off[0::2] = plo, mid, cl, po
        lo[1::2], hi[1::2], cnt[1::2], off[1::2] = mid, phi, pc - cl, po + cl


def delta_theta(r: np.ndarray, ell: float, R: float) -> np.ndarray:
    """Max angular deviation for a neighbor at radius >= ell (Eq. A.3)."""
    r = np.asarray(r, np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        arg = (np.cosh(r) * math.cosh(ell) - math.cosh(R)) / (np.sinh(r) * math.sinh(ell))
    return np.where(r + ell < R, math.pi, np.arccos(np.clip(arg, -1.0, 1.0)))


@dataclass(frozen=True)
class RhgEngineTable:
    """The P-independent cell layout as flat columns (one row per cell,
    ring-major; ring 0 is the core disk)."""
    ring: np.ndarray        # int64 [N]
    cell: np.ndarray        # int64 [N] angular index within the ring
    clo: np.ndarray         # f64 [N] cosh(alpha * r_lo)
    chi: np.ndarray         # f64 [N] cosh(alpha * r_hi)
    width: np.ndarray       # f64 [N] angular cell width
    count: np.ndarray       # int64 [N]
    gid0: np.ndarray        # int64 [N]
    key_data: np.ndarray    # uint32 [N, W]
    ring_lo: np.ndarray     # f64 [rings] inner radius (0.0 for the core)
    ring_start: np.ndarray  # int64 [rings] first row of each ring
    ring_k: np.ndarray      # int64 [rings] cells per ring
    ring_width: np.ndarray  # f64 [rings]


def rhg_engine_table(params: RHGParams, rng_impl: str = THREEFRY) -> RhgEngineTable:
    """The engine cell layout: one range-recursion replay per ring, one
    batched key derivation over every cell, numpy column assembly."""
    n_core, ann_counts, bounds = region_counts(params)
    a = params.alpha
    B = len(ann_counts)
    ks = np.maximum(1, ann_counts.astype(np.int64) // _CELL_OCC)
    cnts, offs = [], []
    for b in range(B):
        c, o = _range_table(params.seed, _TAG_CELLS_ENG, b, int(ks[b]),
                            int(ann_counts[b]))
        cnts.append(c)
        offs.append(o)
    one = np.ones(1, np.int64)
    ring = np.concatenate([0 * one, np.repeat(np.arange(1, B + 1), ks)])
    cell = np.concatenate([0 * one] + [np.arange(k, dtype=np.int64) for k in ks])
    count = np.concatenate([n_core * one] + cnts)
    gid_ring = n_core + np.concatenate(
        [np.zeros(1, np.int64), np.cumsum(ann_counts.astype(np.int64))[:-1]])
    gid0 = np.concatenate([0 * one] + [gid_ring[b] + offs[b] for b in range(B)])
    # math.cosh, not np.cosh: the SIMD variant can differ by 1 ulp from
    # the libm scalar the reference's rows are built with
    ring_clo = np.array([1.0] + [math.cosh(a * float(x)) for x in bounds[:-1]])
    ring_chi = np.array([math.cosh(a * params.R / 2.0)]
                        + [math.cosh(a * float(x)) for x in bounds[1:]])
    ring_width = np.concatenate([[2.0 * math.pi], 2.0 * math.pi / ks])
    base = device_key(params.seed, _TAG_V_ENG, impl=rng_impl)
    keys = fold_in(fold_in_many(base, torch.from_numpy(ring)), torch.from_numpy(cell))
    return RhgEngineTable(
        ring=ring, cell=cell,
        clo=ring_clo[ring], chi=ring_chi[ring], width=ring_width[ring],
        count=count, gid0=gid0, key_data=keys.numpy().astype(np.uint32),
        ring_lo=np.concatenate([[0.0], bounds[:-1]]),
        ring_start=np.concatenate([0 * one,
                                   1 + np.concatenate([np.zeros(1, np.int64),
                                                       np.cumsum(ks)[:-1]])]),
        ring_k=np.concatenate([one, ks]),
        ring_width=ring_width)


def rhg_engine_point_plan(params: RHGParams, P: int, rng_impl: str = THREEFRY):
    """Polar PointPlan over the engine cell layout (core included), cells
    dealt round-robin by global index, with each cell's first vertex id
    in ``gid0``."""
    with obs.trace("plan/rhg", phase="plan", family="rhg", reseed=False, P=P):
        t = rhg_engine_table(params, rng_impl)
        per_pe, gid0 = [], []
        for pe in range(P):
            sl = slice(pe, None, P)
            per_pe.append((
                t.key_data[sl],
                t.count[sl],
                np.stack([t.ring[sl], t.cell[sl]], axis=1),
                np.stack([t.clo[sl], t.chi[sl], t.width[sl]], axis=1),
            ))
            gid0.append(t.gid0[sl])
        out = make_point_plan(per_pe, POINTS_POLAR, scale=params.alpha, dim=2,
                              rng_impl=rng_impl, gid0=gid0)
        return dataclasses.replace(
            out, reseed_fn=lambda s: rhg_engine_point_plan(
                dataclasses.replace(params, seed=s), P, rng_impl))


def rhg_pair_plan(params: RHGParams, P: int, rng_impl: str = THREEFRY):
    """GEOM_HYP PairPlan: every candidate cell pair exactly once, dealt to
    PEs by the first cell's index.  The candidate list is a pure
    function of the spec, so the union is exact for any P."""
    with obs.trace("plan/rhg", phase="plan", family="rhg", reseed=False, P=P):
        t = rhg_engine_table(params, rng_impl)
        code = _pair_codes(t, params.R)
        N = len(t.ring)
        ia, ib = code // N, code % N
        k = ia.size
        fp = np.broadcast_to(np.array([params.alpha, cosh_threshold(params.R)]), (k, 2))
        geom_a = np.stack([t.clo[ia], t.chi[ia], t.cell[ia].astype(np.float64),
                           t.width[ia]], axis=1)
        geom_b = np.stack([t.clo[ib], t.chi[ib], t.cell[ib].astype(np.float64),
                           t.width[ib]], axis=1)
        out = pair_plan_from_columns(
            P, ia % P, np.full(k, GEOM_HYP, np.int32),
            t.key_data[ia], t.key_data[ib], t.count[ia], t.count[ib],
            t.gid0[ia][:, None], t.gid0[ib][:, None], geom_a, geom_b,
            fp, ia == ib, rng_impl=rng_impl)
        return dataclasses.replace(
            out, reseed_fn=lambda s: rhg_pair_plan(
                dataclasses.replace(params, seed=s), P, rng_impl))


def _pair_codes(t: RhgEngineTable, R: float) -> np.ndarray:
    """Candidate cell-pair codes ``max(i1,i2) * N + min(i1,i2)``, deduped
    and ascending.  One 2-D index grid per ring pair: within a ring the
    window is a fixed span around each cell; across rings it is the Δθ
    window of each cell's angular extent, with the full ring when the
    window wraps."""
    N = len(t.ring)
    rings = len(t.ring_k)
    codes: List[np.ndarray] = []
    for r1 in range(rings):
        k1, w1 = int(t.ring_k[r1]), float(t.ring_width[r1])
        s1, lo1 = int(t.ring_start[r1]), float(t.ring_lo[r1])
        c1 = np.arange(k1, dtype=np.int64)
        for r2 in range(r1 + 1):
            k2, w2 = int(t.ring_k[r2]), float(t.ring_width[r2])
            s2, lo2 = int(t.ring_start[r2]), float(t.ring_lo[r2])
            if lo1 + lo2 < R:
                dth = math.pi
            else:
                dth = float(delta_theta(np.array([lo1]), lo2, R)[0])
            if r1 == r2:
                span = min(int(dth / w1) + 1, k1)
                j = np.arange(span + 1, dtype=np.int64)
                i1 = (s1 + c1)[:, None]
                i2 = s1 + (c1[:, None] + j[None, :]) % k1
                codes.append((np.maximum(i1, i2) * N + np.minimum(i1, i2)).ravel())
                continue
            lo_c = np.floor((c1 * w1 - dth) / w2).astype(np.int64)
            hi_c = np.floor(((c1 + 1) * w1 + dth) / w2).astype(np.int64)
            span = hi_c - lo_c + 1
            full = span >= k2
            # s1 > s2 + k2 here, so i1 > i2 always: i1 is the code's major
            if full.any():
                i1 = (s1 + c1[full])[:, None]
                i2 = (s2 + np.arange(k2, dtype=np.int64))[None, :]
                codes.append((i1 * N + i2).ravel())
            part = ~full
            if part.any():
                S = int(span[part].max())
                j = np.arange(S, dtype=np.int64)
                i2 = s2 + (lo_c[part][:, None] + j[None, :]) % k2
                i1 = np.broadcast_to((s1 + c1[part])[:, None], i2.shape)
                ok = j[None, :] < span[part][:, None]
                codes.append((i1 * N + i2)[ok].ravel())
    allc = np.sort(np.concatenate(codes))
    keep = np.ones(len(allc), bool)
    keep[1:] = allc[1:] != allc[:-1]
    return allc[keep]


# --------------------------------------------------------------------------
# per-PE generation over the P-dependent cell layout (``rhg_pe``), the
# graph of the LM data pipeline
# --------------------------------------------------------------------------

class RangeCounter:
    """1-D hashed binomial recursion over [0, units): per-cell counts and
    recursion-order (== angular-order) vertex-id offsets."""

    def __init__(self, seed: int, tag: int, annulus: int, units: int, total: int):
        self.seed, self.tag, self.annulus, self.units = seed, tag, annulus, units
        self._memo: Dict[Tuple[int, int], int] = {(0, units): total}

    def _children(self, lo: int, hi: int) -> Tuple[int, int]:
        mid = (lo + hi) // 2
        key_l = (lo, mid)
        if key_l not in self._memo:
            cp = self.count(lo, hi)
            rng = host_rng(self.seed, self.tag, self.annulus, lo, hi)
            cl = binomial(rng, cp, (mid - lo) / (hi - lo))
            self._memo[key_l] = cl
            self._memo[(mid, hi)] = cp - cl
        return self._memo[key_l], self._memo[(mid, hi)]

    def count(self, lo: int, hi: int) -> int:
        if (lo, hi) in self._memo:
            return self._memo[(lo, hi)]
        # descend from the smallest memoized ancestor
        clo, chi = 0, self.units
        while (clo, chi) != (lo, hi):
            mid = (clo + chi) // 2
            self._children(clo, chi)
            if hi <= mid:
                chi = mid
            elif lo >= mid:
                clo = mid
            else:
                raise AssertionError("query range must align with recursion")
        return self._memo[(lo, hi)]

    def cell_count(self, i: int) -> int:
        return self.count(i, i + 1)

    def cell_offset(self, i: int) -> int:
        clo, chi, off = 0, self.units, 0
        while chi - clo > 1:
            mid = (clo + chi) // 2
            left, _ = self._children(clo, chi)
            if i < mid:
                chi = mid
            else:
                off += left
                clo = mid
        return off


@dataclass
class _Annulus:
    idx: int
    lo: float
    hi: float
    count: int
    cells: int          # U_b, a multiple of P
    counter: RangeCounter
    gid0: int           # global id offset of this annulus

    @property
    def cell_width(self) -> float:
        return 2.0 * math.pi / self.cells


class RHGPlan:
    """Shared deterministic plan: every PE derives the identical one."""

    def __init__(self, params: RHGParams, P: int):
        self.params, self.P = params, P
        self.n_core, ann_counts, self.bounds = region_counts(params)
        self.annuli: List[_Annulus] = []
        gid = self.n_core
        for b, cnt in enumerate(ann_counts):
            cells = P * max(1, int(cnt) // (_CELL_OCC * P))
            ctr = RangeCounter(params.seed, _TAG_CELLS, b, cells, int(cnt))
            self.annuli.append(
                _Annulus(b, float(self.bounds[b]), float(self.bounds[b + 1]),
                         int(cnt), cells, ctr, gid)
            )
            gid += int(cnt)

    def core_vertices(self) -> Tuple[np.ndarray, np.ndarray]:
        rng = host_rng(self.params.seed, _TAG_V, -1, 0)
        u = rng.random(self.n_core)
        theta = rng.random(self.n_core) * 2.0 * math.pi
        r = _inv_cdf_interval(self.params, 0.0, self.params.R / 2.0, u)
        return r, theta

    def cell_vertices(self, b: int, cell: int) -> Tuple[np.ndarray, np.ndarray, int]:
        """(radii, angles, gid0) of one cell, identical from any PE."""
        ann = self.annuli[b]
        cnt = ann.counter.cell_count(cell)
        rng = host_rng(self.params.seed, _TAG_V, b, cell)
        u = rng.random(cnt)
        theta = (cell + rng.random(cnt)) * ann.cell_width
        r = _inv_cdf_interval(self.params, ann.lo, ann.hi, u)
        return r, theta, ann.gid0 + ann.counter.cell_offset(cell)


class _Segments:
    """The adjacency tests of ``rhg_pe`` as segments of ``hyp_edges``:
    blocks of packed query and candidate rows (the four features, no
    padding, and their gids) and one ``(q_off, q_len, c_off, c_len)`` row
    a test, in the order the reference's ``_adjacency`` calls run."""

    def __init__(self):
        self.q, self.c, self.rows = [], [], []
        self.q_len = self.c_len = 0

    def add_q(self, feat: np.ndarray, gids: np.ndarray) -> int:
        """Append query rows; returns their offset."""
        self.q.append((feat[:, :4], gids))
        self.q_len += len(feat)
        return self.q_len - len(feat)

    def add_c(self, feat: np.ndarray, gids: np.ndarray) -> int:
        """Append candidate rows; returns their offset."""
        self.c.append((feat[:, :4], gids))
        self.c_len += len(feat)
        return self.c_len - len(feat)

    def test(self, q_off: int, q_len: int, c_off: int, c_len: int) -> None:
        self.rows.append((q_off, q_len, c_off, c_len))

    def edges(self, cosh_r: float, device: torch.device) -> np.ndarray:
        """int64 ``[K, 2]`` ``(query gid, candidate gid)`` hits, self-pairs
        dropped, in the reference's ``emit`` order: one upload of the
        features and one of the gids and table, one ``hyp_edges`` call,
        the hits copied back."""
        blocks = self.q + self.c
        feats = np.concatenate([np.zeros((0, 4))] + [f for f, _ in blocks])
        ints = np.concatenate([np.zeros(0, np.int64)] + [g for _, g in blocks]
                              + [np.asarray(self.rows, np.int64).reshape(-1)])
        f = torch.from_numpy(feats).to(device)
        n = torch.from_numpy(ints).to(device)
        Q, C = self.q_len, self.c_len
        uv = hyp_edges(f[:Q], f[Q:], n[:Q], n[Q:Q + C], n[Q + C:].view(-1, 4), cosh_r)
        return uv.cpu().numpy()


def rhg_pe(params: RHGParams, P: int, pe: int, batch: int = 512, device=None
           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """All edges incident to PE ``pe``'s vertices, communication-free
    (``repro.core.rhg.rhg_pe``): (edges [k, 2] with u > v, sorted and
    unique; local gids, radii, angles).  Every adjacency test the
    reference runs becomes a segment of one ``hyp_edges`` call on
    ``device`` (CUDA unless the caller passes ``"cpu"``)."""
    dev = resolve_device(device)
    plan = RHGPlan(params, P)
    R, coshR = params.R, cosh_threshold(params.R)
    chunk_lo, chunk_hi = pe * 2 * math.pi / P, (pe + 1) * 2 * math.pi / P

    # ---- core (recomputed redundantly on every PE, paper §7.1) ----------
    core_r, core_theta = plan.core_vertices()
    core_feat = precompute_features(core_r, core_theta)
    core_gids = np.arange(plan.n_core)
    core_local = (core_theta >= chunk_lo) & (core_theta < chunk_hi)

    # ---- local vertices per annulus -------------------------------------
    local: Dict[int, Tuple[np.ndarray, ...]] = {}
    for ann in plan.annuli:
        cpc = ann.cells // P
        rs, ts, gs = [], [], []
        for cell in range(pe * cpc, (pe + 1) * cpc):
            r, t, g0 = plan.cell_vertices(ann.idx, cell)
            rs.append(r), ts.append(t), gs.append(g0 + np.arange(len(r)))
        r = np.concatenate(rs) if rs else np.zeros(0)
        t = np.concatenate(ts) if ts else np.zeros(0)
        g = np.concatenate(gs) if gs else np.zeros(0, np.int64)
        local[ann.idx] = (r, t, g)

    seg = _Segments()
    core_c = seg.add_c(core_feat, core_gids)

    # ---- core-core: a clique by the triangle inequality, checked through
    # the same Eq. 9 path so float rounding never disagrees across PEs
    if plan.n_core > 1 and core_local.any():
        n_local = int(core_local.sum())
        seg.test(seg.add_q(core_feat[core_local], core_gids[core_local]), n_local,
                 core_c, plan.n_core)

    # ---- queries: local vertices (incl. owned core) vs every region ----
    query_sets = [(core_r[core_local], core_theta[core_local], core_gids[core_local])]
    query_sets += [local[a] for a in local]

    # cache of regenerated remote cells per annulus
    cell_cache: Dict[Tuple[int, int], Tuple[np.ndarray, np.ndarray, int]] = {}

    def get_cell(b: int, cell: int):
        key = (b, cell)
        if key not in cell_cache:
            cell_cache[key] = plan.cell_vertices(b, cell)
        return cell_cache[key]

    for (qr, qt, qg) in query_sets:
        if len(qr) == 0:
            continue
        q_off = seg.add_q(precompute_features(qr, qt), qg)

        # vs core candidates (inward query; no window needed: the core is tiny)
        if plan.n_core > 0:
            for s in range(0, len(qr), batch):
                seg.test(q_off + s, min(batch, len(qr) - s), core_c, plan.n_core)

        # vs each annulus (inward + outward unified)
        for ann in plan.annuli:
            if ann.count == 0:
                continue
            dth = delta_theta(qr, ann.lo, R)
            w = ann.cell_width
            lo_cell = np.floor((qt - dth) / w).astype(np.int64)
            hi_cell = np.floor((qt + dth) / w).astype(np.int64)
            span = np.minimum(hi_cell - lo_cell + 1, ann.cells)
            for s in range(0, len(qr), batch):
                sl = slice(s, s + batch)
                cand_feats, cand_gids = [], []
                # candidate cells of this batch, each once, in first-seen order
                needed = {}
                for qi in range(*sl.indices(len(qr))):
                    for j in range(int(span[qi])):
                        needed[(lo_cell[qi] + j) % ann.cells] = True
                for c in needed:
                    r, t, g0 = get_cell(ann.idx, int(c))
                    if len(r):
                        cand_feats.append(precompute_features(r, t))
                        cand_gids.append(g0 + np.arange(len(r)))
                if not cand_feats:
                    continue
                cand = np.concatenate(cand_feats)
                seg.test(q_off + s, min(batch, len(qr) - s),
                         seg.add_c(cand, np.concatenate(cand_gids)), len(cand))

    e = seg.edges(coshR, dev)
    u = np.maximum(e[:, 0], e[:, 1])
    v = np.minimum(e[:, 0], e[:, 1])
    e = np.unique(np.stack([u, v], axis=1), axis=0)  # repro: allow(no-numpy-unique) per-PE union, as the reference's rhg_pe

    lg = [core_gids[core_local]] + [local[a][2] for a in local]
    lr = [core_r[core_local]] + [local[a][0] for a in local]
    lt = [core_theta[core_local]] + [local[a][1] for a in local]
    return e, np.concatenate(lg), np.concatenate(lr), np.concatenate(lt)
