"""Plan tables and their batched device programs (port of
``repro.distrib.engine``): ChunkPlans for the sampled families,
PointPlans for the vertex positions and PairPlans for the geometric
edges of RGG, RHG and RDG.

The host divide-and-conquer recursions emit a ``[P, C]`` table of chunk
rows -- key, universe, count, decode parameters, owned bit -- and the
device program executes it.  The tables are numpy arrays equal, field by
field, to the reference's; :func:`chunk_plan_from_arrays` builds a port
plan from the reference's own tables so both engines can run the
identical table.

Exact union without sorting: undirected chunk (I, J) is generated on PE
I and PE J but *kept* only by its owner (the row PE), so the
concatenated output is exactly the global edge set.

Where the reference ``vmap``s a per-chunk function over the table, the
port's :func:`_edge_chunk_fn` is one batched function over ``[R]`` chunk
rows: the sampler runs every sampled row at once (one ``chunk_sample``
call: draws, sort and redraw rounds), then ``chunk_decode`` decodes every slot and
writes the keep mask; ``chunk_rmat`` and ``chunk_ba`` write the R-MAT and
BA rows.  Likewise :func:`_point_cell_fn` is one ``cell_points`` launch and
:func:`_pair_fn` one ``pair_edges`` launch over ``[R]`` table rows.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import obs
from ..core.prng import THREEFRY, check_rng_impl
from ..core.sampling import round_up_capacity, sample_rows
from ..kernels.geom.ops import cell_points, pair_edges
from ..kernels.geom.ref import (GEOM_CERT, GEOM_EMPTY, GEOM_HYP, GEOM_TORUS,  # noqa: F401
                                POINTS_CUBE, POINTS_POLAR)
from ..kernels.sampler.ops import chunk_ba, chunk_decode, chunk_rmat
from ..kernels.build import resolve_device
from ..kernels.sampler.ref import (KIND_BA, KIND_DIRECTED, KIND_EMPTY, KIND_RECT,  # noqa: F401
                                   KIND_RMAT, KIND_TRI)
from .world import LocalMesh

# kinds whose edges come from the without-replacement index sampler
SAMPLED_KINDS = frozenset({KIND_DIRECTED, KIND_TRI, KIND_RECT})

_EDGE_INPUTS = ("kind", "key_data", "universe", "count", "params", "fparams", "owned")


def default_mesh(P: int, device=None) -> LocalMesh:
    """1-D mesh over the most local devices that divide P evenly (the
    reference's rule): the first k cards, k the largest divisor of P that
    is at most ``torch.cuda.device_count()``.  A CPU device, or a CUDA
    device with an index, gives a one-row mesh on that device; asking for
    CUDA without a card raises (:func:`resolve_device`)."""
    dev = resolve_device(device)
    if device is not None and (dev.type == "cpu" or torch.device(device).index is not None):
        return LocalMesh((dev,))
    ndev = torch.cuda.device_count()
    use = max(d for d in range(1, min(ndev, P) + 1) if P % d == 0)
    return LocalMesh(tuple(torch.device("cuda", i) for i in range(use)))


@dataclass(frozen=True)
class ChunkSpec:
    """One chunk as the host D&C recursion emits it.

    ``params`` is kind-specific: DIRECTED -> (row_lo, n, 0); TRI ->
    (lo, 0, 0); RECT -> (width, rlo, clo).  ``key`` is the chunk's raw
    key data (uint32 words, or the int64 words of
    :func:`repro_torch.core.prng.device_key`)."""
    kind: int
    key: object
    universe: int
    count: int
    params: Tuple[int, int, int]
    owned: bool = True
    fparams: Tuple[float, ...] = ()


@dataclass(frozen=True)
class ChunkPlan:
    """Host-emitted table driving the edge program.

    All arrays have leading dims [P, C] (PE x chunk slot, padded with
    KIND_EMPTY rows)."""
    kind: np.ndarray        # int32  [P, C]
    key_data: np.ndarray    # uint32 [P, C, 2]
    universe: np.ndarray    # int64  [P, C]
    count: np.ndarray       # int64  [P, C]
    params: np.ndarray      # int64  [P, C, 3]
    fparams: np.ndarray     # float64 [P, C, 4]
    owned: np.ndarray       # bool   [P, C]
    n: int                  # global vertex count (metadata; decode reads params)
    capacity: int           # fixed per-chunk buffer
    rng_impl: str = THREEFRY
    # seed -> equivalent plan for that seed (see reseed())
    reseed_fn: Optional[Callable[[int], "ChunkPlan"]] = field(
        default=None, compare=False, repr=False)

    @property
    def num_pes(self) -> int:
        return self.kind.shape[0]

    @property
    def chunks_per_pe(self) -> int:
        return self.kind.shape[1]

    @property
    def total_edges(self) -> int:
        return int(self.count[self.owned].sum())

    @property
    def kinds_present(self) -> Tuple[int, ...]:
        """Distinct non-empty chunk kinds of the plan."""
        return tuple(sorted(int(k) for k in np.unique(self.kind) if k != KIND_EMPTY))  # repro: allow(no-numpy-unique) O(P*C) static plan metadata, not edge dedup

    @property
    def rmat_log_n(self) -> int:
        """Descent depth shared by every RMAT chunk of the plan."""
        sel = self.kind == KIND_RMAT
        return int(self.params[sel, 0].max()) if sel.any() else 0

    # ---- the runtime's plan protocol ----

    def input_arrays(self) -> Tuple[np.ndarray, ...]:
        return tuple(getattr(self, name) for name in _EDGE_INPUTS)

    def slot_fn(self):
        return _edge_chunk_fn(self.capacity, self.rng_impl, self.kinds_present,
                              self.rmat_log_n)

    def stream_index(self) -> np.ndarray:
        return owned_chunk_index(self)

    def signature(self) -> tuple:
        """Static program identity: plans with equal signatures run the
        same batched program on tables of the same shape."""
        return ("chunk", self.kind.shape, self.key_data.shape[-1],
                self.capacity, self.rng_impl, self.kinds_present, self.rmat_log_n)

    def reseed(self, seed: int) -> "ChunkPlan":
        """The plan this emitter would have produced for ``seed`` (only
        the seed-dependent columns are recomputed)."""
        if self.reseed_fn is None:
            raise ValueError(
                "plan carries no reseed emitter; re-emit from the GraphSpec")
        with obs.trace("plan/reseed", phase="plan", reseed=True,
                       plan=type(self).__name__):
            return self.reseed_fn(int(seed))


def _key_data_of(key) -> np.ndarray:
    if isinstance(key, torch.Tensor):
        key = key.numpy()
    return np.asarray(key).astype(np.uint32).ravel()


def make_chunk_plan(
    per_pe: Sequence[Sequence[ChunkSpec]],
    n: int,
    capacity: Optional[int] = None,
    rng_impl: str = THREEFRY,
) -> ChunkPlan:
    """Pad per-PE chunk lists into the rectangular plan tables."""
    P = len(per_pe)
    C = max(1, max((len(row) for row in per_pe), default=1))
    first = next((row[0] for row in per_pe if row), None)
    width = len(_key_data_of(first.key)) if first is not None else 2
    kind = np.zeros((P, C), np.int32)
    key_data = np.zeros((P, C, width), np.uint32)
    universe = np.zeros((P, C), np.int64)
    count = np.zeros((P, C), np.int64)
    params = np.zeros((P, C, 3), np.int64)
    fparams = np.zeros((P, C, 4), np.float64)
    owned = np.zeros((P, C), bool)
    for pe, row in enumerate(per_pe):
        for j, spec in enumerate(row):
            kind[pe, j] = spec.kind
            key_data[pe, j] = _key_data_of(spec.key)
            universe[pe, j] = spec.universe
            count[pe, j] = spec.count
            params[pe, j] = spec.params
            if spec.fparams:
                fparams[pe, j, : len(spec.fparams)] = spec.fparams
            owned[pe, j] = spec.owned
    cap = capacity if capacity is not None else round_up_capacity(int(count.max()) if count.size else 0)
    return ChunkPlan(kind, key_data, universe, count, params, fparams, owned, n, cap, rng_impl)


def chunk_edges(specs: Sequence[ChunkSpec], device, rng_impl: str = THREEFRY) -> torch.Tensor:
    """int64 ``[k, 2]`` on ``device``: the kept edges of ``specs``, row
    after row, from one call of the chunk program (:func:`_edge_chunk_fn`)
    at the capacity of their largest count.  The per-PE generators of
    :mod:`repro_torch.core` (one PE's chunks, as the paper's PE computes
    them) run on it."""
    plan = make_chunk_plan([specs], 0, rng_impl=rng_impl)
    rows = [torch.from_numpy(a[0].view(np.int32) if a.dtype == np.uint32 else a[0]).to(device)
            for a in plan.input_arrays()]
    edges, keep = plan.slot_fn()(*rows)
    return edges[keep]


def chunk_plan_from_columns(
    P: int,
    pe: np.ndarray,
    kind: np.ndarray,
    key_data: np.ndarray,
    universe: np.ndarray,
    count: np.ndarray,
    params: np.ndarray,
    owned: np.ndarray,
    n: int,
    fparams: Optional[np.ndarray] = None,
    capacity: Optional[int] = None,
    rng_impl: str = THREEFRY,
) -> ChunkPlan:
    """Vectorized :func:`make_chunk_plan`: flat per-chunk columns in.

    ``pe`` [k] assigns each flat row to its PE; within-PE slot order is
    the rows' order of appearance (a stable sort groups them)."""
    pe = np.asarray(pe, np.int64)
    k = len(pe)
    per = np.bincount(pe, minlength=P) if k else np.zeros(P, np.int64)
    C = max(1, int(per.max()) if per.size else 0)
    W = key_data.shape[-1] if k else 2
    order = np.argsort(pe, kind="stable")
    spe = pe[order]
    starts = np.concatenate(([0], np.cumsum(per)))
    col = np.arange(k, dtype=np.int64) - starts[spe]
    t_kind = np.zeros((P, C), np.int32)
    t_key = np.zeros((P, C, W), np.uint32)
    t_uni = np.zeros((P, C), np.int64)
    t_cnt = np.zeros((P, C), np.int64)
    t_par = np.zeros((P, C, 3), np.int64)
    t_fpar = np.zeros((P, C, 4), np.float64)
    t_own = np.zeros((P, C), bool)
    if k:
        t_kind[spe, col] = np.asarray(kind, np.int32)[order]
        t_key[spe, col] = np.asarray(key_data, np.uint32)[order]
        t_uni[spe, col] = np.asarray(universe, np.int64)[order]
        t_cnt[spe, col] = np.asarray(count, np.int64)[order]
        t_par[spe, col] = np.asarray(params, np.int64)[order]
        if fparams is not None:
            fp = np.asarray(fparams, np.float64)
            t_fpar[spe, col, : fp.shape[-1]] = fp[order]
        t_own[spe, col] = np.asarray(owned, bool)[order]
    cap = capacity if capacity is not None else round_up_capacity(
        int(count.max()) if k else 0)
    return ChunkPlan(t_kind, t_key, t_uni, t_cnt, t_par, t_fpar, t_own,
                     n, cap, rng_impl)


def chunk_plan_from_arrays(tables: Dict[str, np.ndarray], n: int,
                           capacity: int) -> ChunkPlan:
    """A port plan holding exactly the given ``[P, C]`` tables (``kind``,
    ``key_data``, ``universe``, ``count``, ``params``, ``fparams``,
    ``owned``), e.g. those of a plan the reference emitted, so that both
    engines execute the identical table."""
    return ChunkPlan(
        kind=np.asarray(tables["kind"], np.int32),
        key_data=np.asarray(tables["key_data"], np.uint32),
        universe=np.asarray(tables["universe"], np.int64),
        count=np.asarray(tables["count"], np.int64),
        params=np.asarray(tables["params"], np.int64),
        fparams=np.asarray(tables["fparams"], np.float64),
        owned=np.asarray(tables["owned"], bool),
        n=int(n), capacity=int(capacity))


def deal_plan(plan: ChunkPlan, P: int) -> ChunkPlan:
    """Re-deal a plan built for k *virtual* chunks onto P real PEs.

    The owned rows of the k-PE plan are dealt round-robin onto P PEs, so
    any P executes the identical edge set.  Mirror (recomputed,
    un-owned) rows are dropped -- ownership already makes the union
    exact."""
    with obs.trace("plan/deal", phase="plan", P=P, virtual=plan.num_pes):
        return _deal_plan(plan, P)


def _deal_plan(plan: ChunkPlan, P: int) -> ChunkPlan:
    # np.argwhere walks v-major, c-minor; dealing by stable sort on v % P
    # keeps that order within each PE
    idx = np.argwhere(plan.owned & (plan.kind != KIND_EMPTY))
    src = (idx[:, 0], idx[:, 1])
    dealt = chunk_plan_from_columns(
        P, idx[:, 0] % P, plan.kind[src], plan.key_data[src],
        plan.universe[src], plan.count[src], plan.params[src],
        np.ones(len(idx), bool), plan.n, fparams=plan.fparams[src],
        capacity=plan.capacity, rng_impl=plan.rng_impl)
    reseed = None
    if plan.reseed_fn is not None:
        reseed = lambda s, _p=plan, _P=P: deal_plan(_p.reseed(s), _P)
    return dataclasses.replace(dealt, reseed_fn=reseed)


def reseedable_chunk_plan(plan: ChunkPlan, key_fn: Callable[[int], np.ndarray],
                          count_fn: Optional[Callable[[int], np.ndarray]] = None,
                          ) -> ChunkPlan:
    """Attach a structure/seed-split reseed emitter to a ChunkPlan.

    ``key_fn(seed) -> uint32 [k, W]`` and ``count_fn(seed) -> int64 [k]``
    recompute the two seed-dependent columns for the k non-empty chunks
    in table (pe-major) order; everything else is reused.  The derived
    capacity follows :func:`make_chunk_plan`'s rule, so a reseeded plan
    equals a cold emission."""
    pos = np.argwhere(plan.kind != KIND_EMPTY)
    idx = (pos[:, 0], pos[:, 1])

    def emit(seed: int) -> ChunkPlan:
        if count_fn is None:
            count, cap = plan.count, plan.capacity
        else:
            flat = np.asarray(count_fn(seed), np.int64)
            count = np.zeros_like(plan.count)
            count[idx] = flat
            cap = round_up_capacity(int(flat.max()) if flat.size else 0)
        key_data = np.zeros_like(plan.key_data)
        key_data[idx] = np.asarray(key_fn(seed), np.uint32)
        return dataclasses.replace(plan, key_data=key_data, count=count,
                                   capacity=cap, reseed_fn=emit)

    return dataclasses.replace(plan, reseed_fn=emit)


def owned_chunk_index(plan: ChunkPlan) -> np.ndarray:
    """int64 [K, 2] of (pe, slot) for every owned non-empty chunk, in
    stream order (pe-major)."""
    sel = plan.owned & (plan.kind != KIND_EMPTY)
    return np.argwhere(sel).astype(np.int64)


def slice_plan(plan, lo: int, hi: int):
    """Restrict a table plan (:class:`ChunkPlan` or :class:`PairPlan`) to
    the PE range [lo, hi): every [P, ...] table sliced on its leading
    axis, other fields untouched.  The segmenter behind
    :meth:`repro_torch.distrib.runtime.PlanEmitter.from_plan`: segment
    PEs are re-indexed to [0, hi - lo), and the slice drops ``reseed_fn``
    (a segment is not a reseedable whole plan)."""
    P = plan.num_pes
    if not 0 <= lo < hi <= P:
        raise ValueError(f"bad PE range [{lo}, {hi}) for P={P}")
    upd = {}
    for f in dataclasses.fields(plan):
        v = getattr(plan, f.name)
        if isinstance(v, np.ndarray) and v.ndim >= 1 and v.shape[0] == P:
            upd[f.name] = v[lo:hi]
    upd["reseed_fn"] = None
    return dataclasses.replace(plan, **upd)


def _edge_chunk_fn(capacity: int, rng_impl: str,
                   kinds: Sequence[int] = SAMPLED_KINDS, log_n: int = 0):
    """The batched chunk program: ``rows(kind, key_data, universe, count,
    params, fparams, owned)`` on ``[R]`` row tensors (key_data int32
    ``[R, 2]``) -> (edges int64 ``[R, capacity, 2]``, keep bool ``[R,
    capacity]``); ``keep`` folds in validity and ownership.

    Each kernel runs only for the kinds present: the sampled rows draw and
    sort (the other rows' counts are 0 there, so they sample nothing) and
    ``chunk_decode`` writes every row; ``chunk_rmat`` (``log_n`` levels)
    and ``chunk_ba`` then write their own rows over it, or the first of
    them writes every row when no row is sampled."""
    check_rng_impl(rng_impl)
    kinds = frozenset(int(k) for k in kinds) - {KIND_EMPTY}
    sampled = kinds & SAMPLED_KINDS
    unknown = kinds - SAMPLED_KINDS - {KIND_RMAT, KIND_BA}
    if unknown:
        raise ValueError(f"unknown chunk kinds {sorted(unknown)}")

    def rows(kind, key_data, universe, count, params, fparams, owned):
        out = None
        if sampled:
            cnt = count
            if kinds - SAMPLED_KINDS:
                is_sampled = (kind == KIND_DIRECTED) | (kind == KIND_TRI) | (kind == KIND_RECT)
                cnt = torch.where(is_sampled, count, 0)
            out = chunk_decode(sample_rows(key_data, universe, cnt, capacity),
                               kind, params, count, owned)
        if KIND_RMAT in kinds:
            out = chunk_rmat(key_data, kind, params, fparams, count, owned, log_n,
                             capacity, out)
        if KIND_BA in kinds:
            out = chunk_ba(key_data, kind, params, count, owned, capacity, out)
        if out is None:     # a plan of EMPTY rows only
            R = kind.shape[0]
            out = (torch.zeros((R, capacity, 2), dtype=torch.int64, device=kind.device),
                   torch.zeros((R, capacity), dtype=torch.bool, device=kind.device))
        return out

    return rows


# --------------------------------------------------------------------------
# point plans: spatial (RGG cube cells) and radial (RHG annulus cells)
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class PointPlan:
    """Per-PE cell table for vertex generation.

    kind == 'cube':  point = (cell + u) / scale           (scale = grid g)
    kind == 'polar': r = arccosh(g0 + u0*(g1 - g0)) / scale  (scale = alpha)
                     theta = (cell[1] + u1) * g2

    ``gid0`` (the port's addition, not a device input) holds each cell's
    first vertex id, so the streamed points can be put in id order."""
    kind: str               # POINTS_CUBE | POINTS_POLAR
    key_data: np.ndarray    # uint32  [P, C, W] per-cell key
    count: np.ndarray       # int64   [P, C]
    cell: np.ndarray        # int64   [P, C, K] integer cell coordinates
    geom: np.ndarray        # float64 [P, C, G] kind-specific reals
    scale: float
    dim: int                # output dims per point
    capacity: int
    rng_impl: str = THREEFRY
    reseed_fn: Optional[Callable[[int], "PointPlan"]] = field(
        default=None, compare=False, repr=False)
    gid0: Optional[np.ndarray] = field(default=None, compare=False, repr=False)

    @property
    def num_pes(self) -> int:
        return self.count.shape[0]

    # ---- the runtime's plan protocol ----

    def input_arrays(self) -> Tuple[np.ndarray, ...]:
        return (self.key_data, self.count, self.cell, self.geom)

    def slot_fn(self):
        return _point_cell_fn(self.kind, self.capacity, self.dim, self.scale,
                              self.rng_impl)

    def stream_index(self) -> np.ndarray:
        """Non-empty cells in pe-major order (every cell is unique)."""
        return np.argwhere(self.count > 0).astype(np.int64)

    def signature(self) -> tuple:
        return ("point", self.kind, self.count.shape, self.key_data.shape[-1],
                self.cell.shape[-1], self.geom.shape[-1], self.scale, self.dim,
                self.capacity, self.rng_impl)

    def reseed(self, seed: int) -> "PointPlan":
        """Equivalent plan for ``seed`` (see :meth:`ChunkPlan.reseed`)."""
        if self.reseed_fn is None:
            raise ValueError(
                "plan carries no reseed emitter; re-emit from the GraphSpec")
        with obs.trace("plan/reseed", phase="plan", reseed=True,
                       plan=type(self).__name__):
            return self.reseed_fn(int(seed))


def make_point_plan(
    per_pe: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]],
    kind: str,
    scale: float,
    dim: int,
    capacity: Optional[int] = None,
    rng_impl: str = THREEFRY,
    gid0: Optional[Sequence[np.ndarray]] = None,
) -> PointPlan:
    """per_pe: one (key_data [Ci,W], counts [Ci], cells [Ci,K], geom [Ci,G])
    tuple per PE; rows are padded to the widest PE with count-0 cells.
    ``gid0``, when given, is each PE's [Ci] first vertex ids."""
    P = len(per_pe)
    C = max(1, max(int(len(c)) for _, c, _, _ in per_pe))
    first = next((row for row in per_pe if row[0].size), None)
    W = first[0].shape[-1] if first is not None else 2
    K = first[2].shape[-1] if first is not None else 1
    G = first[3].shape[-1] if first is not None else 1
    key_data = np.zeros((P, C, W), np.uint32)
    count = np.zeros((P, C), np.int64)
    cell = np.zeros((P, C, K), np.int64)
    geom = np.ones((P, C, G), np.float64)  # 1s: harmless in both transforms
    g0 = np.zeros((P, C), np.int64)
    for pe, (kd, cnt, cl, gm) in enumerate(per_pe):
        k = len(cnt)
        if k:
            key_data[pe, :k] = kd
            count[pe, :k] = cnt
            cell[pe, :k] = cl
            geom[pe, :k] = gm
            if gid0 is not None:
                g0[pe, :k] = gid0[pe]
    cap = capacity if capacity is not None else max(8, int(count.max()) + 8)
    check_rng_impl(rng_impl)
    return PointPlan(kind, key_data, count, cell, geom, scale, dim, cap, rng_impl,
                     gid0=g0 if gid0 is not None else None)


def _point_cell_fn(plan_kind: str, capacity: int, dim: int, scale: float,
                   rng_impl: str):
    """The batched cell program: ``rows(key_data, count, cell, geom)`` on
    ``[R]`` row tensors -> (points float64 ``[R, capacity, dim]``, mask
    bool ``[R, capacity]``)."""
    check_rng_impl(rng_impl)

    def rows(key_data, count, cell, geom):
        return cell_points(key_data, count, cell, geom, kind=plan_kind, scale=scale,
                           capacity=capacity, dim=dim)

    return rows


# --------------------------------------------------------------------------
# pair plans: the geometric edge table (RHG, RGG and RDG)
# --------------------------------------------------------------------------

# key impls whose draws are a pure function of (key, slot), the invariant
# that lets every candidate-pair row regenerate its cells' points
COUNTER_RNGS = frozenset({THREEFRY})


def require_counter_rng(rng_impl: str) -> None:
    """Reject non-counter key impls for pair plans (see COUNTER_RNGS)."""
    if rng_impl not in COUNTER_RNGS:
        raise ValueError(
            f"pair plans require a counter-based per-element PRNG, got "
            f"{rng_impl!r}: geometric edge plans recompute cell points from "
            f"hashed keys across candidate-pair rows; use rng_impl of "
            f"{sorted(COUNTER_RNGS)} for RGG/RHG/RDG")


def pair_slot_index(i, j, cap: int):
    """Lexicographic index of slot pair (i, j), i < j, among the
    C(cap, 2) ordered pairs of a row (the bit GEOM_CERT rows use for
    their per-edge emit masks).  Works on ints and int tensors."""
    return i * (cap - 1) - i * (i - 1) // 2 + (j - i - 1)


@dataclass(frozen=True)
class PairSpec:
    """One candidate-pair row as a host geometric emitter produces it.

    GEOM_HYP (RHG annulus-cell pair): side = (key_data, count, gid0,
      geom = (cosh(a*lo), cosh(a*hi), cell_index, angular_width));
      fparams = (alpha, cosh R).
    GEOM_TORUS (RGG cube-cell pair): side = (key_data, count, gid0,
      geom = integer cell coordinates as floats); fparams = (grid side g,
      r^2).
    ``self_pair`` restricts a row to slot pairs i < j (cell-vs-itself)."""
    kind: int
    key_a: object
    key_b: object
    count_a: int
    count_b: int
    gid_a: object           # int (gid offset) or int sequence
    gid_b: object
    geom_a: Sequence[float]
    geom_b: Sequence[float]
    fparams: Tuple[float, ...] = ()
    self_pair: bool = False


_PAIR_INPUTS = ("kind", "key_a", "key_b", "count_a", "count_b", "gid_a",
                "gid_b", "geom_a", "geom_b", "fparams", "self_pair", "active")


@dataclass(frozen=True)
class PairPlan:
    """Host-emitted candidate-pair table for geometric edge generation.

    Every candidate pair appears exactly once globally, so the
    concatenated per-PE outputs are the exact edge set.  All arrays have
    leading dims [P, C] (PE x pair slot, padded with GEOM_EMPTY rows);
    trailing widths are emitter-derived (W key words, K gid words, G
    geometry features, F float params)."""
    kind: np.ndarray        # int32  [P, C]  (GEOM_*)
    key_a: np.ndarray       # uint32 [P, C, W]
    key_b: np.ndarray       # uint32 [P, C, W]
    count_a: np.ndarray     # int64  [P, C]
    count_b: np.ndarray     # int64  [P, C]
    gid_a: np.ndarray       # int64  [P, C, K]
    gid_b: np.ndarray       # int64  [P, C, K]
    geom_a: np.ndarray      # float64 [P, C, G]
    geom_b: np.ndarray      # float64 [P, C, G]
    fparams: np.ndarray     # float64 [P, C, F]
    self_pair: np.ndarray   # bool   [P, C]
    active: np.ndarray      # bool   [P, C]
    capacity: int           # per-cell point capacity
    dim: int = 2            # spatial dimension (TORUS decode)
    rng_impl: str = THREEFRY
    reseed_fn: Optional[Callable[[int], "PairPlan"]] = field(
        default=None, compare=False, repr=False)

    @property
    def num_pes(self) -> int:
        return self.active.shape[0]

    @property
    def pairs_per_pe(self) -> int:
        return self.active.shape[1]

    @property
    def total_pairs(self) -> int:
        return int(self.active.sum())

    @property
    def kinds_present(self) -> Tuple[int, ...]:
        """Distinct non-empty geometry kinds of the plan."""
        return tuple(sorted(int(k) for k in np.unique(self.kind) if k != GEOM_EMPTY))  # repro: allow(no-numpy-unique) O(P*C) static plan metadata, not edge dedup

    # ---- the runtime's plan protocol ----

    def input_arrays(self) -> Tuple[np.ndarray, ...]:
        return tuple(getattr(self, name) for name in _PAIR_INPUTS)

    def slot_fn(self):
        return _pair_fn(self.capacity, self.rng_impl, self.kinds_present, self.dim)

    def stream_index(self) -> np.ndarray:
        return active_pair_index(self)

    def signature(self) -> tuple:
        return ("pair", self.active.shape, self.key_a.shape[-1], self.gid_a.shape[-1],
                self.geom_a.shape[-1], self.fparams.shape[-1], self.capacity,
                self.kinds_present, self.dim, self.rng_impl)

    def reseed(self, seed: int) -> "PairPlan":
        """Equivalent plan for ``seed`` (see :meth:`ChunkPlan.reseed`)."""
        if self.reseed_fn is None:
            raise ValueError(
                "plan carries no reseed emitter; re-emit from the GraphSpec")
        with obs.trace("plan/reseed", phase="plan", reseed=True,
                       plan=type(self).__name__):
            return self.reseed_fn(int(seed))


def make_pair_plan(
    per_pe: Sequence[Sequence[PairSpec]],
    capacity: Optional[int] = None,
    rng_impl: str = THREEFRY,
    dim: int = 2,
) -> PairPlan:
    """Pad per-PE pair lists into the rectangular plan tables; trailing
    widths come from the widest spec handed in."""
    require_counter_rng(rng_impl)
    P = len(per_pe)
    C = max(1, max((len(row) for row in per_pe), default=1))
    specs = [sp for row in per_pe for sp in row]
    W = len(_key_data_of(specs[0].key_a)) if specs else 2
    K = max([1] + [len(np.atleast_1d(np.asarray(s))) for sp in specs
                   for s in (sp.gid_a, sp.gid_b)])
    G = max([1] + [len(np.atleast_1d(np.asarray(g, np.float64))) for sp in specs
                   for g in (sp.geom_a, sp.geom_b)])
    F = max([1] + [len(sp.fparams) for sp in specs])
    kind = np.zeros((P, C), np.int32)
    key_a = np.zeros((P, C, W), np.uint32)
    key_b = np.zeros((P, C, W), np.uint32)
    count_a = np.zeros((P, C), np.int64)
    count_b = np.zeros((P, C), np.int64)
    gid_a = np.zeros((P, C, K), np.int64)
    gid_b = np.zeros((P, C, K), np.int64)
    geom_a = np.ones((P, C, G), np.float64)  # 1s: harmless in every decode
    geom_b = np.ones((P, C, G), np.float64)
    fparams = np.zeros((P, C, F), np.float64)
    self_pair = np.zeros((P, C), bool)
    active = np.zeros((P, C), bool)
    for pe, row in enumerate(per_pe):
        for j, sp in enumerate(row):
            kind[pe, j] = sp.kind
            key_a[pe, j] = _key_data_of(sp.key_a)
            key_b[pe, j] = _key_data_of(sp.key_b)
            count_a[pe, j] = sp.count_a
            count_b[pe, j] = sp.count_b
            ga = np.atleast_1d(np.asarray(sp.gid_a, np.int64))
            gb = np.atleast_1d(np.asarray(sp.gid_b, np.int64))
            gid_a[pe, j, : len(ga)] = ga
            gid_b[pe, j, : len(gb)] = gb
            va = np.atleast_1d(np.asarray(sp.geom_a, np.float64))
            vb = np.atleast_1d(np.asarray(sp.geom_b, np.float64))
            geom_a[pe, j, : len(va)] = va
            geom_b[pe, j, : len(vb)] = vb
            if sp.fparams:
                fparams[pe, j, : len(sp.fparams)] = sp.fparams
            self_pair[pe, j] = sp.self_pair
            active[pe, j] = True
    cap = capacity
    if cap is None:
        cmax = max(int(count_a.max()) if count_a.size else 0,
                   int(count_b.max()) if count_b.size else 0)
        cap = round_up_capacity(cmax, mult=8)
    return PairPlan(kind, key_a, key_b, count_a, count_b, gid_a, gid_b,
                    geom_a, geom_b, fparams, self_pair, active, cap, dim, rng_impl)


def pair_plan_from_columns(
    P: int,
    pe: np.ndarray,
    kind: np.ndarray,
    key_a: np.ndarray,
    key_b: np.ndarray,
    count_a: np.ndarray,
    count_b: np.ndarray,
    gid_a: np.ndarray,
    gid_b: np.ndarray,
    geom_a: np.ndarray,
    geom_b: np.ndarray,
    fparams: np.ndarray,
    self_pair: np.ndarray,
    capacity: Optional[int] = None,
    rng_impl: str = THREEFRY,
    dim: int = 2,
) -> PairPlan:
    """Vectorized :func:`make_pair_plan`: flat per-pair columns in.

    ``pe`` [k] assigns each flat row to its PE; within-PE slot order is
    the rows' order of appearance (a stable sort groups them)."""
    require_counter_rng(rng_impl)
    pe = np.asarray(pe, np.int64)
    k = len(pe)
    per = np.bincount(pe, minlength=P) if k else np.zeros(P, np.int64)
    C = max(1, int(per.max()) if per.size else 0)
    W = key_a.shape[-1] if k else 2
    K = gid_a.shape[-1] if k else 1
    G = geom_a.shape[-1] if k else 1
    F = fparams.shape[-1] if k else 1
    order = np.argsort(pe, kind="stable")
    spe = pe[order]
    starts = np.concatenate(([0], np.cumsum(per)))
    col = np.arange(k, dtype=np.int64) - starts[spe]
    t_kind = np.zeros((P, C), np.int32)
    t_ka = np.zeros((P, C, W), np.uint32)
    t_kb = np.zeros((P, C, W), np.uint32)
    t_ca = np.zeros((P, C), np.int64)
    t_cb = np.zeros((P, C), np.int64)
    t_ga = np.zeros((P, C, K), np.int64)
    t_gb = np.zeros((P, C, K), np.int64)
    t_va = np.ones((P, C, G), np.float64)
    t_vb = np.ones((P, C, G), np.float64)
    t_fp = np.zeros((P, C, F), np.float64)
    t_sp = np.zeros((P, C), bool)
    t_act = np.zeros((P, C), bool)
    if k:
        t_kind[spe, col] = np.asarray(kind, np.int32)[order]
        t_ka[spe, col] = np.asarray(key_a, np.uint32)[order]
        t_kb[spe, col] = np.asarray(key_b, np.uint32)[order]
        t_ca[spe, col] = np.asarray(count_a, np.int64)[order]
        t_cb[spe, col] = np.asarray(count_b, np.int64)[order]
        t_ga[spe, col] = np.asarray(gid_a, np.int64)[order]
        t_gb[spe, col] = np.asarray(gid_b, np.int64)[order]
        t_va[spe, col] = np.asarray(geom_a, np.float64)[order]
        t_vb[spe, col] = np.asarray(geom_b, np.float64)[order]
        t_fp[spe, col] = np.asarray(fparams, np.float64)[order]
        t_sp[spe, col] = np.asarray(self_pair, bool)[order]
        t_act[spe, col] = True
    cap = capacity
    if cap is None:
        cmax = max(int(count_a.max()) if k else 0,
                   int(count_b.max()) if k else 0)
        cap = round_up_capacity(cmax, mult=8)
    return PairPlan(t_kind, t_ka, t_kb, t_ca, t_cb, t_ga, t_gb,
                    t_va, t_vb, t_fp, t_sp, t_act, cap, dim, rng_impl)


def pair_plan_from_arrays(tables: Dict[str, np.ndarray], capacity: int,
                          dim: int = 2) -> PairPlan:
    """A port plan holding exactly the given ``[P, C]`` tables (the
    :data:`_PAIR_INPUTS` fields), e.g. those of a plan the reference
    emitted, so that both engines execute the identical table."""
    dtypes = {"kind": np.int32, "key_a": np.uint32, "key_b": np.uint32,
              "count_a": np.int64, "count_b": np.int64, "gid_a": np.int64,
              "gid_b": np.int64, "geom_a": np.float64, "geom_b": np.float64,
              "fparams": np.float64, "self_pair": bool, "active": bool}
    return PairPlan(**{f: np.asarray(tables[f], dtypes[f]) for f in _PAIR_INPUTS},
                    capacity=int(capacity), dim=int(dim))


def active_pair_index(plan: PairPlan) -> np.ndarray:
    """int64 [K, 2] of (pe, slot) for every active candidate pair, in
    stream order (every pair is globally unique, so active == owned)."""
    return np.argwhere(plan.active).astype(np.int64)


def _pair_fn(capacity: int, rng_impl: str, kinds: Sequence[int] = (GEOM_HYP,),
             dim: int = 2):
    """The batched candidate-pair program: ``rows(kind, key_a, key_b,
    count_a, count_b, gid_a, gid_b, geom_a, geom_b, fparams, self_pair,
    active)`` on ``[R]`` row tensors -> (edges int64 ``[R, capacity^2,
    2]``, keep bool ``[R, capacity^2]``) of canonical ``(max gid, min
    gid)`` edges; ``keep`` folds in validity, the self-pair rule and the
    active bit.

    A caller that knows its rows' counts on the host may pass ``stage``,
    each kind's largest count (see :func:`pair_edges`), which sizes the
    staging of their points."""
    require_counter_rng(rng_impl)
    kinds = tuple(sorted(frozenset(int(k) for k in kinds) - {GEOM_EMPTY}))

    def rows(kind, key_a, key_b, count_a, count_b, gid_a, gid_b, geom_a, geom_b,
             fparams, self_pair, active, stage=None):
        return pair_edges(kind, key_a, key_b, count_a, count_b, gid_a, gid_b,
                          geom_a, geom_b, fparams, self_pair, active,
                          capacity=capacity, dim=dim, kinds=kinds, stage=stage)

    return rows
