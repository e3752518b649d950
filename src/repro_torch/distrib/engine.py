"""ChunkPlan tables and the batched chunk program (port of the ChunkPlan
half of ``repro.distrib.engine``).

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
rows: the sampler runs every row at once (``chunk_draw`` + ``torch.sort``
rounds), then ``chunk_decode`` decodes every slot and writes the keep
mask.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.prng import THREEFRY, check_rng_impl
from ..core.sampling import round_up_capacity, sample_rows
from ..kernels.sampler.ops import chunk_decode
from ..kernels.sampler.ref import KIND_DIRECTED, KIND_EMPTY, KIND_RECT, KIND_TRI

# chunk kinds understood by the edge program (the reference's codes)
KIND_RMAT, KIND_BA = 4, 5

# kinds whose edges come from the without-replacement index sampler
SAMPLED_KINDS = frozenset({KIND_DIRECTED, KIND_TRI, KIND_RECT})

_EDGE_INPUTS = ("kind", "key_data", "universe", "count", "params", "fparams", "owned")


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
        return tuple(sorted(int(k) for k in np.unique(self.kind) if k != KIND_EMPTY))

    # ---- the runtime's plan protocol ----

    def input_arrays(self) -> Tuple[np.ndarray, ...]:
        return tuple(getattr(self, name) for name in _EDGE_INPUTS)

    def slot_fn(self):
        return _edge_chunk_fn(self.capacity, self.rng_impl, self.kinds_present)

    def stream_index(self) -> np.ndarray:
        return owned_chunk_index(self)

    def signature(self) -> tuple:
        """Static program identity: plans with equal signatures run the
        same batched program on tables of the same shape."""
        return ("chunk", self.kind.shape, self.key_data.shape[-1],
                self.capacity, self.rng_impl, self.kinds_present)

    def reseed(self, seed: int) -> "ChunkPlan":
        """The plan this emitter would have produced for ``seed`` (only
        the seed-dependent columns are recomputed)."""
        if self.reseed_fn is None:
            raise ValueError(
                "plan carries no reseed emitter; re-emit from the GraphSpec")
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


def slice_plan(plan: ChunkPlan, lo: int, hi: int) -> ChunkPlan:
    """Restrict a plan to the PE range [lo, hi) -- every [P, ...] table
    sliced on its leading axis, other fields untouched; the slice drops
    ``reseed_fn``."""
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
                   kinds: Sequence[int] = SAMPLED_KINDS):
    """The batched chunk program: ``rows(kind, key_data, universe, count,
    params, fparams, owned)`` on ``[R]`` row tensors (key_data int32
    ``[R, 2]``) -> (edges int64 ``[R, capacity, 2]``, keep bool ``[R,
    capacity]``); ``keep`` folds in validity and ownership."""
    check_rng_impl(rng_impl)
    other = frozenset(int(k) for k in kinds) - SAMPLED_KINDS - {KIND_EMPTY}
    if other:
        raise NotImplementedError(
            f"chunk kinds {sorted(other)} (KIND_RMAT / KIND_BA) are not "
            f"ported yet: ROADMAP queue 1, item 6 (remaining ChunkPlan kinds)")

    def rows(kind, key_data, universe, count, params, fparams, owned):
        vals = sample_rows(key_data, universe, count, capacity)
        return chunk_decode(vals, kind, params, count, owned)

    return rows
