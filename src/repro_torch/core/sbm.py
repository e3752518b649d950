"""Stochastic block model plan emitter (port of the plan half of
``repro.core.sbm``, the paper's future-work item on the same machinery).

SBM(n, blocks, p_in, p_out): vertices are split into ``blocks`` equal
sections; pairs inside a block appear with ``p_in``, pairs across blocks
with ``p_out``.  Every block region (i, j), i >= j, is an independent
Bernoulli region whose edge count is a hash-seeded Binomial, and whose
edges are a without-replacement sample of its universe: a TRI chunk on
the diagonal, a RECT chunk off it, so ``chunk_sample`` and ``chunk_decode``
run them unchanged.

As in the undirected ER cross, region (i, j) is generated on PE i % P
(owned) and mirrored on PE j % P, so the concatenated owned rows are the
exact edge set.  :func:`sbm_region_edges` and :func:`sbm_pe` are the
per-region and per-PE generators of the reference, on the same kernels.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import obs
from ..distrib.engine import (KIND_RECT, KIND_TRI, ChunkSpec, chunk_edges,
                              chunk_plan_from_columns, reseedable_chunk_plan)
from ..kernels.build import resolve_device
from .chunking import section_bounds, tri_size
from .prng import (THREEFRY, PhiloxReplayer, device_key, fold_in, fold_in_many, hash_paths,
                   host_rng)
from .variates import binomial

_TAG_SBM = 61


def _region_layout(n: int, B: int):
    """Seed-independent flat region columns, canonical i-major order:
    ``(ri, rj, sec, diag, U)`` for all B(B+1)/2 regions (i, j), i >= j."""
    ri = np.repeat(np.arange(B, dtype=np.int64), np.arange(1, B + 1))
    rj = np.arange(len(ri), dtype=np.int64) - ri * (ri + 1) // 2
    sec = n * np.arange(B + 1, dtype=np.int64) // B
    wi, wj = sec[ri + 1] - sec[ri], sec[rj + 1] - sec[rj]
    diag = ri == rj
    U = np.where(diag, wi * (wi - 1) // 2, wi * wj)
    return ri, rj, sec, diag, U


def _region_keys(seed: int, ri: np.ndarray, rj: np.ndarray,
                 rng_impl: str) -> np.ndarray:
    """uint32 [k, 2] key data == ``device_key(seed, _TAG_SBM, i, j)`` rows."""
    keys = fold_in_many(device_key(seed, _TAG_SBM, impl=rng_impl), torch.from_numpy(ri))
    return fold_in(keys, torch.from_numpy(rj)).numpy().astype(np.uint32)


def _region_counts(seed: int, ri: np.ndarray, rj: np.ndarray,
                   U: np.ndarray, pvec: np.ndarray) -> np.ndarray:
    """Binomial(U, p) per region from its own hashed generator (one
    batched hash, replayed draws), as ``host_rng(seed, _TAG_SBM, i, j)``."""
    paths = np.stack([np.full(len(ri), _TAG_SBM, np.int64), ri, rj], axis=1)
    rep = PhiloxReplayer()
    out = np.empty(len(ri), np.int64)
    for k, h in enumerate(hash_paths(seed, paths)):
        out[k] = binomial(rep.at(h), int(U[k]), float(pvec[k]))
    return out


def _region_params(sec: np.ndarray, ri: np.ndarray, rj: np.ndarray,
                   diag: np.ndarray) -> np.ndarray:
    """TRI rows (lo, 0, 0); RECT rows (width, row lo, column lo)."""
    z = np.zeros(len(ri), np.int64)
    return np.where(diag[:, None],
                    np.stack([sec[ri], z, z], axis=1),
                    np.stack([sec[rj + 1] - sec[rj], sec[ri], sec[rj]], axis=1))


def _cross_pack(ri: np.ndarray, rj: np.ndarray, P: int):
    """Flat (region -> PE) dealing: region (i, j) sits owned on PE i % P
    and mirrored on PE j % P (when different), pe-major with within-PE
    rows in region order.  Returns ``(flat_r, pe, owned)``."""
    R = len(ri)
    mir = rj % P != ri % P
    pe_col = np.concatenate([ri % P, rj[mir] % P])
    r_col = np.concatenate([np.arange(R, dtype=np.int64),
                            np.arange(R, dtype=np.int64)[mir]])
    own_col = np.concatenate([np.ones(R, bool), np.zeros(int(mir.sum()), bool)])
    order = np.lexsort((r_col, pe_col))  # pe-major, region-minor
    return r_col[order], pe_col[order], own_col[order]


def _region_spec(seed: int, n: int, B: int, i: int, j: int, p_in: float,
                 p_out: float) -> ChunkSpec:
    """Block region (i, j), i >= j, as one chunk row: its Binomial count
    from ``host_rng(seed, _TAG_SBM, i, j)``, a TRI chunk on the diagonal,
    a RECT chunk off it."""
    if i < j:
        raise ValueError(f"region ({i}, {j}): want i >= j")
    lo_i, hi_i = section_bounds(n, B, i)
    lo_j, hi_j = section_bounds(n, B, j)
    key = device_key(seed, _TAG_SBM, i, j)
    if i == j:
        U = tri_size(hi_i - lo_i)
        return ChunkSpec(KIND_TRI, key, U, binomial(host_rng(seed, _TAG_SBM, i, j), U, p_in),
                         (lo_i, 0, 0))
    U = (hi_i - lo_i) * (hi_j - lo_j)
    return ChunkSpec(KIND_RECT, key, U, binomial(host_rng(seed, _TAG_SBM, i, j), U, p_out),
                     (hi_j - lo_j, lo_i, lo_j))


def sbm_region_edges(seed: int, n: int, B: int, i: int, j: int, p_in: float, p_out: float,
                     device=None) -> torch.Tensor:
    """Edges of block region (i, j), i >= j, the same from any PE:
    ``repro.core.sbm.sbm_region_edges``, bit for bit, as int64 ``[k, 2]``
    on ``device`` (CUDA unless ``"cpu"``)."""
    return chunk_edges([_region_spec(seed, n, B, i, j, p_in, p_out)], resolve_device(device))


def sbm_pe(seed: int, n: int, B: int, p_in: float, p_out: float, P: int, pe: int,
           device=None) -> torch.Tensor:
    """All edges incident to PE ``pe``'s blocks (blocks dealt round-robin),
    each region once, in the reference's order (``repro.core.sbm.sbm_pe``):
    one call of the chunk program over the regions on ``device``."""
    seen, specs = set(), []
    for b in range(pe, B, P):
        for j in range(B):
            region = (b, j) if j <= b else (j, b)
            if region not in seen:
                seen.add(region)
                specs.append(_region_spec(seed, n, B, *region, p_in, p_out))  # repro: allow(no-per-chunk-host-loop) per-PE generator, as the reference's
    dev = resolve_device(device)
    if not specs:
        return torch.zeros((0, 2), dtype=torch.int64, device=dev)
    return chunk_edges(specs, dev)


def sbm_plan(seed: int, n: int, B: int, p_in: float, p_out: float,
             P: int, rng_impl: str = THREEFRY):
    """ChunkPlan equal, field by field, to ``repro.core.sbm.sbm_plan``:
    every block region as a TRI/RECT chunk with a hash-seeded Binomial
    count, generated by both endpoint block owners and owned by the row
    block's PE."""
    with obs.trace("plan/sbm", phase="plan", family="sbm", reseed=False, P=P):
        ri, rj, sec, diag, U = _region_layout(n, B)
        pvec = np.where(diag, p_in, p_out)
        flat_r, pe, owned = _cross_pack(ri, rj, P)
        kind = np.where(diag, KIND_TRI, KIND_RECT).astype(np.int32)[flat_r]
        params = _region_params(sec, ri, rj, diag)[flat_r]
        plan = chunk_plan_from_columns(
            P, pe, kind, _region_keys(seed, ri, rj, rng_impl)[flat_r],
            U[flat_r], _region_counts(seed, ri, rj, U, pvec)[flat_r],
            params, owned, n, rng_impl=rng_impl)
        # the layout and ownership are seed-independent; a reseed recomputes
        # the counts and keys and scatters them through flat_r (mirror rows
        # share their region's count and key)
        return reseedable_chunk_plan(
            plan,
            key_fn=lambda s: _region_keys(s, ri, rj, rng_impl)[flat_r],
            count_fn=lambda s: _region_counts(s, ri, rj, U, pvec)[flat_r])


def sbm_plan_segment(seed: int, n: int, B: int, p_in: float, p_out: float,
                     P: int, lo: int, hi: int, rng_impl: str = THREEFRY):
    """Plan rows of PEs [lo, hi) only: the native segment of the runtime's
    ``PlanEmitter`` overlap.

    Only the regions whose owner or mirror PE falls in the range are
    keyed and counted, so a segment costs about ``(hi - lo) / P`` of the
    plan; the restriction is exact because every region draws from its
    own hashed generator.  The tables equal ``slice_plan(sbm_plan(...),
    lo, hi)`` field by field except ``capacity``, which is the
    segment's own (each slot's draws do not depend on it)."""
    with obs.trace("plan/sbm", phase="plan", family="sbm", reseed=False,
                   P=P, lo=lo, hi=hi):
        ri, rj, sec, diag, U = _region_layout(n, B)
        flat_r, pe, owned = _cross_pack(ri, rj, P)
        sel = (pe >= lo) & (pe < hi)
        flat_r, pe, owned = flat_r[sel], pe[sel], owned[sel]
        # distinct regions this range touches, in canonical order
        needed = np.zeros(len(ri), bool)
        needed[flat_r] = True
        ridx = np.nonzero(needed)[0]
        inv = np.zeros(len(ri), np.int64)
        inv[ridx] = np.arange(len(ridx), dtype=np.int64)
        keys = _region_keys(seed, ri[ridx], rj[ridx], rng_impl)
        cnt = _region_counts(seed, ri[ridx], rj[ridx], U[ridx],
                             np.where(diag[ridx], p_in, p_out))
        kind = np.where(diag, KIND_TRI, KIND_RECT).astype(np.int32)
        params = _region_params(sec, ri, rj, diag)
        return chunk_plan_from_columns(
            hi - lo, pe - lo, kind[flat_r], keys[inv[flat_r]], U[flat_r],
            cnt[inv[flat_r]], params[flat_r], owned, n, rng_impl=rng_impl)


def block_of(n: int, B: int, v: np.ndarray) -> np.ndarray:
    """Block id of each vertex (inverse of ``section_bounds``)."""
    bounds = np.array([section_bounds(n, B, b)[0] for b in range(B)] + [n])
    return np.searchsorted(bounds, v, side="right") - 1
