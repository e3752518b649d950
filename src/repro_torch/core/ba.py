"""Barabási-Albert plan emitter (port of the plan half of
``repro.core.ba``; Sanders & Schulz, adapted in paper §3.5.1).

Batagelj-Brandes fill the edge array M sequentially: ``M[2k] = k // d``
and ``M[2k + 1] = M[r]`` for a uniform ``r`` in ``[0, 2k]``.  Each target
resolves independently by replaying its chain of positions with a
hash-keyed draw per position (``chunk_ba`` on the device), so the plan
is one KIND_BA chunk per PE covering the edge ids of its vertex section,
and :func:`ba_pe` is that chunk alone.
"""
from __future__ import annotations

import numpy as np

import torch

from .. import obs
from ..distrib.engine import (KIND_BA, ChunkSpec, chunk_edges, chunk_plan_from_columns,
                              reseedable_chunk_plan)
from ..kernels.build import resolve_device
from .chunking import section_bounds
from .prng import THREEFRY, device_key

_TAG_BA = 41


def ba_plan(seed: int, n: int, d: int, P: int, rng_impl: str = THREEFRY):
    """ChunkPlan equal, field by field, to ``repro.core.ba.ba_plan``."""

    def key_of(s: int) -> np.ndarray:
        one = device_key(s, _TAG_BA, impl=rng_impl).numpy().astype(np.uint32)
        return np.broadcast_to(one, (P, one.size))

    with obs.trace("plan/ba", phase="plan", family="ba", reseed=False, P=P):
        sec = n * np.arange(P + 1, dtype=np.int64) // P
        ids = np.arange(P, dtype=np.int64)
        z = np.zeros(P, np.int64)
        plan = chunk_plan_from_columns(
            P, ids, np.full(P, KIND_BA, np.int32), key_of(seed), z,
            (sec[1:] - sec[:-1]) * d,
            np.stack([np.full(P, d, np.int64), sec[:-1] * d, z], axis=1),
            np.ones(P, bool), n, rng_impl=rng_impl)
        # edge-id ranges (and so counts and capacity) are seed-independent:
        # reseeding is a key swap
        return reseedable_chunk_plan(plan, key_fn=key_of)


def ba_pe(seed: int, n: int, d: int, P: int, pe: int, device=None) -> torch.Tensor:
    """Edges whose source lies in PE ``pe``'s vertex section, int64 ``[k,
    2]`` on ``device`` (CUDA unless ``"cpu"``): ``repro.core.ba.ba_pe``,
    bit for bit, through ``chunk_ba``."""
    vlo, vhi = section_bounds(n, P, pe)
    spec = ChunkSpec(KIND_BA, device_key(seed, _TAG_BA), 0, (vhi - vlo) * d, (d, vlo * d, 0))
    return chunk_edges([spec], resolve_device(device))
