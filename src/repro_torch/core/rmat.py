"""R-MAT plan emitter (port of the plan half of ``repro.core.rmat``, paper
§3.5.2): the Graph 500 comparison baseline.

Each of the m edges descends log2(n) levels of the recursive adjacency
matrix with probabilities (a, b, c, d); one hashed key per edge id makes
it communication-free.  The plan is one KIND_RMAT chunk per PE covering
its edge-id section ``[m i // P, m (i + 1) // P)``; the descent runs on
the device in ``chunk_rmat``, and :func:`rmat_pe` is one PE's chunk
alone.  Graph 500 semantics: self-loops and duplicate edges are kept.
"""
from __future__ import annotations

import numpy as np

import torch

from .. import obs
from ..distrib.engine import (KIND_RMAT, ChunkSpec, chunk_edges, chunk_plan_from_columns,
                              reseedable_chunk_plan)
from ..kernels.build import resolve_device
from .chunking import section_bounds
from .prng import THREEFRY, device_key

_TAG_RMAT = 51


def rmat_plan(seed: int, log_n: int, m: int, P: int,
              probs=(0.57, 0.19, 0.19, 0.05), rng_impl: str = THREEFRY):
    """ChunkPlan equal, field by field, to ``repro.core.rmat.rmat_plan``."""

    def key_of(s: int) -> np.ndarray:
        one = device_key(s, _TAG_RMAT, impl=rng_impl).numpy().astype(np.uint32)
        return np.broadcast_to(one, (P, one.size))

    with obs.trace("plan/rmat", phase="plan", family="rmat", reseed=False, P=P):
        a, b, c, _ = probs
        sec = m * np.arange(P + 1, dtype=np.int64) // P
        ids = np.arange(P, dtype=np.int64)
        z = np.zeros(P, np.int64)
        fparams = np.broadcast_to(np.array([float(a), float(b), float(c), 0.0]), (P, 4))
        plan = chunk_plan_from_columns(
            P, ids, np.full(P, KIND_RMAT, np.int32), key_of(seed), z,
            sec[1:] - sec[:-1],
            np.stack([np.full(P, log_n, np.int64), sec[:-1], z], axis=1),
            np.ones(P, bool), 1 << log_n, fparams=fparams, rng_impl=rng_impl)
        # edge-id sections are seed-independent: reseeding is a key swap
        return reseedable_chunk_plan(plan, key_fn=key_of)


def rmat_pe(seed: int, log_n: int, m: int, P: int, pe: int,
            probs=(0.57, 0.19, 0.19, 0.05), device=None) -> torch.Tensor:
    """PE ``pe``'s share ``[m pe / P, m (pe + 1) / P)`` of the m edges,
    int64 ``[k, 2]`` on ``device`` (CUDA unless ``"cpu"``):
    ``repro.core.rmat.rmat_pe``, bit for bit, through ``chunk_rmat``."""
    elo, ehi = section_bounds(m, P, pe)
    a, b, c, _ = probs
    spec = ChunkSpec(KIND_RMAT, device_key(seed, _TAG_RMAT), 0, ehi - elo, (log_n, elo, 0),
                     fparams=(float(a), float(b), float(c), 0.0))
    return chunk_edges([spec], resolve_device(device))
