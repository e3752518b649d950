"""Synthetic inputs of the R-MAT, BA and wedge-closing kernels, made from a
seed with numpy: chunk rows of every kind mixed in one batch (RMAT, BA,
the sampled kinds and EMPTY; counts 0 and up to capacity, edge ids past
2^31, unowned rows) and clustering neighbour tables (empty and
all-sentinel rows, full rows) with chunk and pair buffers.  Shared by the
card tests of the kernels and ``chip_smoke.py``, which import no JAX.
"""
import numpy as np
import torch

from repro_torch.kernels.sampler.ref import (KIND_BA, KIND_DIRECTED, KIND_EMPTY, KIND_RECT,
                                             KIND_RMAT, KIND_TRI)

KINDS = (KIND_RMAT, KIND_BA, KIND_DIRECTED, KIND_TRI, KIND_RECT, KIND_EMPTY)
SENTINEL = 1 << 62      # the clustering table's padding (stats.accumulate._NB_SENTINEL)
PROBS = ((0.57, 0.19, 0.19, 0.05), (0.45, 0.25, 0.15, 0.15), (0.25, 0.25, 0.25, 0.25))


def chunk_rows(R: int, cap: int, d: int, seed: int, device="cpu"):
    """``(key, kind, params, fparams, count, owned)`` of ``R`` rows of kinds
    drawn from :data:`KINDS`, RMAT and BA most often: RMAT rows start at
    edge ids up to 2^40 with one of :data:`PROBS`, BA rows at ids up to
    2^34 with ``d`` edges a vertex; counts are random, with 0 and ``cap``
    among them."""
    rng = np.random.default_rng(seed)
    kind = rng.choice(KINDS, R, p=[0.35, 0.35, 0.075, 0.075, 0.05, 0.1]).astype(np.int32)
    kind[:2] = (KIND_RMAT, KIND_BA)[:R]
    key = rng.integers(-2 ** 31, 2 ** 31, (R, 2)).astype(np.int32)
    params = rng.integers(0, 1 << 20, (R, 3))
    params[:, 0] = np.where(kind == KIND_BA, d, params[:, 0])
    params[:, 1] = np.where(kind == KIND_RMAT, rng.integers(0, 1 << 40, R),
                            np.where(kind == KIND_BA, rng.integers(0, 1 << 34, R) // d * d,
                                     params[:, 1]))
    fparams = np.array(PROBS)[rng.integers(0, len(PROBS), R)]
    count = rng.integers(0, cap + 1, R)
    count[::4], count[1::5] = cap, 0
    owned = rng.random(R) < 0.8
    return tuple(torch.from_numpy(x).to(device)
                 for x in (key, kind, params, fparams, count, owned))


def wedge_inputs(S: int, NB: int, N: int, seed: int, device="cpu", batch: int = 0):
    """``(edges [N, 2], mask [N], nb [S, NB])``: sorted neighbour rows of
    random lengths up to ``NB`` drawn from ``[0, n)`` (every fourth row
    all sentinel, as an overflowed sample's, one row full), endpoints
    drawn from the same range (a third of them from row 0, so wedges
    close) and a mask keeping about 1 slot in 8.  ``batch`` > 0 shapes
    ``edges`` ``[batch, N / batch, 2]`` and the mask ``[batch, N /
    batch]``, a pair wave's buffers."""
    rng = np.random.default_rng(seed)
    n = max(1 << 14, 2 * NB)
    nb = np.full((S, NB), SENTINEL, np.int64)
    for s in range(S):
        if s % 4 == 3:
            continue
        k = NB if s == 1 else int(rng.integers(0, NB + 1))
        nb[s, :k] = np.sort(rng.choice(n, size=k, replace=False))
    edges = rng.integers(0, n, (N, 2))
    row0 = nb[0][nb[0] < SENTINEL]
    if len(row0):
        take = rng.random((N, 2)) < 1 / 3
        edges = np.where(take, rng.choice(row0, (N, 2)), edges)
    mask = rng.random(N) < 1 / 8
    if batch:
        edges, mask = edges.reshape(batch, -1, 2), mask.reshape(batch, -1)
    return tuple(torch.from_numpy(x).to(device) for x in (edges, mask, nb))
