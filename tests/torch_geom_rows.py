"""Synthetic inputs of the geometric kernels, made from a seed with numpy:
candidate-pair rows of every kind mixed in one batch (GEOM_HYP, GEOM_TORUS,
GEOM_CERT, GEOM_EMPTY; self pairs, inactive rows, empty and full cells)
and point-plan cells (cube and polar, empty cells among them).  Shared by
the CPU tests of the plain versions and the card tests of the kernels,
which import no JAX.
"""
import math

import numpy as np
import torch

from repro_torch.kernels.geom.ref import GEOM_CERT, GEOM_EMPTY, GEOM_HYP, GEOM_TORUS

ALL_KINDS = (GEOM_HYP, GEOM_TORUS, GEOM_CERT)
KIND_SHARE = {GEOM_HYP: 0.35, GEOM_TORUS: 0.3, GEOM_CERT: 0.3, GEOM_EMPTY: 0.05}
HYP_ALPHA, HYP_R = 0.8, 9.0
TORUS_G, TORUS_R = 8, 0.12


def pair_rows(R: int, cap: int, dim: int, seed: int, device="cpu", kinds=ALL_KINDS):
    """The twelve row tensors of ``pair_edges`` for ``R`` rows of random
    kinds among ``kinds`` and GEOM_EMPTY: HYP rows carry rings of the disk
    of radius ``HYP_R``, TORUS rows neighbouring cells of a
    ``TORUS_G``-grid, CERT rows a simplex in a box around it and a random
    emit mask."""
    rng = np.random.default_rng(seed)
    pick = list(kinds) + [GEOM_EMPTY]
    share = np.array([KIND_SHARE[k] for k in pick])
    kind = rng.choice(pick, R, p=share / share.sum()).astype(np.int32)
    key_a, key_b = (rng.integers(-2 ** 31, 2 ** 31, (R, 2)).astype(np.int32) for _ in range(2))
    count_a, count_b = (rng.integers(0, cap + 1, R) for _ in range(2))
    count_a[::5] = cap
    count_b[1::7] = 0
    K = max(cap, dim + 1)
    gid_a, gid_b = (rng.integers(0, 1 << 40, (R, K)) for _ in range(2))
    G = max(4, (dim + 1) * dim, 2 * dim)
    geom_a, geom_b = np.zeros((R, G)), np.zeros((R, G))
    fparams = np.zeros((R, 2))

    hyp = kind == GEOM_HYP
    for geom in (geom_a, geom_b):
        lo = rng.uniform(0.0, HYP_R - 0.5, R)
        hi = np.minimum(lo + rng.uniform(0.05, 2.0, R), HYP_R)
        cells = 2 ** rng.integers(0, 7, R)
        ci = np.floor(rng.random(R) * cells)
        ring = np.stack([np.cosh(HYP_ALPHA * lo), np.cosh(HYP_ALPHA * hi), ci,
                         2 * math.pi / cells], axis=-1)
        geom[hyp, :4] = ring[hyp]
    fparams[hyp] = (HYP_ALPHA, math.cosh(HYP_R))

    torus = kind == GEOM_TORUS
    cell_a = rng.integers(0, TORUS_G, (R, dim))
    cell_b = np.clip(cell_a + rng.integers(-1, 2, (R, dim)), 0, TORUS_G - 1)
    geom_a[torus, :dim], geom_b[torus, :dim] = cell_a[torus], cell_b[torus]
    fparams[torus] = (TORUS_G, TORUS_R ** 2)

    cert = kind == GEOM_CERT
    center = rng.random((R, dim))
    simplex = center[:, None, :] + rng.normal(0.0, 0.05, (R, dim + 1, dim))
    width = rng.choice([0.05, 0.3, 1.0], (R, 1))
    geom_a[cert, :(dim + 1) * dim] = simplex.reshape(R, -1)[cert]
    geom_b[cert, :2 * dim] = np.concatenate([center - width, center + width], axis=-1)[cert]
    gid_b[cert, 0] = rng.integers(0, 1 << 62, R)[cert]
    fparams[cert, 0] = 1.0

    self_pair = rng.random(R) < 0.3
    count_b[self_pair] = count_a[self_pair]
    active = rng.random(R) < 0.85
    rows = (kind, key_a, key_b, count_a, count_b, gid_a, gid_b, geom_a, geom_b, fparams,
            self_pair, active)
    return [torch.from_numpy(np.ascontiguousarray(t)).to(device) for t in rows]


def cell_rows(R: int, cap: int, dim: int, kind: str, seed: int, device="cpu"):
    """(key, count, cell, geom) of ``R`` point-plan cells and the plan's
    scale: every fourth cell empty, every seventh full."""
    rng = np.random.default_rng(seed)
    key = rng.integers(-2 ** 31, 2 ** 31, (R, 2)).astype(np.int32)
    count = rng.integers(0, cap + 1, R)
    count[::4] = 0
    count[1::7] = cap
    if kind == "cube":
        cell = rng.integers(0, 64, (R, dim))
        geom, scale = np.ones((R, 1)), 64.0
    else:
        lo = rng.uniform(0.0, HYP_R - 0.5, R)
        hi = np.minimum(lo + rng.uniform(0.05, 2.0, R), HYP_R)
        cells = 2 ** rng.integers(0, 9, R)
        cell = np.stack([rng.integers(0, 16, R), np.floor(rng.random(R) * cells)], -1)
        geom = np.stack([np.cosh(HYP_ALPHA * lo), np.cosh(HYP_ALPHA * hi),
                         2 * math.pi / cells], axis=-1)
        scale = HYP_ALPHA
    t = [torch.from_numpy(np.ascontiguousarray(x)).to(device)
         for x in (key, count, cell.astype(np.int64), geom)]
    return t, scale
