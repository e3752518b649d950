"""Synthetic rows of the collision sampler, made from a seed with numpy:
random sparse rows led by rows that take each of the kernel's paths (count
0; universes 0, 1 and 3, whose buckets hold one value and, at capacities
past 3 x 8192, outgrow shared memory; dense rows that need many redraw
rounds or never finish, by counting values, by a sort of the whole row and
by listed duplicates).  Shared by the card tests of ``chunk_sample`` and
``chip_smoke.py``, which import no JAX.
"""
import numpy as np
import torch


def special_rows(cap: int):
    """(universe, count) of the leading rows for a capacity ``cap``."""
    return [(1000, 0), (0, cap), (1, cap), (3, cap), (cap + cap // 2 + 1, cap),
            (2 * cap, cap // 2), (2 ** 24, cap), (cap, cap), (5000, min(cap, 4000)),
            (12000, min(cap, 9000))]


def sampler_rows(R: int, cap: int, seed: int, device="cpu"):
    """``(key int32 [R, 2], universe int64 [R], count int64 [R])``: the
    first ``min(R, 10)`` rows from :func:`special_rows`, the others with
    universes up to 2^50 and counts up to ``cap``."""
    rng = np.random.default_rng(seed)
    key = rng.integers(-2 ** 31, 2 ** 31, (R, 2)).astype(np.int32)
    uni = rng.integers(0, 2 ** 50, R)
    cnt = np.minimum(rng.integers(0, cap + 1, R), uni)
    for r, (u, c) in enumerate(special_rows(cap)[:R]):
        uni[r], cnt[r] = u, c
    return tuple(torch.from_numpy(x).to(device) for x in (key, uni, cnt))
