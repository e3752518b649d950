"""Sampling without replacement + index->edge decoding (port of
``repro.core.sampling``).

The collision sampler draws one 64-bit word per slot, takes it modulo
the universe, sorts, and redraws the values that repeat their sorted
predecessor until none repeats (at most 63 redraw rounds, then it
returns as the reference does).  :func:`sample_rows` runs it over a
batch of ``R`` chunk rows at once: each round is one ``chunk_draw``
kernel launch over ``[R, capacity]`` plus one ``torch.sort`` along the
rows, and finished rows are left alone, which is what the reference's
vmapped ``while_loop`` does row by row.  The duplicate flag is read on
the host once per round (one synchronisation per round).

Slot ``i``'s draw depends only on ``(key, round, i)``, never on the
capacity, so two PEs padding the same chunk differently recompute the
same values.
"""
from __future__ import annotations

import torch

from ..kernels.sampler.ops import chunk_draw
from ..kernels.sampler.ref import decode_directed, decode_rect, decode_tri  # noqa: F401
from .prng import key_words

MAX_FIX_ROUNDS = 64


def round_up_capacity(x: int, mult: int = 64) -> int:
    """Static buffer capacity: x rounded up to a multiple of `mult`."""
    return max(mult, (int(x) + mult - 1) // mult * mult)


def key_bits32(key) -> torch.Tensor:
    """int32 tensor holding the bit pattern of uint32 key words, the
    layout the sampler kernel reads."""
    k = key_words(key)
    return torch.where(k >= 1 << 31, k - (1 << 32), k).to(torch.int32)


def sample_rows(key: torch.Tensor, universe: torch.Tensor, count: torch.Tensor,
                capacity: int) -> torch.Tensor:
    """Sorted int64 ``[R, capacity]``: per row, ``count`` distinct values
    in ``[0, universe)`` followed by the sentinels ``universe + i``.

    ``key`` int32 ``[R, 2]``, ``universe`` and ``count`` int64 ``[R]``,
    all on the device the sampler runs on."""
    s = torch.sort(chunk_draw(key, universe, count, 0, capacity), dim=-1).values
    for t in range(1, MAX_FIX_ROUNDS):
        active = (s[:, 1:] == s[:, :-1]).any(dim=1)
        if not bool(active.any()):
            break
        s = torch.sort(chunk_draw(key, universe, count, t, capacity, s, active),
                       dim=-1).values
    return s


def _sample_collision(key, universe: int, count: int, capacity: int):
    """One row of :func:`sample_rows`: (vals [capacity] sorted, mask
    [capacity]).  ``key`` is the row's key words; the sampler runs on
    the key tensor's device."""
    k = key_bits32(key).reshape(1, 2)
    dev = k.device
    vals = sample_rows(k, torch.tensor([universe], dtype=torch.int64, device=dev),
                       torch.tensor([count], dtype=torch.int64, device=dev),
                       capacity)[0]
    return vals, torch.arange(capacity, device=dev) < count


def sample_wo_replacement(key, universe: int, count: int, capacity: int, *,
                          method: str = "collision"):
    """`count` distinct sorted int64 samples from [0, universe):
    (vals [capacity] sorted, mask [capacity]); padding slots hold
    distinct sentinels >= universe."""
    if method == "gumbel":
        raise NotImplementedError(
            "the exact Gumbel-top-k sampler is not ported: it is off the "
            "engine path (ROADMAP queue 1, item 2)")
    if method != "collision":
        raise ValueError(f"unknown sampling method {method!r}")
    return _sample_collision(key, universe, count, capacity)
