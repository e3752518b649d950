"""Sampling without replacement + index->edge decoding (port of
``repro.core.sampling``).

The collision sampler draws one 64-bit word per slot, takes it modulo
the universe, sorts, and redraws the values that repeat their sorted
predecessor until none repeats (at most 63 redraw rounds, then it
returns as the reference does).  :func:`sample_rows` runs it over a
batch of ``R`` chunk rows at once through ``chunk_sample``: on the card
one call of the hand-written sampler (draws, a sort by value ranges and
the redraw rounds, no ``torch.sort`` and no read on the host); on the
CPU its plain version, ``chunk_draw`` rounds and ``torch.sort``.
Finished rows are left alone, which is what the reference's vmapped
``while_loop`` does row by row.

Slot ``i``'s draw depends only on ``(key, round, i)``, never on the
capacity, so two PEs padding the same chunk differently recompute the
same values.

``method="gumbel"`` is the reference's exact Gumbel-top-k sampler, off
the engine path: plain PyTorch on either device, with JAX's float64
uniforms and glibc's ``log`` (which the reference's fused program calls).
"""
from __future__ import annotations

import torch

from ..kernels.geom.libm import glibc_log_any
from ..kernels.sampler.ops import chunk_sample
from ..kernels.sampler.ref import decode_directed, decode_rect, decode_tri  # noqa: F401
from .prng import key_words, uniform64

_TINY = 2.2250738585072014e-308     # float64's smallest normal, jnp.finfo(f64).tiny


def round_up_capacity(x: int, mult: int = 64) -> int:
    """Static buffer capacity: x rounded up to a multiple of `mult`."""
    return max(mult, (int(x) + mult - 1) // mult * mult)


def key_bits32(key) -> torch.Tensor:
    """int32 tensor holding the bit pattern of uint32 key words, the
    layout the sampler kernel reads."""
    k = key_words(key)
    return torch.where(k >= 1 << 31, k - (1 << 32), k).to(torch.int32)


def sample_rows(key: torch.Tensor, universe: torch.Tensor, count: torch.Tensor,
                capacity: int, rounds=None) -> torch.Tensor:
    """Sorted int64 ``[R, capacity]``: per row, ``count`` distinct values
    in ``[0, universe)`` followed by the sentinels ``universe + i``.

    ``key`` int32 ``[R, 2]``, ``universe`` and ``count`` int64 ``[R]``,
    all on the device the sampler runs on; ``rounds`` (int32 ``[R]``),
    when given, takes each row's redraw rounds."""
    return chunk_sample(key, universe, count, capacity, rounds)


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


def gumbel(key, universe: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (universe,), float64)``: ``-log(-log(u))``
    of JAX's uniforms on ``[tiny, 1)`` (``u * (1 - tiny) + tiny``, where
    ``1 - tiny`` rounds to 1), through glibc's ``log``."""
    u = torch.clamp(uniform64(key, (universe,)) + _TINY, min=_TINY)
    return -glibc_log_any(-glibc_log_any(u))


def _sample_gumbel(key, universe: int, count: int, capacity: int):
    """Exact uniform k-subset by Gumbel-top-k (``repro.core.sampling.
    _sample_gumbel``): the indices of the ``min(capacity, universe)``
    largest scores, ties to the lower index first (a stable descending
    sort, as XLA's TopK), then the first ``count`` kept and sorted, the
    other slots holding the sentinels ``universe + i``."""
    k_words = key_words(key)
    dev = k_words.device
    k = min(capacity, universe)
    top = torch.sort(gumbel(k_words, universe), descending=True, stable=True).indices[:k]
    idx = torch.arange(capacity, dtype=torch.int64, device=dev)
    vals = universe + idx
    vals[:k] = top
    vals = torch.sort(torch.where(idx < count, vals, universe + idx)).values
    return vals, idx < count


def sample_wo_replacement(key, universe: int, count: int, capacity: int, *,
                          method: str = "collision"):
    """`count` distinct sorted int64 samples from [0, universe):
    (vals [capacity] sorted, mask [capacity]); padding slots hold
    distinct sentinels >= universe.  ``method="gumbel"`` needs a
    universe small enough to score every element, and ``count <=
    min(capacity, universe)``."""
    if method == "gumbel":
        universe = int(universe)
        if count > min(capacity, universe):
            raise ValueError(
                f"gumbel path holds min(capacity, universe) = "
                f"{min(capacity, universe)} samples, got count={count}")
        return _sample_gumbel(key, universe, count, capacity)
    if method != "collision":
        raise ValueError(f"unknown sampling method {method!r}")
    return _sample_collision(key, universe, count, capacity)
