"""The probe table of the wedge-closing kernel: the union of the sample rows.

``close_wedges`` asks, for each valid slot ``(u, v)``, which samples hold
both endpoints in their neighbour rows.  The rows are few and short
against the graph, so nearly every ``u`` is in none of them; the kernel
probes ``u`` in the union of the rows and is done on a miss.
:func:`wedge_table` builds that union once (on the host, deterministic)
from the sorted, sentinel-padded ``[S, NB]`` neighbour table:

* ``hkey``: the union's keys placed by linear probing in ``T = 2^log_t
  >= 2U`` slots (``U`` keys), :data:`EMPTY` elsewhere.  A key's home slot
  is the top ``log_t`` bits of ``key * MUL_SLOT`` (mod 2^64, Fibonacci
  hashing);
* ``off``, ``ids``: each slot's samples as a CSR list over the slots,
  ascending within a slot (empty for an empty slot);
* ``filt``: a filter of ``F = 2^log_f`` bits in 32-bit words: the top
  ``log_f + 5`` bits of ``key * MUL_FILTER`` name a word and two bits in
  it (:func:`filter_entry`), both set for every key.  The kernel stages it
  in shared memory in front of the keys, which stay in global memory; a
  vertex not in the union passes it about once in 200 lookups at 32 bits
  a key (at most ``2^18`` bits: 32 KB).

:func:`probe` finds keys as the kernel does; it serves the plain version
(:func:`.ref.close_wedges_table_ref`).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

SENTINEL = 1 << 62                 # the rows' padding (stats.accumulate._NB_SENTINEL)
EMPTY = -1                         # an empty slot of ``hkey``; vertex ids are >= 0
MUL_SLOT = 0x9E3779B97F4A7C15      # 2^64 / golden ratio
MUL_FILTER = 0xC2B2AE3D27D4EB4F
MIN_LOG_T = 4
FILTER_LOG_BITS = (10, 18)         # the filter's size range: 32 bits a key within it


class WedgeTable(NamedTuple):
    """The union of the live sample rows (see the module docstring)."""
    samples: int          # S, the rows of the neighbour table
    hkey: torch.Tensor    # int64 [T]
    off: torch.Tensor     # int64 [T + 1]
    ids: torch.Tensor     # int32 [total row length]
    filt: torch.Tensor    # int32 [F / 32]

    @property
    def log_t(self) -> int:
        return self.hkey.numel().bit_length() - 1

    @property
    def log_f(self) -> int:
        return (32 * self.filt.numel()).bit_length() - 1

    @property
    def union(self) -> int:
        """U, the number of distinct vertices in the live rows."""
        return int((self.hkey != EMPTY).sum())

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (self.hkey, self.off, self.ids, self.filt))


def hash_bits(q: torch.Tensor, mul: int, bits: int) -> torch.Tensor:
    """The top ``bits`` bits of ``q * mul`` mod 2^64, of int64 ``q``: the
    product wraps in int64 as in uint64; the arithmetic shift's sign bits
    are masked off."""
    signed = mul - (1 << 64) if mul >= 1 << 63 else mul
    return ((q * signed) >> (64 - bits)) & ((1 << bits) - 1)


def filter_entry(q: torch.Tensor, log_f: int):
    """(word, bit, bit) of each ``q`` in a filter of ``2^log_f`` bits."""
    x = hash_bits(q, MUL_FILTER, log_f + 5)
    return x >> 10, (x >> 5) & 31, x & 31


def _linear_probing(home: np.ndarray, T: int) -> np.ndarray:
    """The key index held by each of ``T`` slots (-1 if empty), keys
    placed by linear probing from their ``home`` slots.  In each round
    every unplaced key tries its current slot; the lowest-index key
    reaching a free slot takes it, the others move one slot on.  So every
    slot between a key's home and its own was taken before the key
    passed it, which is what a lookup walks."""
    held = np.full(T, -1, np.int64)
    at = home.copy()
    todo = np.arange(len(home))
    while len(todo):
        p = at[todo]
        free = np.flatnonzero(held[p] < 0)
        order = free[np.argsort(p[free], kind="stable")]   # by slot, then key index
        first = np.ones(len(order), bool)
        first[1:] = p[order[1:]] != p[order[:-1]]
        won = order[first]
        held[p[won]] = todo[won]
        left = np.ones(len(todo), bool)
        left[won] = False
        todo = todo[left]
        at[todo] = (at[todo] + 1) & (T - 1)
    return held


def wedge_table(nb: torch.Tensor, device: Optional[torch.device] = None) -> WedgeTable:
    """The :class:`WedgeTable` of the sorted, sentinel-padded neighbour
    table ``nb`` (int64 ``[S, NB]``; an all-sentinel row, an overflowed
    sample's, is in no list), built on the host, on ``device`` (default
    ``nb``'s).  A vertex repeated in a row is listed once."""
    dev = nb.device if device is None else torch.device(device)
    a = nb.cpu().numpy()
    S = a.shape[0]
    row, col = np.nonzero(a < SENTINEL)
    key = a[row, col]
    order = np.lexsort((row, key))                 # by key, then sample
    key, row = key[order], row[order]
    distinct = np.ones(len(key), bool)
    distinct[1:] = (key[1:] != key[:-1]) | (row[1:] != row[:-1])
    key, row = key[distinct], row[distinct]
    if len(key) and key[0] < 0:
        raise ValueError("wedge_table: neighbour ids must be >= 0")
    starts = np.flatnonzero(np.r_[True, key[1:] != key[:-1]]) if len(key) else np.zeros(0, np.int64)
    keys = key[starts]
    U = len(keys)
    log_t = max(MIN_LOG_T, int(2 * U - 1).bit_length())
    if log_t > 31:
        raise ValueError(f"wedge_table: {U} distinct neighbours do not fit a 2^31-slot table")
    T = 1 << log_t
    keys_t = torch.from_numpy(keys)
    held = _linear_probing(hash_bits(keys_t, MUL_SLOT, log_t).numpy(), T)
    occupied = np.flatnonzero(held >= 0)
    slot_of = np.empty(U, np.int64)
    slot_of[held[occupied]] = occupied
    hkey = np.full(T, EMPTY, np.int64)
    hkey[occupied] = keys[held[occupied]]
    sizes = np.diff(np.r_[starts, len(key)])
    per_slot = np.zeros(T, np.int64)
    per_slot[slot_of] = sizes
    off = np.r_[0, np.cumsum(per_slot)]
    # the (key, sample) entries in slot order; stable, so samples stay ascending
    ids = row[np.argsort(np.repeat(slot_of, sizes), kind="stable")].astype(np.int32)
    log_f = min(max(int(32 * U - 1).bit_length(), FILTER_LOG_BITS[0]), FILTER_LOG_BITS[1])
    words = np.zeros(1 << (log_f - 5), np.uint32)
    w, b1, b2 = (x.numpy() for x in filter_entry(keys_t, log_f))
    for b in (b1, b2):
        np.bitwise_or.at(words, w, (np.uint32(1) << b.astype(np.uint32)))
    filt = words.view(np.int32)
    return WedgeTable(S, *(torch.from_numpy(x).to(dev) for x in (hkey, off, ids, filt)))


def probe(table: WedgeTable, q: torch.Tensor) -> torch.Tensor:
    """int64: the slot of each ``q`` (int64) in ``table.hkey``, or -1: the
    filter bits, then linear probing from the home slot up to an empty
    slot (every slot at most once), as the kernel looks up an endpoint."""
    T = table.hkey.numel()
    w, b1, b2 = filter_entry(q, table.log_f)
    word = table.filt[w].to(torch.int64)
    listed = (word >> b1) & (word >> b2) & 1 == 1
    at = hash_bits(q, MUL_SLOT, table.log_t)
    slot = torch.full_like(q, -1)
    todo = torch.nonzero(listed).flatten()
    for _ in range(T):
        if not todo.numel():
            break
        k = table.hkey[at[todo]]
        hit = k == q[todo]
        slot[todo[hit]] = at[todo[hit]]
        todo = todo[~hit & (k != EMPTY)]
        at[todo] = (at[todo] + 1) & (T - 1)
    return slot
