"""Pseudorandomization substrate (paper §2.2), PyTorch port.

The host half (splitmix64 hashing of recursion-tree positions into numpy
Philox generators) is a verbatim copy of ``repro.core.prng``: the plan
arithmetic runs on the host in both packages.

The device half is JAX's Threefry-2x32 in its partitionable layout,
written out so that the port draws the same bits as the JAX package:

* ``key(seed)`` is ``(0, seed)``; ``device_key`` masks seed and path ids
  to 31 bits first, as the reference does.
* ``fold_in(k, d)`` is ``TF(k, (0, d mod 2^32))``.
* 32-bit word ``i`` of ``bits(k, shape)`` is the XOR of the two outputs
  of ``TF(k, (0, i))``.
* ``counter_bits64(key, cap, w)[i, j]`` takes word ``2j`` as its high
  half and word ``2j + 1`` as its low half of ``bits(fold_in(key, i),
  (w, 2))``.

Key words are carried as int64 tensors holding values in ``[0, 2^32)``
(torch's CPU build has no unsigned 64-bit shifts or remainders), and
:func:`threefry2x32` masks after every add.  The CUDA sampler
(``kernels/sampler/csrc/threefry.cuh``) computes the same function on
native ``uint32``.
"""
from __future__ import annotations

import numpy as np
import torch

_GOLDEN = np.uint64(0x9E3779B97F4A7C15)
_MIX1 = np.uint64(0xBF58476D1CE4E5B9)
_MIX2 = np.uint64(0x94D049BB133111EB)
_U64 = np.uint64

THREEFRY = "threefry2x32"
_M32 = 0xFFFFFFFF
_KS_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def splitmix64(x: np.uint64) -> np.uint64:
    """One splitmix64 round; high-quality 64-bit mixer (vectorized-safe)."""
    with np.errstate(over="ignore"):
        x = _U64(x) + _GOLDEN
        x = (x ^ (x >> _U64(30))) * _MIX1
        x = (x ^ (x >> _U64(27))) * _MIX2
        return x ^ (x >> _U64(31))


def hash_path(seed: int, *path: int) -> int:
    """Stable 64-bit hash of a recursion-tree position.

    Rank-independent: two PEs hashing the same (seed, path) always agree,
    different paths give independent streams (splitmix64 avalanche).
    """
    with np.errstate(over="ignore"):
        h = splitmix64(_U64(seed & 0xFFFFFFFFFFFFFFFF))
        for p in path:
            h = splitmix64(h ^ (_U64(int(p) & 0xFFFFFFFFFFFFFFFF) + _GOLDEN))
    return int(h)


def hash_paths(seed: int, paths: np.ndarray) -> np.ndarray:
    """Vectorized :func:`hash_path` over the rows of ``paths`` [N, L]:
    one splitmix64 chain per row, bit-identical to the scalar loop."""
    with np.errstate(over="ignore"):
        h = np.full(len(paths), splitmix64(_U64(seed & 0xFFFFFFFFFFFFFFFF)),
                    np.uint64)
        for c in range(paths.shape[1]):
            col = paths[:, c].astype(np.int64).astype(np.uint64)
            h = splitmix64(h ^ (col + _GOLDEN))
    return h


def host_rng(seed: int, *path: int) -> np.random.Generator:
    """Numpy generator for one recursion-tree node (host-side plan)."""
    return np.random.Generator(np.random.Philox(key=hash_path(seed, *path)))


class PhiloxReplayer:
    """Reusable Philox generator for hot replay loops.

    ``at(h)`` resets one shared bit generator to the freshly-keyed
    Philox state, so its draws are bit-identical to
    ``np.random.Generator(np.random.Philox(key=h))`` at a fraction of
    the construction cost."""

    def __init__(self):
        self._bg = np.random.Philox(key=0)
        self._gen = np.random.Generator(self._bg)

    def at(self, h: int) -> np.random.Generator:
        st = self._bg.state
        st["state"]["key"][:] = (int(h) & 0xFFFFFFFFFFFFFFFF, 0)
        st["state"]["counter"][:] = 0
        st["buffer_pos"] = 4
        st["has_uint32"] = 0
        st["uinteger"] = 0
        self._bg.state = st
        return self._gen


# --------------------------------------------------------------------------
# device half: JAX's Threefry-2x32, partitionable layout
# --------------------------------------------------------------------------

def check_rng_impl(impl: str | None) -> None:
    """The port implements JAX's ``threefry2x32`` key type only."""
    if impl not in (None, THREEFRY):
        raise ValueError(
            f"rng_impl {impl!r} is not supported: the port implements "
            f"{THREEFRY!r} only")


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter ``(x0, x1)`` under the key
    ``(k0, k1)``.  Every argument is an int64 tensor (or int) holding a
    32-bit word; the arguments broadcast.  Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (x0 + k0) & _M32
    x1 = (x1 + k1) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def key_words(key) -> torch.Tensor:
    """int64 ``[..., 2]`` key words of raw key data (numpy uint32, or an
    int32 tensor holding the same bit pattern, or int64 words)."""
    if isinstance(key, np.ndarray):
        return torch.from_numpy(key.astype(np.int64))
    key = torch.as_tensor(key)
    return key.to(torch.int64) & _M32


def fold_in(key, data) -> torch.Tensor:
    """``jax.random.fold_in``: int64 key words ``[..., 2]`` folded with
    ``data`` (an int or an int tensor broadcasting against the key's
    leading shape; reduced mod 2^32, as JAX's uint32 cast does)."""
    k = key_words(key)
    d = torch.as_tensor(data, dtype=torch.int64, device=k.device) & _M32
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def device_key(seed: int, *path: int, impl: str | None = None) -> torch.Tensor:
    """Key words (int64 [2]) of a recursion-tree node: ``key(seed)``
    folded with each path id, seed and ids masked to 31 bits."""
    check_rng_impl(impl)
    key = torch.tensor([0, seed & 0x7FFFFFFF], dtype=torch.int64)
    for p in path:
        key = fold_in(key, int(p) & 0x7FFFFFFF)
    return key


def fold_in_many(key, ids) -> torch.Tensor:
    """One independent key per id: int64 words ``[len(ids), 2]``."""
    return fold_in(key_words(key)[None, :], torch.as_tensor(ids))


def bits64_limbs(key, ids, word: int = 0):
    """(hi, lo) 32-bit limbs of 64-bit word ``word`` of slot ``ids`` under
    ``key`` (``key`` [..., 2] broadcasting against ``ids``)."""
    k = fold_in(key, ids)
    k0, k1 = k[..., 0], k[..., 1]
    hi = torch.bitwise_xor(*threefry2x32(k0, k1, 0, 2 * word))
    lo = torch.bitwise_xor(*threefry2x32(k0, k1, 0, 2 * word + 1))
    return hi, lo


def counter_bits64(key, capacity: int, width: int) -> torch.Tensor:
    """``[capacity, width]`` 64-bit words as int64 bit patterns (the
    reference returns them as uint64); word ``(i, j)`` is a pure
    function of ``(key, i, j)``, never of ``capacity``."""
    k = key_words(key)
    ids = torch.arange(capacity, dtype=torch.int64, device=k.device)[:, None]
    cols = [bits64_limbs(k, ids, j) for j in range(width)]
    return torch.cat([(hi << 32) | lo for hi, lo in cols], dim=1)


def mod_u64(hi, lo, u):
    """``(hi * 2^32 + lo) mod u`` for 32-bit limbs and ``1 <= u < 2^63``,
    in int64 without overflow: the high limb's remainder is doubled 32
    times with a conditional subtract, then the low limb is added the
    same way."""
    r = hi % u
    for _ in range(32):
        r = torch.where(r >= u - r, r - (u - r), r + r)
    a = lo % u
    return torch.where(r >= u - a, r - (u - a), r + a)
