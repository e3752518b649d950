"""Wrappers of the pair-mask kernels (``csrc/pairmask.cu``).

:func:`pair_mask` (the dense mask of a block of pairs) and
:func:`hyp_edges` (the hyp test over ragged segments, hits compacted)
compute their plain versions (:mod:`.ref`) for tensors on the CPU; for
CUDA tensors they launch their kernels on the current stream of the
tensors' card (``build.launch``), count the call in ``build.LAUNCHES``
and raise if a launch fails.  There is no fallback from one to the other.

Each entry point is opaque to the op scan of
``repro_torch.analyze.opscan``: inside a trace a call counts as one
launch, whichever version runs.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ...analyze import opscan
from .. import build
from .ref import TILES, hyp_edges_ref, pair_mask_ref

_P = ctypes.c_void_p
_I = ctypes.c_longlong
_D = ctypes.c_double
_PI = ctypes.POINTER(ctypes.c_longlong)
_SIGNATURES = {"pair_mask": [_P, _P, _I, _I, _I, _I, ctypes.c_int, ctypes.c_int,
                             ctypes.c_float, _D, _P, _P],
               "hyp_edges_grid": [ctypes.c_int, _PI, _PI],
               "hyp_edges_count": [_P, _P, _P, _P, _P, _I, _I, _I, _D, _I, _P, _P],
               "hyp_edges_write": [_P, _P, _P, _P, _P, _I, _D, _I, _P, _I, _P, _P]}


def _lib():
    return build.library("pairmask", _SIGNATURES)


@opscan.opaque("pair_mask")
def pair_mask(a: torch.Tensor, b: torch.Tensor, scalar, *, tile: str,
              dim: int = 2) -> torch.Tensor:
    """int8 mask ``[B, M, N]`` (or ``[M, N]`` for unbatched ``[M, F]``
    inputs) of the tile test over every pair ``(a[.., i], b[.., j])``.

    ``euclid``: float32 rows, ``||a_i - b_j||^2 <= scalar`` over the
    first ``dim`` columns (``scalar`` = r^2, rounded to float32).
    ``hyp``: float64 feature rows, the Eq. 9 sign test with ``scalar`` =
    cosh R.  Self-pairs are not excluded."""
    if tile not in TILES:
        raise ValueError(f"unknown tile {tile!r}; know {TILES}")
    if a.device.type == "cpu":
        return pair_mask_ref(a, b, scalar, tile=tile, dim=dim)
    batched = a.dim() == 3
    if not batched:
        a, b = a[None], b[None]
    (B, M, F), N, dev = a.shape, b.shape[1], a.device
    dtype = torch.float32 if tile == "euclid" else torch.float64
    need = dim if tile == "euclid" else 4
    if F < need or (tile == "euclid" and dim not in (2, 3)):
        raise ValueError(f"{tile} tile needs {need} columns and dim 2 or 3, got F={F}")
    build.check_arg(a, "a", dtype, (B, M, F), dev)
    build.check_arg(b, "b", dtype, (B, N, F), dev)
    out = torch.empty((B, M, N), dtype=torch.int8, device=dev)
    if out.numel():
        build.launch("pair_mask", dev, _lib().pair_mask,
                     a.data_ptr(), b.data_ptr(), B, M, N, F, int(tile == "hyp"), dim,
                     float(scalar), float(scalar), out.data_ptr())
        build.LAUNCHES["pair_mask"] += 1
    return out if batched else out[0]



@functools.lru_cache(maxsize=None)
def _grid(index: int) -> tuple:
    """(blocks, warps) of ``hyp_edges``' passes on CUDA device ``index``:
    as many blocks as its SMs hold at once."""
    blocks, warps = ctypes.c_longlong(0), ctypes.c_longlong(0)
    build.check(build.query(torch.device("cuda", index), _lib().hyp_edges_grid, index,
                            ctypes.byref(blocks), ctypes.byref(warps)), "hyp_edges")
    return blocks.value, warps.value


def _check_edges_args(q, c, q_gid, c_gid, segments) -> None:
    dev = q.device
    Q, C, S = len(q), len(c), len(segments)
    build.check_arg(q, "q", torch.float64, (Q, 4), dev)
    build.check_arg(c, "c", torch.float64, (C, 4), dev)
    build.check_arg(q_gid, "q_gid", torch.int64, (Q,), dev)
    build.check_arg(c_gid, "c_gid", torch.int64, (C,), dev)
    build.check_arg(segments, "segments", torch.int64, (S, 4), dev)
    if dev.type == "cuda" and (q.data_ptr() % 16 or c.data_ptr() % 16):
        raise ValueError("q and c must start 16-byte aligned: the kernel reads a row as two "
                         "16-byte loads")


def _out_of_range(segments: torch.Tensor, s: int, Q: int, C: int) -> ValueError:
    return ValueError(f"hyp_edges: segment {s} (q_off, q_len, c_off, c_len) = "
                      f"{segments[s].tolist()} is out of range of q [{Q}, 4] and c [{C}, 4]")


def _count_passes(q, c, q_gid, c_gid, segments, cosh_r):
    """Launch passes 1-3 of ``hyp_edges``; returns (blocks, scratch)."""
    blocks, warps = _grid(q.device.index)
    S = len(segments)
    scratch = torch.empty(4 + S + 1 + 2 * warps, dtype=torch.int64, device=q.device)
    build.launch("hyp_edges", q.device, _lib().hyp_edges_count,
                 q.data_ptr(), c.data_ptr(), q_gid.data_ptr(), c_gid.data_ptr(),
                 segments.data_ptr(), S, len(q), len(c), float(cosh_r), blocks,
                 scratch.data_ptr())
    return blocks, scratch


def _write_pass(q, c, q_gid, c_gid, segments, cosh_r, blocks, scratch, out) -> None:
    build.launch("hyp_edges", q.device, _lib().hyp_edges_write,
                 q.data_ptr(), c.data_ptr(), q_gid.data_ptr(), c_gid.data_ptr(),
                 segments.data_ptr(), len(segments), float(cosh_r), blocks,
                 scratch.data_ptr(), len(out), out.data_ptr())


@opscan.opaque("hyp_edges")
def hyp_edges(q: torch.Tensor, c: torch.Tensor, q_gid: torch.Tensor, c_gid: torch.Tensor,
              segments: torch.Tensor, cosh_r) -> torch.Tensor:
    """int64 ``[K, 2]``: ``(q_gid[i], c_gid[j])`` for every pair of every
    segment whose hyp tile (the Eq. 9 test with threshold ``cosh_r``)
    holds and whose gids differ, segment by segment and row-major in
    ``(i, j)`` within a segment.

    ``q [Q, 4]``, ``c [C, 4]``: float64 feature rows ``[cos θ, sin θ,
    coth r, 1/sinh r]``; ``q_gid [Q]``, ``c_gid [C]``: int64;
    ``segments [S, 4]``: int64 rows ``(q_off, q_len, c_off, c_len)``, each
    testing ``q[q_off:q_off + q_len]`` against ``c[c_off:c_off + c_len]``.
    Raises ``ValueError`` on a segment out of range.  On the card ``q``
    and ``c`` start 16-byte aligned, and the call reads one total back to
    size its output."""
    _check_edges_args(q, c, q_gid, c_gid, segments)
    Q, C, S = len(q), len(c), len(segments)
    if q.device.type == "cpu":
        qo, ql, co, cl = segments.unbind(1)
        bad = ((qo < 0) | (ql < 0) | (co < 0) | (cl < 0) | (qo > Q) | (ql > Q - qo)
               | (co > C) | (cl > C - co))
        if bad.any():
            raise _out_of_range(segments, int(torch.nonzero(bad)[0, 0]), Q, C)
        return hyp_edges_ref(q, c, q_gid, c_gid, segments, cosh_r)
    if S == 0:
        return torch.zeros((0, 2), dtype=torch.int64, device=q.device)
    blocks, scratch = _count_passes(q, c, q_gid, c_gid, segments, cosh_r)
    _, hits, bad = scratch[:3].tolist()
    if bad:
        raise _out_of_range(segments, bad - 1, Q, C)
    out = torch.empty((hits, 2), dtype=torch.int64, device=q.device)
    if hits:
        _write_pass(q, c, q_gid, c_gid, segments, cosh_r, blocks, scratch, out)
    build.LAUNCHES["hyp_edges"] += 1
    return out


def hyp_edges_into(q: torch.Tensor, c: torch.Tensor, q_gid: torch.Tensor,
                   c_gid: torch.Tensor, segments: torch.Tensor, cosh_r,
                   out: torch.Tensor) -> None:
    """:func:`hyp_edges`' four passes on the card into ``out`` (int64
    ``[K, 2]``, K the hit count of an earlier call on the same inputs),
    with no host read, so that they can be captured in a CUDA graph and
    timed.  Hits past ``K`` are dropped; a segment out of range tests no
    pair.  Counted as a launch."""
    _check_edges_args(q, c, q_gid, c_gid, segments)
    if q.device.type != "cuda":
        raise ValueError("hyp_edges_into runs the kernel: it takes CUDA tensors")
    build.check_arg(out, "out", torch.int64, (len(out), 2), q.device)
    if len(segments):
        blocks, scratch = _count_passes(q, c, q_gid, c_gid, segments, cosh_r)
        _write_pass(q, c, q_gid, c_gid, segments, cosh_r, blocks, scratch, out)
    build.LAUNCHES["hyp_edges"] += 1
