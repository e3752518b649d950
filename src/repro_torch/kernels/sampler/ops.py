"""Wrappers of the chunk sampler kernels (``csrc/collision.cu``,
``csrc/sampler.cu``).

For tensors on the CPU each wrapper computes its plain version
(:mod:`.ref`); for CUDA tensors it launches its kernel on the current
stream of the tensors' card (``build.launch``), counts the launch in
``build.LAUNCHES`` and raises if the launch fails.  There is no fallback
from one to the other.

Each entry point is opaque to the op scan of
``repro_torch.analyze.opscan``: inside a trace a call counts as one
launch, whichever version runs.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ...analyze import opscan
from .. import build
from .ref import (BUCKET_CAP, LIST_CAP, buckets_per_row, chunk_ba_ref, chunk_decode_ref,
                  chunk_rmat_ref, sample_rows_ref)

_P = ctypes.c_void_p
_I = ctypes.c_longlong
_C = ctypes.c_int
_COLLISION = {"chunk_sample": [_P, _P, _P, _I, _I, _C, _C, _C, _P, _P, _P, _P, _P]}
_SIGNATURES = {
    "chunk_decode": [_P, _P, _P, _P, _P, _I, _I, _P, _P, _P],
    "chunk_rmat": [_P, _P, _P, _P, _P, _P, ctypes.c_int, _I, _I, ctypes.c_int, _P, _P, _P],
    "chunk_ba": [_P, _P, _P, _P, _P, _I, _I, ctypes.c_int, _P, _P, _P, _P],
}


def _lib():
    return build.library("sampler", _SIGNATURES)


@opscan.opaque("chunk_sample")
def chunk_sample(key: torch.Tensor, universe: torch.Tensor, count: torch.Tensor,
                 capacity: int, rounds: Optional[torch.Tensor] = None, *,
                 bucket_cap: int = BUCKET_CAP, list_cap: int = LIST_CAP) -> torch.Tensor:
    """Sorted int64 ``[R, capacity]``: the collision sampler over ``R``
    rows (see :func:`.ref.sample_rows_ref`), draws, sort and redraw
    rounds in one call that reads nothing back on the host.  ``key`` is
    int32 ``[R, 2]`` (the uint32 key words' bit pattern), ``universe``
    (``>= 0``) and ``count`` int64 ``[R]``; ``rounds`` (int32 ``[R]``),
    when given, takes each row's redraw rounds.  ``bucket_cap`` (1..8192)
    and ``list_cap`` (0..1024) bound the buckets the kernel sorts in
    shared memory and the duplicate positions it lists a row: smaller
    values send rows through its paths for large buckets and many
    duplicates (the tests do), with the same result."""
    if key.device.type == "cpu":
        return sample_rows_ref(key, universe, count, capacity, rounds)
    R, dev = key.shape[0], key.device
    build.check_arg(key, "key", torch.int32, (R, 2), dev)
    build.check_arg(universe, "universe", torch.int64, (R,), dev)
    build.check_arg(count, "count", torch.int64, (R,), dev)
    if rounds is not None:
        build.check_arg(rounds, "rounds", torch.int32, (R,), dev)
    if not 0 <= capacity < 2 ** 31:
        raise ValueError(f"capacity {capacity} outside [0, 2^31)")
    if not (1 <= bucket_cap <= BUCKET_CAP and 0 <= list_cap <= LIST_CAP):
        raise ValueError(f"bucket_cap {bucket_cap} or list_cap {list_cap} out of range")
    out = torch.empty((R, capacity), dtype=torch.int64, device=dev)
    if not out.numel():
        if rounds is not None:
            rounds.zero_()
        return out
    nb_max = buckets_per_row(capacity)
    scratch = torch.empty_like(out)
    # bucket counts, duplicate counts and lists, the first round's plan
    work = torch.zeros(R * (nb_max + 4 * LIST_CAP + 6) + 1 + 2 * R * LIST_CAP,
                       dtype=torch.int32, device=dev)
    build.launch(
        "chunk_sample", dev, build.library("collision", _COLLISION).chunk_sample,
        key.data_ptr(), universe.data_ptr(), count.data_ptr(), R, capacity, nb_max,
        bucket_cap, list_cap, out.data_ptr(), scratch.data_ptr(), work.data_ptr(),
        None if rounds is None else rounds.data_ptr())
    build.LAUNCHES["chunk_sample"] += 1
    return out


@opscan.opaque("chunk_decode")
def chunk_decode(vals: torch.Tensor, kind: torch.Tensor, params: torch.Tensor,
                 count: torch.Tensor, owned: torch.Tensor):
    """(edges int64 ``[R, cap, 2]``, keep bool ``[R, cap]``) of the sorted
    draws ``vals`` (see :func:`.ref.chunk_decode_ref`); ``kind`` int32
    ``[R]``, ``params`` int64 ``[R, 3]``, ``count`` int64 ``[R]``,
    ``owned`` bool ``[R]``."""
    if vals.device.type == "cpu":
        return chunk_decode_ref(vals, kind, params, count, owned)
    (R, cap), dev = vals.shape, vals.device
    build.check_arg(vals, "vals", torch.int64, (R, cap), dev)
    build.check_arg(kind, "kind", torch.int32, (R,), dev)
    build.check_arg(params, "params", torch.int64, (R, 3), dev)
    build.check_arg(count, "count", torch.int64, (R,), dev)
    build.check_arg(owned, "owned", torch.bool, (R,), dev)
    edges = torch.empty((R, cap, 2), dtype=torch.int64, device=dev)
    keep = torch.empty((R, cap), dtype=torch.bool, device=dev)
    if vals.numel():
        build.launch("chunk_decode", dev, _lib().chunk_decode,
                     vals.data_ptr(), kind.data_ptr(), params.data_ptr(),
                     count.data_ptr(), owned.data_ptr(), R, cap, edges.data_ptr(),
                     keep.data_ptr())
        build.LAUNCHES["chunk_decode"] += 1
    return edges, keep


def _check_rows(key, kind, params, count, owned, out, capacity):
    """The checks of the per-kind chunk programs' common arguments; the
    output they write (``out``, or a fresh one to fill)."""
    R, dev = kind.shape[0], kind.device
    build.check_arg(key, "key", torch.int32, (R, 2), dev)
    build.check_arg(kind, "kind", torch.int32, (R,), dev)
    build.check_arg(params, "params", torch.int64, (R, 3), dev)
    build.check_arg(count, "count", torch.int64, (R,), dev)
    build.check_arg(owned, "owned", torch.bool, (R,), dev)
    if out is None:
        return (torch.empty((R, capacity, 2), dtype=torch.int64, device=dev),
                torch.empty((R, capacity), dtype=torch.bool, device=dev)), True
    build.check_arg(out[0], "edges", torch.int64, (R, capacity, 2), dev)
    build.check_arg(out[1], "keep", torch.bool, (R, capacity), dev)
    return out, False


@opscan.opaque("chunk_rmat")
def chunk_rmat(key: torch.Tensor, kind: torch.Tensor, params: torch.Tensor,
               fparams: torch.Tensor, count: torch.Tensor, owned: torch.Tensor,
               log_n: int, capacity: int, out=None):
    """(edges int64 ``[R, capacity, 2]``, keep bool ``[R, capacity]``) of
    the RMAT rows (see :func:`.ref.chunk_rmat_ref`), written into ``out``
    when it is given (its other rows untouched), else into a fresh output
    whose other rows are ``(0, 0)`` and not kept.  ``key`` int32 ``[R,
    2]``, ``kind`` int32 ``[R]``, ``params`` int64 ``[R, 3]``, ``fparams``
    float64 ``[R, 4]``, ``count`` int64 ``[R]``, ``owned`` bool ``[R]``;
    ``0 <= log_n <= 62``."""
    if not 0 <= log_n <= 62:
        raise ValueError(f"log_n {log_n} outside [0, 62]")
    if kind.device.type == "cpu":
        return chunk_rmat_ref(key, kind, params, fparams, count, owned, log_n, capacity, out)
    (edges, keep), fill = _check_rows(key, kind, params, count, owned, out, capacity)
    build.check_arg(fparams, "fparams", torch.float64, (kind.shape[0], 4), kind.device)
    if edges.numel():
        build.launch("chunk_rmat", kind.device, _lib().chunk_rmat,
                     key.data_ptr(), kind.data_ptr(), params.data_ptr(), fparams.data_ptr(),
                     count.data_ptr(), owned.data_ptr(), int(log_n), kind.shape[0], capacity,
                     int(fill), edges.data_ptr(), keep.data_ptr())
        build.LAUNCHES["chunk_rmat"] += 1
    return edges, keep


@opscan.opaque("chunk_ba")
def chunk_ba(key: torch.Tensor, kind: torch.Tensor, params: torch.Tensor,
             count: torch.Tensor, owned: torch.Tensor, capacity: int, out=None,
             steps: Optional[torch.Tensor] = None):
    """(edges, keep) of the BA rows (see :func:`.ref.chunk_ba_ref`), with
    ``out`` as in :func:`chunk_rmat`.  ``steps``, an int64 ``[2]`` tensor,
    takes the launch's chain steps and the steps its warps issued (32 per
    trip of a warp's loop) when it is given (two atomics a warp).  The
    plain version adds only the chain steps."""
    if kind.device.type == "cpu":
        return chunk_ba_ref(key, kind, params, count, owned, capacity, out, steps)
    (edges, keep), fill = _check_rows(key, kind, params, count, owned, out, capacity)
    if steps is not None:
        build.check_arg(steps, "steps", torch.int64, (2,), kind.device)
    if edges.numel():
        build.launch("chunk_ba", kind.device, _lib().chunk_ba,
                     key.data_ptr(), kind.data_ptr(), params.data_ptr(), count.data_ptr(),
                     owned.data_ptr(), kind.shape[0], capacity, int(fill), edges.data_ptr(),
                     keep.data_ptr(), None if steps is None else steps.data_ptr())
        build.LAUNCHES["chunk_ba"] += 1
    return edges, keep
