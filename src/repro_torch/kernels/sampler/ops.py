"""Wrappers of the chunk sampler kernels (``csrc/sampler.cu``).

For tensors on the CPU each wrapper computes its plain version
(:mod:`.ref`); for CUDA tensors it launches its kernel on the current
stream, counts the launch in ``build.LAUNCHES`` and raises if the launch
fails.  There is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import build
from .ref import chunk_decode_ref, chunk_draw_ref

_P = ctypes.c_void_p
_I = ctypes.c_longlong
_SIGNATURES = {
    "chunk_draw": [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P],
    "chunk_decode": [_P, _P, _P, _P, _P, _I, _I, _P, _P, _P],
}


def _lib():
    return build.library("sampler", _SIGNATURES)


def chunk_draw(key: torch.Tensor, universe: torch.Tensor, count: torch.Tensor,
               t: int, capacity: int,
               sorted_vals: Optional[torch.Tensor] = None,
               active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int64 ``[R, capacity]`` draws of round ``t`` (see
    :func:`.ref.chunk_draw_ref`).  ``key`` is int32 ``[R, 2]`` (the
    uint32 key words' bit pattern), ``universe`` and ``count`` int64
    ``[R]``; redraw mode takes the sorted values and a bool ``[R]``
    active flag and leaves inactive rows as they are."""
    if key.device.type == "cpu":
        return chunk_draw_ref(key, universe, count, t, capacity, sorted_vals, active)
    R, dev = key.shape[0], key.device
    build.check_arg(key, "key", torch.int32, (R, 2), dev)
    build.check_arg(universe, "universe", torch.int64, (R,), dev)
    build.check_arg(count, "count", torch.int64, (R,), dev)
    if (sorted_vals is None) != (active is None):
        raise ValueError("redraw mode needs both sorted_vals and active")
    if sorted_vals is not None:
        build.check_arg(sorted_vals, "sorted_vals", torch.int64, (R, capacity), dev)
        build.check_arg(active, "active", torch.bool, (R,), dev)
    out = torch.empty((R, capacity), dtype=torch.int64, device=dev)
    if out.numel():
        build.check(_lib().chunk_draw(
            key.data_ptr(), universe.data_ptr(), count.data_ptr(), int(t), R,
            capacity, None if sorted_vals is None else sorted_vals.data_ptr(),
            None if active is None else active.data_ptr(), out.data_ptr(),
            build.stream_arg(dev)), "chunk_draw")
        build.LAUNCHES["chunk_draw"] += 1
    return out


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
        build.check(_lib().chunk_decode(
            vals.data_ptr(), kind.data_ptr(), params.data_ptr(),
            count.data_ptr(), owned.data_ptr(), R, cap, edges.data_ptr(),
            keep.data_ptr(), build.stream_arg(dev)), "chunk_decode")
        build.LAUNCHES["chunk_decode"] += 1
    return edges, keep
