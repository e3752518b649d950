"""Wrapper of the wedge-closing kernel (``csrc/wedges.cu``).

For tensors on the CPU it computes its plain version (:mod:`.ref`); for
CUDA tensors it launches the kernel on the current stream, counts the
launch in ``build.LAUNCHES`` and raises if the launch fails.  There is
no fallback from one to the other.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import build
from .ref import close_wedges_ref

_P = ctypes.c_void_p
_I = ctypes.c_longlong
_SIGNATURES = {"close_wedges": [_P, _P, _I, _P, _I, _I, _P, _P]}


def close_wedges(edges: torch.Tensor, nb: torch.Tensor, *,
                 mask: Optional[torch.Tensor] = None, count: Optional[int] = None,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int64 ``[S]`` counts of the valid slots of ``edges`` (int64 ``[N,
    2]``) that close a wedge of each sample row of ``nb`` (int64 ``[S,
    NB]``, sorted, sentinel-padded): see :func:`.ref.close_wedges_ref`.
    The valid slots are ``mask`` (bool ``[N]``) when it is given, else
    the first ``count`` (all when ``count`` is None).  The counts are
    added into ``out`` (int64 ``[S]``) when it is given."""
    S, NB = nb.shape
    N, dev = edges.shape[0], edges.device
    if count is None:
        count = N
    if out is None:
        out = torch.zeros(S, dtype=torch.int64, device=dev)
    build.check_arg(out, "out", torch.int64, (S,), dev)
    if dev.type == "cpu":
        return out.add_(close_wedges_ref(edges, nb, mask=mask, count=count))
    build.check_arg(edges, "edges", torch.int64, (N, 2), dev)
    build.check_arg(nb, "nb", torch.int64, (S, NB), dev)
    if mask is not None:
        build.check_arg(mask, "mask", torch.bool, (N,), dev)
    if edges.data_ptr() % 16:
        raise ValueError("edges must be 16-byte aligned (the kernel loads an edge at once)")
    n = N if mask is not None else min(int(count), N)
    if n and S and NB:
        build.check(build.library("wedges", _SIGNATURES).close_wedges(
            edges.data_ptr(), None if mask is None else mask.data_ptr(), n,
            nb.data_ptr(), S, NB, out.data_ptr(), build.stream_arg(dev)), "close_wedges")
        build.LAUNCHES["close_wedges"] += 1
    return out
