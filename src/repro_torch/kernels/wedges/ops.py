"""Wrapper of the wedge-closing kernel (``csrc/wedges.cu``) and its table
builder (:func:`.table.wedge_table`).

For tensors on the CPU it computes its plain version
(:func:`.ref.close_wedges_table_ref`); for CUDA tensors it launches the
kernel on the current stream of the tensors' card (``build.launch``),
counts the launch in ``build.LAUNCHES`` and raises if the launch fails.
There is no fallback from one to the other.

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
from .ref import close_wedges_table_ref
from .table import WedgeTable, wedge_table

__all__ = ["WedgeTable", "close_wedges", "wedge_table"]

_P = ctypes.c_void_p
_I = ctypes.c_longlong
_SIGNATURES = {"close_wedges": [_P, _P, _I, _P, _I, _P, _P, _P, _I, _I, _P, _P]}


@opscan.opaque("close_wedges")
def close_wedges(edges: torch.Tensor, table: WedgeTable, *,
                 mask: Optional[torch.Tensor] = None, count: Optional[int] = None,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int64 ``[S]`` counts of the valid slots of ``edges`` (int64 ``[N,
    2]``, vertex ids) whose two endpoints are both in a sample's row, per
    sample of ``table`` (:func:`.table.wedge_table` of the neighbour
    table): see :func:`.ref.close_wedges_ref`.  The valid slots are
    ``mask`` (bool ``[N]``) when it is given, else the first ``count``
    (all when ``count`` is None).  The counts are added into ``out``
    (int64 ``[S]``) when it is given."""
    S = table.samples
    N, dev = edges.shape[0], edges.device
    if count is None:
        count = N
    if out is None:
        out = torch.zeros(S, dtype=torch.int64, device=dev)
    build.check_arg(out, "out", torch.int64, (S,), dev)
    if dev.type == "cpu":
        return out.add_(close_wedges_table_ref(edges, table, mask=mask, count=count))
    build.check_arg(edges, "edges", torch.int64, (N, 2), dev)
    if mask is not None:
        build.check_arg(mask, "mask", torch.bool, (N,), dev)
    T = table.hkey.numel()
    build.check_arg(table.hkey, "table.hkey", torch.int64, (T,), dev)
    build.check_arg(table.off, "table.off", torch.int64, (T + 1,), dev)
    build.check_arg(table.ids, "table.ids", torch.int32, (table.ids.numel(),), dev)
    build.check_arg(table.filt, "table.filt", torch.int32, (table.filt.numel(),), dev)
    if edges.data_ptr() % 16 or table.filt.data_ptr() % 16:
        raise ValueError("edges and table.filt must be 16-byte aligned (16-byte loads)")
    n = N if mask is not None else min(int(count), N)
    if n and table.ids.numel():     # an empty union closes no wedge
        build.launch(
            "close_wedges", dev, build.library("wedges", _SIGNATURES).close_wedges,
            edges.data_ptr(), None if mask is None else mask.data_ptr(), n,
            table.hkey.data_ptr(), table.log_t, table.off.data_ptr(), table.ids.data_ptr(),
            table.filt.data_ptr(), table.log_f, S, out.data_ptr())
        build.LAUNCHES["close_wedges"] += 1
    return out
