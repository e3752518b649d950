"""Wrappers of the hist kernel (``csrc/hist.cu``).

Three entry points, as in ``repro.kernels.hist.ops``:

* :func:`degree_histogram` / :func:`log2_histogram` -- histogram of
  *values* (per-vertex degrees), linear or log2-binned; values past the
  last bin are clamped into it.
* :func:`bincount_ids` -- occurrence counts of ids in ``[0, length)``
  (degree accumulation from edge endpoints); other ids are dropped.

Both reach :func:`hist_counts`, which runs the kernel for CUDA tensors
(counting the launch in ``build.LAUNCHES``) and the plain version
(:mod:`.ref`) for CPU tensors.  The reference sends ``bincount_ids``
above 4096 bins to XLA's scatter; here one kernel computes both cases.
Values are int64 throughout (the reference casts to int32 first, which
is the same for every value below 2^31).  Negative ids are dropped
whatever the length.

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
from .ref import hist_counts_ref

# log2 binning: bin 0 holds value 0, bin 1 + k holds [2^k, 2^(k+1));
# 32 bins cover every non-negative int32, as in the reference.
LOG2_BINS = 32

_SIGNATURES = {"hist": [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                        ctypes.c_void_p]}


_ENTRY = []   # the loaded ``hist`` entry point, resolved at the first launch


def _entry():
    if not _ENTRY:
        _ENTRY.append(build.library("hist", _SIGNATURES).hist)
    return _ENTRY[0]


@opscan.opaque("hist_counts")
def hist_counts(values: torch.Tensor, num_bins: int, *, log2: bool = False,
                drop: bool = False,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int64 counts[num_bins] of ``values``, added into ``out`` when it is
    given (in place: the degree accumulators add every chunk into one
    degree array instead of allocating a histogram per chunk)."""
    v = values if values.dim() == 1 else values.reshape(-1)
    if v.dtype != torch.int64 or not v.is_contiguous():
        v = v.to(torch.int64).contiguous()
    dev = v.device
    if out is None:
        out = torch.zeros(num_bins, dtype=torch.int64, device=dev)
    build.check_arg(out, "out", torch.int64, (num_bins,), dev)
    if dev.type == "cpu":
        return out.add_(hist_counts_ref(v, num_bins, log2=log2, drop=drop))
    n = v.numel()
    if n and num_bins:
        build.launch("hist", dev, _entry(), v.data_ptr(), n, num_bins, log2, drop,
                     out.data_ptr())
        build.LAUNCHES["hist"] += 1
    return out


def degree_histogram(values: torch.Tensor, num_bins: int, *,
                     log2: bool = False) -> torch.Tensor:
    """int64 counts[num_bins] of ``values`` (overflow clamped)."""
    return hist_counts(values, num_bins, log2=log2)


def log2_histogram(values: torch.Tensor) -> torch.Tensor:
    """int64 counts[LOG2_BINS]: bin 0 = zeros, bin 1+k = [2^k, 2^(k+1))."""
    return degree_histogram(values, LOG2_BINS, log2=True)


def bincount_ids(ids: torch.Tensor, length: int, *,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int64 counts[length]: occurrences of each id in ``[0, length)``;
    ids outside it are dropped.  Adds into ``out`` when given."""
    return hist_counts(ids, length, drop=True, out=out)
