"""Wrapper of the pair-mask kernel (``csrc/pairmask.cu``).

:func:`pair_mask` computes its plain version (:mod:`.ref`) for tensors
on the CPU; for CUDA tensors it launches the kernel on the current
stream, counts the launch in ``build.LAUNCHES`` and raises if the launch
fails.  There is no fallback from one to the other.

Each entry point is opaque to the op scan of
``repro_torch.analyze.opscan``: inside a trace a call counts as one
launch, whichever version runs.
"""
from __future__ import annotations

import ctypes

import torch

from ...analyze import opscan
from .. import build
from .ref import TILES, pair_mask_ref

_P = ctypes.c_void_p
_I = ctypes.c_longlong
_SIGNATURES = {"pair_mask": [_P, _P, _I, _I, _I, _I, ctypes.c_int, ctypes.c_int,
                             ctypes.c_float, ctypes.c_double, _P, _P]}


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
        build.check(_lib().pair_mask(
            a.data_ptr(), b.data_ptr(), B, M, N, F, int(tile == "hyp"), dim,
            float(scalar), float(scalar), out.data_ptr(), build.stream_arg(dev)),
            "pair_mask")
        build.LAUNCHES["pair_mask"] += 1
    return out if batched else out[0]

