"""Wrappers of the geometric engine kernels (``csrc/geom.cu``).

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
from typing import Mapping, Optional

import torch

from ...analyze import opscan
from .. import build
from . import libm
from .ref import (GEOM_CERT, GEOM_EMPTY, GEOM_HYP, GEOM_TORUS, POINTS_CUBE, POINTS_POLAR,
                  cell_points_ref, pair_edges_ref, stage_bounds)

_P = ctypes.c_void_p
_I = ctypes.c_longlong
_C = ctypes.c_int
_SIGNATURES = {
    "pair_edges": [_P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _I, _P, _I, _P, _P,
                   _I, _I, _I, _I, _C, _C, _P, _P, _P],
    "cell_points": [_P, _P, _P, _I, _P, _I, _C, ctypes.c_double, _I, _I, _C,
                    _P, _P, _P],
    "libm_eval": [_C, _P, _P, _I, _P],
}
# the row kinds a pair_edges launch runs, as the kernel's bits
_KIND_BITS = {GEOM_HYP: 1, GEOM_TORUS: 2, GEOM_CERT: 4}
#: the device libm functions ``libm_eval`` runs, in the kernel's order
LIBM_FUNCTIONS = {"xla_exp": libm.xla_exp, "xla_expm1": libm.xla_expm1,
                  "xla_log1p": libm.xla_log1p, "glibc_log": libm.glibc_log,
                  "glibc_sin": libm.glibc_sin, "glibc_cos": libm.glibc_cos}


def _lib():
    return build.library("geom", _SIGNATURES)


@opscan.opaque("pair_edges")
def pair_edges(kind, key_a, key_b, count_a, count_b, gid_a, gid_b, geom_a, geom_b,
               fparams, self_pair, active, *, capacity: int, dim: int, kinds,
               stage: Optional[Mapping[int, int]] = None):
    """(edges int64 ``[R, capacity^2, 2]``, keep bool ``[R, capacity^2]``)
    of ``R`` GEOM_TORUS / GEOM_HYP / GEOM_CERT candidate-pair rows (see
    :func:`.ref.pair_edges_ref`).  ``kind`` int32 ``[R]``; keys int32
    ``[R, 2]`` (the uint32 words' bits); counts int64 ``[R]``; gids int64
    ``[R, K]``; geoms float64 ``[R, G]``; ``fparams`` float64 ``[R, F]``;
    ``self_pair`` and ``active`` bool ``[R]``.

    ``stage`` maps ``GEOM_HYP`` and ``GEOM_TORUS`` to a bound on the
    counts of that kind's active rows which the caller knows from its host
    tables, e.g. the largest count of each kind in a serving slab whose
    rows run at a capacity class above their own; a kind left out is
    bounded by ``capacity``.  The bound is a precondition: a row past it
    is refused (the plain version raises ``ValueError``; on the card a
    check kernel launched first fails the launch with a device assertion,
    which ends the process's CUDA context), never clamped.  On the card a row stages ``2 stage`` points
    of its kind (32 bytes each on HYP rows, 16 on TORUS rows) in a
    block's shared memory: a HYP stage up to 3630 or a TORUS stage up to
    7261 on an H100, at any capacity; the launch raises beyond."""
    if kind.device.type == "cpu":
        return pair_edges_ref(kind, key_a, key_b, count_a, count_b, gid_a, gid_b,
                              geom_a, geom_b, fparams, self_pair, active,
                              capacity=capacity, dim=dim, kinds=kinds, stage=stage)
    R, dev = kind.shape[0], kind.device
    K, G, F = gid_a.shape[-1], geom_a.shape[-1], fparams.shape[-1]
    build.check_arg(kind, "kind", torch.int32, (R,), dev)
    for name, t in (("key_a", key_a), ("key_b", key_b)):
        build.check_arg(t, name, torch.int32, (R, 2), dev)
    for name, t in (("count_a", count_a), ("count_b", count_b)):
        build.check_arg(t, name, torch.int64, (R,), dev)
    for name, t in (("gid_a", gid_a), ("gid_b", gid_b)):
        build.check_arg(t, name, torch.int64, (R, K), dev)
    for name, t in (("geom_a", geom_a), ("geom_b", geom_b)):
        build.check_arg(t, name, torch.float64, (R, G), dev)
    build.check_arg(fparams, "fparams", torch.float64, (R, F), dev)
    build.check_arg(self_pair, "self_pair", torch.bool, (R,), dev)
    build.check_arg(active, "active", torch.bool, (R,), dev)
    if set(kinds) - {GEOM_EMPTY, GEOM_HYP, GEOM_TORUS, GEOM_CERT}:
        raise ValueError(f"pair_edges runs GEOM_TORUS, GEOM_HYP and GEOM_CERT rows, got {kinds}")
    need = max(4 if GEOM_HYP in kinds else 0, dim if GEOM_TORUS in kinds else 0,
               (dim + 1) * dim if GEOM_CERT in kinds else 0)
    need_f = 2 if {GEOM_HYP, GEOM_TORUS} & set(kinds) else 1
    if F < need_f or G < need or K < 1 or dim not in (2, 3):
        raise ValueError(f"pair_edges: want F >= {need_f}, G >= {need}, K >= 1, dim 2 or 3; "
                         f"got F={F}, G={G}, K={K}, dim={dim}")
    stage_hyp, stage_torus = stage_bounds(stage, capacity)
    bits = sum(_KIND_BITS[k] for k in set(kinds) - {GEOM_EMPTY})
    slots = capacity * capacity
    edges = torch.empty((R, slots, 2), dtype=torch.int64, device=dev)
    keep = torch.empty((R, slots), dtype=torch.bool, device=dev)
    if edges.numel():
        build.launch(
            "pair_edges", dev, _lib().pair_edges,
            kind.data_ptr(), key_a.data_ptr(), key_b.data_ptr(), count_a.data_ptr(),
            count_b.data_ptr(), gid_a.data_ptr(), gid_b.data_ptr(), K,
            geom_a.data_ptr(), geom_b.data_ptr(), G, fparams.data_ptr(), F,
            self_pair.data_ptr(), active.data_ptr(), R, capacity, stage_hyp, stage_torus,
            dim, bits, edges.data_ptr(), keep.data_ptr())
        build.LAUNCHES["pair_edges"] += 1
    return edges, keep


@opscan.opaque("cell_points")
def cell_points(key, count, cell, geom, *, kind: str, scale: float, capacity: int,
                dim: int):
    """(points float64 ``[R, capacity, dim]``, mask bool ``[R,
    capacity]``) of ``R`` point-plan cells (see
    :func:`.ref.cell_points_ref`).  ``key`` int32 ``[R, 2]``, ``count``
    int64 ``[R]``, ``cell`` int64 ``[R, Kc]``, ``geom`` float64 ``[R, G]``."""
    if count.device.type == "cpu":
        return cell_points_ref(key, count, cell, geom, kind=kind, scale=scale,
                               capacity=capacity, dim=dim)
    if kind not in (POINTS_CUBE, POINTS_POLAR):
        raise ValueError(f"unknown point kind {kind!r}")
    R, dev = count.shape[0], count.device
    Kc, G = cell.shape[-1], geom.shape[-1]
    polar = kind == POINTS_POLAR
    if (polar and (dim != 2 or Kc < 2 or G < 3)) or (not polar and Kc < dim) or \
            not 0 < dim < 4:
        raise ValueError(f"cell_points: {kind} cells with dim={dim}, Kc={Kc}, G={G}")
    build.check_arg(key, "key", torch.int32, (R, 2), dev)
    build.check_arg(count, "count", torch.int64, (R,), dev)
    build.check_arg(cell, "cell", torch.int64, (R, Kc), dev)
    build.check_arg(geom, "geom", torch.float64, (R, G), dev)
    out = torch.empty((R, capacity, dim), dtype=torch.float64, device=dev)
    mask = torch.empty((R, capacity), dtype=torch.bool, device=dev)
    if mask.numel():
        build.launch(
            "cell_points", dev, _lib().cell_points,
            key.data_ptr(), count.data_ptr(), cell.data_ptr(), Kc, geom.data_ptr(), G,
            int(polar), 1.0 / float(scale), R, capacity, dim, out.data_ptr(),
            mask.data_ptr())
        build.LAUNCHES["cell_points"] += 1
    return out, mask


def libm_eval(name: str, x: torch.Tensor) -> torch.Tensor:
    """One of :data:`LIBM_FUNCTIONS` (``csrc/libm.cuh``) on float64 ``x``:
    its plain version on the CPU, the device function on the card.  Not a
    kernel of any path: it holds the device functions against the plain
    ones."""
    fn = LIBM_FUNCTIONS[name]
    if x.device.type == "cpu":
        return fn(x)
    build.check_arg(x, "x", torch.float64, tuple(x.shape), x.device)
    y = torch.empty_like(x)
    build.launch("libm_eval", x.device, _lib().libm_eval, list(LIBM_FUNCTIONS).index(name),
                 x.data_ptr(), y.data_ptr(), x.numel())
    return y
