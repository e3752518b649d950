"""Wrappers of the Delaunay kernels (``csrc/delaunay.cu``) and the
capacities of the batched triangulation (port of
``repro.kernels.delaunay.ops``).

For tensors on the CPU each wrapper computes its plain version
(:mod:`.ref`, :mod:`.predicates`); for CUDA tensors it launches its
kernel on the current stream of the tensors' card (``build.launch``),
counts the launch in ``build.LAUNCHES`` and raises if the launch fails.
There is no fallback from one to the other.

Capacities are static per (padded size, dim) bucket, as the reference's:
``simplex_capacity`` is the slot budget (2-D retriangulation is Euler
exact, 3-D may leak slots), ``cavity_capacity`` the largest cavity one
insertion may delete, ``group_size`` the candidates per trip.  An
overflow clears the row's ``ok`` and the planner expands the halo.

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
from .predicates import circumsphere
from .ref import triangulate_ref

_P = ctypes.c_void_p
_I = ctypes.c_longlong
_C = ctypes.c_int
_SIGNATURES = {
    "triangulate": [_P, _P, _I, _I, _I, _C, _C, _C, _C, _P, _P, _P, _P, _P, _P, _P],
    "triangulate_cluster": [_I, _I, _C, _C, _C, ctypes.POINTER(_C)],
    "circumspheres": [_P, _I, _C, _P, _P, _P, _P],
}
#: trip parts whose clock64 cycles ``triangulate(parts=...)`` sums per row
TRIP_PARTS = ("candidates", "scan", "gather", "cavity", "accept", "write")


def _lib():
    return build.library("delaunay", _SIGNATURES)


def simplex_capacity(n: int, dim: int) -> int:
    return 2 * n + 16 if dim == 2 else 8 * n + 64


def cavity_capacity(dim: int) -> int:
    return 32 if dim == 2 else 96


def group_size(dim: int) -> int:
    return 4


@functools.lru_cache(maxsize=None)
def _cluster(B: int, N: int, dim: int, cavity: int, group: int, device: int) -> int:
    c = _C(0)
    build.check(build.query(torch.device("cuda", device), _lib().triangulate_cluster,
                            B, N, dim, cavity, group, ctypes.byref(c)),
                "triangulate cluster query")
    return c.value


def cluster_size(B: int, N: int, dim: int, device=None) -> int:
    """CTAs per row of :func:`triangulate` for ``B`` rows of ``N`` points
    on ``device``: the largest of 16, 8, 4, 2 for which the card holds the
    ``B`` clusters at once (``cudaOccupancyMaxActiveClusters``), else 1.
    Raises where a row's N-bit bitmap does not fit in shared memory."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return _cluster(int(B), int(N), dim, cavity_capacity(dim), group_size(dim), index)


@opscan.opaque("triangulate")
def triangulate(pts: torch.Tensor, cnt: torch.Tensor, *, dim: int, num_simplices: int,
                cavity: int, group: int, work: torch.Tensor | None = None,
                parts: torch.Tensor | None = None):
    """``(simp int32 [B, S, d+1], alive bool [B, S], ok bool [B])`` of
    ``B`` padded rows (see :func:`.ref.triangulate_ref`): ``pts`` float64
    ``[B, N, d]``, ``cnt`` int64 ``[B]``.  ``work`` (int64 ``[B, 2]``)
    receives each row's trips and the alive slots its trips scanned; on
    the card a row stops at the trip that clears its ``ok``, and ``parts``
    (int64 ``[B, 6]``, card only) the clock64 cycles its trips spent in
    each of :data:`TRIP_PARTS`.  On the card each row runs on a cluster
    of :func:`cluster_size` CTAs.  The kernel reads nothing back."""
    if pts.device.type == "cpu":
        if parts is not None:
            raise ValueError("parts counts device clock cycles: CUDA tensors only")
        return triangulate_ref(pts, cnt, dim=dim, num_simplices=num_simplices,
                               cavity=cavity, group=group, work=work)
    B, N, d = pts.shape
    dev = pts.device
    if d != dim or (dim, cavity, group) not in ((2, 32, 4), (3, 96, 4)):
        raise ValueError(f"triangulate runs (dim, cavity, group) = (2, 32, 4) or "
                         f"(3, 96, 4) on {dim}-dimensional points; got {d}-dimensional "
                         f"points with ({dim}, {cavity}, {group})")
    build.check_arg(pts, "pts", torch.float64, (B, N, d), dev)
    build.check_arg(cnt, "cnt", torch.int64, (B,), dev)
    S = num_simplices
    simp = torch.empty((B, S, d + 1), dtype=torch.int32, device=dev)
    alive = torch.empty((B, S), dtype=torch.bool, device=dev)
    ok = torch.empty(B, dtype=torch.bool, device=dev)
    # one slot record: the circumcenter, |cc|^2 and r^2 (a pad in 3-D)
    rec = torch.empty((B, S, 4 if dim == 2 else 6), dtype=torch.float64, device=dev)
    if work is None:
        work = torch.empty((B, 2), dtype=torch.int64, device=dev)
    build.check_arg(work, "work", torch.int64, (B, 2), dev)
    if parts is not None:
        build.check_arg(parts, "parts", torch.int64, (B, len(TRIP_PARTS)), dev)
    if B:
        C = cluster_size(B, N, dim, dev)
        build.launch(
            "triangulate", dev, _lib().triangulate,
            pts.data_ptr(), cnt.data_ptr(), B, N, S, dim, cavity, group, C, simp.data_ptr(),
            alive.data_ptr(), ok.data_ptr(), rec.data_ptr(), work.data_ptr(),
            0 if parts is None else parts.data_ptr())
        build.LAUNCHES["triangulate"] += 1
    return simp, alive, ok


@opscan.opaque("circumspheres")
def circumspheres(simp: torch.Tensor):
    """``(center float64 [R, d], r2 float64 [R], nondeg bool [R])`` of
    ``R`` simplices ``simp`` float64 ``[R, d+1, d]``, rounded as the
    reference's planning pass rounds them (see
    :func:`.predicates.circumsphere`, ``fused=False``)."""
    if simp.device.type == "cpu":
        return circumsphere(simp, fused=False)
    R, dev = simp.shape[0], simp.device
    d = simp.shape[-1]
    build.check_arg(simp, "simp", torch.float64, (R, d + 1, d), dev)
    if d not in (2, 3):
        raise ValueError(f"circumspheres takes d in (2, 3), got {d}")
    center = torch.empty((R, d), dtype=torch.float64, device=dev)
    r2 = torch.empty(R, dtype=torch.float64, device=dev)
    nondeg = torch.empty(R, dtype=torch.bool, device=dev)
    if R:
        build.launch("circumspheres", dev, _lib().circumspheres, simp.data_ptr(), R, d,
                     center.data_ptr(), r2.data_ptr(), nondeg.data_ptr())
        build.LAUNCHES["circumspheres"] += 1
    return center, r2, nondeg


def batched_delaunay(points, counts, *, dim: int, device=None):
    """Triangulate ``B`` padded point rows in one launch: ``points``
    ``[B, N, d]`` float64 and ``counts`` ``[B]`` (numpy arrays or
    tensors), on ``device`` (CUDA unless ``"cpu"``).  Returns ``(simp,
    alive, ok)`` tensors: the alive slots triangulate each row's points
    plus its super-simplex (vertex ids ``>= N``); a row that is not
    ``ok`` must be rebuilt with a larger halo.  Count-0 rows cost no
    trips."""
    dev = build.resolve_device(device)
    pts = torch.as_tensor(points, dtype=torch.float64).to(dev).contiguous()
    cnt = torch.as_tensor(counts, dtype=torch.int64).to(dev).contiguous()
    B, N, d = pts.shape
    if d != dim:
        raise ValueError(f"points are {d}-dimensional, expected {dim}")
    return triangulate(pts, cnt, dim=dim, num_simplices=simplex_capacity(N, dim),
                       cavity=cavity_capacity(dim), group=group_size(dim))
