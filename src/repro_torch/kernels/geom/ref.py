"""Plain PyTorch versions of the geometric engine kernels: the per-row
candidate-pair program of ``repro.distrib.engine._pair_fn`` (GEOM_TORUS,
GEOM_HYP and GEOM_CERT) and the cell program of ``_point_cell_fn``.

Both regenerate a cell's points from its hashed key with the counter
uniforms of :func:`repro_torch.core.prng.counter_uniform` and decode
them as the reference does:

* cube (RGG): ``(cell + u) / g`` in float64 (cast to float32 for the
  edge test; the cell program multiplies by ``1 / g`` instead, as XLA
  does with the reference's constant);
* polar (RHG): ``r = arccosh(clo + u0 (chi - clo)) / alpha`` and
  ``θ = (cell + u1) w``; the edge test adds the features ``[cos θ,
  sin θ, cosh r / sinh r, 1 / sinh r]`` of ``r = max(r, 1e-12)``.

The transcendentals are those of the reference's compiled programs, bit
for bit (:mod:`.libm`): XLA-CPU's own ``exp``, ``expm1`` and ``log1p``,
glibc's ``log``, ``sin`` and ``cos``.  Around them, ``clo + u0 (chi -
clo)`` is one fused multiply-add, ``arccosh(x) = log1p(sqrt(x - 1)
(sqrt(x + 1) + sqrt(x - 1)))`` (``log x + log 2`` from 2^1023 on),
``cosh r = exp(r - log 2) + exp(-log 2 - r)`` and ``sinh r`` is ``(e +
e / (e + 1)) / 2`` with ``e = expm1(r)`` below 1, ``exp(r - log 2) -
exp(-log 2 - r)`` above, as XLA expands them.  Every divisor is a
tensor: on the card a division by a Python float would be a
multiplication by its reciprocal.

A GEOM_CERT row (RDG) re-certifies one Delaunay simplex: the Cramer
circumsphere of ``geom_a[:(d+1) d]`` must lie inside the box ``geom_b[:2
d]`` (:func:`repro_torch.kernels.delaunay.predicates.circumsphere_in_box`),
and slot pair ``(i, j)`` emits the edge of the row's vertex ids ``gid_a[i],
gid_a[j]`` when bit ``pair_slot_index(i, j, cap)`` of ``gid_b[0]`` is set.

The CUDA kernels (``csrc/geom.cu``, with ``csrc/libm.cuh``) compute the
same operations in the same order, so on the card they equal these
functions bit for bit.
"""
from __future__ import annotations

import torch

from ...core.prng import counter_uniform
from ..delaunay.predicates import circumsphere_in_box, sqrt_rn
from ..pairmask.ref import euclid_tile, hyp_tile
from .libm import glibc_cos, glibc_log, glibc_sin, xla_exp, xla_expm1, xla_log1p

# geometry kinds of the pair table and point kinds of the cell table (the
# reference's codes)
GEOM_EMPTY, GEOM_HYP, GEOM_TORUS, GEOM_CERT = 0, 1, 2, 3
POINTS_CUBE, POINTS_POLAR = "cube", "polar"

_LOG2 = 0.69314718055994529
_ACOSH_LARGE = 8.9884656743115785e+307   # 2^1023


def acosh_xla(x: torch.Tensor) -> torch.Tensor:
    """arccosh as XLA expands it, for ``x >= 1``."""
    sm = sqrt_rn(x - 1.0)
    small = xla_log1p(sm * (sqrt_rn(x + 1.0) + sm))
    return torch.where(x >= _ACOSH_LARGE, glibc_log(x) + _LOG2, small)


def polar_draw(key, geom: torch.Tensor, capacity: int):
    """(alpha r, θ) float64 ``[R, capacity]`` of polar cells: ``geom [R,
    >= 4]`` holds (clo, chi, cell index, angular width)."""
    u = counter_uniform(key, capacity, 2)
    clo, chi = geom[:, 0, None], geom[:, 1, None]
    x = torch.addcmul(clo, u[..., 0], chi - clo)
    theta = (geom[:, 2, None] + u[..., 1]) * geom[:, 3, None]
    return acosh_xla(x), theta


def hyp_radius_theta(key, geom: torch.Tensor, scale: torch.Tensor, capacity: int):
    """(r, θ) of the edge test: ``r = max(alpha r / scale, 1e-12)``
    (``scale [R]``, divided)."""
    ar, theta = polar_draw(key, geom, capacity)
    return torch.clamp_min(ar / scale[:, None], 1e-12), theta


def hyp_features(key, geom: torch.Tensor, scale: torch.Tensor, capacity: int) -> torch.Tensor:
    """float64 ``[R, capacity, 4]``: ``[cos θ, sin θ, coth r, 1/sinh r]``."""
    r, theta = hyp_radius_theta(key, geom, scale, capacity)
    e_hi = xla_exp(r - _LOG2)
    e_lo = xla_exp(-_LOG2 - r)
    em1 = xla_expm1(r)
    sh = torch.where(r.abs() < 1.0, (em1 + em1 / (em1 + 1.0)) * 0.5, e_hi - e_lo)
    return torch.stack([glibc_cos(theta), glibc_sin(theta),
                        (e_hi + e_lo) / sh, 1.0 / sh], dim=-1)


def cube_draw(key, geom: torch.Tensor, capacity: int, dim: int) -> torch.Tensor:
    """float64 ``[R, capacity, dim]``: ``cell + u`` with the cell's integer
    coordinates in ``geom [R, >= dim]``."""
    return geom[:, None, :dim] + counter_uniform(key, capacity, dim)


def stage_bounds(stage, capacity: int):
    """``(HYP, TORUS)`` bounds of ``pair_edges``' ``stage`` mapping (a kind
    left out, or no mapping, is bounded by the capacity)."""
    stage = {} if stage is None else dict(stage)
    if set(stage) - {GEOM_HYP, GEOM_TORUS}:
        raise ValueError(f"pair_edges: stage bounds GEOM_HYP and GEOM_TORUS rows, got {stage}")
    out = tuple(int(stage.get(k, capacity)) for k in (GEOM_HYP, GEOM_TORUS))
    if not all(0 <= b <= capacity for b in out):
        raise ValueError(f"pair_edges: stage {stage} outside 0..capacity={capacity}")
    return out


def check_stage(kind, count_a, count_b, active, kinds, capacity: int, stage) -> None:
    """Raise ``ValueError`` where an active row of a kind the launch runs
    holds more points (at most ``capacity``) than its kind's stage."""
    for k, bound in zip((GEOM_HYP, GEOM_TORUS), stage_bounds(stage, capacity)):
        if k not in kinds or bound == capacity:
            continue
        live = active & (kind == k)
        most = torch.maximum(count_a, count_b).clamp(0, capacity)
        if bool((live & (most > bound)).any()):
            raise ValueError(f"pair_edges: a row of kind {k} holds {int(most[live].max())} "
                             f"points, past its stage {bound}")


def pair_edges_ref(kind, key_a, key_b, count_a, count_b, gid_a, gid_b, geom_a,
                   geom_b, fparams, self_pair, active, *, capacity: int, dim: int,
                   kinds=(GEOM_HYP, GEOM_TORUS), stage=None):
    """(edges int64 ``[R, capacity^2, 2]``, keep bool ``[R, capacity^2]``)
    of ``R`` candidate-pair rows: slot ``i * capacity + j`` holds the
    canonical edge ``(max, min)`` of ``gid_a + i`` and ``gid_b + j`` (on
    a CERT row, of ``gid_a[i]`` and ``gid_a[j]``) and keeps it when both
    slots hold points (``i < count_a``, ``j < count_b``), ``i < j`` on a
    self pair, the row is active and the row's geometry test passes.
    ``fparams`` is ``(g, r^2)`` on TORUS rows and ``(alpha, cosh R)`` on
    HYP rows.  ``stage`` bounds each kind's counts (see
    :func:`repro_torch.kernels.geom.ops.pair_edges`): a row past it
    raises, as the kernel refuses it."""
    if stage is not None:
        check_stage(kind, count_a, count_b, active, kinds, capacity, stage)
    N = capacity
    R = kind.shape[0]
    dev = kind.device
    ii = torch.arange(N, dtype=torch.int64, device=dev)
    I, J = ii[None, :, None], ii[None, None, :]
    valid = (I < count_a[:, None, None]) & (J < count_b[:, None, None])
    once = ~self_pair[:, None, None] | (I < J)
    hit = torch.zeros((R, N, N), dtype=torch.bool, device=dev)
    if GEOM_HYP in kinds:
        fa = hyp_features(key_a, geom_a, fparams[:, 0], N)
        fb = hyp_features(key_b, geom_b, fparams[:, 0], N)
        hyp = hyp_tile(fa, fb, fparams[:, 1, None, None])
        hit = torch.where((kind == GEOM_HYP)[:, None, None], hyp, hit)
    if GEOM_TORUS in kinds:
        g = fparams[:, 0, None, None]
        pa = (cube_draw(key_a, geom_a, N, dim) / g).to(torch.float32)
        pb = (cube_draw(key_b, geom_b, N, dim) / g).to(torch.float32)
        near = euclid_tile(pa, pb, fparams[:, 1, None, None].to(torch.float32), dim)
        hit = torch.where((kind == GEOM_TORUS)[:, None, None], near, hit)
    ga = gid_a[:, 0, None, None] + I
    gb = gid_b[:, 0, None, None] + J
    if GEOM_CERT in kinds:
        cert_row = (kind == GEOM_CERT)[:, None, None]
        simp = geom_a[:, :(dim + 1) * dim].reshape(R, dim + 1, dim)
        cert = circumsphere_in_box(simp, geom_b[:, :dim], geom_b[:, dim:2 * dim])
        slot = (I * (N - 1) - torch.div(I * (I - 1), 2, rounding_mode="floor")
                + (J - I - 1)).clamp(0, 62)
        bit = torch.bitwise_right_shift(gid_b[:, 0, None, None], slot) & 1
        hit = torch.where(cert_row, (bit == 1) & cert[:, None, None], hit)
        kmax = gid_a.shape[-1] - 1
        ga = torch.where(cert_row, gid_a[:, I.clamp(0, kmax)[0]], ga)
        gb = torch.where(cert_row, gid_a[:, J.clamp(0, kmax)[0]], gb)
    keep = hit & valid & once & active[:, None, None]
    edges = torch.stack(torch.broadcast_tensors(torch.maximum(ga, gb),
                                                torch.minimum(ga, gb)), dim=-1)
    return edges.reshape(R, N * N, 2), keep.reshape(R, N * N)


def cell_points_ref(key, count, cell, geom, *, kind: str, scale: float,
                    capacity: int, dim: int):
    """(points float64 ``[R, capacity, dim]``, mask bool ``[R, capacity]``)
    of ``R`` point-plan cells; padding slots (``mask`` false) hold 0.
    Cube cells: ``(cell + u) / scale``.
    Polar cells: ``(r, θ)`` with ``geom = (clo, chi, width)`` and
    ``cell = (ring, angular index)``; ``scale`` is alpha.

    The plan's ``scale`` is a constant of the reference's compiled
    program, and XLA divides by a constant as a multiplication by its
    float64 reciprocal; so does this function."""
    R, dev = count.shape[0], count.device
    inv = torch.tensor(1.0 / scale, dtype=torch.float64, device=dev)
    if kind == POINTS_CUBE:
        pts = cube_draw(key, cell.to(torch.float64), capacity, dim) * inv
    elif kind == POINTS_POLAR:
        g4 = torch.stack([geom[:, 0], geom[:, 1], cell[:, 1].to(torch.float64),
                          geom[:, 2]], dim=-1)
        ar, theta = polar_draw(key, g4, capacity)
        pts = torch.stack([ar * inv, theta], dim=-1)
    else:
        raise ValueError(f"unknown point kind {kind!r}")
    mask = torch.arange(capacity, device=dev)[None, :] < count[:, None]
    return torch.where(mask[..., None], pts, torch.zeros((), dtype=pts.dtype, device=dev)), mask

