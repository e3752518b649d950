"""The Cramer circumsphere predicate (port of
``repro.kernels.delaunay.predicates``), shared by the triangulation, the
planning pass's certificates and the engine's GEOM_CERT rows.

The reference solves ``rows @ off = rhs`` with ``rows = V[1:] - V[0]``
and ``rhs = |rows|^2 / 2`` by Cramer's rule; a zero determinant marks a
degenerate simplex.  Its three sites do not round alike (read from the
compiled objects of each program that runs it):

* inside the jitted triangulation loop and inside the engine's jitted
  pair program, XLA on the CPU fuses multiply-adds: a sum of squares
  ``x0^2 + x1^2 (+ x2^2)`` is ``fma(x1, x1, x0 * x0)`` (then ``fma(x2,
  x2, .)``), a 2 x 2 minor ``a b - c d`` is ``fma(a, b, -(c d))``, and a
  3 x 3 determinant over columns ``x, y, z`` is ``fma(z0, C, fma(x0, A,
  -(y0 B)))`` with ``A, B, C`` the minors of ``(y, z)``, ``(x, z)`` and
  ``(x, y)`` on coordinates 1 and 2 (``fused=True``);
* the planning pass (``repro.core.rdg.circumspheres``) calls the
  predicate outside ``jit``: every operation runs alone, so every
  product and sum is rounded (``fused=False``).

The port follows each site.  ``torch.addcmul`` is one rounding, like an
FMA.  The CUDA device functions (``csrc/predicates.cuh``) compute the
same operations in the same order under ``-fmad=false``.
"""
from __future__ import annotations

import numpy as np
import torch


def fma(a, b, c):
    """``a * b + c`` rounded once."""
    return torch.addcmul(c, a, b)


def sum_squares(x: torch.Tensor, fused: bool = True) -> torch.Tensor:
    """Sum of squares over the last axis: an FMA chain, or (``fused=False``)
    every product and sum rounded."""
    acc = x[..., 0] * x[..., 0]
    for k in range(1, x.shape[-1]):
        acc = fma(x[..., k], x[..., k], acc) if fused else acc + x[..., k] * x[..., k]
    return acc


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root, as XLA's ``vsqrtpd`` and CUDA's
    double ``sqrt`` give it.  PyTorch's vectorised CPU ``sqrt`` is not
    always correctly rounded, so CPU tensors take numpy's."""
    if x.device.type == "cpu":
        with np.errstate(invalid="ignore"):              # NaN for x < 0, as torch.sqrt
            return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)


def _minor(a, b, c, d, fused):
    return fma(a, b, -(c * d)) if fused else a * b - c * d


def _det3(x, y, z, fused):
    """Determinant of the columns ``x, y, z`` (each ``[..., 3]``)."""
    A = _minor(y[..., 1], z[..., 2], y[..., 2], z[..., 1], fused)
    B = _minor(x[..., 1], z[..., 2], x[..., 2], z[..., 1], fused)
    C = _minor(x[..., 1], y[..., 2], x[..., 2], y[..., 1], fused)
    if fused:
        return fma(z[..., 0], C, _minor(x[..., 0], A, y[..., 0], B, fused))
    return x[..., 0] * A - y[..., 0] * B + z[..., 0] * C


def circumsphere(simp: torch.Tensor, fused: bool = True):
    """Circumsphere of ``[..., d+1, d]`` float64 simplices, d in {2, 3}:
    ``(center [..., d], r2 [...], nondeg [...])`` with ``r2`` the squared
    radius.  A degenerate simplex (``det == 0``) reports ``nondeg ==
    False`` and a finite junk center and radius.  ``fused`` picks the
    rounding of the jitted sites or (False) of the planning pass."""
    d = simp.shape[-1]
    if d not in (2, 3):
        raise ValueError(f"circumsphere supports d in {{2, 3}}, got {d}")
    a0 = simp[..., 0, :]
    rows = simp[..., 1:, :] - a0[..., None, :]
    rhs = 0.5 * sum_squares(rows, fused)
    if d == 2:
        r = rows
        det = _minor(r[..., 0, 0], r[..., 1, 1], r[..., 0, 1], r[..., 1, 0], fused)
        num = torch.stack([_minor(rhs[..., 0], r[..., 1, 1], r[..., 0, 1], rhs[..., 1], fused),
                           _minor(r[..., 0, 0], rhs[..., 1], rhs[..., 0], r[..., 1, 0], fused)],
                          dim=-1)
    else:
        # the reference's c_k = rows[..., k] is coordinate k of every row
        c0, c1, c2 = rows[..., 0], rows[..., 1], rows[..., 2]
        det = _det3(c0, c1, c2, fused)
        num = torch.stack([_det3(rhs, c1, c2, fused), _det3(c0, rhs, c2, fused),
                           _det3(c0, c1, rhs, fused)], dim=-1)
    nondeg = det != 0
    off = num / torch.where(nondeg, det, torch.ones_like(det))[..., None]
    return a0 + off, sum_squares(off, fused), nondeg


def circumsphere_in_box(simp: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor):
    """GEOM_CERT certificate, as the engine's jitted pair program rounds
    it: the circumsphere of each ``[..., d+1, d]`` simplex lies inside the
    box ``[lo, hi]`` (each ``[..., d]``); degenerate simplices fail."""
    center, r2, nondeg = circumsphere(simp)
    rad = sqrt_rn(r2)[..., None]
    inside = ((center - rad >= lo).all(dim=-1) & (center + rad <= hi).all(dim=-1))
    return nondeg & inside
