"""Plain PyTorch versions of the pair-mask tiles (port of
``repro.kernels.pairmask.ref``).

XLA on the CPU contracts the reference's tile arithmetic into fused
multiply-adds, so the plain version spells the fused order out with
``torch.addcmul`` (one rounding, like an FMA):

* ``euclid`` (float32): ``fma(d0, d0, d1 * d1)``, then in 3-D
  ``fma(d2, d2, acc)``, compared ``acc <= r^2``;
* ``hyp`` (float64, the Eq. 9 sign test on the features ``[cos θ,
  sin θ, coth r, 1/sinh r]``): ``fma(coshR, q3 * c3, fma(-q2, c2,
  fma(q0, c0, q1 * c1))) > 0``.

The CUDA tiles (``csrc/tiles.cuh``) compute the same operations in the
same order.  Every tile broadcasts over leading batch dimensions:
``a [..., M, F]`` against ``b [..., N, F]`` gives ``[..., M, N]``.

:func:`hyp_edges_ref` runs the hyp tile over a table of ragged segments
and keeps the hits' gid pairs, as ``rhg_pe`` needs them.
"""
from __future__ import annotations

import torch

TILES = ("euclid", "hyp")


def _pairs(a: torch.Tensor, b: torch.Tensor, k: int):
    """Column ``k`` of ``a`` as ``[..., M, 1]`` and of ``b`` as ``[..., 1, N]``."""
    return a[..., :, None, k], b[..., None, :, k]


def euclid_tile(a: torch.Tensor, b: torch.Tensor, r2, dim: int) -> torch.Tensor:
    """bool ``[..., M, N]``: squared float32 distance over the first
    ``dim`` (2 or 3) columns ``<= r2``."""
    if dim not in (2, 3):
        raise ValueError(f"euclid tile takes dim 2 or 3, got {dim}")
    d = [x - y for x, y in (_pairs(a, b, k) for k in range(dim))]
    acc = torch.addcmul(d[1] * d[1], d[0], d[0])
    if dim == 3:
        acc = torch.addcmul(acc, d[2], d[2])
    return acc <= r2


def hyp_tile(q: torch.Tensor, c: torch.Tensor, cosh_r) -> torch.Tensor:
    """bool ``[..., M, N]``: the Eq. 9 test ``dist_H < R`` on float64
    feature rows; ``cosh_r`` broadcasts against ``[..., M, N]``."""
    (q0, c0), (q1, c1), (q2, c2), (q3, c3) = (_pairs(q, c, k) for k in range(4))
    acc = torch.addcmul(q1 * c1, q0, c0)
    acc = torch.addcmul(acc, -q2, c2)
    acc = torch.addcmul(acc, q3 * c3, torch.as_tensor(cosh_r, dtype=q.dtype,
                                                      device=q.device))
    return acc > 0


def pair_mask_ref(a: torch.Tensor, b: torch.Tensor, scalar, *, tile: str,
                  dim: int = 2) -> torch.Tensor:
    """int8 ``[..., M, N]`` mask of the tile test over all pairs: the
    plain twin of :func:`repro_torch.kernels.pairmask.ops.pair_mask`.
    ``scalar`` is r^2 (rounded to float32) for ``euclid`` and cosh R for
    ``hyp``."""
    if tile == "euclid":
        r2 = torch.tensor(float(scalar), dtype=torch.float32, device=a.device)
        return euclid_tile(a, b, r2, dim).to(torch.int8)
    if tile == "hyp":
        return hyp_tile(a, b, float(scalar)).to(torch.int8)
    raise ValueError(f"unknown tile {tile!r}; know {TILES}")


def hyp_edges_ref(q: torch.Tensor, c: torch.Tensor, q_gid: torch.Tensor,
                  c_gid: torch.Tensor, segments: torch.Tensor, cosh_r) -> torch.Tensor:
    """int64 ``[K, 2]`` of ``(q_gid[i], c_gid[j])`` for every pair of each
    segment ``(q_off, q_len, c_off, c_len)`` of ``segments`` whose hyp tile
    holds and whose gids differ: segment by segment, row-major in
    ``(i, j)`` within one.  The plain twin of
    :func:`repro_torch.kernels.pairmask.ops.hyp_edges`."""
    out = [torch.zeros((0, 2), dtype=torch.int64, device=q.device)]
    for qo, ql, co, cl in segments.tolist():
        if ql == 0 or cl == 0:
            continue
        ii, jj = torch.nonzero(hyp_tile(q[qo:qo + ql], c[co:co + cl], float(cosh_r)),
                               as_tuple=True)
        u, v = q_gid[qo + ii], c_gid[co + jj]
        keep = u != v
        out.append(torch.stack([u[keep], v[keep]], dim=1))
    return torch.cat(out)
