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
same order.  Every function broadcasts over leading batch dimensions:
``a [..., M, F]`` against ``b [..., N, F]`` gives ``[..., M, N]``.
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
