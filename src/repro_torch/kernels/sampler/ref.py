"""Plain PyTorch versions of the sampler kernels (same function, no kernel).

``chunk_draw_ref`` and ``chunk_decode_ref`` compute exactly what
``csrc/sampler.cu`` computes, element for element; the CPU tests hold
them against ``repro.core.sampling`` and ``chip_smoke.py`` holds the
kernels against them on the card.  The decodes are the reference's
``decode_directed`` / ``decode_tri`` / ``decode_rect`` on int64 tensors.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...core.prng import bits64_limbs, fold_in, key_words, mod_u64

KIND_EMPTY, KIND_DIRECTED, KIND_TRI, KIND_RECT = 0, 1, 2, 3


def decode_directed(idx, n, row_lo):
    """Chunk-local universe index -> directed edge (u, v), u != v."""
    row = row_lo + idx // (n - 1)
    c = idx % (n - 1)
    col = c + (c >= row).to(idx.dtype)
    return row, col


def decode_rect(idx, width, row_lo, col_lo):
    """Rect chunk index -> undirected edge (u, v) with u > v."""
    return row_lo + idx // width, col_lo + idx % width


def _tri(k):
    return k * (k - 1) // 2


def decode_tri(idx, lo):
    """Strictly-lower-tri chunk index -> undirected edge (u, v), u > v.

    The float64 isqrt estimate is corrected in int64 (three steps, as the
    reference does), so it is exact up to idx ~ 2^62; the products wrap
    in int64 exactly as XLA's do."""
    idx = torch.as_tensor(idx, dtype=torch.int64)
    r = torch.floor((1.0 + torch.sqrt(1.0 + 8.0 * idx.to(torch.float64))) / 2.0
                    ).to(torch.int64)
    for _ in range(3):
        r = r - (_tri(r) > idx).to(torch.int64) + (_tri(r + 1) <= idx).to(torch.int64)
    return lo + r, lo + idx - _tri(r)


def chunk_draw_ref(key: torch.Tensor, universe: torch.Tensor,
                   count: torch.Tensor, t: int, capacity: int,
                   sorted_vals: Optional[torch.Tensor] = None,
                   active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int64 ``[R, capacity]`` draws of round ``t`` for ``R`` chunk rows.

    Slot ``i`` of row ``r``: ``bits64(fold_in(fold_in(key_r, t), i)) mod
    max(U_r, 1)``, or the sentinel ``U_r + i`` for ``i >= count_r``.  In
    redraw mode (``sorted_vals`` given) sorted position ``p`` of an active
    row takes slot ``p``'s draw where it repeats its predecessor and keeps
    its value elsewhere."""
    k = fold_in(key_words(key), t)                              # [R, 2]
    idx = torch.arange(capacity, dtype=torch.int64, device=k.device)
    hi, lo = bits64_limbs(k[:, None, :], idx[None, :])          # [R, cap]
    u = universe[:, None]
    v = mod_u64(hi, lo, torch.clamp(u, min=1))
    v = torch.where(idx[None, :] < count[:, None], v, u + idx[None, :])
    if sorted_vals is None:
        return v
    dup = torch.zeros_like(sorted_vals, dtype=torch.bool)
    dup[:, 1:] = sorted_vals[:, 1:] == sorted_vals[:, :-1]
    return torch.where(dup & active[:, None], v, sorted_vals)


def chunk_decode_ref(vals: torch.Tensor, kind: torch.Tensor,
                     params: torch.Tensor, count: torch.Tensor,
                     owned: torch.Tensor):
    """(edges int64 ``[R, cap, 2]``, keep bool ``[R, cap]``) of sorted
    draws ``vals`` ``[R, cap]``, decoded per row ``kind``.

    Rows of other kinds (EMPTY padding) decode to ``(0, 0)``.  A decode's
    divisor is 1 on the rows it does not select (and on degenerate rows,
    which hold no edge), so no row can divide by zero."""
    cap = vals.shape[1]
    kind = kind[:, None].to(torch.int64)
    p0, p1, p2 = (params[:, j:j + 1] for j in range(3))
    one = torch.ones_like(p0)
    zero = torch.zeros_like(vals)
    n = torch.where((kind == KIND_DIRECTED) & (p1 > 1), p1, one + one)
    du, dv = decode_directed(vals, n, p0)
    tu, tv = decode_tri(vals, p0)
    width = torch.clamp(torch.where(kind == KIND_RECT, p0, one), min=1)
    ru, rv = decode_rect(vals, width, p1, p2)
    u = torch.where(kind == KIND_DIRECTED, du,
                    torch.where(kind == KIND_TRI, tu,
                                torch.where(kind == KIND_RECT, ru, zero)))
    v = torch.where(kind == KIND_DIRECTED, dv,
                    torch.where(kind == KIND_TRI, tv,
                                torch.where(kind == KIND_RECT, rv, zero)))
    idx = torch.arange(cap, dtype=torch.int64, device=vals.device)
    keep = ((idx[None, :] < count[:, None]) & owned[:, None]
            & (kind != KIND_EMPTY))
    return torch.stack([u, v], dim=-1), keep
