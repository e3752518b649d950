"""Edge-list validation helpers on int64 ``[m, 2]`` tensors (port of
``repro.core.graph``)."""
from __future__ import annotations

from typing import Optional

import torch

from ..kernels.hist.ops import bincount_ids


def _lexsorted(e: torch.Tensor) -> torch.Tensor:
    """Rows of ``e`` in lexicographic order (two stable sorts)."""
    e = e[torch.sort(e[:, 1], stable=True).indices]
    return e[torch.sort(e[:, 0], stable=True).indices]


def canonical_undirected(edges: torch.Tensor) -> torch.Tensor:
    """(u, v) with u > v, sorted, deduped."""
    if edges.numel() == 0:
        return edges.reshape(0, 2).to(torch.int64)
    e = edges.to(torch.int64)
    s = _lexsorted(torch.stack([e.max(dim=1).values, e.min(dim=1).values], dim=1))
    new = torch.ones(len(s), dtype=torch.bool, device=s.device)
    new[1:] = (s[1:] != s[:-1]).any(dim=1)
    return s[new]


def has_self_loops(edges: torch.Tensor) -> bool:
    return bool((edges[:, 0] == edges[:, 1]).any()) if edges.numel() else False


def has_duplicates(edges: torch.Tensor) -> bool:
    if edges.numel() == 0:
        return False
    s = _lexsorted(edges)
    return bool((s[1:] == s[:-1]).all(dim=1).any())


def degrees(edges: torch.Tensor, n: int, directed: bool = False, *,
            out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int64 [n] (out-)degrees, through the hist kernel on the card;
    endpoints outside ``[0, n)`` are dropped.  Adds into ``out`` when
    given."""
    d = torch.zeros(n, dtype=torch.int64, device=edges.device) if out is None else out
    if edges.numel() == 0:
        return d
    # undirected: both endpoints of every edge, one launch over the rows
    bincount_ids(edges[:, 0] if directed else edges.reshape(-1), n, out=d)
    return d
