"""Plain PyTorch version of the wedge-closing kernel (same function)."""
from __future__ import annotations

from typing import Optional

import torch


def close_wedges_ref(edges: torch.Tensor, nb: torch.Tensor, *,
                     mask: Optional[torch.Tensor] = None,
                     count: Optional[int] = None) -> torch.Tensor:
    """int64 ``[S]``: per sample row of ``nb`` (``[S, NB]``, sorted, padded
    with sentinels larger than any vertex id), how many valid slots of
    ``edges`` (``[N, 2]``) have both endpoints in the row.  The valid
    slots are ``mask`` (bool ``[N]``) or else the first ``count``.  Each
    endpoint is found by ``torch.searchsorted`` (the reference's
    ``jnp.searchsorted``), its position clamped into the row."""
    e = edges[mask] if mask is not None else edges[:count]
    S, NB = nb.shape
    hits = torch.ones((S, e.shape[0]), dtype=torch.bool, device=nb.device)
    for col in (0, 1):
        q = e[:, col].expand(S, -1).contiguous()
        pos = torch.searchsorted(nb, q).clamp(max=NB - 1)
        hits &= torch.gather(nb, 1, pos) == q
    return hits.sum(dim=1)
