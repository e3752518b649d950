"""Plain PyTorch versions of the wedge-closing kernel (same function):
:func:`close_wedges_ref` over the neighbour table (the reference's
definition), :func:`close_wedges_table_ref` over its
:class:`~.table.WedgeTable`, as the kernel computes it."""
from __future__ import annotations

from typing import Optional

import torch

from .table import WedgeTable, probe


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


def close_wedges_table_ref(edges: torch.Tensor, table: WedgeTable, *,
                           mask: Optional[torch.Tensor] = None,
                           count: Optional[int] = None) -> torch.Tensor:
    """:func:`close_wedges_ref` of the neighbour table that ``table`` was
    built from, for endpoints that are vertex ids (below the sentinel),
    edge-major: each valid slot probes ``u``, then ``v``, in the union of
    the rows; the samples listed under both count it once each."""
    e = edges[mask] if mask is not None else edges[:count]
    S, dev = table.samples, edges.device
    su = probe(table, e[:, 0].contiguous())
    e, su = e[su >= 0], su[su >= 0]
    sv = probe(table, e[:, 1].contiguous())
    su, sv = su[sv >= 0], sv[sv >= 0]
    # u's samples, one entry each, looked up among v's: every (slot,
    # sample) code of the table is ascending (slots, then each list)
    lo = table.off[su]
    size = table.off[su + 1] - lo
    which = torch.repeat_interleave(torch.arange(len(su), device=dev), size)
    first = torch.cumsum(size, 0) - size
    s = table.ids[lo[which] + torch.arange(len(which), device=dev) - first[which]].to(torch.int64)
    slots = torch.arange(table.hkey.numel(), device=dev)
    codes = torch.repeat_interleave(slots, table.off.diff()) * S + table.ids
    want = sv[which] * S + s
    at = torch.searchsorted(codes, want).clamp(max=max(0, len(codes) - 1))
    return torch.bincount(s[codes[at] == want], minlength=S)
