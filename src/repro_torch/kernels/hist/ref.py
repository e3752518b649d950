"""Plain PyTorch version of the hist kernel (identical bin semantics)."""
from __future__ import annotations

import torch


def log2_bin_ref(v: torch.Tensor) -> torch.Tensor:
    """bin 0 <- value 0; bin 1 + floor(log2 v) <- value v >= 1 (int64),
    by integer compares, as the reference's kernel bins."""
    b = torch.zeros_like(v)
    for k in range(63):
        b += (v >= (1 << k)).to(v.dtype)
    return b


def hist_counts_ref(values: torch.Tensor, num_bins: int, *, log2: bool = False,
                    drop: bool = False) -> torch.Tensor:
    """int64 counts[num_bins]; negatives count nowhere, bins past the
    last are clamped into it, or with ``drop`` counted nowhere."""
    v = values.reshape(-1).to(torch.int64)
    out = torch.zeros(num_bins, dtype=torch.int64, device=v.device)
    if not num_bins:
        return out
    b = log2_bin_ref(v) if log2 else v
    ok = v >= 0
    if drop:
        ok &= b < num_bins
    b = torch.where(ok, torch.clamp(b, max=num_bins - 1), 0)
    return out.scatter_add_(0, b, ok.to(torch.int64))
