"""Ambient sharding hints for the model code (port of
``repro.models.pmesh``).

Model layers call ``constrain(x, ...tokens)`` at a handful of points
(attention heads, MoE dispatch buffers, the residual stream, loss
logits).  Outside a :func:`use_hints` block (tests, one-device runs)
they return ``x`` itself; inside, they redistribute a DTensor to the
placements the tokens name on the active ``DeviceMesh`` (the reference's
``with_sharding_constraint``).  Axis tokens:

    'dp'  -> the data-parallel axes ('pod', 'data') / ('data',)
    'tp'  -> the tensor-parallel axis 'model'
    None  -> replicated

A token whose mesh size does not divide the dimension degrades to
``None`` (replication) instead of erroring: the divisibility fallback of
:mod:`repro_torch.models.shardings`.  The state is thread-local.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Tuple

import torch

from .shardings import mesh_sizes, to_placements

_state = threading.local()


class _Hints:
    def __init__(self, mesh, dp: Tuple[str, ...], tp: str):
        self.mesh, self.dp, self.tp = mesh, dp, tp
        self.sizes = mesh_sizes(mesh)

    def axis_size(self, token) -> int:
        axes = self.dp if token == "dp" else (self.tp,)
        return math.prod(self.sizes[a] for a in axes)

    def resolve(self, token, dim: int):
        if token is None:
            return None
        if dim % self.axis_size(token) != 0:
            return None
        return self.dp if token == "dp" else self.tp


@contextlib.contextmanager
def use_hints(mesh, tp: str = "model"):
    dp = tuple(a for a in ("pod", "data") if a in mesh_sizes(mesh))
    prev = getattr(_state, "hints", None)
    _state.hints = _Hints(mesh, dp, tp)
    try:
        yield
    finally:
        _state.hints = prev


def current() -> Optional[_Hints]:
    return getattr(_state, "hints", None)


def tp_size(default: int = 1) -> int:
    h = current()
    return h.axis_size("tp") if h else default


def _as_dtensor(x: torch.Tensor, mesh):
    """``x`` as a DTensor on ``mesh``; a plain tensor (one that every rank
    computed whole) is taken as replicated."""
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)


def redistribute(x: torch.Tensor, spec, mesh):
    """``x`` (a DTensor, or a plain tensor taken as replicated) moved to
    ``spec``'s placements on ``mesh``."""
    # always through ``redistribute``, even where the placements already
    # match: its backward moves the gradient to them too, as the
    # transpose of a sharding constraint constrains the cotangent
    return _as_dtensor(x, mesh).redistribute(mesh, to_placements(spec, mesh))


def local(fn, *xs, summed: Optional[int] = None):
    """``fn`` of DTensors ``xs``, run on each rank's shards
    (``local_map``), the result in the first one's placement: for work
    that is independent along every sharded dimension (attention over
    batch and heads), as GSPMD partitions it.  ``summed``: a dimension of
    the first input that ``fn`` sums away, whose shards' results are
    partial sums (the next ``constrain`` reduces them).  ``fn(*xs)``
    itself outside mesh hints."""
    h = current()
    if h is None:
        return fn(*xs)
    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor.experimental import local_map

    out = tuple(xs[0].placements)
    if summed is not None:
        out = tuple(p if not isinstance(p, Shard) or p.dim < summed
                    else Partial() if p.dim == summed else Shard(p.dim - 1) for p in out)
    return local_map(fn, out_placements=(out,),
                     in_placements=tuple(tuple(x.placements) for x in xs),
                     device_mesh=h.mesh)(*xs)


def splits(token, dim: int) -> bool:
    """Whether ``constrain`` would split a dimension of size ``dim`` by
    ``token`` over more than one rank."""
    h = current()
    return h is not None and h.resolve(token, dim) is not None and h.axis_size(token) > 1


def constrain(x: torch.Tensor, *tokens) -> torch.Tensor:
    h = current()
    if h is None:
        return x
    assert len(tokens) == x.dim(), (tokens, x.shape)
    spec = tuple(h.resolve(t, d) for t, d in zip(tokens, x.shape))
    return redistribute(x, spec, h.mesh)


class _PinGrad(torch.autograd.Function):
    """Identity forward; the backward moves the cotangent onto the
    parameter's placements at its production site, so a weight gradient
    leaves as a reduce-scatter instead of a late full all-reduce
    (ZeRO-2-style placement)."""

    @staticmethod
    def forward(ctx, x, spec, mesh):
        ctx.spec, ctx.mesh = spec, mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return redistribute(g, ctx.spec, ctx.mesh), None, None


def pin_grad(x: torch.Tensor, spec) -> torch.Tensor:
    """Identity forward; constrains the gradient to ``spec`` backward."""
    h = current()
    if h is None:
        return x
    return _PinGrad.apply(x, spec, h.mesh)
