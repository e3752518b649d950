"""Sharding rules (port of ``repro.models.shardings``): FSDP (+ZeRO) over
``data``, tensor parallel over ``model``, pure data parallel over ``pod``
(parameters replicated across pods; the gradient all-reduce rides the
slower inter-pod fabric).

Attention/FFN projections are stored flat ``[d_in, H*hd]`` so the TP axis
always divides (smollm's 15 heads x 64 = 960).  Any dimension that does
not divide its mesh axis falls back to replication (:func:`_maybe`).

KV caches shard (batch -> dp, seq -> ``model``); SSM states (batch -> dp,
heads -> ``model``).

A spec is a plain tuple with one entry a tensor dimension: ``None``
(replicated), an axis name, or a tuple of axis names (the counterpart of
a ``PartitionSpec``); :func:`to_placements` turns it into DTensor
placements.  The port's parameters are one tree a layer (``layers[i]``),
so a leaf of the reference's stacked body, ``P(None, *fixed)``, is the
port's ``fixed`` (:func:`repro_torch.models.convert.unstack_layers` maps
the two layouts).  Everything here is a function of shapes and mesh
sizes: a mesh is anything with ``axis_names`` and ``shape`` (a
``DeviceMesh`` has ``mesh_dim_names`` and ``mesh.shape``; both are read).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

from torch import nn

from .config import ArchConfig

FSDP = "data"
TP = "model"

Spec = Tuple[Any, ...]


def mesh_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or of any object with
    ``axis_names`` and ``shape`` (or ``devices.shape``)."""
    names = getattr(mesh, "mesh_dim_names", None) or mesh.axis_names
    shape = getattr(mesh, "devices", None)
    shape = shape.shape if shape is not None else tuple(mesh.shape)
    return dict(zip(names, shape))


def dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh_sizes(mesh))


def _entry(axes: Tuple[str, ...]):
    """A spec entry for ``axes``: one axis by its name (``PartitionSpec``
    writes ``("data",)`` as ``"data"``), several as their tuple."""
    return axes[0] if len(axes) == 1 else axes


def _axis_size(axis, sizes: Dict[str, int]) -> int:
    if isinstance(axis, tuple):
        return math.prod(sizes[a] for a in axis)
    return sizes[axis]


def _maybe(axis, dim_size: int, mesh):
    """``axis`` if its mesh size divides ``dim_size``, else ``None``."""
    if axis is None:
        return None
    return axis if dim_size % _axis_size(axis, mesh_sizes(mesh)) == 0 else None


def leaf_spec(name: str, shape, mesh) -> Spec:
    """The spec of one parameter named ``name`` (its key in its tree)."""
    nd = len(shape)
    tp_sz = mesh_sizes(mesh)[TP]

    def spec(*axes):
        return tuple(_maybe(a, d, mesh) for a, d in zip(axes, shape))

    if nd <= 1:
        return (None,) * nd if nd else ()
    if name == "tok":
        return spec(TP, FSDP)
    if name == "head":
        return spec(FSDP, TP)
    if name in ("wq", "wk", "wv", "w_dkv", "w_uk", "w_uv", "in_proj"):
        return spec(FSDP, TP)
    if name in ("wo", "out_proj"):
        return spec(TP, FSDP)
    if name == "router":
        return spec(FSDP, None)
    if name == "conv_w":
        return spec(None, TP)
    if name in ("w_gate", "w_up"):
        if nd == 3:  # MoE experts [E, d, F]
            if shape[0] % tp_sz == 0:
                return spec(TP, FSDP, None)        # expert parallel
            return spec(None, FSDP, TP)            # TP inside each expert
        return spec(FSDP, TP)
    if name == "w_down":
        if nd == 3:
            if shape[0] % tp_sz == 0:
                return spec(TP, None, FSDP)
            return spec(None, TP, FSDP)
        return spec(TP, FSDP)
    return spec(*([None] * nd))


def param_specs(params, mesh, cfg: ArchConfig = None) -> Any:
    """The spec tree of ``params`` (a ``ParamTree`` or nested dicts and
    lists of tensors): each leaf's spec by its key and shape."""
    def walk(name, tree):
        if hasattr(tree, "items") and not hasattr(tree, "shape"):
            return {k: walk(k, v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple, nn.ModuleList)):
            return [walk(name, v) for v in tree]
        return leaf_spec(name, tuple(tree.shape), mesh)

    return {k: walk(k, v) for k, v in params.items()}


def batch_specs(cfg: ArchConfig, mesh, batch_shapes: Dict) -> Dict[str, Spec]:
    dp = dp_axes(mesh)
    dp_sz = _axis_size(dp, mesh_sizes(mesh))
    out = {}
    for k, v in batch_shapes.items():
        b = _entry(dp) if v.shape[0] % dp_sz == 0 else None
        out[k] = (b,) + (None,) * (len(v.shape) - 1)
    return out


def _cache_leaf(name: str, shape, dp, dp_sz: int, tp_sz: int) -> Spec:
    if name == "idx" or len(shape) == 0:
        return (None,) * len(shape)
    bspec = _entry(dp) if shape[0] % dp_sz == 0 else None
    if name in ("k", "v"):        # [B, S, KV, hd]
        return (bspec, TP if shape[1] % tp_sz == 0 else None, None, None)
    if name in ("c", "kr"):       # MLA [B, S, r]
        return (bspec, TP if shape[1] % tp_sz == 0 else None, None)
    if name == "h":               # SSM [B, H, P, N]
        return (bspec, TP if shape[1] % tp_sz == 0 else None, None, None)
    if name == "conv":            # [B, K-1, ch]
        return (bspec, None, TP if shape[2] % tp_sz == 0 else None)
    return (bspec,) + (None,) * (len(shape) - 1)


def cache_specs(cfg: ArchConfig, mesh, caches) -> Any:
    """(batch -> dp, seq -> ``model``) for KV caches; SSM states (batch ->
    dp, heads -> ``model``).  ``caches`` is one dict a layer
    (``transformer.caches_init``); ``idx``, a Python int, has spec ``()``."""
    sizes = mesh_sizes(mesh)
    dp = dp_axes(mesh)
    dp_sz, tp_sz = _axis_size(dp, sizes), sizes[TP]
    return [{k: _cache_leaf(k, tuple(getattr(v, "shape", ())), dp, dp_sz, tp_sz)
             for k, v in layer.items()} for layer in caches]


def to_placements(spec: Spec, mesh) -> list:
    """DTensor placements of ``spec`` on a ``DeviceMesh``: ``Shard(d)``
    on every mesh axis of more than one rank named by tensor dimension
    ``d``, ``Replicate()`` on the others (a shard of one rank is the
    whole tensor)."""
    from torch.distributed.tensor import Replicate, Shard

    sizes = mesh_sizes(mesh)
    names = list(sizes)
    out = [Replicate() for _ in names]
    for d, axis in enumerate(spec):
        if axis is None:
            continue
        for a in (axis if isinstance(axis, tuple) else (axis,)):
            if sizes[a] > 1:
                out[names.index(a)] = Shard(d)
    return out
