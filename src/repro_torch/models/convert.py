"""Weights carried across from the reference (port-only).

The reference's ``model_init`` returns ``{"embed", "final_norm",
"prefix": [block], "body": [stacked block], "remainder": [block]}``
(``repro.models.transformer.detect_layout``): ``body[j]`` holds, leaf by
leaf, the ``reps`` layers ``prefix + r * period + j`` stacked on a
leading axis, and ``remainder[j]`` is layer ``prefix + reps * period +
j``.  :func:`from_reference` unstacks that tree, given as numpy arrays,
into the port's one-entry-a-layer :class:`~.transformer.ParamTree`, so
both packages can run on the same weights; :func:`opt_state_from_reference`
does the same for the optimizer's moments, so both can train on from the
same state.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from ..kernels.build import resolve_device
from .config import ArchConfig
from .transformer import ParamTree, detect_layout


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def unstack_layers(ref: Dict[str, Any], cfg: ArchConfig) -> List[Dict[str, Any]]:
    """The reference's prefix/body/remainder blocks as a list of
    ``cfg.n_layers`` per-layer trees, in layer order."""
    prefix, period, reps, rem = detect_layout(cfg)
    layers: List[Any] = [None] * cfg.n_layers
    for i in range(prefix):
        layers[i] = ref["prefix"][i]
    for j in range(period):
        for r in range(reps):
            layers[prefix + r * period + j] = _map(ref["body"][j], lambda a, r=r: a[r])
    for j in range(rem):
        layers[prefix + reps * period + j] = ref["remainder"][j]
    return layers


def from_reference(ref: Dict[str, Any], cfg: ArchConfig, device=None) -> ParamTree:
    """The port's parameters holding the reference's values (numpy arrays
    in the reference's ``model_init`` layout), on ``device`` (CUDA unless
    the caller asks for the CPU)."""
    device = resolve_device(device)
    tree = {"embed": ref["embed"], "final_norm": ref["final_norm"],
            "layers": unstack_layers(ref, cfg)}
    return ParamTree(_map(tree, lambda a: torch.from_numpy(np.array(a)).to(device)))


def opt_state_from_reference(ref_state: Dict[str, Any], cfg: ArchConfig, device=None) -> dict:
    """The port's optimizer state (``repro_torch.train.optimizer``) holding
    the reference's ``{"m", "v", "step"}`` (numpy arrays, ``m`` and ``v``
    in the reference's parameter layout): the moments unstacked and keyed
    by the port's parameter names, the step as an int32 scalar, on
    ``device`` (CUDA unless the caller asks for the CPU)."""
    device = resolve_device(device)

    def moments(tree):
        return {k: p.detach() for k, p in from_reference(tree, cfg, device).named_parameters()}

    return {"m": moments(ref_state["m"]), "v": moments(ref_state["v"]),
            "step": torch.tensor(int(np.asarray(ref_state["step"])), dtype=torch.int32,
                                 device=device)}
