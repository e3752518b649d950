"""Gradient compression for cross-pod data parallelism (port of
``repro.distrib.compress``): int8 block-quantized all-reduce with error
feedback.

Quantizing to int8 (per-block absmax scaling) cuts the data-parallel
gradient bytes 4x against float32; the residual quantization error is
carried to the next step (error feedback), which preserves convergence.
``torch.round`` rounds half to even, as ``jnp.round`` does, so the codec
equals the reference's exactly.
"""
from __future__ import annotations

from typing import Tuple

import torch

BLOCK = 256


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 ``[blocks, BLOCK]``, float32 ``[blocks, 1]`` scales) of ``x``
    flattened and zero-padded to whole blocks."""
    flat = x.to(torch.float32).reshape(-1)
    pad = (-flat.numel()) % BLOCK
    flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    flat = (q.to(torch.float32) * scale).reshape(-1)
    size = 1
    for s in shape:
        size *= s
    return flat[:size].reshape(shape)


def _leaves(tree) -> list:
    """The tensors of a dict or list (nested), depth first."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _rebuild(tree, leaves):
    """``tree``'s structure over the next tensors of the iterator ``leaves``."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return next(leaves)


def make_error_feedback_codec():
    """Returns (codec(grads, err) -> (grads', err'), zero_err(params)) over
    a dict or list (nested) of tensors."""

    def zero_err(params):
        return _rebuild(params, iter([torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                                      for p in _leaves(params)]))

    def one(g, e):
        corrected = g.to(torch.float32) + e
        q, s = _quantize(corrected)
        deq = _dequantize(q, s, g.shape)
        return deq, corrected - deq

    def codec(grads, err):
        outs = [one(g, e) for g, e in zip(_leaves(grads), _leaves(err))]
        return (_rebuild(grads, iter([o[0] for o in outs])),
                _rebuild(grads, iter([o[1] for o in outs])))

    return codec, zero_err


def compression_ratio(dtype_in=torch.float32) -> float:
    scale_overhead = 4.0 / BLOCK
    return dtype_in.itemsize / (1.0 + scale_overhead)
