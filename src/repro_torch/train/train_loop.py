"""Train step factory (port of ``repro.train.train_loop``): loss -> grad
-> (optional int8-compressed gradients) -> AdamW, with optional microbatch
gradient accumulation so large global batches fit activation memory.

Gradients come from ``torch.autograd`` over :func:`~repro_torch.models.transformer.lm_loss`
(whose superblocks and loss chunks are recomputed in backward, as the
reference's ``jax.checkpoint``); a parameter the loss does not reach gets
a zero gradient, as ``jax.grad`` gives.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..models import transformer as T
from ..models.config import ArchConfig
from . import optimizer as O


def make_train_step(
    cfg: ArchConfig,
    opt_cfg: O.OptConfig,
    *,
    accum: int = 1,
    compress: Optional[Callable] = None,   # (grads) -> grads, e.g. distrib.compress's codec
    loss_chunk: int = 512,
):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt,
    metrics)``; ``batch`` holds numpy arrays or tensors, moved to the
    parameters' device.  The masters and the optimizer state are updated
    in place (:func:`~repro_torch.train.optimizer.opt_update`).

    With accum > 1, the batch's leading dim is split into ``accum``
    microbatches whose float32 gradients are summed, then divided by
    ``accum`` with the loss, as the reference's scan does; the metrics are
    then ``loss``, ``grad_norm`` and ``lr`` alone."""

    def grads_of(params, names, leaves, batch):
        loss, metrics = T.lm_loss(params, cfg, batch, loss_chunk=loss_chunk)
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = {k: (g if g is not None else torch.zeros_like(p))
                 for k, p, g in zip(names, leaves, gs)}
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def train_step(params, opt_state, batch):
        names, leaves = zip(*params.named_parameters())
        dev = leaves[0].device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        if accum == 1:
            loss, metrics, grads = grads_of(params, names, leaves, batch)
        else:
            acc = [torch.zeros_like(p, dtype=torch.float32, requires_grad=False) for p in leaves]
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            for mb in range(accum):
                micro = {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])[mb]
                         for k, v in batch.items()}
                l, _, g = grads_of(params, names, leaves, micro)
                torch._foreach_add_(acc, [g[k] for k in names])
                loss = loss + l
            n = torch.tensor(float(accum), dtype=torch.float32, device=dev)
            grads: Dict[str, torch.Tensor] = dict(zip(names, torch._foreach_div(acc, n)))
            loss = loss / n
            metrics = {}
        if compress is not None:
            grads = compress(grads)
        decay = O.weight_decay_names(cfg, params)
        params, opt_state, om = O.opt_update(opt_cfg, params, grads, opt_state, decay)
        metrics = dict(metrics, loss=loss, **om)
        return params, opt_state, metrics

    return train_step
