"""AdamW + global-norm clipping + warmup-cosine schedule (port of
``repro.train.optimizer``).

Plain functions on the port's :class:`~repro_torch.models.transformer.ParamTree`:
the optimizer state is ``{"m": {name: tensor}, "v": {name: tensor},
"step": int32 scalar}`` keyed by the parameters' names
(``layers.3.mixer.wq``), and :func:`opt_update` updates the masters, ``m``
and ``v`` in place (the reference donates its buffers to the jitted step).
Each leaf goes through the reference's elementwise operations in its order,
batched over the leaves with ``torch._foreach_*``; the scalars (the
learning rate, the bias corrections, the clip scale) stay on the device,
so a step reads nothing back to the host.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Collection, Dict, FrozenSet, Tuple

import torch

from ..models.config import ArchConfig
from ..models.transformer import detect_layout


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip: float = 1.0


def _scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a float32 scalar on ``like``'s device: dividing by it is a
    true division on the card too (CUDA divides by a host scalar through
    its reciprocal)."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def schedule(cfg: OptConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor or an int): linear warmup,
    then a cosine decay to 0 at ``total_steps``; float32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.lr * step / _scalar(max(1.0, cfg.warmup), step)
    t = (step - cfg.warmup) / _scalar(max(1.0, cfg.total_steps - cfg.warmup), step)
    cos = 0.5 * cfg.lr * (1.0 + torch.cos(math.pi * torch.clamp(t, 0.0, 1.0)))
    return torch.where(step < cfg.warmup, warm, cos)


def opt_init(params) -> Dict[str, Any]:
    """Zero moments for every parameter of ``params`` (a ``ParamTree``),
    on its device, and step 0."""
    named = list(params.named_parameters())
    # zeros_like keeps a DTensor parameter's placements (the dry run)
    zeros = lambda: {k: torch.zeros_like(p, dtype=torch.float32, requires_grad=False)
                     for k, p in named}
    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=named[0][1].device)}


def global_norm(grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum over the leaves of each leaf's sum of squares."""
    sums = [torch.sum(torch.square(g.to(torch.float32))) for g in grads.values()]
    return torch.sqrt(torch.stack(sums).sum())


def weight_decay_names(arch: ArchConfig, params) -> FrozenSet[str]:
    """The parameters that AdamW decays: those of rank 2 or more in the
    reference's stacked layout (``repro.models.transformer.model_init``).
    The layers of the body (``detect_layout``) are stacked there on a
    leading axis, so their 1-D leaves (norm scales, ``A_log``, ``D``,
    biases) are decayed; those of the prefix and the remainder are not."""
    prefix, period, reps, _ = detect_layout(arch)
    body = range(prefix, prefix + period * reps)
    out = set()
    for name, p in params.named_parameters():
        parts = name.split(".")
        stacked = parts[0] == "layers" and int(parts[1]) in body
        if p.dim() + stacked >= 2:
            out.add(name)
    return frozenset(out)


def opt_update(cfg: OptConfig, params, grads: Dict[str, torch.Tensor], state: Dict[str, Any],
               decay: Collection[str]) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step: ``(params, state, {"grad_norm", "lr"})``.  ``grads``
    is keyed like ``state["m"]``; ``decay`` names the parameters that take
    weight decay (:func:`weight_decay_names`).  ``params``, ``m`` and ``v``
    are updated in place; the returned state holds them and the new step."""
    names = list(state["m"])
    named = dict(params.named_parameters())
    ps = [named[k] for k in names]
    ms = [state["m"][k] for k in names]
    vs = [state["v"][k] for k in names]
    step = state["step"] + 1
    gn = global_norm(grads)
    scale = torch.clamp(_scalar(cfg.clip, gn) / (gn + 1e-9), max=1.0)
    lr = schedule(cfg, step)
    stepf = step.to(torch.float32)
    b1c = 1.0 - torch.pow(cfg.b1, stepf)
    b2c = 1.0 - torch.pow(cfg.b2, stepf)

    with torch.no_grad():
        gs = torch._foreach_mul([grads[k].to(torch.float32) for k in names], scale)
        torch._foreach_mul_(ms, cfg.b1)                       # m = b1 m + (1 - b1) g
        torch._foreach_add_(ms, torch._foreach_mul(gs, 1 - cfg.b1))
        g2 = torch._foreach_mul(gs, 1 - cfg.b2)                # v = b2 v + (1 - b2) g g
        torch._foreach_mul_(g2, gs)
        torch._foreach_mul_(vs, cfg.b2)
        torch._foreach_add_(vs, g2)
        del gs, g2
        den = torch._foreach_div(vs, b2c)                      # sqrt(v / b2c) + eps
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, cfg.eps)
        delta = torch._foreach_div(ms, b1c)                    # (m / b1c) / den
        torch._foreach_div_(delta, den)
        del den
        dec = [i for i, k in enumerate(names) if k in decay]   # + wd p
        if dec:
            sub = [delta[i] for i in dec]
            torch._foreach_add_(sub, torch._foreach_mul([ps[i] for i in dec], cfg.weight_decay))
        torch._foreach_mul_(delta, lr)                         # p - lr delta
        torch._foreach_sub_(ps, delta)
    return params, {"m": state["m"], "v": state["v"], "step": step}, {"grad_norm": gn, "lr": lr}
