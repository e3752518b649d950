"""Serving: prefill + batched greedy decode over KV/SSM caches (port of
``repro.train.serve``).  Runs on the device of the parameters, under
``torch.no_grad``."""
from __future__ import annotations

import numpy as np
import torch

from ..models import transformer as T
from ..models.config import ArchConfig


def _device(params) -> torch.device:
    return params["embed"]["tok"].device


@torch.no_grad()
def prefill(params, cfg: ArchConfig, tokens, s_max: int, embeds=None):
    """Run the prompt ``tokens`` [B, S] through the model, filling caches
    sized ``s_max``.  Returns (caches, last_token_logits [B, V])."""
    dev = _device(params)
    tokens = torch.as_tensor(tokens, device=dev)
    B, S = tokens.shape
    dtype = cfg.compute_dtype
    caches = T.caches_init(cfg, B, s_max, dtype, dev)
    pos = torch.arange(S, dtype=torch.int32, device=dev).repeat(B, 1)
    batch = {"tokens": tokens, "positions": pos}
    if cfg.frontend != "none":
        batch = {"embeds": embeds if embeds is not None
                 else params["embed"]["tok"][tokens.long()].to(dtype),
                 "positions": pos}
    h, _, caches = T.forward(params, cfg, batch, caches=caches)
    logits = h[:, -1] @ params["embed"]["head"].to(h.dtype)
    return caches, logits


@torch.no_grad()
def generate(params, cfg: ArchConfig, prompts: np.ndarray, steps: int) -> np.ndarray:
    """Greedy generation for a batch of prompts [B, S]; returns int32
    [B, steps]: the argmax of the prefill's logits, then of each decode
    step's (ties to the lowest token id)."""
    dev = _device(params)
    B, S = prompts.shape
    caches, logits = prefill(params, cfg, torch.as_tensor(np.asarray(prompts), device=dev),
                             S + steps)
    out = []
    tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    for t in range(steps):
        out.append(tok.cpu().numpy())
        pos = torch.full((B, 1), S + t, dtype=torch.int32, device=dev)
        logits, caches = T.decode_step(params, cfg, tok, pos, caches)
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    return np.concatenate(out, axis=1)
