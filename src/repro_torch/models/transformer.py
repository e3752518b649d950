"""Model assembly (port of ``repro.models.transformer``).

Heterogeneous layer stacks (gemma3's 5 local : 1 global, jamba's 7 ssm :
1 attn with MoE every 2nd layer, deepseek's dense first layer) follow
per-layer signatures.  The reference compiles them as an unrolled prefix,
a scanned superblock of ``period`` layers and an unrolled remainder
(:func:`detect_layout`); the port runs a plain loop over the layers, and
its parameters are one entry per layer (``layers[i]``).  Under autograd
without caches, each superblock (the reference's scan body) and each loss
chunk is checkpointed (``torch.utils.checkpoint``), as the reference's
``jax.checkpoint``: their activations are recomputed in backward.
:mod:`repro_torch.models.convert` maps the reference's stacked layout
onto it.

:func:`model_init` returns a :class:`ParamTree`, an ``nn.Module`` whose
parameters are the float32 masters (``parameters()``, ``state_dict()``
and ``.to()`` as for any module); the functions here read it as a dict.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import layers as L
from . import pmesh
from ..kernels.build import resolve_device
from .config import ArchConfig, torch_dtype

Params = Dict[str, Any]


class ParamTree(nn.Module):
    """Nested dicts and lists of tensors as a module: a dict entry is a
    parameter or a child tree, a list a ``ModuleList`` of trees.  Indexed
    like the dict it was built from (``p["mixer"]["wq"]``)."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            elif isinstance(v, (list, tuple)):
                self.add_module(k, nn.ModuleList([ParamTree(x) for x in v]))
            else:
                self.register_parameter(k, nn.Parameter(v, requires_grad=v.is_floating_point()))

    def __getitem__(self, k: str):
        return getattr(self, k)

    def __contains__(self, k: str) -> bool:
        return k in self._parameters or k in self._modules

    def keys(self):
        return list(self._parameters) + list(self._modules)

    def items(self):
        return [(k, self[k]) for k in self.keys()]


# ------------------------------------------------------------- patterns

def layer_signature(cfg: ArchConfig, i: int) -> tuple:
    kind = cfg.layer_kind(i)
    return (
        kind,
        cfg.layer_attn_kind(i) if kind == "attn" else "",
        cfg.layer_is_moe(i),
    )


def detect_layout(cfg: ArchConfig) -> Tuple[int, int, int, int]:
    """(prefix, period, reps, remainder) covering n_layers: the
    reference's stacked parameter layout."""
    sigs = [layer_signature(cfg, i) for i in range(cfg.n_layers)]
    best = None
    for prefix in range(0, min(5, cfg.n_layers)):
        for period in range(1, min(9, cfg.n_layers - prefix + 1)):
            reps = (cfg.n_layers - prefix) // period
            if reps < 2:
                continue
            rem = cfg.n_layers - prefix - reps * period
            body = sigs[prefix: prefix + period]
            ok = all(
                sigs[prefix + j] == body[j % period]
                for j in range(reps * period + rem)
            )
            if ok:
                cand = (prefix, period, reps, rem)
                if best is None or (cand[0], cand[1]) < (best[0], best[1]):
                    best = cand
        if best and best[0] == prefix:
            break
    if best is None:
        return 0, cfg.n_layers, 1, 0  # fully unrolled fallback
    return best


# ------------------------------------------------------------- blocks

def block_init(cfg: ArchConfig, i: int, generator=None, device=None) -> Params:
    sig = layer_signature(cfg, i)
    p: Params = {"norm1": L.rmsnorm_init(cfg, cfg.d_model, device),
                 "norm2": L.rmsnorm_init(cfg, cfg.d_model, device)}
    if sig[0] == "attn":
        p["mixer"] = (L.mla_init(cfg, generator, device) if cfg.mla
                      else L.attention_init(cfg, generator, device))
    else:
        p["mixer"] = L.mamba2_init(cfg, generator, device)
    if sig[2]:
        p["ffn"] = L.moe_init(cfg, generator, device)
    elif cfg.d_ff:
        p["ffn"] = L.mlp_init(cfg, cfg.d_ff, generator, device)
    return p


def block_apply(p: Params, cfg: ArchConfig, i: int, x, pos,
                cache: Optional[dict] = None):
    """Returns (x, aux_loss, new_cache)."""
    sig = layer_signature(cfg, i)
    p = cast_params(p, cfg.dtype)
    # under mesh hints the sequence-sharded residual is gathered for the
    # tensor-parallel products (Megatron-SP's all-gather, which GSPMD
    # inserts for the reference)
    h = pmesh.constrain(L.rmsnorm(p["norm1"], x), "dp", None, None)
    if sig[0] == "attn":
        if cfg.mla:
            mix, new_cache = L.mla_attention(p["mixer"], cfg, h, pos, cache=cache)
        else:
            mix, new_cache = L.attention(p["mixer"], cfg, h, pos, sig[1], cache=cache)
    else:
        mix, new_cache = L.mamba2(p["mixer"], cfg, h, cache=cache)
    # each branch meets the residual sequence-sharded (a reduce-scatter of
    # the tensor-parallel partial sums); its gradient returns so too
    x = x + pmesh.constrain(mix, "dp", "tp", None)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if "ffn" in p:
        h2 = pmesh.constrain(L.rmsnorm(p["norm2"], x), "dp", None, None)
        if sig[2]:
            f, aux = L.moe(p["ffn"], cfg, h2)
        else:
            f = L.mlp(p["ffn"], h2)
        x = x + pmesh.constrain(f, "dp", "tp", None)
    x = pmesh.constrain(x, "dp", "tp", None)
    return x, aux, new_cache


def block_cache_init(cfg: ArchConfig, i: int, batch: int, s_max: int, dtype,
                     device=None) -> dict:
    sig = layer_signature(cfg, i)
    dtype = torch_dtype(dtype)
    device = _resolve(device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    if sig[0] == "attn":
        if cfg.mla:
            return {"c": zeros(batch, s_max, cfg.kv_lora_rank),
                    "kr": zeros(batch, s_max, cfg.qk_rope_dim), "idx": 0}
        # sliding-window layers only ever attend to the last `window`
        # tokens: a ring buffer of that size replaces the full cache
        s_cache = min(s_max, cfg.window) if sig[1] == "swa" else s_max
        return {"k": zeros(batch, s_cache, cfg.n_kv_heads, cfg.hd),
                "v": zeros(batch, s_cache, cfg.n_kv_heads, cfg.hd), "idx": 0}
    di, N, H = cfg.d_inner, cfg.d_state, cfg.n_ssm_heads
    return {"conv": zeros(batch, cfg.d_conv - 1, di + 2 * N),
            "h": zeros(batch, H, di // H, N), "idx": 0}


# ------------------------------------------------------------- model

def _resolve(device) -> torch.device:
    """CUDA unless the caller asks for the CPU (``resolve_device``), or
    ``"meta"`` for shapes alone."""
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device)


def model_init(cfg: ArchConfig, *, generator: Optional[torch.Generator] = None,
               device=None) -> ParamTree:
    """The model's float32 masters, drawn from ``generator`` on ``device``
    with the reference's shapes, distributions and scales (``device="meta"``
    gives the shapes only; CUDA unless the caller asks for the CPU).
    Without a generator, one seeded with 0."""
    device = _resolve(device)
    if generator is None and device.type != "meta":
        generator = torch.Generator(device=device).manual_seed(0)
    tree = {"embed": L.embed_init(cfg, generator, device),
            "final_norm": L.rmsnorm_init(cfg, cfg.d_model, device),
            "layers": [block_init(cfg, i, generator, device) for i in range(cfg.n_layers)]}
    return ParamTree(tree)


def cast_params(p, dtype) -> Params:
    """Mixed precision: every float32 tensor with two or more dimensions
    (the MoE router included) cast to the compute dtype; 1-D tensors
    (norm scales, ``A_log``, ``dt_bias``, ``D``) stay float32.  Returns
    plain dicts; autograd flows through the casts to the masters.  Under
    mesh hints each cast weight is also grad-pinned after its cast: its
    gradient is moved to the parameter's placements where it is made, a
    reduce-scatter of bf16 bytes instead of a late all-reduce."""
    dt = torch_dtype(dtype)
    hints = pmesh.current()

    def leaf(name, x):
        if x.dtype == torch.float32 and x.dim() >= 2:
            x = x.to(dt)
            if hints is not None:
                from .shardings import leaf_spec
                x = pmesh.pin_grad(x, leaf_spec(name, tuple(x.shape), hints.mesh))
        return x

    def walk(name, t):
        if isinstance(t, (dict, ParamTree)):
            return {k: walk(k, v) for k, v in t.items()}
        if isinstance(t, (list, tuple, nn.ModuleList)):
            return [walk(name, v) for v in t]
        return leaf(name, t)

    return walk(None, p)


def _embed_tokens(p: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor]):
    dt = cfg.compute_dtype
    if cfg.frontend != "none":
        return batch["embeds"].to(dt)
    # the B x S rows first, then the cast: the same values as casting
    # the whole table, without its traffic
    if pmesh.current() is not None:
        # under mesh hints, as the reference: the table cast, gathered
        # whole on every rank, and looked up for the rank's tokens (its
        # gradient leaves reduce-scattered onto the table's shards)
        tok = pmesh.constrain(p["embed"]["tok"].to(dt), None, None)
        return torch.nn.functional.embedding(batch["tokens"].long(), tok)
    return p["embed"]["tok"][batch["tokens"].long()].to(dt)


def _layers(p: Params, cfg: ArchConfig, lo: int, hi: int, x, pos, aux):
    """Layers ``lo .. hi - 1`` without caches; returns (x, aux)."""
    for i in range(lo, hi):
        x, a, _ = block_apply(p["layers"][i], cfg, i, x, pos)
        aux = aux + a
    return x, aux


def _remat(fn, *args):
    """``fn(*args)`` with its activations recomputed in backward (the
    forward draws no random numbers, so no generator state is kept)."""
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)


def forward(p: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
            caches: Optional[List[dict]] = None):
    """Hidden states [B, S, D]; returns (h, total_aux, new_caches).
    ``caches`` is one cache dict per layer (:func:`caches_init`).  Under
    autograd without caches, each of the ``reps`` superblocks of
    :func:`detect_layout` (layers ``prefix + r * period + j``) is
    checkpointed when ``reps >= 2``; the prefix and the remainder are not."""
    x = _embed_tokens(p, cfg, batch)
    # the residual stream is sequence-sharded between blocks under mesh
    # hints (Megatron-SP)
    x = pmesh.constrain(x, "dp", "tp", None)
    pos = batch["positions"]
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    new_caches: List[dict] = []
    prefix, period, reps, _ = detect_layout(cfg)
    remat = caches is None and reps >= 2 and torch.is_grad_enabled()
    i = 0
    while i < cfg.n_layers:
        if remat and prefix <= i < prefix + reps * period:
            x, aux_total = _remat(_layers, p, cfg, i, i + period, x, pos, aux_total)
            i += period
            continue
        c = caches[i] if caches is not None else None
        x, aux, nc = block_apply(p["layers"][i], cfg, i, x, pos, c)
        aux_total = aux_total + aux
        new_caches.append(nc)
        i += 1
    x = L.rmsnorm(p["final_norm"], x)
    return x, aux_total, (new_caches if caches is not None else None)


def caches_init(cfg: ArchConfig, batch: int, s_max: int, dtype, device=None) -> List[dict]:
    """One zeroed cache a layer for ``batch`` sequences of up to ``s_max``
    positions (sliding-window layers: a ring of ``window``)."""
    return [block_cache_init(cfg, i, batch, s_max, dtype, device) for i in range(cfg.n_layers)]


# ------------------------------------------------------------- loss

def _sum_exp(logits, m):
    return torch.sum(torch.exp(logits - m), dim=-1)


def _masked_target(logits, labels, iota):
    """Each row's logit at its label among the vocabulary ``iota``
    indexes (0 where the label is elsewhere)."""
    return torch.sum(torch.where(iota == labels[..., None], logits, 0.0), dim=-1)


def _gathered_target(logits, labels):
    return torch.gather(logits, -1, labels[..., None])[..., 0]


def _chunk_ce(h, head, labels):
    """Summed cross-entropy of one chunk: h [B, ck, D], labels [B, ck]."""
    logits = (h @ head).to(torch.float32)                            # [B, ck, V]
    logits = pmesh.constrain(logits, "dp", None, "tp")               # vocab-sharded
    if pmesh.splits("tp", logits.shape[-1]):
        # vocab-parallel: the log-sum-exp from each rank's max and sum of
        # exponentials over its vocabulary slice, the target's logit as a
        # masked sum over it, the sums on each rank's shards; each reduced
        # across the ranks to every rank (and its gradient given to every
        # rank so, to split locally), so no rank holds the whole vocabulary
        m = pmesh.constrain(torch.amax(logits, dim=-1, keepdim=True).detach(), "dp", None, None)
        s = pmesh.constrain(pmesh.local(_sum_exp, logits, m, summed=2), "dp", None)
        lse = m[..., 0] + torch.log(s)
        iota = pmesh.constrain(torch.arange(logits.shape[-1], device=logits.device), "tp")
        tgt = pmesh.constrain(pmesh.local(_masked_target, logits,
                                          pmesh.constrain(labels, "dp", None), iota,
                                          summed=2), "dp", None)
    else:
        # the gather on each rank's shards: DTensor's own gradient of it
        # is a zero tensor of the whole batch on a mesh with a pod axis
        lse = torch.logsumexp(logits, dim=-1)
        tgt = pmesh.local(_gathered_target, logits, pmesh.constrain(labels, "dp", None))
    # the tokens' losses split over the batch, and so their gradient: the
    # sum's backward would give it to every rank whole
    return torch.sum(pmesh.constrain(lse - tgt, "dp", None))


def lm_loss(p: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
            loss_chunk: int = 512) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Chunked cross-entropy: logits are materialized ``loss_chunk``
    tokens at a time so the [tokens, vocab] tensor never exists in full;
    under autograd each chunk's logits are recomputed in backward."""
    h, aux, _ = forward(p, cfg, batch)
    B, S, D = h.shape
    labels = batch["labels"].long()
    head = p["embed"]["head"].to(h.dtype)
    if pmesh.current() is not None:
        from .shardings import leaf_spec
        head = pmesh.pin_grad(head, leaf_spec("head", tuple(head.shape), pmesh.current().mesh))
        # the head gathered over the data axes and split over the
        # vocabulary (FSDP's weight gather), the sequence gathered (as
        # before a block's products): each rank's logits are its own
        # tokens' over its vocabulary slice, never the whole batch's
        head = pmesh.constrain(head, None, "tp")
        h = pmesh.constrain(h, "dp", None, None)
    ce = _chunk_ce
    if torch.is_grad_enabled():
        ce = lambda *args: _remat(_chunk_ce, *args)

    ck = min(loss_chunk, S)
    while S % ck:
        ck -= 1
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for s in range(0, S, ck):
        total = total + ce(h[:, s:s + ck], head, labels[:, s:s + ck])
    loss = total / (B * S)
    metrics = {"ce": loss, "aux": aux}
    return loss + 0.01 * aux, metrics


def decode_step(p: Params, cfg: ArchConfig, tokens, positions, caches):
    """One-token decode: tokens [B,1] -> (logits [B,1,V], new caches)."""
    batch = {"tokens": tokens, "positions": positions}
    if cfg.frontend != "none":
        batch = {"embeds": p["embed"]["tok"][tokens.long()].to(cfg.compute_dtype),
                 "positions": positions}
    h, _, new_caches = forward(p, cfg, batch, caches=caches)
    logits = h @ p["embed"]["head"].to(h.dtype)
    return logits, new_caches


def param_shapes(cfg: ArchConfig) -> ParamTree:
    """The parameters as meta tensors: shapes and dtypes, no allocation."""
    return model_init(cfg, device="meta")
