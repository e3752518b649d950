"""The LM's layers (port of ``repro.models.layers``): GQA/SWA attention,
MLA, MoE, Mamba2-SSD, RMSNorm, RoPE/M-RoPE.

Every layer is an (init, apply) pair over a dict of tensors (a plain
dict or a :class:`repro_torch.models.transformer.ParamTree`): masters
live in ``param_dtype`` (float32) and compute runs in ``dtype``
(bfloat16 at full width), cast by ``transformer.cast_params``.  Each
function computes what the reference's does, in the same dtypes and the
same order of operations: attention is einsum, mask and a float32
softmax (no library attention kernel), the MoE dispatch is a scatter of
rows into expert buffers.

Caches are dicts of tensors with ``idx`` a Python int (the number of
positions written); a cache write fills the cache tensor in place and
the new cache dict holds the same tensors.  Under a device mesh
(:func:`repro_torch.models.pmesh.use_hints`) the reference's sharding
hints redistribute DTensors at its sites, a cache write returns a new
tensor (a masked single-token write, local on every shard of a
sequence-sharded cache), and the MoE dispatch runs in one group a
data-parallel rank; outside one, the hints return their input and the
code computes what it did without them.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import pmesh
from .config import ArchConfig

Params = Dict[str, torch.Tensor]


def _init(generator: Optional[torch.Generator], shape, scale: float, dtype,
          device) -> torch.Tensor:
    """A float32 standard normal of ``shape`` times ``scale``, cast to
    ``dtype`` (the reference's ``_init``).  On the meta device: the
    shape and dtype only."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    x = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
    return (x * scale).to(dtype)


def _ones(shape, dtype, device) -> torch.Tensor:
    return torch.ones(shape, dtype=dtype, device=device)


def _einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``jnp.einsum``'s dtype rule: the operands promoted to one dtype."""
    dt = ops[0].dtype
    for o in ops[1:]:
        dt = torch.promote_types(dt, o.dtype)
    return torch.einsum(eq, *(o.to(dt) for o in ops))


# ---------------------------------------------------------------- rmsnorm

def rmsnorm_init(cfg: ArchConfig, dim: int, device=None) -> Params:
    return {"scale": _ones((dim,), cfg.master_dtype, device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * p["scale"].to(torch.float32)
    return out.to(dt)


# ---------------------------------------------------------------- rope

def rope_freqs(hd: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, hd, 2, dtype=np.float64) / hd))


@functools.lru_cache(maxsize=64)
def _rope_freqs_on(hd: int, theta: float, device: torch.device) -> torch.Tensor:
    """:func:`rope_freqs` as float32 on ``device``, copied there once (a
    copy from host memory on every call would wait for the card)."""
    return torch.tensor(rope_freqs(hd, theta), dtype=torch.float32, device=device)


def apply_rope(x: torch.Tensor, pos: torch.Tensor, theta: float,
               mrope_sections: Optional[Tuple[int, ...]] = None) -> torch.Tensor:
    """x: [..., S, H, hd]; pos: [..., S] (or [3, ..., S] for M-RoPE).

    M-RoPE (qwen2-vl): the hd/2 frequency slots are split into (t, h, w)
    sections, each rotated by its own position stream.  With text-only
    positions all three streams coincide."""
    hd = x.shape[-1]
    freqs = _rope_freqs_on(hd, float(theta), x.device)
    if mrope_sections is None:
        ang = pos[..., :, None].to(torch.float32) * freqs        # [..., S, hd/2]
    else:
        parts = []
        start = 0
        for s_idx, sec in enumerate(mrope_sections):
            f = freqs[start: start + sec]
            p = pos[s_idx] if pos.dim() > x.dim() - 2 else pos
            parts.append(p[..., :, None].to(torch.float32) * f)
            start += sec
        ang = torch.cat(parts, dim=-1)
    cos = torch.cos(ang)[..., :, None, :]                          # [..., S, 1, hd/2]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- masks

def attn_mask(q_len: int, kv_len: int, *, causal: bool, window: int,
              q_offset, device=None) -> torch.Tensor:
    """bool [q_len, kv_len]; True = attend.  q_offset aligns decode steps."""
    qi = torch.arange(q_len, device=device)[:, None] + q_offset
    kj = torch.arange(kv_len, device=device)[None, :]
    m = torch.ones((q_len, kv_len), dtype=torch.bool, device=device)
    if causal:
        m &= kj <= qi
    if window and window > 0:
        m &= kj > qi - window
    return m


# ---------------------------------------------------------------- GQA attn

def attention_init(cfg: ArchConfig, generator=None, device=None) -> Params:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    sc, dt = 0.02, cfg.master_dtype
    p = {
        "wq": _init(generator, (d, H * hd), sc, dt, device),
        "wk": _init(generator, (d, KV * hd), sc, dt, device),
        "wv": _init(generator, (d, KV * hd), sc, dt, device),
        "wo": _init(generator, (H * hd, d), sc / math.sqrt(2 * cfg.n_layers), dt, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = _ones((hd,), dt, device)
        p["k_norm"] = _ones((hd,), dt, device)
    return p


def _qk_normalize(x, scale):
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + 1e-6) * scale.to(torch.float32)).to(x.dtype)


_Q_CHUNK = 1024  # q-block size for chunked attention


def cache_write(cache_arr: torch.Tensor, new: torch.Tensor, idx: int) -> torch.Tensor:
    """Write ``new`` [B, S, ...] into ``cache_arr`` [B, Smax, ...] at
    position ``idx``, in place; returns ``cache_arr``.  The start is
    clamped so the update fits, as ``dynamic_update_slice`` clamps it.

    Under mesh hints the write returns a new tensor.  A single token goes
    in by a masked (one-hot) write: a slice update of a sequence-sharded
    cache would gather the whole cache every step, while the masked write
    is local on every shard (the owner takes ``new``, the others keep
    their slice).  A longer write concatenates around the update."""
    S = new.shape[1]
    start = min(max(int(idx), 0), cache_arr.shape[1] - S)
    if pmesh.current() is not None:
        if S == 1:
            iota = torch.arange(cache_arr.shape[1], device=cache_arr.device)
            mask = (iota == start).reshape((1, -1) + (1,) * (cache_arr.dim() - 2))
            return torch.where(mask, new.to(cache_arr.dtype), cache_arr)
        parts = [cache_arr[:, :start], new.to(cache_arr.dtype),
                 cache_arr[:, start + S:]]
        return torch.cat([q for q in parts if q.shape[1]], dim=1)
    cache_arr[:, start:start + S] = new.to(cache_arr.dtype)
    return cache_arr


def _sdpa(q, k, v, hd, n_heads, *, causal, window, q_offset):
    """q: [B,S,H,hd]; k,v: [B,T,KV,hd] -> out [B,S,H,hd].

    GQA keys/values are expanded to H heads.  For S > _Q_CHUNK (a
    multiple of it) the q axis is processed in blocks so the [S, T]
    score matrix never materializes (exact softmax per q row)."""
    B, S, H, _ = q.shape
    T = k.shape[1]
    G = n_heads // k.shape[2]
    kx = torch.repeat_interleave(k, G, dim=2)
    vx = torch.repeat_interleave(v, G, dim=2)
    kx = pmesh.constrain(kx, "dp", None, "tp", None)
    vx = pmesh.constrain(vx, "dp", None, "tp", None)

    def attend_all(q, kx, vx):
        def attend(q_blk, offset):
            scores = _einsum("bshd,bthd->bhst", q_blk, kx).to(torch.float32)
            scores = scores / math.sqrt(hd)
            mask = attn_mask(q_blk.shape[1], T, causal=causal, window=window,
                             q_offset=offset, device=q.device)
            scores = torch.where(mask[None, None], scores, -1e30)
            w = torch.softmax(scores, dim=-1).to(v.dtype)
            return _einsum("bhst,bthd->bshd", w, vx)

        if S <= _Q_CHUNK or S % _Q_CHUNK:
            return attend(q, q_offset)
        return torch.cat([attend(q[:, i:i + _Q_CHUNK], q_offset + i)
                          for i in range(0, S, _Q_CHUNK)], dim=1)

    # under mesh hints, with q as kx and vx (batch and heads sharded),
    # each rank attends over its own shards
    if pmesh.current() is not None and q.placements == kx.placements:
        return pmesh.local(attend_all, q, kx, vx)
    return attend_all(q, kx, vx)


def _sdpa_decode(q, k, v, hd, n_heads, *, window, q_offset, key_pos=None):
    """Decode attention against a cache without GQA head expansion: the
    grouped einsum.  key_pos: absolute position of each cache slot (ring
    buffers); when None, slot t holds position t."""
    B, S, H, _ = q.shape
    KV = k.shape[2]
    G = n_heads // KV
    # under mesh hints q's heads stay whole on every tensor-parallel rank
    # (q is one token a sequence): the cache's positions take that axis
    # (``shardings.cache_specs``), so each rank scores its own positions
    # and the contraction over them sums across it.  Heads split over the
    # same axis would put two sharded dimensions, batch and kv heads,
    # into one of the einsum's folds, which torch 2.11's DTensor refuses.
    q = pmesh.constrain(q, "dp", None, None, None)
    qg = q.reshape(B, S, KV, G, hd)
    scores = _einsum("bskgh,btkh->bkgst", qg, k).to(torch.float32)
    scores = scores / math.sqrt(hd)
    if key_pos is None:
        mask = attn_mask(S, k.shape[1], causal=True, window=window,
                         q_offset=q_offset, device=q.device)
    else:
        qi = torch.arange(S, device=q.device)[:, None] + q_offset
        mask = (key_pos[None, :] <= qi) & (key_pos[None, :] >= 0)
        if window and window > 0:
            mask &= key_pos[None, :] > qi - window
    scores = torch.where(mask[None, None, None], scores, -1e30)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = _einsum("bkgst,btkh->bskgh", w, v)
    return out.reshape(B, S, H, hd)


def attention(p: Params, cfg: ArchConfig, x: torch.Tensor, pos: torch.Tensor,
              kind: str, *, cache: Optional[dict] = None) -> Tuple[torch.Tensor, Optional[dict]]:
    """Full-sequence (cache=None) or cached prefill/decode.

    cache = {k: [B, Smax, KV, hd], v: ..., idx: int}."""
    B, S, d = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = x.dtype
    # under mesh hints the flat projections are placed as the heads will
    # be (below) before they are split into heads
    q = x @ p["wq"].to(dt)
    if H % pmesh.tp_size():
        q = pmesh.constrain(q, "dp", "tp", None)
    q = q.reshape(B, S, H, hd)
    k = pmesh.constrain(x @ p["wk"].to(dt), "dp", None, None).reshape(B, S, KV, hd)
    v = pmesh.constrain(x @ p["wv"].to(dt), "dp", None, None).reshape(B, S, KV, hd)
    if cfg.qk_norm:
        q = _qk_normalize(q, p["q_norm"])
        k = _qk_normalize(k, p["k_norm"])
    # GQA: kv heads rarely divide the TP axis; replicate k/v across TP
    # (they are small) so the head expansion is a local slice
    k = pmesh.constrain(k, "dp", None, None, None)
    v = pmesh.constrain(v, "dp", None, None, None)
    sections = (16, 24, 24) if (cfg.mrope and hd == 128) else None
    q = apply_rope(q, pos, cfg.rope_theta, sections)
    k = apply_rope(k, pos, cfg.rope_theta, sections)

    # TP strategy: head-sharded when H divides the TP axis; otherwise
    # (ragged head counts, e.g. 15) context-parallel: shard q's seq axis
    if H % pmesh.tp_size() == 0:
        q = pmesh.constrain(q, "dp", None, "tp", None)
    else:
        q = pmesh.constrain(q, "dp", "tp", None, None)

    window = cfg.window if kind == "swa" else 0
    if cache is None:
        out = _sdpa(q, k, v, hd, H, causal=cfg.causal, window=window, q_offset=0)
        new_cache = None
    else:
        idx = int(cache["idx"])
        W = cache["k"].shape[1]
        ring = kind == "swa" and W == cfg.window  # ring buffer cache
        if ring and S > 1:
            # prefill a ring cache: attend over the in-flight k/v, then
            # store only the last `window` tokens, rolled so that slot ==
            # position % window
            out = _sdpa(q, k, v, hd, H, causal=True, window=window, q_offset=idx)
            if S >= W:
                ck = cache["k"].copy_(torch.roll(k[:, -W:], (idx + S) % W, dims=1))
                cv = cache["v"].copy_(torch.roll(v[:, -W:], (idx + S) % W, dims=1))
            else:
                ck = cache_write(cache["k"], k, idx)
                cv = cache_write(cache["v"], v, idx)
        elif ring:
            # ring decode: slot r holds position idx - ((idx%W - r) mod W)
            slot = idx % W
            ck = cache_write(cache["k"], k, slot)
            cv = cache_write(cache["v"], v, slot)
            r = torch.arange(W, device=x.device)
            key_pos = idx - torch.remainder(slot - r, W)
            out = _sdpa_decode(q, ck, cv, hd, H, window=window, q_offset=idx,
                               key_pos=key_pos)
        else:
            ck = cache_write(cache["k"], k, idx)
            cv = cache_write(cache["v"], v, idx)
            if S == 1:
                out = _sdpa_decode(q, ck, cv, hd, H, window=window, q_offset=idx)
            else:  # prefill into the cache: chunked path, no [S,T] blowup
                out = _sdpa(q, ck, cv, hd, H, causal=True, window=window, q_offset=idx)
        new_cache = {"k": ck, "v": cv, "idx": idx + S}
    # the heads merge where they were split: seq-sharded when H does not
    # divide the TP axis (a constraint on the merge keeps the gradient
    # arriving there in the same placement)
    out = out.reshape(B, S, H * hd)
    if H % pmesh.tp_size():
        out = pmesh.constrain(out, "dp", "tp", None)
    return out @ p["wo"].to(dt), new_cache


# ---------------------------------------------------------------- MLA

def mla_init(cfg: ArchConfig, generator=None, device=None) -> Params:
    d, H = cfg.d_model, cfg.n_heads
    nope, rope, vh, r = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim, cfg.kv_lora_rank
    sc, dt = 0.02, cfg.master_dtype
    return {
        "wq": _init(generator, (d, H * (nope + rope)), sc, dt, device),
        "w_dkv": _init(generator, (d, r + rope), sc, dt, device),     # c_kv + k_rope
        "w_uk": _init(generator, (r, H * nope), sc, dt, device),
        "w_uv": _init(generator, (r, H * vh), sc, dt, device),
        "wo": _init(generator, (H * vh, d), sc / math.sqrt(2 * cfg.n_layers), dt, device),
        "kv_norm": _ones((r,), dt, device),
    }


def mla_attention(p: Params, cfg: ArchConfig, x: torch.Tensor, pos: torch.Tensor,
                  *, cache: Optional[dict] = None) -> Tuple[torch.Tensor, Optional[dict]]:
    """DeepSeek MLA.  Prefill: expanded keys/values.  Decode: the
    *absorbed* path, scores against the compressed c_kv cache directly
    (a cache row is kv_lora + rope floats).

    cache = {c: [B, Smax, r], kr: [B, Smax, rope], idx: int}."""
    B, S, d = x.shape
    H = cfg.n_heads
    nope, rope, vh, r = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim, cfg.kv_lora_rank
    dt = x.dtype

    q = (x @ p["wq"].to(dt)).reshape(B, S, H, nope + rope)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, pos, cfg.rope_theta)

    dkv = x @ p["w_dkv"].to(dt)
    c_kv = rmsnorm({"scale": p["kv_norm"]}, dkv[..., :r])
    k_rope = apply_rope(dkv[..., r:][:, :, None, :], pos, cfg.rope_theta)[:, :, 0]

    scale = 1.0 / math.sqrt(nope + rope)
    new_cache = None
    if cache is not None:
        idx = int(cache["idx"])
        cc = cache_write(cache["c"], c_kv, idx)
        ckr = cache_write(cache["kr"], k_rope, idx)
        new_cache = {"c": cc, "kr": ckr, "idx": idx + S}
    if cache is None or S > 1:
        # prefill/training: expanded keys/values, q-chunked (a prefill
        # writes the cache above but attends over the current tokens)
        k_nope = (c_kv @ p["w_uk"].to(dt)).reshape(B, S, H, nope)
        v = (c_kv @ p["w_uv"].to(dt)).reshape(B, S, H, vh)

        def attend(qn_blk, qr_blk, offset):
            scores = (_einsum("bshn,bthn->bhst", qn_blk, k_nope)
                      + _einsum("bshn,btn->bhst", qr_blk, k_rope)).to(torch.float32)
            mask = attn_mask(qn_blk.shape[1], S, causal=True, window=0,
                             q_offset=offset, device=x.device)
            scores = torch.where(mask[None, None], scores * scale, -1e30)
            w = torch.softmax(scores, dim=-1).to(dt)
            return _einsum("bhst,bthv->bshv", w, v)

        if S <= _Q_CHUNK or S % _Q_CHUNK:
            out = attend(q_nope, q_rope, 0)
        else:
            out = torch.cat([attend(q_nope[:, i:i + _Q_CHUNK], q_rope[:, i:i + _Q_CHUNK], i)
                             for i in range(0, S, _Q_CHUNK)], dim=1)
    else:
        # single-token decode: the absorbed path against the c_kv cache
        cc, ckr, idx = new_cache["c"], new_cache["kr"], int(cache["idx"])
        T = cc.shape[1]
        w_uk = p["w_uk"].to(dt).reshape(r, H, nope)
        q_c = _einsum("bshn,rhn->bshr", q_nope, w_uk)
        scores = (_einsum("bshr,btr->bhst", q_c, cc)
                  + _einsum("bshn,btn->bhst", q_rope, ckr)).to(torch.float32)
        mask = attn_mask(S, T, causal=True, window=0, q_offset=idx, device=x.device)
        scores = torch.where(mask[None, None], scores * scale, -1e30)
        w = torch.softmax(scores, dim=-1).to(dt)
        attn_c = _einsum("bhst,btr->bshr", w, cc)         # attend over c_kv
        w_uv = p["w_uv"].to(dt).reshape(r, H, vh)
        out = _einsum("bshr,rhv->bshv", attn_c, w_uv)     # absorbed W_UV
    out = out.reshape(B, S, H * vh)
    return out @ p["wo"].to(dt), new_cache


# ---------------------------------------------------------------- MLP

def mlp_init(cfg: ArchConfig, d_ff: int, generator=None, device=None) -> Params:
    d, dt = cfg.d_model, cfg.master_dtype
    return {
        "w_gate": _init(generator, (d, d_ff), 0.02, dt, device),
        "w_up": _init(generator, (d, d_ff), 0.02, dt, device),
        "w_down": _init(generator, (d_ff, d), 0.02 / math.sqrt(2 * cfg.n_layers), dt, device),
    }


def mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    h = F.silu(x @ p["w_gate"].to(dt)) * (x @ p["w_up"].to(dt))
    return h @ p["w_down"].to(dt)


# ---------------------------------------------------------------- MoE

def moe_init(cfg: ArchConfig, generator=None, device=None) -> Params:
    d, E, Fd, dt = cfg.d_model, cfg.n_experts, cfg.moe_d_ff, cfg.master_dtype
    p = {
        "router": _init(generator, (d, E), 0.02, torch.float32, device),  # router in f32
        "w_gate": _init(generator, (E, d, Fd), 0.02, dt, device),
        "w_up": _init(generator, (E, d, Fd), 0.02, dt, device),
        "w_down": _init(generator, (E, Fd, d), 0.02 / math.sqrt(2 * cfg.n_layers), dt, device),
    }
    if cfg.n_shared_experts:
        p["shared"] = mlp_init(cfg, cfg.moe_d_ff * cfg.n_shared_experts, generator, device)
    return p


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the ``k`` largest along the last axis, ties to
    the lower index first (a stable descending sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_route(p: Params, cfg: ArchConfig, xg: torch.Tensor):
    """Token-choice routing of ``xg`` [G, Tg, d]: (gate, expert [G, Tg, K],
    keep, dest [G, Tg, K], capacity C, aux loss).  ``dest`` is the row
    ``expert * C + slot`` of a kept choice and the overflow row ``E * C``
    of a dropped one; slots count each expert's choices in token-major
    order."""
    G, Tg, _ = xg.shape
    E, K = cfg.n_experts, cfg.top_k
    # the router is a 2-D master, so cast_params rounded it to the compute
    # dtype; it multiplies in float32 (the reference promotes it back)
    logits = xg.to(torch.float32) @ p["router"].to(torch.float32)   # [G, Tg, E]
    probs = torch.softmax(logits, dim=-1)
    gate, expert = top_k(probs, K)                                   # [G, Tg, K]
    gate = gate / torch.sum(gate, dim=-1, keepdim=True)

    # load-balancing aux loss (Switch-style)
    me = torch.mean(probs, dim=(0, 1))
    ce = torch.mean(F.one_hot(expert[..., 0], E).to(torch.float32), dim=(0, 1))
    aux = E * torch.sum(me * ce)

    C = max(1, int(cfg.capacity_factor * Tg * K / E))
    flat_e = expert.reshape(G, Tg * K)
    onehot_pos = F.one_hot(flat_e, E).to(torch.int32)               # [G, TgK, E]
    pos_in_e = torch.cumsum(onehot_pos, dim=1) - 1
    slot = torch.gather(pos_in_e, 2, flat_e[..., None])[..., 0]
    keep = (slot < C).reshape(G, Tg, K)
    dest = torch.where(keep.reshape(G, Tg * K), flat_e * C + slot, E * C)
    return gate, expert, keep, dest.reshape(G, Tg, K), C, aux


def moe(p: Params, cfg: ArchConfig, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-choice top-k with grouped-local capacity dispatch.

    Tokens are processed in G groups aligned with the data-parallel axes
    (G = their size under mesh hints when it divides the tokens, 1
    otherwise): routing positions and the dispatch are computed per
    group, so every buffer carries a leading dp-shardable group dim, and
    each group's capacity is ``cf * Tg * K / E``.  Dispatch and combine
    are row scatters and gathers, one top-k slot at a time, never the
    one-hot einsum.  Returns (out, aux_loss)."""
    B, S, d = x.shape
    E, T, dt = cfg.n_experts, B * S, x.dtype
    hints = pmesh.current()
    G = hints.axis_size("dp") if hints and T % hints.axis_size("dp") == 0 else 1
    Tg = T // G
    xt = x.reshape(T, d)
    gate, _, keep, dest, C, aux = moe_route(p, cfg, xt.reshape(G, Tg, d))
    gate, keep = gate.reshape(T, -1), keep.reshape(T, -1)
    # group g's rows start at g * (E * C + 1); its row E * C takes every
    # dropped choice and is cut off
    grp = torch.arange(G, device=x.device).repeat_interleave(Tg)     # each token's group
    dest = dest.reshape(T, -1)
    buf = torch.zeros((G * (E * C + 1), d), dtype=dt, device=x.device)
    for kk in range(cfg.top_k):
        buf = buf.index_add(0, dest[:, kk] + grp * (E * C + 1), xt)
    buf = buf.reshape(G, E * C + 1, d)[:, :-1].reshape(G, E, C, d)
    # groups ride the dp axis; experts ride TP when they divide it (EP),
    # otherwise the expert FFN width is sharded over TP
    ep = E % pmesh.tp_size() == 0
    buf = pmesh.constrain(buf, "dp", "tp" if ep else None, None, None)

    h = F.silu(_einsum("gecd,edf->gecf", buf, p["w_gate"].to(dt)))
    h = h * _einsum("gecd,edf->gecf", buf, p["w_up"].to(dt))
    if not ep:
        h = pmesh.constrain(h, "dp", None, None, "tp")
    rows = _einsum("gecf,efd->gecd", h, p["w_down"].to(dt)).reshape(G * E * C, d)

    combined = torch.zeros((T, d), dtype=dt, device=x.device)
    for kk in range(cfg.top_k):
        r = rows[torch.clamp(dest[:, kk], max=E * C - 1) + grp * (E * C)]
        combined = combined + r * (gate[:, kk] * keep[:, kk]).to(dt)[:, None]

    if cfg.n_shared_experts:
        combined = combined + mlp(p["shared"], xt)
    return combined.reshape(B, S, d), aux


# ---------------------------------------------------------------- Mamba2 SSD

def mamba2_init(cfg: ArchConfig, generator=None, device=None) -> Params:
    d, di, N, H = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.n_ssm_heads
    dt = cfg.master_dtype
    conv_ch = di + 2 * N  # conv over x, B, C (mamba2 layout)
    return {
        "in_proj": _init(generator, (d, 2 * di + 2 * N + H), 0.02, dt, device),
        "conv_w": _init(generator, (cfg.d_conv, conv_ch), 0.2, dt, device),
        "A_log": torch.zeros((H,), dtype=torch.float32, device=device),
        "dt_bias": torch.zeros((H,), dtype=torch.float32, device=device),
        "D": torch.ones((H,), dtype=torch.float32, device=device),
        "out_norm": _ones((di,), dt, device),
        "out_proj": _init(generator, (di, d), 0.02 / math.sqrt(2 * cfg.n_layers), dt, device),
    }


def _ssd_chunked(xh, dt, A, Bm, Cm, chunk: int):
    """Minimal SSD (Mamba2 §6): intra-chunk quadratic + inter-chunk scan.

    xh: [B,S,H,P], dt: [B,S,H] (>=0), A: [H] (<0), Bm/Cm: [B,S,N].
    Returns y: [B,S,H,P]."""
    B_, S, H, P = xh.shape
    N = Bm.shape[-1]
    nc = S // chunk
    xc = xh.reshape(B_, nc, chunk, H, P)
    dtc = dt.reshape(B_, nc, chunk, H)
    Bc = Bm.reshape(B_, nc, chunk, N)
    Cc = Cm.reshape(B_, nc, chunk, N)

    da = dtc * A  # [B,nc,Q,H] (negative)
    cum = torch.cumsum(da, dim=2)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]          # [B,nc,Qi,Qj,H]
    ii = torch.arange(chunk, device=xh.device)
    causal = (ii[:, None] >= ii[None, :])[None, None, :, :, None]
    L = torch.where(causal, torch.exp(seg), 0.0)

    # intra-chunk: y_intra[i] = sum_j L[i,j] * (C_i . B_j) * dt_j * x_j
    cb = _einsum("bcin,bcjn->bcij", Cc, Bc)                       # [B,nc,Qi,Qj]
    w = cb[..., None] * L                                         # [B,nc,Qi,Qj,H]
    y_intra = _einsum("bcijh,bcjh,bcjhp->bcihp", w, dtc, xc)

    # chunk summaries: S_c = sum_j exp(cum_last - cum_j) dt_j x_j B_j^T
    # (the state recurrence runs in float32; outputs cast back)
    decay_tail = torch.exp(cum[:, :, -1:, :] - cum)               # [B,nc,Q,H]
    Sc = _einsum("bcjh,bcjh,bcjhp,bcjn->bchpn", decay_tail, dtc, xc, Bc)
    Sc = Sc.to(torch.float32)

    # inter-chunk recurrence over nc: the state before each chunk
    total = torch.exp(cum[:, :, -1, :])                           # [B,nc,H]
    h = torch.zeros((B_, H, P, N), dtype=torch.float32, device=xh.device)
    prev = []
    for c in range(nc):
        prev.append(h)
        h = h * total[:, c, :, None, None] + Sc[:, c]
    h_prev = torch.stack(prev, dim=1)                             # [B,nc,H,P,N]

    # inter-chunk contribution: y_inter[i] = C_i . (exp(cum_i) * h_prev)
    y_inter = _einsum("bcin,bcih,bchpn->bcihp",
                      Cc.to(torch.float32), torch.exp(cum), h_prev)
    y = (y_intra.to(torch.float32) + y_inter).reshape(B_, S, H, P)
    return y.to(xh.dtype)


def mamba2(p: Params, cfg: ArchConfig, x: torch.Tensor, *,
           cache: Optional[dict] = None, chunk: int = 128) -> Tuple[torch.Tensor, Optional[dict]]:
    """Mamba2 SSD mixer.  cache = {conv: [B, d_conv-1, ch], h: [B,H,P,N], idx}.

    With a cache the mixer takes the recurrent step of the sequence's
    first token (the reference's decode branch, for any S)."""
    B, S, d = x.shape
    di, N, H = cfg.d_inner, cfg.d_state, cfg.n_ssm_heads
    P = di // H
    dt_model = x.dtype

    proj = x @ p["in_proj"].to(dt_model)                          # [B,S,2di+2N+H]
    z, xbc, dt_raw = torch.split(proj, [di, di + 2 * N, H], dim=-1)
    dt = F.softplus(dt_raw.to(torch.float32) + p["dt_bias"])      # [B,S,H]
    A = -torch.exp(p["A_log"])                                    # [H]

    conv_w = p["conv_w"].to(dt_model)                             # [K, ch]
    K = cfg.d_conv
    if cache is None:
        pad = torch.zeros((B, K - 1, xbc.shape[-1]), dtype=dt_model, device=x.device)
        xin = torch.cat([pad, xbc], dim=1)
        new_conv_state = None
    else:
        ct = torch.promote_types(cache["conv"].dtype, dt_model)
        xin = torch.cat([cache["conv"].to(ct), xbc.to(ct)], dim=1)  # [B, K-1+S, ch]
        new_conv_state = xin[:, -(K - 1):]
    conv = sum(xin[:, i: i + S] * conv_w[i] for i in range(K))
    conv = F.silu(conv)
    xh, Bm, Cm = torch.split(conv, [di, N, N], dim=-1)
    xh = xh.reshape(B, S, H, P)

    if cache is None:
        pad_s = (-S) % chunk
        if pad_s:
            def zpad(a):
                return F.pad(a, [0, 0] * (a.dim() - 2) + [0, pad_s])
            # the padded branch rounds dt to the model dtype first
            y = _ssd_chunked(zpad(xh), zpad(dt.to(dt_model)).to(torch.float32),
                             A, zpad(Bm), zpad(Cm), chunk)[:, :S]
        else:
            y = _ssd_chunked(xh, dt, A, Bm, Cm, chunk)
        new_cache = None
    else:
        # recurrent decode: h <- h * exp(dt A) + dt * x B^T ; y = C.h
        h = cache["h"]
        dts = dt[:, 0]                                            # [B,H]
        decay = torch.exp(dts * A)                                # [B,H]
        upd = _einsum("bh,bhp,bn->bhpn", dts.to(dt_model), xh[:, 0], Bm[:, 0])
        h = h * decay[..., None, None].to(dt_model) + upd
        y = _einsum("bn,bhpn->bhp", Cm[:, 0], h)[:, None]         # [B,1,H,P]
        new_cache = {"conv": new_conv_state, "h": h, "idx": int(cache["idx"]) + S}

    y = y + p["D"].to(dt_model)[:, None] * xh
    y = y.reshape(B, S, di)
    y = rmsnorm({"scale": p["out_norm"]}, y * F.silu(z))
    return y @ p["out_proj"].to(dt_model), new_cache


# ---------------------------------------------------------------- embed

def embed_init(cfg: ArchConfig, generator=None, device=None) -> Params:
    return {
        "tok": _init(generator, (cfg.vocab, cfg.d_model), 1.0, cfg.master_dtype, device),
        "head": _init(generator, (cfg.d_model, cfg.vocab), 0.02, cfg.master_dtype, device),
    }
