"""Architecture configuration schema covering all 10 families (port of
``repro.models.config``): dense / MoE / MLA / SWA / local-global /
qk-norm / M-RoPE / SSD(Mamba2) / hybrid (Jamba) / encoder-only.

``dtype`` (compute) and ``param_dtype`` (masters) keep the reference's
names; :func:`torch_dtype` and the ``compute_dtype``/``master_dtype``
properties give PyTorch's.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float64": torch.float64}


def torch_dtype(name) -> torch.dtype:
    """The ``torch.dtype`` of a dtype name (``"bfloat16"``, ...), or the
    dtype itself."""
    return name if isinstance(name, torch.dtype) else _DTYPES[str(name)]


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense|moe|ssm|hybrid|encoder|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # default d_model // n_heads

    # attention flavor
    attn_kind: str = "full"         # full | swa | local_global
    window: int = 4096
    local_per_global: int = 0       # gemma3: 5 local then 1 global
    qk_norm: bool = False
    rope_theta: float = 1e4
    mrope: bool = False             # qwen2-vl (text positions in dry-run)
    causal: bool = True

    # MLA (deepseek)
    mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0            # 0 = no q compression (v2-lite)
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 128

    # MoE
    moe: bool = False
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    moe_every: int = 1              # jamba: MoE every 2nd layer
    first_dense_layers: int = 0     # deepseek: layer 0 dense
    capacity_factor: float = 1.25

    # SSM (mamba2 SSD)
    ssm: bool = False
    attn_every: int = 0             # jamba: one attention layer per 8
    d_state: int = 128
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    d_conv: int = 4
    expand: int = 2

    # frontend stubs for [vlm]/[audio]: inputs are precomputed embeddings
    frontend: str = "none"          # none | vision | audio

    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "float32"

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def master_dtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.ssm_heads or (self.d_inner // self.ssm_head_dim)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    # ---- layer-pattern helpers -------------------------------------------

    def layer_kind(self, i: int) -> str:
        """'attn' | 'ssm' for mixer at layer i."""
        if not self.ssm:
            return "attn"
        if self.attn_every and (i % self.attn_every == self.attn_every // 2):
            return "attn"
        return "ssm"

    def layer_attn_kind(self, i: int) -> str:
        """'full' | 'swa' for attention layer i (gemma3 5:1 pattern)."""
        if self.attn_kind == "local_global":
            return "full" if (i % (self.local_per_global + 1)
                              == self.local_per_global) else "swa"
        return self.attn_kind

    def layer_is_moe(self, i: int) -> bool:
        if not self.moe:
            return False
        if i < self.first_dense_layers:
            return False
        return (i % self.moe_every) == (self.moe_every - 1) if self.moe_every > 1 else True

    def param_count(self) -> int:
        """Approximate total parameters (for roofline MODEL_FLOPS)."""
        d, hd = self.d_model, self.hd
        total = self.vocab * d  # embed (untied lm head counted below)
        total += self.vocab * d
        for i in range(self.n_layers):
            if self.layer_kind(i) == "attn":
                if self.mla:
                    qdim = self.n_heads * (self.qk_nope_dim + self.qk_rope_dim)
                    total += d * qdim
                    total += d * (self.kv_lora_rank + self.qk_rope_dim)
                    total += self.kv_lora_rank * self.n_heads * (self.qk_nope_dim + self.v_head_dim)
                    total += self.n_heads * self.v_head_dim * d
                else:
                    total += d * self.n_heads * hd
                    total += 2 * d * self.n_kv_heads * hd
                    total += self.n_heads * hd * d
            else:
                di, N, H = self.d_inner, self.d_state, self.n_ssm_heads
                total += d * (2 * di + 2 * N + H) + di * d + di * self.d_conv
            if self.layer_is_moe(i):
                e_all = self.n_experts + self.n_shared_experts
                total += e_all * 3 * d * self.moe_d_ff + d * self.n_experts
            elif self.d_ff:
                total += 3 * d * self.d_ff
            total += 2 * d
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed top-k + shared)."""
        if not self.moe:
            return self.param_count()
        total = self.param_count()
        for i in range(self.n_layers):
            if self.layer_is_moe(i):
                inactive = (self.n_experts - self.top_k) * 3 * self.d_model * self.moe_d_ff
                total -= inactive
        return total
