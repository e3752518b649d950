"""Architecture registry + assigned input shapes (port of
``repro.configs.base``).

Shapes (LM family):
  train_4k    : train_step,  seq 4096,   global batch 256
  prefill_32k : prefill,     seq 32768,  global batch 32
  decode_32k  : serve_step,  1 new token against a 32768 KV cache, batch 128
  long_500k   : serve_step,  1 new token against a 524288 cache,  batch 1
                (sub-quadratic archs only — see `applicable`)
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from ..models.config import ArchConfig


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str       # train | prefill | decode
    seq: int
    batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

ARCHS = [
    "deepseek_v2_lite_16b",
    "mixtral_8x7b",
    "qwen2_vl_72b",
    "smollm_360m",
    "granite_20b",
    "gemma3_27b",
    "qwen3_0p6b",
    "jamba_v0_1_52b",
    "hubert_xlarge",
    "mamba2_2p7b",
]


def get_config(arch: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.get_config()


def get_smoke_config(arch: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.get_smoke_config()


def _spec(shape) -> ShapeSpec:
    return SHAPES[shape] if isinstance(shape, str) else shape


def applicable(cfg: ArchConfig, shape) -> Tuple[bool, str]:
    """Which (arch x shape) cells run, and why a cell is skipped
    (``shape``: a name of :data:`SHAPES` or a :class:`ShapeSpec`)."""
    s = _spec(shape)
    shape = s.name
    if not cfg.causal and s.kind == "decode":
        return False, "encoder-only: no decode step"
    if shape == "long_500k":
        subq = cfg.ssm or cfg.attn_kind in ("swa", "local_global")
        if not subq:
            return False, "pure full attention: 500k decode cache skipped per shape rules"
    return True, ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape) -> Dict[str, torch.Tensor]:
    """Meta-tensor stand-ins for every model input (no allocation);
    ``shape`` as in :func:`applicable`.

    [vlm]/[audio] archs receive precomputed patch/frame embeddings from
    the stub frontend instead of token ids."""
    s = _spec(shape)
    i32 = torch.int32
    if s.kind == "train":
        out = {
            "labels": _meta((s.batch, s.seq), i32),
            "positions": _meta((s.batch, s.seq), i32),
        }
        if cfg.frontend != "none":
            out["embeds"] = _meta((s.batch, s.seq, cfg.d_model), torch.bfloat16)
        else:
            out["tokens"] = _meta((s.batch, s.seq), i32)
        return out
    if s.kind == "prefill":
        out = {"positions": _meta((s.batch, s.seq), i32)}
        if cfg.frontend != "none":
            out["embeds"] = _meta((s.batch, s.seq, cfg.d_model), torch.bfloat16)
        else:
            out["tokens"] = _meta((s.batch, s.seq), i32)
        return out
    # decode: one new token; the KV/SSM caches come from
    # transformer.caches_init on the meta device
    return {
        "tokens": _meta((s.batch, 1), i32),
        "positions": _meta((s.batch, 1), i32),
    }
