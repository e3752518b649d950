"""gemma3-27b [dense]: 5 local (sliding 1024) : 1 global, 128k context
[hf:google/gemma-3; unverified]."""
from repro_torch.models.config import ArchConfig


def get_config() -> ArchConfig:
    return ArchConfig(
        name="gemma3-27b", family="dense",
        n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16,
        d_ff=21504, vocab=262144, head_dim=128,
        attn_kind="local_global", local_per_global=5, window=1024,
        qk_norm=True, rope_theta=1e6,
    )


def get_smoke_config() -> ArchConfig:
    return get_config().replace(
        n_layers=12, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, window=16, dtype="float32",
    )
