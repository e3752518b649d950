"""qwen3-0.6b [dense]: qk_norm, GQA [hf:Qwen/Qwen3; hf]."""
from repro_torch.models.config import ArchConfig


def get_config() -> ArchConfig:
    return ArchConfig(
        name="qwen3-0.6b", family="dense",
        n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8,
        d_ff=3072, vocab=151936, head_dim=128,
        qk_norm=True, rope_theta=1e6,
    )


def get_smoke_config() -> ArchConfig:
    return get_config().replace(
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, dtype="float32",
    )
