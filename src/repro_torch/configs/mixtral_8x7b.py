"""mixtral-8x7b [moe]: 8 experts top-2, sliding-window attention
[arXiv:2401.04088; hf]."""
from repro_torch.models.config import ArchConfig


def get_config() -> ArchConfig:
    return ArchConfig(
        name="mixtral-8x7b", family="moe",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab=32000,
        attn_kind="swa", window=4096,
        moe=True, n_experts=8, top_k=2, moe_d_ff=14336,
    )


def get_smoke_config() -> ArchConfig:
    return get_config().replace(
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab=256, n_experts=4, top_k=2, moe_d_ff=128, window=32,
        dtype="float32",
    )
