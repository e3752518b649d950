"""smollm-360m [dense]: llama-arch small [hf:HuggingFaceTB/SmolLM; hf]."""
from repro_torch.models.config import ArchConfig


def get_config() -> ArchConfig:
    return ArchConfig(
        name="smollm-360m", family="dense",
        n_layers=32, d_model=960, n_heads=15, n_kv_heads=5,
        d_ff=2560, vocab=49152, head_dim=64,
    )


def get_smoke_config() -> ArchConfig:
    return get_config().replace(
        n_layers=4, d_model=96, n_heads=3, n_kv_heads=1, head_dim=32,
        d_ff=192, vocab=256, dtype="float32",
    )
