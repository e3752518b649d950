"""granite-20b [dense]: llama-arch, code, MQA (kv=1) [arXiv:2405.04324; hf]."""
from repro_torch.models.config import ArchConfig


def get_config() -> ArchConfig:
    return ArchConfig(
        name="granite-20b", family="dense",
        n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1,
        d_ff=24576, vocab=49152, head_dim=128,
    )


def get_smoke_config() -> ArchConfig:
    return get_config().replace(
        n_layers=4, d_model=96, n_heads=4, n_kv_heads=1, head_dim=24,
        d_ff=192, vocab=256, dtype="float32",
    )
