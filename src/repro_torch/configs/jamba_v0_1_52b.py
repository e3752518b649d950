"""jamba-v0.1-52b [hybrid]: Mamba+attention 1:7 interleave (attention at
offset 4 of each 8-layer block), MoE 16e top-2 on every 2nd layer
[arXiv:2403.19887; hf].  The SSM mixer is the Mamba2/SSD block of
``models/layers.py`` in place of Jamba's Mamba-1, as in the reference."""
from repro_torch.models.config import ArchConfig


def get_config() -> ArchConfig:
    return ArchConfig(
        name="jamba-v0.1-52b", family="hybrid",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab=65536,
        moe=True, n_experts=16, top_k=2, moe_d_ff=14336, moe_every=2,
        ssm=True, attn_every=8, d_state=16, ssm_head_dim=64, expand=2,
    )


def get_smoke_config() -> ArchConfig:
    return get_config().replace(
        n_layers=16, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab=256, n_experts=4, top_k=2, moe_d_ff=128,
        d_state=8, ssm_head_dim=16, dtype="float32",
    )
