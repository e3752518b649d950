"""mamba2-2.7b [ssm]: attention-free SSD (state-space duality), no FFN,
d_state=128 [arXiv:2405.21060; unverified]."""
from repro_torch.models.config import ArchConfig


def get_config() -> ArchConfig:
    return ArchConfig(
        name="mamba2-2.7b", family="ssm",
        n_layers=64, d_model=2560, n_heads=1, n_kv_heads=1,
        d_ff=0, vocab=50280,
        ssm=True, attn_every=0, d_state=128, ssm_head_dim=64, expand=2,
    )


def get_smoke_config() -> ArchConfig:
    return get_config().replace(
        n_layers=4, d_model=64, vocab=256, d_state=16, ssm_head_dim=16,
        dtype="float32",
    )
