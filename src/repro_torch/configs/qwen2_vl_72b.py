"""qwen2-vl-72b [vlm]: M-RoPE, dynamic resolution [arXiv:2409.12191; hf].
Vision frontend is a stub: input_specs supplies precomputed patch
embeddings; M-RoPE runs with coinciding (t,h,w) text positions."""
from repro_torch.models.config import ArchConfig


def get_config() -> ArchConfig:
    return ArchConfig(
        name="qwen2-vl-72b", family="vlm",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=29568, vocab=152064, head_dim=128,
        mrope=True, rope_theta=1e6, frontend="vision",
    )


def get_smoke_config() -> ArchConfig:
    return get_config().replace(
        n_layers=4, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab=256, dtype="float32",
    )
