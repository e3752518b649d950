"""hubert-xlarge [audio]: encoder-only (bidirectional), frame-level
targets (504 clusters) [arXiv:2106.07447; unverified].  Audio frontend is
a stub: input_specs supplies precomputed frame embeddings."""
from repro_torch.models.config import ArchConfig


def get_config() -> ArchConfig:
    return ArchConfig(
        name="hubert-xlarge", family="audio",
        n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16,
        d_ff=5120, vocab=504,
        causal=False, frontend="audio",
    )


def get_smoke_config() -> ArchConfig:
    return get_config().replace(
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab=64, dtype="float32",
    )
