"""deepseek-v2-lite-16b [moe]: MLA kv_lora=512, 64 routed top-6 + 2 shared,
first layer dense [arXiv:2405.04434; hf].  (The assignment line's "160
routed" tail describes full V2; the leading "MoE 64e top-6" is V2-Lite.)"""
from repro_torch.models.config import ArchConfig


def get_config() -> ArchConfig:
    return ArchConfig(
        name="deepseek-v2-lite-16b", family="moe",
        n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=10944, vocab=102400,
        mla=True, kv_lora_rank=512, q_lora_rank=0,
        qk_rope_dim=64, qk_nope_dim=128, v_head_dim=128,
        moe=True, n_experts=64, n_shared_experts=2, top_k=6,
        moe_d_ff=1408, first_dense_layers=1,
    )


def get_smoke_config() -> ArchConfig:
    return get_config().replace(
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab=256, kv_lora_rank=32, qk_rope_dim=16, qk_nope_dim=32,
        v_head_dim=32, n_experts=8, top_k=2, moe_d_ff=64, dtype="float32",
    )
