"""deepseek-moe-16b [moe] — fine-grained MoE: 2 shared + 64 routed top-6
[arXiv:2401.06066; hf].

28L d_model=2048 16H (kv=16, MHA) expert d_ff=1408 vocab=102400; first
layer is a dense FFN (d_ff=10944) per the published config.
"""
from repro_torch.models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b", family="moe",
        n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=1408, vocab=102400,
        n_experts=64, top_k=6, n_shared_experts=2,
        first_dense=1, dense_d_ff=10944,
        mlp_kind="swiglu", norm="rmsnorm",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-smoke", family="moe",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=48, vocab=512,
        n_experts=8, top_k=3, n_shared_experts=2,
        first_dense=1, dense_d_ff=160,
    )
