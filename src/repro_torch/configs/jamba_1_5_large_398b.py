"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7 interleave, MoE.

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16e top-2
[arXiv:2403.19887; hf]. Attention at position 4 of every 8-layer block
(1:7 ratio); MoE FFN every 2nd layer (e=16, top-2). 398B total / ~98B
active.
"""
from repro_torch.models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b", family="hybrid",
        n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=24576, vocab=65536, head_dim=128,
        mixer="mamba_hybrid", attn_period=8, attn_offset=4,
        n_experts=16, top_k=2, moe_period=2, moe_offset=1,
        dense_d_ff=24576, mlp_kind="swiglu", norm="rmsnorm",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="jamba-smoke", family="hybrid",
        n_layers=8, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=96, vocab=512, head_dim=16,
        mixer="mamba_hybrid", attn_period=8, attn_offset=4,
        n_experts=4, top_k=2, moe_period=2, moe_offset=1,
        dense_d_ff=96, ssm_state=8,
    )
