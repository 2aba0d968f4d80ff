"""dbrx-132b [moe] — 16 experts top-4, fine-grained
[hf:databricks/dbrx-base; unverified].

40L d_model=6144 48H (GQA kv=8) expert d_ff=10752 vocab=100352.
"""
from repro_torch.models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b", family="moe",
        n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=10752, vocab=100352,
        n_experts=16, top_k=4,
        mlp_kind="swiglu", norm="layernorm",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="dbrx-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=96, vocab=512, n_experts=4, top_k=2,
        norm="layernorm",
    )
