"""starcoder2-3b [dense] — GQA, RoPE [arXiv:2402.19173; hf].

30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152.
"""
from repro_torch.models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-3b", family="dense",
        n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2,
        d_ff=12288, vocab=49152, mlp_kind="gelu", norm="layernorm",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-3b-smoke", family="dense",
        n_layers=3, d_model=96, n_heads=6, n_kv_heads=2,
        d_ff=384, vocab=512, mlp_kind="gelu", norm="layernorm",
    )
