"""starcoder2-15b [dense] — GQA, RoPE, GELU MLP [arXiv:2402.19173; hf].

40L d_model=6144 48H (GQA kv=4) d_ff=24576 vocab=49152.
"""
from repro_torch.models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-15b", family="dense",
        n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4,
        d_ff=24576, vocab=49152, mlp_kind="gelu", norm="layernorm",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-15b-smoke", family="dense",
        n_layers=3, d_model=96, n_heads=6, n_kv_heads=2,
        d_ff=384, vocab=512, mlp_kind="gelu", norm="layernorm",
    )
