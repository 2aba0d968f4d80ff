"""granite-8b [dense] — llama-arch code model [arXiv:2405.04324; hf].

36L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=49152.
"""
from repro_torch.models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-8b", family="dense",
        n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab=49152, mlp_kind="swiglu", norm="rmsnorm",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="granite-smoke", family="dense",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=160, vocab=512,
    )
