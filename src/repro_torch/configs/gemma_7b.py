"""gemma-7b [dense] — GeGLU, head_dim=256, tied+scaled embeddings
[arXiv:2403.08295; hf].

28L d_model=3072 16H (kv=16, MHA) d_ff=24576 vocab=256000.
"""
from repro_torch.models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma-7b", family="dense",
        n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16,
        d_ff=24576, vocab=256000, head_dim=256,
        mlp_kind="geglu", norm="rmsnorm",
        tie_embeddings=True, embed_scale=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="gemma-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=256, vocab=512, head_dim=32, mlp_kind="geglu",
        tie_embeddings=True, embed_scale=True,
    )
