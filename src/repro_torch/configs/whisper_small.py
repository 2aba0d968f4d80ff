"""whisper-small [audio] — enc-dec; conv frontend stubbed
[arXiv:2212.04356; unverified].

12+12L d_model=768 12H d_ff=3072 vocab=51865. ``input_specs`` provides
precomputed 1500-frame encoder embeddings (the conv frontend stub per
the assignment); LM shapes apply to the decoder side.
"""
from repro_torch.models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-small", family="encdec",
        n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
        d_ff=3072, vocab=51865, mlp_kind="gelu", norm="layernorm",
        use_rope=False, encoder_layers=12, encoder_seq=1500,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke", family="encdec",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=512, mlp_kind="gelu", norm="layernorm",
        use_rope=False, encoder_layers=2, encoder_seq=32,
    )
