"""phi-3-vision-4.2b [vlm] — phi3-mini backbone + CLIP stub
[hf:microsoft/Phi-3-vision-128k-instruct; hf].

32L d_model=3072 32H (kv=32, MHA) d_ff=8192 vocab=32064. The modality
frontend is a stub: ``input_specs`` provides 576 precomputed CLIP patch
embeddings (d=1024) per sample, projected and prepended to the token
sequence.
"""
from repro_torch.models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi-3-vision-4.2b", family="vlm",
        n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
        d_ff=8192, vocab=32064, mlp_kind="swiglu", norm="rmsnorm",
        vision_patches=576, vision_d=1024,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="phi3v-smoke", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=160, vocab=512, vision_patches=16, vision_d=48,
    )
