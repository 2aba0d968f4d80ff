"""rwkv6-7b "Finch" [ssm] — attention-free, data-dependent decay
[arXiv:2404.05892; hf].

32L d_model=4096 d_ff=14336 vocab=65536; head size 64 (64 heads).
"""
from repro_torch.models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b", family="ssm",
        n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64,
        d_ff=14336, vocab=65536, mixer="rwkv", rwkv_head_size=64,
        use_rope=False,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-smoke", family="ssm",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=160, vocab=512, mixer="rwkv", rwkv_head_size=16,
        use_rope=False,
    )
