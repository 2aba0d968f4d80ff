"""The assigned input-shape cells and their per-architecture
applicability.

LM shapes are (seq_len × global_batch). ``decode_*`` / ``long_*`` lower
``serve_step`` (one new token against a KV cache/state of ``seq``), not
``train_step``. ``long_500k`` requires sub-quadratic sequence mixing —
it runs for the SSM/hybrid archs (rwkv6: O(1) state; jamba: 7/8 of
layers O(1) mamba state, 1/8 windowed O(T) KV reads) and is *skipped*
(with the reason recorded) for pure full-attention archs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.models.model import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str          # train | prefill | decode
    seq: int
    batch: int


SHAPES = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}

SUBQUADRATIC_MIXERS = ("mamba_hybrid", "rwkv")


def supports(cfg: ModelConfig, shape_name: str) -> Tuple[bool, Optional[str]]:
    shape = SHAPES[shape_name]
    if shape.name == "long_500k" and cfg.mixer not in SUBQUADRATIC_MIXERS:
        return False, ("full-attention architecture: 512k-token decode is "
                       "quadratic-cost; skipped per assignment note "
                       "(sub-quadratic archs only)")
    return True, None


def microbatches_for(cfg: ModelConfig, shape: ShapeCell,
                     dp_size: int) -> int:
    """Grad-accumulation factor: bound per-microbatch tokens/device.

    The reference's rule, kept as it is so that a cell splits into the
    same microbatches: ≤ 4 sequences per device per microbatch.
    """
    if shape.kind != "train":
        return 1
    per_dev = max(shape.batch // max(dp_size, 1), 1)
    target = 4
    m = max(per_dev // target, 1)
    while per_dev % m:
        m -= 1
    return m
