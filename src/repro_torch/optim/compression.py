"""int8 error-feedback gradient compression for the cross-shard reduce
(port of ``repro/optim/compression.py``).

    q_t   = quant_int8(g_t + e_{t-1})        (per-tensor absmax scaling)
    ĝ_t   = Σ_shards dequant(q_t) / n        (the mean across the mesh)
    e_t   = (g_t + e_{t-1}) − dequant(q_t)   (residual carried forward)

The reduction runs over the port's shard meshes (``core/mesh.py``) in
place of a JAX axis name: :class:`~repro_torch.core.mesh.ShardMesh`
holds every shard in this process, so each function takes one gradient
(and one residual) per held shard, in shard order;
:class:`~repro_torch.core.mesh.ProcessGroupMesh` holds one, and its
``all_reduce`` sums across the ranks. Scales, counts and residuals are
float32, as the reference's are.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor absmax int8 quantization. Returns (q, scale)."""
    xf = x.to(torch.float32)
    scale = torch.clamp(xf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum(gs: Sequence[torch.Tensor], errs: Sequence[torch.Tensor],
                    mesh) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Error-feedback int8 mean of one gradient across ``mesh``: ``gs``
    and ``errs`` hold one tensor per held shard. Returns (the mean, in
    the gradients' dtype; each held shard's new residual)."""
    deqs, new_errs = [], []
    for g, err in zip(gs, errs, strict=True):
        corrected = g.to(torch.float32) + err.to(torch.float32)
        q, scale = quantize_int8(corrected)
        deq = dequantize_int8(q, scale)
        deqs.append(deq)
        new_errs.append((corrected - deq).to(err.dtype))
    total = mesh.reduce(deqs, "sum")
    n = mesh.reduce([torch.ones((), dtype=torch.float32, device=d.device)
                     for d in deqs], "sum")
    return (total / n).to(gs[0].dtype), new_errs


def compressed_psum_tree(grads: Sequence[Dict[str, torch.Tensor]],
                         errs: Sequence[Dict[str, torch.Tensor]], mesh
                         ) -> Tuple[Dict[str, torch.Tensor],
                                    List[Dict[str, torch.Tensor]]]:
    """:func:`compressed_psum` of every leaf of per-shard gradient dicts
    (one dict per held shard, keyed alike)."""
    mean: Dict[str, torch.Tensor] = {}
    new_errs: List[Dict[str, torch.Tensor]] = [{} for _ in grads]
    for k in grads[0]:
        mean[k], es = compressed_psum([g[k] for g in grads],
                                      [e[k] for e in errs], mesh)
        for out, e in zip(new_errs, es):
            out[k] = e
    return mean, new_errs


def init_error_state(grads_template: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for k, g in grads_template.items()}
