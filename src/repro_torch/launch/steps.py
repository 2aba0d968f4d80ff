"""Step builders: (arch × shape × mesh) → step function + abstract
inputs + specs (port of ``repro/launch/steps.py``).

``build_step`` returns the step of one cell, its inputs as tensors on
the ``meta`` device (shapes and dtypes, no allocation) and the in/out
partition specs (``models.sharding``), on any mesh — the 256- and
512-chip production meshes are device-free (``launch.mesh``). The step
runs under ``layers.activation_mesh_scope`` of that mesh; on a
``DeviceMesh`` the training step pins its gradients and microbatches by
the specs' placements.

  train  : (model, opt_state, batch) → (model, opt_state, metrics)
  prefill: (model, tokens, state, extras) → (logits, state)
  decode : (model, tokens, state) → (logits, state)

The reference's rules are kept: bfloat16 moments (and accumulator) above
5·10¹⁰ parameters, ``microbatches_for`` the data-parallel size, and its
input shapes and dtypes (int32 tokens, bfloat16 frames and patches).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..configs.shapes import SHAPES, ShapeCell, microbatches_for
from ..models import sharding as SH
from ..models.layers import activation_mesh_scope
from ..models.model import ModelConfig, abstract_params, param_count
from ..models.serving import decode_step, init_serve_state, prefill_step
from ..optim import OptConfig, init_opt_state
from ..runtime.train_loop import make_train_step

META = torch.device("meta")


def _struct(shape, dtype):
    return torch.empty(shape, dtype=dtype, device=META)


def _batch_struct(cfg: ModelConfig, shape: ShapeCell) -> Dict[str, Any]:
    """``meta`` stand-ins for every model input (no allocation)."""
    b, s = shape.batch, shape.seq
    if shape.kind == "decode":     # one new token against a seq cache
        return {"tokens": _struct((b, 1), torch.int32)}
    text = s - (cfg.vision_patches if cfg.family == "vlm" else 0)
    d = {"tokens": _struct((b, text), torch.int32)}
    if shape.kind == "train":
        d["labels"] = _struct((b, text), torch.int32)
    if cfg.family == "encdec":
        d["frames"] = _struct((b, cfg.encoder_seq, cfg.d_model),
                              torch.bfloat16)
    if cfg.family == "vlm":
        d["patches"] = _struct((b, cfg.vision_patches, cfg.vision_d),
                               torch.bfloat16)
    return d


def input_specs(cfg: ModelConfig, shape_name: str) -> Dict[str, Any]:
    """Abstract inputs for an (arch, shape): ``meta`` tensors."""
    return _batch_struct(cfg, SHAPES[shape_name])


def _is_device_mesh(mesh) -> bool:
    return getattr(mesh, "mesh_dim_names", None) is not None


def build_step(cfg: ModelConfig, shape_name: str, mesh,
               opt_cfg: OptConfig = None, *, size_of: ModelConfig = None):
    """Returns (fn, example_args (abstract), in_specs, out_specs).
    ``size_of`` (default ``cfg``) is the configuration whose parameter
    count picks the moments' dtype (the dry run builds cut-down depths
    of a configuration)."""
    shape = SHAPES[shape_name]
    if opt_cfg is None:
        # ≥50B params: bf16 optimizer moments (halves ZeRO state)
        big = param_count(size_of or cfg) > 50e9
        opt_cfg = OptConfig(state_dtype="bfloat16" if big else "float32")
    else:
        big = False
    dp = SH.mesh_axis_size(mesh, SH.dp_axes(mesh) or None)
    pspecs = SH.param_specs(cfg, mesh)
    bspecs = SH.batch_specs(cfg, mesh, shape.batch)
    params_abs = abstract_params(cfg)

    if shape.kind == "train":
        m = microbatches_for(cfg, shape, dp)
        batch_abs = _batch_struct(cfg, shape)
        grad_sh = mb_sh = None
        if _is_device_mesh(mesh):
            grad_sh = {n: SH.placements(s, mesh) for n, s in pspecs.items()}
            mb_sh = {k: SH.placements(SH.P(None, *bspecs[k]), mesh)
                     for k in batch_abs}
        step0 = make_train_step(
            cfg, opt_cfg, microbatches=m, grad_shardings=grad_sh,
            mb_shardings=mb_sh,
            accum_dtype=torch.bfloat16 if big else torch.float32)

        def step(model, opt_state, batch):
            with activation_mesh_scope(mesh):
                return step0(model, opt_state, batch)

        opt_abs = init_opt_state(params_abs, opt_cfg)
        ospecs = {"m": pspecs, "v": pspecs, "step": SH.P()}
        bsp = {k: bspecs[k] for k in batch_abs}
        return step, (params_abs, opt_abs, batch_abs), \
            (pspecs, ospecs, bsp), (pspecs, ospecs, None)

    # serving cells
    state_abs = init_serve_state(cfg, shape.batch, shape.seq,
                                 torch.bfloat16, device=META)
    sspecs = SH.serve_state_specs(cfg, mesh, state_abs)
    batch_abs = _batch_struct(cfg, shape)
    extras_abs = {k: v for k, v in batch_abs.items() if k != "tokens"}
    especs = {k: bspecs[k] for k in extras_abs}
    logits_spec = SH.P(*bspecs["tokens"])

    if shape.kind == "prefill":
        def fn(model, tokens, state, extras):
            with activation_mesh_scope(mesh):
                return prefill_step(cfg, model, tokens, state, extras)
        args = (params_abs, batch_abs["tokens"], state_abs, extras_abs)
        return fn, args, (pspecs, bspecs["tokens"], sspecs, especs), \
            (logits_spec, sspecs)

    def fn(model, tokens, state):
        with activation_mesh_scope(mesh):
            return decode_step(cfg, model, tokens, state)
    args = (params_abs, batch_abs["tokens"], state_abs)
    return fn, args, (pspecs, bspecs["tokens"], sspecs), \
        (logits_spec, sspecs)
