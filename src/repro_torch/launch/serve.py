"""Serving launcher: prefill a batch of prompts, then batched greedy
decode (port of ``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \
        [--smoke] [--batch 4 --prompt-len 32 --gen 16] [--device cuda] \
        [--mesh]

Runs on the card unless ``--device cpu`` is given. Parameters are drawn
from seed 0 and prompts (and whisper's frames, phi-3-vision's patches)
from seed 1; the state is float32, as the reference launcher keeps it.
With ``--mesh`` it serves on ``launch.mesh.make_host_mesh``'s ``(1,
world)`` ``DeviceMesh``: DTensor parameters (``distribute_params``) and
state (``init_serve_state(..., mesh=)``) under
``layers.activation_mesh_scope``. Prints the reference's two ``[serve]``
lines.
"""
from __future__ import annotations

import argparse
import contextlib
import time
from typing import Any, Dict

import torch

from repro_torch import configs as cfgreg
from repro_torch.models.layers import (activation_mesh_scope, is_dtensor,
                                      model_device)
from repro_torch.models.model import ModelConfig, init_params, param_count
from repro_torch.models.serving import (decode_step, init_serve_state,
                                        prefill_step)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _whole(t):
    return t.full_tensor() if is_dtensor(t) else t


def serve(cfg: ModelConfig, batch: int = 4, prompt_len: int = 32,
          gen: int = 16, device="cuda", model=None,
          mesh=None) -> Dict[str, Any]:
    """Prefill ``batch`` random prompts of ``prompt_len`` tokens, then
    decode ``gen - 1`` tokens greedily. ``model`` (built by
    ``init_params(cfg, 0)`` when not given) is reused as it is; with a
    ``DeviceMesh`` ``mesh`` it is distributed onto it (in place) and the
    state is too, and the ids and logits come back whole.

    Returns the generated ids (B, gen), the last logits, whether every
    logit of the run was finite, the parameter count, and the host
    times of prefill and decode (each ended by a synchronise)."""
    dev = model_device(device)
    if model is None:
        model = init_params(cfg, 0, device=dev)
    if mesh is not None and not is_dtensor(next(model.parameters())):
        from repro_torch.models.sharding import distribute_params
        distribute_params(model, mesh)
    max_len = prompt_len + gen + (
        cfg.vision_patches if cfg.family == "vlm" else 0)
    state = init_serve_state(cfg, batch, max_len, torch.float32, device=dev,
                             mesh=mesh)

    g = torch.Generator(device=dev).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=g,
                            device=dev)
    extras = {}
    if cfg.family == "encdec":
        extras["frames"] = torch.randn(
            (batch, cfg.encoder_seq, cfg.d_model), generator=g, device=dev)
    if cfg.family == "vlm":
        extras["patches"] = torch.randn(
            (batch, cfg.vision_patches, cfg.vision_d), generator=g,
            device=dev)

    scope = activation_mesh_scope(mesh) if mesh is not None \
        else contextlib.nullcontext()
    with scope:
        _sync(dev)
        t0 = time.perf_counter()
        logits, state = prefill_step(cfg, model, prompts, state, extras)
        logits = _whole(logits)
        finite = torch.isfinite(logits).all()
        _sync(dev)
        t_prefill = time.perf_counter() - t0

        toks = logits.argmax(-1)[:, None]
        out = [toks]
        t0 = time.perf_counter()
        for _ in range(gen - 1):
            logits, state = decode_step(cfg, model, toks, state, {})
            logits = _whole(logits)
            finite &= torch.isfinite(logits).all()
            toks = logits.argmax(-1)[:, None]
            out.append(toks)
        _sync(dev)
        t_decode = time.perf_counter() - t0
    return {"ids": torch.cat(out, dim=1), "logits": logits,
            "finite": bool(finite), "params": param_count(cfg),
            "prefill_s": t_prefill, "decode_s": t_decode, "state": state}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", action="store_true",
                    help="serve on the (1, world) DeviceMesh of this host")
    args = ap.parse_args(argv)

    cfg = cfgreg.get_smoke(args.arch) if args.smoke \
        else cfgreg.get(args.arch)
    mesh = None
    if args.mesh:
        from repro_torch.launch.mesh import make_host_mesh
        mesh = make_host_mesh(args.device)
    r = serve(cfg, args.batch, args.prompt_len, args.gen, args.device,
              mesh=mesh)
    steps = args.gen - 1
    t_prefill, t_decode = r["prefill_s"], r["decode_s"]
    print(f"[serve] {cfg.name}: prefill {args.batch}×{args.prompt_len} "
          f"in {t_prefill*1e3:.1f} ms; "
          f"decode {steps} steps in {t_decode*1e3:.1f} ms "
          f"({t_decode/max(steps, 1)*1e3:.1f} ms/tok)")
    print(f"[serve] sample continuation ids: "
          f"{r['ids'][0][:10].tolist()}")
    return r


if __name__ == "__main__":
    main()
