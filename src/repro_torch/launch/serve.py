"""Serving launcher: prefill a batch of prompts, then batched greedy
decode (port of ``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \
        [--smoke] [--batch 4 --prompt-len 32 --gen 16] [--device cuda]

Runs on the card unless ``--device cpu`` is given. Parameters are drawn
from seed 0 and prompts (and whisper's frames, phi-3-vision's patches)
from seed 1; the state is float32, as the reference launcher keeps it.
Prints the reference's two ``[serve]`` lines.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict

import torch

from repro_torch import configs as cfgreg
from repro_torch.models.layers import model_device
from repro_torch.models.model import ModelConfig, init_params, param_count
from repro_torch.models.serving import (decode_step, init_serve_state,
                                        prefill_step)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(cfg: ModelConfig, batch: int = 4, prompt_len: int = 32,
          gen: int = 16, device="cuda", model=None) -> Dict[str, Any]:
    """Prefill ``batch`` random prompts of ``prompt_len`` tokens, then
    decode ``gen - 1`` tokens greedily. ``model`` (built by
    ``init_params(cfg, 0)`` when not given) is reused as it is.

    Returns the generated ids (B, gen), the last logits, whether every
    logit of the run was finite, the parameter count, and the host
    times of prefill and decode (each ended by a synchronise)."""
    dev = model_device(device)
    if model is None:
        model = init_params(cfg, 0, device=dev)
    max_len = prompt_len + gen + (
        cfg.vision_patches if cfg.family == "vlm" else 0)
    state = init_serve_state(cfg, batch, max_len, torch.float32, device=dev)

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

    _sync(dev)
    t0 = time.perf_counter()
    logits, state = prefill_step(cfg, model, prompts, state, extras)
    finite = torch.isfinite(logits).all()
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    toks = logits.argmax(-1)[:, None]
    out = [toks]
    t0 = time.perf_counter()
    for _ in range(gen - 1):
        logits, state = decode_step(cfg, model, toks, state, {})
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
    args = ap.parse_args(argv)

    cfg = cfgreg.get_smoke(args.arch) if args.smoke \
        else cfgreg.get(args.arch)
    r = serve(cfg, args.batch, args.prompt_len, args.gen, args.device)
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
