"""Train launcher (port of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b \
        [--smoke] [--steps 50] [--batch 4 --seq 64] [--microbatches 1] \
        [--ckpt-dir DIR] [--device cuda]

Runs on the card unless ``--device cpu`` is given. ``--smoke`` trains
the reduced same-family configuration; without it the published one
(``python -m repro_torch.launch.train --arch starcoder2-3b --seq 4096
--microbatches 2`` fits one H100 80GB). Parameters are drawn from seed
0. The synthetic batches draw tokens (and whisper's frames,
phi-3-vision's patches, as bfloat16) from a CPU ``torch.Generator``
seeded with the step, so they differ from the reference launcher's
``jax.random`` draws; tests that compare the two packages feed both the
same numpy batches. Prints the reference's ``[train]`` lines.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import configs as cfgreg
from repro_torch.models.layers import model_device
from repro_torch.models.model import init_params, param_count
from repro_torch.optim import OptConfig
from repro_torch.runtime.train_loop import TrainLoopConfig, train_loop


def synthetic_batches(cfg, batch, seq):
    """``batch_fn(step)``: random tokens (B, seq) and their next tokens as
    labels, deterministic in ``step``, on the host."""
    def batch_fn(step):
        g = torch.Generator().manual_seed(step)
        toks = torch.randint(0, cfg.vocab, (batch, seq + 1), generator=g)
        b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.family == "encdec":
            b["frames"] = torch.randn(
                (batch, cfg.encoder_seq, cfg.d_model),
                generator=g).to(torch.bfloat16)
        if cfg.family == "vlm":
            b["patches"] = torch.randn(
                (batch, cfg.vision_patches, cfg.vision_d),
                generator=g).to(torch.bfloat16)
        return b
    return batch_fn


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=cfgreg.list_archs()
                    + list(cfgreg.ALIASES))
    ap.add_argument("--smoke", action="store_true",
                    help="train the reduced same-family config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = cfgreg.get_smoke(args.arch) if args.smoke \
        else cfgreg.get(args.arch)
    dev = model_device(args.device)
    print(f"[train] {cfg.name}: {param_count(cfg)/1e6:.1f}M params, "
          f"1 device(s) ({dev})")
    ocfg = OptConfig(lr=3e-4, warmup_steps=10, total_steps=args.steps)
    lcfg = TrainLoopConfig(steps=args.steps,
                           microbatches=args.microbatches,
                           ckpt_every=max(args.steps // 2, 1),
                           ckpt_dir=args.ckpt_dir, log_every=10)

    def on_log(row):
        print(f"  step {row['step']:4d} loss {row['loss']:.4f} "
              f"({row['time_s']*1e3:.0f} ms)")

    # handed over without a name here: the loop trains a copy, and the
    # drawn model is freed once the copy exists
    _, _, info = train_loop(cfg, ocfg, lcfg, init_params(cfg, 0, device=dev),
                            synthetic_batches(cfg, args.batch, args.seq),
                            hooks={"on_log": on_log})
    losses = [r["loss"] for r in info["history"]]
    print(f"[train] done: loss {losses[0]:.3f} → {losses[-1]:.3f}; "
          f"stragglers={len(info['stragglers'])}")
    return info


if __name__ == "__main__":
    main()
