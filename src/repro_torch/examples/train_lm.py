"""End-to-end example: train a 40M-parameter LM for a few hundred steps
with the full runtime (microbatching, checkpointing/restart, watchdog)
(port of ``examples/train_lm.py``).

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300] \
        [--ckpt DIR] [--device cpu]

The model is a scaled granite-family configuration (39.9 M parameters,
float32). Data is the reference's deterministic synthetic bigram
pipeline, drawn by numpy, so its batches equal the reference's bit for
bit; the loss should fall below the ln(vocab) random floor within a
few hundred steps. Runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from ..models.layers import model_device
from ..models.model import ModelConfig, init_params, param_count
from ..optim import OptConfig
from ..runtime.train_loop import TrainLoopConfig, train_loop


def make_config():
    return ModelConfig(
        name="granite-100m", family="dense",
        n_layers=8, d_model=512, n_heads=8, n_kv_heads=4,
        d_ff=2048, vocab=8192, dtype="float32", remat=False)


def token_pipeline(cfg, batch=8, seq=256):
    """Deterministic-by-step synthetic bigram language (int32 tokens on
    the host)."""
    trans = np.random.default_rng(0).integers(
        0, cfg.vocab, size=(cfg.vocab, 4))

    def batch_fn(step):
        rng = np.random.default_rng(step)          # replayable (FT)
        toks = np.empty((batch, seq + 1), np.int32)
        toks[:, 0] = rng.integers(0, cfg.vocab, batch)
        for t in range(seq):
            choice = rng.integers(0, 4, batch)
            noise = rng.random(batch) < 0.05
            nxt = trans[toks[:, t], choice]
            toks[:, t + 1] = np.where(
                noise, rng.integers(0, cfg.vocab, batch), nxt)
        return {"tokens": torch.from_numpy(toks[:, :-1].copy()),
                "labels": torch.from_numpy(toks[:, 1:].copy())}

    return batch_fn


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_train_lm"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = make_config()
    dev = model_device(args.device)
    print(f"model {cfg.name}: {param_count(cfg)/1e6:.1f}M params on {dev}")
    ocfg = OptConfig(lr=3e-4, warmup_steps=30, total_steps=args.steps)
    lcfg = TrainLoopConfig(steps=args.steps, microbatches=2,
                           ckpt_every=100, ckpt_dir=args.ckpt,
                           log_every=20)

    def on_log(row):
        print(f"step {row['step']:4d}  loss {row['loss']:.4f}  "
              f"lr {row['lr']:.2e}  {row['time_s']*1e3:.0f} ms")

    _, _, info = train_loop(cfg, ocfg, lcfg, init_params(cfg, 0, device=dev),
                            token_pipeline(cfg), hooks={"on_log": on_log})
    losses = [r["loss"] for r in info["history"]]
    print(f"\nloss: {losses[0]:.3f} → {losses[-1]:.3f} "
          f"(random floor ln({cfg.vocab}) = {np.log(cfg.vocab):.2f})")
    print(f"stragglers flagged: {len(info['stragglers'])}")
    print(f"checkpoints under {args.ckpt}: kill and re-run to resume.")
    return info


if __name__ == "__main__":
    main()
