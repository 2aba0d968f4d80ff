"""The LM substrate's serving under a mesh, run by every rank of one
``torch.distributed`` gloo group on a ``(data=2, model=4)``
``DeviceMesh`` (``tests/test_torch_sharded_serve.py`` spawns the ranks
once and reads rank 0's record).

For each configuration of ``ARCHS`` (float32 smoke): DTensor
parameters (``distribute_params``) and a DTensor state
(``init_serve_state(..., mesh=)``), then prefill of ``PREFILL`` tokens
and ``DECODE`` decode steps through ``launch.steps.build_step``'s
prefill and decode functions. Recorded whole (``full_tensor``) by rank
0: the logits of each step, every leaf of the last state
(``serve_state_to_numpy``), whether every leaf kept the placements of
``serve_state_specs``, and, for granite, whether a decode past
``max_len`` raised on the mesh.
"""
from __future__ import annotations

import numpy as np
import torch

ARCHS = ("granite-8b", "starcoder2-3b", "rwkv6-7b", "jamba-1.5-large-398b",
         "whisper-small")
MESH = (2, 4)
B, PREFILL, DECODE, MAX_LEN = 4, 8, 3, 16


def smoke_cfg(arch):
    import torch_shard_cases
    return torch_shard_cases.smoke_cfg(arch)


def inputs_np(cfg):
    """The tokens (B, PREFILL + DECODE) and the extras (whisper's
    frames)."""
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab, (B, PREFILL + DECODE))
    extras = {}
    if cfg.family == "encdec":
        extras["frames"] = rng.normal(
            size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return toks, extras


def run(cfg, model, state, toks, extras, prefill, decode, put=None):
    """Prefill then ``DECODE`` decode steps: the logits of each step and
    the last state. ``put`` places an input (the identity by default)."""
    put = put or (lambda name, t: t)
    toks = torch.from_numpy(toks)
    ex = {k: put(k, torch.from_numpy(v)) for k, v in extras.items()}
    logits, state = prefill(model, put("tokens", toks[:, :PREFILL]), state,
                            ex)
    out = [logits]
    for i in range(PREFILL, PREFILL + DECODE):
        logits, state = decode(model, put("tokens", toks[:, i:i + 1]),
                               state)
        out.append(logits)
    return out, state


def flat_state(tree, prefix="state"):
    """``{"state/blocks/s0/k": array, ...}`` of a numpy state tree."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_state(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


def placed_as_specs(state, mesh) -> bool:
    from repro_torch.models import sharding as SH
    specs = SH.serve_state_specs(None, mesh, state)

    def walk(node, spec):
        if isinstance(node, dict):
            return all(walk(v, spec[k]) for k, v in node.items())
        if isinstance(node, list):
            return all(walk(v, s) for v, s in zip(node, spec))
        if not isinstance(node, torch.Tensor):
            return True
        return tuple(node.placements) == SH.placements(spec, mesh)
    return walk(state, specs)


def rank_main(rank, world, store, out_path):
    import torch.distributed as tdist
    from torch.distributed.device_mesh import init_device_mesh

    import torch_shard_cases as shard
    from repro_torch.launch.steps import build_step
    from repro_torch.models import sharding as SH
    from repro_torch.models.model import params_from_numpy
    from repro_torch.models.serving import (init_serve_state,
                                            serve_state_to_numpy)
    torch.set_num_threads(1)
    tdist.init_process_group("gloo", init_method=f"file://{store}",
                             world_size=world, rank=rank)
    rec = {}
    try:
        mesh = init_device_mesh("cpu", MESH,
                                mesh_dim_names=("data", "model"))
        for arch in ARCHS:
            cfg = smoke_cfg(arch)
            model = SH.distribute_params(
                params_from_numpy(cfg, shard.model_np(cfg), "cpu"), mesh)
            specs = SH.batch_specs(cfg, mesh, B)

            def put(name, t):
                return SH.distribute(t, mesh, SH.placements(specs[name],
                                                            mesh))
            prefill = build_step(cfg, "prefill_32k", mesh)[0]
            decode = build_step(cfg, "decode_32k", mesh)[0]
            state = init_serve_state(cfg, B, MAX_LEN, torch.float32,
                                     device="cpu", mesh=mesh)
            toks, extras = inputs_np(cfg)
            logits, state = run(cfg, model, state, toks, extras, prefill,
                                decode, put)
            for i, lg in enumerate(logits):
                rec[f"{arch}:logits:{i}"] = shard.full(lg)
            rec[f"{arch}:placed"] = np.asarray(placed_as_specs(state, mesh))
            for k, v in flat_state(serve_state_to_numpy(state)).items():
                rec[f"{arch}:{k}"] = v
            if arch == "granite-8b":
                state["pos"] = MAX_LEN
                try:
                    decode(model, put("tokens", torch.zeros(
                        (B, 1), dtype=torch.long)), state)
                    raised = False
                except ValueError:
                    raised = True
                rec["granite:overflow_raised"] = np.asarray(raised)
        if rank == 0:
            np.savez(out_path, **rec)
    finally:
        tdist.destroy_process_group()
