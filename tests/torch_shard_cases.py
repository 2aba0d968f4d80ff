"""The LM substrate's sharded cases, run by every rank of one
``torch.distributed`` gloo group on a ``(data=2, model=4)``
``DeviceMesh`` (``tests/test_torch_sharded_train.py`` spawns the
ranks once and reads rank 0's record).

For each configuration of ``ARCHS`` (float32 smoke): one
``make_train_step`` with ``grad_shardings`` (and ``mb_shardings``, in
``MICROBATCHES[arch]`` = 2 microbatches) — its loss (the sharded loss
of each microbatch, averaged), its grad_norm,
and its first moments (0.1 × the clipped accumulated gradient, each
leaf pinned to its parameter's placements); then one ``opt_update`` on
the DTensor leaves with the unsharded gradients (``batch_grads``' own,
distributed). For granite also the sharded loss with the
``fsdp_use_hint`` toggle on and off, and the stepped state saved (the
checkpoint holds it whole) and restored onto the ranks' mesh with
``runtime.elastic.load_for_mesh``: each rank's shards against its own,
byte for byte. Then, for each configuration of ``GRAD_ARCHS``, the
sharded loss and the gradient of every parameter (``batch_grads`` on
``distribute_params`` / ``distribute_batch``): starcoder2's 6 heads and
2 KV heads do not divide the model axis (ROADMAP C.17), and whisper's
encoder and cross-attention are what C.15c broke, and gemma's tied head
makes its logits from the vocab-sharded embedding table (the head and
the cross entropy vocab-parallel, C.18). Then the
expert-parallel MoE layer of ``moe_case`` on the ranks. Every value is
saved whole (``full_tensor``) by rank 0.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

ARCHS = ("granite-8b", "deepseek-moe-16b", "jamba-1.5-large-398b",
         "rwkv6-7b")
# two microbatches exercise mb_shardings; the heavier two take one
MICROBATCHES = {"granite-8b": 2, "deepseek-moe-16b": 2,
                "jamba-1.5-large-398b": 1, "rwkv6-7b": 1}
GRAD_ARCHS = ("starcoder2-3b", "starcoder2-15b", "whisper-small", "gemma-7b")
MESH = (2, 4)
OPT = dict(lr=1e-3, warmup_steps=0, total_steps=10)


def smoke_cfg(arch):
    from repro_torch import configs
    return dataclasses.replace(configs.get_smoke(arch), dtype="float32")


def batch_np(cfg, n=4, seq=16):
    rng = np.random.default_rng(1)
    b = {k: rng.integers(0, cfg.vocab, (n, seq)) for k in ("tokens",
                                                           "labels")}
    b["labels"][1, -4:] = -100
    return b


def grad_batch_np(cfg):
    """``batch_np`` with whisper's encoder input (float32 frames)."""
    b = batch_np(cfg)
    if cfg.family == "encdec":
        b["frames"] = np.random.default_rng(2).normal(
            size=(4, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return b


def model_np(cfg):
    from repro_torch.models.model import init_params, params_to_numpy
    return params_to_numpy(init_params(cfg, 0, device="cpu"))


def batch_grads(cfg, model, batch):
    """Loss and ``{name: gradient}`` of ``model`` on ``batch``."""
    from repro_torch.models.model import loss_fn
    names, params = zip(*model.named_parameters())
    loss, _ = loss_fn(cfg, model, batch)
    return loss, dict(zip(names, torch.autograd.grad(loss, params)))


def moe_case():
    """The reference's multi-device MoE case
    (``tests/test_distributed.py``): dims, params and input."""
    from repro_torch.models import moe as MOE
    dims = MOE.MoEDims(n_experts=8, top_k=2, d_expert=32, n_shared=1,
                       capacity_factor=8.0)
    p = MOE.init_moe(16, dims, torch.float32, device="cpu",
                     gen=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(4, 8, 16)).astype(np.float32))
    return dims, p, x


def same_bytes(a, b):
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(ints[a.element_size()]),
        b.contiguous().view(ints[b.element_size()]))


def host_state(model, opt):
    """The reference-layout ``(params, opt_state)`` tree of a sharded
    model, each leaf gathered whole to the host (a collective)."""
    from repro_torch.checkpoint.ckpt import _to_host
    from repro_torch.models.model import stack_named

    def tree(items):
        return stack_named((n, _to_host(t)) for n, t in items)
    return (tree(model.named_parameters()),
            {"m": tree(opt["m"].items()), "v": tree(opt["v"].items()),
             "step": _to_host(opt["step"])})


def elastic(cfg, ocfg, mesh, model, opt, ckpt_dir, rank):
    """Save the sharded state, restore it onto ``mesh``: every rank's
    shards equal its own (1) or not (0), reduced over the ranks."""
    import torch.distributed as tdist
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.models.model import abstract_params
    from repro_torch.optim import init_opt_state
    from repro_torch.runtime.elastic import load_for_mesh
    from repro_torch.runtime.train_loop import train_state_tree
    host = host_state(model, opt)
    if rank == 0:
        save_checkpoint(ckpt_dir, 3, host, meta={"model": cfg.name})
    tdist.barrier()
    meta = abstract_params(cfg)
    template = train_state_tree(meta, init_opt_state(meta, ocfg), "meta")
    params, moments, step, _ = load_for_mesh(ckpt_dir, template, cfg, mesh)
    ok = step == 3 and int(moments["step"].full_tensor()) == \
        int(opt["step"])
    for n, p in model.named_parameters():
        for got, want in ((params[n], p), (moments["m"][n], opt["m"][n]),
                          (moments["v"][n], opt["v"][n])):
            ok &= tuple(got.placements) == tuple(want.placements) and \
                same_bytes(got.to_local(), want.to_local())
    flag = torch.tensor([int(ok)])
    tdist.all_reduce(flag, op=tdist.ReduceOp.MIN)
    return flag.numpy()


def full(t):
    from repro_torch.models.layers import is_dtensor
    t = t.detach()
    return (t.full_tensor() if is_dtensor(t) else t).numpy().copy()


def rank_main(rank, world, store, out_path):
    import torch.distributed as tdist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.models import sharding as SH
    from repro_torch.models import layers as L
    from repro_torch.models.layers import activation_mesh_scope
    from repro_torch.models.model import (abstract_params, loss_fn,
                                          params_from_numpy)
    from repro_torch.models.moe import moe_ffn_sharded
    from repro_torch.optim import OptConfig, init_opt_state, opt_update
    from repro_torch.runtime.train_loop import make_train_step
    torch.set_num_threads(1)
    tdist.init_process_group("gloo", init_method=f"file://{store}",
                             world_size=world, rank=rank)
    rec = {}
    try:
        mesh = init_device_mesh("cpu", MESH,
                                mesh_dim_names=("data", "model"))
        ocfg = OptConfig(**OPT)
        for arch in ARCHS:
            cfg = smoke_cfg(arch)
            tree, bnp = model_np(cfg), batch_np(cfg)
            batch = {k: torch.from_numpy(v) for k, v in bnp.items()}

            def sharded():
                return SH.distribute_params(
                    params_from_numpy(cfg, tree, "cpu"), mesh)
            pl = SH.param_placements(abstract_params(cfg), mesh)
            bspecs = SH.batch_specs(cfg, mesh, 4)
            mb_pl = {k: SH.placements(SH.P(None, *bspecs[k]), mesh)
                     for k in batch}
            with activation_mesh_scope(mesh):
                model = sharded()
                opt = init_opt_state(model, ocfg)
                step = make_train_step(cfg, ocfg, MICROBATCHES[arch],
                                       grad_shardings=pl,
                                       mb_shardings=mb_pl)
                _, opt, met = step(model, opt,
                                   SH.distribute_batch(cfg, mesh, batch))
                for k in ("loss", "grad_norm"):
                    rec[f"{arch}:step:{k}"] = full(met[k])
                for n, m in opt["m"].items():
                    assert tuple(m.placements) == pl[n], n
                    rec[f"{arch}:step:m:{n}"] = full(m)
            if arch == "granite-8b":
                rec["elastic:equal"] = elastic(cfg, ocfg, mesh, model, opt,
                                               out_path + ".ckpt", rank)
                for on in (True, False):
                    L.OPT["fsdp_use_hint"] = on
                    with activation_mesh_scope(mesh):
                        loss, _ = loss_fn(cfg, sharded(),
                                          SH.distribute_batch(cfg, mesh,
                                                              batch))
                    rec[f"granite:loss:fsdp_use_hint={on}"] = full(loss)
                L.OPT["fsdp_use_hint"] = True
            # one opt_update on the DTensor leaves, unsharded gradients
            plain = params_from_numpy(cfg, tree, "cpu")
            _, g_plain = batch_grads(cfg, plain, batch)
            model = sharded()
            opt = init_opt_state(model, ocfg)
            with activation_mesh_scope(mesh):
                opt_update(model, {n: SH.distribute(g, mesh, pl[n])
                                   for n, g in g_plain.items()}, opt, ocfg)
            for n, p in model.named_parameters():
                rec[f"{arch}:opt:param:{n}"] = full(p)
        for arch in GRAD_ARCHS:
            cfg = smoke_cfg(arch)
            batch = {k: torch.from_numpy(v)
                     for k, v in grad_batch_np(cfg).items()}
            model = SH.distribute_params(
                params_from_numpy(cfg, model_np(cfg), "cpu"), mesh)
            with activation_mesh_scope(mesh):
                loss, grads = batch_grads(
                    cfg, model, SH.distribute_batch(cfg, mesh, batch))
            rec[f"{arch}:grad:loss"] = full(loss)
            for n, g in grads.items():
                rec[f"{arch}:grad:{n}"] = full(g)
        dims, p, x = moe_case()
        SH.distribute_params(p, mesh, {
            n: SH.placements(SH.leaf_spec("moe." + n, t.shape, mesh), mesh)
            for n, t in p.named_parameters()})
        with activation_mesh_scope(mesh):
            out, aux = moe_ffn_sharded(
                p, SH.distribute(x, mesh, SH.placements(
                    SH.P(("data",), None, None), mesh)), dims, mesh)
        rec["moe:out"], rec["moe:aux"] = full(out), full(aux)
        if rank == 0:
            np.savez(out_path, **rec)
    finally:
        tdist.destroy_process_group()
