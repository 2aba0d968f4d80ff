"""Phase 13's sharded checks of ``chip_smoke.py`` alone, on one tree, on
a one-rank NCCL ``(data=1, model=1)`` mesh (needs one card).

- ``full LAYERS``: 13e-ii, ``LM_FULL`` (granite-8b) at full width in
  bfloat16 (``LAYERS`` its depth, 0 the published one), served plain
  and under the mesh: prefill ms, ms a decode token, relative RMS of the
  logits. One JSON line.
- ``smoke``: for each smoke configuration, 13c (the DTensor loss,
  gradients, step and update against the plain card path) and 13e-i
  (prefill and decode under the mesh against plain). One JSON line each.

To compare two trees on one card, run it on each in turns, each in a
process of its own (parent, change, change, parent), with the other
tree unpacked by ``git archive`` into a git-ignored directory:

    python tools/phase13_alone.py _archive/parent full 0
    python tools/phase13_alone.py . full 0
"""
import json
import os
import sys
import time


def main(root, what, layers="0"):
    root = os.path.abspath(root)
    sys.path[:0] = [os.path.join(root, "src"), root]
    os.chdir(root)
    import torch
    import torch.distributed as tdist
    from torch.distributed.device_mesh import init_device_mesh

    import chip_smoke as C
    from repro_torch import configs

    store = os.path.join(os.environ.get("TMPDIR", "/tmp"),
                         f"nccl-store-{os.getpid()}")
    tdist.init_process_group("nccl", init_method=f"file://{store}",
                             world_size=1, rank=0)
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        print(json.dumps({"tree": root, "card": C.card_line()}), flush=True)
        if what == "smoke":
            torch.backends.cuda.matmul.allow_tf32 = False
            for arch in configs.list_archs():
                t0 = time.perf_counter()
                shard, ok_shard = C.shard_smoke_on_card(torch, arch, mesh)
                serve, ok_serve = C.serve_smoke_on_mesh(torch, arch, mesh)
                print(json.dumps({"arch": arch, "13c": shard,
                                  "13c_ok": ok_shard, "13e-i": serve,
                                  "13e-i_ok": ok_serve,
                                  "s": time.perf_counter() - t0}),
                      flush=True)
        else:
            out, ok = C.serve_full_on_mesh(torch, mesh, int(layers))
            print(json.dumps({"ok": ok, **{k: v for k, v in out.items()
                                            if not k.endswith("_ids")}}),
                  flush=True)
    finally:
        tdist.destroy_process_group()
        if os.path.exists(store):
            os.remove(store)


if __name__ == "__main__":
    main(*sys.argv[1:])
