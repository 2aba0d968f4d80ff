"""Where a dry-run cell's numbers come from (``PERF.md`` §6): the port's
step by op, and its peak at several depths.

    PYTHONPATH=src python tools/dryrun_attribution.py port ARCH SHAPE \\
        [--mesh single|multi|DxM] [--blocks 1] [--smoke]
    PYTHONPATH=src python tools/dryrun_attribution.py peaks ARCH SHAPE \\
        [--mesh ...] [--depths 1,2,3,4] [--smoke]

``port`` runs the cell's step once at ``--blocks`` superblocks (Mamba
and RWKV scans at ``launch.dryrun.K1`` steps, as ``measure_cell`` runs
them) under ``launch.hlo_analysis.StepCounter`` on a fake process group,
and prints its matmul FLOPs a device by op and operand shapes and its
collective bytes by kind and operand shape, largest first. ``peaks``
prints the peak of live storage (``temp_bytes``) of a run at each of
``--depths`` superblocks, beside the lines through 1 and 2 and through 2
and 3 (``dryrun.peak_rule``). The reference's compiled step by dot:
``tools/reference_dryrun.py --dots``.
"""
import argparse
import collections
import sys


def _mesh(name):
    from repro_torch.core.mesh import AbstractMesh
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    if name in ("single", "multi"):
        abstract = make_production_mesh(multi_pod=name == "multi")
    else:
        d, m = (int(v) for v in name.lower().split("x"))
        abstract = AbstractMesh((d, m), ("data", "model"))
    return dryrun.fake_device_mesh(abstract)


def _cell(args):
    from repro_torch import configs
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.launch import dryrun
    cfg = (configs.get_smoke if args.smoke else configs.get)(args.arch)
    shape = SHAPES[args.shape]
    scans = cfg.mixer in ("rwkv", "mamba_hybrid") and \
        shape.kind != "decode" and shape.seq > dryrun.K2
    return cfg, dryrun.K1 if scans else None


def _run(cfg, args, mesh, blocks, steps):
    from repro_torch.launch import dryrun
    from repro_torch.models import layers as L
    L.SCAN_STEPS = steps
    try:
        return dryrun._measure(dryrun._cut(cfg, blocks), args.shape, mesh,
                               cfg)
    finally:
        L.SCAN_STEPS = None


def port(args):
    from repro_torch.launch import hlo_analysis as H
    flops, colls = collections.Counter(), collections.Counter()

    class Recording(H.StepCounter):
        def __torch_dispatch__(self, func, types, args_=(), kwargs=None):
            before = (self.flops, dict(self.coll_by_type))
            out = super().__torch_dispatch__(func, types, args_, kwargs)
            if out is NotImplemented or self._propagating:
                return out
            shapes = tuple(tuple(a.shape) for a in args_
                           if hasattr(a, "shape"))
            if self.flops != before[0]:
                flops[(func.__name__, shapes)] += self.flops - before[0]
            for kind, nbytes in self.coll_by_type.items():
                if nbytes != before[1].get(kind, 0.0):
                    colls[(kind, shapes[:1])] += \
                        nbytes - before[1].get(kind, 0.0)
            return out

    H.StepCounter = Recording
    cfg, steps = _cell(args)
    nums = _run(cfg, args, _mesh(args.mesh), args.blocks, steps)
    print(f"{cfg.name} {args.shape} at {args.blocks} superblock(s): "
          f"matmul FLOPs {nums['matmul_flops']:.4g}, collective bytes "
          f"{nums['collective_bytes']:.4g} a device")
    for (op, shapes), f in flops.most_common(args.top):
        print(f"  {f:12.4g} FLOPs  {op} {shapes}")
    for (kind, shape), b in colls.most_common(args.top):
        print(f"  {b:12.4g} bytes  {kind} {shape}")


def peaks(args):
    from repro_torch.launch import dryrun
    cfg, steps = _cell(args)
    mesh = _mesh(args.mesh)
    depths = [int(v) for v in args.depths.split(",")]
    got = {n: _run(cfg, args, mesh, n, steps)["temp_bytes"]
           for n in depths}
    gib = 2 ** 30
    for n in depths:
        line = [f"{cfg.name} {args.shape}: {n} superblock(s) "
                f"{got[n] / gib:.3f} GiB"]
        if 1 in got and 2 in got:
            old = got[1] + (n - 1) * (got[2] - got[1])
            line.append(f"line through 1 and 2 {old / gib:.3f}")
        if 2 in got and 3 in got and n >= 3:
            new = dryrun.peak_rule(n, [got.get(1, 0), got[2], got[3]])
            line.append(f"through 2 and 3 (peak_rule) {new / gib:.3f}")
        print(", ".join(line))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="mode", required=True)
    for mode in ("port", "peaks"):
        p = sub.add_parser(mode)
        p.add_argument("arch")
        p.add_argument("shape")
        p.add_argument("--mesh", default="single")
        p.add_argument("--smoke", action="store_true")
        p.add_argument("--top", type=int, default=12)
    sub.choices["port"].add_argument("--blocks", type=int, default=1)
    sub.choices["peaks"].add_argument("--depths", default="1,2,3,4")
    args = ap.parse_args(argv)
    {"port": port, "peaks": peaks}[args.mode](args)


if __name__ == "__main__":
    main(sys.argv[1:])
