"""The reference's dry run (``repro.launch.dryrun``) on meshes of ``Auto``
axes, for comparing the port's dry run with it cell by cell.

Under jax 0.9, ``jax.make_mesh`` makes ``Explicit`` axes, and the
reference's ``shard_hint`` refuses them (ROADMAP C.1). This script runs
the reference's own ``main`` unchanged, its ``make_production_mesh``
replaced by one that passes ``axis_types=(AxisType.Auto,) * n``: the
single-pod ``(data=16, model=16)`` and multi-pod ``(pod=2, data=16,
model=16)`` meshes on XLA's fake host devices (the reference's dry run
asks for 512 of them when it is imported). ``--smoke`` takes the smoke
configurations, and ``--mesh-shape DxM`` a ``(data=D, model=M)`` mesh
instead of the production ones; its records are named ``meshDxM`` as
the port's dry run names them.

Records go to ``--out`` (default ``experiments/dryrun``), one
``<arch>__<shape>__<mesh>.json`` a cell, with the keys of the port's
(``python -m repro_torch.launch.dryrun``).

``--dots FILE`` runs nothing: it prints the matmul FLOPs of an HLO dump
that ``--keep-hlo`` kept (``<out>/<cell>.hlo``) by dot result and
operand shapes, trip-count weighted (``PERF.md`` §6's attribution of
cells under the reference's FLOPs).

``--compare DIR`` runs nothing: it prints, as a markdown table, each
cell of the port's records in ``DIR`` (``experiments/dryrun_torch``)
beside the reference's record of the same name in ``--out``: matmul
FLOPs, HBM bytes and collective bytes a device, port / reference and
their ratio, and memory a device; a row an (arch, mesh), a column a
shape.

Usage:
    PYTHONPATH=src python tools/reference_dryrun.py \\
        [--archs a,b] [--shapes s1,s2] [--mesh single|multi|both]
        [--out experiments/dryrun] [--smoke] [--mesh-shape 2x4]
    python tools/reference_dryrun.py --compare experiments/dryrun_torch \\
        [--out experiments/dryrun]
    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/reference_dryrun.py \\
        --dots experiments/dryrun/<arch>__<shape>__pod16x16.hlo
"""
import argparse
import collections
import glob
import json
import os
import re
import sys


def compare(port_dir: str, ref_dir: str) -> None:
    """Print the port's records beside the reference's (``--compare``):
    a row an (arch, mesh), a column a shape; in each cell matmul FLOPs
    (F), HBM bytes (H) and collective bytes (C) a device, port /
    reference (ratio), and memory a device in GiB, port / reference."""
    def num(rec, *keys):
        for k in keys:
            rec = rec[k]
        return float(rec)

    rows, shapes = {}, []
    for f in sorted(glob.glob(os.path.join(port_dir, "*.json"))):
        with open(f) as fh:
            port = json.load(fh)
        path = os.path.join(ref_dir, os.path.basename(f))
        if not os.path.exists(path):
            continue
        with open(path) as fh:
            ref = json.load(fh)
        shapes += [port["shape"]] if port["shape"] not in shapes else []
        cell = "skipped"
        if port.get("status") == "ok" and ref.get("status") == "ok":
            parts = []
            for tag, keys in (("F", ("hlo_analysis", "matmul_flops")),
                              ("H", ("hlo_analysis", "hbm_traffic_bytes")),
                              ("C", ("hlo_analysis", "collective_bytes"))):
                a, b = num(port, *keys), num(ref, *keys)
                ratio = f" ({a / b:.2f}×)" if b else ""
                parts.append(f"{tag} {a:.4g} / {b:.4g}{ratio}")
            a, b = (num(r, "memory", "total_bytes") / 2**30
                    for r in (port, ref))
            cell = "; ".join(parts) + f"; {a:.2f} / {b:.2f} GiB"
        rows.setdefault((port["arch"], port["mesh"]), {})[port["shape"]] = \
            cell
    from repro.configs.shapes import SHAPES
    shapes.sort(key=list(SHAPES).index)
    print("| arch, mesh | " + " | ".join(shapes) + " |")
    print("|---" * (len(shapes) + 1) + "|")
    for (arch, mesh), cells in rows.items():
        print(f"| {arch}, {mesh} | "
              + " | ".join(cells.get(sh, "—") for sh in shapes) + " |")


def dots(path: str, top: int = 12) -> None:
    """Print the matmul FLOPs of an HLO dump of the reference's dry run
    (``--keep-hlo``) by dot result and operand shapes, each weighted by
    its loop's trip count as the reference's ``analyze_hlo`` weights it
    (``--dots``)."""
    from repro.launch import hlo_analysis as H
    text = open(path).read()
    comps, entry = H._parse_computations(text)
    dims = {}
    for instrs in comps.values():
        for ins in instrs:
            m = H._SHAPE_RE.search(ins.line.split("=", 1)[1]) \
                if "=" in ins.line else None
            if m:
                dims[ins.name] = [int(d) for d in m.group(2).split(",")
                                  if d]
    # each computation's executions, as analyze_hlo's fixpoint counts them
    mult = collections.defaultdict(float)
    mult[entry] = 1.0
    for _ in range(64):
        new = collections.defaultdict(float)
        new[entry] = 1.0
        for name, instrs in comps.items():
            m = mult.get(name, 0.0)
            for ins in instrs if m else ():
                if ins.opcode == "while":
                    cond = re.search(r"condition=%?([\w\.\-]+)", ins.line)
                    body = re.search(r"body=%?([\w\.\-]+)", ins.line)
                    trips = H._trip_count(comps.get(cond.group(1), [])) \
                        if cond else 1
                    if body:
                        new[body.group(1)] += m * trips
                    if cond:
                        new[cond.group(1)] += m * (trips + 1)
                else:
                    for f in ins.called or ():
                        if f in comps:
                            new[f] += m
        if dict(new) == dict(mult):
            break
        mult = new
    by = collections.Counter()
    for name, instrs in comps.items():
        for ins in instrs:
            if ins.opcode == "dot" and mult.get(name):
                res = H._SHAPE_RE.search(ins.line.split("=", 1)[1]).group(0)
                ops = tuple(str(dims.get(o)) for o in ins.operands[:2])
                by[(res, ops)] += H._dot_flops(ins, dims) * mult[name]
    print(f"{path}: matmul FLOPs {sum(by.values()):.4g} a device")
    for (res, ops), f in by.most_common(top):
        print(f"  {f:12.4g} FLOPs  {res} = {' . '.join(ops)}")


def main(argv=None):
    ap = argparse.ArgumentParser(allow_abbrev=False)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--mesh-shape", default=None)
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--compare", default=None)
    ap.add_argument("--dots", default=None)
    args, rest = ap.parse_known_args(argv)
    if args.compare:
        return compare(args.compare, args.out)
    if args.dots:
        return dots(args.dots)

    from repro.launch import dryrun     # sets XLA_FLAGS before jax starts
    import jax
    from jax.sharding import AxisType

    from repro import configs

    if args.smoke:
        configs.get = configs.get_smoke
    if args.mesh_shape:
        d, m = (int(v) for v in args.mesh_shape.lower().split("x"))
        shape, axes = (d, m), ("data", "model")
        rest += ["--mesh", "single"]        # the last --mesh wins

        def make_mesh(*, multi_pod=False):
            return jax.make_mesh(shape, axes,
                                 axis_types=(AxisType.Auto,) * 2)
    else:
        def make_mesh(*, multi_pod=False):
            shape = (2, 16, 16) if multi_pod else (16, 16)
            axes = ("pod", "data", "model") if multi_pod \
                else ("data", "model")
            return jax.make_mesh(shape, axes,
                                 axis_types=(AxisType.Auto,) * len(axes))
    dryrun.make_production_mesh = make_mesh

    out = args.out
    if args.mesh_shape:     # written as pod16x16 by the reference's main
        out = os.path.join(args.out, ".pending")
        os.makedirs(out, exist_ok=True)
        for f in glob.glob(os.path.join(out, "*.json")):
            os.remove(f)
    try:
        dryrun.main(rest + ["--out", out])
    finally:
        if args.mesh_shape:
            name = f"mesh{shape[0]}x{shape[1]}"
            for f in glob.glob(os.path.join(out, "*__pod16x16.json")):
                with open(f) as fh:
                    rec = json.load(fh)
                rec["mesh"] = name
                base = os.path.basename(f)[:-len("pod16x16.json")]
                with open(os.path.join(args.out, base + name + ".json"),
                          "w") as fh:
                    json.dump(rec, fh, indent=1)
                os.remove(f)


if __name__ == "__main__":
    main(sys.argv[1:])
