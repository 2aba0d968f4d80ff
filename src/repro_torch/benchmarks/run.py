"""Run the port's benchmarks and keep their rows.

    PYTHONPATH=src python -m repro_torch.benchmarks.run [--smoke] [--device cpu]

Prints ``name,us_per_call,derived`` rows (B3, the kernels bench, for
now) and writes them to ``experiments/BENCH_torch_{smoke,full}.json``
(git-ignored; the reference's ``BENCH_*.json`` names are left alone).
Runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import json
import platform
import time
from pathlib import Path

import torch

EXPERIMENTS = Path(__file__).resolve().parents[3] / "experiments"


def main(argv=None) -> Path:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="tiny sizes: same code paths, seconds not minutes")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    # the smoke switch must be set BEFORE the benches read their sizes
    from . import common
    if args.smoke:
        common.configure_smoke()
    from . import kernels_bench
    print("name,us_per_call,derived")
    kernels_bench.main(device=args.device)
    dev = torch.device(args.device)
    out = {
        "smoke": args.smoke,
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "python": platform.python_version(),
        "torch": torch.__version__,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "rows": common.EMITTED,
    }
    EXPERIMENTS.mkdir(parents=True, exist_ok=True)
    path = EXPERIMENTS / f"BENCH_torch_{'smoke' if args.smoke else 'full'}.json"
    path.write_text(json.dumps(out, indent=1))
    print(f"# wrote {path} ({len(common.EMITTED)} rows)")
    return path


if __name__ == "__main__":
    main()
