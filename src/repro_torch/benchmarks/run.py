"""Run the port's benchmarks and keep their rows.

    PYTHONPATH=src python -m repro_torch.benchmarks.run [--smoke]
        [--device cpu] [--rows N]

Runs B1–B9 in the reference's order (``benchmarks/run.py``): B1
``fig2_exploration``, B2 ``objects_read``, B3 ``kernels_bench``, B4
``accuracy_sweep``, B5 ``adaptation_cost``, B6 ``heatmap_exploration``,
B7 ``serving_concurrency``, B8 ``streaming_exploration``, B9
``predictive_exploration``. Prints their ``name,us_per_call,derived``
rows and writes them to ``experiments/BENCH_torch_{smoke,full}.json``
(B1's per-query table to ``experiments/fig2_torch.csv``; both
git-ignored, the reference's own files are left alone). Runs on the card
unless ``--device cpu`` is given (the engines then run under
``"torch"``). ``--rows`` sizes the bench dataset (``common.configure``:
the query size scales with it). A failed gate raises, so the exit code
is non-zero.
"""
from __future__ import annotations

import argparse
import importlib
import json
import platform
import time
from pathlib import Path

import torch

EXPERIMENTS = Path(__file__).resolve().parents[3] / "experiments"
BENCHES = ("fig2_exploration", "objects_read", "kernels_bench",
           "accuracy_sweep", "adaptation_cost", "heatmap_exploration",
           "serving_concurrency", "streaming_exploration",
           "predictive_exploration")


def main(argv=None) -> Path:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="tiny sizes: same code paths, seconds not minutes")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int,
                    help="rows of the bench dataset (B1, B2, B4-B9)")
    args = ap.parse_args(argv)
    # the sizes must be set BEFORE the benches read them
    from . import common
    if args.smoke:
        common.configure_smoke()
    if args.rows:
        common.configure(args.rows)
    EXPERIMENTS.mkdir(parents=True, exist_ok=True)
    print("name,us_per_call,derived")
    for name in BENCHES:
        bench = importlib.import_module(f".{name}", __package__)
        if name == "fig2_exploration":
            bench.main(save_csv=EXPERIMENTS / "fig2_torch.csv",
                       device=args.device)
        else:
            bench.main(device=args.device)
    dev = torch.device(args.device)
    out = {
        "smoke": args.smoke,
        "rows_of_dataset": common.N_ROWS,
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "python": platform.python_version(),
        "torch": torch.__version__,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "rows": common.EMITTED,
    }
    path = EXPERIMENTS / f"BENCH_torch_{'smoke' if args.smoke else 'full'}.json"
    path.write_text(json.dumps(out, indent=1))
    print(f"# wrote {path} ({len(common.EMITTED)} rows)")
    return path


if __name__ == "__main__":
    main()
