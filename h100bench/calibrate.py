"""Readings for the limits of ``correct``: the precision control (and, for
training, a planted fault) on the seeds given, at the cell's own size.

    python3 h100bench/calibrate.py --workload <cell> --seeds 11 12 13

Prints one JSON line a seed: ``{"seed": n, "<reading>": {"<check>": value}}``
from the cell driver's ``calibrate(run)``. The program's own readings come
from the benchmark's runs (each prints its checks).
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from h100bench.harness import core
    from h100bench.harness import manifest as mf

    core.cache_env(ROOT)
    manifest = mf.Manifest.load()
    cell = manifest.cell(args.workload)
    for seed in args.seeds:
        run = core.Run(cell, manifest, seed, 0.0, False, time.perf_counter(), device=args.device)
        driver = mf.load_module(mf.driver_path(run.traffic["driver"]))
        t0 = time.perf_counter()
        readings = driver.calibrate(run)
        print(json.dumps({"seed": seed, **readings, "seconds": time.perf_counter() - t0}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
