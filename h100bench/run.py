"""The benchmark of the PyTorch and CUDA port on the H100.

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on the cards of this machine: its
configuration (``configs/``), its traffic (``traffic/``, which names the
driver in ``drivers/``), a window of ``--seconds``, the comparison with the
plain reference (``reference/``), and prints one JSON line last on stdout.
``--trace 1`` runs the window under torch.profiler and reports the cell's
per-layer metrics (``metrics/``) instead of its end-to-end ones.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def log(msg: str) -> None:
    print(f"[h100bench] {msg}", file=sys.stderr, flush=True)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from h100bench.harness import core
    from h100bench.harness import manifest as mf

    core.cache_env(ROOT)
    manifest = mf.Manifest.load()
    cell = manifest.cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"{cell.name} needs {cell.chips} CUDA card(s); this machine has {n}")
        return 2
    run = core.Run(cell, manifest, args.seed, args.seconds, bool(args.trace), T_PROCESS)
    driver = mf.load_module(mf.driver_path(run.traffic["driver"]))
    outcome = driver.run(run)
    for note in outcome.notes:
        log(note)
    found = core.forbidden_modules()
    if found:
        log(f"modules of JAX or of the JAX package were loaded: {', '.join(found)}")
        return 3
    for name, t in (("device", run.device_trace), ("operator", run.op_trace)):
        if t is not None:
            log(core.trace_summary(name, t))
    line = core.result_line(run, outcome, torch.cuda.get_device_name(0), log)
    log(f"card: {core.card_line()}; window {run.window_s:.3f} s, set-up {run.setup_s:.3f} s")
    core.print_checks(outcome.checks)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
