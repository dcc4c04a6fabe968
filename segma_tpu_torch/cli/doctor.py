"""Environment diagnostics (counterpart of ``segma_tpu/cli/doctor.py``):

    python -m segma_tpu_torch.cli.doctor [--config cfg.yml] [--probe-timeout S]

One command that says whether a machine is ready to train or serve: the
versions, the card, a timed round-trip to it with a real data dependency,
the kernel library's build state (built, stale or absent, and whether
``nvcc`` is there to build it), the native WAV reader, host memory, and with
``--config`` the (data, seq, model) mesh its ``mesh`` section resolves to
over the visible cards (``parallel.make_mesh``), how serving and training
run over it (``parallel.mesh.describe``), and whether its
``train.dispatch`` trains over it as ``cli.train`` starts it there, one NCCL
rank per card (``parallel.mesh.check_dispatch``, which refuses epoch
dispatch only over gloo ranks on cards with seq or model above 1). Exit
code 0: healthy;
1: a check failed (so 1 on a machine without a card).
"""

from __future__ import annotations

import argparse
import threading
import time


def _row(name: str, ok: bool, detail: str) -> bool:
    print(f"[{'ok ' if ok else 'FAIL'}] {name:<18} {detail}", flush=True)
    return ok


def _probe(timeout_s: float) -> tuple[bool, str]:
    """(ok, detail) of one round-trip to the card whose result is read back,
    on a thread so that a stalled device cannot hang the command."""
    import torch

    result: dict = {}

    def probe() -> None:
        t0 = time.perf_counter()
        try:
            x = torch.ones(1024, device="cuda")
            result["ok"] = float((x * 2).sum()) == 2048.0
            result["dt"] = time.perf_counter() - t0
        except Exception as e:  # noqa: BLE001 — reported as the row
            result["err"] = f"{type(e).__name__}: {e}"

    t = threading.Thread(target=probe, daemon=True)
    t.start()
    t.join(timeout=timeout_s)
    if t.is_alive():
        return False, f"no round-trip within {timeout_s:g}s: the card looks stalled"
    if "err" in result:
        return False, result["err"]
    return result["ok"], f"round-trip {result['dt'] * 1e3:.0f} ms (first use included)"


def _kernel_build() -> tuple[bool, str]:
    """The kernel library's state, and whether it can be (re)built here."""
    from segma_tpu_torch.ops import _build

    if not _build.LIB_PATH.exists():
        state = "absent"
    elif _build._stale():
        state = "stale"
    else:
        state = "built"
    try:
        nvcc = f"nvcc {_build._nvcc()}"
    except RuntimeError:
        nvcc = "nvcc not found"
    ok = state == "built" or not nvcc.startswith("nvcc not")
    return ok, f"{_build.LIB_PATH} {state}; {nvcc}"


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description="environment diagnostics")
    parser.add_argument("--config", default=None,
                        help="also resolve the devices this config would serve on")
    parser.add_argument("--probe-timeout", type=float, default=60.0,
                        help="seconds before the card's round-trip counts as a stall")
    args = parser.parse_args(argv)

    import torch

    from segma_tpu_torch import __version__
    from segma_tpu_torch.ops import _build
    from segma_tpu_torch.utils import host_mem_total_gb, host_rss_gb

    healthy = _row("segma_tpu_torch", True, __version__)
    _row("torch", True, f"{torch.__version__} (CUDA {torch.version.cuda})")
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    healthy &= _row(
        "card", n_cards > 0,
        f"{n_cards} x {torch.cuda.get_device_name(0)}" if n_cards
        else "torch.cuda.is_available() is false: no CUDA card",
    )
    if n_cards:
        healthy &= _row("card probe", *_probe(args.probe_timeout))
    healthy &= _row("kernel build", *_kernel_build())
    try:
        _build.host_library()
        healthy &= _row("native decoder", True, f"built ({_build.HOST_LIB_PATH})")
    except (RuntimeError, OSError) as e:
        healthy = _row("native decoder", False, f"{type(e).__name__}: {e}")
    _row("host memory", True, f"rss {host_rss_gb():.2f} GB / total {host_mem_total_gb():.0f} GB")

    if args.config:
        try:
            from segma_tpu_torch.config import load_config
            from segma_tpu_torch.parallel.mesh import check_dispatch, describe, make_mesh

            cfg = load_config(args.config)
            mesh = make_mesh(cfg)
            cards = ", ".join(str(d) for d in mesh.devices.flat)
            healthy &= _row("mesh", True, f"{mesh.shape} on {cards}: {describe(mesh)}")
            # as cli.train starts it over these cards: one NCCL rank each
            check_dispatch(cfg, tuple(mesh.shape.values()), "nccl", mesh.primary)
            healthy &= _row("mesh training", True,
                            f"train.dispatch={cfg.train.dispatch} trains over it, one NCCL rank "
                            f"per card (epoch dispatch refuses gloo ranks on cards where seq or "
                            f"model is above 1)")
        except Exception as e:  # noqa: BLE001 — reported as the row
            healthy = _row("mesh", False, f"{type(e).__name__}: {e}")

    raise SystemExit(0 if healthy else 1)


if __name__ == "__main__":
    main()
