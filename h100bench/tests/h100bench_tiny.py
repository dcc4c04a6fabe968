"""Runs of the benchmark's cells on the CPU at tiny widths, for the tests:
the real drivers, traffic shapes and limits, with the models shrunk, the
program in f32 (so that a sound run meets the reference to rounding) and
the corpora cut to seconds."""

import copy
import time

from h100bench.harness import core
from h100bench.harness import manifest as mf

M = mf.Manifest.load()


def cell_of(driver: str, chips: int) -> mf.Cell:
    for cell in M.cells.values():
        if mf.load_yaml(mf.traffic_path(cell.traffic))["driver"] == driver and cell.chips == chips:
            return cell
    raise LookupError(f"no cell of {driver} on {chips} chips")


def tiny_run(cell: mf.Cell, seed: int = 2**31 + 7, seconds: float = 0.5,
             precision: str = "f32", trace: bool = False, **traffic_keys) -> core.Run:
    config = copy.deepcopy(mf.load_yaml(M.config_path(cell)))
    traffic = copy.deepcopy(mf.load_yaml(mf.traffic_path(cell.traffic)))
    config["program"]["train"]["precision"] = precision
    enc = config["encoder"]
    if traffic["driver"] == "serve_files":
        enc.update(d_model=32, encoder_layers=2, encoder_attention_heads=2, encoder_ffn_dim=64)
        config["program"]["model"]["config"]["lstm"]["hidden_size"] = 8
        traffic.update(files_s=[40.0, 61.5], inner_batch=2)
    else:
        enc.update(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                   intermediate_size=64, conv_dim=[16] * 7, num_conv_pos_embeddings=16,
                   num_conv_pos_embedding_groups=4)
        config["program"]["train"]["dataloader"]["num_workers"] = 2
        traffic.update(train_files=2, train_file_s=40, val_files=1, val_file_s=8, batch_size=4,
                       warmup_steps=4, dataset_multiplier=400)
    traffic.update(traffic_keys)
    return core.Run(cell, M, seed, seconds, trace, time.perf_counter(), device="cpu",
                    config=config, traffic=traffic)


def drive(run: core.Run) -> dict:
    """The run's result line, as ``run.py`` prints it."""
    driver = mf.load_module(mf.driver_path(run.traffic["driver"]))
    outcome = driver.run(run)
    return core.result_line(run, outcome, "cpu", lambda msg: None)
