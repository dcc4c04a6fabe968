"""The ``wavlm_hydra`` family on the CPU at tiny widths: the cell resolves
through the manifest; ``build`` sets every weight from the seed, the bare
parameters at their stated scales; ``flops`` at the published widths; the
reference meets the f32 program to rounding and its serving grid is the
program's; a sound run of the cell's driver is correct and one with the
program's relative-position bias left out is not."""

import copy
import time

import numpy as np
import pytest
import torch

from h100bench.harness import core
from h100bench.harness import manifest as mf

M = mf.Manifest.load()
CELL = "wavlm_large_hydra.serve_longform"
TINY = dict(hidden_size=128, num_hidden_layers=2, num_attention_heads=2, intermediate_size=64,
            conv_dim=[16] * 7, num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)

torch.set_num_threads(2)


def tiny_run(seed: int = 2**31 + 11) -> core.Run:
    cell = M.cell(CELL)
    config = copy.deepcopy(mf.load_yaml(M.config_path(cell)))
    traffic = copy.deepcopy(mf.load_yaml(mf.traffic_path(cell.traffic)))
    config["program"]["train"]["precision"] = "f32"
    config["encoder"].update(TINY)
    traffic.update(files_s=[40.0, 61.5], inner_batch=2)
    return core.Run(cell, M, seed, 0.5, False, time.perf_counter(), device="cpu", config=config,
                    traffic=traffic)


def test_cell_resolves_through_the_manifest():
    cell = M.cell(CELL)
    config = mf.load_yaml(M.config_path(cell))
    assert config["family"] == "wavlm_hydra" and config["reduced"] == []
    assert M.configs[cell.config]["reduced"] == [] and cell.chips == 1
    assert mf.family_module(config).__name__ == "h100bench.models.wavlm_hydra"
    assert mf.reference_module(config).__name__ == "h100bench.reference.wavlm_hydra"
    assert mf.driver_path(mf.load_yaml(mf.traffic_path(cell.traffic))["driver"]).is_file()
    names = {m.name for m in M.per_layer(cell)}
    assert {"wavlm_attn_roofline", "rel_attn_ms.serve", "mfu.serve", "device_idle.serve"} <= names
    assert all(mf.metric_path(n).is_file() for n in names)
    assert [m.name for m in M.end_to_end(cell)] == ["serve_xrt", "setup_s"]


def test_build_draws_every_weight_and_the_bare_ones_at_their_scales():
    run = tiny_run()
    fam = mf.family_module(run.config)
    cfg = run.program_config()
    model, sd = fam.build(run, cfg, torch.device("cpu"))
    assert set(sd) == {n for n, _ in model.module.named_parameters()}
    table = sd["encoder.layers.0.attention.rel_attn_embed"]
    assert table.shape == (320, 2) and 0.8 < float(table.std()) < 1.2
    consts = torch.cat([sd[f"encoder.layers.{i}.attention.gru_rel_pos_const"].flatten()
                        for i in range(2)])
    assert float((consts - 1).abs().max()) > 0.05
    enc = model.module.enc_cfg
    assert (enc.feat_extract_norm, enc.conv_bias, enc.stable_layer_norm) == ("layer", False, True)
    again = fam.build(run, cfg, torch.device("cpu"))[1]
    assert all(torch.equal(sd[k], again[k]) for k in sd)


def test_flops_at_the_published_widths():
    config = mf.load_yaml(M.config_path(M.cell(CELL)))
    fam = mf.family_module(config)
    per_chunk = fam.flops(config, {"chunks": 1})
    assert 146e9 < per_chunk < 148e9  # 19.6 G front end, 3.6 G embedding, 24 x 5.17 G
    assert fam.flops(config, {"chunks": 64}) == 64 * per_chunk
    assert fam.flops(config, {"crops": 1}) is None


def test_reference_meets_the_f32_program():
    run = tiny_run()
    model, sd = mf.family_module(run.config).build(run, run.program_config(), torch.device("cpu"))
    ref = mf.reference_module(run.config).model(sd, run.config, "cpu")
    wav = torch.from_numpy((np.random.default_rng(3).standard_normal((2, 64_000)) * 0.1)
                           .astype(np.float32))
    got = model.apply(wav)
    want = ref.chunk_logits(wav)
    assert got.shape == want.shape == (2, 199, 4)
    assert float((got - want).abs().max()) <= 1e-4


@pytest.mark.parametrize("n", [64_000, 64_399, 64_400, 2 * 63_680 + 64_000 + 9_320, 1_000_003])
def test_reference_grid_is_the_programs(n):
    from segma_tpu_torch.inference import Chunkyfier
    from segma_tpu_torch.geometry import ConvolutionSettings

    ref = mf.reference_module(mf.load_yaml(M.config_path(M.cell(CELL))))
    ck = Chunkyfier(64, 64_000, ConvolutionSettings((320,), (320,), (0,)))
    assert ref.grid(n)[1] == ck.total_frames(n, strict_tail=True)
    assert ref.WINDOWS == ck.n_windows and ref.STRIDE == ck.chunk_stride


def test_a_sound_run_is_correct_and_the_bias_left_out_moves_both_readings(monkeypatch):
    """A sound run is correct. The relative-position bias left out moves the
    served RTTM off the reference: ``rttm_diff`` and the widest gap,
    ``rttm_gap``, read above the sound run's. Whether one such run fails the
    cell's limit depends on the seed (at these widths 16 of 20 seeds read
    above it, 0.11-14.3; on the card 8 of 9, 1.11-5.88; PERF.md §2), so that
    is not asserted."""
    run = tiny_run()
    driver = mf.load_module(mf.driver_path(run.traffic["driver"]))
    limit = run.traffic["checks"]["rttm_diff"]
    sound = driver.run(run)
    assert sound.checks[0].ok and sound.checks[0].value <= limit

    fam = mf.family_module(run.config)
    build = fam.build

    def without_bias(run, cfg, device):
        model, sd = build(run, cfg, device)
        with torch.no_grad():
            model.module.encoder.layers[0].attention.rel_attn_embed.zero_()
        return model, sd

    monkeypatch.setattr(fam, "build", without_bias)
    fault = driver.run(tiny_run()).readings
    assert fault["rttm_diff"] > sound.readings["rttm_diff"] + 0.5
    assert fault["rttm_gap"] > sound.readings["rttm_gap"] + 0.1
