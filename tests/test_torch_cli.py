"""The port's remaining CLIs on the CPU: the ``segma-tpu-torch`` dispatcher
against the JAX package's command table, the export and bundle CLIs, and
``doctor``, which exits 1 without a card."""

from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from segma_tpu.cli import _COMMANDS as JAX_COMMANDS
from segma_tpu_torch import checkpoint
from segma_tpu_torch.cli import _COMMANDS, main
from segma_tpu_torch.config import load_config
from segma_tpu_torch.export import ExportedPipeline
from segma_tpu_torch.inference import InferencePipeline

REPO = Path(__file__).resolve().parent.parent
VAD = ["model.name=conv_vad", "model.config.hidden=32", "model.config.depth=1",
       "model.config.dtype=f32", "audio.chunk_duration_s=1.0", "train.seed=3"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_command_table_is_jax_s():
    """The same ten commands, in order, each on the port's counterpart of
    the JAX module, whose ``main`` takes an argv."""
    assert list(_COMMANDS) == list(JAX_COMMANDS)
    for name, (module, _desc) in _COMMANDS.items():
        assert module == JAX_COMMANDS[name][0].replace("segma_tpu.", "segma_tpu_torch.", 1)
        assert callable(importlib.import_module(module).main), name


def test_dispatcher_usage_and_unknown_command(capsys):
    main([])
    out = capsys.readouterr().out
    assert out.startswith("usage: segma-tpu-torch <command>")
    assert all(f"  {name}" in out for name in _COMMANDS)
    with pytest.raises(SystemExit) as e:
        main(["nope"])
    assert e.value.code == 2 and "unknown command 'nope'" in capsys.readouterr().err


def test_console_script_is_declared():
    text = (REPO / "pyproject.toml").read_text()
    assert 'segma-tpu-torch = "segma_tpu_torch.cli:main"' in text


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A conv_vad config file and a checkpoint of weights other than its
    seed's (the checkpoint must be what the export serves)."""
    root = tmp_path_factory.mktemp("cli")
    cfg = load_config(REPO / "segma_tpu_torch/config/default.yml", VAD)
    model = checkpoint.build_model(cfg, seed=11, device="cpu")
    checkpoint.save_params(root / "ck", checkpoint.flax_split(model)[0])
    return chip_smoke.write_config(root / "cfg.json", cfg), root / "ck", model


def test_export_cli_through_the_dispatcher(trained, tmp_path, capsys):
    cfg_path, ck, model = trained
    out = tmp_path / "artifact"
    main(["export", "--config", str(cfg_path), "--checkpoint", str(ck), "--output", str(out),
          "--platforms", "cpu", "--buckets", "2", "--batch-size", "2", "--stream-batches",
          "--model-version", "v7"])
    assert f"exported conv_vad -> {out}" in capsys.readouterr().out
    exp = ExportedPipeline.load(out, device="cpu")
    assert exp.manifest["model_version"] == "v7" and exp.manifest["platforms"] == ["cpu"]
    assert exp.manifest["stream_batches"] == [] and exp.manifest["buckets"] == [2]
    wav = (np.random.default_rng(0).standard_normal(30_000) * 3000).astype(np.int16)
    np.testing.assert_array_equal(
        exp.logits_for_audio(wav),
        InferencePipeline(model, batch_size=2, device="cpu").logits_for_audio(wav))


def test_export_cli_refuses_a_card_it_has_not(trained, tmp_path):
    cfg_path, ck, _ = trained
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the card-less case is what is checked")
    with pytest.raises(RuntimeError):
        main(["export", "--config", str(cfg_path), "--checkpoint", str(ck), "--output",
              str(tmp_path / "x")])
    with pytest.raises(SystemExit):
        main(["export", "--config", str(cfg_path), "--output", str(tmp_path / "x"),
              "--platforms", "tpu"])


def test_bundle_cli_through_the_dispatcher(trained, tmp_path, capsys):
    cfg_path, ck, _ = trained
    for name in ("a", "b"):
        main(["export", "--config", str(cfg_path), "--checkpoint", str(ck), "--output",
              str(tmp_path / name), "--platforms", "cpu", "--buckets", "2",
              "--stream-batches"])
    with pytest.raises(ValueError, match="pick the default"):
        main(["bundle", str(tmp_path)])
    main(["bundle", str(tmp_path), "--default", "b"])
    assert "default: b" in capsys.readouterr().out
    assert json.loads((tmp_path / "bundle.json").read_text())["default"] == "b"


def test_doctor_exits_1_without_a_card(capsys, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the card-less case is what is checked")
    from segma_tpu_torch.cli import doctor

    cfg = chip_smoke.write_config(
        tmp_path / "cfg.json", load_config(REPO / "segma_tpu_torch/config/default.yml", VAD))
    with pytest.raises(SystemExit) as e:
        doctor.main(["--config", str(cfg), "--probe-timeout", "5"])
    assert e.value.code == 1
    out = capsys.readouterr().out
    assert "[FAIL] card" in out and "[FAIL] mesh" in out
    assert "[ok ] torch" in out and "[ok ] native decoder" in out and "host memory" in out
    assert "kernel build" in out and "nvcc" in out


def test_doctor_cli_in_a_child_exits_1_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the card-less case is what is checked")
    proc = subprocess.run([sys.executable, "-m", "segma_tpu_torch.cli.doctor"], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": str(REPO)})
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "[FAIL] card" in proc.stdout
