"""The port's cluster scripts (``segma_tpu_torch/utils/experiment.py``): the
counterparts of ``tests/test_experiment.py``, with the port's commands, one
GPU per job, and a GPU device type on the xpk target."""

from __future__ import annotations

import numpy as np

import segma_tpu.utils.experiment as jexp
from segma_tpu_torch.utils import experiment as exp_mod
from segma_tpu_torch.utils.experiment import Experiment, gen_sweep, new_experiment_id


def test_new_experiment_id_format():
    rid = new_experiment_id(np.random.default_rng(0))
    stamp, word = rid.split("-", 1)
    assert len(stamp) == 15 and stamp[8] == "_"
    assert word in exp_mod.WORD_LIST and exp_mod.WORD_LIST == jexp.WORD_LIST


def test_slurm_script_self_requeues(tmp_path):
    exp = Experiment(config_path="cfg.yml", run_id="test-run", target="slurm")
    paths = exp.write(tmp_path)
    script = paths["run"].read_text()
    assert "--dependency=afterany:$SLURM_JOBID" in script and "finished" in script
    # only a run that exits 0 drops the sentinel: an interrupted one (75)
    # must be resumed by the queued successor
    assert '[ "$status" -eq 0 ] && touch "$RUN_DIR/finished"' in script
    assert "#SBATCH --gres=gpu:1" in script
    assert ("python -m segma_tpu_torch.cli.auto_train -c cfg.yml --auto-resume "
            "--run-id test-run --output models") in script
    assert "scripts/" not in script
    assert paths["run"].stat().st_mode & 0o111


def test_xpk_script(tmp_path):
    exp = Experiment(config_path="cfg.yml", run_id="r", target="xpk")
    script = exp.write(tmp_path)["run"].read_text()
    assert "xpk workload create" in script and "--restart-on-user-code-failure" in script
    assert "--device-type h100-80gb-1" in script and "--tpu-type" not in script
    assert "segma_tpu_torch.cli.auto_train" in script


def test_pred_eval_script(tmp_path):
    exp = Experiment(config_path="cfg.yml", run_id="r")
    s = exp.write_pred_eval("data/ds", "data/ds/wav", tmp_path).read_text()
    assert "python -m segma_tpu_torch.inference --config models/r/config.yml" in s
    assert "python -m segma_tpu_torch.evaluate --gt data/ds/rttm" in s
    assert "models/r/checkpoints/best.ckpt" in s and "#SBATCH --gres=gpu:1" in s


def test_gen_sweep(tmp_path):
    meta = gen_sweep("cfg.yml", {"data.dataset_multiplier": [0.1, 0.5], "train.lr": [1e-3]},
                     tmp_path)
    lines = meta.read_text().strip().split("\n")
    assert sum("sbatch" in ln for ln in lines) == 2
    run_scripts = list(tmp_path.glob("*/run.sh"))
    assert len(run_scripts) == 2
    joined = "".join(p.read_text() for p in run_scripts)
    assert "data.dataset_multiplier=0.1" in joined and "train.lr=0.001" in joined


def test_same_second_sweep_never_collides(tmp_path, monkeypatch):
    """Two experiments of one second that draw the same word get two ids."""
    orig_rng = np.random.default_rng
    monkeypatch.setattr(exp_mod.np.random, "default_rng", lambda *a, **k: orig_rng(0))
    e1 = Experiment(config_path="c.yml")
    e1.write(tmp_path)
    e2 = Experiment(config_path="c.yml")
    e2.write(tmp_path)
    assert e1.run_id != e2.run_id
    assert len(list(tmp_path.glob("*/run.sh"))) == 2


def test_scripts_are_jax_s_but_for_the_commands_and_the_gpu():
    """The requeue loop and the sbatch headers are the JAX package's: only
    the commands, the GPU line and the comments differ."""
    port = Experiment(config_path="cfg.yml", run_id="r")
    jax = jexp.Experiment(config_path="cfg.yml", run_id="r")

    def code(script: str, command: str) -> list[str]:
        return [ln for ln in script.replace(command, "<train>").splitlines()
                if ln.strip() and not ln.lstrip().startswith("# ")
                and ln != "#SBATCH --gres=gpu:1"]

    assert code(port.slurm_script(), port.train_command()) == code(
        jax.slurm_script(), jax.train_command())
