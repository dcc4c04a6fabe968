"""Experiment orchestration: run ids and cluster scripts with auto-requeue
(counterpart of ``segma_tpu/utils/experiment.py``).

Writes a self-resubmitting training job script and a predict+evaluate
script under a readable run id (timestamp and a word), running the port's
commands on one GPU. Two targets:

- ``slurm``: sbatch scripts (``#SBATCH --gres=gpu:1``) whose resilience loop
  resubmits the job with ``--dependency=afterany:$SLURM_JOBID`` until a
  ``finished`` sentinel exists; only a run that exits 0 drops it, and an
  interrupted one (exit 75) is resumed by the queued successor through
  ``cli.auto_train --auto-resume``;
- ``xpk``: an XPK/GKE workload on a GPU device type (``--device-type``), the
  sentinel's role taken by ``--restart-on-user-code-failure`` and
  ``--auto-resume``.

``gen_sweep`` writes one experiment per point of a parameter grid and a
``meta_run.sh`` that submits them all.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from itertools import product
from pathlib import Path

import numpy as np

# a short built-in word list: the timestamp makes ids unique, the word readable
WORD_LIST = [
    f"{a}{b}"
    for a in (
        "amber", "basalt", "cobalt", "dune", "ember", "fjord", "garnet",
        "heron", "indigo", "jasper", "krill", "lagoon", "moss", "nimbus",
        "onyx", "pampa", "quartz", "reef", "sepia", "tundra", "umber",
        "vortex", "willow", "xenon", "yarrow", "zephyr",
    )
    for b in ("", "-north", "-south", "-east", "-west")
]


def new_experiment_id(rng: np.random.Generator | None = None) -> str:
    """``YYYYMMDD_HHMMSS-<word>`` run identifier."""
    rng = rng or np.random.default_rng()
    word = WORD_LIST[int(rng.integers(len(WORD_LIST)))]
    return time.strftime("%Y%m%d_%H%M%S") + f"-{word}"


@dataclass
class Experiment:
    """Cluster job scripts for one training run on one GPU."""

    config_path: str
    target: str = "slurm"  # slurm | xpk
    run_id: str = field(default_factory=new_experiment_id)
    output_root: str = "models"
    partition: str = "gpu"
    time_limit: str = "48:00:00"
    mem: str = "100G"
    cpus: int = 24
    device_type: str = "h100-80gb-1"
    docker_image: str = "segma-tpu-torch:latest"
    extra_train_args: list[str] = field(default_factory=list)

    @property
    def run_dir(self) -> Path:
        return Path(self.output_root) / self.run_id

    def train_command(self) -> str:
        args = " ".join(self.extra_train_args)
        return (
            f"python -m segma_tpu_torch.cli.auto_train -c {self.config_path} "
            f"--auto-resume --run-id {self.run_id} --output {self.output_root} "
            f"{args}".strip()
        )

    def pred_eval_command(self, dataset: str, wavs: str) -> str:
        ckpt = self.run_dir / "checkpoints" / "best.ckpt"
        out = self.run_dir / "predictions"
        return "\n".join([
            f"python -m segma_tpu_torch.inference --config {self.run_dir}/config.yml "
            f"--wavs {wavs} --uris {dataset}/test.txt --checkpoint {ckpt} "
            f"--output {out} --save-logits",
            f"python -m segma_tpu_torch.evaluate --gt {dataset}/rttm "
            f"--pred {out}/raw_rttm -c {self.run_dir}/config.yml",
        ])

    # -- script generation ------------------------------------------------------
    def slurm_script(self) -> str:
        """Training sbatch script with the self-requeue resilience loop."""
        return f"""#!/bin/bash
#SBATCH --job-name=segma-{self.run_id}
#SBATCH --partition={self.partition}
#SBATCH --gres=gpu:1
#SBATCH --time={self.time_limit}
#SBATCH --mem={self.mem}
#SBATCH --cpus-per-task={self.cpus}
#SBATCH --output=logs/{self.run_id}-%j.out

set -u
RUN_DIR={self.run_dir}
mkdir -p "$RUN_DIR" logs

# resilience: resubmit this script after this job ends (any exit state)
# until the training run drops the `finished` sentinel
if [ -f "$RUN_DIR/finished" ]; then
    # a successor queued before the run completed: nothing is left to do
    # (it would otherwise resume a finished run for another epoch)
    exit 0
fi
sbatch --dependency=afterany:$SLURM_JOBID "$0"

{self.train_command()}
status=$?

# only a COMPLETED run drops the sentinel: an interrupted or self-recycled
# run exits 75 (EX_TEMPFAIL) and the queued successor resumes it
[ "$status" -eq 0 ] && touch "$RUN_DIR/finished"
exit "$status"
"""

    def xpk_script(self) -> str:
        """XPK-style GPU workload launcher."""
        return f"""#!/bin/bash
# GPU workload via xpk (GKE). Requires a provisioned cluster.
set -eu
xpk workload create \\
  --workload segma-{self.run_id} \\
  --device-type {self.device_type} \\
  --docker-image {self.docker_image} \\
  --restart-on-user-code-failure \\
  --command "{self.train_command()}"
"""

    def pred_eval_script(self, dataset: str, wavs: str) -> str:
        return f"""#!/bin/bash
#SBATCH --job-name=segma-pe-{self.run_id}
#SBATCH --partition={self.partition}
#SBATCH --gres=gpu:1
#SBATCH --time=20:00:00
#SBATCH --mem=40G
#SBATCH --output=logs/{self.run_id}-pe-%j.out

set -eu
{self.pred_eval_command(dataset, wavs)}
"""

    def write(self, out_dir: Path | str = "experiments") -> dict[str, Path]:
        # a sweep can make several experiments within one second: an id that
        # collides with a sibling's gets a counter rather than overwriting it
        base, n = self.run_id, 2
        while (Path(out_dir) / self.run_id).exists():
            self.run_id = f"{base}-{n}"
            n += 1
        out_dir = Path(out_dir) / self.run_id
        out_dir.mkdir(parents=True, exist_ok=True)
        if self.target == "slurm":
            path = out_dir / "run.sh"
            path.write_text(self.slurm_script())
        else:
            path = out_dir / "run_xpk.sh"
            path.write_text(self.xpk_script())
        path.chmod(0o755)
        return {"run": path}

    def write_pred_eval(
        self, dataset: str, wavs: str, out_dir: Path | str = "experiments"
    ) -> Path:
        out_dir = Path(out_dir) / self.run_id
        out_dir.mkdir(parents=True, exist_ok=True)
        p = out_dir / "pred_eval.sh"
        p.write_text(self.pred_eval_script(dataset, wavs))
        p.chmod(0o755)
        return p


def gen_sweep(config: str, grid: dict[str, list], out_dir: Path, target: str = "slurm") -> Path:
    """One experiment per point of the Cartesian product of ``grid`` (dotted
    config keys -> values), and ``meta_run.sh`` submitting them all."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    keys = list(grid)
    lines = ["#!/bin/bash", "set -eu"]
    for values in product(*(grid[k] for k in keys)):
        overrides = [f"{k}={v}" for k, v in zip(keys, values)]
        exp = Experiment(config_path=config, target=target, extra_train_args=overrides)
        paths = exp.write(out_dir)
        lines.append(f"{'sbatch' if target == 'slurm' else 'bash'} {paths['run']}")
    meta = out_dir / "meta_run.sh"
    meta.write_text("\n".join(lines) + "\n")
    meta.chmod(0o755)
    return meta
