"""Config subset the port reads (counterpart of ``segma_tpu/config/base.py``).

What serving and training the ten models of the JAX registry need is
modelled: the dataset, the audio
geometry, the label classes, the models' hyper-parameters and the training
fields, and the ``mesh`` section (the device mesh's layout, validated as
JAX validates it). ``load_config`` reads the same YAML files as the JAX
package (``default.yml`` plus the per-model YAML) with ``a.b.c=value``
overrides; it also reads the ``config.yml`` that JAX's ``Config.save`` writes
into a run directory. The ``wandb`` section is skipped.
``Config.save`` writes a YAML file that both packages' ``load_config`` read.
``pyyaml`` is imported inside ``load_config`` and ``Config.save`` only, so a
program that builds its ``Config`` in code does not need it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

CONFIG_DIR = Path(__file__).parent


class ConfigError(ValueError):
    """Raised on invalid config input."""


@dataclass
class AudioConfig:
    chunk_duration_s: float
    sample_rate: int
    strict_frames: bool
    reference_tail: bool = False

    @property
    def chunk_duration_f(self) -> int:
        """Number of samples in one chunk."""
        return int(self.chunk_duration_s * self.sample_rate)


@dataclass
class DataConfig:
    classes: list[str]
    dataset_path: str = ""
    dataset_multiplier: float = 1.0


@dataclass
class LSTMConfig:
    hidden_size: int
    num_layers: int
    bidirectional: bool
    dropout: float
    # JAX's lax.scan unroll factor: it changes how XLA schedules the steps,
    # not the math. The port's LSTM (cuDNN, or its kernel in inference) has
    # no such knob, so the port reads it, checks it and writes it back, and
    # it has no effect here
    unroll: int = 1


@dataclass
class WhisperidouConfig:
    encoder: str
    linear: list[int]
    classifier: int
    # run the encoder on the chunk's own frames instead of Whisper's 30 s
    # context (numerics differ slightly from the padded reference)
    fast_context: bool = False


@dataclass
class WhisperimaxConfig:
    encoder: str
    lstm: LSTMConfig
    linear: list[int]
    classifier: int
    fast_context: bool = False


@dataclass
class SurgicalWhisperConfig:
    encoder: str
    encoder_layers: list[int]
    reduction: str
    linear: list[int]
    classifier: int
    fast_context: bool = False


@dataclass
class HydraWhisperConfig:
    encoder: str
    lstm: LSTMConfig
    classifier: int
    fast_context: bool = False


@dataclass
class SurgicalHydraConfig:
    encoder: str
    encoder_layers: list[int]
    reduction: str
    lstm: LSTMConfig
    classifier: int
    fast_context: bool = False


@dataclass
class SurgicalHubertHydraConfig:
    wav_encoder: str
    encoder_layers: list[int]
    reduction: str
    classifier: int
    freeze_encoder: bool = False


@dataclass
class ConvVADConfig:
    """``conv_vad`` and ``powerset_vad``: a convolutional model on the
    log-mel frame grid (rf_step 320)."""

    hidden: int = 256
    depth: int = 4
    dtype: str = "bf16"  # compute dtype: bf16 | f32
    # powerset_vad only: the most simultaneous labels one subset class holds
    max_set_size: int = 2


@dataclass
class SincNetHydraConfig:
    """``sincnet_hydra``: a learnable band-pass (SincNet) front end, a BiLSTM
    and hydra heads; rf_step = 32 * stride (320 at the default 10)."""

    stride: int = 10
    filters: int = 80
    kernel_size: int = 251
    hidden: int = 128
    lstm: LSTMConfig | None = None
    dtype: str = "bf16"  # compute dtype: bf16 | f32


@dataclass
class ModelConfig:
    name: str
    chkp_path: str | None = None
    config: (
        WhisperidouConfig | WhisperimaxConfig | SurgicalWhisperConfig | HydraWhisperConfig
        | SurgicalHydraConfig | SurgicalHubertHydraConfig | ConvVADConfig
        | SincNetHydraConfig | None
    ) = None


@dataclass
class SchedulerConfig:
    patience: int = 3  # plateau epochs before the LR drops tenfold
    # "plateau" (ReduceLROnPlateau on the monitored metric) or "cosine" (per
    # micro-step linear warmup, then cosine decay to min_lr_ratio * lr)
    type: str = "plateau"
    warmup_steps: int = 0
    min_lr_ratio: float = 0.0


@dataclass
class DataloaderConfig:
    num_workers: int = 8  # sampler threads, their batches taken in a fixed order


@dataclass
class TrainConfig:
    lr: float = 1e-3
    batch_size: int = 32
    max_epochs: int = 100
    validation_metric: str = "loss"  # loss | f1_score | auroc
    # any of loss, f1_score, auroc, roc (a per-label ROC figure when matplotlib exists)
    extra_val_metrics: list[str] = field(default_factory=lambda: ["loss", "f1_score"])
    profiler: str | None = None  # any value: trace the epoch after the first into the run dir
    seed: int | None = None
    precision: str = "bf16"  # compute dtype: bf16 | f32
    log_every_n_steps: int = 50  # per-step loss records; 0 disables
    early_stop_patience: int = 10
    save_top_k: int = 5  # epoch checkpoints kept by the monitored metric; -1 keeps all
    class_weights: list[float] | None = None
    # optimizer update once per k micro-batches, on the running mean of their
    # gradients (optax.MultiSteps); 1 = off
    grad_accum_steps: int = 1
    remat: bool = False  # recompute each HuBERT layer in the backward pass
    debug_nans: bool = False  # raise FloatingPointError at the first non-finite step
    # host->device batches: "f32" normalised on the host, "int16" the raw
    # PCM16 crop normalised on the device (non-PCM16 sources ship f32)
    transport: str = "f32"
    # stop with interrupted=True when host RSS passes this many GB at an
    # epoch boundary; null = 90% of MemTotal, 0 disables
    host_rss_limit_gb: float | None = None
    val_every_n_epochs: int = 1  # the last epoch always validates
    # "step": one step per host call; "epoch": the epoch's stacked offsets,
    # labels and rates uploaded once and the step replayed over them (a
    # captured CUDA graph on the card); needs the device audio cache
    dispatch: str = "step"
    # where a subset's audio lives: "host", "device" (uploaded once, batches
    # carry crop offsets) or "auto" (device within the budget below)
    data_cache: str = "auto"
    device_cache_budget_gb: float = 12.0  # data_cache=auto: all subsets together
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    dataloader: DataloaderConfig = field(default_factory=DataloaderConfig)


@dataclass
class MeshConfig:
    """The device mesh's layout (``parallel.make_mesh``): ``data`` replicas
    of the model, each taking a block of the windows or of the batch; -1
    takes every device not claimed by ``seq * model``. ``model`` (tensor
    parallelism) and ``seq`` (the Whisper encoder's time axis) are read and
    validated as in JAX: the pipeline serves over any mesh, the trainer
    trains over one of one process per device (``train.dispatch=step``
    where they are above 1)."""

    data: int = -1
    model: int = 1
    seq: int = 1


VAL_METRICS = ("loss", "f1_score", "auroc")  # train.validation_metric
# partial_loss: powerset models only (partial_f1_score and partial_auroc come
# with f1_score and auroc)
EXTRA_VAL_METRICS = ("loss", "f1_score", "auroc", "roc", "partial_loss")
# the wandb section of a saved config: the port logs to metrics.jsonl only
WANDB_OFFLINE = {"offline": True, "project": "segma_tpu_torch", "name": "train"}


@dataclass
class Config:
    data: DataConfig
    audio: AudioConfig
    model: ModelConfig
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    def save(self, path: Path | str) -> None:
        """This config as YAML, with an offline ``wandb`` section, which the
        JAX package's ``load_config`` requires (the port's skips it)."""
        import yaml

        with Path(path).open("w") as f:
            yaml.dump({"wandb": dict(WANDB_OFFLINE), **dataclasses.asdict(self)}, f,
                      default_flow_style=False, sort_keys=False)


_MODEL_CONFIG_TYPES: dict[str, type] = {
    "whisperidou": WhisperidouConfig,
    "whisperimax": WhisperimaxConfig,
    "surgical_whisper": SurgicalWhisperConfig,
    "hydra_whisper": HydraWhisperConfig,
    "surgical_hydra": SurgicalHydraConfig,
    "surgical_hubert_hydra": SurgicalHubertHydraConfig,
    "surgical_wavlm_hydra": SurgicalHubertHydraConfig,
    "sincnet_hydra": SincNetHydraConfig,
    "conv_vad": ConvVADConfig,
    "powerset_vad": ConvVADConfig,
}
_NESTED: dict[tuple[type, str], type] = {
    (WhisperimaxConfig, "lstm"): LSTMConfig,
    (HydraWhisperConfig, "lstm"): LSTMConfig,
    (SurgicalHydraConfig, "lstm"): LSTMConfig,
    (SincNetHydraConfig, "lstm"): LSTMConfig,
    (TrainConfig, "scheduler"): SchedulerConfig,
    (TrainConfig, "dataloader"): DataloaderConfig,
}
# the families whose encoder time axis can shard over mesh.seq (JAX's
# _SEQ_SHARDABLE_MODELS: Whisper's conv front end halves an even mel grid;
# the HuBERT, WavLM and SincNet stacks emit odd time lengths)
_SEQ_SHARDABLE_MODELS = frozenset(
    {"whisperidou", "whisperimax", "surgical_whisper", "hydra_whisper", "surgical_hydra"})


def _build(cls: type, data: dict, path: str) -> Any:
    """Strict dict -> dataclass for the modelled fields (unknown keys raise)."""
    if not isinstance(data, dict):
        raise ConfigError(f"{path}: expected a mapping for {cls.__name__}")
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = sorted(set(data) - set(fields))
    if unknown:
        raise ConfigError(f"{path}: unknown keys {unknown} for {cls.__name__}")
    kwargs = {}
    for name, value in data.items():
        sub = _NESTED.get((cls, name))
        kwargs[name] = (_build(sub, value, f"{path}.{name}") if sub and value is not None
                        else value)
    missing = [
        n for n, f in fields.items()
        if n not in kwargs
        and f.default is dataclasses.MISSING
        and f.default_factory is dataclasses.MISSING
    ]
    if missing:
        raise ConfigError(f"{path}: missing required fields {missing}")
    return cls(**kwargs)


def _positive_int(value: Any) -> bool:
    return type(value) is int and value >= 1


def config_from_dict(config_d: dict) -> Config:
    """Build a ``Config`` from the shared YAML layout."""
    model_d = dict(config_d["model"])
    name = model_d["name"]
    if name not in _MODEL_CONFIG_TYPES:
        raise ConfigError(
            f"unknown model {name!r}; registered models: {sorted(_MODEL_CONFIG_TYPES)}"
        )
    if model_d.get("config") is not None:
        model_d["config"] = _build(
            _MODEL_CONFIG_TYPES[name], model_d["config"], "config.model.config"
        )
    data_d = dict(config_d["data"])
    data_d["classes"] = list(data_d["classes"])
    train = _build(TrainConfig, config_d.get("train") or {}, "config.train")
    train.lr = float(train.lr)
    train.scheduler.min_lr_ratio = float(train.scheduler.min_lr_ratio)
    train.device_cache_budget_gb = float(train.device_cache_budget_gb)
    if train.host_rss_limit_gb is not None:
        train.host_rss_limit_gb = float(train.host_rss_limit_gb)
    if train.validation_metric not in VAL_METRICS:
        raise ConfigError(
            f"config.train.validation_metric={train.validation_metric!r}: the port "
            f"monitors one of {VAL_METRICS}"
        )
    unported = sorted(set(train.extra_val_metrics) - set(EXTRA_VAL_METRICS))
    if unported:
        raise ConfigError(
            f"config.train.extra_val_metrics: {unported} are not ported yet "
            f"(the port computes {EXTRA_VAL_METRICS})"
        )
    if train.scheduler.type not in ("plateau", "cosine"):
        raise ConfigError(
            f"config.train.scheduler.type={train.scheduler.type!r}: 'plateau' or 'cosine'")
    if train.transport not in ("f32", "int16"):
        raise ConfigError(f"config.train.transport={train.transport!r}: 'f32' or 'int16'")
    if train.dispatch not in ("step", "epoch"):
        raise ConfigError(f"config.train.dispatch={train.dispatch!r}: 'step' or 'epoch'")
    if train.data_cache not in ("host", "device", "auto"):
        raise ConfigError(
            f"config.train.data_cache={train.data_cache!r}: 'host', 'device' or 'auto'")
    if train.grad_accum_steps < 1:
        raise ConfigError(
            f"config.train.grad_accum_steps={train.grad_accum_steps}: must be at least 1")
    lstm = getattr(model_d.get("config"), "lstm", None)
    if lstm is not None and not _positive_int(lstm.unroll):
        raise ConfigError(
            f"config.model.config.lstm.unroll={lstm.unroll!r}: an int of at least 1")
    mesh = _build(MeshConfig, config_d.get("mesh") or {}, "config.mesh")
    if not (mesh.data == -1 or _positive_int(mesh.data)):
        raise ConfigError(f"config.mesh.data={mesh.data!r}: -1 or an int of at least 1")
    for axis in ("model", "seq"):
        if not _positive_int(getattr(mesh, axis)):
            raise ConfigError(
                f"config.mesh.{axis}={getattr(mesh, axis)!r}: an int of at least 1")
    return Config(
        data=_build(DataConfig, data_d, "config.data"),
        audio=_build(AudioConfig, config_d["audio"], "config.audio"),
        model=_build(ModelConfig, model_d, "config.model"),
        train=train,
        mesh=mesh,
    )


def _deep_merge(base: dict, override: dict) -> dict:
    out = dict(base)
    for key, value in override.items():
        if key in out and isinstance(out[key], dict) and isinstance(value, dict):
            out[key] = _deep_merge(out[key], value)
        else:
            out[key] = value
    return out


def load_config(config_path: Path | str, cli_extra_args: list[str] | None = None) -> Config:
    """YAML -> dotted overrides -> per-model YAML merge -> ``Config``."""
    import yaml

    with Path(config_path).open("r") as f:
        config_d = yaml.safe_load(f)
    had_config = isinstance(config_d.get("model", {}).get("config"), dict)
    for item in cli_extra_args or []:
        if "=" not in item:
            raise ConfigError(f"override {item!r} is not of the form key.path=value")
        key_path, _, raw = item.partition("=")
        node = config_d
        keys = key_path.strip().split(".")
        for key in keys[:-1]:
            node = node.setdefault(key, {})
            if not isinstance(node, dict):
                raise ConfigError(f"cannot override non-mapping node {key!r}")
        node[keys[-1]] = yaml.safe_load(raw) if raw != "" else None
    if not had_config:
        name = config_d["model"]["name"]
        model_c_p = CONFIG_DIR / f"{name}.yml"
        if not model_c_p.exists():
            raise ConfigError(f"no per-model config for model {name!r}")
        with model_c_p.open("r") as f:
            merged = yaml.safe_load(f)
        partial = config_d["model"].get("config") or {}
        config_d["model"]["config"] = _deep_merge(merged, partial)
    cfg = config_from_dict(config_d)
    _validate_mesh_seq(cfg)
    return cfg


def _validate_mesh_seq(cfg: Config) -> None:
    """Refuse a ``mesh.seq`` that cannot shard the encoder's time axis, with
    JAX's messages (``segma_tpu/config/base.py:_validate_mesh_seq``)."""
    seq = cfg.mesh.seq
    if seq <= 1:
        return
    name = cfg.model.name
    if name not in _SEQ_SHARDABLE_MODELS:
        raise ConfigError(
            f"mesh.seq={seq}: sequence parallelism is only available for "
            f"the whisper family {sorted(_SEQ_SHARDABLE_MODELS)}; "
            f"'{name}' emits odd encoder time lengths at every chunk size, "
            "so its time axis cannot shard (see SCALING.md) — use "
            "mesh.data/mesh.model instead"
        )
    if getattr(cfg.model.config, "fast_context", False):
        grid = int(round(cfg.audio.chunk_duration_f / 320))
        ctx = f"fast_context time grid {grid} (chunk_f/320)"
    else:
        grid = 1500
        ctx = "padded 30 s context time grid 1500"
    if grid % seq:
        divisors = [d for d in range(2, min(grid, 33)) if grid % d == 0]
        raise ConfigError(
            f"mesh.seq={seq} does not divide the whisper encoder's {ctx}: "
            "the sharding would silently degrade to seq-fold replication. "
            f"Valid seq values here: {divisors}"
        )


__all__ = [
    "AudioConfig", "Config", "ConfigError", "ConvVADConfig", "DataConfig", "DataloaderConfig",
    "HydraWhisperConfig", "LSTMConfig", "MeshConfig", "ModelConfig", "SchedulerConfig",
    "SincNetHydraConfig",
    "SurgicalHubertHydraConfig", "SurgicalHydraConfig", "SurgicalWhisperConfig", "TrainConfig",
    "WhisperidouConfig", "WhisperimaxConfig", "config_from_dict", "load_config",
]
