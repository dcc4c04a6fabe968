"""Config subset the port reads (counterpart of ``segma_tpu/config/base.py``).

What serving and training the five Whisper variants and
``surgical_hubert_hydra`` need is modelled: the dataset, the audio
geometry, the label classes, the models' hyper-parameters and the training
fields of the host-data, one-process, per-step path. ``load_config`` reads the same YAML files as the JAX package
(``default.yml`` plus the per-model YAML) with ``a.b.c=value`` overrides.
The ``wandb`` and ``mesh`` sections are skipped. A training key of the JAX
schema that the port does not model yet is accepted only at the value that
means "off" (``UNPORTED_TRAIN``); any other value raises ``ConfigError``.
``pyyaml`` is imported inside ``load_config`` only, so a program that builds
its ``Config`` in code does not need it.
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
class ModelConfig:
    name: str
    chkp_path: str | None = None
    config: (
        WhisperidouConfig | WhisperimaxConfig | SurgicalWhisperConfig | HydraWhisperConfig
        | SurgicalHydraConfig | SurgicalHubertHydraConfig | None
    ) = None


@dataclass
class SchedulerConfig:
    patience: int = 3  # plateau epochs before the LR drops tenfold


@dataclass
class DataloaderConfig:
    num_workers: int = 8  # sampler threads; 1 gives a deterministic batch order


@dataclass
class TrainConfig:
    lr: float = 1e-3
    batch_size: int = 32
    max_epochs: int = 100
    validation_metric: str = "loss"  # loss | f1_score
    extra_val_metrics: list[str] = field(default_factory=lambda: ["loss", "f1_score"])
    seed: int | None = None
    precision: str = "bf16"  # compute dtype: bf16 | f32
    log_every_n_steps: int = 50  # per-step loss records; 0 disables
    early_stop_patience: int = 10
    save_top_k: int = 5  # epoch checkpoints kept by the monitored metric; -1 keeps all
    class_weights: list[float] | None = None
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    dataloader: DataloaderConfig = field(default_factory=DataloaderConfig)


# JAX training keys the port does not model yet -> the values it accepts
# (each means the feature is off; data_cache "auto" resolves to the host path,
# the only one ported)
UNPORTED_TRAIN: dict[str, tuple] = {
    "dispatch": ("step",),
    "data_cache": ("host", "auto"),
    "device_cache_budget_gb": (12.0,),
    "grad_accum_steps": (1,),
    "transport": ("f32",),
    "remat": (False,),
    "profiler": (None,),
    "debug_nans": (False,),
    "host_rss_limit_gb": (None,),
    "val_every_n_epochs": (1,),
}
UNPORTED_SCHEDULER: dict[str, tuple] = {
    "type": ("plateau",),
    "warmup_steps": (0,),
    "min_lr_ratio": (0.0,),
}


@dataclass
class Config:
    data: DataConfig
    audio: AudioConfig
    model: ModelConfig
    train: TrainConfig = field(default_factory=TrainConfig)


_MODEL_CONFIG_TYPES: dict[str, type] = {
    "whisperidou": WhisperidouConfig,
    "whisperimax": WhisperimaxConfig,
    "surgical_whisper": SurgicalWhisperConfig,
    "hydra_whisper": HydraWhisperConfig,
    "surgical_hydra": SurgicalHydraConfig,
    "surgical_hubert_hydra": SurgicalHubertHydraConfig,
}
_NESTED: dict[tuple[type, str], type] = {
    (WhisperimaxConfig, "lstm"): LSTMConfig,
    (HydraWhisperConfig, "lstm"): LSTMConfig,
    (SurgicalHydraConfig, "lstm"): LSTMConfig,
    (TrainConfig, "scheduler"): SchedulerConfig,
    (TrainConfig, "dataloader"): DataloaderConfig,
}
_UNPORTED: dict[type, dict[str, tuple]] = {
    TrainConfig: UNPORTED_TRAIN,
    SchedulerConfig: UNPORTED_SCHEDULER,
}


def _build(cls: type, data: dict, path: str) -> Any:
    """Strict dict -> dataclass for the modelled fields (unknown keys raise;
    unported keys raise unless they hold their "off" value)."""
    if not isinstance(data, dict):
        raise ConfigError(f"{path}: expected a mapping for {cls.__name__}")
    data = dict(data)
    for name, accepted in _UNPORTED.get(cls, {}).items():
        if name in data:
            value = data.pop(name)
            if value not in accepted:
                raise ConfigError(
                    f"{path}.{name}={value!r} is not ported yet; the port accepts "
                    f"{' or '.join(map(repr, accepted))}"
                )
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = sorted(set(data) - set(fields))
    if unknown:
        raise ConfigError(f"{path}: unknown keys {unknown} for {cls.__name__}")
    kwargs = {}
    for name, value in data.items():
        sub = _NESTED.get((cls, name))
        kwargs[name] = _build(sub, value, f"{path}.{name}") if sub else value
    missing = [
        n for n, f in fields.items()
        if n not in kwargs
        and f.default is dataclasses.MISSING
        and f.default_factory is dataclasses.MISSING
    ]
    if missing:
        raise ConfigError(f"{path}: missing required fields {missing}")
    return cls(**kwargs)


def config_from_dict(config_d: dict) -> Config:
    """Build a ``Config`` from the shared YAML layout."""
    model_d = dict(config_d["model"])
    name = model_d["name"]
    if name not in _MODEL_CONFIG_TYPES:
        raise ConfigError(
            f"model {name!r} is not ported; ported models: {sorted(_MODEL_CONFIG_TYPES)}"
        )
    if model_d.get("config") is not None:
        model_d["config"] = _build(
            _MODEL_CONFIG_TYPES[name], model_d["config"], "config.model.config"
        )
    data_d = dict(config_d["data"])
    data_d["classes"] = list(data_d["classes"])
    train = _build(TrainConfig, config_d.get("train") or {}, "config.train")
    train.lr = float(train.lr)
    if train.validation_metric not in ("loss", "f1_score"):
        raise ConfigError(
            f"config.train.validation_metric={train.validation_metric!r}: the port "
            "monitors 'loss' or 'f1_score'"
        )
    unported = sorted(set(train.extra_val_metrics) - {"loss", "f1_score"})
    if unported:
        raise ConfigError(
            f"config.train.extra_val_metrics: {unported} are not ported yet "
            "(the port computes 'loss' and 'f1_score')"
        )
    return Config(
        data=_build(DataConfig, data_d, "config.data"),
        audio=_build(AudioConfig, config_d["audio"], "config.audio"),
        model=_build(ModelConfig, model_d, "config.model"),
        train=train,
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
    return config_from_dict(config_d)


__all__ = [
    "AudioConfig", "Config", "ConfigError", "DataConfig", "DataloaderConfig",
    "HydraWhisperConfig", "LSTMConfig", "ModelConfig", "SchedulerConfig",
    "SurgicalHubertHydraConfig", "SurgicalHydraConfig", "SurgicalWhisperConfig",
    "TrainConfig", "WhisperidouConfig", "WhisperimaxConfig", "config_from_dict",
    "load_config",
]
