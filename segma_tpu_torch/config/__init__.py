"""Config subset the serving slice reads (counterpart of
``segma_tpu/config/base.py``).

Only what inference over ``surgical_hydra`` needs is modelled: the audio
geometry, the label classes, the model's hyper-parameters and the compute
precision. ``load_config`` reads the same YAML files as the JAX package
(``default.yml`` plus the per-model YAML) with ``a.b.c=value`` overrides;
sections and training fields this port does not model yet are skipped.
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


@dataclass
class LSTMConfig:
    hidden_size: int
    num_layers: int
    bidirectional: bool
    dropout: float


@dataclass
class SurgicalHydraConfig:
    encoder: str
    encoder_layers: list[int]
    reduction: str
    lstm: LSTMConfig
    classifier: int
    fast_context: bool = False


@dataclass
class ModelConfig:
    name: str
    chkp_path: str | None = None
    config: SurgicalHydraConfig | None = None


@dataclass
class TrainConfig:
    precision: str = "bf16"  # compute dtype: bf16 | f32


@dataclass
class Config:
    data: DataConfig
    audio: AudioConfig
    model: ModelConfig
    train: TrainConfig = field(default_factory=TrainConfig)


_MODEL_CONFIG_TYPES: dict[str, type] = {"surgical_hydra": SurgicalHydraConfig}


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
        sub = {"lstm": LSTMConfig}.get(name) if cls is SurgicalHydraConfig else None
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
    train_d = config_d.get("train") or {}
    return Config(
        data=DataConfig(classes=list(config_d["data"]["classes"])),
        audio=_build(AudioConfig, config_d["audio"], "config.audio"),
        model=_build(ModelConfig, model_d, "config.model"),
        train=TrainConfig(precision=train_d.get("precision", "bf16")),
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
    "AudioConfig", "Config", "ConfigError", "DataConfig", "LSTMConfig",
    "ModelConfig", "SurgicalHydraConfig", "TrainConfig", "config_from_dict",
    "load_config",
]
