"""Offline HuBERT checkpoint -> flax-layout parameter tree (a copy of
``segma_tpu/models/hubert/convert.py``; numpy, plus torch for ``*.bin``).

Both layouts of HF's configs: the base models' (``feat_extract_norm``
"group", post-norm layers) and the Large models' (``"layer"``: a LayerNorm
after every conv; ``do_stable_layer_norm``: pre-norm layers), with or
without ``conv_bias`` (``layout_keys``).

Accepts both checkpoint families:

- HF ``HubertModel`` snapshots (config.json + model.safetensors /
  pytorch_model.bin), keys such as ``encoder.layers.0.attention.q_proj.weight``
  with a weight-normed positional conv stored as parametrizations;
- torchaudio ``HuBERTPretrainModel`` checkpoints (a ``state_dict`` whose keys
  carry a ``model.`` prefix and ``wav2vec2.encoder.transformer...`` paths,
  the positional conv stored as ``weight_g``/``weight_v``).

The tree has flax's names and layouts, so ``convert.flax_to_torch`` loads it
into the port's modules, and its frozen part hashes to the JAX package's
fingerprint.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any

import numpy as np
import torch

from segma_tpu_torch.models.hubert.encoder import FEAT_EXTRACT_NORMS, HubertEncoderConfig
from segma_tpu_torch.utils.safetensors import load_file


def layout_keys(cfg: dict) -> dict:
    """The layout of an HF HuBERT or WavLM config.json, as the encoder
    config's keywords: ``feat_extract_norm`` ("group", the base models', or
    "layer", the Large ones'), ``conv_bias`` and ``do_stable_layer_norm``
    (HF's defaults where absent). Raises ValueError, naming the key, on a
    value the port cannot build."""
    norm = cfg.get("feat_extract_norm", "group")
    if norm not in FEAT_EXTRACT_NORMS:
        raise ValueError(f"config.json: feat_extract_norm={norm!r} cannot be built (the port "
                         f"builds {' or '.join(map(repr, FEAT_EXTRACT_NORMS))})")
    flags = {}
    for key in ("conv_bias", "do_stable_layer_norm"):
        value = cfg.get(key, False)
        if not isinstance(value, bool):
            raise ValueError(f"config.json: {key}={value!r} cannot be built (needs true or false)")
        flags[key] = value
    return dict(feat_extract_norm=norm, conv_bias=flags["conv_bias"],
                stable_layer_norm=flags["do_stable_layer_norm"])


def read_hubert_config(snapshot: Path) -> HubertEncoderConfig:
    """An HF config.json -> the encoder config (HuBERT-base without one)."""
    cfg_p = Path(snapshot) / "config.json"
    if not cfg_p.exists():
        return HubertEncoderConfig.base()
    with cfg_p.open() as f:
        cfg = json.load(f)
    return HubertEncoderConfig(
        hidden_size=cfg["hidden_size"],
        n_layers=cfg["num_hidden_layers"],
        n_heads=cfg["num_attention_heads"],
        ffn_dim=cfg["intermediate_size"],
        conv_dim=tuple(cfg["conv_dim"]),
        conv_kernels=tuple(cfg["conv_kernel"]),
        conv_strides=tuple(cfg["conv_stride"]),
        pos_conv_kernel=cfg.get("num_conv_pos_embeddings", 128),
        pos_conv_groups=cfg.get("num_conv_pos_embedding_groups", 16),
        **layout_keys(cfg),
    )


def _np(v: Any) -> np.ndarray:
    """A tensor of a torch pickle as numpy (bf16, which numpy lacks, as f32)."""
    if isinstance(v, torch.Tensor):
        return (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    return np.asarray(v)


def _load_bins(snapshot: Path) -> dict[str, np.ndarray]:
    bins = sorted(Path(snapshot).glob("*.bin"))
    if not bins:
        raise FileNotFoundError(f"no model.safetensors or *.bin weights under {snapshot}")
    out: dict[str, np.ndarray] = {}
    for b in bins:
        sd = torch.load(b, map_location="cpu", weights_only=True)
        out.update({k: _np(v) for k, v in sd.items()})
    return out


def _load_raw(path: Path) -> dict[str, np.ndarray]:
    path = Path(path)
    if path.is_dir():
        st = path / "model.safetensors"
        return load_file(st) if st.exists() else _load_bins(path)
    # a single torch checkpoint file (torchaudio / lightning style)
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("state_dict", ckpt)
    return {k: _np(v) for k, v in sd.items()}


def _normalize_keys(sd: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Rewrite torchaudio-style keys onto the HF naming used below."""
    out: dict[str, np.ndarray] = {}
    for k, v in sd.items():
        k = k.removeprefix("model.").removeprefix("wav2vec2.")
        k = k.replace("encoder.transformer.", "encoder.")
        k = k.replace("encoder.feature_projection.", "feature_projection.")
        # torchaudio weight-norm naming -> HF parametrizations naming
        k = k.replace("pos_conv_embed.conv.weight_g",
                      "pos_conv_embed.conv.parametrizations.weight.original0")
        k = k.replace("pos_conv_embed.conv.weight_v",
                      "pos_conv_embed.conv.parametrizations.weight.original1")
        out[k] = v
    return out


def _dense(sd: dict[str, np.ndarray], name: str, bias: bool = True) -> dict[str, np.ndarray]:
    """torch Linear -> flax Dense params (shared with the Whisper converter)."""
    p = {"kernel": np.ascontiguousarray(sd[f"{name}.weight"].T)}
    if bias:
        p["bias"] = sd[f"{name}.bias"]
    return p


def _layernorm(sd: dict[str, np.ndarray], name: str) -> dict[str, np.ndarray]:
    return {"scale": sd[f"{name}.weight"], "bias": sd[f"{name}.bias"]}


def _pos_conv_weight(sd: dict[str, np.ndarray]) -> np.ndarray:
    """The weight-normed positional conv kernel: w = g * v / ||v|| over dims
    (0, 1), then torch (out, in/groups, k) -> flax (k, in/groups, out)."""
    base = "encoder.pos_conv_embed.conv"
    if f"{base}.weight" in sd:
        w = sd[f"{base}.weight"]
    else:
        g = sd[f"{base}.parametrizations.weight.original0"]
        v = sd[f"{base}.parametrizations.weight.original1"]
        norm = np.sqrt((v**2).sum(axis=(0, 1), keepdims=True))
        w = g * v / np.maximum(norm, 1e-12)
    return np.ascontiguousarray(w.transpose(2, 1, 0))


def convert_hubert_params(path: Path) -> tuple[HubertEncoderConfig, dict, dict]:
    """(config, feature_extractor params, transformer params)."""
    cfg = read_hubert_config(Path(path))
    sd = _normalize_keys(_load_raw(Path(path)))
    fe, tr = convert_hubert_state_dict(sd, cfg)
    return cfg, fe, tr


def convert_hubert_state_dict(
    sd: dict[str, np.ndarray], cfg: HubertEncoderConfig
) -> tuple[dict, dict]:
    """A normalized raw state dict (``_normalize_keys``) -> (feature_extractor,
    transformer) params."""
    fe: dict = {}
    for i in range(len(cfg.conv_kernels)):
        pre = f"feature_extractor.conv_layers.{i}"
        w = sd[f"{pre}.conv.weight"]
        fe[f"conv_{i}"] = {"kernel": np.ascontiguousarray(w.transpose(2, 1, 0))}
        if cfg.conv_bias:
            fe[f"conv_{i}"]["bias"] = sd[f"{pre}.conv.bias"]
        if cfg.feat_extract_norm == "layer":  # a LayerNorm after every conv
            fe[f"layer_norm_{i}"] = _layernorm(sd, f"{pre}.layer_norm")
    if cfg.feat_extract_norm == "group":  # HF names conv 0's GroupNorm layer_norm too
        fe["group_norm"] = _layernorm(sd, "feature_extractor.conv_layers.0.layer_norm")

    tr: dict = {
        "feature_layer_norm": _layernorm(sd, "feature_projection.layer_norm"),
        "feature_projection": _dense(sd, "feature_projection.projection"),
        "pos_conv": {"kernel": _pos_conv_weight(sd),
                     "bias": sd["encoder.pos_conv_embed.conv.bias"]},
        "layer_norm": _layernorm(sd, "encoder.layer_norm"),
    }
    for i in range(cfg.n_layers):
        pre = f"encoder.layers.{i}"
        tr[f"layers_{i}"] = {
            "attention": {
                "q_proj": _dense(sd, f"{pre}.attention.q_proj"),
                "k_proj": _dense(sd, f"{pre}.attention.k_proj"),
                "v_proj": _dense(sd, f"{pre}.attention.v_proj"),
                "out_proj": _dense(sd, f"{pre}.attention.out_proj"),
            },
            "layer_norm": _layernorm(sd, f"{pre}.layer_norm"),
            "intermediate_dense": _dense(sd, f"{pre}.feed_forward.intermediate_dense"),
            "output_dense": _dense(sd, f"{pre}.feed_forward.output_dense"),
            "final_layer_norm": _layernorm(sd, f"{pre}.final_layer_norm"),
        }
    return _as_f32(fe), _as_f32(tr)


def _as_f32(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _as_f32(v) for k, v in tree.items()}
    return np.asarray(tree, dtype=np.float32)
