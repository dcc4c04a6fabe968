"""Offline HF Whisper snapshot -> flax-layout encoder tree (a copy of
``segma_tpu/models/whisper/convert.py``).

Reads the local encoder directory (config.json + model.safetensors or
pytorch_model.bin) and rewrites its tensors into the flax
``WhisperEncoder`` tree, which ``convert.flax_to_torch`` loads into the
port's encoder. Nothing is downloaded.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from segma_tpu_torch.models.hubert.convert import _as_f32, _dense, _layernorm, _load_bins
from segma_tpu_torch.models.whisper.encoder import WhisperEncoderConfig
from segma_tpu_torch.utils.safetensors import load_file


def read_encoder_config(snapshot: Path) -> WhisperEncoderConfig:
    """Map an HF config.json to the encoder config."""
    with (Path(snapshot) / "config.json").open() as f:
        cfg = json.load(f)
    return WhisperEncoderConfig(
        d_model=cfg["d_model"],
        n_heads=cfg["encoder_attention_heads"],
        n_layers=cfg["encoder_layers"],
        ffn_dim=cfg["encoder_ffn_dim"],
        n_mels=cfg.get("num_mel_bins", 80),
        max_positions=cfg.get("max_source_positions", 1500),
    )


def _load_state_dict(snapshot: Path) -> dict[str, np.ndarray]:
    """Tensors from model.safetensors (preferred) or the ``*.bin`` pickles."""
    st = Path(snapshot) / "model.safetensors"
    return load_file(st) if st.exists() else _load_bins(snapshot)


def _strip_prefix(sd: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Accept both bare-encoder snapshots and full-model ones."""
    for prefix in ("model.encoder.", "encoder."):
        if any(k.startswith(prefix) for k in sd):
            return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    return sd


def _conv(sd: dict[str, np.ndarray], name: str) -> dict[str, np.ndarray]:
    # torch Conv1d (out, in, k) -> flax (k, in, out)
    return {
        "kernel": np.ascontiguousarray(sd[f"{name}.weight"].transpose(2, 1, 0)),
        "bias": sd[f"{name}.bias"],
    }


def convert_encoder_params(snapshot: Path) -> tuple[WhisperEncoderConfig, dict]:
    """(config, flax params subtree) for the encoder at ``snapshot``."""
    cfg = read_encoder_config(snapshot)
    sd = _strip_prefix(_load_state_dict(snapshot))
    params: dict = {
        "conv1": _conv(sd, "conv1"),
        "conv2": _conv(sd, "conv2"),
        "embed_positions": sd["embed_positions.weight"],
        "layer_norm": _layernorm(sd, "layer_norm"),
    }
    for i in range(cfg.n_layers):
        pre = f"layers.{i}"
        params[f"layers_{i}"] = {
            "self_attn_layer_norm": _layernorm(sd, f"{pre}.self_attn_layer_norm"),
            "self_attn": {
                "q_proj": _dense(sd, f"{pre}.self_attn.q_proj"),
                "k_proj": _dense(sd, f"{pre}.self_attn.k_proj", bias=False),
                "v_proj": _dense(sd, f"{pre}.self_attn.v_proj"),
                "out_proj": _dense(sd, f"{pre}.self_attn.out_proj"),
            },
            "final_layer_norm": _layernorm(sd, f"{pre}.final_layer_norm"),
            "fc1": _dense(sd, f"{pre}.fc1"),
            "fc2": _dense(sd, f"{pre}.fc2"),
        }
    params = {k: _as_f32(v) for k, v in params.items()}
    return cfg, params
