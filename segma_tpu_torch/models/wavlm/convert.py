"""An HF ``WavLMModel`` snapshot -> flax-layout parameter trees (a copy of
``segma_tpu/models/wavlm/convert.py``; numpy, reading safetensors with the
port's own reader or ``*.bin`` with torch).

HuBERT's layout (``models/hubert/convert.py``, either layout of the
config: WavLM-base's or WavLM-Large's) plus each layer's
``gru_rel_pos_linear`` and ``gru_rel_pos_const`` (1, H, 1, 1), and layer
0's ``rel_attn_embed.weight`` (buckets, H), which the tree holds as the
bare leaf ``rel_attn_embed``.
"""

from __future__ import annotations

import json
from pathlib import Path

from segma_tpu_torch.models.hubert.convert import (
    _as_f32,
    _dense,
    _load_raw,
    _normalize_keys,
    convert_hubert_state_dict,
    layout_keys,
)
from segma_tpu_torch.models.wavlm.encoder import WavLMEncoderConfig


def read_wavlm_config(snapshot: Path) -> WavLMEncoderConfig:
    """An HF config.json -> the encoder config (WavLM-base without one)."""
    cfg_p = Path(snapshot) / "config.json"
    if not cfg_p.exists():
        return WavLMEncoderConfig.base()
    with cfg_p.open() as f:
        cfg = json.load(f)
    return WavLMEncoderConfig(
        hidden_size=cfg["hidden_size"],
        n_layers=cfg["num_hidden_layers"],
        n_heads=cfg["num_attention_heads"],
        ffn_dim=cfg["intermediate_size"],
        conv_dim=tuple(cfg["conv_dim"]),
        conv_kernels=tuple(cfg["conv_kernel"]),
        conv_strides=tuple(cfg["conv_stride"]),
        pos_conv_kernel=cfg.get("num_conv_pos_embeddings", 128),
        pos_conv_groups=cfg.get("num_conv_pos_embedding_groups", 16),
        num_buckets=cfg.get("num_buckets", 320),
        max_distance=cfg.get("max_bucket_distance", 800),
        **layout_keys(cfg),
    )


def convert_wavlm_params(path: Path) -> tuple[WavLMEncoderConfig, dict, dict]:
    """(config, feature_extractor params, transformer params)."""
    cfg = read_wavlm_config(Path(path))
    sd = _normalize_keys(_load_raw(Path(path)))
    fe, tr = convert_hubert_state_dict(sd, cfg)
    for i in range(cfg.n_layers):
        pre = f"encoder.layers.{i}.attention"
        attn = tr[f"layers_{i}"]["attention"]
        attn["gru_rel_pos_linear"] = _dense(sd, f"{pre}.gru_rel_pos_linear")
        attn["gru_rel_pos_const"] = sd[f"{pre}.gru_rel_pos_const"]
        if f"{pre}.rel_attn_embed.weight" in sd:
            attn["rel_attn_embed"] = sd[f"{pre}.rel_attn_embed.weight"]
    return cfg, fe, _as_f32(tr)

