"""Import trained reference (PyTorch Lightning) checkpoints (counterpart of
``segma_tpu/convert_reference.py``).

The migration path for users of the reference framework: a Lightning
``.ckpt`` from its ``scripts/train.py`` (state_dict keys such as
``w_encoder.*``, ``lstm_shared.weight_ih_l0``,
``task_heads.linear_head_<label>.weight``, ``layer_weights``) becomes the
JAX package's flax parameter tree, numpy arrays in flax's names and layouts,
equal leaf for leaf to what the JAX package's importer gives, and is loaded
into the port's module.

Weight mapping:

- torch ``nn.LSTM`` stacks gates [i, f, g, o] along dim 0 of
  ``weight_ih/hh`` and carries two bias vectors; the flax
  ``OptimizedLSTMCell`` keeps per-gate kernels (``i{i,f,g,o}`` input, no
  bias; ``h{i,f,g,o}`` hidden, one bias), so ``h{g}.bias = bias_ih[g] +
  bias_hh[g]``; the port's ``BiLSTM`` then holds that sum in ``bias_hh``;
- the per-label ``Linear(h, 1)`` hydra heads concatenate column-wise into
  one ``Dense(h, n_labels)``;
- the Whisper encoder's ``w_encoder.`` keys go through the snapshot
  converter's helpers (``models/whisper/convert.py``), HuBERT's
  ``wav2vec2.`` keys through ``models/hubert/convert.py``.

``torch.load`` runs with ``weights_only=False``, as a Lightning checkpoint
pickles more than tensors: a checkpoint whose pickle names ``lightning``
classes needs them importable where it is loaded.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

import numpy as np
import torch

from segma_tpu_torch.convert import load_flax_subtrees
from segma_tpu_torch.models.base import SegmentationModel

_GATES = ("i", "f", "g", "o")


def _load_state_dict(ckpt_path: Path) -> dict[str, np.ndarray]:
    ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    return {
        k: (v.detach().float().numpy() if isinstance(v, torch.Tensor)
            else np.asarray(v, dtype=np.float32))
        for k, v in sd.items()
    }


def _convert_lstm(sd: dict, prefix: str, num_layers: int, bidirectional: bool) -> dict:
    """torch nn.LSTM state -> flax BiLSTM param subtree."""
    out: dict[str, Any] = {}
    cell_idx = 0
    for layer in range(num_layers):
        for suffix in ["", "_reverse"] if bidirectional else [""]:
            w_ih = sd[f"{prefix}.weight_ih_l{layer}{suffix}"]  # (4h, in)
            w_hh = sd[f"{prefix}.weight_hh_l{layer}{suffix}"]  # (4h, h)
            b_ih = sd[f"{prefix}.bias_ih_l{layer}{suffix}"]
            b_hh = sd[f"{prefix}.bias_hh_l{layer}{suffix}"]
            h = w_hh.shape[1]
            cell: dict[str, Any] = {}
            for gi, g in enumerate(_GATES):
                s = slice(gi * h, (gi + 1) * h)
                cell[f"i{g}"] = {"kernel": np.ascontiguousarray(w_ih[s].T)}
                cell[f"h{g}"] = {
                    "kernel": np.ascontiguousarray(w_hh[s].T),
                    "bias": b_ih[s] + b_hh[s],
                }
            out[f"OptimizedLSTMCell_{cell_idx}"] = cell
            cell_idx += 1
    return out


def _convert_hydra_heads(sd: dict, labels: tuple[str, ...]) -> dict:
    """per-label Linear(h, 1) heads -> fused Dense(h, n_labels)."""
    kernels, biases = [], []
    for label in labels:
        kernels.append(sd[f"task_heads.linear_head_{label}.weight"][0])  # (1, h)
        biases.append(sd[f"task_heads.linear_head_{label}.bias"][0])  # (1,)
    return {"heads": {"kernel": np.stack(kernels, axis=1),  # (h, n_labels)
                      "bias": np.asarray(biases, np.float32)}}


def _convert_whisper_encoder(sd: dict) -> dict:
    """``w_encoder.``-prefixed HF WhisperEncoder state -> flax params."""
    from segma_tpu_torch.models.whisper import convert as wc

    enc_sd = {k[len("w_encoder."):]: v for k, v in sd.items() if k.startswith("w_encoder.")}
    n_layers = max(int(k.split(".")[1]) for k in enc_sd if k.startswith("layers.")) + 1
    params: dict = {
        "conv1": wc._conv(enc_sd, "conv1"),
        "conv2": wc._conv(enc_sd, "conv2"),
        "embed_positions": enc_sd["embed_positions.weight"],
        "layer_norm": wc._layernorm(enc_sd, "layer_norm"),
    }
    for i in range(n_layers):
        pre = f"layers.{i}"
        params[f"layers_{i}"] = {
            "self_attn_layer_norm": wc._layernorm(enc_sd, f"{pre}.self_attn_layer_norm"),
            "self_attn": {
                "q_proj": wc._dense(enc_sd, f"{pre}.self_attn.q_proj"),
                "k_proj": wc._dense(enc_sd, f"{pre}.self_attn.k_proj", bias=False),
                "v_proj": wc._dense(enc_sd, f"{pre}.self_attn.v_proj"),
                "out_proj": wc._dense(enc_sd, f"{pre}.self_attn.out_proj"),
            },
            "final_layer_norm": wc._layernorm(enc_sd, f"{pre}.final_layer_norm"),
            "fc1": wc._dense(enc_sd, f"{pre}.fc1"),
            "fc2": wc._dense(enc_sd, f"{pre}.fc2"),
        }
    return params


def _convert_mlp_classifier(sd: dict, prefix: str = "classifier") -> dict:
    """torch ``nn.Sequential(Linear, ReLU, Linear)`` -> flax MLPHead params:
    the reference's ``classifier.0`` / ``classifier.2`` become ``Dense_0`` /
    ``Dense_1``."""
    out: dict[str, Any] = {}
    idxs = sorted({int(k.split(".")[1]) for k in sd if k.startswith(f"{prefix}.")})
    for flax_i, torch_i in enumerate(idxs):
        out[f"Dense_{flax_i}"] = {
            "kernel": np.ascontiguousarray(sd[f"{prefix}.{torch_i}.weight"].T),
            "bias": sd[f"{prefix}.{torch_i}.bias"],
        }
    return out


def _torch_linear(sd: dict, name: str) -> dict:
    return {"kernel": np.ascontiguousarray(sd[f"{name}.weight"].T), "bias": sd[f"{name}.bias"]}


def _reduction(model: SegmentationModel) -> str | None:
    layer_mix = getattr(model.module, "layer_mix", None)
    return None if layer_mix is None else layer_mix.reduction


def _import_hubert(sd: dict, model: SegmentationModel) -> dict:
    """surgical_hubert_hydra Lightning checkpoint -> flax params.

    Reference checkpoints carry the whole torchaudio ``wav2vec2.*`` tree
    (their state_dict filter matches an ``encoder.`` prefix that no key
    has), plus ``layer_weights`` and the per-label ``task_heads``. The
    reference's forward uses only the last hidden state despite its
    weighting; the port, like the JAX package, applies the weighting, so
    only a 'weighted' config takes the learnable vector (``encoder_layers=
    [n]`` with ``reduction=average`` reproduces the reference's last layer).
    """
    from segma_tpu_torch.models.hubert.convert import _normalize_keys, convert_hubert_state_dict

    enc_sd = _normalize_keys({k: v for k, v in sd.items() if k.startswith("wav2vec2.")})
    fe, tr = convert_hubert_state_dict(enc_sd, model.module.enc_cfg)
    params: dict[str, Any] = {
        "feature_extractor": fe,
        "encoder": tr,
        "heads": _convert_hydra_heads(sd, model.label_encoder.base_labels),
    }
    if _reduction(model) == "weighted" and "layer_weights" in sd:
        params["layer_mix"] = {"layer_weights": sd["layer_weights"]}
    return params


SUPPORTED_IMPORTS = (
    "whisperidou",
    "whisperimax",
    "surgical_whisper",
    "hydra_whisper",
    "surgical_hydra",
    "surgical_hubert_hydra",
)


def import_reference_checkpoint(ckpt_path: Path | str, model: SegmentationModel) -> dict:
    """Convert a reference Lightning checkpoint into ``model``'s flax param
    tree, load it into ``model.module`` and return it. All six reference
    variants are supported."""
    if model.name not in SUPPORTED_IMPORTS:
        raise ValueError(
            f"reference import supports {'/'.join(SUPPORTED_IMPORTS)} "
            f"(e.g. surgical_hydra), got {model.name!r}"
        )
    sd = _load_state_dict(Path(ckpt_path))

    if model.name == "surgical_hubert_hydra":
        params = _import_hubert(sd, model)
    else:
        params = {"encoder": _convert_whisper_encoder(sd)}
        if model.name in ("surgical_hydra", "hydra_whisper", "whisperimax"):
            lstm_cfg = model.module.lstm_shared.cfg
            # whisperimax's reference attributes: self.lstm, self.linear
            # (Sequential 0/2), self.classifier
            prefix = "lstm" if model.name == "whisperimax" else "lstm_shared"
            params["lstm_shared"] = _convert_lstm(
                sd, prefix, lstm_cfg.num_layers, lstm_cfg.bidirectional
            )
        if model.name in ("surgical_hydra", "hydra_whisper"):
            params["heads"] = _convert_hydra_heads(sd, model.label_encoder.base_labels)
        elif model.name == "whisperimax":
            params["linear_0"] = _torch_linear(sd, "linear.0")
            params["linear_1"] = _torch_linear(sd, "linear.2")
            params["classifier"] = _torch_linear(sd, "classifier")
        else:  # whisperidou / surgical_whisper: Sequential MLP classifier
            params["classifier"] = _convert_mlp_classifier(sd)
        # 'average' keeps a buffer in the reference state_dict; the average
        # reduction has no parameter to fill
        if model.name in ("surgical_hydra", "surgical_whisper") and _reduction(model) == "weighted":
            params["layer_mix"] = {"layer_weights": sd["layer_weights"]}
    params = _as_f32(params)
    lstm = getattr(model.module, "lstm_shared", None)
    load_flax_subtrees(model.module, params, lstm.cfg.bidirectional if lstm is not None else True)
    return params


def _as_f32(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _as_f32(v) for k, v in tree.items()}
    return np.asarray(tree, dtype=np.float32)
