"""The port's ``surgical_hydra`` over a Whisper encoder, at the widths of a
configuration file that names ``family: whisper_hydra``, and the operations
of its work.

``build`` makes the model with the configuration's published encoder widths
and gives it the seeded state dict, which it returns beside the model (the
reference takes the same dict). ``flops`` counts the operations of the work
a driver did (``chunks``: 4 s chunks served) by ``metrics/flops.py``.
"""

from __future__ import annotations

import warnings

import torch

from h100bench.harness import weights
from h100bench.metrics.flops import whisper_hydra_chunk_flops

FRAMES = 199  # a 4 s chunk's frames


def build(run, cfg, device: torch.device):
    from segma_tpu_torch.models import Models
    from segma_tpu_torch.models.whisper.encoder import WhisperEncoderConfig
    from segma_tpu_torch.utils.encoders import MultiLabelEncoder

    enc = run.config["encoder"]
    enc_cfg = WhisperEncoderConfig(
        d_model=enc["d_model"], n_heads=enc["encoder_attention_heads"],
        n_layers=enc["encoder_layers"], ffn_dim=enc["encoder_ffn_dim"],
        n_mels=enc["num_mel_bins"], max_positions=enc["max_source_positions"])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the encoder is random by design: no snapshot
        model = Models[cfg.model.name](MultiLabelEncoder(cfg.data.classes), cfg, device=device,
                                       generator=torch.Generator().manual_seed(0),
                                       enc_cfg=enc_cfg)
    sd = weights.seeded_state_dict(model.module, run.seed, device)
    weights.load_into(model.module, sd)
    return model, sd


def flops(config: dict, work: dict) -> float | None:
    """The operations of ``work`` ({"chunks": n}); None for work of another
    kind."""
    if set(work) != {"chunks"}:
        return None
    program = config["program"]
    return work["chunks"] * whisper_hydra_chunk_flops(
        config["encoder"], program["model"]["config"]["lstm"], len(program["data"]["classes"]),
        FRAMES)
