"""The port's ``surgical_hubert_hydra`` over a HuBERT encoder, at the widths
of a configuration file that names ``family: hubert_hydra``, and the
operations of its work.

``build`` makes the model with the configuration's published widths and
gives it the seeded state dict, which it returns beside the model (the
reference takes the same dict). ``flops`` counts the operations of the work
a driver did (``crops``: 4 s training crops stepped, forward and backward)
by ``metrics/flops.py``.
"""

from __future__ import annotations

import warnings

import torch

from h100bench.harness import weights
from h100bench.metrics.flops import hubert_hydra_train_crop_flops

CROP_SAMPLES = 64_000


def build(run, cfg, device: torch.device):
    from segma_tpu_torch.models import Models
    from segma_tpu_torch.models.hubert.encoder import HubertEncoderConfig
    from segma_tpu_torch.utils.encoders import MultiLabelEncoder

    enc = run.config["encoder"]
    enc_cfg = HubertEncoderConfig(
        hidden_size=enc["hidden_size"], n_layers=enc["num_hidden_layers"],
        n_heads=enc["num_attention_heads"], ffn_dim=enc["intermediate_size"],
        conv_dim=tuple(enc["conv_dim"]), conv_kernels=tuple(enc["conv_kernel"]),
        conv_strides=tuple(enc["conv_stride"]), pos_conv_kernel=enc["num_conv_pos_embeddings"],
        pos_conv_groups=enc["num_conv_pos_embedding_groups"])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the encoder is random by design: no snapshot
        model = Models[cfg.model.name](MultiLabelEncoder(cfg.data.classes), cfg, device=device,
                                       generator=torch.Generator().manual_seed(0),
                                       enc_cfg=enc_cfg)
    sd = weights.seeded_state_dict(model.module, run.seed, device)
    weights.load_into(model.module, sd)
    return model, sd


def flops(config: dict, work: dict) -> float | None:
    """The operations of ``work`` ({"crops": n}); None for work of another
    kind."""
    if set(work) != {"crops"}:
        return None
    n_labels = len(config["program"]["data"]["classes"])
    return work["crops"] * hubert_hydra_train_crop_flops(config["encoder"], CROP_SAMPLES,
                                                         n_labels)
