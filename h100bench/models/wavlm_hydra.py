"""The port's ``surgical_wavlm_hydra`` over a WavLM encoder, at the widths
of a configuration file that names ``family: wavlm_hydra``, and the
operations of its work.

``build`` makes the model with the configuration's published widths and
layout and gives it the seeded state dict, which it returns beside the
model (the reference takes the same dict). ``harness.weights`` draws every
weight it has a rule for; WavLM's two bare parameters, which it has none
for, are drawn here from the same seed at scales where the bias counts:
layer 0's relative-position table ``rel_attn_embed`` N(0, 1) and each
layer's gate constant ``gru_rel_pos_const`` 1 + N(0, 0.5). (flax's N(0,
0.02) would leave the bias near 0.05 against scores near 1, and a program
that dropped it would serve the same RTTMs.) ``flops`` counts the
operations of the work a driver did (``chunks``: 4 s chunks served).
"""

from __future__ import annotations

import warnings

import torch

from h100bench.harness import weights
from h100bench.metrics.flops import hubert_front_end_flops, hubert_frames, transformer_layer_flops

CHUNK_SAMPLES = 64_000
# the bare parameters' draws: shift + scale N(0, 1)
BARE_DRAW = {"rel_attn_embed": (1.0, 0.0), "gru_rel_pos_const": (0.5, 1.0)}


def encoder_config(enc: dict):
    """The port's encoder config from the configuration's HF keys."""
    from segma_tpu_torch.models.wavlm.encoder import WavLMEncoderConfig

    return WavLMEncoderConfig(
        hidden_size=enc["hidden_size"], n_layers=enc["num_hidden_layers"],
        n_heads=enc["num_attention_heads"], ffn_dim=enc["intermediate_size"],
        conv_dim=tuple(enc["conv_dim"]), conv_kernels=tuple(enc["conv_kernel"]),
        conv_strides=tuple(enc["conv_stride"]), pos_conv_kernel=enc["num_conv_pos_embeddings"],
        pos_conv_groups=enc["num_conv_pos_embedding_groups"],
        num_buckets=enc["num_buckets"], max_distance=enc["max_bucket_distance"],
        feat_extract_norm=enc["feat_extract_norm"], conv_bias=enc["conv_bias"],
        stable_layer_norm=enc["do_stable_layer_norm"])


def seeded_state_dict(module: torch.nn.Module, seed: int,
                      device: torch.device) -> dict[str, torch.Tensor]:
    """``harness.weights``' draw of every weight with a rule, and the bare
    parameters' from a generator of the same seed."""
    bare = {n: p for n, p in module.named_parameters() if n.split(".")[-1] in BARE_DRAW}
    for p in bare.values():  # the plan skips a tensor that takes no gradient
        p.requires_grad_(False)
    try:
        sd = weights.seeded_state_dict(module, seed, device)
    finally:
        for p in bare.values():
            p.requires_grad_(True)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    for name in sorted(bare):
        scale, shift = BARE_DRAW[name.split(".")[-1]]
        sd[name] = torch.randn(bare[name].shape, generator=gen, device=device) * scale + shift
    return sd


def build(run, cfg, device: torch.device):
    from segma_tpu_torch.models import Models
    from segma_tpu_torch.utils.encoders import MultiLabelEncoder

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the encoder is random by design: no snapshot
        model = Models[cfg.model.name](MultiLabelEncoder(cfg.data.classes), cfg, device=device,
                                       generator=torch.Generator().manual_seed(0),
                                       enc_cfg=encoder_config(run.config["encoder"]))
    sd = seeded_state_dict(model.module, run.seed, device)
    weights.load_into(model.module, sd)
    return model, sd


def chunk_flops(enc: dict, n_labels: int) -> float:
    """One served 4 s chunk: the front end; the projection, the grouped
    positional convolution, the layers (with each head's 8-wide gate
    projection), the layer sum and the heads, forward only."""
    s = hubert_frames(enc, CHUNK_SAMPLES)
    d, c = enc["hidden_size"], enc["conv_dim"][-1]
    groups, k = enc["num_conv_pos_embedding_groups"], enc["num_conv_pos_embeddings"]
    layers = enc["num_hidden_layers"]
    layer = transformer_layer_flops(s, d, enc["intermediate_size"]) + 2 * s * d * 8
    return (hubert_front_end_flops(enc, CHUNK_SAMPLES) + 2 * s * c * d
            + 2 * s * k * d * (d // groups) + layers * layer + 2 * layers * s * d
            + 2 * s * d * n_labels)


def flops(config: dict, work: dict) -> float | None:
    """The operations of ``work`` ({"chunks": n}); None for work of another
    kind."""
    if set(work) != {"chunks"}:
        return None
    n_labels = len(config["program"]["data"]["classes"])
    return work["chunks"] * chunk_flops(config["encoder"], n_labels)
