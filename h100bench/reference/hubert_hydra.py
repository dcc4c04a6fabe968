"""Plain ``surgical_hubert_hydra`` in f32: HuBERT-base as published, with
segma's head, for ``training.train_steps``.

The model (segma's ``surgical_hubert_hydra``): the frozen convolutional
front end (seven bias-free convolutions, a per-channel GroupNorm after the
first, exact GELU); LayerNorm and the feature projection; the grouped
positional convolution (its extra last frame dropped) through GELU, added,
then LayerNorm; post-LayerNorm layers (attention with biased q, k, v, out;
an exact-GELU MLP); the softmax-weighted sum of the layers' outputs;
dropout 0.5 in training, its keep mask ``torch.rand`` over (crops, frames,
hidden) from the trainer's generator; one linear head per label.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from h100bench.reference.common import Cast, layer_norm, softmax_mix
from h100bench.reference.training import CHUNK

DROPOUT = 0.5
FROZEN = ("feature_extractor.",)


def frames(samples: int, enc: dict) -> int:
    n = samples
    for k, s in zip(enc["conv_kernel"], enc["conv_stride"]):
        n = (n - k) // s + 1
    return n


def crop_frames(config: dict) -> int:
    """The frames of a training crop at a configuration's widths."""
    return frames(CHUNK, config["encoder"])


def model(sd: dict, config: dict, device, precision: str = "f32") -> "HubertHydra":
    """The reference of a configuration file, from the seeded state dict."""
    return HubertHydra(sd, config["encoder"], device, precision)


class HubertHydra:
    """The model's weights (f32 copies of the state dict ``sd``, the
    trainable ones leaves that take gradients) and its forward."""

    def __init__(self, sd: dict, enc: dict, device, precision: str = "f32") -> None:
        self.enc, self.device = enc, torch.device(device)
        self.cast = Cast(precision)
        self.params = {k: v.detach().to(device=device, dtype=torch.float32).clone()
                       for k, v in sd.items()}
        for k, v in self.params.items():
            v.requires_grad_(not k.startswith(FROZEN))
        self.trainable = {k: v for k, v in self.params.items() if v.requires_grad}

    def front_end(self, wav: torch.Tensor) -> torch.Tensor:
        p, c = self.params, self.cast
        x = wav[:, None, :]
        with torch.no_grad():
            for i, (k, s) in enumerate(zip(self.enc["conv_kernel"], self.enc["conv_stride"])):
                x = c.conv1d(x, p[f"feature_extractor.conv_{i}.weight"], stride=s)
                if i == 0:
                    x = F.group_norm(x, x.shape[1], p["feature_extractor.group_norm.weight"],
                                     p["feature_extractor.group_norm.bias"], 1e-5)
                x = F.gelu(x)
        return x.transpose(1, 2)

    def forward(self, wav: torch.Tensor, keep: torch.Tensor | None) -> torch.Tensor:
        """(B, 64000) f32 -> (B, frames, labels) logits; ``keep``: the dropout
        keep mask of the layer sum, None for none."""
        p, c = self.params, self.cast
        feats = self.front_end(wav)
        x = layer_norm(feats, p, "encoder.feature_layer_norm")
        x = c.linear(x, p["encoder.feature_projection.weight"],
                     p["encoder.feature_projection.bias"])
        k = self.enc["num_conv_pos_embeddings"]
        pos = c.conv1d(x.transpose(1, 2), p["encoder.pos_conv.weight"], p["encoder.pos_conv.bias"],
                       padding=k // 2, groups=self.enc["num_conv_pos_embedding_groups"])
        if k % 2 == 0:
            pos = pos[:, :, :-1]
        x = layer_norm(x + F.gelu(pos.transpose(1, 2)), p, "encoder.layer_norm")
        b, s, d = x.shape
        heads = self.enc["num_attention_heads"]
        hd = d // heads
        outs = []
        for i in range(self.enc["num_hidden_layers"]):
            q = f"encoder.layers.{i}"
            proj = lambda n, h: c.linear(h, p[f"{q}.attention.{n}.weight"],  # noqa: E731
                                         p[f"{q}.attention.{n}.bias"])
            split = lambda t: t.view(b, s, heads, hd).transpose(1, 2)  # noqa: E731
            a = c.attention(split(proj("q_proj", x)), split(proj("k_proj", x)),
                            split(proj("v_proj", x)), hd**-0.5)
            x = layer_norm(x + proj("out_proj", a.transpose(1, 2).reshape(b, s, d)), p,
                           f"{q}.layer_norm")
            h = F.gelu(c.linear(x, p[f"{q}.intermediate_dense.weight"],
                                p[f"{q}.intermediate_dense.bias"]))
            h = c.linear(h, p[f"{q}.output_dense.weight"], p[f"{q}.output_dense.bias"])
            x = layer_norm(x + h, p, f"{q}.final_layer_norm")
            outs.append(x)
        mixed = softmax_mix(torch.stack(outs), p["layer_mix.layer_weights"])
        if keep is not None:
            mixed = torch.where(keep, mixed / (1.0 - DROPOUT), torch.zeros_like(mixed))
        return c.linear(mixed, p["heads.heads.weight"], p["heads.heads.bias"])

    def dropout_keep(self, gen: torch.Generator, crops: int, n_frames: int) -> torch.Tensor:
        """One step's keep mask of the layer sum's dropout, drawn from ``gen``."""
        return torch.rand((crops, n_frames, self.enc["hidden_size"]), generator=gen,
                          device=self.device) < 1.0 - DROPOUT
