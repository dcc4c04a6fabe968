"""Plain ``surgical_wavlm_hydra`` in f32: a WavLM encoder as Hugging Face's
``WavLMModel`` computes it, with segma's head, and the serving path's frame
grid worked out again from the audio.

The model, from the configuration's HF keys (``encoder``):

- the convolutional front end: seven convolutions (with a bias where
  ``conv_bias``), each followed by a LayerNorm over its channels where
  ``feat_extract_norm`` is "layer" (HF's ``WavLMLayerNormConvLayer``), or a
  per-channel GroupNorm after the first where it is "group"; exact GELU;
- LayerNorm and the feature projection; the grouped positional convolution
  (its extra last frame dropped) through GELU, added;
- with ``do_stable_layer_norm`` (HF's ``WavLMEncoderStableLayerNorm``):
  pre-LayerNorm layers, ``x + attn(LN(x))`` then ``x + mlp(LN(x))``, and the
  encoder's LayerNorm after the last layer; without it LayerNorm on the
  embedding and post-LayerNorm layers;
- WavLM's attention (HF's ``WavLMAttention``): every score of head h, query
  i and key j takes ``gate[b, h, i] * E[bucket(j - i), h]``, E layer 0's
  table, the T5 buckets of HF's ``_relative_positions_bucket`` (in f32, as
  HF), the gate ``a (b c - 1) + 2`` from a sigmoid of each head's 8-wide
  projection of the layer's input summed in pairs of 4, c the layer's
  per-head constant;
- the hidden states as HF returns them (each layer's input, the final
  output), the softmax-weighted sum of all but the first, one linear head
  per label.

The grid (segma's serving geometry for a raw-waveform model with
``strict_frames``): frames of 320 samples; a window of n samples holds (n -
320) // 321 + 1 of them (one 320-sample kernel, a step of 321 where a kernel
is even), so a 4 s chunk of 64000 samples gives 199 frames and chunks start
every 199 x 320 samples; a file of n samples has its whole chunks' frames,
and for a tail of at least 400 samples (tail - 320) // 321 + 1 more, its
chunk zero-padded.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from h100bench.reference.common import Cast, ieee_f32, softmax_mix

CHUNK = 64_000
FRAME = 320
TAIL_MIN = 400
FRONT_EPS = 1e-5  # HF's nn.LayerNorm and GroupNorm of the front end


def n_windows(samples: int) -> int:
    """Frames of a strict window of ``samples`` samples."""
    return max(0, (samples - FRAME) // (FRAME + 1) + 1)


WINDOWS = n_windows(CHUNK)  # 199
STRIDE = WINDOWS * FRAME  # 63680


def grid(n: int) -> tuple[int, int]:
    """(whole chunks, frames) of a file of ``n`` samples."""
    whole = (n - CHUNK) // STRIDE + 1 if n >= CHUNK else 0
    tail = n - whole * STRIDE
    return whole, whole * WINDOWS + (n_windows(tail) if tail >= TAIL_MIN else 0)


def chunks(n: int) -> int:
    """The chunks a file of ``n`` samples needs (padding not counted)."""
    return -(-grid(n)[1] // WINDOWS)


def relative_buckets(rel: torch.Tensor, num_buckets: int, max_distance: int) -> torch.Tensor:
    """HF's T5-style bucket of each relative position (key - query)."""
    half = num_buckets // 2
    buckets = (rel > 0).to(torch.long) * half
    rel = rel.abs()
    max_exact = half // 2
    large = (max_exact + torch.log(rel.float() / max_exact) / math.log(max_distance / max_exact)
             * (half - max_exact)).to(torch.long)
    large = torch.minimum(large, torch.full_like(large, half - 1))
    return buckets + torch.where(rel < max_exact, rel, large)


def model(sd: dict, config: dict, device, precision: str = "f32") -> "WavLMHydra":
    """The reference of a configuration file, from the seeded state dict."""
    return WavLMHydra(sd, config["encoder"], len(config["program"]["data"]["classes"]), device,
                      precision)


class WavLMHydra:
    """The model on ``device`` from the state dict ``sd`` (the port's
    module's names, where the seeded weights were named), at the published
    widths ``enc`` (HF keys)."""

    def __init__(self, sd: dict, enc: dict, n_labels: int, device, precision: str = "f32",
                 bias: bool = True) -> None:
        self.sd = {k: v.to(device=device, dtype=torch.float32) for k, v in sd.items()}
        self.enc, self.n_labels, self.device = enc, n_labels, torch.device(device)
        self.cast = Cast(precision)
        self.bias = bias  # False: the relative-position bias left out (a planted fault)

    def ln(self, x: torch.Tensor, prefix: str, eps: float) -> torch.Tensor:
        return F.layer_norm(x, x.shape[-1:], self.sd[f"{prefix}.weight"],
                            self.sd[f"{prefix}.bias"], eps)

    def front_end(self, wav: torch.Tensor) -> torch.Tensor:
        """(B, samples) -> (B, frames, conv_dim[-1])."""
        sd, c, enc = self.sd, self.cast, self.enc
        x = wav[:, None, :]
        for i, (k, s) in enumerate(zip(enc["conv_kernel"], enc["conv_stride"])):
            x = c.conv1d(x, sd[f"feature_extractor.conv_{i}.weight"],
                         sd.get(f"feature_extractor.conv_{i}.bias"), stride=s)
            if enc["feat_extract_norm"] == "layer":
                x = self.ln(x.transpose(1, 2), f"feature_extractor.layer_norm_{i}",
                            FRONT_EPS).transpose(1, 2)
            elif i == 0:
                x = F.group_norm(x, x.shape[1], sd["feature_extractor.group_norm.weight"],
                                 sd["feature_extractor.group_norm.bias"], FRONT_EPS)
            x = F.gelu(x)
        return x.transpose(1, 2)

    def position_bias(self, t: int) -> torch.Tensor:
        """(H, T, T): E[bucket(j - i), h]."""
        pos = torch.arange(t, device=self.device)
        ids = relative_buckets(pos[None, :] - pos[:, None], self.enc["num_buckets"],
                               self.enc["max_bucket_distance"])
        return self.sd["encoder.layers.0.attention.rel_attn_embed"][ids].permute(2, 0, 1)

    def attention(self, x: torch.Tensor, i: int, bias: torch.Tensor) -> torch.Tensor:
        sd, c = self.sd, self.cast
        b, t, d = x.shape
        heads = self.enc["num_attention_heads"]
        hd = d // heads
        pre = f"encoder.layers.{i}.attention"

        def proj(name, h):
            return c.linear(h, sd[f"{pre}.{name}.weight"], sd[f"{pre}.{name}.bias"])

        def split(y):
            return y.view(b, t, heads, hd).transpose(1, 2)

        q, k, v = split(proj("q_proj", x)), split(proj("k_proj", x)), split(proj("v_proj", x))
        gate = F.linear(split(x), sd[f"{pre}.gru_rel_pos_linear.weight"],
                        sd[f"{pre}.gru_rel_pos_linear.bias"])
        gate_a, gate_b = torch.sigmoid(gate.view(b, heads, t, 2, 4).sum(-1)).chunk(2, dim=-1)
        gate = gate_a * (gate_b * sd[f"{pre}.gru_rel_pos_const"] - 1.0) + 2.0  # (B, H, T, 1)
        scores = c.grad(torch.matmul(c(q), c(k).transpose(-1, -2))) * hd**-0.5
        if self.bias:
            scores = scores + gate * bias[None]
        a = c.grad(torch.matmul(c(torch.softmax(scores, dim=-1)), c(v)))
        return proj("out_proj", a.transpose(1, 2).reshape(b, t, d))

    def mlp(self, x: torch.Tensor, i: int) -> torch.Tensor:
        sd, c = self.sd, self.cast
        pre = f"encoder.layers.{i}"
        h = F.gelu(c.linear(x, sd[f"{pre}.intermediate_dense.weight"],
                            sd[f"{pre}.intermediate_dense.bias"]))
        return c.linear(h, sd[f"{pre}.output_dense.weight"], sd[f"{pre}.output_dense.bias"])

    def hidden_states(self, wav: torch.Tensor) -> list[torch.Tensor]:
        """HF's ``output_hidden_states``: each layer's input, then the output."""
        sd, c, enc = self.sd, self.cast, self.enc
        eps = enc["layer_norm_eps"]
        stable = enc["do_stable_layer_norm"]
        x = self.ln(self.front_end(wav), "encoder.feature_layer_norm", eps)
        x = c.linear(x, sd["encoder.feature_projection.weight"],
                     sd["encoder.feature_projection.bias"])
        k = enc["num_conv_pos_embeddings"]
        pos = c.conv1d(x.transpose(1, 2), sd["encoder.pos_conv.weight"],
                       sd["encoder.pos_conv.bias"], padding=k // 2,
                       groups=enc["num_conv_pos_embedding_groups"])
        if k % 2 == 0:
            pos = pos[:, :, :-1]
        x = x + F.gelu(pos.transpose(1, 2))
        if not stable:
            x = self.ln(x, "encoder.layer_norm", eps)
        bias = self.position_bias(x.shape[1])
        states = []
        for i in range(enc["num_hidden_layers"]):
            states.append(x)
            pre = f"encoder.layers.{i}"
            if stable:
                x = x + self.attention(self.ln(x, f"{pre}.layer_norm", eps), i, bias)
                x = x + self.mlp(self.ln(x, f"{pre}.final_layer_norm", eps), i)
            else:
                x = self.ln(x + self.attention(x, i, bias), f"{pre}.layer_norm", eps)
                x = self.ln(x + self.mlp(x, i), f"{pre}.final_layer_norm", eps)
        states.append(self.ln(x, "encoder.layer_norm", eps) if stable else x)
        return states

    @torch.no_grad()
    def chunk_logits(self, chunks: torch.Tensor) -> torch.Tensor:
        """(B, 64000) f32 chunks -> (B, 199, labels) logits, in IEEE f32."""
        with ieee_f32():
            mixed = softmax_mix(torch.stack(self.hidden_states(chunks)[1:]),
                                self.sd["layer_mix.layer_weights"])
            return self.cast.linear(mixed, self.sd["heads.heads.weight"],
                                    self.sd["heads.heads.bias"])

    def file_logits(self, pcm: np.ndarray, batch: int = 16) -> torch.Tensor:
        """(frames, labels) f32 logits of a whole file of int16 samples."""
        n = pcm.shape[0]
        _, frames = grid(n)
        n_chunks = -(-frames // WINDOWS)
        audio = torch.from_numpy(pcm.astype(np.float32) / 32768.0).to(self.device)
        audio = F.pad(audio, (0, max(0, (n_chunks - 1) * STRIDE + CHUNK - n)))
        out = []
        for lo in range(0, n_chunks, batch):
            idx = torch.arange(lo, min(n_chunks, lo + batch), device=self.device)
            starts = idx * STRIDE
            windows = audio[starts[:, None] + torch.arange(CHUNK, device=self.device)[None, :]]
            out.append(self.chunk_logits(windows).reshape(-1, self.n_labels))
        return torch.cat(out)[:frames]
