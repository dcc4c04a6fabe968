"""Plain ``surgical_wavlm_hydra`` in f32 torch, written from Hugging Face's
``WavLMModel`` (``WavLMFeatureEncoder``, ``WavLMEncoder`` and
``WavLMEncoderStableLayerNorm``, ``WavLMAttention``), for the tests to hold
the port to. It imports nothing of the port, of JAX or of the JAX package:
it takes a state dict under the port's module names and a config of HF's
keys, and runs with TF32 off.

- the front end: seven convolutions (biased where ``conv_bias``), after
  each a LayerNorm over the channels (``feat_extract_norm="layer"``) or after
  the first a per-channel GroupNorm (``"group"``), exact GELU;
- LayerNorm and the projection; the grouped positional convolution, its
  extra last frame dropped, through GELU, added;
- ``do_stable_layer_norm``: pre-LayerNorm layers and the encoder's
  LayerNorm after the last; otherwise LayerNorm on the embedding and
  post-LayerNorm layers;
- each score of head h, query i and key j takes ``gate[b, h, i] *
  E[bucket(j - i), h]``: E is layer 0's table, the bucket HF's T5 bucket in
  f32, the gate ``a (b c - 1) + 2`` from the layer input's 8-wide projection
  per head, summed in pairs of 4, through a sigmoid;
- HF's hidden states (each layer's input, the final output), the softmax
  mix of all but the first, one linear head per label.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _ln(sd, x, prefix, eps):
    return F.layer_norm(x, x.shape[-1:], sd[f"{prefix}.weight"], sd[f"{prefix}.bias"], eps)


def buckets(rel: torch.Tensor, num_buckets: int, max_distance: int) -> torch.Tensor:
    half = num_buckets // 2
    out = (rel > 0).to(torch.long) * half
    rel = rel.abs()
    exact = half // 2
    large = (exact + torch.log(rel.float() / exact) / math.log(max_distance / exact)
             * (half - exact)).to(torch.long)
    large = torch.minimum(large, torch.full_like(large, half - 1))
    return out + torch.where(rel < exact, rel, large)


def front_end(sd: dict, enc: dict, wav: torch.Tensor) -> torch.Tensor:
    x = wav[:, None, :]
    for i, (k, s) in enumerate(zip(enc["conv_kernel"], enc["conv_stride"])):
        x = F.conv1d(x, sd[f"feature_extractor.conv_{i}.weight"],
                     sd.get(f"feature_extractor.conv_{i}.bias"), stride=s)
        if enc["feat_extract_norm"] == "layer":
            x = _ln(sd, x.transpose(1, 2), f"feature_extractor.layer_norm_{i}", 1e-5)
            x = x.transpose(1, 2)
        elif i == 0:
            x = F.group_norm(x, x.shape[1], sd["feature_extractor.group_norm.weight"],
                             sd["feature_extractor.group_norm.bias"], 1e-5)
        x = F.gelu(x)
    return x.transpose(1, 2)


def attention(sd: dict, enc: dict, x: torch.Tensor, i: int, bias: torch.Tensor | None):
    b, t, d = x.shape
    heads = enc["num_attention_heads"]
    hd = d // heads
    pre = f"encoder.layers.{i}.attention"

    def proj(name, h):
        return F.linear(h, sd[f"{pre}.{name}.weight"], sd[f"{pre}.{name}.bias"])

    def split(y):
        return y.view(b, t, heads, hd).transpose(1, 2)

    q, k, v = split(proj("q_proj", x)), split(proj("k_proj", x)), split(proj("v_proj", x))
    scores = q @ k.transpose(-1, -2) * hd**-0.5
    if bias is not None:
        g = F.linear(split(x), sd[f"{pre}.gru_rel_pos_linear.weight"],
                     sd[f"{pre}.gru_rel_pos_linear.bias"])
        ga, gb = torch.sigmoid(g.view(b, heads, t, 2, 4).sum(-1)).chunk(2, dim=-1)
        gate = ga * (gb * sd[f"{pre}.gru_rel_pos_const"] - 1.0) + 2.0
        scores = scores + gate * bias[None]
    a = torch.softmax(scores, dim=-1) @ v
    return proj("out_proj", a.transpose(1, 2).reshape(b, t, d))


def hidden_states(sd: dict, enc: dict, wav: torch.Tensor, bias: bool = True) -> list:
    """HF's ``output_hidden_states``; ``bias=False`` leaves the
    relative-position bias out (a planted fault)."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        eps = enc["layer_norm_eps"]
        stable = enc["do_stable_layer_norm"]
        x = _ln(sd, front_end(sd, enc, wav), "encoder.feature_layer_norm", eps)
        x = F.linear(x, sd["encoder.feature_projection.weight"],
                     sd["encoder.feature_projection.bias"])
        k = enc["num_conv_pos_embeddings"]
        pos = F.conv1d(x.transpose(1, 2), sd["encoder.pos_conv.weight"],
                       sd["encoder.pos_conv.bias"], padding=k // 2,
                       groups=enc["num_conv_pos_embedding_groups"])
        x = x + F.gelu(pos[:, :, :-1] if k % 2 == 0 else pos).transpose(1, 2)
        if not stable:
            x = _ln(sd, x, "encoder.layer_norm", eps)
        t = x.shape[1]
        pos_ids = torch.arange(t, device=x.device)
        ids = buckets(pos_ids[None, :] - pos_ids[:, None], enc["num_buckets"],
                      enc["max_bucket_distance"])
        table = sd["encoder.layers.0.attention.rel_attn_embed"][ids].permute(2, 0, 1)
        table = table if bias else None
        states = []
        for i in range(enc["num_hidden_layers"]):
            states.append(x)
            pre = f"encoder.layers.{i}"
            ff = (f"{pre}.intermediate_dense", f"{pre}.output_dense")

            def mlp(h):
                h = F.gelu(F.linear(h, sd[f"{ff[0]}.weight"], sd[f"{ff[0]}.bias"]))
                return F.linear(h, sd[f"{ff[1]}.weight"], sd[f"{ff[1]}.bias"])

            if stable:
                x = x + attention(sd, enc, _ln(sd, x, f"{pre}.layer_norm", eps), i, table)
                x = x + mlp(_ln(sd, x, f"{pre}.final_layer_norm", eps))
            else:
                x = _ln(sd, x + attention(sd, enc, x, i, table), f"{pre}.layer_norm", eps)
                x = _ln(sd, x + mlp(x), f"{pre}.final_layer_norm", eps)
        states.append(_ln(sd, x, "encoder.layer_norm", eps) if stable else x)
        return states
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def logits(sd: dict, enc: dict, wav: torch.Tensor, bias: bool = True) -> torch.Tensor:
    """(B, samples) -> (B, frames, labels)."""
    stacked = torch.stack(hidden_states(sd, enc, wav, bias)[1:])
    w = torch.softmax(sd["layer_mix.layer_weights"], dim=0)
    mixed = (w.view(-1, 1, 1, 1) * stacked).sum(0)
    return F.linear(mixed, sd["heads.heads.weight"], sd["heads.heads.bias"])
