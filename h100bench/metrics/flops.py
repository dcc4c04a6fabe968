"""The benchmark's own count of the operations a model needs, from the
published widths in a configuration file: 2 m n k for each product of an
m x k and a k x n operand (convolutions as products over their windows),
the two attention products, and the LSTM's gate products. Elementwise
work, normalisation, softmax and the log-mel are left out: they are small
beside the products, and the peak they are held to is the tensor cores'.
"""

from __future__ import annotations


def conv_out(n: int, kernel: int, stride: int, pad: int) -> int:
    return (n + 2 * pad - kernel) // stride + 1


def transformer_layer_flops(s: int, d: int, ffn: int) -> float:
    """One encoder layer over s positions: q, k, v and out projections, the
    score and value products, the two MLP products."""
    return 8 * s * d * d + 4 * s * s * d + 4 * s * d * ffn


def lstm_flops(steps: int, inputs: int, hidden: int, layers: int, directions: int) -> float:
    """The gate products of a stacked LSTM: per step and direction,
    4 hidden x (input + hidden)."""
    total, width = 0.0, inputs
    for _ in range(layers):
        total += directions * steps * 2 * 4 * hidden * (width + hidden)
        width = directions * hidden
    return total


def whisper_hydra_chunk_flops(enc: dict, lstm: dict, n_labels: int, frames: int) -> float:
    """One served chunk of ``surgical_hydra``: the chunk padded to Whisper's
    30 s (2 x ``max_source_positions`` log-mel frames), the two convolutions,
    the encoder layers, the weighted layer sum, the BiLSTM over every
    position and the heads over the chunk's ``frames``."""
    d, s = enc["d_model"], enc["max_source_positions"]
    mel_frames = 2 * s
    flops = 2 * mel_frames * enc["num_mel_bins"] * 3 * d  # conv1, k3 s1
    flops += 2 * s * d * 3 * d  # conv2, k3 s2
    flops += enc["encoder_layers"] * transformer_layer_flops(s, d, enc["encoder_ffn_dim"])
    flops += 2 * enc["encoder_layers"] * s * d  # the layer sum
    directions = 2 if lstm["bidirectional"] else 1
    flops += lstm_flops(s, d, lstm["hidden_size"], lstm["num_layers"], directions)
    flops += 2 * frames * directions * lstm["hidden_size"] * n_labels
    return float(flops)


def hubert_front_end_flops(enc: dict, samples: int) -> float:
    """The frozen convolutional front end over ``samples``, forward only."""
    flops, n, c_in = 0.0, samples, 1
    for dim, k, stride in zip(enc["conv_dim"], enc["conv_kernel"], enc["conv_stride"]):
        n = conv_out(n, k, stride, 0)
        flops += 2 * n * c_in * k * dim
        c_in = dim
    return flops


def hubert_frames(enc: dict, samples: int) -> int:
    n = samples
    for k, stride in zip(enc["conv_kernel"], enc["conv_stride"]):
        n = conv_out(n, k, stride, 0)
    return n


def hubert_hydra_train_crop_flops(enc: dict, samples: int, n_labels: int) -> float:
    """One training crop of ``surgical_hubert_hydra``: the frozen front end
    forward; the trainable part (feature projection, grouped positional
    convolution, layers, layer sum, heads) forward and backward, the
    backward twice the forward (the input's gradient and the weights'),
    except the feature projection's, which needs no input gradient."""
    s = hubert_frames(enc, samples)
    d, c = enc["hidden_size"], enc["conv_dim"][-1]
    groups, k = enc["num_conv_pos_embedding_groups"], enc["num_conv_pos_embeddings"]
    projection = 2 * s * c * d
    pos_conv = 2 * s * k * d * (d // groups)
    layers = enc["num_hidden_layers"] * transformer_layer_flops(s, d, enc["intermediate_size"])
    mix_heads = 2 * enc["num_hidden_layers"] * s * d + 2 * s * d * n_labels
    trainable = 3 * (pos_conv + layers + mix_heads) + 2 * projection
    return hubert_front_end_flops(enc, samples) + trainable
