"""Seeded weights for a model, made on the device in two large draws.

The names and shapes are those of the program's module; the values come
from ``--seed`` alone, in f32 (the port keeps its parameters in f32 and
casts them where they are used), and the same state dict is handed to the
program and to the reference:

- linear and convolution weights N(0, 1 / fan_in), their biases N(0, 0.02);
- LayerNorm and GroupNorm weights 1 + N(0, 0.05), biases N(0, 0.05);
- LSTM weights and ``bias_hh`` uniform in +-1/sqrt(hidden); ``bias_ih`` zero
  (the port's BiLSTM carries flax's one bias in ``bias_hh``);
- a layer sum's weights N(0, 0.5), so that its softmax is not uniform;
- a tensor that takes no gradient and is no weight (Whisper's position
  table) keeps the module's value and is left out of the dict.
"""

from __future__ import annotations

import torch
from torch import nn


def _plan(module: nn.Module) -> list[tuple[str, tuple, str, float, float]]:
    """(name, shape, draw, scale, shift) per weight: draw "normal" gives
    shift + scale N(0, 1), "uniform" shift + scale U(-1, 1), "zero" zeros."""
    plan = []
    for mod_name, mod in module.named_modules():
        prefix = f"{mod_name}." if mod_name else ""
        for p_name, p in mod.named_parameters(recurse=False):
            name, shape = prefix + p_name, tuple(p.shape)
            if isinstance(mod, nn.LSTM):
                if p_name.startswith("bias_ih"):
                    plan.append((name, shape, "zero", 0.0, 0.0))
                else:
                    plan.append((name, shape, "uniform", mod.hidden_size**-0.5, 0.0))
            elif isinstance(mod, (nn.Linear, nn.Conv1d)):
                if p_name == "weight":
                    plan.append((name, shape, "normal", p[0].numel() ** -0.5, 0.0))
                else:
                    plan.append((name, shape, "normal", 0.02, 0.0))
            elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
                plan.append((name, shape, "normal", 0.05, 1.0 if p_name == "weight" else 0.0))
            elif p_name == "layer_weights":
                plan.append((name, shape, "normal", 0.5, 0.0))
            elif not p.requires_grad:
                continue  # a fixed table of the architecture
            else:
                raise ValueError(f"no rule for the weight {name} of {type(mod).__name__}")
    return plan


def seeded_state_dict(module: nn.Module, seed: int,
                      device: torch.device) -> dict[str, torch.Tensor]:
    """The weights of ``module``'s parameters from ``seed``, on ``device``."""
    plan = _plan(module)
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = {kind: sum(torch.Size(s).numel() for _, s, k, _, _ in plan if k == kind)
             for kind in ("normal", "uniform")}
    normal = torch.randn(sizes["normal"], generator=gen, device=device)
    uniform = torch.rand(sizes["uniform"], generator=gen, device=device) * 2 - 1
    used = {"normal": 0, "uniform": 0}
    out = {}
    for name, shape, kind, scale, shift in plan:
        n = torch.Size(shape).numel()
        if kind == "zero":
            out[name] = torch.zeros(shape, device=device)
            continue
        src = normal if kind == "normal" else uniform
        out[name] = src[used[kind]: used[kind] + n].view(shape) * scale + shift
        used[kind] += n
    return out


def load_into(module: nn.Module, state: dict[str, torch.Tensor]) -> None:
    """Copy ``state`` into ``module``'s parameters (every weight of the plan,
    nothing else)."""
    missing, unexpected = module.load_state_dict(state, strict=False)
    if unexpected:
        raise KeyError(f"weights the module does not have: {unexpected}")
    left = [k for k in missing if k in dict(module.named_parameters())
            and dict(module.named_parameters())[k].requires_grad]
    if left:
        raise KeyError(f"trainable weights left unset: {left}")
