"""Weight bridge: a JAX ``surgical_hydra`` parameter tree -> the port's
``state_dict``.

The input is the flax params tree as nested dicts of numpy arrays (what
``jax.tree.map(np.asarray, params)`` gives); no JAX is needed here.

- conv kernels (k, in, out) -> (out, in, k); dense kernels (in, out) ->
  (out, in); LayerNorm ``scale`` -> ``weight``; ``layers_{i}`` ->
  ``layers.{i}``; ``embed_positions`` and ``layer_weights`` as they are;
- the BiLSTM cells ``OptimizedLSTMCell_{k}`` come in the order layer0-fwd,
  layer0-bwd, layer1-fwd, ...; each cell's per-gate kernels (``i{g}`` input,
  ``h{g}`` hidden with the bias) stack in gate order i, f, g, o into
  ``weight_ih_l{n}[_reverse]`` and ``weight_hh_l{n}[_reverse]``; ``h{g}.bias``
  goes into ``bias_hh`` and ``bias_ih`` is zero (the inverse of
  ``segma_tpu/convert_reference.py:_convert_lstm``).
"""

from __future__ import annotations

import re
from typing import Any

import numpy as np
import torch

_GATES = ("i", "f", "g", "o")
_LSTM_MODULE = "lstm_shared"


def _flatten(tree: dict, prefix: tuple[str, ...] = ()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, (*prefix, key))
        else:
            yield (*prefix, key), np.asarray(value, np.float32)


def _module_name(part: str) -> str:
    m = re.fullmatch(r"layers_(\d+)", part)
    return f"layers.{m.group(1)}" if m else part


def _tensor(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def lstm_state(cells: dict[str, Any], bidirectional: bool = True) -> dict[str, torch.Tensor]:
    """flax BiLSTM cells -> ``torch.nn.LSTM`` parameters."""
    n_dirs = 2 if bidirectional else 1
    out: dict[str, torch.Tensor] = {}
    for k in range(len(cells)):
        cell = cells[f"OptimizedLSTMCell_{k}"]
        layer, direction = divmod(k, n_dirs)
        suffix = f"l{layer}" + ("_reverse" if direction else "")
        w_ih = np.concatenate([np.asarray(cell[f"i{g}"]["kernel"]).T for g in _GATES])
        w_hh = np.concatenate([np.asarray(cell[f"h{g}"]["kernel"]).T for g in _GATES])
        b_hh = np.concatenate([np.asarray(cell[f"h{g}"]["bias"]) for g in _GATES])
        out[f"weight_ih_{suffix}"] = _tensor(w_ih)
        out[f"weight_hh_{suffix}"] = _tensor(w_hh)
        out[f"bias_ih_{suffix}"] = _tensor(np.zeros_like(b_hh))
        out[f"bias_hh_{suffix}"] = _tensor(b_hh)
    return out


def flax_to_torch(params: dict[str, Any], bidirectional: bool = True) -> dict[str, torch.Tensor]:
    """JAX ``WhisperSegModule`` params -> ``WhisperSegModule.state_dict()``."""
    state: dict[str, torch.Tensor] = {}
    for path, a in _flatten({k: v for k, v in params.items() if k != _LSTM_MODULE}):
        *mods, leaf = path
        if leaf == "kernel":
            leaf, a = "weight", (a.transpose(2, 1, 0) if a.ndim == 3 else a.T)
        elif leaf == "scale":
            leaf = "weight"
        state[".".join([*map(_module_name, mods), leaf])] = _tensor(a)
    if _LSTM_MODULE in params:
        for name, t in lstm_state(params[_LSTM_MODULE], bidirectional).items():
            state[f"{_LSTM_MODULE}.lstm.{name}"] = t
    return state


def load_flax_params(module: torch.nn.Module, params: dict[str, Any]) -> None:
    """Load a JAX params tree into a ``WhisperSegModule`` (strict: every key
    must match)."""
    state = flax_to_torch(params, module.lstm_shared.cfg.bidirectional)
    device = next(module.parameters()).device
    module.load_state_dict({k: v.to(device) for k, v in state.items()}, strict=True)
