"""Weight bridge between a JAX model's parameter tree (any of the ten
models' modules) and the port's ``state_dict``, both ways (``flax_to_torch``,
``torch_to_flax``). The port's modules carry flax's names, automatic ones
too (conv_vad's ``Conv_{i}``, ``LayerNorm_{i}``, ``HydraHeads_0``).

The input is the flax params tree as nested dicts of numpy arrays (what
``jax.tree.map(np.asarray, params)`` gives); no JAX is needed here.

- conv kernels (k, in, out) -> (out, in, k), grouped ones (k, in/groups,
  out) -> (out, in/groups, k) alike; dense kernels (in, out) -> (out, in);
  LayerNorm and GroupNorm ``scale`` -> ``weight``; ``layers_{i}`` ->
  ``layers.{i}``; the other leaves as they are (``embed_positions``,
  ``layer_weights``, SincNet's ``low_hz`` and ``band_hz``, WavLM's bare
  ``rel_attn_embed`` and ``gru_rel_pos_const``); the HuBERT and WavLM
  ``feature_extractor.conv_{i}`` keep their names;
- the BiLSTM cells ``OptimizedLSTMCell_{k}`` come in the order layer0-fwd,
  layer0-bwd, layer1-fwd, ...; each cell's per-gate kernels (``i{g}`` input,
  ``h{g}`` hidden with the bias) stack in gate order i, f, g, o into
  ``weight_ih_l{n}[_reverse]`` and ``weight_hh_l{n}[_reverse]``; ``h{g}.bias``
  goes into ``bias_hh`` and ``bias_ih`` is zero (``layers.BiLSTM`` keeps it
  zero and frozen).

``torch_to_flax`` inverts it; an LSTM's two biases go into ``h{g}.bias`` as
their sum, the one bias a flax cell has.

Both also carry an optimizer's moments (``moments=True``): a moment tensor
goes to the flax leaf of its parameter through the same names and layouts.
Only ``bias_hh`` trains, so its moment is the moment of the flax cell's one
bias: ``torch_to_flax`` takes it, and ``flax_to_torch`` gives it back to
``bias_hh`` alone (no ``bias_ih`` entry).
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


def lstm_state(
    cells: dict[str, Any], bidirectional: bool = True, moments: bool = False
) -> dict[str, torch.Tensor]:
    """flax BiLSTM cells -> ``torch.nn.LSTM`` parameters (the moments of
    the trainable ones with ``moments=True``: no ``bias_ih``)."""
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
        if not moments:
            out[f"bias_ih_{suffix}"] = _tensor(np.zeros_like(b_hh))
        out[f"bias_hh_{suffix}"] = _tensor(b_hh)
    return out


def flax_to_torch(
    params: dict[str, Any], bidirectional: bool = True, moments: bool = False
) -> dict[str, torch.Tensor]:
    """A JAX model's params -> the port module's ``state_dict()`` (or a tree
    of moments -> the moments of each parameter)."""
    state: dict[str, torch.Tensor] = {}
    for path, a in _flatten({k: v for k, v in params.items() if k != _LSTM_MODULE}):
        *mods, leaf = path
        if leaf == "kernel":
            leaf, a = "weight", (a.transpose(2, 1, 0) if a.ndim == 3 else a.T)
        elif leaf == "scale":
            leaf = "weight"
        state[".".join([*map(_module_name, mods), leaf])] = _tensor(a)
    if _LSTM_MODULE in params:
        for name, t in lstm_state(params[_LSTM_MODULE], bidirectional, moments).items():
            state[f"{_LSTM_MODULE}.lstm.{name}"] = t
    return state


def _flax_path(name: str) -> list[str]:
    """``encoder.layers.0.attention`` -> ``['encoder', 'layers_0', 'attention']``."""
    parts: list[str] = []
    for part in name.split(".") if name else []:
        if part.isdigit() and parts:
            parts[-1] = f"{parts[-1]}_{part}"
        else:
            parts.append(part)
    return parts


def flax_path(module: torch.nn.Module, name: str) -> list[str]:
    """The flax path of ``module``'s state entry ``name`` (its parts):
    ``encoder.layers.0.fc1.weight`` is ``encoder/layers_0/fc1/kernel``."""
    *mods, leaf = name.split(".")
    owner = module.get_submodule(".".join(mods))
    if leaf == "weight" and isinstance(owner, (torch.nn.Linear, torch.nn.Conv1d)):
        leaf = "kernel"
    elif leaf == "weight" and isinstance(owner, (torch.nn.LayerNorm, torch.nn.GroupNorm)):
        leaf = "scale"
    return [*_flax_path(".".join(mods)), leaf]


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def lstm_cells(
    lstm: torch.nn.LSTM, tensors: dict[str, torch.Tensor] | None = None, moments: bool = False
) -> dict[str, Any]:
    """``torch.nn.LSTM`` parameters -> flax BiLSTM cells (``lstm_state``'s
    inverse): per gate, ``i{g}`` and ``h{g}`` kernels and the sum of the two
    biases as ``h{g}.bias``. ``tensors`` (by the LSTM's parameter names)
    stands in for the parameters; with ``moments=True`` the bias is
    ``bias_hh``'s alone, and ``bias_ih`` need not be there."""
    n_dirs = 2 if lstm.bidirectional else 1
    if tensors is None:
        tensors = dict(lstm.named_parameters())
    cells: dict[str, Any] = {}
    for layer in range(lstm.num_layers):
        for direction in range(n_dirs):
            suffix = f"l{layer}" + ("_reverse" if direction else "")
            w_ih, w_hh, b_hh = (
                np.split(_numpy(tensors[f"{kind}_{suffix}"]), 4)
                for kind in ("weight_ih", "weight_hh", "bias_hh")
            )
            if not moments:
                b_hh = [bh + bi for bh, bi in
                        zip(b_hh, np.split(_numpy(tensors[f"bias_ih_{suffix}"]), 4))]
            cell = {}
            for g, wi, wh, bh in zip(_GATES, w_ih, w_hh, b_hh):
                cell[f"i{g}"] = {"kernel": np.ascontiguousarray(wi.T)}
                cell[f"h{g}"] = {"kernel": np.ascontiguousarray(wh.T), "bias": bh}
            cells[f"OptimizedLSTMCell_{layer * n_dirs + direction}"] = cell
    return cells


def torch_to_flax(
    module: torch.nn.Module, tensors: dict[str, torch.Tensor] | None = None,
    moments: bool = False,
) -> dict[str, Any]:
    """A port module -> the JAX params tree (nested dicts of f32 numpy
    arrays, flax's names and layouts).

    ``tensors`` (by ``state_dict`` name) stands in for the module's state,
    each in its parameter's layout: an optimizer's moments of some of the
    parameters, with ``moments=True``; the tree then holds those only."""
    state = module.state_dict() if tensors is None else tensors
    tree: dict[str, Any] = {}
    for name, t in state.items():
        if name.split(".")[0] == _LSTM_MODULE:
            continue
        *parts, leaf = flax_path(module, name)
        a = _numpy(t)
        if leaf == "kernel":
            a = a.transpose(2, 1, 0) if a.ndim == 3 else a.T
        node = tree
        for part in parts:
            node = node.setdefault(part, {})
        node[leaf] = np.ascontiguousarray(a)
    prefix = f"{_LSTM_MODULE}.lstm."
    lstm = {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}
    if lstm:
        tree[_LSTM_MODULE] = lstm_cells(getattr(module, _LSTM_MODULE).lstm, lstm, moments)
    return tree


def load_flax_params(module: torch.nn.Module, params: dict[str, Any]) -> None:
    """Load a JAX params tree into a port module (strict: every key must
    match)."""
    lstm = getattr(module, _LSTM_MODULE, None)
    state = flax_to_torch(params, lstm.cfg.bidirectional if lstm is not None else True)
    device = next(module.parameters()).device
    module.load_state_dict({k: v.to(device) for k, v in state.items()}, strict=True)


def load_flax_subtrees(
    module: torch.nn.Module, params: dict[str, Any], bidirectional: bool = True,
    take: Any = None,
) -> None:
    """Overlay top-level subtrees of a flax params tree (an encoder snapshot's,
    a checkpoint's trainable tree) on a module: every state entry under those
    top-level names must be matched, in shape too, and no other entry
    changes. ``take`` maps the tree's tensors (by state entry name) to the
    module's, where it holds blocks of them (a tensor-parallel member)."""
    state = flax_to_torch(params, bidirectional)
    if take is not None:
        state = take(state)
    want = {k for k in module.state_dict() if k.split(".")[0] in params}
    if set(state) != want:
        raise ValueError(
            f"tree does not match the module under {sorted(params)}: missing "
            f"{sorted(want - set(state))[:5]}, unexpected {sorted(set(state) - want)[:5]}"
        )
    device = next(module.parameters()).device
    module.load_state_dict({k: v.to(device) for k, v in state.items()}, strict=False)
