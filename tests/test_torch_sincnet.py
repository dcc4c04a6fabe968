"""``sincnet_hydra`` against the JAX package's ``SincNetModule`` at 16
filters of 101 taps, hidden 32, a BiLSTM of 16 x 2, on 1 s chunks.

- the filter bank and ``SincConv``'s output: atol 1e-6 and 1e-5 (f32, the
  same ops in the same order; the output is a 101-tap sum of order 3);
- logits, f32: atol 1e-4, the suite's pin; bf16: 2e-2 * max(1, max|logit|),
  and no further from the f32 model than 1.5 times JAX's bf16 logits are,
  as for the Whisper variants: JAX's BiLSTM cells compute in bf16, the
  port's LSTM in f32;
- one train step as flax trees (loss 1e-5, gradients 1e-4, updates 1e-5
  where a gradient is not within 100 times AdamW's eps of zero, as in
  tests/test_torch_vad.py), the filter edges left at their initialisation,
  where the last filter's upper edge is exactly sr / 2: JAX's ``clip``
  passes half the gradient at that tie, and so must the port
  (``torch.clamp`` would pass all of it).
"""

from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segma_tpu.config import load_config as jax_load_config
from segma_tpu.models import Models as JaxModels
from segma_tpu.models.sincnet import SincConv as JaxSincConv
from segma_tpu.train import make_optimizer as jax_make_optimizer
from segma_tpu.train import make_train_step as jax_make_train_step
from segma_tpu.utils.encoders import MultiLabelEncoder as JaxEncoder
from segma_tpu_torch.config import load_config
from segma_tpu_torch.convert import load_flax_params, torch_to_flax
from segma_tpu_torch.models import Models
from segma_tpu_torch.models.sincnet import SincConv
from segma_tpu_torch.train import make_optimizer, make_train_step
from segma_tpu_torch.utils.encoders import MultiLabelEncoder
from tests.test_torch_lstm_train import _leaves
from tests.test_torch_vad import assert_updates_match

REPO = Path(__file__).resolve().parent.parent
LR = 1e-3
EXTRA = ["model.name=sincnet_hydra", "model.config.filters=16", "model.config.kernel_size=101",
         "model.config.hidden=32", "model.config.lstm.hidden_size=16",
         "audio.chunk_duration_s=1.0"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def build_pair(precision: str = "f32", perturb_sinc: bool = True):
    """(JAX model with its params, port model with the same weights): the
    JAX init plus N(0, 0.05) from numpy seed 0, the filter edges too unless
    ``perturb_sinc`` is False."""
    extra = [*EXTRA, f"model.config.dtype={precision}"]
    jcfg = jax_load_config(REPO / "segma_tpu/config/default.yml", extra)
    cfg = load_config(REPO / "segma_tpu_torch/config/default.yml", extra)
    jmodel = JaxModels["sincnet_hydra"](JaxEncoder(jcfg.data.classes), jcfg)
    params = jax.tree.map(np.asarray, jmodel.init_params(jax.random.key(0)))
    rng = np.random.default_rng(0)
    noisy = jax.tree.map(lambda a: (a + rng.normal(0, 0.05, a.shape)).astype(np.float32), params)
    if not perturb_sinc:
        noisy["sinc"] = params["sinc"]
    jmodel.params = noisy
    model = Models["sincnet_hydra"](MultiLabelEncoder(cfg.data.classes), cfg, device="cpu")
    load_flax_params(model.module, jmodel.params)
    return jmodel, model


def _wav(n: int = 16_000, seed: int = 1) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal((2, n)) * 0.1).astype(np.float32)


def test_filter_bank_and_sinc_conv_match_jax():
    wav = _wav(4_000)
    jsinc = JaxSincConv(filters=16, kernel_size=101, dtype=jnp.float32)
    params = jsinc.init(jax.random.key(0), jnp.asarray(wav))
    sinc = SincConv(filters=16, kernel_size=101, dtype=torch.float32)
    for name in ("low_hz", "band_hz"):
        np.testing.assert_array_equal(getattr(sinc, name).detach().numpy(),
                                      np.asarray(params["params"][name]))
    ref = np.asarray(jsinc.apply(params, jnp.asarray(wav)))
    got = sinc(torch.from_numpy(wav)).detach().numpy()
    assert got.shape == ref.shape == (2, 400, 16)
    np.testing.assert_allclose(got, ref, atol=1e-5)
    # the bank itself: JAX's at stride 1 reads it back from a unit impulse,
    # out[t] = bank[:, 500 + half - t]
    impulse = np.zeros((1, 1_010), np.float32)
    impulse[0, 500] = 1.0
    unit = JaxSincConv(filters=16, kernel_size=101, stride=1, dtype=jnp.float32)
    ref_bank = np.asarray(unit.apply(params, jnp.asarray(impulse)))[0, 450:551][::-1].T
    bank = sinc.bank().detach().numpy()
    assert bank.shape == (16, 101)
    np.testing.assert_allclose(bank, ref_bank, atol=1e-6)


def test_geometry():
    jmodel, model = build_pair()
    cs, jcs = model.conv_settings, jmodel.conv_settings
    assert (cs.kernels, cs.strides, cs.paddings) == (jcs.kernels, jcs.strides, jcs.paddings)
    assert cs.rf_step == 320
    assert model.n_windows == jmodel.n_windows == 49
    for n in (16_000, 64_000, 64_321):
        assert cs.n_windows(n, strict=False) == jcs.n_windows(n, strict=False)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_logits_match_jax(precision):
    jmodel, model = build_pair(precision)
    wav = _wav()
    ref = np.asarray(jmodel.apply(jmodel.params, jnp.asarray(wav)))
    got = model.apply(torch.from_numpy(wav)).numpy()
    assert got.shape == ref.shape == (2, 49, 4)
    if precision == "f32":
        np.testing.assert_allclose(got, ref, atol=1e-4)
        return
    np.testing.assert_allclose(got, ref, atol=2e-2 * max(1.0, float(np.abs(ref).max())))
    f32 = jmodel.module.clone(dtype=jnp.float32)
    truth = np.asarray(f32.apply({"params": jmodel.params}, jnp.asarray(wav)))
    assert np.abs(got - truth).max() <= 1.5 * np.abs(ref - truth).max()


def test_train_step_matches_jax_at_the_band_edge_tie():
    jmodel, model = build_pair(perturb_sinc=False)
    sinc = model.module.sinc
    f2 = sinc.min_low_hz + sinc.low_hz.abs() + sinc.min_band_hz + sinc.band_hz.abs()
    assert float(f2[-1].detach()) == sinc.sample_rate / 2  # the tie
    rng = np.random.default_rng(1)
    batch = {"x": _wav(seed=2), "y": (rng.random((2, 49, 4)) > 0.6).astype(np.float32)}

    def loss_fn(p):
        logits = jmodel.apply(p, jnp.asarray(batch["x"]), train=True,
                              rngs={"dropout": jax.random.key(1)})
        return jmodel.loss(logits, jnp.asarray(batch["y"]))[0]

    params = jax.tree.map(jnp.asarray, jmodel.params)
    grads = jax.tree.map(np.asarray, jax.grad(loss_fn)(params))
    opt = jax_make_optimizer(jmodel, LR)
    after, _, loss, _ = jax_make_train_step(jmodel, opt)(
        params, opt.init(params), {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.key(1))
    p_loss, _ = make_train_step(model, make_optimizer(model, LR))(
        {k: torch.from_numpy(v) for k, v in batch.items()}, None)
    assert abs(float(p_loss) - float(loss)) <= 1e-5
    named = dict(model.module.named_parameters())
    got = dict(_leaves(torch_to_flax(
        model.module, {n: p.grad for n, p in named.items() if p.requires_grad}, moments=True)))
    want = dict(_leaves(grads))
    assert set(got) == set(want)
    for key, g in got.items():
        np.testing.assert_allclose(g, want[key], atol=1e-4, err_msg=key)
    # the tie's own gradients, to the gradient's scale
    for key in ("/sinc/low_hz", "/sinc/band_hz"):
        scale = np.abs(want[key]).max()
        assert abs(got[key][-1] - want[key][-1]) <= 1e-4 * scale, (key, got[key][-1],
                                                                   want[key][-1])
    assert_updates_match(torch_to_flax(model.module), jax.tree.map(np.asarray, after), grads)
