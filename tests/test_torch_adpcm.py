"""The ADPCM transport of the port (``segma_tpu_torch/ops/adpcm.py``) against
the JAX package's ``segma_tpu/ops/adpcm.py``.

- the encoder: byte for byte equal to JAX's, on int16 and float input;
- the torch decode: bit for bit equal to the numpy ``adpcm_decode_np`` and
  to JAX's ``adpcm_decode``, at lengths aligned to the 64-sample block and
  not, on batched rows; all-zero bytes decode to silence;
- ``InferencePipeline(transport="adpcm")``: conv_vad's logits (hidden 32,
  depth 2, 1 s chunks, the JAX params bridged by ``convert.flax_to_torch``)
  against JAX's at the suite's f32 pin 1e-4 on a single file, a segmented
  long file and a packed group; int8 mu-law under ADPCM is a TypeError.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import segma_tpu.inference as jinf
import segma_tpu.ops.adpcm as jadpcm
from segma_tpu_torch import inference as tinf
from segma_tpu_torch.ops import adpcm
from tests.test_torch_vad import build_pair

LOGITS_ATOL = 1e-4  # f32, the suite's pin (tests/test_torch_hubert.py)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    return build_pair("conv_vad")


def _speechy(n: int, seed: int = 0) -> np.ndarray:
    """int16 tones in noise bursts with silences, like the serving WAVs."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16_000
    env = (np.sin(2 * np.pi * t / 1.7) > 0).astype(np.float64)
    sig = 0.3 * np.sin(2 * np.pi * 440.0 * t) * env + 0.05 * rng.standard_normal(n)
    return (np.clip(sig, -1, 1) * 32767).astype(np.int16)


@pytest.mark.parametrize("n", [64, 1000, 16_000, 40_037])
def test_encode_matches_jax(n):
    pcm = _speechy(n, seed=n)
    np.testing.assert_array_equal(adpcm.adpcm_encode(pcm), jadpcm.adpcm_encode(pcm))
    f32 = pcm.astype(np.float32) / 32768.0
    np.testing.assert_array_equal(adpcm.adpcm_encode(f32), jadpcm.adpcm_encode(f32))
    assert adpcm.encoded_nbytes(n) == jadpcm.encoded_nbytes(n) == adpcm.n_blocks(n) * 35


@pytest.mark.parametrize("n", [64, 640, 1000, 16_001, 48_000])
def test_decode_bit_exact_with_numpy_and_jax(n):
    rows = np.stack([_speechy(n, seed=s) for s in range(3)])
    rows[1] = (np.random.default_rng(9).standard_normal(n) * 12_000).clip(-32768, 32767)
    rows[2, : n // 2] = 32767  # full scale: the largest scales and sums
    data = adpcm.adpcm_encode(rows)
    assert data.shape == (3, adpcm.encoded_nbytes(n)) and data.dtype == np.uint8
    got = adpcm.adpcm_decode(torch.from_numpy(data), n).numpy()
    ref_np = adpcm.adpcm_decode_np(data, n)
    ref_jax = np.asarray(jadpcm.adpcm_decode(jnp.asarray(data), n))
    assert got.dtype == np.float32 and got.shape == (3, n)
    np.testing.assert_array_equal(got, ref_np)
    np.testing.assert_array_equal(got, ref_jax)
    np.testing.assert_array_equal(ref_np, jadpcm.adpcm_decode_np(data, n))
    # one row alone decodes as in the batch
    np.testing.assert_array_equal(
        adpcm.adpcm_decode(torch.from_numpy(data[1]), n).numpy(), got[1])


def test_zero_bytes_decode_to_silence_and_slices_are_exact():
    z = adpcm.adpcm_decode(torch.zeros(7 * 35, dtype=torch.uint8), 7 * 64)
    assert torch.equal(z, torch.zeros(7 * 64))
    pcm = _speechy(10_000)
    a = adpcm.adpcm_encode_audio(pcm)
    ja = jadpcm.adpcm_encode_audio(pcm)
    assert a.n_samples == ja.n_samples == 10_000
    for start, nb in ((0, 200), (64 * 50, 40), (64 * 150, 30)):  # the last one runs past the end
        np.testing.assert_array_equal(a.block_slice(start, nb), ja.block_slice(start, nb))
    with pytest.raises(ValueError, match="multiple of 64"):
        a.block_slice(100, 4)


def test_adpcm_logits_match_jax_single_segmented_and_packed(pair):
    jmodel, model = pair
    lengths = (3 * 15_680 + 9_000, 11 * 15_680 + 400, 2 * 15_680 + 700)
    pcms = [_speechy(n, seed=i) for i, n in enumerate(lengths)]
    jpipe = jinf.InferencePipeline(jmodel, jmodel.params, batch_size=4, transport="adpcm")
    refs = [jpipe.logits_for_audio(p) for p in pcms]
    # single dispatch, encoded at the dispatch site and pre-encoded
    pipe = tinf.InferencePipeline(model, batch_size=4, device="cpu", transport="adpcm")
    for pcm, ref in zip(pcms, refs):
        np.testing.assert_allclose(pipe.logits_for_audio(pcm), ref, atol=LOGITS_ATOL)
        np.testing.assert_allclose(pipe.logits_for_audio(adpcm.adpcm_encode_audio(pcm)), ref,
                                   atol=LOGITS_ATOL)
    # the long file in segments of 4 chunks (stride 15,680 = 245 blocks)
    seg = tinf.InferencePipeline(model, batch_size=4, device="cpu", max_bucket_chunks=4)
    jseg = jinf.InferencePipeline(jmodel, jmodel.params, batch_size=4, max_bucket_chunks=4)
    enc = adpcm.adpcm_encode_audio(pcms[1])
    ref = jseg.logits_for_audio(jadpcm.adpcm_encode_audio(pcms[1]))
    np.testing.assert_allclose(seg.logits_for_audio(enc), ref, atol=LOGITS_ATOL)
    np.testing.assert_allclose(ref, refs[1], atol=LOGITS_ATOL)
    # a packed group of pre-encoded files
    encs = [adpcm.adpcm_encode_audio(p) for p in pcms]
    outs = pipe.logits_for_audios_async(encs, pack_files=3)
    jouts = jpipe.logits_for_audios_async(
        [jadpcm.adpcm_encode_audio(p) for p in pcms], pack_files=3)
    for (lg, tf), (jlg, jtf) in zip(outs, jouts):
        assert tf == jtf
        np.testing.assert_allclose(lg[:tf].numpy(), np.asarray(jlg[:jtf]), atol=LOGITS_ATOL)


def test_int8_under_adpcm_is_a_type_error(pair):
    _, model = pair
    pipe = tinf.InferencePipeline(model, batch_size=4, device="cpu", transport="adpcm")
    mu = tinf.mulaw_compress(_speechy(20_000))
    with pytest.raises(TypeError, match="mu-law int8"):
        pipe.logits_for_audio(mu)
    with pytest.raises(ValueError, match="transport"):
        tinf.InferencePipeline(model, device="cpu", transport="mulaw")
