"""The port's streaming segmenter (``segma_tpu_torch/streaming.py``): the
counterparts of ``tests/test_streaming.py``'s live-model tests, on conv_vad
(hidden 32, depth 2, 1 s chunks, the JAX params bridged by
``convert.flax_to_torch``), on the CPU.

- streamed intervals equal the port's offline ones exactly, for every way
  of cutting the pushes, with int16 and f32 pushes, mixed-dtype promotion,
  reference tails and reordered threshold keys; flushing twice raises;
- the ChunkForwardBatcher: N concurrent sessions give the serial sessions'
  intervals in fewer dispatches than chunks, and mixed-dtype rows equal;
- the port's streamed intervals equal JAX's streamed and offline ones, with
  thresholds placed more than 10x the measured port-vs-JAX probability
  difference away from every frame (as tests/test_torch_inference.py does).
"""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

import segma_tpu.inference as jinf
import segma_tpu.streaming as jstream
from segma_tpu_torch import inference as tinf
from segma_tpu_torch.streaming import (
    ChunkForwardBatcher, StreamFlushedError, StreamingSegmenter, make_streaming_forward,
)
from tests.test_torch_vad import build_pair, overrides


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


@pytest.fixture(scope="module")
def audio() -> np.ndarray:
    rng = np.random.default_rng(4)
    # ~3.3 chunks at the 1 s geometry: 2 full strides + a tail
    n = 16_000 + 15_680 * 2 + 5_000
    return (rng.standard_normal(n) * 0.2).astype(np.float32)


def _offline(model, audio, thresholds=None):
    pipe = tinf.InferencePipeline(model, batch_size=4, device="cpu")
    thr = thresholds or tinf.default_thresholds(model.label_encoder.base_labels)
    return sorted(pipe.decode_intervals(pipe.logits_for_audio(audio), thr))


def _streamed(model, pushes, thresholds=None, forward_fn=None):
    seg = StreamingSegmenter(model, thresholds, forward_fn=forward_fn)
    emitted = []
    for p in pushes:
        emitted += seg.push(p)
    emitted += seg.flush()
    assert sorted(emitted) == seg.intervals
    return seg.intervals


@pytest.mark.parametrize("push_size", [1000, 16_000, 37_777])
def test_streaming_matches_offline(pair, audio, push_size):
    _, model = pair
    pushes = [audio[o : o + push_size] for o in range(0, len(audio), push_size)]
    got = _streamed(model, pushes)
    assert got == _offline(model, audio) and got


def test_streaming_incremental_emission(pair, audio):
    _, model = pair
    seg = StreamingSegmenter(model)
    first = seg.push(audio[: 2 * 16_000])
    rest = seg.push(audio[2 * 16_000 :]) + seg.flush()
    assert first and sorted(first + rest) == seg.intervals


def test_flush_twice_raises(pair):
    _, model = pair
    seg = StreamingSegmenter(model)
    seg.push(np.zeros(20_000, np.float32))
    seg.flush()
    with pytest.raises(StreamFlushedError, match="already called"):
        seg.flush()
    with pytest.raises(StreamFlushedError):
        seg.push(np.zeros(10, np.int16))


def test_streaming_reference_tail_matches_offline(pair, audio):
    from segma_tpu_torch.config import load_config
    from segma_tpu_torch.models import Models
    from segma_tpu_torch.utils.encoders import MultiLabelEncoder
    from tests.test_torch_vad import REPO

    _, model = pair
    cfg = load_config(REPO / "segma_tpu_torch/config/default.yml",
                      [*overrides("conv_vad"), "audio.reference_tail=true"])
    model_rt = Models["conv_vad"](MultiLabelEncoder(cfg.data.classes), cfg, device="cpu")
    model_rt.module.load_state_dict(model.module.state_dict())
    seg = StreamingSegmenter(model_rt)
    seg.push(audio)
    seg.flush()
    assert seg.intervals == _offline(model_rt, audio)
    default_seg = StreamingSegmenter(model)
    default_seg.push(audio)
    default_seg.flush()
    assert seg._n_frames > default_seg._n_frames


def test_streaming_threshold_key_order_invariant(pair, audio):
    _, model = pair
    labels = model.label_encoder.base_labels
    thr = {label: {"lower_bound": 0.05 + 0.9 * i / max(1, len(labels) - 1), "upper_bound": 1.0}
           for i, label in enumerate(labels)}
    shuffled = {k: thr[k] for k in reversed(list(thr))}
    a = _streamed(model, [audio], thr)
    assert a == _streamed(model, [audio], shuffled) == _offline(model, audio, thr)
    np.testing.assert_array_equal(StreamingSegmenter(model, shuffled).thr,
                                  tinf.threshold_vector(labels, thr))


def test_streaming_int16_equals_f32(pair, audio):
    _, model = pair
    pcm = (audio * 32768.0).clip(-32768, 32767).astype(np.int16)
    got = _streamed(model, [pcm[:30_000], pcm[30_000:]])
    assert got == _streamed(model, [pcm.astype(np.float32) / 32768.0])
    assert got == _offline(model, pcm) and got


def test_streaming_invariant_to_push_partitioning(pair, audio):
    """Any cut points of the pushes give the same intervals (seeded cuts)."""
    _, model = pair
    reference = _offline(model, audio)
    rng = np.random.default_rng(17)
    for k in range(8):
        cuts = sorted(rng.choice(np.arange(1, len(audio)), size=k, replace=False))
        bounds = [0, *cuts, len(audio)]
        pushes = [audio[a:b] for a, b in zip(bounds[:-1], bounds[1:])]
        assert _streamed(model, pushes) == reference, cuts


def test_streaming_mixed_dtype_pushes_promote(pair, audio):
    _, model = pair
    pcm = (audio * 32768.0).clip(-32768, 32767).astype(np.int16)
    a = StreamingSegmenter(model)
    a.push(pcm[:20_000])
    assert a._buffer.dtype == np.int16
    a.push(pcm[20_000:].astype(np.float32) / 32768.0)
    assert a._buffer.dtype == np.float32
    a.flush()
    assert a.intervals == _streamed(model, [pcm]) and a.intervals


def test_chunk_forward_batcher_parity_and_batching(pair):
    _, model = pair
    n_sessions = 4
    rng = np.random.default_rng(11)
    audios = [(rng.standard_normal(3 * 16_000 + 777) * 0.3).astype(np.float32)
              for _ in range(n_sessions)]
    expected = [_streamed(model, [a]) for a in audios]
    batcher = ChunkForwardBatcher(model, window_ms=30.0, max_batch=4)
    results: list = [None] * n_sessions

    def run(i: int) -> None:
        a = audios[i]
        results[i] = _streamed(model, [a[o : o + 16_000] for o in range(0, len(a), 16_000)],
                               forward_fn=batcher)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n_sessions)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert results == expected
    # 4 sessions x 4 chunks (3 full + the tail) would be 16 single dispatches
    assert batcher.dispatches < 16, batcher.dispatches


def test_chunk_forward_batcher_mixed_dtype_group(pair):
    _, model = pair
    chunk_f = model.config.audio.chunk_duration_f
    pcm = (np.random.default_rng(9).standard_normal(chunk_f) * 8000).astype(np.int16)
    batcher = ChunkForwardBatcher(model, window_ms=150.0, max_batch=4)
    outs = {}

    def call(key, chunk):
        outs[key] = batcher(chunk)

    ts = [threading.Thread(target=call, args=("i16", pcm)),
          threading.Thread(target=call, args=("f32", pcm.astype(np.float32) / 32768.0))]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    torch.testing.assert_close(outs["i16"], outs["f32"], rtol=0, atol=0)
    single = make_streaming_forward(model)(pcm)
    assert single.shape == outs["i16"].shape == (model.n_windows, model.n_labels)


def test_streamed_intervals_match_jax(pair):
    jmodel, model = pair
    rng = np.random.default_rng(23)
    audio = (rng.standard_normal(5 * 15_680 + 9_000) * 0.3).astype(np.float32)
    jpipe = jinf.InferencePipeline(jmodel, jmodel.params, batch_size=4)
    ref_p = 1.0 / (1.0 + np.exp(-jpipe.logits_for_audio(audio)))
    got_p = 1.0 / (1.0 + np.exp(-tinf.InferencePipeline(
        model, batch_size=4, device="cpu").logits_for_audio(audio)))
    margin = max(10 * float(np.abs(ref_p - got_p).max()), 1e-6)
    thr = {}
    for li, label in enumerate(model.label_encoder.base_labels):
        p = np.sort(ref_p[:, li])
        mid = p[int(0.1 * len(p)) : int(0.9 * len(p)) + 1]
        gaps = np.diff(mid)
        i = int(np.argmax(gaps))
        assert gaps[i] / 2 > margin, (label, gaps[i])
        thr[label] = {"lower_bound": float((mid[i] + mid[i + 1]) / 2), "upper_bound": 1.0}
    pushes = [audio[o : o + 7_000] for o in range(0, len(audio), 7_000)]
    jseg = jstream.StreamingSegmenter(jmodel, jmodel.params, thresholds=thr)
    for p in pushes:
        jseg.push(p)
    jseg.flush()
    got = _streamed(model, pushes, thr)
    assert got == sorted(jseg.intervals) == _offline(model, audio, thr) and got


def test_from_exported_waits_for_the_export_slice(pair):
    """Ported: an artifact without stream programs is refused by name
    (tests/test_torch_export.py streams off artifacts that have them)."""
    from types import SimpleNamespace

    with pytest.raises(ValueError, match="no streaming program"):
        StreamingSegmenter.from_exported(SimpleNamespace(stream_fn=None))
    with pytest.raises(ValueError, match="re-export"):
        ChunkForwardBatcher.from_exported(SimpleNamespace(stream_batch_fns={}))
