"""Data parallelism of the port against the JAX package, on the CPU.

- Mesh: ``make_mesh``'s shapes and errors are JAX's; ``shard_batch``'s
  blocks are the shards of JAX's ``shard_batch``; replicas carry the source
  model's weights and buffers; ``model > 1`` and ``seq > 1`` are refused by
  the trainer's check and served.
- Serving over 4 CPU replicas (conv_vad, hidden 32, depth 2, 1 s chunks, the
  JAX params bridged by ``convert.flax_to_torch``): one long file in
  segments, packed files and ADPCM, bit-equal to the port's meshless
  pipeline where every replica's block is a whole number of inner batches,
  and within the serving pin, 1e-4 x max(1, max|logit|), of JAX's pipeline
  over its 8-device mesh; the predict CLI with ``--mesh auto`` over a device
  list, and ``infer_file`` over a mesh pipeline; ``serve_forever`` over a
  mesh answers as the meshless service does.
- Launch counters: one locked counter loses no increment under 16 threads.
- Config: the YAML that JAX's ``Config.save`` writes for each of the ten
  models loads in the port; ``model.config.lstm.unroll`` loads in both
  packages; ``mesh.seq`` is refused as JAX refuses it; the ``mesh`` section
  survives the port's save and load, and JAX reads it back.
"""

from __future__ import annotations

import threading
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import segma_tpu.inference as jinf
import segma_tpu.ops.adpcm as jadpcm
import segma_tpu.parallel.mesh as jmesh
from segma_tpu.config import ConfigError as JaxConfigError
from segma_tpu.config import load_config as jax_load_config
from segma_tpu_torch import inference as tinf
from segma_tpu_torch.config import ConfigError, load_config
from segma_tpu_torch.ops.adpcm import adpcm_encode_audio
from segma_tpu_torch.parallel import make_mesh, replicate, shard_batch
from segma_tpu_torch.parallel import mesh as tmesh
from tests.test_torch_vad import build_pair, overrides

REPO = Path(__file__).resolve().parent.parent
JAX_DEFAULT = REPO / "segma_tpu/config/default.yml"
PORT_DEFAULT = REPO / "segma_tpu_torch/config/default.yml"
MODEL_NAMES = ("whisperidou", "whisperimax", "surgical_whisper", "hydra_whisper",
               "surgical_hydra", "surgical_hubert_hydra", "surgical_wavlm_hydra",
               "sincnet_hydra", "conv_vad", "powerset_vad")
STRIDE = 15_680  # conv_vad's chunk stride at 1 s chunks
REPLICAS = 4
INNER = 4  # the inner batch: 16 chunks make 4 rows per replica, one inner batch
SEGMENT = 16  # max_bucket_chunks
CPU4 = ["cpu"] * REPLICAS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- config -----------------------------------------------------------------------


@pytest.mark.parametrize("name", MODEL_NAMES)
def test_jax_saved_config_loads_in_the_port(tmp_path, name):
    """A JAX run dir's ``config.yml`` (``Config.save``) is the port's input."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jcfg = jax_load_config(JAX_DEFAULT, [f"model.name={name}"])
    path = tmp_path / "config.yml"
    jcfg.save(path)
    cfg = load_config(path)
    assert cfg.model.name == name
    assert (cfg.mesh.data, cfg.mesh.model, cfg.mesh.seq) == (
        jcfg.mesh.data, jcfg.mesh.model, jcfg.mesh.seq)
    lstm = getattr(cfg.model.config, "lstm", None)
    if lstm is not None:
        assert lstm.unroll == jcfg.model.config.lstm.unroll == 1


@pytest.mark.parametrize("name", ["surgical_hydra", "whisperimax", "sincnet_hydra"])
def test_lstm_unroll_loads_in_both_packages(tmp_path, name):
    extra = [f"model.name={name}", "model.config.lstm.unroll=8"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jcfg = jax_load_config(JAX_DEFAULT, extra)
    cfg = load_config(PORT_DEFAULT, extra)
    assert cfg.model.config.lstm.unroll == jcfg.model.config.lstm.unroll == 8
    cfg.save(tmp_path / "c.yml")  # written back, and read by both
    assert load_config(tmp_path / "c.yml").model.config.lstm.unroll == 8
    assert jax_load_config(tmp_path / "c.yml").model.config.lstm.unroll == 8


@pytest.mark.parametrize("value", [0, -2, "many"])
def test_lstm_unroll_must_be_a_positive_int(value):
    with pytest.raises(ConfigError, match="unroll"):
        load_config(PORT_DEFAULT, [f"model.config.lstm.unroll={value}"])


@pytest.mark.parametrize("extra, match", [
    (["mesh.seq=7"], "1500"),
    (["model.name=surgical_hydra", "mesh.seq=8"], "1500"),
    (["model.name=surgical_hubert_hydra", "mesh.seq=2"], "whisper"),
    (["model.name=conv_vad", "mesh.seq=2"], "whisper"),
    (["model.name=surgical_hydra", "model.config.fast_context=true", "mesh.seq=7"], "200"),
])
def test_unsatisfiable_mesh_seq_is_refused_as_in_jax(extra, match):
    with pytest.raises(JaxConfigError) as jax_err:
        jax_load_config(JAX_DEFAULT, extra)
    with pytest.raises(ConfigError, match=match) as err:
        load_config(PORT_DEFAULT, extra)
    assert str(err.value) == str(jax_err.value)


@pytest.mark.parametrize("extra", [
    ["model.name=surgical_hydra", "mesh.seq=4"],
    ["model.name=surgical_hydra", "model.config.fast_context=true", "mesh.seq=8"],
])
def test_satisfiable_mesh_seq_loads_as_in_jax(extra):
    assert load_config(PORT_DEFAULT, extra).mesh.seq == jax_load_config(
        JAX_DEFAULT, extra).mesh.seq


def test_mesh_section_survives_save_and_jax_reads_it(tmp_path):
    cfg = load_config(PORT_DEFAULT, ["mesh.data=2", "mesh.model=1", "mesh.seq=4"])
    assert (cfg.mesh.data, cfg.mesh.model, cfg.mesh.seq) == (2, 1, 4)
    cfg.save(tmp_path / "c.yml")
    again = load_config(tmp_path / "c.yml")
    jcfg = jax_load_config(tmp_path / "c.yml")
    for c in (again, jcfg):
        assert (c.mesh.data, c.mesh.model, c.mesh.seq) == (2, 1, 4)


def test_default_mesh_is_jax_s():
    cfg, jcfg = load_config(PORT_DEFAULT), jax_load_config(JAX_DEFAULT)
    assert (cfg.mesh.data, cfg.mesh.model, cfg.mesh.seq) == (
        jcfg.mesh.data, jcfg.mesh.model, jcfg.mesh.seq) == (-1, 1, 1)


def test_unknown_mesh_key_is_refused():
    with pytest.raises(ConfigError, match="MeshConfig"):
        load_config(PORT_DEFAULT, ["mesh.pipeline=2"])


# -- mesh -------------------------------------------------------------------------


@pytest.mark.parametrize("sizes", [
    dict(data=4, model=2), dict(data=-1, model=2), dict(data=-1, seq=2, model=2),
    dict(data=8), dict(), dict(data=3, model=2), dict(data=-1, model=3), dict(data=2),
])
def test_make_mesh_shapes_and_errors_are_jax_s(sizes):
    import jax

    devices = jax.devices()
    assert len(devices) == 8  # tests/conftest.py's virtual CPU devices
    try:
        want = dict(jmesh.make_mesh(devices=devices, **sizes).shape)
    except ValueError as e:
        with pytest.raises(ValueError) as err:
            make_mesh(devices=["cpu"] * 8, **sizes)
        assert str(err.value) == str(e)
        return
    got = make_mesh(devices=["cpu"] * 8, **sizes)
    assert got.shape == want
    assert got.devices.shape == tuple(want[a] for a in ("data", "seq", "model"))


def test_make_mesh_reads_the_config_section():
    cfg = load_config(PORT_DEFAULT, ["mesh.data=2", "mesh.seq=2"])
    jcfg = jax_load_config(JAX_DEFAULT, ["mesh.data=2", "mesh.seq=2"])
    import jax

    want = dict(jmesh.make_mesh(jcfg, jax.devices()[:4]).shape)
    assert make_mesh(cfg, ["cpu"] * 4).shape == want


def test_shard_batch_blocks_are_jax_s_shards():
    x = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    jsharded = jmesh.shard_batch(x, jmesh.make_mesh(data=8))
    want = [np.asarray(s.data) for s in sorted(
        jsharded.addressable_shards, key=lambda s: s.index[0].start)]
    got = shard_batch(torch.from_numpy(x), make_mesh(devices=["cpu"] * 8))
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    blocks = shard_batch({"x": torch.from_numpy(x), "y": torch.arange(16)},
                         make_mesh(devices=["cpu"] * 4))
    assert [b["y"].tolist() for b in blocks] == [list(range(i, i + 4)) for i in (0, 4, 8, 12)]
    with pytest.raises(ValueError, match="divide"):
        shard_batch(torch.zeros(6), make_mesh(devices=["cpu"] * 4))


def test_block_bounds_align_to_inner_batches():
    assert tmesh.block_bounds(32, 4, align=4) == [(0, 8), (8, 16), (16, 24), (24, 32)]
    assert tmesh.block_bounds(40, 4, align=4) == [(0, 12), (12, 24), (24, 36), (36, 40)]
    assert tmesh.block_bounds(6, 4, align=4) == [(0, 2), (2, 4), (4, 6), (6, 6)]
    assert tmesh.block_bounds(256, 2, align=64) == [(0, 128), (128, 256)]


@pytest.fixture(scope="module")
def pair():
    return build_pair("conv_vad")


def test_replicas_carry_the_source_weights(pair):
    _, model = pair
    replicas = replicate(model, make_mesh(devices=CPU4))
    assert replicas[0] is model and len({id(r.module) for r in replicas}) == REPLICAS
    want = model.module.state_dict()
    for r in replicas[1:]:
        got = r.module.state_dict()
        assert set(got) == set(want)
        for k, v in want.items():
            assert torch.equal(got[k], v) and got[k].data_ptr() != v.data_ptr(), k
        assert r.frozen_prefixes == model.frozen_prefixes
        assert [p.requires_grad for p in r.module.parameters()] == [
            p.requires_grad for p in model.module.parameters()]


@pytest.mark.parametrize("sizes", [dict(model=2), dict(seq=2), dict(data=1, seq=2, model=2)])
def test_tensor_and_sequence_parallel_meshes_are_refused(pair, sizes):
    """Refused by the trainer's check under epoch dispatch over gloo ranks
    on cards only, saying why; NCCL ranks on cards and gloo ranks on the
    CPU train them under either dispatch, step dispatch everywhere
    (tests/test_torch_train_tensor_seq.py), and serving takes them
    (tests/test_torch_tensor_seq.py)."""
    _, model = pair
    mesh = make_mesh(devices=CPU4, **sizes)
    shape = tuple(mesh.shape.values())
    epoch = load_config(PORT_DEFAULT, ["train.dispatch=epoch"])
    with pytest.raises(ValueError, match="a gloo collective on a card's tensors waits on the host"):
        tmesh.check_dispatch(epoch, shape, "gloo", "cuda")
    tmesh.check_dispatch(epoch, shape, "nccl", "cuda")
    tmesh.check_dispatch(epoch, shape, "gloo", "cpu")
    tmesh.check_dispatch(load_config(PORT_DEFAULT, ["train.dispatch=step"]), shape, "gloo", "cuda")
    tmesh.check_dispatch(epoch, (4, 1, 1), "gloo", "cuda")  # data-parallel epoch dispatch stays
    pipe = tinf.InferencePipeline(model, device="cpu", mesh=mesh)
    assert pipe.members.shape == mesh.devices.shape


def _pipelines(pair, transport: str = "auto"):
    """(the port's meshless pipeline, the port's over 4 CPU replicas, JAX's
    over its 8-device mesh)."""
    jmodel, model = pair
    kw = dict(batch_size=INNER, max_bucket_chunks=SEGMENT, transport=transport)
    return (tinf.InferencePipeline(model, device="cpu", **kw),
            tinf.InferencePipeline(model, device="cpu", mesh=make_mesh(devices=CPU4), **kw),
            jinf.InferencePipeline(jmodel, jmodel.params, mesh=jmesh.make_mesh(data=8), **kw))


def _pin(got: np.ndarray, ref: np.ndarray) -> None:
    atol = 1e-4 * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, atol=atol, rtol=0)


def _pcm(n_samples: int, seed: int) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(n_samples) * 4_000).astype(np.int16)


@pytest.mark.parametrize("n_chunks", [16, 48])
def test_long_file_over_replicas(pair, n_chunks):
    """48 chunks: three segments of 16, each 4 rows per replica."""
    pipe, mesh_pipe, jpipe = _pipelines(pair)
    pcm = _pcm(n_chunks * STRIDE + 900, seed=n_chunks)
    got = mesh_pipe.logits_for_audio(pcm)
    np.testing.assert_array_equal(got, pipe.logits_for_audio(pcm))
    _pin(got, jpipe.logits_for_audio(pcm))
    (lg, tf), (ref, ref_tf) = (p.logits_for_audio_async(pcm) for p in (mesh_pipe, pipe))
    assert tf == ref_tf == jpipe.logits_for_audio_async(pcm)[1]
    assert lg.shape == ref.shape  # the same bucketed grid: 16 chunks hold 4 per replica


def test_short_file_bucket_holds_a_chunk_per_replica(pair):
    pipe, mesh_pipe, jpipe = _pipelines(pair)
    pcm = _pcm(STRIDE + 500, seed=3)  # 2 chunks needed: 4 with 4 replicas, 8 in JAX
    assert mesh_pipe.logits_for_audio_async(pcm)[0].shape[0] == 4 * 49
    assert pipe.logits_for_audio_async(pcm)[0].shape[0] == 2 * 49
    _pin(mesh_pipe.logits_for_audio(pcm), jpipe.logits_for_audio(pcm))


def test_packed_files_over_replicas(pair):
    """Three files of a 16-chunk bucket in one dispatch: 48 rows, 12 per
    replica, three inner batches each; a 4-chunk file in another."""
    pipe, mesh_pipe, jpipe = _pipelines(pair)
    audios = [_pcm(n, seed=i) for i, n in enumerate(
        (14 * STRIDE + 700, 16 * STRIDE, 12 * STRIDE + 9_000, 3 * STRIDE + 100))]
    audios[1] = audios[1].astype(np.float32) / 32768.0  # a bucket of its own dtype
    outs = mesh_pipe.logits_for_audios_async(audios, pack_files=3)
    ref = pipe.logits_for_audios_async(audios, pack_files=3)
    jouts = jpipe.logits_for_audios_async(audios, pack_files=3)
    for i, ((lg, tf), (rlg, rtf), (jlg, jtf)) in enumerate(zip(outs, ref, jouts)):
        assert tf == rtf == jtf, i
        if i != 3:  # the 4-chunk file's block is one row per replica
            np.testing.assert_array_equal(lg[:tf].numpy(), rlg[:tf].numpy(), err_msg=str(i))
        _pin(lg[:tf].numpy(), np.asarray(jlg[:jtf]))


def test_adpcm_over_replicas(pair):
    pipe, mesh_pipe, jpipe = _pipelines(pair, transport="adpcm")
    pcm = _pcm(32 * STRIDE + 3_000, seed=9)
    enc = adpcm_encode_audio(pcm)
    got = mesh_pipe.logits_for_audio(enc)
    np.testing.assert_array_equal(got, pipe.logits_for_audio(enc))
    _pin(got, jpipe.logits_for_audio(jadpcm.AdpcmAudio(enc.data, enc.n_samples)))
    # a waveform encoded at dispatch (transport="adpcm") is the same audio
    np.testing.assert_array_equal(mesh_pipe.logits_for_audio(pcm), got)


def _write_wav(path: Path, pcm: np.ndarray) -> None:
    import wave

    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16_000)
        w.writeframes(pcm.astype("<i2").tobytes())


def test_predict_cli_mesh_auto_over_a_device_list(pair, tmp_path, monkeypatch):
    """``--mesh auto`` spreads over the devices ``visible_devices`` names
    (the cards on a card; here four CPU entries): the RTTMs and saved
    logits equal ``--mesh off``'s, and the logits are within the pin of
    JAX's predict CLI over its 8 devices."""
    _, model = pair
    ck = tmp_path / "ck"
    from segma_tpu_torch import checkpoint

    checkpoint.save_params(ck, checkpoint.flax_split(model)[0], {"epoch": 0})
    jmodel = pair[0]
    wavs = tmp_path / "wav"
    wavs.mkdir()
    for i, n in enumerate((16 * STRIDE + 50, 20 * STRIDE, 5 * STRIDE)):
        _write_wav(wavs / f"{i:04d}.wav", _pcm(n, seed=20 + i))
    cfg_path = tmp_path / "cfg.yml"
    model.config.save(cfg_path)
    seen = []
    real_init = tinf.InferencePipeline.__post_init__

    def spy(self):
        real_init(self)
        seen.append(len(self.replicas))

    monkeypatch.setattr(tinf.InferencePipeline, "__post_init__", spy)
    monkeypatch.setattr(tmesh, "visible_devices", lambda device: [torch.device("cpu")] * 4)
    common = ["--config", str(cfg_path), "--wavs", str(wavs), "--checkpoint", str(ck),
              "--batch_size", str(INNER), "--save-logits", "--device", "cpu",
              *overrides("conv_vad")]
    tinf.main([*common, "--output", str(tmp_path / "auto"), "--mesh", "auto"])
    tinf.main([*common, "--output", str(tmp_path / "off"), "--mesh", "off"])
    assert seen == [REPLICAS, 1]
    for f in sorted((tmp_path / "off" / "raw_rttm").glob("*.rttm")):
        assert (tmp_path / "auto" / "raw_rttm" / f.name).read_bytes() == f.read_bytes()
    jpipe = jinf.InferencePipeline(jmodel, jmodel.params, batch_size=INNER,
                                   mesh=jmesh.make_mesh(data=8))
    for f in sorted(wavs.glob("*.wav")):
        got = np.load(tmp_path / "auto" / "logits" / f"{f.stem}-logits_dict_t.npz")
        off = np.load(tmp_path / "off" / "logits" / f"{f.stem}-logits_dict_t.npz")
        ref = jpipe.logits_for_audio(tinf._load_mono(f))
        for li, label in enumerate(model.label_encoder.base_labels):
            if f.stem != "0002":  # 5 chunks: 2 per replica, not the meshless inner batch
                np.testing.assert_array_equal(got[label], off[label])
            _pin(got[label], ref[:, li])


def test_infer_file_over_replicas(pair, tmp_path):
    """``infer_file`` over a mesh pipeline writes the meshless pipeline's
    RTTM (a 20-chunk file: blocks of 8 windows, two inner batches each)."""
    pipe, mesh_pipe, _ = _pipelines(pair)
    wav = tmp_path / "one.wav"
    _write_wav(wav, _pcm(20 * STRIDE, seed=51))
    got = tinf.infer_file(wav, mesh_pipe, tmp_path / "mesh")
    want = tinf.infer_file(wav, pipe, tmp_path / "off")
    assert got == want and got
    assert ((tmp_path / "mesh" / "raw_rttm" / "one.rttm").read_bytes()
            == (tmp_path / "off" / "raw_rttm" / "one.rttm").read_bytes())


def test_auto_mesh_resolution(monkeypatch):
    cfg = load_config(PORT_DEFAULT)
    assert tmesh.auto_mesh(cfg, torch.device("cpu")) is None  # one device
    monkeypatch.setattr(tmesh, "visible_devices", lambda device: [torch.device("cpu")] * 4)
    assert tmesh.auto_mesh(cfg, torch.device("cpu")).shape == {"data": 4, "seq": 1, "model": 1}
    two = load_config(PORT_DEFAULT, ["mesh.data=2"])
    assert tmesh.auto_mesh(two, torch.device("cpu")).shape["data"] == 2
    one = load_config(PORT_DEFAULT, ["mesh.data=1"])
    assert tmesh.auto_mesh(one, torch.device("cpu")) is None
    with pytest.raises(ValueError, match="does not match"):
        tmesh.auto_mesh(load_config(PORT_DEFAULT, ["mesh.data=8"]), torch.device("cpu"))


def test_serve_forever_over_a_mesh_answers_as_one_device(pair, tmp_path, monkeypatch):
    """``serve_forever(mesh=<Mesh>)`` on four CPU replicas: a one-shot
    request and a micro-batched pair answer as a meshless service does, and
    a streaming session runs on the first device."""
    from segma_tpu_torch import checkpoint, serve
    from segma_tpu_torch.client import SegmaClient
    from segma_tpu_torch.serve import runtime

    _, model = pair
    servers = []
    real_make = runtime.make_server

    def capture(*a, **kw):
        servers.append(real_make(*a, **kw))
        return servers[-1]

    monkeypatch.setattr(runtime, "make_server", capture)
    monkeypatch.setattr(checkpoint, "load_model_for_inference", lambda *a, **kw: model)

    t = threading.Thread(target=serve.serve_forever, kwargs=dict(
        config=model.config, port=0, batch_size=INNER, batch_window_ms=50.0,
        mesh=make_mesh(devices=CPU4), device="cpu"), daemon=True)
    t.start()
    for _ in range(600):
        if servers:
            break
        t.join(0.1)
    assert servers, "the server did not bind"
    server = servers[0]
    try:
        wav = tmp_path / "r.wav"
        pcm = _pcm(17 * STRIDE, seed=41)
        _write_wav(wav, pcm)
        client = SegmaClient(f"http://127.0.0.1:{server.server_address[1]}")
        ref_server = serve.make_server(serve.SegmentationService(
            tinf.InferencePipeline(model, batch_size=INNER, device="cpu")), port=0)
        threading.Thread(target=ref_server.serve_forever, daemon=True).start()
        try:
            want = SegmaClient(
                f"http://127.0.0.1:{ref_server.server_address[1]}").segment(str(wav))
        finally:
            ref_server.shutdown()
        assert want and client.segment(str(wav)) == want
        results = [None, None]

        def one(i):
            results[i] = client.segment(str(wav))

        threads = [threading.Thread(target=one, args=(i,)) for i in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
            assert not th.is_alive()
        assert results == [want, want]
        with client.stream() as session:
            session.push(pcm)
        assert session.intervals
    finally:
        server.shutdown()
        t.join(30)
    assert not t.is_alive()


# -- launch counters ----------------------------------------------------------------


def test_locked_counter_loses_no_increment_under_16_threads():
    """16 threads, each counting 2000 launches of one kernel and reading
    the counts, with the interpreter switching threads every microsecond:
    ``x += 1`` on a module global would lose counts here."""
    import sys

    from segma_tpu_torch import ops
    from segma_tpu_torch.ops import attention, logmel

    counter = ops.LaunchCounter(("a", "b"))
    saved = ops.launch_counts()
    ops.set_launch_counts(dict.fromkeys(saved, 0))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(2000):
                counter.add({"a": 1})
                counter.read()
                ops.count_launch("logmel")
                ops.count_launch("flash_attn_fwd")

        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
            assert not t.is_alive()
        assert counter.read() == {"a": 16 * 2000, "b": 0}
        assert (logmel.launches, attention.launches) == (16 * 2000, 16 * 2000)
        ops.add_launch_counts({"flash_attn_bwd": 3})
        assert attention.bwd_launches == 3
    finally:
        sys.setswitchinterval(interval)
        ops.set_launch_counts(saved)
