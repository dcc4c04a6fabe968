"""Tensor and sequence parallelism in the port's serving, against the JAX
package on its 8 virtual CPU devices.

The models are tests/test_parallel.py's ``tp_model`` widths (Whisper d 64,
2 heads, 2 layers, ffn 128; surgical_hydra with a 16-wide BiLSTM, 1 s
chunks, f32), the JAX init plus N(0, 0.05) noise from numpy seed 0 so every
bias is non-zero (a row-parallel bias added once per member would show),
bridged by ``convert.flax_to_torch``. The port's members are CPU entries
of one device list; JAX's tolerance applies, rtol 2e-4 and atol 2e-5:

- the rules: for each of the ten registry models, the port shards exactly
  the parameters, on the same features, that JAX's ``spec_for_path``
  shards; the members' shards concatenate to the full weights; features
  that do not divide over ``model`` raise ``ValueError`` in both packages;
- ``ThreadGroup`` over 1, 2 and 4 members: the sum and the gather of a
  plain loop, the same bits on every member; a raising member ends the
  call with its own error well within the timeout, and a member that never
  arrives ends it at the timeout;
- ``attention_plain`` of a query block against the full keys is JAX's
  ``_einsum_core`` on the same block;
- the pipeline under (4,1,2), (1,4,2) and (2,2,2) against JAX's under the
  same mesh and against the port's meshless pipeline; HuBERT and WavLM
  under (4,1,2); fast_context under seq=2; 2 heads over model=4 (the heads
  do not divide, the features do); packing and ADPCM under (4,1,2) against
  per-file results; a seq config served without a mesh; the service over
  (2,1,2) answering as the meshless one does;
- the trainer refuses epoch dispatch over seq or model above 1, naming the
  queue item, and a recorded attention at unequal lengths says why none is
  needed.
"""

from __future__ import annotations

import threading
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import segma_tpu.inference as jinf
import segma_tpu.parallel.mesh as jmesh
from segma_tpu.config import load_config as jax_load_config
from segma_tpu.models import Models as JaxModels
from segma_tpu.ops.adpcm import AdpcmAudio as JaxAdpcmAudio
from segma_tpu.ops.attention import _einsum_core
from segma_tpu.parallel.sharding import shard_params as jax_shard_params
from segma_tpu.parallel.sharding import spec_for_path as jax_spec_for_path
from segma_tpu.utils.encoders import MultiLabelEncoder as JaxEncoder
from segma_tpu_torch import inference as tinf
from segma_tpu_torch.config import load_config
from segma_tpu_torch.convert import flax_path, load_flax_params
from segma_tpu_torch.models import Models
from segma_tpu_torch.ops.adpcm import adpcm_encode_audio
from segma_tpu_torch.ops.attention import attention_core, attention_plain
from segma_tpu_torch.parallel import make_mesh
from segma_tpu_torch.parallel import mesh as tmesh
from segma_tpu_torch.parallel.collectives import SOLO, GroupAborted, ThreadGroup, run_members
from segma_tpu_torch.parallel.sharding import (
    TP_RULES, member_groups, param_shardings, shard_params, spec_for_path, torch_dim,
)
from segma_tpu_torch.utils.encoders import MultiLabelEncoder

REPO = Path(__file__).resolve().parent.parent
JAX_DEFAULT = REPO / "segma_tpu/config/default.yml"
PORT_DEFAULT = REPO / "segma_tpu_torch/config/default.yml"
MODEL_NAMES = ("whisperidou", "whisperimax", "surgical_whisper", "hydra_whisper",
               "surgical_hydra", "surgical_hubert_hydra", "surgical_wavlm_hydra",
               "sincnet_hydra", "conv_vad", "powerset_vad")
RTOL, ATOL = 2e-4, 2e-5  # tests/test_parallel.py's
INNER = 4
WHISPER_TINY = dict(d_model=64, n_heads=2, n_layers=2, ffn_dim=128)
HUBERT_TINY = dict(hidden_size=64, n_layers=2, n_heads=2, ffn_dim=128, conv_dim=(32,) * 7,
                   pos_conv_kernel=16, pos_conv_groups=4)
WAVLM_TINY = dict(HUBERT_TINY, num_buckets=32, max_distance=80)
MESHES = {"4x1x2": dict(data=4, seq=1, model=2), "1x4x2": dict(data=1, seq=4, model=2),
          "2x2x2": dict(data=2, seq=2, model=2)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _noisy(params):
    rng = np.random.default_rng(0)
    return jax.tree.map(
        lambda a: (np.asarray(a) + rng.normal(0, 0.05, a.shape)).astype(np.float32), params)


def _pair(name: str, extra: tuple[str, ...] = ()):
    """(JAX model with noisy params, the port's model with the same weights)
    at tiny widths."""
    overrides = [f"model.name={name}", "audio.chunk_duration_s=1.0", "train.precision=f32",
                 *extra]
    if name == "surgical_hydra":
        overrides += ["model.config.encoder=missing_tiny",
                      "model.config.lstm={hidden_size: 16, num_layers: 1, "
                      "bidirectional: true, dropout: 0.0}"]
        from segma_tpu.models.whisper.encoder import WhisperEncoderConfig as J
        from segma_tpu_torch.models.whisper.encoder import WhisperEncoderConfig as T

        widths = WHISPER_TINY
    else:
        overrides += ["model.config.wav_encoder=missing", "audio.strict_frames=true"]
        if name == "surgical_hubert_hydra":
            from segma_tpu.models.hubert.encoder import HubertEncoderConfig as J
            from segma_tpu_torch.models.hubert.encoder import HubertEncoderConfig as T

            widths = HUBERT_TINY
        else:
            from segma_tpu.models.wavlm.encoder import WavLMEncoderConfig as J
            from segma_tpu_torch.models.wavlm.encoder import WavLMEncoderConfig as T

            widths = WAVLM_TINY
    jcfg = jax_load_config(JAX_DEFAULT, overrides)
    cfg = load_config(PORT_DEFAULT, overrides)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # random encoders, on purpose
        jmodel = JaxModels[name](JaxEncoder(jcfg.data.classes), jcfg)
        model = Models[name](MultiLabelEncoder(cfg.data.classes), cfg, device="cpu",
                             enc_cfg=T(**widths))
    jmodel.module = jmodel.module.clone(enc_cfg=J(**widths))
    jmodel.params = _noisy(jmodel.init_params(jax.random.key(0)))
    load_flax_params(model.module, jmodel.params)
    return jmodel, model


@pytest.fixture(scope="module")
def whisper():
    return _pair("surgical_hydra")


def _audio(n: int, seed: int) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(n) * 0.1).astype(np.float32)


def _port_mesh(sizes: dict):
    return make_mesh(devices=["cpu"] * int(np.prod(list(sizes.values()))), **sizes)


def _jax_pipeline(jmodel, sizes: dict | None):
    if sizes is None:
        return jinf.InferencePipeline(jmodel, jmodel.params, batch_size=INNER)
    mesh = jmesh.make_mesh(**sizes)
    if sizes.get("seq", 1) > 1:
        jmodel = jmodel.with_module(jmodel.module.clone(mesh=mesh))
    return jinf.InferencePipeline(jmodel, jmodel.params, batch_size=INNER, mesh=mesh)


def _close(got, ref) -> None:
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=RTOL, atol=ATOL)


# -- the rules -----------------------------------------------------------------------


def _jax_sharded(name: str) -> dict[str, tuple[tuple, tuple]]:
    """JAX's sharded leaves of ``name`` at the default config: flax path ->
    (spec, shape), from the init's shapes alone."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jcfg = jax_load_config(JAX_DEFAULT, [f"model.name={name}"])
        jmodel = JaxModels[name](JaxEncoder(jcfg.data.classes), jcfg)
    wav = jnp.zeros((1, jcfg.audio.chunk_duration_f), jnp.float32)
    shapes = jax.eval_shape(
        lambda k: jmodel.module.init({"params": k}, wav, train=False), jax.random.key(0))
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes["params"])[0]:
        spec = tuple(jax_spec_for_path(path))
        if spec:
            out["/".join(str(getattr(k, "key", k)) for k in path)] = (spec, leaf.shape)
    return out


@pytest.mark.parametrize("name", MODEL_NAMES)
def test_rules_shard_what_jax_shards(name):
    """The same parameters, the same specs, the same features."""
    want = _jax_sharded(name)
    cfg = load_config(PORT_DEFAULT, [f"model.name={name}"])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = Models[name](MultiLabelEncoder(cfg.data.classes), cfg, device="cpu")
    state = model.module.state_dict()
    got = {"/".join(flax_path(model.module, k)): (spec, tuple(state[k].shape))
           for k, spec in param_shardings(model.module).items() if spec}
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:6]
    for path, (spec, shape) in got.items():
        jspec, jshape = want[path]
        assert spec == jspec, path
        flax_dim = spec.index("model")
        assert shape[torch_dim(spec)] == jshape[flax_dim], path
    # the encoders' attention and MLP are what is sharded, when there is one
    assert bool(want) == (name not in ("sincnet_hydra", "conv_vad", "powerset_vad"))


def test_rules_are_jax_s():
    from segma_tpu.parallel.sharding import TP_RULES as JAX_RULES

    assert [(p, s) for p, s in TP_RULES] == [(p, tuple(s)) for p, s in JAX_RULES]
    for path in ("encoder/layers_0/self_attn/q_proj/bias", "encoder/layers_3/fc2/bias",
                 "encoder/layers_1/attention/out_proj/kernel", "heads/heads/kernel"):
        assert spec_for_path(path) == spec_for_path(tuple(path.split("/")))


def test_shards_concatenate_to_the_full_weights(whisper):
    _, model = whisper
    copies = shard_params(model.module, _port_mesh(dict(data=1, seq=1, model=2)))
    full = model.module.state_dict()
    specs = param_shardings(model.module)
    members = [c.state_dict() for c in copies.flat]
    n_sharded = 0
    for name, value in full.items():
        dim = torch_dim(specs[name])
        if dim is None:
            for m in members:
                assert torch.equal(m[name], value), name
            continue
        n_sharded += 1
        assert all(m[name].shape[dim] == value.shape[dim] // 2 for m in members), name
        assert torch.equal(torch.cat([m[name] for m in members], dim), value), name
    # q, k, v, out, fc1, fc2 kernels and the q, v, fc1 biases (k has none) of 2 layers
    assert n_sharded == 2 * 9


@pytest.mark.parametrize("sizes", [(1, 2), (2, 1), (2, 2)])
def test_an_axis_of_one_gets_the_identity_group(whisper, sizes):
    n_seq, n_model = sizes
    _, model = whisper
    copies = shard_params(model.module, _port_mesh(dict(data=2, seq=n_seq, model=n_model)))
    for (i, s, m), member in np.ndenumerate(copies):
        attn = member.encoder.layers[0].self_attn
        for group, n, rank in ((member.encoder.seq_group, n_seq, s),
                               (attn.model_group, n_model, m)):
            if n == 1:
                assert group is SOLO
            else:
                assert (group.group.size, group.rank) == (n, rank)
        # one seq group per model rank and one model group per seq rank, per coordinate
        assert len(member_groups(member)) == (n_seq > 1) + (n_model > 1)
    groups = {g for member in copies.flat for g in member_groups(member)}
    assert len(groups) == 2 * ((n_seq > 1) * n_model + (n_model > 1) * n_seq)


def test_features_that_do_not_divide_raise_as_in_jax(whisper):
    jmodel, model = whisper
    with pytest.raises(ValueError, match="divisible"):
        jax_shard_params(jmodel.params, jmesh.make_mesh(devices=jax.devices()[:6], data=2,
                                                        model=3))
    with pytest.raises(ValueError, match="divisible"):
        shard_params(model.module, _port_mesh(dict(data=2, seq=1, model=3)))


# -- the group -----------------------------------------------------------------------


@pytest.mark.parametrize("size", [1, 2, 4])
def test_thread_group_sums_and_gathers_in_rank_order(size):
    group = ThreadGroup(["cpu"] * size, timeout=30)
    xs = [torch.from_numpy(np.random.default_rng(i).standard_normal((3, 5)).astype(np.float32))
          for i in range(size)]
    want_sum = xs[0]
    for x in xs[1:]:
        want_sum = want_sum + x
    with ThreadPoolExecutor(size) as pool:
        outs = run_members(pool, [
            lambda r=r: (group.member(r).all_reduce_sum(xs[r] * 1),
                         group.member(r).all_gather(xs[r], dim=1),
                         group.member(r).all_reduce_sum(xs[r] * 2))
            for r in range(size)], [group])
    for total, gathered, doubled in outs:
        assert torch.equal(total, want_sum)  # the same bits on every member
        assert torch.equal(gathered, torch.cat(xs, dim=1))
        assert torch.equal(doubled, outs[0][2])


def test_thread_group_under_a_short_switch_interval():
    """16 members, 50 rounds each of a sum and a gather, with the
    interpreter switching threads every microsecond: a slot read before its
    round's deposit, or overwritten while a peer reads it, breaks a result."""
    import sys

    n, rounds = 16, 50
    group = ThreadGroup(["cpu"] * n, timeout=60)

    def member(r: int) -> bool:
        me = group.member(r)
        for i in range(rounds):
            x = torch.full((3,), float(i * n + r))
            total = float(i * n * n + n * (n - 1) // 2)  # the sum over r of i n + r
            if not torch.equal(me.all_reduce_sum(x), torch.full((3,), total)):
                return False
            if not torch.equal(me.all_gather(x, dim=0)[::3], torch.arange(n) + float(i * n)):
                return False
        return True

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(n) as pool:
            assert all(run_members(pool, [lambda r=r: member(r) for r in range(n)], [group]))
    finally:
        sys.setswitchinterval(interval)


def test_a_raising_member_ends_the_call_with_its_error():
    group = ThreadGroup(["cpu"] * 4, timeout=60)

    def task(r: int):
        if r == 2:
            raise ValueError("member 2 saw a bad shape")
        return group.member(r).all_reduce_sum(torch.ones(2))

    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as pool:
        with pytest.raises(ValueError, match="member 2"):
            run_members(pool, [lambda r=r: task(r) for r in range(4)], [group])
        assert time.perf_counter() - t0 < 10  # the peers were released, not timed out
        # the group is ready for the next call
        outs = run_members(pool, [lambda r=r: group.member(r).all_reduce_sum(torch.ones(2))
                                  for r in range(4)], [group])
    assert all(torch.equal(o, torch.full((2,), 4.0)) for o in outs)


def test_a_missing_member_ends_the_call_at_the_timeout():
    group = ThreadGroup(["cpu"] * 2, timeout=0.5)
    t0 = time.perf_counter()
    with pytest.raises(GroupAborted, match="0.5 s"):
        group.member(0).all_gather(torch.ones(1), dim=0)
    assert time.perf_counter() - t0 < 10


# -- attention ---------------------------------------------------------------------


@pytest.mark.parametrize("block", [(0, 375), (375, 750), (100, 137)])
def test_query_block_attention_is_jax_s(block):
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((2, 1500, 2, 64)).astype(np.float32) for _ in range(3))
    lo, hi = block
    want = _einsum_core(jnp.asarray(q[:, lo:hi]), jnp.asarray(k), jnp.asarray(v), 0.125,
                        jnp.float32)
    got = attention_plain(torch.from_numpy(q[:, lo:hi]), torch.from_numpy(k),
                          torch.from_numpy(v), 0.125, torch.float32)
    assert got.shape == (2, hi - lo, 2, 64)
    _close(got, want)
    full = attention_plain(*map(torch.from_numpy, (q, k, v)), 0.125, torch.float32)
    _close(got, full[:, lo:hi])


def test_recorded_attention_at_unequal_lengths_names_the_training_item():
    """Refused under autograd, with the reason: no trained path splits time
    (the Whisper encoder, the one that does, is frozen)."""
    q = torch.zeros(1, 4, 1, 64, requires_grad=True)
    kv = torch.zeros(1, 8, 1, 64)
    with pytest.raises(NotImplementedError, match="only the Whisper encoder splits time .* frozen"):
        attention_core(q, kv, kv, sm_scale=0.125, dtype=torch.float32)
    with torch.no_grad():
        assert attention_core(q, kv, kv, sm_scale=0.125, dtype=torch.float32).shape == q.shape


# -- serving -----------------------------------------------------------------------


@pytest.mark.parametrize("mesh", list(MESHES))
def test_whisper_pipeline_matches_jax_under_the_same_mesh(whisper, mesh):
    jmodel, model = whisper
    audio = _audio(50_000, seed=1)
    pipe = tinf.InferencePipeline(model, batch_size=INNER, device="cpu",
                                  mesh=_port_mesh(MESHES[mesh]))
    got = pipe.logits_for_audio(audio)
    assert pipe.members.shape == tuple(MESHES[mesh].values())
    _close(got, _jax_pipeline(jmodel, MESHES[mesh]).logits_for_audio(audio))
    _close(got, tinf.InferencePipeline(model, batch_size=INNER,
                                       device="cpu").logits_for_audio(audio))


@pytest.mark.parametrize("name", ["surgical_hubert_hydra", "surgical_wavlm_hydra"])
def test_raw_waveform_families_match_jax_under_tp(name):
    jmodel, model = _pair(name)
    audio = _audio(40_000, seed=3)
    got = tinf.InferencePipeline(model, batch_size=INNER, device="cpu",
                                 mesh=_port_mesh(MESHES["4x1x2"])).logits_for_audio(audio)
    _close(got, _jax_pipeline(jmodel, MESHES["4x1x2"]).logits_for_audio(audio))
    _close(got, tinf.InferencePipeline(model, batch_size=INNER,
                                       device="cpu").logits_for_audio(audio))


def test_fast_context_under_seq():
    """The encoder on the chunk's own 100 log-mel frames: 50 positions, two
    time blocks of 25."""
    jmodel, model = _pair("surgical_hydra", ("model.config.fast_context=true",))
    audio = _audio(30_000, seed=4)
    sizes = dict(data=2, seq=2, model=2)
    got = tinf.InferencePipeline(model, batch_size=INNER, device="cpu",
                                 mesh=_port_mesh(sizes)).logits_for_audio(audio)
    _close(got, _jax_pipeline(jmodel, sizes).logits_for_audio(audio))
    _close(got, tinf.InferencePipeline(model, batch_size=INNER,
                                       device="cpu").logits_for_audio(audio))


@pytest.mark.parametrize("name", ["surgical_hydra", "surgical_wavlm_hydra"])
def test_heads_that_do_not_divide_over_model(name):
    """2 heads over model=4 (64 and 128 features divide): every member
    attends all heads from the gathered q, k, v, and keeps its features."""
    jmodel, model = _pair(name)
    audio = _audio(30_000, seed=5)
    sizes = dict(data=2, seq=1, model=4)
    got = tinf.InferencePipeline(model, batch_size=INNER, device="cpu",
                                 mesh=_port_mesh(sizes)).logits_for_audio(audio)
    _close(got, _jax_pipeline(jmodel, sizes).logits_for_audio(audio))


def test_packing_under_tp_matches_per_file(whisper):
    jmodel, model = whisper
    rng = np.random.default_rng(5)
    audios = [(rng.standard_normal(n) * 0.1).astype(np.float32)
              for n in (20_000, 33_000, 20_500, 47_000)]
    single = tinf.InferencePipeline(model, batch_size=INNER, device="cpu")
    refs = [single.logits_for_audio(a) for a in audios]
    pipe = tinf.InferencePipeline(model, batch_size=INNER, device="cpu",
                                  mesh=_port_mesh(MESHES["4x1x2"]))
    jrefs = [jinf.InferencePipeline(jmodel, jmodel.params, batch_size=INNER).logits_for_audio(a)
             for a in audios]
    for (lg, tf), ref, jref in zip(pipe.logits_for_audios_async(audios, pack_files=4), refs,
                                   jrefs):
        _close(lg[:tf].numpy(), ref)
        _close(lg[:tf].numpy(), jref)


def test_adpcm_under_tp_matches_one_device(whisper):
    jmodel, model = whisper
    wav = (np.random.default_rng(6).standard_normal(40_000) * 3000).astype(np.int16)
    enc = adpcm_encode_audio(wav)
    ref = tinf.InferencePipeline(model, batch_size=INNER, device="cpu").logits_for_audio(enc)
    pipe = tinf.InferencePipeline(model, batch_size=INNER, device="cpu", transport="adpcm",
                                  mesh=_port_mesh(MESHES["4x1x2"]))
    got = pipe.logits_for_audio(enc)
    _close(got, ref)
    _close(got, jinf.InferencePipeline(jmodel, jmodel.params, batch_size=INNER).logits_for_audio(
        JaxAdpcmAudio(enc.data, enc.n_samples)))
    np.testing.assert_array_equal(pipe.logits_for_audio(wav), got)  # encoded at dispatch


def test_seq_config_serves_without_a_mesh_on_one_device(whisper, monkeypatch):
    """mesh.seq=2 on one device: ``--mesh auto`` resolves to no mesh and the
    model serves meshless (JAX builds it without a mesh then); over two
    devices it resolves to (1, 2, 1)."""
    jmodel, model = whisper
    cfg = load_config(PORT_DEFAULT, ["model.name=surgical_hydra", "mesh.seq=2", "mesh.data=1"])
    assert tinf.resolve_mesh("auto", cfg, torch.device("cpu")) is None
    monkeypatch.setattr(tmesh, "visible_devices", lambda device: [torch.device("cpu")] * 2)
    assert tinf.resolve_mesh("auto", cfg, torch.device("cpu")).shape == {
        "data": 1, "seq": 2, "model": 1}
    audio = _audio(20_000, seed=7)
    plain = tinf.InferencePipeline(model, batch_size=INNER, device="cpu").logits_for_audio(audio)
    _close(plain, _jax_pipeline(jmodel, None).logits_for_audio(audio))
    two = tinf.InferencePipeline(model, batch_size=INNER, device="cpu",
                                 mesh=tinf.resolve_mesh("auto", cfg, torch.device("cpu")))
    _close(two.logits_for_audio(audio), plain)


def test_members_are_bit_identical_across_the_group(whisper):
    """Each member of a coordinate ends with the same bits: the logits of
    the model-rank 1 and seq-rank 1 members equal the supplying member's."""
    _, model = whisper
    pipe = tinf.InferencePipeline(model, batch_size=INNER, device="cpu",
                                  mesh=_port_mesh(dict(data=1, seq=2, model=2)))
    chunks = torch.from_numpy(_audio(4 * 16_000, seed=8).reshape(4, 16_000))
    outs = run_members(pipe._pool, [lambda m=m: m.apply(chunks) for m in pipe.members.flat],
                       pipe._groups)
    for out in outs[1:]:
        assert torch.equal(out, outs[0])


def test_a_raising_member_does_not_hang_the_pipeline(whisper, monkeypatch):
    _, model = whisper
    pipe = tinf.InferencePipeline(model, batch_size=INNER, device="cpu",
                                  mesh=_port_mesh(dict(data=1, seq=2, model=2)))
    bad = pipe.members[0, 1, 1]
    real = bad.apply
    monkeypatch.setattr(bad, "apply", lambda wav: (_ for _ in ()).throw(
        RuntimeError("member (0, 1, 1) failed")))
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match=r"\(0, 1, 1\) failed"):
        pipe.logits_for_audio(_audio(20_000, seed=9))
    assert time.perf_counter() - t0 < 60
    monkeypatch.setattr(bad, "apply", real)
    _close(pipe.logits_for_audio(_audio(20_000, seed=9)),
           tinf.InferencePipeline(model, batch_size=INNER,
                                  device="cpu").logits_for_audio(_audio(20_000, seed=9)))


def test_service_over_a_tp_mesh_answers_as_one_device(whisper, tmp_path, monkeypatch):
    """``serve_forever(mesh=(2, 1, 2))``: a one-shot request answers as a
    meshless service does."""
    import wave

    from segma_tpu_torch import checkpoint, serve
    from segma_tpu_torch.client import SegmaClient
    from segma_tpu_torch.serve import runtime

    _, model = whisper
    servers = []
    real_make = runtime.make_server

    def capture(*a, **kw):
        servers.append(real_make(*a, **kw))
        return servers[-1]

    monkeypatch.setattr(runtime, "make_server", capture)
    monkeypatch.setattr(checkpoint, "load_model_for_inference", lambda *a, **kw: model)
    t = threading.Thread(target=serve.serve_forever, kwargs=dict(
        config=model.config, port=0, batch_size=INNER, batch_window_ms=0.0,
        mesh=_port_mesh(dict(data=2, seq=1, model=2)), device="cpu"), daemon=True)
    t.start()
    for _ in range(600):
        if servers:
            break
        t.join(0.1)
    assert servers, "the server did not bind"
    try:
        wav = tmp_path / "r.wav"
        with wave.open(str(wav), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16_000)
            w.writeframes((_audio(90_000, seed=10) * 20_000).astype("<i2").tobytes())
        ref_server = serve.make_server(serve.SegmentationService(
            tinf.InferencePipeline(model, batch_size=INNER, device="cpu")), port=0)
        threading.Thread(target=ref_server.serve_forever, daemon=True).start()
        try:
            want = SegmaClient(
                f"http://127.0.0.1:{ref_server.server_address[1]}").segment(str(wav))
        finally:
            ref_server.shutdown()
        got = SegmaClient(f"http://127.0.0.1:{servers[0].server_address[1]}").segment(str(wav))
        assert want and got == want
    finally:
        servers[0].shutdown()
        t.join(30)
    assert not t.is_alive()


# -- training refuses epoch dispatch only ---------------------------------------------


def test_training_refuses_tp_and_sp_naming_the_queue_item():
    """The trainer's check refuses ``train.dispatch=epoch`` over seq or model
    above 1 where the ranks are gloo ranks on cards, saying why and that
    step dispatch trains the mesh (it names no queue item: NCCL ranks on
    cards train it under epoch dispatch); step dispatch, and epoch dispatch
    over a data-only mesh, pass."""
    from segma_tpu_torch.parallel.mesh import EPOCH_GLOO_CARD, check_dispatch

    assert "Queue" not in EPOCH_GLOO_CARD and "train.dispatch=step" in EPOCH_GLOO_CARD
    epoch = load_config(PORT_DEFAULT, ["train.dispatch=epoch"])
    step = load_config(PORT_DEFAULT, ["train.dispatch=step"])
    for sizes in (dict(model=2), dict(seq=2), dict(data=1, seq=2, model=2)):
        shape = tuple(make_mesh(devices=["cpu"] * 4, **sizes).shape.values())
        with pytest.raises(ValueError, match="NCCL refuses two ranks on one card"):
            check_dispatch(epoch, shape, "gloo", "cuda:0")
        check_dispatch(step, shape, "gloo", "cuda:0")
    check_dispatch(epoch, tuple(make_mesh(devices=["cpu"] * 4).shape.values()), "gloo", "cuda:0")
