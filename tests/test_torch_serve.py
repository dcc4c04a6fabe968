"""The port's HTTP/WebSocket server (``segma_tpu_torch/serve``) against the
JAX package's ``segma_tpu.serve`` on the same conv_vad weights (hidden 32,
depth 2, 1 s chunks, the JAX params bridged by ``convert.flax_to_torch``),
both servers on 127.0.0.1 in this process, driven by the port's
``SegmaClient`` and by raw requests.

The thresholds lie more than 10x the measured port-vs-JAX probability
difference away from every frame of the audio sent (as
tests/test_torch_inference.py places them), so the two servers' answers
are compared byte for byte:

- ``/v1/segment`` JSON (WAV, big- and little-endian L16) and RTTM bodies;
- HTTP and WebSocket streaming sessions;
- the status codes of bad bodies (400), unknown paths and sessions (404),
  a reload without a bundle (409), an oversized body (413) and the session
  cap (429);
- the API contract (response keys, metric names);
- micro-batching groups concurrent requests; two streaming sessions and
  one-shot requests run together under ``batch_window_ms > 0`` answer as
  they do one after the other;
- the session cap, the SIGTERM drain and the RSS watchdog's exit 75;
- the serve CLI on the CPU answers /healthz and drains on SIGTERM (exit 0);
  a missing artifact or bundle raises before the server binds.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

import segma_tpu.serve as jserve
from segma_tpu.inference import InferencePipeline as JaxPipeline
from segma_tpu_torch import checkpoint
from segma_tpu_torch import inference as tinf
from segma_tpu_torch import serve
from segma_tpu_torch.client import SegmaClient, SegmaClientError, iter_wav_chunks
from segma_tpu_torch.config import load_config
from tests.test_torch_vad import REPO, build_pair, overrides

STRIDE = 15_680  # conv_vad's chunk stride at 1 s chunks


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pcm(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16_000
    env = (np.sin(2 * np.pi * t / 0.9) > 0).astype(np.float64)
    sig = 0.4 * np.sin(2 * np.pi * 350.0 * t) * env + 0.08 * rng.standard_normal(n)
    return (np.clip(sig, -1, 1) * 32767).astype(np.int16)


def _wav(path: Path, pcm: np.ndarray) -> Path:
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16_000)
        w.writeframes(pcm.astype("<i2").tobytes())
    return path


AUDIO = {
    "request": _pcm(40_000, 12),
    "stream_a": _pcm(48_000, 100),
    "stream_b": _pcm(3 * STRIDE + 9_000, 101),
}


def _start(server) -> str:
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{server.server_address[1]}"


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    jmodel, model = build_pair("conv_vad")
    jpipe = JaxPipeline(jmodel, jmodel.params, batch_size=8)
    pipe = tinf.InferencePipeline(model, batch_size=8, device="cpu")
    ref = np.concatenate([jpipe.logits_for_audio(a) for a in AUDIO.values()])
    got = np.concatenate([pipe.logits_for_audio(a) for a in AUDIO.values()])
    ref_p, got_p = (1 / (1 + np.exp(-x)) for x in (ref, got))
    margin = max(10 * float(np.abs(ref_p - got_p).max()), 1e-6)
    thr = {}
    for li, label in enumerate(model.label_encoder.base_labels):
        p = np.sort(ref_p[:, li])
        mid = p[int(0.1 * len(p)) : int(0.9 * len(p)) + 1]
        gaps = np.diff(mid)
        i = int(np.argmax(gaps))
        assert gaps[i] / 2 > margin, (label, gaps[i])
        thr[label] = {"lower_bound": float((mid[i] + mid[i + 1]) / 2), "upper_bound": 1.0}
    root = tmp_path_factory.mktemp("serve")
    wav_path = _wav(root / "req.wav", AUDIO["request"])
    jsvc = jserve.SegmentationService(jpipe, thr)
    svc = serve.SegmentationService(pipe, thr)
    servers = {"jax": jserve.make_server(jsvc, port=0), "torch": serve.make_server(svc, port=0)}
    urls = {k: _start(s) for k, s in servers.items()}
    yield {"pipe": pipe, "jpipe": jpipe, "thr": thr, "svc": svc, "jsvc": jsvc, "urls": urls,
           "wav": wav_path, "model": model, "jmodel": jmodel}
    for s in servers.values():
        s.shutdown()


def _post(url: str, body: bytes, ctype: str = "application/octet-stream"):
    req = urllib.request.Request(url, data=body, method="POST")
    req.add_header("Content-Type", ctype)
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, resp.read()


def _status(method: str, url: str, body: bytes | None = None,
            headers: dict | None = None) -> int:
    req = urllib.request.Request(url, data=body, method=method, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            resp.read()
            return resp.status
    except urllib.error.HTTPError as e:
        return e.code


def test_segment_bodies_match_jax(env):
    body = env["wav"].read_bytes()
    pcm = AUDIO["request"]
    for query, data, ctype in (
        ("uri=req", body, "application/octet-stream"),
        ("uri=req&format=rttm", body, "application/octet-stream"),
        ("uri=be", pcm.astype(">i2").tobytes(), "audio/l16; rate=16000"),
        ("uri=le", pcm.astype("<i2").tobytes(), "audio/L16;endianness=little"),
    ):
        got = _post(f"{env['urls']['torch']}/v1/segment?{query}", data, ctype)
        ref = _post(f"{env['urls']['jax']}/v1/segment?{query}", data, ctype)
        assert got == ref, query
    payload = json.loads(_post(f"{env['urls']['torch']}/v1/segment?uri=req", body)[1])
    assert payload["intervals"] and payload["uri"] == "req"
    # and the intervals are run_inference_on_audios's on the same file
    out = env["wav"].parent / "offline"
    tinf.run_inference_on_audios(env["model"].config, env["wav"].parent, None, out,
                                 thresholds=env["thr"], model=env["model"], device="cpu",
                                 batch_size=8)
    client = SegmaClient(env["urls"]["torch"])
    served = client.segment(env["wav"], uri="req", rttm=True).splitlines()
    # the server sorts by time, the file goes label by label
    assert sorted(served) == sorted((out / "raw_rttm" / "req.rttm").read_text().splitlines())


def _client_streams(url: str, pcm: np.ndarray, ws: bool) -> list:
    client = SegmaClient(url)
    with (client.stream_ws() if ws else client.stream()) as s:
        for k in range(0, len(pcm), 8_000):
            s.push(pcm[k : k + 8_000])
    return sorted(s.intervals)


@pytest.mark.parametrize("ws", [False, True], ids=["http", "websocket"])
def test_streaming_matches_jax_and_one_shot(env, ws):
    for name in ("stream_a", "stream_b"):
        pcm = AUDIO[name]
        got = _client_streams(env["urls"]["torch"], pcm, ws)
        assert got == _client_streams(env["urls"]["jax"], pcm, ws), name
        one = SegmaClient(env["urls"]["torch"]).segment(pcm)
        assert got == sorted(one) and got, name
    assert not env["svc"]._streams


def test_status_codes_match_jax(env):
    def codes(url: str, small: str, capped: str) -> list[int]:
        sid = json.loads(_post(f"{url}/v1/stream/start", b"")[1])["session"]
        _post(f"{url}/v1/stream/{sid}/flush", b"")
        return [
            _status("POST", f"{url}/v1/segment", b"tiny"),  # not a WAV: 400
            _status("POST", f"{url}/v1/segment", b"RIFF\x00\x00"),  # truncated WAV: 400
            _status("POST", f"{url}/v1/segment", b"\x00\x01\x02",
                    {"Content-Type": "audio/l16"}),  # odd byte count: 400
            _status("GET", f"{url}/v1/stream/ws"),  # no upgrade header: 400
            _status("GET", f"{url}/nope"),  # 404
            _status("POST", f"{url}/v1/nope", b""),  # 404
            _status("POST", f"{url}/v1/segment?model=other", b""),  # unknown model: 404
            _status("POST", f"{url}/v1/stream/{sid}/push", b"\x00\x00"),  # flushed: 404
            _status("POST", f"{url}/v1/stream/{sid}/flush", b""),  # 404
            _status("POST", f"{url}/admin/reload", b""),  # no bundle: 409
            _status("POST", f"{small}/v1/segment", b"\x00" * 4096),  # 413
            _status("POST", f"{small}/v1/segment", b"tiny"),  # under the cap: 400
            _status("POST", f"{capped}/v1/stream/start", b""),  # 200
            _status("POST", f"{capped}/v1/stream/start", b""),  # the cap of 1: 429
            _status("GET", f"{url}/healthz"),  # 200
        ]

    results = {}
    for side, mod, svc in (("jax", jserve, env["jsvc"]), ("torch", serve, env["svc"])):
        small = mod.make_server(svc, port=0, max_body_bytes=1024)
        capped = mod.make_server(mod.SegmentationService(svc.pipeline, env["thr"],
                                                         max_sessions=1), port=0)
        try:
            results[side] = codes(env["urls"][side], _start(small), _start(capped))
        finally:
            small.shutdown()
            capped.shutdown()
    assert results["torch"] == results["jax"]
    assert results["torch"] == [400, 400, 400, 400, 404, 404, 404, 404, 404, 409, 413, 400,
                                200, 429, 200]


def test_http_api_contract_is_stable(env):
    url = env["urls"]["torch"]
    payload = json.loads(_post(f"{url}/v1/segment?uri=c", env["wav"].read_bytes())[1])
    assert set(payload) == {"uri", "sample_rate", "intervals"}
    assert all(set(iv) == {"label", "start_s", "end_s"} for iv in payload["intervals"])
    client = SegmaClient(url)
    health = client.health()
    assert set(health) == {"status", "version", "model", "labels", "device"}
    assert health["model"] == "conv_vad" and health["status"] == "ok"
    assert set(json.loads(urllib.request.urlopen(f"{env['urls']['jax']}/healthz").read())) == set(
        health)
    names = {ln.split("{")[0].split()[0] for ln in client.metrics().splitlines()
             if ln and not ln.startswith("#")}
    assert names == {
        "segma_requests_total", "segma_request_errors_total", "segma_audio_seconds_total",
        "segma_uptime_seconds", "segma_batch_dispatches_total",
        "segma_request_latency_seconds", "segma_host_rss_bytes",
    }
    assert client.models() == {"default": "conv_vad", "models": {"conv_vad": {
        "model": "conv_vad", "labels": env["svc"].labels, "sample_rate": 16_000,
        "streaming": True}}}
    with pytest.raises(SegmaClientError) as e:
        client.reload()
    assert e.value.status == 409


def test_micro_batching_groups_concurrent_requests(env):
    body = env["wav"].read_bytes()
    batched = serve.SegmentationService(env["pipe"], env["thr"], batch_window_ms=200.0,
                                        max_batch=8)
    direct = env["svc"].segment(body)
    results = []
    threads = [threading.Thread(target=lambda: results.append(batched.segment(body)))
               for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(results) == 6 and all(r == direct for r in results) and direct
    assert batched._batcher.dispatches < 6
    with pytest.raises(ValueError, match="RIFF"):
        batched.segment(b"definitely not audio")
    pcm = np.zeros(20_000, "<i2").tobytes()
    assert batched.segment(pcm, "audio/l16") == env["svc"].segment(pcm, "audio/l16")


def test_streams_and_one_shots_together_match_serial(env):
    """Two HTTP streaming sessions (ChunkForwardBatcher) and four one-shot
    requests (micro-batcher) at once, under batch_window_ms > 0."""
    svc = serve.SegmentationService(env["pipe"], env["thr"], batch_window_ms=20.0,
                                    max_batch=4)
    server = serve.make_server(svc, port=0)
    url = _start(server)
    expected_streams = {n: _client_streams(env["urls"]["torch"], AUDIO[n], False)
                        for n in ("stream_a", "stream_b")}
    body = env["wav"].read_bytes()
    expected_one = SegmaClient(env["urls"]["torch"]).segment(body)
    got: dict = {}
    errors: list = []

    def stream(name: str) -> None:
        try:
            got[name] = _client_streams(url, AUDIO[name], False)
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    def one(k: int) -> None:
        try:
            got[k] = SegmaClient(url).segment(body)
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    threads = [threading.Thread(target=stream, args=(n,)) for n in expected_streams]
    threads += [threading.Thread(target=one, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    server.shutdown()
    assert not errors, errors
    for name, ref in expected_streams.items():
        assert got[name] == ref and ref, name
    assert all(got[k] == expected_one for k in range(4))
    assert svc._stream_forward.dispatches < sum(
        -(-len(AUDIO[n]) // STRIDE) for n in expected_streams) + 2
    assert not svc._streams


def test_stream_session_cap(env):
    capped = serve.SegmentationService(env["pipe"], max_sessions=2)
    a = capped.stream_start()
    capped.stream_start()
    with pytest.raises(serve.SessionLimitError):
        capped.stream_start()
    capped.stream_flush(a)
    capped.stream_start()  # the freed slot is reusable
    with pytest.raises(KeyError):
        capped.stream_flush(a)


def test_sigterm_drains_and_stops(env):
    prev = signal.getsignal(signal.SIGTERM)
    srv = serve.make_server(env["svc"], port=0)

    def kill_soon():
        time.sleep(0.3)
        os.kill(os.getpid(), signal.SIGTERM)

    threading.Thread(target=kill_soon, daemon=True).start()
    t0 = time.monotonic()
    serve._serve_until_signalled(srv)
    assert time.monotonic() - t0 < 10
    assert signal.getsignal(signal.SIGTERM) is prev


def test_rss_watchdog_drains_and_exits_75(env, monkeypatch):
    srv = serve.make_server(env["svc"], port=0)
    real = serve._start_rss_watchdog
    monkeypatch.setattr(serve.runtime, "_start_rss_watchdog",
                        lambda server, limit: real(server, limit, poll_s=0.2))
    with pytest.raises(SystemExit) as e:
        serve._serve_until_signalled(srv, max_rss_gb=0.001)  # any process exceeds 1 MB
    assert e.value.code == 75


def test_drain_waits_for_inflight_reply(env):
    slow = serve.SegmentationService(env["pipe"], env["thr"])
    orig = slow._segment_audios

    def slow_segment(audios):
        time.sleep(1.0)
        return orig(audios)

    slow._segment_audios = slow_segment
    srv = serve.make_server(slow, port=0)
    url = _start(srv)
    result = {}
    ct = threading.Thread(target=lambda: result.update(
        zip(("status", "raw"), _post(f"{url}/v1/segment", env["wav"].read_bytes()))))
    ct.start()
    deadline = time.monotonic() + 5
    while srv.inflight() == 0 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert srv.inflight() == 1
    srv.shutdown()
    srv.drain(grace_s=10.0)
    assert srv.inflight() == 0
    ct.join(10)
    assert result.get("status") == 200 and json.loads(result["raw"])["intervals"]


def test_iter_wav_chunks_and_adpcm_uploads(env):
    chunks = list(iter_wav_chunks(env["wav"], chunk_s=0.5))
    np.testing.assert_array_equal(np.concatenate(chunks), AUDIO["request"])
    assert {len(c) for c in chunks[:-1]} == {8_000}
    adpcm = serve.SegmentationService(
        tinf.InferencePipeline(env["model"], batch_size=8, device="cpu", transport="adpcm"),
        env["thr"], transport="adpcm")
    audio = adpcm._audio_from_body(env["wav"].read_bytes(), "")
    assert audio.data.dtype == np.uint8 and audio.n_samples == len(AUDIO["request"])
    assert isinstance(adpcm.segment(env["wav"].read_bytes()), list)


def test_export_paths_raise(env, tmp_path):
    """The export paths are ported (tests/test_torch_export.py and
    test_torch_bundle.py serve them): here, a missing artifact or bundle
    raises before anything binds, and a mesh that is not a ``parallel.Mesh``
    (nor "auto", "off" or None) is refused."""
    missing = str(tmp_path / "missing")
    with pytest.raises(FileNotFoundError):
        serve.serve_forever(artifact=missing, device="cpu")
    with pytest.raises(FileNotFoundError):
        serve.serve_forever(bundle=missing, device="cpu")
    with pytest.raises(FileNotFoundError):
        serve.bundle_reloader(missing, device="cpu")({})
    with pytest.raises(ValueError, match="mesh must be"):
        serve.serve_forever(config=env["model"].config, mesh=object(), device="cpu")
    from segma_tpu_torch.cli import serve as cli_serve

    with pytest.raises(FileNotFoundError):
        cli_serve.main(["--artifact", missing, "--device", "cpu"])
    with pytest.raises(SystemExit):
        cli_serve.main(["--device", "cpu"])  # no source


def test_serve_forever_needs_a_card_unless_asked(env, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.serve_forever(config=env["model"].config)


def test_serve_cli_on_the_cpu(tmp_path):
    """python -m segma_tpu_torch.cli.serve --device cpu: warm-up, /healthz,
    one /segment, and a SIGTERM drain to exit 0."""
    over = overrides("conv_vad")
    cfg = load_config(REPO / "segma_tpu_torch/config/default.yml", over)
    model = checkpoint.build_model(cfg, device="cpu")
    trainable, frozen = checkpoint.flax_split(model)
    checkpoint.save_params(tmp_path / "ck", trainable,
                           {"frozen_fingerprint": checkpoint.frozen_fingerprint(frozen)})
    log = tmp_path / "serve.log"
    with log.open("w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "segma_tpu_torch.cli.serve", "--config",
             str(REPO / "segma_tpu_torch/config/default.yml"), "--checkpoint",
             str(tmp_path / "ck"), "--port", "0", "--device", "cpu", "--batch-window-ms", "5",
             *over],
            cwd=REPO, stdout=out, stderr=subprocess.STDOUT,
            env={**os.environ, "OMP_NUM_THREADS": "1"},
        )
    try:
        deadline = time.monotonic() + 120
        url = None
        while time.monotonic() < deadline and url is None:
            for line in log.read_text().splitlines():
                if "serving conv_vad on " in line:
                    url = line.split(" on ")[-1].strip()
            if proc.poll() is not None:
                break
            time.sleep(0.2)
        assert url, log.read_text()
        client = SegmaClient(url)
        assert client.health()["device"].startswith("cpu")
        pcm = _pcm(20_000, 3)
        ref = tinf.InferencePipeline(model, batch_size=64, device="cpu")
        thr = tinf.default_thresholds(model.label_encoder.base_labels)
        expected = sorted(ref.decode_intervals(ref.logits_for_audio(pcm), thr))
        got = client.segment(pcm)
        assert [(round(s * 16_000), round(e * 16_000), lb) for s, e, lb in got] == expected
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(60) == 0, log.read_text()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert "warming up" in log.read_text() and "SIGTERM" in log.read_text()
