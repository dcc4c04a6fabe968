"""Bundles of the port's artifacts (``segma_tpu_torch/bundle.py``) and their
serving, hot reload included, on the CPU: the counterparts of
``tests/test_bundle.py``, plus ``bundle.json`` written by both packages over
the same artifact manifests, and the JAX package's catalog of its own
artifacts equal to the port's of its own, but for the timestamps.

Two artifacts of one tiny conv_vad with different thresholds ('alert', 0:
every frame fires; 'strict', 1: none does) make the routing visible in the
answers.
"""

from __future__ import annotations

import json
import shutil
import socket
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path
from urllib.parse import urlparse

import numpy as np
import pytest
import torch

import segma_tpu.bundle as jbundle
from segma_tpu_torch import ws
from segma_tpu_torch.bundle import load_bundle, write_bundle_manifest
from segma_tpu_torch.config import load_config
from segma_tpu_torch.export import export_inference
from segma_tpu_torch.models import Models
from segma_tpu_torch.serve import ModelRouter, SegmentationService, bundle_reloader, make_server
from segma_tpu_torch.utils.encoders import MultiLabelEncoder

REPO = Path(__file__).resolve().parent.parent
L16 = "audio/l16;endianness=little"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _make_model(seed: int = 0):
    cfg = load_config(REPO / "segma_tpu_torch/config/default.yml", [
        "model.name=conv_vad", "model.config.hidden=32", "model.config.depth=1",
        "model.config.dtype=f32", "audio.chunk_duration_s=1.0"])
    return Models["conv_vad"](MultiLabelEncoder(cfg.data.classes), cfg, device="cpu",
                              generator=torch.Generator().manual_seed(seed))


def _export(model, out: Path, lower: float, version=None, stream_batches=(2,)) -> Path:
    labels = model.label_encoder.base_labels
    return export_inference(
        model, out, thresholds={lb: {"lower_bound": lower, "upper_bound": 1.0} for lb in labels},
        buckets=(2,), batch_size=2, transport="int16", platforms=("cpu",),
        stream_batches=stream_batches, model_version=version,
    )


@pytest.fixture(scope="module")
def model():
    return _make_model(0)


@pytest.fixture(scope="module")
def bundle_dir(model, tmp_path_factory) -> Path:
    root = tmp_path_factory.mktemp("bundle")
    _export(model, root / "alert", 0.0, version="v1.2.0")
    _export(model, root / "strict", 1.0)
    write_bundle_manifest(root, default="alert")
    return root


def _serve(router) -> tuple[str, object]:
    srv = make_server(router, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{srv.server_address[1]}", srv


@pytest.fixture(scope="module")
def bundle_server(bundle_dir):
    manifest, pipelines = load_bundle(bundle_dir, device="cpu")
    shared = threading.Lock()
    services = {name: SegmentationService(pipe, device_lock=shared)
                for name, pipe in pipelines.items()}
    url, srv = _serve(ModelRouter(services, manifest["default"]))
    yield url, services
    srv.shutdown()


def _get(url: str):
    with urllib.request.urlopen(url, timeout=60) as resp:
        return resp.status, resp.read()


def _post(url: str, body: bytes, ctype: str = "application/octet-stream"):
    req = urllib.request.Request(url, data=body, method="POST")
    req.add_header("Content-Type", ctype)
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, resp.read()


def _pcm_body() -> bytes:
    return (np.random.default_rng(3).standard_normal(16_000) * 8000).astype("<i2").tobytes()


# -- manifest ------------------------------------------------------------------


def test_bundle_manifest_catalog(bundle_dir):
    manifest = json.loads((bundle_dir / "bundle.json").read_text())
    assert manifest["format_version"] == 1 and manifest["default"] == "alert"
    assert set(manifest["models"]) == {"alert", "strict"}
    alert = manifest["models"]["alert"]
    assert alert["model_name"] == "conv_vad" and alert["model_version"] == "v1.2.0"
    assert alert["created_at"] and alert["path"] == "alert"
    assert manifest["models"]["strict"]["model_version"] is None


def test_ambiguous_default_rejected(bundle_dir, tmp_path):
    root = tmp_path / "no_default"
    shutil.copytree(bundle_dir, root)
    (root / "bundle.json").unlink()
    with pytest.raises(ValueError, match="pick the default"):
        write_bundle_manifest(root)
    write_bundle_manifest(root, default="strict")
    assert json.loads(write_bundle_manifest(root).read_text())["default"] == "strict"


def test_unknown_default_rejected(bundle_dir):
    with pytest.raises(KeyError, match="nope"):
        write_bundle_manifest(bundle_dir, default="nope")


def test_load_bundle_without_manifest(bundle_dir, tmp_path):
    root = tmp_path / "bare"
    shutil.copytree(bundle_dir, root)
    (root / "bundle.json").unlink()
    manifest, pipelines = load_bundle(root, default="strict", device="cpu")
    assert manifest["default"] == "strict" and set(pipelines) == {"alert", "strict"}


def test_newer_bundle_format_rejected(bundle_dir, tmp_path):
    root = tmp_path / "future"
    shutil.copytree(bundle_dir, root)
    manifest = json.loads((root / "bundle.json").read_text())
    manifest["format_version"] = 99
    (root / "bundle.json").write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="newer"):
        load_bundle(root, device="cpu")


def test_empty_bundle_dir_rejected(tmp_path):
    with pytest.raises(FileNotFoundError):
        write_bundle_manifest(tmp_path)


def test_bundle_json_equals_jax_s(bundle_dir, tmp_path):
    """Both packages' writers over the same manifests write the same file;
    a re-scan keeps the election in both."""
    root = tmp_path / "both"
    shutil.copytree(bundle_dir, root)
    port = write_bundle_manifest(root, default="strict").read_text()
    assert jbundle.write_bundle_manifest(root).read_text() == port
    assert json.loads(port)["default"] == "strict"


def test_jax_catalog_of_its_artifacts_equals_the_port_s(model, tmp_path):
    """The JAX package's bundle of its own conv_vad artifacts against the
    port's of its own (same names, versions, thresholds): equal catalogs but
    for the timestamps."""
    import jax

    import segma_tpu.export as jexport
    from segma_tpu.config import load_config as jax_load_config
    from segma_tpu.models import Models as JaxModels
    from segma_tpu.utils.encoders import MultiLabelEncoder as JaxEncoder

    jcfg = jax_load_config(REPO / "segma_tpu/config/default.yml", [
        "model.name=conv_vad", "model.config={hidden: 32, depth: 1, dtype: f32}",
        "audio.chunk_duration_s=1.0"])
    jmodel = JaxModels["conv_vad"](JaxEncoder(jcfg.data.classes), jcfg)
    jmodel.init_params(jax.random.key(0))
    for side in ("jax", "torch"):
        for name, lower, version in (("alert", 0.0, "v1"), ("strict", 1.0, None)):
            labels = model.label_encoder.base_labels
            thr = {lb: {"lower_bound": lower, "upper_bound": 1.0} for lb in labels}
            if side == "jax":
                jexport.export_inference(jmodel, tmp_path / side / name, thresholds=thr,
                                         buckets=(2,), batch_size=2, platforms=("cpu",),
                                         stream_batches=(), model_version=version)
            else:
                _export(model, tmp_path / side / name, lower, version, stream_batches=())
    ref = json.loads(jbundle.write_bundle_manifest(tmp_path / "jax", default="alert").read_text())
    got = json.loads(write_bundle_manifest(tmp_path / "torch", default="alert").read_text())
    for catalog in (ref, got):
        for entry in catalog["models"].values():
            assert entry.pop("created_at")
    assert got == ref


# -- serving -------------------------------------------------------------------


def test_models_endpoint(bundle_server):
    url, _ = bundle_server
    payload = json.loads(_get(f"{url}/v1/models")[1])
    assert payload["default"] == "alert" and set(payload["models"]) == {"alert", "strict"}
    alert = payload["models"]["alert"]
    assert alert["model_version"] == "v1.2.0" and alert["streaming"] is True
    assert isinstance(alert["labels"], list) and alert["labels"] and alert["created_at"]


def test_segment_routes_by_model(bundle_server):
    url, _ = bundle_server
    body = _pcm_body()
    default, alert, strict = (
        json.loads(_post(f"{url}/v1/segment{q}", body, L16)[1])["intervals"]
        for q in ("", "?model=alert", "?model=strict"))
    assert default == alert and alert
    assert strict == []


def test_unknown_model_is_404(bundle_server):
    url, _ = bundle_server
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(f"{url}/v1/segment?model=nope", _pcm_body(), "audio/l16")
    assert e.value.code == 404 and "nope" in json.loads(e.value.read())["error"]


def test_healthz_lists_models(bundle_server):
    url, _ = bundle_server
    payload = json.loads(_get(f"{url}/healthz")[1])
    assert payload["models"] == ["alert", "strict"] and payload["default"] == "alert"


def test_metrics_per_model_series(bundle_server):
    url, _ = bundle_server
    _post(f"{url}/v1/segment?model=strict", _pcm_body(), "audio/l16")
    text = _get(f"{url}/metrics")[1].decode()
    assert 'segma_requests_total{model="alert"}' in text
    assert 'segma_requests_total{model="strict"}' in text
    assert text.count("# TYPE segma_requests_total counter") == 1


def test_stream_session_over_artifact_bundle(bundle_server):
    url, _ = bundle_server
    sid = json.loads(_post(f"{url}/v1/stream/start?model=alert", b"")[1])["session"]
    pcm = (np.zeros(20_000) + 0.1 * 32767).astype("<i2").tobytes()
    _post(f"{url}/v1/stream/{sid}/push", pcm, L16)
    assert json.loads(_post(f"{url}/v1/stream/{sid}/flush", b"")[1])["intervals"]


def test_bundle_cli_writes_manifest(bundle_dir, capsys):
    from segma_tpu_torch.cli.bundle import main

    main([str(bundle_dir)])
    out = capsys.readouterr().out
    assert "default: alert" in out and "v1.2.0" in out
    assert json.loads((bundle_dir / "bundle.json").read_text())["default"] == "alert"


def _ws_handshake(url: str, path: str):
    u = urlparse(url)
    sock = socket.create_connection((u.hostname, u.port), timeout=30)
    f = sock.makefile("rwb")
    f.write(f"GET {path} HTTP/1.1\r\nHost: {u.hostname}:{u.port}\r\n".encode()
            + b"Upgrade: websocket\r\nConnection: Upgrade\r\n"
            b"Sec-WebSocket-Key: dGhlIHNhbXBsZSBub25jZQ==\r\nSec-WebSocket-Version: 13\r\n\r\n")
    f.flush()
    return sock, f, f.readline()


def test_ws_streaming_over_bundle_with_model_param(bundle_server):
    url, _ = bundle_server
    sock, f, status = _ws_handshake(url, "/v1/stream/ws?model=alert")
    try:
        assert b"101" in status
        while f.readline() not in (b"\r\n", b""):
            pass
        pcm = (np.zeros(20_000) + 0.1 * 32767).astype("<i2").tobytes()
        f.write(ws.mask_frame(ws.OP_BINARY, pcm))
        f.flush()
        assert ws.read_frame(f, require_mask=False)[0] == ws.OP_TEXT
        f.write(ws.mask_frame(ws.OP_TEXT, b"flush"))
        f.flush()
        op, payload = ws.read_frame(f, require_mask=False)
        assert op == ws.OP_TEXT and json.loads(payload)["intervals"]
        assert ws.read_frame(f, require_mask=False)[0] == ws.OP_CLOSE
    finally:
        sock.close()


def test_ws_unknown_model_is_404(bundle_server):
    url, _ = bundle_server
    sock, _f, status = _ws_handshake(url, "/v1/stream/ws?model=nope")
    sock.close()
    assert b"404" in status


# -- hot reload ------------------------------------------------------------------


@pytest.fixture()
def reloadable_server(model, tmp_path):
    """A live bundle server over a bundle directory that the test changes."""
    root = tmp_path / "bundle"
    root.mkdir()
    _export(model, root / "alert", 0.0, version="v1")
    write_bundle_manifest(root, default="alert")
    rescan = bundle_reloader(root, device="cpu")
    services, default, report = rescan({})
    assert report["added"] == ["alert"] and report["kept"] == []
    router = ModelRouter(services, default, reloader=rescan)
    url, srv = _serve(router)
    yield url, router, root
    srv.shutdown()


def test_admin_reload_adds_removes_and_drains(model, reloadable_server):
    """A new artifact routes without a restart, an unchanged one keeps its
    service, a removed one 404s for new requests, and a session opened
    before the reload drains on its service."""
    url, router, root = reloadable_server
    body = _pcm_body()
    sid = json.loads(_post(f"{url}/v1/stream/start?model=alert", b"")[1])["session"]
    old_service = router.get("alert")

    _export(model, root / "strict", 1.0)
    write_bundle_manifest(root)  # keeps the 'alert' election
    status, raw = _post(f"{url}/admin/reload", b"")
    report = json.loads(raw)
    assert status == 200 and report["added"] == ["strict"]
    assert report["kept"] == ["alert"] and report["default"] == "alert"
    assert router.get("alert") is old_service
    status, raw = _post(f"{url}/v1/segment?model=strict", body, L16)
    assert status == 200 and json.loads(raw)["intervals"] == []
    assert set(json.loads(_get(f"{url}/v1/models")[1])["models"]) == {"alert", "strict"}

    shutil.rmtree(root / "strict")
    (root / "bundle.json").unlink()
    write_bundle_manifest(root)
    assert json.loads(_post(f"{url}/admin/reload", b"")[1])["removed"] == ["strict"]
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(f"{url}/v1/segment?model=strict", body, L16)
    assert e.value.code == 404

    _post(f"{url}/v1/stream/{sid}/push", body, L16)
    assert json.loads(_post(f"{url}/v1/stream/{sid}/flush", b"")[1])["intervals"]


def test_admin_reload_replaces_reexported_artifact(model, reloadable_server):
    """A re-export in place (a new created_at) gets a new service; a session
    opened before drains on the retired one, a new one lands on the new."""
    url, router, root = reloadable_server
    old_sid = json.loads(_post(f"{url}/v1/stream/start", b"")[1])["session"]
    old_service = router.get("alert")
    time.sleep(1.1)  # created_at has a resolution of 1 s
    _export(model, root / "alert", 0.0, version="v2")
    report = json.loads(_post(f"{url}/admin/reload", b"")[1])
    assert report["replaced"] == ["alert"] and report["kept"] == []
    assert router.get("alert") is not old_service and old_service in router._retired
    assert json.loads(_get(f"{url}/v1/models")[1])["models"]["alert"]["model_version"] == "v2"
    _post(f"{url}/v1/stream/{old_sid}/push", _pcm_body(), L16)
    assert json.loads(_post(f"{url}/v1/stream/{old_sid}/flush", b"")[1])["intervals"]
    new_sid = json.loads(_post(f"{url}/v1/stream/start", b"")[1])["session"]
    assert new_sid in router.get("alert")._streams
    _post(f"{url}/admin/reload", b"")
    assert old_service not in router._retired


def test_admin_reload_rejected_without_bundle(reloadable_server):
    """A router without a reloader (single-model serving) answers 409."""
    _, router, _ = reloadable_server
    url, srv = _serve(ModelRouter.single(router.get("alert")))
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"{url}/admin/reload", b"")
        assert e.value.code == 409
    finally:
        srv.shutdown()


def test_admin_reload_failure_keeps_old_routing(reloadable_server):
    """A torn artifact makes the reload answer 500 and leaves the routing
    table as it was; once repaired, the reload works again."""
    url, router, root = reloadable_server
    before = dict(router.services)
    mf = root / "alert" / "manifest.json"
    orig = mf.read_text()
    mf.write_text("{ torn json")
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(f"{url}/admin/reload", b"")
    assert e.value.code == 500
    assert router.services == before and router.default == "alert"
    assert _post(f"{url}/v1/segment", _pcm_body(), L16)[0] == 200
    mf.write_text(orig)
    status, raw = _post(f"{url}/admin/reload", b"")
    assert status == 200 and json.loads(raw)["kept"] == ["alert"]


def test_reload_prunes_abandoned_sessions_on_retired_services(
    model, reloadable_server, monkeypatch
):
    """An abandoned session must not pin a retired service for ever: the
    reload evicts sessions past the TTL before deciding what to keep."""
    url, router, root = reloadable_server
    _post(f"{url}/v1/stream/start", b"")
    old_service = router.get("alert")
    time.sleep(1.1)
    _export(model, root / "alert", 0.0, version="v2")
    _post(f"{url}/admin/reload", b"")
    assert old_service in router._retired
    monkeypatch.setattr(type(old_service), "STREAM_TTL_S", 0.0)
    _post(f"{url}/admin/reload", b"")
    assert old_service not in router._retired


def test_reload_under_traffic_soak(model, reloadable_server):
    """One-shot requests and whole streaming sessions from several threads
    while the artifact is re-exported and reloaded three times: every
    request succeeds, and one live service remains."""
    url, router, root = reloadable_server
    body = _pcm_body()
    stop = threading.Event()
    errors: list = []
    ok = {"segment": 0, "stream": 0}

    def segment_traffic():
        while not stop.is_set():
            try:
                status, raw = _post(f"{url}/v1/segment", body, L16)
                assert status == 200 and json.loads(raw)["intervals"]
                ok["segment"] += 1
            except Exception as e:  # noqa: BLE001 — collected, failed at the end
                errors.append(e)

    def stream_traffic():
        while not stop.is_set():
            try:
                sid = json.loads(_post(f"{url}/v1/stream/start", b"")[1])["session"]
                _post(f"{url}/v1/stream/{sid}/push", body, L16)
                _post(f"{url}/v1/stream/{sid}/flush", b"")
                ok["stream"] += 1
            except Exception as e:  # noqa: BLE001 — collected, failed at the end
                errors.append(e)

    threads = [threading.Thread(target=segment_traffic) for _ in range(3)]
    threads += [threading.Thread(target=stream_traffic) for _ in range(2)]
    for t in threads:
        t.start()
    try:
        for i in range(3):
            time.sleep(1.1)  # a new created_at
            _export(model, root / "alert", 0.0, version=f"soak{i}")
            status, raw = _post(f"{url}/admin/reload", b"")
            assert status == 200 and json.loads(raw)["replaced"] == ["alert"]
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
    assert not errors, errors[:3]
    assert ok["segment"] > 10 and ok["stream"] > 3, ok
    assert set(router.services) == {"alert"}


def test_serve_cli_bundle_in_a_child(bundle_dir, tmp_path):
    """``python -m segma_tpu_torch.cli.serve --bundle --default-model`` on
    the CPU: the election is overridden, both models answer."""
    import os
    import signal
    import subprocess
    import sys

    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "segma_tpu_torch.cli.serve", "--bundle", str(bundle_dir),
         "--default-model", "strict", "--port", str(port), "--device", "cpu"],
        cwd=REPO, env={**os.environ, "PYTHONPATH": str(REPO)},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        url = f"http://127.0.0.1:{port}"
        deadline = time.monotonic() + 120
        while True:
            try:
                payload = json.loads(_get(f"{url}/v1/models")[1])
                break
            except OSError:
                assert proc.poll() is None and time.monotonic() < deadline, proc.stdout.read()
                time.sleep(0.5)
        assert payload["default"] == "strict"
        assert json.loads(_post(f"{url}/v1/segment", _pcm_body(), L16)[1])["intervals"] == []
        assert json.loads(_post(f"{url}/v1/segment?model=alert", _pcm_body(), L16)[1])[
            "intervals"]
        assert json.loads(_post(f"{url}/admin/reload", b"")[1])["kept"] == ["alert", "strict"]
    finally:
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
