"""The port's camera client, fault transport and live app over the port's
server (a deterministic engine, `device="cpu"`), on real HTTP at
127.0.0.1:0. The client speaks HTTP through the standard library."""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from facerecognitionpipeline_tpu_torch.gallery.manager import GalleryManager
from facerecognitionpipeline_tpu_torch.serve import client as tclient
from facerecognitionpipeline_tpu_torch.serve import server as tserver
from facerecognitionpipeline_tpu_torch.serve.client import (
    FaceRecognitionClient,
    HTTPSession,
    synthetic_frames,
)
from facerecognitionpipeline_tpu_torch.serve.live import LiveFaceRecognition
from facerecognitionpipeline_tpu_torch.telemetry.faults import (
    FaultPlan,
    FaultyClientTransport,
)

DET = (160, 160)


class FakeEngine:
    """Every frame holds student 0's face at a fixed place."""

    device = torch.device("cpu")

    def __init__(self, input_format="rgb"):
        self.input_format = input_format
        self.shapes = []

    def host_frame_shape(self, h, w):
        return (h * 3 // 2, w) if self.input_format == "i420" else (h, w, 3)

    def process_frames(self, frames, templates, valid, gallery_k=3, rotation=0):
        b, f, k = frames.shape[0], 4, gallery_k
        self.shapes.append(tuple(frames.shape))
        z = torch.zeros
        out = {
            "bboxes": z(b, f, 4), "det_scores": z(b, f), "landmarks": z(b, f, 5, 2),
            "face_valid": z(b, f, dtype=torch.bool), "quality_ok": z(b, f, dtype=torch.bool),
            "quality_metrics": {"blur_score": torch.full((b, f), 300.0),
                                "det_score": z(b, f)},
            "aligned": torch.full((b, f, 112, 112, 3), 90.0), "embeddings": z(b, f, 512),
            "embedding_norms": torch.ones(b, f), "match_scores": z(b, f, k),
            "match_idx": z(b, f, k, dtype=torch.int64),
        }
        out["bboxes"][:, 0] = torch.tensor([40.0, 40.0, 100.0, 100.0])
        out["det_scores"][:, 0] = 0.95
        out["face_valid"][:, 0] = True
        out["quality_ok"][:, 0] = True
        out["match_scores"][:, 0] = torch.tensor([0.92, 0.3, 0.1][:k])
        out["match_idx"][:, 0] = torch.tensor([0, 1, 2][:k])
        return out


@pytest.fixture
def served(tmp_path, request):
    kw = getattr(request, "param", {})
    gallery = GalleryManager(str(tmp_path / "g.pkl"), verbose=False, device="cpu")
    rng = np.random.default_rng(0)
    for i in range(3):
        gallery.add_student(f"STU{i:04d}", f"Student {i}",
                            rng.normal(size=(2, 512)).astype(np.float32))
    engine = FakeEngine(kw.get("transport", "rgb"))
    srv = tserver.FaceRecognitionServer(
        gallery=gallery, output_dir=str(tmp_path / "sessions"), engine=engine,
        det_size=DET, batch_max=4, batch_wait_ms=1.0, **kw,
    )
    httpd = tserver.serve(srv, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield srv, f"http://127.0.0.1:{httpd.server_address[1]}", tmp_path
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.shutdown()
        thread.join(timeout=10)


def _client(url, tmp_path, **kw):
    return FaceRecognitionClient(
        server_url=url, synthetic=True, frame_skip=2, max_frames=8, display=False,
        output_dir=str(tmp_path / "client"), det_size=DET, **kw,
    )


@pytest.mark.parametrize("image_format", ["png", "jpeg", "raw", "raw-i420"])
def test_client_run_over_every_transport(served, image_format):
    srv, url, tmp_path = served
    c = _client(url, tmp_path, session_name="run", image_format=image_format)
    assert c.run() == 0
    assert c.frame_count == 8 and c.recognized_tracks["1"]["student_id"] == "STU0000"
    session = tmp_path / "sessions" / "run"
    with open(session / "attendance.json") as f:
        assert [s["student_id"] for s in json.load(f)["recognized"]] == ["STU0000"]
    with open(session / "session.json") as f:
        assert json.load(f)["status"] == "completed"
    with open(session / "performance_report_client.json") as f:
        report = json.load(f)
    assert report["frame_statistics"]["total_network_requests"] == 4
    assert report["frame_statistics"]["total_frames_processed"] == 8
    # the engine saw det-size canvases, one frame per step
    assert set(srv.engine.shapes[2:]) == {(1, 160, 160, 3)}
    # a 480x640 synthetic frame letterboxes by 0.25: boxes come back in
    # the client's coordinates
    np.testing.assert_allclose(c.tracks[0]["bbox"], [160, 160, 400, 400])


@pytest.mark.parametrize("served", [{"transport": "i420"}], indirect=True)
@pytest.mark.parametrize("image_format", ["png", "raw", "raw-i420"])
def test_client_against_an_i420_server(served, image_format):
    srv, url, tmp_path = served
    c = _client(url, tmp_path, session_name="yuv", image_format=image_format)
    assert c.run() == 0 and "1" in c.recognized_tracks
    assert set(srv.engine.shapes[2:]) == {(1, 240, 160)}


def test_client_reports_an_unreachable_server(tmp_path, capsys):
    c = _client("http://127.0.0.1:9", tmp_path, session_name="x")
    assert c.check_server() is False and c.run() == 1
    assert "health check failed" in capsys.readouterr().out


def test_client_survives_a_faulty_transport(served):
    srv, url, tmp_path = served
    c = _client(url, tmp_path, session_name="faulty")
    c.frame_skip, c.max_frames = 1, 24
    plan = FaultPlan(drop_rate=0.25, corrupt_rate=0.25, seed=3)
    c._session = FaultyClientTransport(c._session, plan)
    assert c.run() == 0
    stats = plan.stats()
    assert stats["dropped"] >= 2 and stats["corrupted"] >= 2
    # dropped and corrupted frames cost their request only
    assert c.perf_monitor.total_network_requests == 24 - stats["dropped"] - stats["corrupted"]
    assert "1" in c.recognized_tracks
    with open(tmp_path / "sessions" / "faulty" / "session.json") as f:
        assert json.load(f)["status"] == "completed"


def test_snapshots_reach_the_session_directory(served):
    srv, url, tmp_path = served
    c = _client(url, tmp_path, session_name="snap")
    assert c.init_session()
    c.frame_count = 7
    c.save_snapshot(next(synthetic_frames(64, 48)))
    (name,) = os.listdir(tmp_path / "sessions" / "snap" / "snapshots")
    assert name.startswith("snapshot_frame_000007_") and name.endswith(".png")
    import cv2

    assert cv2.imread(str(tmp_path / "sessions" / "snap" / "snapshots" / name)).shape == (48, 64, 3)
    c._session.close()


def test_synthetic_frames_are_deterministic():
    a, b = synthetic_frames(32, 24, seed=5), synthetic_frames(32, 24, seed=5)
    for _ in range(3):
        np.testing.assert_array_equal(next(a), next(b))
    assert next(a).shape == (24, 32, 3)


# ------------------------------------------------------------- HTTPSession


def test_session_keeps_one_connection_and_reads_errors(served):
    srv, url, _ = served
    http = HTTPSession()
    try:
        r = http.get(f"{url}/health", timeout=5)
        assert r.status_code == 200 and r.json()["status"] == "ok"
        conn = next(iter(http._conns.values()))
        r = http.post(f"{url}/init_session", json={}, timeout=5)
        assert r.status_code == 400 and "session_name is required" in r.text
        assert http.post(f"{url}/nowhere", json={}, timeout=5).status_code == 404
        r = http.post(f"{url}/nowhere", data=b"abc", timeout=5,
                      headers={"Content-Type": "application/octet-stream"})
        assert r.status_code == 400  # the body is read as JSON before the route
        assert http.get(f"{url}/health?x=1", timeout=5).status_code == 404
        assert list(http._conns.values()) == [conn]  # one connection throughout
    finally:
        http.close()
    assert not http._conns


def test_session_reconnects_after_the_server_closed_an_idle_connection(tmp_path):
    """A recycling server reaps idle keep-alive connections; the next
    request goes out once more on a fresh connection."""
    import socket

    lsock = socket.socket()
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(4)
    port = lsock.getsockname()[1]
    served = []

    def one_shot_server():
        # answers one request per connection, then closes it without saying so
        for _ in range(2):
            conn, _ = lsock.accept()
            conn.recv(65536)
            body = b'{"n": %d}' % len(served)
            conn.sendall(b"HTTP/1.1 200 OK\r\nContent-Length: %d\r\n\r\n" % len(body) + body)
            served.append(1)
            conn.close()

    th = threading.Thread(target=one_shot_server, daemon=True)
    th.start()
    http = HTTPSession()
    try:
        assert http.get(f"http://127.0.0.1:{port}/a", timeout=5).json() == {"n": 0}
        time.sleep(0.05)
        assert http.post(f"http://127.0.0.1:{port}/b", json={"x": 1}, timeout=5).json() == {"n": 1}
    finally:
        http.close()
        th.join(timeout=5)
        lsock.close()
    assert not th.is_alive() and len(served) == 2


def test_session_times_out_on_a_silent_server():
    import socket

    lsock = socket.socket()
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(1)
    http = HTTPSession()
    try:
        t0 = time.monotonic()
        with pytest.raises(OSError):
            http.get(f"http://127.0.0.1:{lsock.getsockname()[1]}/", timeout=0.3)
        assert time.monotonic() - t0 < 5
        assert not http._conns  # a failed connection is not kept
    finally:
        http.close()
        lsock.close()


def test_responses_are_not_held_back_by_nagle(served):
    """The server writes headers and body separately; with Nagle's algorithm
    on, every response would wait about 40 ms for the client's delayed ACK."""
    srv, url, _ = served
    http = HTTPSession()
    try:
        times = []
        for _ in range(15):
            t0 = time.perf_counter()
            assert http.get(f"{url}/health", timeout=5).status_code == 200
            times.append(time.perf_counter() - t0)
    finally:
        http.close()
    assert sorted(times)[7] < 0.02, sorted(times)


def test_client_module_needs_neither_torch_nor_cv2_nor_requests(tmp_path):
    import subprocess
    import sys

    code = (
        "import sys\n"
        "import facerecognitionpipeline_tpu_torch.serve.client as c\n"
        "import facerecognitionpipeline_tpu_torch.serve.rawproto\n"
        "bad = [m for m in ('torch', 'cv2', 'requests', 'jax', 'psutil', 'PIL') if m in sys.modules]\n"
        "assert not bad, bad\n"
        "c.FaceRecognitionClient(synthetic=True, display=False, output_dir=sys.argv[1])\n"
        "bad = [m for m in ('torch', 'cv2', 'requests', 'jax') if m in sys.modules]\n"
        "assert not bad, bad\n"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, "-c", code, str(tmp_path / "client")],
        capture_output=True, text=True, timeout=120, cwd=repo,
        env={**os.environ, "PYTHONPATH": repo},
    )
    assert r.returncode == 0, r.stderr[-2000:]


# ---------------------------------------------------------------- live app


def _core(tmp_path, **kw):
    gallery = GalleryManager(str(tmp_path / "g.pkl"), verbose=False, device="cpu")
    gallery.add_student("STU0000", "Student 0",
                        np.random.default_rng(0).normal(size=(2, 512)).astype(np.float32))
    return tserver.FaceRecognitionServer(
        gallery=gallery, output_dir=str(tmp_path / "sessions"), engine=FakeEngine(),
        det_size=DET, batch_max=2, batch_wait_ms=1.0, tracker_mode="live",
        similarity_threshold=0.4, **kw,
    )


def test_live_app_recognizes_and_finalizes(tmp_path):
    app = LiveFaceRecognition(
        core=_core(tmp_path, recognition_interval=2), session_name="live", synthetic=True,
        frame_skip=1, max_frames=6, display=False, auto_snapshot_interval=1e-6,
    )
    assert app.run() == 0
    assert app._last_result["recognized_tracks"]["1"]["student_id"] == "STU0000"
    session = tmp_path / "sessions" / "live"
    with open(session / "session.json") as f:
        doc = json.load(f)
    assert doc["status"] == "completed" and doc["statistics"]["total_frames_processed"] == 6
    with open(session / "attendance.json") as f:
        assert [s["student_id"] for s in json.load(f)["recognized"]] == ["STU0000"]
    assert os.listdir(session / "snapshots")
    assert app.core.tracker.frame_interval_gating


def test_live_frame_skip_composes_with_recognition_interval(tmp_path):
    """interval 30 in captured frames at skip 5 is every 6th processed frame."""
    app = LiveFaceRecognition(
        core=_core(tmp_path, recognition_interval=30), session_name="skip", synthetic=True,
        frame_skip=5, max_frames=30, display=False,
    )
    assert app.core.recognition_interval == 6
    assert app.run() == 0
    assert "1" in app._last_result["recognized_tracks"]


def test_live_app_defaults_to_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LiveFaceRecognition(gallery_path=str(tmp_path / "g.pkl"), output_dir=str(tmp_path))


def test_live_app_builds_the_int8_tier_on_the_cpu(tmp_path):
    """quantize='int8' reaches the core: an int8 detector and embedder
    (calibrated on the synthetic defaults), serving a synthetic frame."""
    app = LiveFaceRecognition(
        gallery_path=str(tmp_path / "g.pkl"), output_dir=str(tmp_path), architecture="ir_micro",
        quantize="int8", device="cpu", synthetic=True, frame_skip=1, max_frames=1,
        display=False,
    )
    try:
        engine = app.core.engine
        assert engine.detector.quantized and engine.embedder.quantized
        assert engine.embedder.model.stage0_unit0.res_conv1.kernel_q.dtype == torch.int8
        assert app.run() == 0
    finally:
        app.core.shutdown()


@pytest.mark.parametrize("module,flags", [
    ("client", {"--server", "--image_format", "--det_size", "--synthetic", "--no_display"}),
    ("live", {"--device", "--gallery_path", "--frame_skip", "--embed_budget"}),
])
def test_cli_parsers_keep_the_reference_flags(module, flags):
    import importlib

    j = importlib.import_module(f"facerecognitionpipeline_tpu.serve.{module}")
    t = importlib.import_module(f"facerecognitionpipeline_tpu_torch.serve.{module}")

    def names(p):
        return {o for a in p._actions for o in a.option_strings}

    extra = {"--device"} if module == "live" else set()
    assert names(t.build_parser()) == names(j.build_parser()) | extra
    assert flags <= names(t.build_parser())


@pytest.mark.parametrize("tool", ["server", "client", "live"])
def test_cli_modules_expose_main(tool):
    import importlib

    cli = importlib.import_module(
        f"facerecognitionpipeline_tpu_torch.cli.face_recognition_{tool}"
    )
    serve_mod = importlib.import_module(f"facerecognitionpipeline_tpu_torch.serve.{tool}")
    assert cli.main is serve_mod.main
    with pytest.raises(SystemExit) as e:
        cli.main(["--help"])
    assert e.value.code == 0


def test_client_main_parses_det_size(monkeypatch):
    seen = {}

    class Stop(Exception):
        pass

    def fake(**kw):
        seen.update(kw)
        raise Stop

    monkeypatch.setattr(tclient, "FaceRecognitionClient", fake)
    with pytest.raises(Stop):
        tclient.main(["--det_size", "320x160", "--image_format", "raw-i420", "--no_display"])
    assert seen["det_size"] == (160, 320) and seen["image_format"] == "raw-i420"
    assert seen["display"] is False
