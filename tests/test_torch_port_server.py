"""The port's HTTP server held against the JAX package's server.

(a) One request script over real HTTP against both servers, each over its
    own fake engine that returns the same seeded outputs: status codes and
    JSON bodies must be equal apart from timings, pids, paths and
    timestamps; so must `attendance.json` and `session.json`.
(b) The slice as a whole: the real small engines (trained synthetic detector
    weights, the same embedder variables on both sides, float32), the same
    rendered scene, both servers over HTTP.
(c) The bounded mid-body wait of the port's `_read_body`.
(d) What the port's server refuses at construction.
(e) The int8 tier: both servers built by their constructors with
    quantize='int8' (and quantize_calib) over the same weights answer one
    request script alike.

Everything runs on the CPU (`device="cpu"`); servers bind 127.0.0.1:0.
"""

import base64
import json
import os
import socket
import threading
import time

import numpy as np
import pytest
import torch

from facerecognitionpipeline_tpu.gallery.manager import GalleryManager as JGallery
from facerecognitionpipeline_tpu.serve import server as jserver
from facerecognitionpipeline_tpu_torch.gallery.manager import GalleryManager as TGallery
from facerecognitionpipeline_tpu_torch.serve import rawproto
from facerecognitionpipeline_tpu_torch.serve import server as tserver
from facerecognitionpipeline_tpu_torch.serve.client import (
    HTTPSession,
    _encode_image_base64,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DET = (160, 160)
FACES = 4


# ------------------------------------------------------------ fake engines


def _fake_outputs(call: int, b: int, k: int) -> dict:
    """Seeded step outputs for dispatch number `call`: slot 0 is student 0 at
    0.92, slot 1 a drifting face whose best match stays below threshold and
    which is outside the embed budget on odd calls."""
    rng = np.random.default_rng(1000 + call)
    f = FACES
    out = {
        "bboxes": np.zeros((b, f, 4), np.float32),
        "det_scores": np.zeros((b, f), np.float32),
        "landmarks": np.zeros((b, f, 5, 2), np.float32),
        "face_valid": np.zeros((b, f), bool),
        "quality_ok": np.zeros((b, f), bool),
        "embedded": np.ones((b, f), bool),
        "quality_metrics": {
            "det_score": np.zeros((b, f), np.float32),
            "face_size": np.full((b, f), 60.0, np.float32),
            "yaw": np.zeros((b, f), np.float32),
            "pitch": np.zeros((b, f), np.float32),
            "roll": np.zeros((b, f), np.float32),
            "blur_score": np.full((b, f), 300.0, np.float32),
        },
        "aligned": rng.uniform(0, 255, (b, f, 112, 112, 3)).astype(np.float32),
        "embeddings": np.zeros((b, f, 512), np.float32),
        "embedding_norms": np.ones((b, f), np.float32),
        "match_scores": np.zeros((b, f, k), np.float32),
        "match_idx": np.zeros((b, f, k), np.int32),
    }
    for i in range(b):
        out["bboxes"][i, 0] = [20, 20, 70, 70]
        out["bboxes"][i, 1] = [90 + call % 7, 80, 140 + call % 7, 130]
        for slot, det in ((0, 0.95), (1, 0.8125)):
            out["det_scores"][i, slot] = det
            out["quality_metrics"]["det_score"][i, slot] = det
            out["face_valid"][i, slot] = True
            out["quality_ok"][i, slot] = True
        out["embedded"][i, 1] = call % 2 == 0
        out["match_scores"][i, 0] = [0.92, 0.3, 0.1][:k]
        out["match_idx"][i, 0] = [0, 1, 2][:k]
        out["match_scores"][i, 1] = [0.3125, 0.25, 0.125][:k]
        out["match_idx"][i, 1] = [2, 1, 0][:k]
    return out


class _FakeEmbedder:
    """Every crop embeds near student 1's template, at a distance that
    depends on the batch: confidences differ by far more than float32
    rounding, so 'keep the best sighting' decides the same way everywhere."""

    def __init__(self, vec):
        self.vec = vec
        noise = np.random.default_rng(11).normal(size=vec.shape)
        noise -= noise.dot(vec) * vec
        self.noise = noise / np.linalg.norm(noise)

    def extract_embeddings_batch(self, faces):
        out = np.stack([
            self.vec + 0.2 * (len(faces) + i) * self.noise for i in range(len(faces))
        ])
        return (out / np.linalg.norm(out, axis=1, keepdims=True)).astype(np.float32)


class JaxFakeEngine:
    def __init__(self, vec, input_format="rgb"):
        self.calls = 0
        self.input_format = input_format
        self.embedder = _FakeEmbedder(vec)

    def host_frame_shape(self, h, w):
        return (h * 3 // 2, w) if self.input_format == "i420" else (h, w, 3)

    def process_frames(self, frames, templates, valid, gallery_k=3):
        self.calls += 1
        return _fake_outputs(self.calls, frames.shape[0], gallery_k)


class TorchFakeEngine(JaxFakeEngine):
    device = torch.device("cpu")

    def process_frames(self, frames, templates, valid, gallery_k=3, rotation=0):
        # a uint8 tensor from the dispatch stage, a numpy batch from warmup
        assert frames.dtype in (torch.uint8, np.uint8)
        self.calls += 1
        out = _fake_outputs(self.calls, frames.shape[0], gallery_k)
        return {
            k: {m: torch.from_numpy(a) for m, a in v.items()}
            if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in out.items()
        }


def _student_embeddings():
    rng = np.random.default_rng(7)
    emb = rng.normal(size=(3, 2, 512)).astype(np.float32)
    return emb / np.linalg.norm(emb, axis=-1, keepdims=True)


class Side:
    """One package's server on a thread, with its own output tree."""

    def __init__(self, which, root, **kw):
        self.which = which
        self.root = str(root)
        emb = _student_embeddings()
        gpath = os.path.join(self.root, "g.pkl")
        fresh = not os.path.exists(gpath)
        if which == "jax":
            self.mod = jserver
            self.gallery = JGallery(gallery_path=gpath, verbose=False)
            engine_cls = JaxFakeEngine
        else:
            self.mod = tserver
            self.gallery = TGallery(gallery_path=gpath, verbose=False, device="cpu")
            engine_cls = TorchFakeEngine
        if fresh:
            for i in range(3):
                self.gallery.add_student(f"STU{i:04d}", f"Student {i}", emb[i])
            self.gallery.save()
        vec = emb[1].mean(0)
        self.engine = engine_cls(vec / np.linalg.norm(vec), kw.pop("engine_format", "rgb"))
        self.srv = self.mod.FaceRecognitionServer(
            gallery=self.gallery,
            similarity_threshold=0.5,
            output_dir=os.path.join(self.root, "sessions"),
            engine=self.engine,
            det_size=DET,
            max_recognition_attempts=2,
            batch_max=4,
            batch_wait_ms=1.0,
            **kw,
        )
        self.httpd = self.mod.serve(self.srv, host="127.0.0.1", port=0)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()
        self.http = HTTPSession()

    def call(self, method, path, **kw):
        if method == "GET":
            r = self.http.get(self.url + path, timeout=30)
        else:
            r = self.http.post(self.url + path, timeout=30, **kw)
        try:
            body = r.json()
        except ValueError:
            body = r.text
        return r.status_code, body

    def close(self):
        self.http.close()
        self.httpd.shutdown()
        self.httpd.server_close()
        self.srv.shutdown()
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()


_DROP = {
    "performance", "pid", "traceback", "timestamp", "first_seen", "last_updated",
    "start_time", "end_time", "duration_seconds", "saved_face_path",
    # /stats: host timings and memory of the run
    "avg_latency_recognition_ms", "avg_latency_network_ms",
    "avg_latency_e2e_server_ms", "current_cpu_ram_mb", "peak_cpu_ram_mb",
}


def _scrub(obj, root):
    """Drop what legitimately differs between two runs (timings, pids,
    clock values) and replace the run's own directory in strings."""
    if isinstance(obj, dict):
        return {k: _scrub(v, root) for k, v in obj.items() if k not in _DROP}
    if isinstance(obj, list):
        return [_scrub(v, root) for v in obj]
    if isinstance(obj, str):
        return obj.replace(root, "<root>")
    return obj


def _assert_same(t, j, where="body"):
    """Equal structure and values; floats within 1e-6 (the legacy route's
    scores come from each package's own float32 gallery matmul; everything
    else is copied from the fake engine's outputs and is exactly equal)."""
    if isinstance(j, dict):
        assert isinstance(t, dict) and t.keys() == j.keys(), (where, t, j)
        for k in j:
            _assert_same(t[k], j[k], f"{where}.{k}")
    elif isinstance(j, list):
        assert isinstance(t, list) and len(t) == len(j), (where, t, j)
        for i, (a, b) in enumerate(zip(t, j)):
            _assert_same(a, b, f"{where}[{i}]")
    elif isinstance(j, float):
        assert isinstance(t, float) and abs(t - j) <= 1e-6, (where, t, j)
    else:
        assert type(t) is type(j) and t == j, (where, t, j)


def _frame(seed=3, h=120, w=160):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


def _raw(fmt, payload=None, **over):
    canvas, scale = rawproto.letterbox_rgb(_frame(), DET)
    if payload is None:
        payload = (
            rawproto.rgb_to_i420(canvas).tobytes() if fmt == "i420"
            else canvas.tobytes()
        )
    headers = {
        "Content-Type": "application/octet-stream",
        rawproto.HEADER_FORMAT: fmt,
        rawproto.HEADER_WIDTH: str(DET[1]),
        rawproto.HEADER_HEIGHT: str(DET[0]),
        rawproto.HEADER_SCALE: repr(scale),
        rawproto.HEADER_COUNT: "7",
        rawproto.HEADER_TIMESTAMP: "2026-01-01T00:00:00",
    }
    headers.update(over)
    return {"data": payload, "headers": headers}


def _png(count, fmt="png"):
    return {"json": {"frame": _encode_image_base64(_frame(), fmt),
                     "frame_count": count,
                     "timestamp": f"2026-01-01T00:00:{count:02d}"}}


# (name, method, path, request, expected status)
MAIN_SCRIPT = [
    ("health_before", "GET", "/health", {}, 200),
    ("frame_before_session", "POST", "/process_frame", _png(0), 400),
    ("raw_before_session", "POST", "/process_frame_raw", _raw("rgb24"), 400),
    ("finalize_before_session", "POST", "/finalize", {"json": {}}, 400),
    ("snapshot_before_session", "POST", "/save_snapshot", {"json": {"snapshot": ""}}, 400),
    ("init_missing_name", "POST", "/init_session", {"json": {}}, 400),
    ("init_traversal_name", "POST", "/init_session",
     {"json": {"session_name": "../escape"}}, 400),
    ("init_hidden_name", "POST", "/init_session",
     {"json": {"session_name": ".hidden/../x"}}, 400),
    ("init", "POST", "/init_session", {"json": {"session_name": "s1"}}, 200),
    ("health_after", "GET", "/health", {}, 200),
    ("stats_empty", "GET", "/stats", {}, 200),
    ("frame_png_1", "POST", "/process_frame", _png(1), 200),
    ("frame_png_2", "POST", "/process_frame", _png(2), 200),
    ("frame_jpeg_3", "POST", "/process_frame", _png(3, "jpeg"), 200),
    ("raw_rgb24", "POST", "/process_frame_raw", _raw("rgb24"), 200),
    ("raw_i420", "POST", "/process_frame_raw", _raw("i420"), 200),
    ("raw_bad_format", "POST", "/process_frame_raw", _raw("bgr"), 400),
    ("raw_short_body", "POST", "/process_frame_raw", _raw("rgb24", b"\x00" * 100), 400),
    ("frame_after_short_body", "POST", "/process_frame", _png(4), 200),
    ("raw_wrong_size", "POST", "/process_frame_raw",
     _raw("rgb24", **{rawproto.HEADER_WIDTH: "320"}), 400),
    ("raw_nan_scale", "POST", "/process_frame_raw",
     _raw("rgb24", **{rawproto.HEADER_SCALE: "nan"}), 400),
    ("raw_zero_scale", "POST", "/process_frame_raw",
     _raw("rgb24", **{rawproto.HEADER_SCALE: "0.0"}), 400),
    ("frame_undecodable", "POST", "/process_frame",
     {"json": {"frame": base64.b64encode(b"not an image").decode()}}, 400),
    ("frame_empty", "POST", "/process_frame", {"json": {"frame": ""}}, 400),
    ("body_not_object", "POST", "/process_frame", {"json": [1, 2]}, 400),
    ("snapshot", "POST", "/save_snapshot",
     {"json": {"snapshot": base64.b64encode(b"pngbytes").decode(),
               "frame_count": 5, "timestamp": "20260101_000000"}}, 200),
    ("snapshot_bad_timestamp", "POST", "/save_snapshot",
     {"json": {"snapshot": "", "frame_count": 5, "timestamp": "../../x"}}, 400),
    ("faces_route_disabled", "POST", "/process_faces", {"json": {"faces": []}}, 404),
    ("unknown_post", "POST", "/nope", {"json": {}}, 404),
    ("unknown_get", "GET", "/nope", {}, 404),
    ("reload_gallery", "POST", "/reload_gallery", {"json": {}}, 200),
    ("reload_gallery_unchanged", "POST", "/reload_gallery", {"json": {}}, 200),
    ("stats_after", "GET", "/stats", {}, 200),
    ("finalize", "POST", "/finalize",
     {"json": {"client_performance_report": {"k": 1}}}, 200),
    ("init_again", "POST", "/init_session", {"json": {"session_name": "s2"}}, 200),
]

_ALIGNED = _encode_image_base64(_frame(9, 112, 112))


def _faces(count, ids):
    return {"json": {
        "faces": [{"track_id": t, "aligned_face_base64": _ALIGNED,
                   "original_crop_base64": _ALIGNED} for t in ids]
        + [{"aligned_face_base64": _ALIGNED},
           {"track_id": 99, "aligned_face_base64": "AAAA"}],
        "frame_count": count, "timestamp": f"2026-01-01T00:01:{count:02d}"}}


LEGACY_SCRIPT = [
    ("faces_before_session", "POST", "/process_faces", _faces(0, [1]), 400),
    ("init", "POST", "/init_session", {"json": {"session_name": "legacy"}}, 200),
    ("faces_1", "POST", "/process_faces", _faces(1, [4, 5]), 200),
    ("faces_2", "POST", "/process_faces", _faces(2, [5, 6]), 200),
    ("frame_png_i420_engine", "POST", "/process_frame", _png(3), 200),
    ("raw_i420_i420_engine", "POST", "/process_frame_raw", _raw("i420"), 200),
    ("raw_rgb24_i420_engine", "POST", "/process_frame_raw", _raw("rgb24"), 200),
    ("finalize", "POST", "/finalize", {"json": {}}, 200),
]


def _run_script(tmp, script, **kw):
    """Both servers through `script`; {step: (jax (status, body), torch
    (status, body))}, plus the artifacts left on disk under 'files'."""
    got = {}
    sides = []
    try:
        for which in ("jax", "torch"):
            sides.append(Side(which, tmp / which, **dict(kw)))
        for name, method, path, req, _ in script:
            answers = []
            for side in sides:
                status, body = side.call(method, path, **req)
                answers.append((status, _scrub(body, side.root)))
            got[name] = tuple(answers)
        files = []
        for side in sides:
            tree = {}
            base = os.path.join(side.root, "sessions")
            for d, _, names in os.walk(base):
                for n in names:
                    rel = os.path.relpath(os.path.join(d, n), base)
                    tree[rel] = os.path.join(d, n)
            files.append((side.root, tree))
        got["files"] = files
        got["calls"] = tuple(s.engine.calls for s in sides)
    finally:
        for side in sides:
            side.close()
    return got


@pytest.fixture(scope="module")
def main_run(tmp_path_factory):
    return _run_script(tmp_path_factory.mktemp("main"), MAIN_SCRIPT)


@pytest.fixture(scope="module")
def legacy_run(tmp_path_factory):
    return _run_script(
        tmp_path_factory.mktemp("legacy"), LEGACY_SCRIPT,
        legacy_faces_route=True, engine_format="i420", transport="i420",
    )


@pytest.mark.parametrize("step", [s[0] for s in MAIN_SCRIPT])
def test_main_script_step_answers_as_the_jax_server(main_run, step):
    expected = {s[0]: s[4] for s in MAIN_SCRIPT}[step]
    (jsc, jbody), (tsc, tbody) = main_run[step]
    assert jsc == expected and tsc == expected, (jsc, tsc, tbody)
    _assert_same(tbody, jbody)


@pytest.mark.parametrize("step", [s[0] for s in LEGACY_SCRIPT])
def test_legacy_and_i420_script_step_answers_as_the_jax_server(legacy_run, step):
    expected = {s[0]: s[4] for s in LEGACY_SCRIPT}[step]
    (jsc, jbody), (tsc, tbody) = legacy_run[step]
    assert jsc == expected and tsc == expected, (jsc, tsc, tbody)
    _assert_same(tbody, jbody)


def test_script_exercises_recognition_failure_and_budget(main_run):
    """The script is only a comparison if it reaches the interesting states."""
    _, (_, body) = main_run["frame_after_short_body"]
    assert body["faces_detected"] == 2
    assert body["recognized_tracks"]["1"]["student_id"] == "STU0000"
    assert body["failed_tracks"] == {"2": True}
    _, (_, first) = main_run["frame_png_1"]
    assert first["newly_recognized"]["1"]["name"] == "Student 0"
    assert first["recognition_attempts"] == {"1": 1}  # slot 1 not embedded yet
    _, (_, reload1) = main_run["reload_gallery"]
    _, (_, reload2) = main_run["reload_gallery_unchanged"]
    assert (reload1["status"], reload2["status"]) == ("reloaded", "unchanged")
    _, (_, stats) = main_run["stats_after"]
    assert stats["total_requests"] == 6 and stats["current_gpu_vram_mb"] == 0
    assert main_run["calls"][0] == main_run["calls"][1]


def test_legacy_script_recognizes_through_the_embedder(legacy_run):
    _, (_, body) = legacy_run["faces_2"]
    assert body["faces_processed"] == 4
    assert {v["student_id"] for v in body["recognized_tracks"].values()} == {"STU0001"}
    assert set(body["recognized_tracks"]) == {"4", "5", "6"}


@pytest.mark.parametrize("artifact", ["session.json", "attendance.json"])
@pytest.mark.parametrize("run,session", [("main", "s1"), ("legacy", "legacy")])
def test_session_artifacts_equal(main_run, legacy_run, run, session, artifact):
    files = (main_run if run == "main" else legacy_run)["files"]
    docs = []
    for root, tree in files:
        with open(tree[os.path.join(session, artifact)]) as f:
            docs.append(_scrub(json.load(f), root))
    _assert_same(docs[1], docs[0])
    if artifact == "attendance.json" and run == "main":
        assert [s["student_id"] for s in docs[1]["recognized"]] == ["STU0000"]
        assert len(docs[1]["unrecognized"]) == 1
    if artifact == "session.json":
        assert docs[1]["status"] == "completed"


def _shape_of_tree(tree):
    """File names with the wall-clock stamp of face crops removed."""
    import re

    return sorted(re.sub(r"_\d{8}_\d{6}_\d{6}_", "_<t>_", rel) for rel in tree)


@pytest.mark.parametrize("run", ["main", "legacy"])
def test_session_directory_trees_equal(main_run, legacy_run, run):
    (_, jtree), (_, ttree) = (main_run if run == "main" else legacy_run)["files"]
    assert _shape_of_tree(ttree) == _shape_of_tree(jtree)
    names = _shape_of_tree(ttree)
    assert any(n.endswith("_aligned.png") for n in names)
    assert any(n.endswith("performance_report_server.json") for n in names)
    if run == "main":
        assert any(n.endswith("performance_report_client.json") for n in names)
        assert any("snapshot_frame_000005_20260101_000000.png" in n for n in names)
        assert any(n.endswith("_original.png") for n in names)


def test_saved_aligned_crops_equal_pixel_for_pixel(main_run):
    """The port writes the crop from a lazy device view; same pixels."""
    import cv2

    (_, jtree), (_, ttree) = main_run["files"]
    pick = lambda tree: sorted(  # noqa: E731
        p for rel, p in tree.items()
        if rel.startswith("s1") and rel.endswith("_aligned.png")
    )
    jp, tp = pick(jtree), pick(ttree)
    assert len(jp) == len(tp) >= 2
    for a, b in zip(jp, tp):
        np.testing.assert_array_equal(cv2.imread(a), cv2.imread(b))


def test_performance_report_schema_equal(main_run):
    (jroot, jtree), (troot, ttree) = main_run["files"]

    def keys(o):
        return {k: keys(v) for k, v in o.items()} if isinstance(o, dict) else None

    docs = []
    for tree in (jtree, ttree):
        with open(tree[os.path.join("s1", "performance_report_server.json")]) as f:
            docs.append(json.load(f))
    assert keys(docs[0]) == keys(docs[1])
    assert docs[0]["session_info"]["model_identifier"] == "ADAFACE_IR_101_TPU"
    assert docs[1]["session_info"]["model_identifier"] == "ADAFACE_IR_101_CUDA"
    assert docs[1]["request_statistics"] == docs[0]["request_statistics"] | {
        "requests_per_second": docs[1]["request_statistics"]["requests_per_second"]
    }
    assert docs[1]["memory_usage"]["gpu_vram"]["available"] is False


# ----------------------------------------------------------------- recycle


def test_recycle_handoff_and_resume_as_the_jax_server(tmp_path):
    """max_requests=3: the third frame writes .recycle_state.json and drains
    the HTTP loop; a second worker resumes the session with its counters."""
    final = []
    for which in ("jax", "torch"):
        side = Side(which, tmp_path / which, max_requests=3)
        try:
            assert side.call("POST", "/init_session", json={"session_name": "r"})[0] == 200
            for i in range(1, 4):
                sc, body = side.call("POST", "/process_frame", **_png(i))
                assert sc == 200
            side.thread.join(timeout=10)
            assert not side.thread.is_alive(), "HTTP loop did not drain"
            assert side.srv._recycle_requested
            state = os.path.join(side.root, "sessions", ".recycle_state.json")
            with open(state) as f:
                assert json.load(f) == {"session_name": "r"}
            assert not os.path.exists(state + ".tmp")
        finally:
            side.close()
        side = Side(which, tmp_path / which)
        try:
            side.srv._create_session("r", resume=True)
            assert side.srv.frame_count == 3
            sc, body = side.call("POST", "/process_frame", **_png(4))
            assert sc == 200
            assert side.call("POST", "/finalize", json={})[0] == 200
            # resume on a finalized session leaves its artifacts alone
            side.srv.session_name = None
            side.srv._create_session("r", resume=True)
            assert side.srv.session_name is None
            with open(os.path.join(side.root, "sessions", "r", "session.json")) as f:
                session = _scrub(json.load(f), side.root)
            with open(os.path.join(side.root, "sessions", "r", "attendance.json")) as f:
                att = _scrub(json.load(f), side.root)
            final.append((_scrub(body, side.root), session, att))
        finally:
            side.close()
    _assert_same(final[1], final[0])
    assert final[1][1]["statistics"]["total_faces_detected"] == 8
    assert [s["student_id"] for s in final[1][2]["recognized"]] == ["STU0000"]


def test_recycle_exit_code_and_supervisor_target():
    assert tserver.RECYCLE_EXIT_CODE == jserver.RECYCLE_EXIT_CODE == 75
    import inspect

    src = inspect.getsource(tserver._supervise)
    assert "facerecognitionpipeline_tpu_torch.cli.face_recognition_server" in src
    assert '"facerecognitionpipeline_tpu.' not in src


# ------------------------------------------------- (c) bounded body waiting


@pytest.fixture
def stall_server(tmp_path):
    side = Side("torch", tmp_path / "torch")
    handler = side.httpd.RequestHandlerClass
    handler.BODY_RECV_TIMEOUT_S = 0.15
    handler.BODY_STALL_TIMEOUTS = 3
    try:
        yield side
    finally:
        side.close()


def _open_post(side, length):
    sock = socket.create_connection(side.httpd.server_address, timeout=10)
    sock.sendall(
        f"POST /init_session HTTP/1.1\r\nHost: x\r\nContent-Type: application/json\r\n"
        f"Content-Length: {length}\r\n\r\n".encode()
    )
    return sock


def test_stalled_client_releases_its_handler_thread(stall_server):
    before = threading.active_count()
    sock = _open_post(stall_server, 1000)
    try:
        sock.sendall(b'{"session_na')
        t0 = time.monotonic()
        # the server must give the connection up by itself: EOF, no response
        assert sock.recv(4096) == b""
        waited = time.monotonic() - t0
    finally:
        sock.close()
    assert 0.3 <= waited < 5.0, waited  # 3 timeouts of 0.15 s, not one, not forever
    deadline = time.monotonic() + 5
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.02)
    assert threading.active_count() <= before
    # and the server still serves
    assert stall_server.call("GET", "/health")[0] == 200


def test_slow_client_that_keeps_sending_is_not_dropped(stall_server):
    """Pauses longer than one recv timeout, but never BODY_STALL_TIMEOUTS in
    a row without progress: the body arrives whole."""
    body = json.dumps({"session_name": "slow"}).encode()
    sock = _open_post(stall_server, len(body))
    try:
        for i in range(0, len(body), 8):
            sock.sendall(body[i:i + 8])
            time.sleep(0.2)
        sock.settimeout(10)
        reply = sock.recv(65536).decode()
    finally:
        sock.close()
    assert reply.startswith("HTTP/1.1 200"), reply
    assert '"session_initialized"' in reply


def test_client_that_closes_mid_body_gets_no_500(stall_server):
    sock = _open_post(stall_server, 1000)
    sock.sendall(b"{")
    sock.close()
    assert stall_server.call("GET", "/health")[0] == 200


# ------------------------------------------------------------ (d) refusals


@pytest.mark.parametrize("kw,what", [
    ({"mesh_data": 2}, None),
    ({"shard_gallery": True}, "shard_gallery"),
], ids=["kw0-multi-GPU", "kw1-multi-GPU"])  # the ids of the refusals these cases were
def test_unported_options_are_refused_at_construction(tmp_path, kw, what):
    """As in the JAX server: mesh_data=2 builds the engine on a 'data' mesh
    (here two CPU entries) whose batcher buckets are multiples of 2, and a
    frame goes through the split step; shard_gallery without a mesh is a
    ValueError."""
    weights = os.path.join(REPO, "pretrained", "mtcnn_dr.npz")
    build = dict(gallery_path=str(tmp_path / "g.pkl"), output_dir=str(tmp_path),
                 architecture="ir_micro", detector_weights=weights, det_size=DET,
                 max_faces=4, batch_max=4, warmup=False, device="cpu", **kw)
    if what is not None:
        with pytest.raises(ValueError, match=what):
            tserver.FaceRecognitionServer(**build)
        return
    srv = tserver.FaceRecognitionServer(**build)
    try:
        assert srv.engine.mesh.shape == {"data": 2, "model": 1}
        assert srv.batcher.bucket_sizes == [4]
        out = srv.batcher.submit(np.zeros((*DET, 3), np.uint8)).result(timeout=120)
        assert out["match_scores"].shape == (4, 3)
    finally:
        srv.batcher.stop()
    with pytest.raises(ValueError, match="multiple"):
        tserver.FaceRecognitionServer(**{**build, "batch_max": 3})


def test_mesh_data_one_is_a_single_device_server(tmp_path):
    side = Side("torch", tmp_path / "torch", mesh_data=1, warmup=False)
    side.close()


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_gallery_quantize_builds_the_servers_own_gallery(tmp_path, quantize):
    """gallery_path + gallery_quantize through the constructor: the server
    loads the file into its own manager, whose compact copy at streaming
    scale is the int8 (codes, scales) pair or bf16 rows."""
    emb = _student_embeddings()
    gpath = str(tmp_path / "g.pkl")
    writer = TGallery(gallery_path=gpath, verbose=False, device="cpu")
    for i in range(3):
        writer.add_student(f"STU{i:04d}", f"Student {i}", emb[i])
    writer.save()
    srv = tserver.FaceRecognitionServer(
        gallery_path=gpath, gallery_quantize=quantize, output_dir=str(tmp_path / "s"),
        engine=TorchFakeEngine(emb[1].mean(0)), det_size=DET, warmup=False, device="cpu",
    )
    try:
        assert srv.gallery is not writer and srv.gallery.gallery_path == gpath
        assert sorted(srv.gallery.students) == sorted(writer.students)
        srv.gallery._device.streaming_threshold = 2  # 3 students stream
        srv.gallery._dirty = True
        templates, valid, ids = srv.gallery.device_snapshot()
        assert ids == list(writer.students) and int(valid.sum()) == 3
        if quantize == "int8":
            codes, scales = templates
            assert codes.dtype == torch.int8 and scales.shape == (codes.shape[0],)
        else:
            assert templates.dtype == torch.bfloat16
    finally:
        srv.shutdown()


def test_server_defaults_to_cuda_and_raises_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserver.FaceRecognitionServer(
            gallery_path=str(tmp_path / "g.pkl"), output_dir=str(tmp_path)
        )
    args = tserver.build_parser().parse_args([])
    assert args.device == "cuda"


def test_transport_mismatch_and_tracker_mode_are_validated(tmp_path):
    for kw, match in (({"transport": "i420"}, "input_format"),
                      ({"tracker_mode": "nope"}, "tracker_mode")):
        with pytest.raises(ValueError, match=match):
            Side("torch", tmp_path / "torch", **kw)


@pytest.mark.parametrize("argv,device", [
    ([], "cuda"), (["--use_cpu"], "cpu"), (["--device", "cpu"], "cpu"),
    (["--use_gpu"], "cuda"), (["--gallery_quantize", "int8", "--use_cpu"], "cpu"),
])
def test_cli_device_flags(monkeypatch, argv, device):
    seen = {}

    class Stop(Exception):
        pass

    def fake_server(**kw):
        seen.update(kw)
        raise Stop

    monkeypatch.setattr(tserver, "FaceRecognitionServer", fake_server)
    with pytest.raises(Stop):
        tserver.main(argv)
    assert seen["device"] == device
    assert seen["transport"] == "rgb" and seen["batch_max"] == 8
    assert seen["gallery_quantize"] == ("int8" if "--gallery_quantize" in argv else None)


def test_cli_parser_has_the_reference_flags():
    def flags(p):
        return {o for a in p._actions for o in a.option_strings}

    assert flags(jserver.build_parser()) | {"--device"} == flags(tserver.build_parser())


# ------------------------------------------------ (b) the slice as a whole

WEIGHTS = os.path.join(REPO, "pretrained", "mtcnn_synthetic.npz")


def _real_engines():
    from facerecognitionpipeline_tpu.models.detector import MTCNNDetector as JDet
    from facerecognitionpipeline_tpu.ops.quality import QualityConfig as JQ
    from facerecognitionpipeline_tpu.pipeline.embedder import FaceEmbedder as JEmb
    from facerecognitionpipeline_tpu.pipeline.engine import RecognitionEngine as JEng
    from facerecognitionpipeline_tpu_torch.models.detector import MTCNNDetector as TDet
    from facerecognitionpipeline_tpu_torch.ops.quality import QualityConfig as TQ
    from facerecognitionpipeline_tpu_torch.pipeline.embedder import FaceEmbedder as TEmb
    from facerecognitionpipeline_tpu_torch.pipeline.engine import RecognitionEngine as TEng

    quality = dict(min_det_score=0.5, min_face_size=15, max_yaw=90, max_pitch=90,
                   max_roll=90, check_blur=False)
    det_kw = dict(det_size=DET, max_faces=FACES, min_face_size=20,
                  weights_path=WEIGHTS, stage_thresholds=(0.6, 0.6, 0.5))
    jemb = JEmb(architecture="ir_micro", random_ok=True)
    variables = {"params": _to_numpy_tree(jemb.variables["params"])}
    temb = TEmb(architecture="ir_micro", variables=variables, device="cpu")
    jeng = JEng(JDet(**det_kw), jemb, quality_config=JQ(**quality), top_k=3)
    teng = TEng(TDet(device="cpu", **det_kw), temb, quality_config=TQ(**quality), top_k=3)
    return jeng, teng, jemb


def _to_numpy_tree(tree):
    if hasattr(tree, "items"):
        return {k: _to_numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


@pytest.fixture(scope="module")
def real_run(tmp_path_factory):
    """Both real servers over one rendered scene: three transports each."""
    from facerecognitionpipeline_tpu.pipeline.processor import FaceProcessor
    from facerecognitionpipeline_tpu.train.detector_train import (
        make_identity,
        render_identity_scene,
    )

    tmp = tmp_path_factory.mktemp("real")
    jeng, teng, jemb = _real_engines()
    scene, boxes, _, _ = render_identity_scene(
        [make_identity(3)], np.random.default_rng(4), size=160
    )
    faces = FaceProcessor(
        output_size=112, detector=jeng.detector,
        quality_filter_config={"min_det_score": 0.5, "min_face_size": 10,
                               "max_yaw": 90, "max_pitch": 90, "max_roll": 90,
                               "check_blur": False},
    ).process_numpy(scene, return_all=True)
    assert faces
    enrolled = np.asarray(jemb.extract_embeddings_batch([faces[0]["aligned_face"]]))
    others = np.random.default_rng(5).normal(size=(2, 512)).astype(np.float32)

    out = {}
    for which, engine in (("jax", jeng), ("torch", teng)):
        if which == "jax":
            gallery = JGallery(gallery_path=str(tmp / which / "g.pkl"), verbose=False)
            mod = jserver
        else:
            gallery = TGallery(gallery_path=str(tmp / which / "g.pkl"),
                               verbose=False, device="cpu")
            mod = tserver
        gallery.add_student("OTHER1", "Other 1", others[0])
        gallery.add_student("SYN0003", "Identity 3", enrolled)
        gallery.add_student("OTHER2", "Other 2", others[1])
        srv = mod.FaceRecognitionServer(
            gallery=gallery, similarity_threshold=0.8,
            output_dir=str(tmp / which / "sessions"), engine=engine,
            det_size=DET, max_recognition_attempts=3, batch_max=2,
            batch_wait_ms=1.0,
        )
        httpd = mod.serve(srv, host="127.0.0.1", port=0)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        http = HTTPSession()
        try:
            r = http.post(f"{url}/init_session", json={"session_name": "real"}, timeout=30)
            assert r.status_code == 200
            canvas, scale = rawproto.letterbox_rgb(scene, DET)
            bodies = {}
            for name, path, req in (
                ("png", "/process_frame",
                 {"json": {"frame": _encode_image_base64(scene), "frame_count": 1}}),
                ("rgb24", "/process_frame_raw", {
                    "data": canvas.tobytes(),
                    "headers": {rawproto.HEADER_FORMAT: "rgb24",
                                rawproto.HEADER_WIDTH: "160",
                                rawproto.HEADER_HEIGHT: "160",
                                rawproto.HEADER_SCALE: repr(scale),
                                rawproto.HEADER_COUNT: "2"}}),
                ("i420", "/process_frame_raw", {
                    "data": rawproto.rgb_to_i420(canvas).tobytes(),
                    "headers": {rawproto.HEADER_FORMAT: "i420",
                                rawproto.HEADER_WIDTH: "160",
                                rawproto.HEADER_HEIGHT: "160",
                                rawproto.HEADER_SCALE: repr(scale),
                                rawproto.HEADER_COUNT: "3"}}),
            ):
                r = http.post(url + path, timeout=300, **req)
                assert r.status_code == 200, r.text[:300]
                bodies[name] = r.json()
            r = http.post(f"{url}/finalize", json={}, timeout=30)
            assert r.status_code == 200
            with open(tmp / which / "sessions" / "real" / "attendance.json") as f:
                bodies["attendance"] = json.load(f)
            out[which] = bodies
        finally:
            http.close()
            httpd.shutdown()
            httpd.server_close()
            srv.shutdown()
            thread.join(timeout=10)
    return out


@pytest.mark.skipif(not os.path.exists(WEIGHTS), reason="trained detector weights not present")
@pytest.mark.parametrize("transport", ["png", "rgb24", "i420"])
def test_real_engine_servers_agree(real_run, transport):
    """Same detections within 1 px, same student, confidence within 2e-3
    (float32 on both sides; the tolerance is the step parity tolerance of
    tests/test_torch_port_step.py carried through the cosine)."""
    j, t = real_run["jax"][transport], real_run["torch"][transport]
    assert t["faces_detected"] == j["faces_detected"] >= 1
    assert [tr["track_id"] for tr in t["tracks"]] == [tr["track_id"] for tr in j["tracks"]]
    for a, b in zip(j["tracks"], t["tracks"]):
        np.testing.assert_allclose(b["bbox"], a["bbox"], atol=1.0)
        assert abs(b["det_score"] - a["det_score"]) < 2e-3
    assert set(t["recognized_tracks"]) == set(j["recognized_tracks"]) != set()
    for tid, rec in j["recognized_tracks"].items():
        assert t["recognized_tracks"][tid]["student_id"] == rec["student_id"] == "SYN0003"
        assert abs(t["recognized_tracks"][tid]["confidence"] - rec["confidence"]) < 2e-3


@pytest.mark.skipif(not os.path.exists(WEIGHTS), reason="trained detector weights not present")
def test_real_engine_attendance_agrees(real_run):
    j, t = real_run["jax"]["attendance"], real_run["torch"]["attendance"]
    assert [s["student_id"] for s in t["recognized"]] == ["SYN0003"]
    assert [s["student_id"] for s in j["recognized"]] == ["SYN0003"]
    assert abs(t["recognized"][0]["confidence"] - j["recognized"][0]["confidence"]) < 2e-3
    assert t["recognized"][0]["confidence"] > 0.9
    assert t["unrecognized"] == j["unrecognized"] == []


# ------------------------------------------------------- (e) the int8 tier

INT8_WEIGHTS = os.path.join(REPO, "pretrained", "mtcnn_dr.npz")
FIXTURE = os.path.join(REPO, "facerecognitionpipeline_tpu_torch", "testdata",
                       "smoke_scenes.npz")


def _int8_server(mod, tmp, gallery, model_path, calib_dir):
    return mod.FaceRecognitionServer(
        gallery=gallery, similarity_threshold=0.8, output_dir=str(tmp / "sessions"),
        architecture="ir_micro", model_path=model_path, detector_weights=INT8_WEIGHTS,
        det_size=DET, max_faces=FACES, batch_max=1, batch_wait_ms=1.0,
        quantize="int8", quantize_calib=calib_dir,
        **({"device": "cpu"} if mod is tserver else {}),
    )


def _write_calib_crops(root):
    from facerecognitionpipeline_tpu_torch.models.quantize import default_calibration_faces
    from facerecognitionpipeline_tpu_torch.utils.io import imwrite_rgb

    os.makedirs(root, exist_ok=True)
    for i, crop in enumerate(default_calibration_faces(6, seed=2)):
        imwrite_rgb(os.path.join(root, f"c{i}.png"), crop)


@pytest.fixture(scope="module")
def int8_run(tmp_path_factory):
    """Both int8 servers, built by their constructors over the same ir_micro
    .npz, calibration crops and detector weights, through one request
    script on a fixture tile. The enrolled student is the port's direct int8
    step's embedding of the tile's face."""
    import jax

    from facerecognitionpipeline_tpu.models.irse import build_backbone as jax_backbone
    from facerecognitionpipeline_tpu.utils.io import save_npz_variables

    tmp = tmp_path_factory.mktemp("int8")
    model_path = str(tmp / "ir_micro.npz")
    variables = jax_backbone("ir_micro").init(
        jax.random.PRNGKey(0), np.zeros((1, 112, 112, 3), np.float32))
    save_npz_variables(model_path, variables)
    calib_dir = str(tmp / "calib")
    _write_calib_crops(calib_dir)
    with np.load(FIXTURE) as d:
        tile = np.ascontiguousarray(d["tiles"][2])

    tgallery = TGallery(gallery_path=str(tmp / "torch" / "g.pkl"), verbose=False, device="cpu")
    tsrv = _int8_server(tserver, tmp / "torch", tgallery, model_path, calib_dir)
    assert tsrv.engine.detector.quantized and tsrv.engine.embedder.quantized
    t, v, _ = tgallery.device_snapshot()
    direct = tsrv.engine.process_frames(torch.from_numpy(tile)[None], t, v)
    ok = (direct["face_valid"][0] & direct["quality_ok"][0]).numpy()
    assert ok.any(), "the tile's face must pass the gate"
    emb = direct["embeddings"][0].float().numpy()[ok][:1]
    others = np.random.default_rng(5).normal(size=(2, 512)).astype(np.float32)
    jgallery = JGallery(gallery_path=str(tmp / "jax" / "g.pkl"), verbose=False)
    for g in (tgallery, jgallery):
        g.add_student("OTHER1", "Other 1", others[0])
        g.add_student("SYN0002", "Tile 2", emb)
        g.add_student("OTHER2", "Other 2", others[1])
    jsrv = _int8_server(jserver, tmp / "jax", jgallery, model_path, calib_dir)

    out = {}
    for which, mod, srv in (("jax", jserver, jsrv), ("torch", tserver, tsrv)):
        httpd = mod.serve(srv, host="127.0.0.1", port=0)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        http = HTTPSession()
        try:
            assert http.post(f"{url}/init_session", json={"session_name": "q"},
                             timeout=30).status_code == 200
            bodies = []
            for count in (1, 2, 3):
                r = http.post(f"{url}/process_frame_raw", timeout=300, data=tile.tobytes(),
                              headers={rawproto.HEADER_FORMAT: "rgb24",
                                       rawproto.HEADER_WIDTH: str(DET[1]),
                                       rawproto.HEADER_HEIGHT: str(DET[0]),
                                       rawproto.HEADER_SCALE: "1.0",
                                       rawproto.HEADER_COUNT: str(count)})
                assert r.status_code == 200, r.text[:300]
                bodies.append(r.json())
            assert http.post(f"{url}/finalize", json={}, timeout=30).status_code == 200
            with open(tmp / which / "sessions" / "q" / "attendance.json") as f:
                out[which] = (bodies, json.load(f))
        finally:
            http.close()
            httpd.shutdown()
            httpd.server_close()
            srv.shutdown()
            thread.join(timeout=10)
    return out


@pytest.mark.parametrize("frame", [0, 1, 2])
def test_int8_servers_answer_alike(int8_run, frame):
    """Same faces, boxes within 1 px, the same recognized student."""
    j, t = int8_run["jax"][0][frame], int8_run["torch"][0][frame]
    assert t["faces_detected"] == j["faces_detected"] >= 1
    assert [tr["track_id"] for tr in t["tracks"]] == [tr["track_id"] for tr in j["tracks"]]
    for a, b in zip(j["tracks"], t["tracks"]):
        np.testing.assert_allclose(b["bbox"], a["bbox"], atol=1.0)
    students = {tid: r["student_id"] for tid, r in t["recognized_tracks"].items()}
    assert students == {tid: r["student_id"] for tid, r in j["recognized_tracks"].items()}


def test_int8_servers_attendance_agrees(int8_run):
    """The same student in attendance.json. Its confidence is the port's own
    direct embedding against itself (1.0) on the port's side; on the JAX
    side, the JAX server's embedding of the same face: each package
    calibrates in bf16 on its own (activation scales within ~2%), so codes,
    and the sub-pixel landmarks that place the aligned crop, differ; it must
    still clear the 0.8 threshold by a margin."""
    j, t = int8_run["jax"][1], int8_run["torch"][1]
    assert [s["student_id"] for s in t["recognized"]] == ["SYN0002"]
    assert [s["student_id"] for s in j["recognized"]] == ["SYN0002"]
    assert t["recognized"][0]["confidence"] > 0.999
    assert j["recognized"][0]["confidence"] > 0.9


def test_quantize_calib_without_images_is_refused_as_in_jax(tmp_path):
    """A calibration directory that holds no image: ValueError from both
    servers' constructors (load_calibration_faces)."""
    for which, mod in (("jax", jserver), ("torch", tserver)):
        kw = {"device": "cpu"} if which == "torch" else {}
        with pytest.raises(ValueError, match="no readable calibration images"):
            mod.FaceRecognitionServer(
                gallery_path=str(tmp_path / which / "g.pkl"),
                output_dir=str(tmp_path / which), architecture="ir_micro",
                detector_weights=os.path.join(REPO, "pretrained", "mtcnn_dr.npz"),
                 det_size=DET, max_faces=FACES,
                quantize="int8", quantize_calib=str(tmp_path / "missing"), warmup=False, **kw,
            )
