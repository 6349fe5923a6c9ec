"""The serving measurements of the port (`serve/bench.py`,
`pipeline/budget_profile.py`) held against the JAX scripts they reproduce
(`examples/serving_bench.py`, `examples/serving_host_ceiling.py`,
`examples/profile_budget.py`), on the CPU.

(a) `encode_frame` sends the JAX script's bytes for every image format.
(b) `ZeroCostEngine` on the CPU returns the JAX stub's outputs, and the
    port's server over it answers a request script (raw I420 over the i420
    transport, raw rgb24 over rgb) with the JAX server's JSON over the JAX
    stub, timings dropped.
(c) `run_clients` from two client processes against that server: the JAX
    row's keys, the server's count equal to the clients', no client that
    imported torch; an answer of 500 raises and gives no row.
(d) `profile_budget` at a small size: the JAX rows' keys, the embedder's
    rows counted per step.
(e) Every entry point asks for the card unless given device='cpu'.

Servers bind 127.0.0.1:0 and run on threads of the test process; the
clients of (c) are spawned processes.
"""

import importlib.util
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch

from facerecognitionpipeline_tpu.gallery.manager import GalleryManager as JGallery
from facerecognitionpipeline_tpu.serve import server as jserver
from facerecognitionpipeline_tpu_torch.pipeline import budget_profile
from facerecognitionpipeline_tpu_torch.serve import bench
from facerecognitionpipeline_tpu_torch.serve.client import HTTPSession

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DET = 160


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_example_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


JBENCH = _example("serving_bench")
JCEILING = _example("serving_host_ceiling")


def _camera_frame():
    return np.random.default_rng(0).integers(0, 256, (720, 1280, 3), dtype=np.uint8)


# ----------------------------------------------------------- (a) payloads


@pytest.mark.parametrize("image_format", ["png", "jpeg", "raw", "raw-i420"])
def test_encode_frame_sends_the_jax_scripts_bytes(image_format):
    frame = _camera_frame()
    for det in (640, DET):
        got = bench.encode_frame(frame, image_format, det)
        want = JBENCH.encode_frame(frame, image_format, det)
        assert got[0] == want[0] and got[2] == want[2]
        assert type(got[1]) is type(want[1]) and got[1] == want[1]


# -------------------------------------------------------- (b) the stub


@pytest.mark.parametrize("input_format", ["rgb", "i420"])
@pytest.mark.parametrize("b,k", [(1, 3), (8, 3), (2, 5)])
def test_zero_cost_engine_returns_the_jax_stubs_outputs(input_format, b, k):
    port = bench.ZeroCostEngine(input_format=input_format, device="cpu")
    jax_stub = JCEILING.ZeroCostEngine(input_format=input_format)
    assert port.host_frame_shape(DET, DET) == jax_stub.host_frame_shape(DET, DET)
    frames = np.zeros((b, *port.host_frame_shape(DET, DET)), np.uint8)
    got = port.process_frames(torch.from_numpy(frames), None, None, gallery_k=k, rotation=7)
    want = jax_stub.process_frames(frames, None, None, gallery_k=k)
    assert got.keys() == want.keys()
    for key, w in want.items():
        pairs = ([(got[key][m], w[m]) for m in w] if isinstance(w, dict)
                 else [(got[key], w)])
        for g, x in pairs:
            assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
            assert g.numpy().dtype == x.dtype and np.array_equal(g.numpy(), x), key


_DROP = {"performance", "pid", "timestamp", "first_seen", "last_updated", "start_time",
         "end_time", "duration_seconds", "saved_face_path", "avg_latency_recognition_ms",
         "avg_latency_network_ms", "avg_latency_e2e_server_ms", "current_cpu_ram_mb",
         "peak_cpu_ram_mb", "session_dir"}


def _scrub(obj):
    if isinstance(obj, dict):
        return {k: _scrub(v) for k, v in obj.items() if k not in _DROP}
    if isinstance(obj, list):
        return [_scrub(v) for v in obj]
    return obj


def _jax_ceiling_server(tmp, transport):
    """The JAX script's server (`examples/serving_host_ceiling.py:100-150`)
    over the JAX stub, at DET."""
    rng = np.random.default_rng(0)
    gallery = JGallery(gallery_path=os.path.join(tmp, "g.pkl"), verbose=False)
    emb = rng.normal(size=(2, 512)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    gallery.add_student("STU0000", "Student 0", emb)
    srv = jserver.FaceRecognitionServer(
        gallery=gallery, output_dir=os.path.join(tmp, "sessions"),
        engine=JCEILING.ZeroCostEngine(input_format=transport), det_size=(DET, DET),
        batch_max=8, batch_wait_ms=5.0, transport=transport)
    frame = rng.integers(0, 256, (720, 1280, 3), dtype=np.uint8)
    payload = JBENCH.encode_frame(frame, "raw-i420" if transport == "i420" else "raw", DET)
    return srv, payload


class _Served:
    def __init__(self, srv, serve):
        self.srv = srv
        self.httpd = serve(srv, host="127.0.0.1", port=0)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()
        self.http = HTTPSession()

    def call(self, method, path, **kw):
        if method == "GET":
            r = self.http.get(self.url + path, timeout=30)
        else:
            r = self.http.post(self.url + path, timeout=30, **kw)
        return r.status_code, _scrub(r.json())

    def close(self):
        self.http.close()
        self.httpd.shutdown()
        self.httpd.server_close()
        self.srv.shutdown()
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()


def _frame_request(payload, count):
    path, body, headers = payload
    return ("POST", path, {"data": body, "headers": {**headers, "X-Frame-Count": str(count)}})


SCRIPT = ["health", "init", "stats_empty", "frame_1", "frame_2", "frame_3", "stats",
          "finalize"]


def _script(payload):
    return {
        "health": ("GET", "/health", {}),
        "init": ("POST", "/init_session", {"json": {"session_name": "ceiling"}}),
        "stats_empty": ("GET", "/stats", {}),
        **{f"frame_{i}": _frame_request(payload, i) for i in (1, 2, 3)},
        "stats": ("GET", "/stats", {}),
        "finalize": ("POST", "/finalize", {"json": {}}),
    }


@pytest.fixture(scope="module", params=["i420", "rgb"])
def stub_script(request, tmp_path_factory):
    """Both ceiling servers through SCRIPT: {step: (jax (status, body),
    torch (status, body))}, plus each side's attendance.json."""
    transport = request.param
    tmp = tmp_path_factory.mktemp(f"ceiling_{transport}")
    jsrv, jpayload = _jax_ceiling_server(str(tmp / "jax"), transport)
    tsrv, tpayload = bench.ceiling_server(DET, transport, device="cpu",
                                          workdir=str(tmp / "torch"))
    assert tpayload[0] == jpayload[0] and tpayload[1] == jpayload[1]
    assert tpayload[2] == jpayload[2]
    from facerecognitionpipeline_tpu_torch.serve import server as tserver

    sides = []
    got = {}
    try:
        sides = [_Served(jsrv, jserver.serve), _Served(tsrv, tserver.serve)]
        steps = _script(tpayload)
        for name in SCRIPT:
            method, path, kw = steps[name]
            got[name] = tuple(side.call(method, path, **kw) for side in sides)
    finally:
        for side in sides:
            side.close()
    for which, root in (("jax", tmp / "jax"), ("torch", tmp / "torch")):
        with open(root / "sessions" / "ceiling" / "attendance.json") as f:
            got[f"attendance_{which}"] = _scrub(json.load(f))
    got["transport"] = transport
    return got


@pytest.mark.parametrize("step", SCRIPT)
def test_stub_server_answers_as_the_jax_stub_server(stub_script, step):
    (jsc, jbody), (tsc, tbody) = stub_script[step]
    assert jsc == tsc == 200, (jsc, tsc, tbody)
    assert tbody == jbody


def test_stub_script_reaches_recognition(stub_script):
    _, (_, first) = stub_script["frame_1"]
    assert first["faces_detected"] == 1
    assert first["newly_recognized"]["1"]["student_id"] == "STU0000"
    _, (_, stats) = stub_script["stats"]
    assert stats["total_requests"] == 3
    assert stub_script["attendance_torch"] == stub_script["attendance_jax"]
    assert [r["student_id"] for r in stub_script["attendance_torch"]["recognized"]] == [
        "STU0000"]


# ------------------------------------------------------- (c) run_clients


JAX_ROW = ("clients", "requests", "req_per_sec", "latency_p50_ms", "latency_p95_ms")


def test_run_clients_from_two_processes_against_the_cpu_stub_server(tmp_path):
    server, payload = bench.ceiling_server(DET, "i420", device="cpu", workdir=str(tmp_path))
    served = bench.ServedBench(server, session="ceiling")
    try:
        row = served.run(2, 1.5, [payload], keep_answers=True, rss_interval=0.5)
        report = served.report()
    finally:
        served.close()
    assert set(JAX_ROW) <= row.keys() and row["clients"] == 2
    assert row["requests"] > 2 and row["requests"] == row["server_requests"]
    assert row["req_per_sec"] == pytest.approx(row["requests"] / row["wall_s"])
    assert 0 < row["latency_p50_ms"] <= row["latency_p95_ms"]
    assert 1.2 < row["wall_s"] < 30
    assert row["clients_imported_torch"] is False
    assert {"rss_first_mb", "rss_last_mb", "rss_kb_per_req", "rss_curve"} <= row.keys()
    assert row["launches"] == {k: 0 for k in row["launches"]}
    assert 1 <= row["steps"] <= row["requests"]
    assert row["frames_per_step"] == row["requests"] / row["steps"]
    assert (row["device"], row["card"], row["step_p50_ms"]) == ("cpu", None, None)
    assert row["cpu_count"] == len(os.sched_getaffinity(0))
    # each client's first answer: the stub's one face at its box
    assert sorted(c for c, _, _ in row["answers"]) == [0, 1]
    for _, j, text in row["answers"]:
        body = json.loads(text)
        assert j == 0 and body["faces_detected"] == 1
        assert body["tracks"][0]["bbox"] == pytest.approx(
            [c / (DET / 1280) for c in (100, 100, 220, 220)])
    assert report["frames"] == row["requests"] and report["steps"] == row["steps"]


class _ErrorHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):
        pass

    def _send(self, status, payload):
        body = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        self._send(200, {"total_requests": 0})

    def do_POST(self):
        self.rfile.read(int(self.headers.get("Content-Length", 0)))
        self._send(500, {"error": "boom in the step"})


def test_run_clients_raises_on_an_error_answer_and_gives_no_row():
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _ErrorHandler)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        payload = bench.encode_frame(_camera_frame(), "raw-i420", DET)
        with pytest.raises(bench.BenchError, match="HTTP 500.*boom in the step"):
            bench.run_clients(f"http://127.0.0.1:{httpd.server_address[1]}", 2, 1.0,
                              [payload])
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)


# ---------------------------------------------------- (d) budget sweep


def test_profile_budget_counts_the_embedders_rows_per_step():
    seen = []
    rows = budget_profile.profile_budget(
        b=2, faces=8, det=DET, budgets=(4, 2), chain=1, samples=1,
        architecture="ir_micro", device="cpu", on_row=seen.append)
    assert seen == rows
    assert [r["budget"] for r in rows] == [None, 4, 2]
    for r in rows:
        assert {"budget", "p50_step_ms", "frames_per_sec", "embeds_per_step"} <= r.keys()
        assert r["embeds_per_step"] == 2 * (r["budget"] or 8)
        assert r["p50_step_ms"] > 0 and r["frames_per_sec"] > 0
        assert (r["device"], r["card"], r["power_limit"], r["device_ms"]) == (
            "cpu", None, None, None)
        assert r["timing"] == "host-clock"


# -------------------------------------------------------- (e) the card


@pytest.mark.parametrize("entry", ["stub", "bench_server", "ceiling", "bench", "budget"])
def test_serving_measurements_default_to_cuda(monkeypatch, tmp_path, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = {
        "stub": lambda: bench.ZeroCostEngine(),
        "bench_server": lambda: bench.bench_server(workdir=str(tmp_path)),
        "ceiling": lambda: bench.run_host_ceiling(clients=(1,), seconds=0.1),
        "bench": lambda: bench.run_serving_bench(clients=(1,), seconds=0.1),
        "budget": lambda: budget_profile.profile_budget(budgets=()),
    }[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()


@pytest.mark.parametrize("script", ["torch_serving_bench", "torch_serving_host_ceiling",
                                    "torch_profile_budget"])
def test_serving_scripts_take_the_jax_flags_and_default_to_cuda(script):
    import re

    with open(os.path.join(REPO, "examples", f"{script.replace('torch_', '')}.py")) as f:
        jax_flags = set(re.findall(r'add_argument\(\s*"--(\w+)"', f.read()))
    parser = _example(script).build_parser()
    ours = vars(parser.parse_args([]))
    assert jax_flags and jax_flags <= ours.keys(), jax_flags - ours.keys()
    assert ours.keys() - jax_flags == {"device"} and ours["device"] == "cuda"


# ------------------------------------------------ (f) the committed rows


REPORTS = os.path.join(REPO, "reports", "serving_bench_torch")
BENCH_CONFIGS = {  # (image format, transport, quantize, embed budget): client counts
    ("png", "rgb", None, None): [1, 4, 8, 12],
    ("jpeg", "rgb", None, None): [1, 4, 8, 12],
    ("raw", "rgb", None, None): [1, 4, 8, 12],
    ("jpeg", "i420", None, None): [1, 4, 8, 12],
    ("raw-i420", "i420", "int8", 8): [4, 12],
}
CURVE_CLIENTS = [1, 4, 8, 12, 16, 24]
CURVE_ROUNDS = 3


def _rows(part):
    with open(os.path.join(REPORTS, f"{part}.jsonl")) as f:
        lines = [json.loads(line) for line in f if line.strip()]
    return ([r for r in lines if "server" not in r and "summary" not in r],
            [r["server"] for r in lines if "server" in r])


def _bench_step_launches(r):
    n = r["steps"]
    assert 1 <= n <= r["requests"]
    assert r["launches"]["crop_resize"] == 3 * n == r["launches"]["nms_fixpoint"]
    assert r["launches"]["warp_patches"] == n
    assert all(r["launches"][k] == 0
               for k in ("gallery_topk", "gallery_topk_int8", "gallery_topk_f32"))
    products = r["launches"]["int8_products"]
    assert (products > 0 and products % n == 0) if r["quantize"] else products == 0


def _on_the_card(r):
    assert r["device"] == "cuda" and r["card"] and r["power_limit"].endswith("W"), r


@pytest.mark.parametrize("part", ["bench", "curve", "ceiling", "budget"])
def test_committed_rows_hold_the_checks(part):
    """reports/serving_bench_torch/ as `chip_smoke.py --serving-only all`
    wrote it on a card: every configuration and client count of the JAX
    scripts (raw I420 and the stub on the card in the curve, at 16 and 24
    clients too, three rounds), the server's count equal to the clients',
    the kernels a step of the bench's build, no launch by the stub, the
    curve's summary recomputed from its rows, the embeds of each budget and
    no budget slower than the dense step."""
    rows, servers = _rows(part)
    if part == "bench":
        got: dict = {}
        for r in rows:
            key = (r["image_format"], r["transport"], r["quantize"], r["embed_budget"])
            got.setdefault(key, []).append(r["clients"])
            _on_the_card(r)
            assert r["requests"] == r["server_requests"] > 0
            assert not r["clients_imported_torch"] and r["wall_s"] >= 20
            _bench_step_launches(r)
        assert got == BENCH_CONFIGS
        assert len(servers) == 3
    elif part == "curve":
        import chip_smoke

        for kind in ("real", "stub"):
            assert sorted((r["round"], r["clients"]) for r in rows if r["engine_kind"] == kind) \
                == sorted((k, n) for k in range(CURVE_ROUNDS) for n in CURVE_CLIENTS)
        for r in rows:
            _on_the_card(r)
            assert r["requests"] == r["server_requests"] > 0 and r["wall_s"] >= 12
            assert not r["clients_imported_torch"] and r["transport"] == "i420"
            if r["engine_kind"] == "real":
                assert (r["image_format"], r["quantize"]) == ("raw-i420", None)
                _bench_step_launches(r)
            else:
                assert r["engine"] == bench.CEILING_ENGINE and not any(r["launches"].values())
        with open(os.path.join(REPORTS, "curve.jsonl")) as f:
            summary = [json.loads(line)["summary"] for line in f if '"summary"' in line]
        assert summary == [chip_smoke.curve_summary(rows)]
        assert len(servers) == 2
    elif part == "ceiling":
        assert sorted((r["device"], r["clients"]) for r in rows) == [
            ("cpu", n) for n in (1, 4, 8, 12)]
        for r in rows + servers:
            assert not any(r["launches"].values()), r
        for r in rows:
            assert r["requests"] == r["server_requests"] > 0 and r["wall_s"] >= 12
            assert r["engine"] == bench.CEILING_ENGINE and r["transport"] == "i420"
    else:
        assert [r["budget"] for r in rows] == [None, 16, 8, 4]
        for r in rows:
            _on_the_card(r)
            assert r["embeds_per_step"] == 8 * (r["budget"] or 32)
            assert r["p50_step_ms"] <= rows[0]["p50_step_ms"] and r["device_ms"] > 0
