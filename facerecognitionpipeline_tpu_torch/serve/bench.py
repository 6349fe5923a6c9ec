"""Serving measurements over real HTTP: the multi-client bench and the
HTTP edge's ceiling with a zero-cost engine.

Counterpart of `examples/serving_bench.py:26-230` and
`examples/serving_host_ceiling.py:43-211`:

* `encode_frame`: the bytes the camera client sends (base64 PNG or JPEG
  to /process_frame; raw rgb24 or I420 planes to /process_frame_raw).
* `run_clients`: N closed-loop clients for a number of seconds, each
  cycling through the payloads; a row of requests, requests/s and latency
  p50/p95 as the clients saw it, plus `server_requests` (the server's
  own count over the window, from /stats) which must equal `requests`.
* `ZeroCostEngine`: the recognition engine's output contract at no cost:
  one valid face per frame, everything else padding.
* `run_serving_bench` and `run_host_ceiling`: the two scripts' `main()`s.

One deliberate difference from the JAX scripts: **each client is a
process of its own**, `serve/soak.py`'s `Clients` (started with `spawn`,
importing numpy and these modules but not torch), where the JAX scripts
run their clients as threads of the server's process. A camera is another
machine; a client thread in the server's process would charge its
interpreter time to the server's interpreter lock. The clients start
together and each stops sending `seconds` later on the system's monotonic
clock. Any client error, an answer other than 200, a request not answered
within `soak.ANSWER_TIMEOUT_S` or a server count other than the clients'
raises `BenchError` and gives no row, as the JAX scripts exit with
"measurement invalid".

This module imports neither torch nor cv2 at import time: the clients
import it.
"""

from __future__ import annotations

import os
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from facerecognitionpipeline_tpu_torch.serve import rawproto, soak
from facerecognitionpipeline_tpu_torch.serve.client import HTTPSession, _encode_image_base64
from facerecognitionpipeline_tpu_torch.telemetry.trace import device_ms

BASELINE_REQ_PER_SEC = 1.33  # BASELINE.md: the reference's server, one client
BENCH_STUDENTS = 23  # the JAX bench's gallery: 23 students x 4 embeddings, seed 0
CAMERA = (720, 1280, 3)  # the synthetic camera frames of both scripts
CEILING_ENGINE = "zero-cost stub (host path only)"
_STUB_METRICS = ("det_score", "face_size", "yaw", "pitch", "roll", "blur_score")


class BenchError(RuntimeError):
    """A measurement that is not valid (see the module docstring)."""


def encode_frame(frame_rgb: np.ndarray, image_format: str, det: int):
    """(path, body, headers) of one camera frame as the client sends it:
    JSON base64 for png/jpeg (headers None), octet-stream raw planes for
    raw/raw-i420 (the rawproto contract)."""
    if image_format in ("raw", "raw-i420"):
        canvas, scale = rawproto.letterbox_rgb(frame_rgb, (det, det))
        if image_format == "raw-i420":
            body, fmt = rawproto.rgb_to_i420(canvas).tobytes(), "i420"
        else:
            body, fmt = np.ascontiguousarray(canvas).tobytes(), "rgb24"
        headers = {
            "Content-Type": "application/octet-stream",
            rawproto.HEADER_FORMAT: fmt,
            rawproto.HEADER_WIDTH: str(det),
            rawproto.HEADER_HEIGHT: str(det),
            rawproto.HEADER_SCALE: repr(scale),
        }
        return "/process_frame_raw", body, headers
    return "/process_frame", _encode_image_base64(frame_rgb, image_format), None


# --------------------------------------------------------------- clients


def served_requests(url: str) -> int:
    """The frame requests the server has answered in its session, from its
    own /stats (`total_requests`)."""
    session = HTTPSession()
    try:
        r = session.get(url + "/stats", timeout=30)
    finally:
        session.close()
    count = r.json().get("total_requests") if r.status_code == 200 else None
    if count is None:
        raise BenchError(f"GET /stats answered {r.status_code} without total_requests: "
                         f"{r.text[:200]}")
    return int(count)


def run_clients(url: str, n_clients: int, seconds: float, payloads,
                rss_interval: float = 0.0, keep_answers: bool = False) -> dict:
    """`n_clients` client processes (`soak.Clients`) against `url` for
    `seconds`, client c sending payload (c + i) % len(payloads) as its
    request i (see the module docstring). Returns the JAX row's keys
    (`clients`, `requests`, `req_per_sec`, `latency_p50_ms`,
    `latency_p95_ms`, and with `rss_interval` > 0 `rss_first_mb`,
    `rss_last_mb`, `rss_kb_per_req`, `rss_curve`: the RSS of this process,
    where the server runs, as the JAX script samples its own), plus
    `server_requests`, `wall_s` (start -> last answer), `client_cpu_s` (the
    clients' CPU seconds summed), `host_cpu_s` (this process's CPU seconds
    over the window), `clients_imported_torch`, `clients_start_s` (spawn ->
    all ready), `clients_end_s` (the clients' deadline -> all exited) and,
    with `keep_answers`,
    `answers`: [client, payload index, body text] of each client's first
    answer per payload."""
    requests = [{"path": path, "json": {"frame": body}} if headers is None
                else {"path": path, "data": body, "headers": headers}
                for path, body, headers in payloads]
    served0 = served_requests(url)
    answered = [0]
    rss_curve: list = []
    with tempfile.TemporaryDirectory(prefix="bench_clients_") as tmp:
        clients = soak.Clients(n_clients, url, requests, tmp, "bench-client", seconds=seconds)
        try:
            t_spawn = time.monotonic()
            t0 = clients.start()
            cpu0 = time.process_time()
            if rss_interval > 0:
                threading.Thread(target=_sample_rss, daemon=True,
                                 args=(rss_curve, t0, seconds, rss_interval, answered)).start()
            out = clients.wait(on_answer=lambda n: answered.__setitem__(0, n))
            host_cpu = time.process_time() - cpu0
            t_done = time.monotonic()
        except soak.SoakError as e:
            raise BenchError(f"measurement invalid: {e}") from e
        finally:
            clients.close()
    lat = np.asarray([ms for r in out for _, ms, _ in r["rows"]], np.float64)
    if not len(lat):
        raise BenchError(f"measurement invalid: no request answered in {seconds} s")
    wall = max(r["rows"][-1][0] for r in out if r["rows"]) - t0
    row = {
        "clients": n_clients,
        "requests": int(len(lat)),
        "req_per_sec": len(lat) / wall,
        "latency_p50_ms": float(np.percentile(lat, 50)),
        "latency_p95_ms": float(np.percentile(lat, 95)),
        "server_requests": served_requests(url) - served0,
        "wall_s": wall,
        "client_cpu_s": float(sum(r["cpu_s"] for r in out)),
        "host_cpu_s": host_cpu,
        "clients_imported_torch": any(r["torch_imported"] for r in out),
        "clients_start_s": t0 - t_spawn,
        "clients_end_s": t_done - t0 - seconds,
    }
    if row["server_requests"] != row["requests"]:
        raise BenchError(f"measurement invalid: the server answered {row['server_requests']} "
                         f"requests in the window, the clients counted {row['requests']}")
    if rss_curve:
        grown = rss_curve[-1]["rss_mb"] - rss_curve[0]["rss_mb"]
        dreq = max(1, rss_curve[-1]["reqs"] - rss_curve[0]["reqs"])
        row["rss_first_mb"] = rss_curve[0]["rss_mb"]
        row["rss_last_mb"] = rss_curve[-1]["rss_mb"]
        row["rss_kb_per_req"] = grown * 1e3 / dreq
        row["rss_curve"] = rss_curve
    if keep_answers:
        row["answers"] = []
        for c, r in enumerate(out):
            first: Dict[int, str] = {}
            for i, (_, _, text) in enumerate(r["rows"]):
                first.setdefault((c + i) % len(requests), text)
            row["answers"] += [[c, j, text] for j, text in sorted(first.items())]
    return row


def _sample_rss(curve: list, t0: float, seconds: float, interval: float, answered) -> None:
    pid = os.getpid()
    stop = t0 + seconds
    while time.monotonic() < stop:
        rss = soak.rss_mb(pid)
        if rss is not None:
            curve.append({"t": time.monotonic() - t0, "rss_mb": rss, "reqs": answered[0]})
        time.sleep(min(interval, max(0.1, stop - time.monotonic())))


# ---------------------------------------------------------------- engine


class ZeroCostEngine:
    """The recognition engine's output contract at no cost
    (`examples/serving_host_ceiling.py:43-90`): one valid face per frame,
    everything else padding. Its outputs are tensors on `device`, so the
    batcher uploads, copies back and hands out lazy views as it does for
    the real engine; on a card they are made once per (batch, k) and handed
    out again, so the step itself costs nothing. device: 'cuda' (the
    default) raises without a card; 'cpu' makes fresh outputs per call, as
    the JAX stub does."""

    def __init__(self, max_faces: int = 16, input_format: str = "rgb", device="cuda"):
        from facerecognitionpipeline_tpu_torch.utils.device import resolve_device

        self.device = resolve_device(device)
        self.max_faces = max_faces
        self.input_format = input_format
        self._made: Dict = {}

    def host_frame_shape(self, h, w):
        return (h * 3 // 2, w) if self.input_format == "i420" else (h, w, 3)

    def _outputs(self, b: int, k: int) -> dict:
        import torch

        f = self.max_faces
        out = {
            "bboxes": np.zeros((b, f, 4), np.float32),
            "det_scores": np.zeros((b, f), np.float32),
            "landmarks": np.zeros((b, f, 5, 2), np.float32),
            "face_valid": np.zeros((b, f), bool),
            "quality_ok": np.zeros((b, f), bool),
            "quality_metrics": {m: np.zeros((b, f), np.float32) for m in _STUB_METRICS},
            "aligned": np.zeros((b, f, 112, 112, 3), np.uint8),
            "embeddings": np.zeros((b, f, 512), np.float32),
            "embedding_norms": np.ones((b, f), np.float32),
            "match_scores": np.zeros((b, f, k), np.float32),
            "match_idx": np.zeros((b, f, k), np.int32),
        }
        out["bboxes"][:, 0] = [100, 100, 220, 220]
        out["det_scores"][:, 0] = 0.95
        out["quality_metrics"]["det_score"][:, 0] = 0.95
        out["quality_metrics"]["face_size"][:, 0] = 120.0
        out["quality_metrics"]["blur_score"][:, 0] = 300.0
        out["face_valid"][:, 0] = True
        out["quality_ok"][:, 0] = True
        out["match_scores"][:, 0, 0] = 0.92

        def put(a):
            return torch.from_numpy(a).to(self.device)

        return {key: {m: put(a) for m, a in v.items()} if isinstance(v, dict) else put(v)
                for key, v in out.items()}

    def process_frames(self, frames, templates, valid, gallery_k=3, rotation=0,
                       start_event=None):
        if start_event is not None:
            start_event.record()
        b = int(frames.shape[0])
        if self.device.type == "cpu":
            return self._outputs(b, gallery_k)
        if (b, gallery_k) not in self._made:
            self._made[(b, gallery_k)] = self._outputs(b, gallery_k)
        return {key: dict(v) if isinstance(v, dict) else v
                for key, v in self._made[(b, gallery_k)].items()}


# ---------------------------------------------------------------- servers


class ServedBench:
    """A FaceRecognitionServer served on 127.0.0.1 from a thread of this
    process, with one session open: what both scripts drive their clients
    against. `run` adds to each row what the server did in the window:
    steps dispatched, frames per step, kernel launches (and int8 products),
    on a card the p50 of the dispatched steps (the `step.device` spans of
    the server's tracer, on across the window) and the share of the window
    they fill, the device, the card's name and power limit, and the cores
    this process may use."""

    def __init__(self, server, session: str = "serving_bench"):
        from facerecognitionpipeline_tpu_torch.serve.server import serve
        from facerecognitionpipeline_tpu_torch.utils.device import card_fields

        self.server = server
        self.httpd = serve(server, "127.0.0.1", 0)
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        http = HTTPSession()
        try:
            r = http.post(self.url + "/init_session", json={"session_name": session},
                          timeout=30)
        finally:
            http.close()
        if r.status_code != 200:
            self.close()
            raise BenchError(f"/init_session answered {r.status_code}: {r.text[:200]}")
        self.where = {"device": str(server.device), **card_fields(server.device),
                      "cpu_count": len(os.sched_getaffinity(0))}

    def run(self, n_clients: int, seconds: float, payloads, settle: float = 0.0,
            rss_interval: float = 0.0, keep_answers: bool = False) -> dict:
        """A settle run of `settle` seconds (no row), then the measured run."""
        from facerecognitionpipeline_tpu_torch.ops.launches import launch_counts

        if settle > 0:
            run_clients(self.url, n_clients, settle, payloads)
        at = launch_counts()
        steps0 = self.server.batcher.steps.count
        tracer = self.server.tracer
        tracer.start()
        try:
            row = run_clients(self.url, n_clients, seconds, payloads,
                              rss_interval=rss_interval, keep_answers=keep_answers)
        finally:
            trace = tracer.stop()
        step_ms = device_ms(trace) if self.server.device.type == "cuda" else []
        steps = self.server.batcher.steps.count - steps0
        row.update({
            "steps": steps,
            "frames_per_step": row["server_requests"] / steps if steps else None,
            "launches": {k: n - at[k] for k, n in launch_counts().items()},
            "step_p50_ms": float(np.percentile(step_ms, 50)) if step_ms else None,
            "step_busy_share": sum(step_ms) / (1e3 * row["wall_s"]) if step_ms else None,
            **self.where,
        })
        return row

    def report(self) -> dict:
        """The server's `launch_report()` (kernels since it was ready, the
        steps it dispatched) with the frames it answered and frames per
        step."""
        rep = self.server.launch_report()
        frames = self.server.perf_monitor.total_requests
        return {**rep, "frames": frames,
                "frames_per_step": frames / rep["steps"] if rep["steps"] else None}

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.server.shutdown()
        self.thread.join(timeout=30)


def bench_server(architecture: str = "ir_101", det: int = 640, batch_max: int = 8,
                 transport: str = "rgb", quantize: Optional[str] = None,
                 embed_budget: Optional[int] = None, device="cuda",
                 workdir: Optional[str] = None):
    """The JAX bench's server (`examples/serving_bench.py:167-200`): 23
    students of 4 seeded embeddings (seed 0), threshold 0.5, `max_faces`
    16, bf16, built by the server's constructor (the shipped detector, the
    embedder seeded at random). Returns (server, rng): the rng goes on to
    draw the camera frames, as the script's does."""
    from facerecognitionpipeline_tpu_torch.gallery.manager import GalleryManager
    from facerecognitionpipeline_tpu_torch.serve.server import FaceRecognitionServer

    workdir = workdir or tempfile.mkdtemp(prefix="serving_bench_")
    rng = np.random.default_rng(0)
    gallery = GalleryManager(gallery_path=os.path.join(workdir, "g.pkl"), verbose=False,
                             device=device)
    embs = rng.normal(size=(BENCH_STUDENTS, 4, 512)).astype(np.float32)
    embs /= np.linalg.norm(embs, axis=-1, keepdims=True)
    for i in range(BENCH_STUDENTS):
        gallery.add_student(f"STU{i:04d}", f"Student {i}", embs[i])
    server = FaceRecognitionServer(
        gallery=gallery, similarity_threshold=0.5,
        output_dir=os.path.join(workdir, "sessions"), det_size=(det, det),
        architecture=architecture, batch_max=batch_max, max_faces=16, transport=transport,
        embed_budget=embed_budget, quantize=quantize, device=device,
    )
    return server, rng


def camera_frames(rng, n: int = 4) -> List[np.ndarray]:
    """The bench's synthetic 720p camera frames."""
    return [rng.integers(0, 256, CAMERA, dtype=np.uint8) for _ in range(n)]


def bench_fields(row: dict, image_format: str, transport: str, quantize: Optional[str],
                 embed_budget: Optional[int], architecture: str) -> dict:
    """The keys the JAX bench adds to a row (its configuration and the
    reference's one-client figure), with the build's quantize and
    architecture."""
    return {"image_format": image_format, "transport": transport,
            "embed_budget": embed_budget, "quantize": quantize,
            "architecture": architecture, "baseline_req_per_sec": BASELINE_REQ_PER_SEC,
            "vs_baseline": row["req_per_sec"] / BASELINE_REQ_PER_SEC}


def run_serving_bench(
    clients: Sequence[int] = (1, 4),
    seconds: float = 30.0,
    det: int = 640,
    batch_max: int = 8,
    architecture: str = "ir_101",
    image_format: str = "png",
    transport: str = "rgb",
    quantize: Optional[str] = None,
    embed_budget: Optional[int] = None,
    rss_interval: float = 0.0,
    device="cuda",
    on_row: Optional[Callable[[dict], None]] = None,
) -> dict:
    """`examples/serving_bench.py`'s run: one server (`bench_server`), 4
    camera frames in `image_format`, and per client count a settle run of
    min(5, seconds / 4) s then the measured run. Returns {"rows": [...],
    "server": ServedBench.report()}; `on_row` is called with each row."""
    server, rng = bench_server(architecture, det, batch_max, transport, quantize,
                               embed_budget, device)
    payloads = [encode_frame(f, image_format, det) for f in camera_frames(rng)]
    bench = ServedBench(server)
    rows = []
    try:
        for n in clients:
            row = bench.run(n, seconds, payloads, settle=min(5.0, seconds / 4),
                            rss_interval=rss_interval)
            row.update(bench_fields(row, image_format, transport, quantize, embed_budget,
                                    architecture))
            rows.append(row)
            if on_row is not None:
                on_row(row)
        report = bench.report()
    finally:
        bench.close()
    return {"rows": rows, "server": report}


def ceiling_server(det: int = 640, transport: str = "i420", device="cuda",
                   workdir: Optional[str] = None):
    """The ceiling's server (`examples/serving_host_ceiling.py:100-150`):
    one student of 2 seeded embeddings (seed 0), `ZeroCostEngine` in the
    transport's input format, batch_max 8, a 5 ms window. Returns (server,
    payload): one camera frame letterboxed and sent as raw planes in the
    transport's own format."""
    from facerecognitionpipeline_tpu_torch.gallery.manager import GalleryManager
    from facerecognitionpipeline_tpu_torch.serve.server import FaceRecognitionServer

    workdir = workdir or tempfile.mkdtemp(prefix="serving_ceiling_")
    engine = ZeroCostEngine(input_format=transport, device=device)
    rng = np.random.default_rng(0)
    gallery = GalleryManager(gallery_path=os.path.join(workdir, "g.pkl"), verbose=False,
                             device=engine.device)
    emb = rng.normal(size=(2, 512)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    gallery.add_student("STU0000", "Student 0", emb)
    server = FaceRecognitionServer(
        gallery=gallery, output_dir=os.path.join(workdir, "sessions"), engine=engine,
        det_size=(det, det), batch_max=8, batch_wait_ms=5.0, transport=transport,
    )
    frame = camera_frames(rng, 1)[0]
    return server, encode_frame(frame, "raw-i420" if transport == "i420" else "raw", det)


def run_host_ceiling(
    clients: Sequence[int] = (1, 4, 8, 12),
    seconds: float = 12.0,
    det: int = 640,
    transport: str = "i420",
    device="cuda",
    on_row: Optional[Callable[[dict], None]] = None,
) -> dict:
    """`examples/serving_host_ceiling.py`'s run: per client count one
    measured run against `ceiling_server` (no settle run, as there). Each
    row leads with the JAX keys (`clients`, `req_s`, `p50_ms`, `engine`).
    Returns {"rows": [...], "server": ServedBench.report()}."""
    server, payload = ceiling_server(det, transport, device)
    bench = ServedBench(server, session="ceiling")
    rows = []
    try:
        for n in clients:
            got = bench.run(n, seconds, [payload])
            row = {"clients": n, "req_s": got.pop("req_per_sec"),
                   "p50_ms": got.pop("latency_p50_ms"), "engine": CEILING_ENGINE,
                   "transport": transport, **got}
            rows.append(row)
            if on_row is not None:
                on_row(row)
        report = bench.report()
    finally:
        bench.close()
    return {"rows": rows, "server": report}
