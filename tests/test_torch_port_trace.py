"""The port's span recorder (`telemetry/trace.py`) over a `DeviceBatcher` on
the CPU: off it records and allocates nothing and reads no clock; on, a
frame's four segments add up to its latency, the counters count what the
engine saw, and `profile_trace` puts the batcher's spans on the profiler's
clock. The card's half is in `tests/test_torch_port_cuda.py`."""

import gc
import json
import os
import threading
import time
import tracemalloc

import numpy as np
import pytest
import torch

from facerecognitionpipeline_tpu_torch.pipeline import step_graph
from facerecognitionpipeline_tpu_torch.serve import batcher as batcher_mod
from facerecognitionpipeline_tpu_torch.serve.batcher import DeviceBatcher
from facerecognitionpipeline_tpu_torch.telemetry import monitor as tmon
from facerecognitionpipeline_tpu_torch.telemetry import trace as ttrace
from facerecognitionpipeline_tpu_torch.telemetry.trace import Tracer

SHAPE = (8, 8, 3)


class _Engine:
    """A CPU engine whose step sleeps `step_s` and answers per frame."""

    device = torch.device("cpu")

    def __init__(self, step_s=0.002):
        self.step_s = step_s
        self.calls = 0

    def host_frame_shape(self, h, w):
        return (h, w, 3)

    def process_frames(self, frames, templates, valid, gallery_k=3, rotation=0):
        self.calls += 1
        time.sleep(self.step_s)
        return {"match_scores": frames.float().mean(dim=(1, 2, 3))[:, None].repeat(1, gallery_k),
                "face_valid": torch.ones(frames.shape[0], dtype=torch.bool)}


def _gallery():
    return torch.zeros(4, 8), torch.ones(4, dtype=torch.bool)


def _batcher(engine=None, tracer=None, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_wait_ms", 2.0)
    return DeviceBatcher(engine or _Engine(), _gallery, tracer=tracer, **kw)


def _frames(n, seed=0):
    return np.random.default_rng(seed).integers(0, 255, (n, *SHAPE), dtype=np.uint8)


def _traffic(b, frames, threads=3, gap_s=0.001):
    """Frames from `threads` client threads; each future's latency is stamped
    by a done-callback from just before its submit()."""
    out, lock = [], threading.Lock()

    def client(part):
        for f in part:
            t0 = time.perf_counter_ns()
            fut = b.submit(f)
            fut.add_done_callback(
                lambda u, t0=t0: (lock.acquire(), out.append((u, time.perf_counter_ns() - t0)),
                                  lock.release()))
            fut.result(timeout=30)
            time.sleep(gap_s)

    ts = [threading.Thread(target=client, args=(frames[i::threads],)) for i in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts)
    return out


def test_off_the_batcher_records_allocates_and_times_nothing(monkeypatch):
    class NoNs:
        perf_counter = staticmethod(time.perf_counter)

        @staticmethod
        def perf_counter_ns():
            raise AssertionError("a clock read with the tracer off")

    monkeypatch.setattr(batcher_mod, "time", NoNs)
    tr = Tracer()
    b = _batcher(tracer=tr)
    b.start()
    try:
        b.submit(_frames(1)[0]).result(timeout=30)  # first-use costs outside the count
        tracemalloc.start()
        try:
            answers = _traffic(b, _frames(24))
            snap = tracemalloc.take_snapshot()
        finally:
            tracemalloc.stop()
    finally:
        b.stop()
    assert len(answers) == 24 and all(u.exception() is None for u, _ in answers)
    assert all(u.id == -1 for u, _ in answers)
    assert tr._spans == [] and tr._gc not in gc.callbacks
    here = snap.filter_traces([tracemalloc.Filter(True, ttrace.__file__)])
    assert sum(s.size for s in here.statistics("filename")) == 0
    assert b.steps.count >= 6 and b.frames.count == 25  # counters count off too


class _Stamped(batcher_mod._Frame):
    """A frame's future that stamps its latency in a done-callback from its
    making in submit() (a callback added after submit() returns would run
    late, on the client's thread, where the frame was already answered)."""

    def __init__(self):
        super().__init__()
        self.t0 = time.perf_counter_ns()
        self.add_done_callback(self._stamp)

    @staticmethod
    def _stamp(fut):
        fut.latency_ns = time.perf_counter_ns() - fut.t0


def test_a_frames_segments_add_up_to_its_latency(monkeypatch):
    monkeypatch.setattr(batcher_mod, "_Frame", _Stamped)
    eng = _Engine()
    b = _batcher(eng)
    b.start()
    try:
        _traffic(b, _frames(4))  # warm
        calls0 = eng.calls
        b.tracer.start()
        answers = _traffic(b, _frames(60, seed=1))
        trace = b.tracer.stop()
    finally:
        b.stop()
    seg = ttrace.frame_segments(trace)
    assert seg.shape == (60, 5)
    assert (np.diff(seg, axis=1) >= 0).all()  # on the CPU the step runs inside the enqueue
    by_submit = {int(r[0]): r for r in seg}
    ingress = {s.id: s.start_ns for s in trace.spans if s.name == "batcher.ingress"}
    for fut, _ in answers:
        row = by_submit[ingress[fut.id]]
        assert abs(np.diff(row).sum() - fut.latency_ns) < 1e6, (row, fut.latency_ns)
    assert trace.counters["batcher.steps"] == eng.calls - calls0
    assert trace.counters["batcher.frames"] == 60
    assert trace.counters["dropped"] == 0
    names = {s.name for s in trace.spans}
    assert {"batcher.ingress", "batcher.upload", "batcher.ready", "batcher.window",
            "batcher.provider", "batcher.enqueue", "step.device", "batcher.d2h",
            "batcher.fanout"} <= names
    steps = {s.id for s in trace.spans if s.name == "step.device"}
    assert {s.parent for s in trace.spans if s.name == "batcher.fanout"} <= steps
    got = ttrace.summary(trace)
    assert got["frames"] == 60 and got["carry_pct"] is not None
    assert 0 <= got["step_idle_pct"] <= 100
    assert got["step_device_ms"] >= 2.0  # the fake step's sleep
    idle = ttrace.idle_split(trace)
    assert 0 < idle["idle_s"] < idle["window_s"]
    assert idle["covered_s"] <= idle["idle_s"] + 1e-9


def test_a_group_that_overflows_the_step_is_carried_once(monkeypatch):
    """max_batch 4: a group of 3 and then one of 2 (queued while the first
    uploads) give two steps, the second group carried once; each group's
    `batcher.ready` span is recorded once, by the dispatch that took it."""
    eng = _Engine()
    b = _batcher(eng, max_wait_ms=500.0)
    plain = b._upload
    first = threading.Event()

    def slow(frames):
        if not first.is_set():
            first.set()
            time.sleep(0.3)
        return plain(frames)

    monkeypatch.setattr(b, "_upload", slow)
    b.tracer.start()
    futs = [b.submit(f) for f in _frames(3)]  # queued before the threads start: one group
    b.start()
    try:
        assert first.wait(10)
        futs += [b.submit(f) for f in _frames(2, seed=2)]  # queued while the first uploads
        for f in futs:
            f.result(timeout=30)
        trace = b.tracer.stop()
    finally:
        b.stop()
    assert trace.counters["batcher.carried"] == 1
    assert trace.counters["batcher.steps"] == eng.calls == 2
    assert trace.counters["batcher.frames"] == 5
    names = [s.name for s in trace.spans]
    assert names.count("batcher.ready") == names.count("batcher.upload") == 2
    ready = {s.id: s.parent for s in trace.spans if s.name == "batcher.ready"}
    assert sorted(ready.values()) == [1, 2] and ready[(3, 4)] == 2


def test_a_collection_in_the_trace_is_a_gc_span():
    tr = Tracer()
    tr.start()
    gc.collect()
    trace = tr.stop()
    assert any(s.name == "gc.gen2" and s.end_ns >= s.start_ns for s in trace.spans)
    assert tr._gc not in gc.callbacks


def test_a_full_store_drops_spans_and_reads_none():
    b = _batcher(tracer=Tracer(capacity=16))
    b.start()
    try:
        b.tracer.start()
        _traffic(b, _frames(24))
        trace = b.tracer.stop()
    finally:
        b.stop()
    assert len(trace.spans) == 16 and trace.counters["dropped"] > 0
    assert ttrace.frame_segments(trace) is None
    assert ttrace.summary(trace) is None and ttrace.idle_split(trace) is None


def test_profile_trace_puts_the_batchers_spans_on_the_profilers_clock(tmp_path):
    b = _batcher(max_wait_ms=1.0)
    b.start()
    ids = []
    try:
        b.submit(_frames(1)[0]).result(timeout=30)
        with tmon.profile_trace(str(tmp_path), tracer=b.tracer):
            for f in _frames(6, seed=3):
                with torch.profiler.record_function("client.frame"):
                    fut = b.submit(f)
                    fut.result(timeout=30)
                ids.append(fut.id)
                time.sleep(0.005)
    finally:
        b.stop()
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as f:
        doc = json.load(f)
    ev = doc["traceEvents"]
    client = sorted((e for e in ev if e.get("name") == "client.frame"), key=lambda e: e["ts"])
    spans = [e for e in ev if e.get("cat") == "program_span"]
    ingress = {e["args"]["id"]: e for e in spans if e["name"] == "batcher.ingress"}
    fanout = {e["args"]["id"]: e for e in spans if e["name"] == "batcher.fanout"}
    assert len(client) == len(ids) == 6
    for c, i in zip(client, ids):
        # us: submit(), stamped on this thread inside the marked work and
        # recorded by the transfer thread, opens the frame; its answer,
        # stamped by the completion thread, ends it before this thread wakes
        assert abs(ingress[i]["ts"] - c["ts"]) < 500
        assert ingress[i]["ts"] < fanout[i]["ts"] + fanout[i]["dur"] < c["ts"] + c["dur"] + 500
    rows = {e["args"]["name"] for e in ev if e.get("ph") == "M" and e.get("name") == "thread_name"}
    assert {"spans: batcher-transfer", "spans: batcher-dispatch",
            "spans: batcher-complete"} <= rows
    assert doc["programCounters"]["batcher.frames"] == 6


class _FakeCapture:
    """An eager stand-in for `CudaCapture` (see test_torch_port_step_graph)."""

    def __call__(self, fn, device):
        outputs = fn()

        def replay():
            fresh = fn()
            for k in outputs:
                outputs[k].copy_(fresh[k])

        return step_graph.Captured(replay, outputs, (), 0, 0.0)


class _GraphEngine(_Engine):
    """A CPU engine whose process_frames goes through `StepGraphs`."""

    class _Sh:
        device = torch.device("cpu")

    def __init__(self):
        super().__init__(step_s=0.0)
        self._shards = [self._Sh()]
        self._graphs = step_graph.StepGraphs(self, capture=_FakeCapture())

    def _shard_part(self, i, frames, rotation, templates, valid, k):
        return {"match_scores": frames.float().mean(dim=(1, 2, 3))[:, None].repeat(1, k)
                + templates.sum(),
                "face_valid": torch.ones(frames.shape[0], dtype=torch.bool)}

    def _combine(self, parts, templates, valid, k):
        return parts[0]

    def process_frames(self, frames, templates, valid, gallery_k=3, rotation=0):
        self.calls += 1
        return self._graphs.run(torch.as_tensor(frames), templates, valid, gallery_k, rotation)


def test_graph_captures_in_the_trace():
    """A warmed batcher captures nothing in traffic; a new gallery operand
    counts one capture (single frames: bucket 1 only)."""
    eng = _GraphEngine()
    gallery = list(_gallery())
    b = DeviceBatcher(eng, lambda: tuple(gallery), max_batch=4, max_wait_ms=1.0)
    b.warmup(SHAPE[:2])
    assert len(eng._graphs.captures) == 2  # buckets 1 and 4
    b.start()
    try:
        b.tracer.start()
        for f in _frames(5):
            b.submit(f).result(timeout=30)
        warm = b.tracer.stop()
        gallery[0] = torch.ones(4, 8)
        b.tracer.start()
        for f in _frames(5):
            b.submit(f).result(timeout=30)
        fresh = b.tracer.stop()
    finally:
        b.stop()
    assert warm.counters["graphs.captures"] == 0 and warm.counters["batcher.steps"] == 5
    assert fresh.counters["graphs.captures"] == 1


def test_the_server_reports_the_batchers_steps(monkeypatch):
    from facerecognitionpipeline_tpu_torch.serve import server as server_mod

    b = _batcher()
    b.steps.bump(7)
    b._dispatch_count = 3  # the rotation's own count is not the report's
    fake = type("S", (), {"batcher": b, "_ready_launches": server_mod.launch_counts()})()
    assert server_mod.FaceRecognitionServer.launch_report(fake)["steps"] == 7


def test_a_raw_request_and_its_frame_form_one_tree(tmp_path):
    """Through the HTTP layer on /process_frame_raw with a session, the
    monitor records `server.request`, `server.read_body`, `server.decode`
    and `server.recognition` under the id of the frame the request
    submitted, the id its batcher spans carry."""
    import http.client

    from facerecognitionpipeline_tpu_torch.gallery.manager import GalleryManager
    from facerecognitionpipeline_tpu_torch.models.detector import MTCNNDetector
    from facerecognitionpipeline_tpu_torch.pipeline.embedder import FaceEmbedder
    from facerecognitionpipeline_tpu_torch.pipeline.engine import RecognitionEngine
    from facerecognitionpipeline_tpu_torch.serve import rawproto
    from facerecognitionpipeline_tpu_torch.serve.server import FaceRecognitionServer, serve

    det = (96, 96)
    weights = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "pretrained", "mtcnn_synthetic.npz")
    engine = RecognitionEngine(
        MTCNNDetector(det_size=det, max_faces=2, min_face_size=20, weights_path=weights,
                      device="cpu"),
        FaceEmbedder(architecture="ir_micro", random_ok=True, device="cpu"), top_k=3)
    srv = FaceRecognitionServer(
        gallery=GalleryManager(gallery_path=str(tmp_path / "g.pkl"), verbose=False,
                               device="cpu"),
        output_dir=str(tmp_path / "sessions"), engine=engine, det_size=det, batch_max=2,
        batch_wait_ms=1.0, device="cpu")
    srv._create_session("traced")
    httpd = serve(srv, "127.0.0.1", 0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    body = _frames(1, seed=5)[0].repeat(12, 0).repeat(12, 1)[:96, :96].tobytes()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=60)
        srv.tracer.start()
        for i in range(3):
            conn.request("POST", "/process_frame_raw", body=body, headers={
                rawproto.HEADER_FORMAT: "rgb24", rawproto.HEADER_WIDTH: "96",
                rawproto.HEADER_HEIGHT: "96", rawproto.HEADER_SCALE: "1.0",
                rawproto.HEADER_COUNT: str(i), "Content-Type": "application/octet-stream"})
            r = conn.getresponse()
            r.read()
            assert r.status == 200
        trace = srv.tracer.stop()
        conn.close()
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.shutdown()
        t.join(timeout=30)
    by = {}
    for s in trace.spans:
        by.setdefault(s.name, []).append(s)
    frames = sorted(s.id for s in by["batcher.ingress"])
    assert len(frames) == 3
    for name in ("server.request", "server.read_body", "server.decode", "server.recognition"):
        assert sorted(s.id for s in by[name]) == frames, name
    for req in by["server.request"]:
        ingress = next(s for s in by["batcher.ingress"] if s.id == req.id)
        fanout = next(s for s in by["batcher.fanout"] if s.id == req.id)
        assert req.start_ns <= ingress.start_ns <= fanout.end_ns <= req.end_ns
    assert srv.perf_monitor.get_current_stats()["total_requests"] == 3
