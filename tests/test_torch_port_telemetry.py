"""The port's telemetry held against the JAX package's: one timing script
(a patched `perf_counter`) through both monitors. Reports must be equal key
for key; values too, apart from the clock-of-day stamps, the process's RAM,
the device-memory slots and the model identifier. `FaultPlan` byte for
byte."""

import json
import os

import numpy as np
import pytest

from facerecognitionpipeline_tpu.telemetry import faults as jfaults
from facerecognitionpipeline_tpu.telemetry import monitor as jmon
from facerecognitionpipeline_tpu_torch.telemetry import faults as tfaults
from facerecognitionpipeline_tpu_torch.telemetry import monitor as tmon


class Ticker:
    """A `time` stand-in whose perf_counter follows a script."""

    def __init__(self, ticks):
        self.ticks = list(ticks)
        self.i = 0

    def perf_counter(self):
        v = self.ticks[self.i % len(self.ticks)] + 1000.0 * (self.i // len(self.ticks))
        self.i += 1
        return v

    def time(self):
        return 5_000.0 + self.perf_counter()


def _ticks(seed, n=4000):
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.uniform(0.0005, 0.03, n)).tolist()


_VOLATILE = {
    "start_time", "end_time", "duration_seconds", "requests_per_second", "average_fps",
    "baseline_mb", "peak_mb", "delta_mb", "cpu_count", "total_ram_gb", "timestamp",
    "current_cpu_ram_mb", "peak_cpu_ram_mb", "model_identifier",
}


def _keys(o):
    if isinstance(o, dict):
        return {k: _keys(v) for k, v in o.items()}
    if isinstance(o, list):
        return [_keys(v) for v in o]
    return type(o).__name__


def _stable(o):
    if isinstance(o, dict):
        return {k: _stable(v) for k, v in o.items() if k not in _VOLATILE}
    if isinstance(o, list):
        return [_stable(v) for v in o]
    return o


def _server_script(mon, rng):
    """Requests with and without a recognition segment."""
    replies = []
    for i in range(130):  # more than the window of 100
        t = mon.start_request()
        if i % 5:
            mon.mark_recognition_start(t)
            mon.mark_recognition_end(t)
        replies.append(mon.end_request(
            t, num_faces_processed=int(rng.integers(0, 5)),
            num_faces_recognized=int(rng.integers(0, 3)),
            num_faces_unknown=int(rng.integers(0, 2)),
        ))
    return replies


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("detailed", [False, True])
def test_server_monitor_reports_equal(monkeypatch, tmp_path, seed, detailed):
    out = {}
    for name, mod, kw in (("jax", jmon, {}), ("torch", tmon, {"device": "cpu"})):
        monkeypatch.setattr(mod, "time", Ticker(_ticks(seed)))
        mon = mod.PerformanceMonitorServer(
            model_identifier=f"ID_{name}", session_name="s", output_dir=str(tmp_path / name),
            latency_window_size=100, **kw,
        )
        mon.log_detailed_requests = detailed
        replies = _server_script(mon, np.random.default_rng(seed))
        stats = mon.get_current_stats()
        report = mon.finalize_session(client_report={"from": "client"})
        with open(tmp_path / name / "performance_report_server.json") as f:
            assert json.load(f) == report
        files = sorted(os.listdir(tmp_path / name))
        out[name] = (replies, stats, report, files)
    j, t = out["jax"], out["torch"]
    assert t[0] == j[0]                       # per-request answers, exactly
    assert _keys(t[1]) == _keys(j[1]) and _stable(t[1]) == _stable(j[1])
    assert _keys(t[2]) == _keys(j[2]) and _stable(t[2]) == _stable(j[2])
    assert t[3] == j[3] and "performance_report_client.json" in t[3]
    assert ("detailed_request_logs_server.json" in t[3]) == detailed
    gpu = t[2]["memory_usage"]["gpu_vram"]
    assert gpu == {"baseline_mb": 0.0, "peak_mb": 0.0, "delta_mb": 0.0,
                   "unit": "megabytes", "available": False}
    assert t[2]["latency_metrics"]["recognition"]["p95_ms"] > 0
    assert t[2]["request_statistics"]["total_requests_processed"] == 130


@pytest.mark.parametrize("seed", range(3))
def test_client_monitor_reports_equal(monkeypatch, tmp_path, seed):
    out = {}
    for name, mod in (("jax", jmon), ("torch", tmon)):
        monkeypatch.setattr(mod, "time", Ticker(_ticks(10 + seed)))
        mon = mod.PerformanceMonitorClient(session_name="c", output_dir=str(tmp_path / name))
        mon.log_detailed_frames = True
        rng = np.random.default_rng(seed)
        replies = []
        for i in range(75):
            t = mon.start_frame()
            mon.mark_capture_end(t)
            if i % 3 == 0:
                mon.mark_network_start(t)
                mon.mark_network_end(t)
            mon.mark_detection_end(t)
            replies.append(mon.end_frame(
                t, num_faces_detected=int(rng.integers(0, 4)),
                network_request_sent=i % 3 == 0,
            ))
        stats = mon.get_current_stats()
        report = mon.finalize_session()
        out[name] = (replies, stats, report, sorted(os.listdir(tmp_path / name)))
    j, t = out["jax"], out["torch"]
    assert t[0] == j[0]
    assert _keys(t[1]) == _keys(j[1]) and _stable(t[1]) == _stable(j[1])
    assert _keys(t[2]) == _keys(j[2]) and _stable(t[2]) == _stable(j[2])
    assert t[3] == j[3]
    assert len(t[2]["fps_metrics"]["fps_history"]) == 2
    assert t[2]["frame_statistics"]["total_network_requests"] == 25


def test_monitor_names_and_alias():
    import facerecognitionpipeline_tpu_torch.telemetry as tt

    assert tt.PerformanceMonitor is tt.PerformanceMonitorServer
    assert tmon.PerformanceMonitor is tmon.PerformanceMonitorServer
    assert tt.PerformanceMonitorClient is tmon.PerformanceMonitorClient


@pytest.mark.parametrize("window,with_range", [((), False), ((), True),
                                               ((1.0, 2.0, 9.5), False), ((3.0,), True)])
def test_latency_summary_equal(window, with_range):
    from collections import deque

    assert tmon._latency_summary(deque(window), with_range) == \
        jmon._latency_summary(deque(window), with_range)


def test_server_monitor_defaults_to_cuda_and_never_touches_it_on_cpu(monkeypatch, tmp_path):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmon.PerformanceMonitorServer("M", "s", str(tmp_path))

    def boom(*a, **k):
        raise AssertionError("torch.cuda touched by a CPU monitor")

    monkeypatch.setattr(torch.cuda, "memory_stats", boom)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", boom)
    mon = tmon.PerformanceMonitorServer("M", "s", str(tmp_path), device="cpu")
    mon.end_request(mon.start_request())
    assert mon.get_current_stats()["current_gpu_vram_mb"] == 0
    assert mon.finalize_session()["system_info"]["gpu_available"] is False


def test_device_memory_reads_the_allocator_of_a_cuda_device(monkeypatch):
    """On a CUDA device the slots come from torch.cuda's allocator counters
    (stubbed here: these tests run without a card)."""
    import torch

    mb = 1024 * 1024
    monkeypatch.setattr(torch.cuda, "memory_stats",
                        lambda d: {"allocated_bytes.all.current": 300 * mb})
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda d: 700 * mb)
    assert tmon._device_mem_mb(torch.device("cuda:0")) == (300.0, 700.0, True)
    assert tmon._device_mem_mb(torch.device("cpu")) == (0.0, 0.0, False)


def test_without_psutil_ram_figures_read_zero(monkeypatch):
    monkeypatch.setattr(tmon, "_psutil", lambda: None)
    assert tmon._cpu_ram_mb() == 0.0
    assert tmon._system_info() == {"cpu_count": 0, "total_ram_gb": 0}


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    import torch

    with tmon.profile_trace(str(tmp_path / "traces")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    (name,) = os.listdir(tmp_path / "traces")
    with open(tmp_path / "traces" / name) as f:
        trace = json.load(f)
    assert name.startswith("trace_") and trace["traceEvents"]


# ------------------------------------------------------------------ faults


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("rates", [(0.2, 0.3, 0.2), (0.0, 1.0, 0.0), (1.0, 0.0, 0.0),
                                   (0.0, 0.0, 0.0)])
def test_fault_plan_byte_for_byte(seed, rates):
    import base64

    drop, corrupt, delay = rates
    plans = [
        mod.FaultPlan(drop_rate=drop, corrupt_rate=corrupt, delay_rate=delay,
                      delay_seconds=0.0, seed=seed)
        for mod in (jfaults, tfaults)
    ]
    rng = np.random.default_rng(seed)
    for _ in range(40):
        payload = base64.b64encode(rng.bytes(int(rng.integers(0, 300)))).decode()
        got = [p.apply(payload) for p in plans]
        assert got[0] == got[1]
    assert plans[1].stats() == plans[0].stats()
    if rates == (0.0, 0.0, 0.0):
        assert plans[1].stats() == {"dropped": 0, "corrupted": 0, "delayed": 0}


class _Session:
    def __init__(self):
        self.posts, self.closed = [], False

    def get(self, url, **k):
        return ("get", url)

    def post(self, url, json=None, **k):
        self.posts.append((url, json, k))
        return ("post", url)

    def close(self):
        self.closed = True


def test_faulty_transport_wraps_any_session():
    import base64

    inner = _Session()
    frame = base64.b64encode(b"x" * 100).decode()
    t = tfaults.FaultyClientTransport(inner, tfaults.FaultPlan(corrupt_rate=1.0, seed=1))
    assert t.get("u") == ("get", "u")
    assert t.post("u/process_frame", json={"frame": frame, "frame_count": 3}, timeout=5)
    url, sent, kw = inner.posts[0]
    assert sent["frame"] != frame and sent["frame_count"] == 3 and kw == {"timeout": 5}
    t.post("u/init_session", json={"session_name": "s"})
    assert inner.posts[1][1] == {"session_name": "s"}  # non-frame posts pass untouched
    dropper = tfaults.FaultyClientTransport(inner, tfaults.FaultPlan(drop_rate=1.0))
    with pytest.raises(ConnectionError, match="injected frame drop"):
        dropper.post("u/process_frame", json={"frame": frame})
    t.close()
    assert inner.closed
