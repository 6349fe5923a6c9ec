"""Client/server performance telemetry with the reference's report schemas.

Counterpart of `facerecognitionpipeline_tpu/telemetry/monitor.py`: same
segment-timing API (start_request / mark_recognition_* / end_request;
start_frame / mark_capture_end / mark_detection_end / mark_network_* /
end_frame), same rolling windows (deque maxlen 100), same
`performance_report_{server,client}.json` schemas, key for key.

What differs from the JAX package:
* device memory comes from `torch.cuda.memory_stats(device)` (bytes the
  caching allocator has handed out now, and their peak), reported in the
  same `gpu_vram` slots with `available: bool`. The server monitor takes the
  server's `device`; on a CPU device it reports `available: False` and never
  touches `torch.cuda`;
* `profile_trace` wraps `torch.profiler.profile` and exports a Chrome trace
  into `log_dir`, with a `Tracer`'s spans beside the profiler's events;
* with its server's `Tracer` on (`telemetry/trace.py`), `end_request`
  records the request's spans: `server.request`, `server.recognition`, and
  `server.read_body` / `server.decode` where the raw route timed them, all
  with the id of the frame the request submitted. The reports do not change;
* `psutil` is looked up at the call; without it the RAM figures read 0;
* `torch` is imported by the server monitor and `profile_trace` only, so the
  camera client (which uses `PerformanceMonitorClient`) runs without it.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import deque
from datetime import datetime
from typing import Dict, Optional

import numpy as np

from facerecognitionpipeline_tpu_torch.telemetry.trace import Tracer


def _psutil():
    try:
        import psutil
    except ImportError:
        return None
    return psutil


def _cpu_ram_mb() -> float:
    psutil = _psutil()
    if psutil is None:
        return 0.0
    return psutil.Process().memory_info().rss / (1024 * 1024)


def _system_info() -> Dict:
    psutil = _psutil()
    if psutil is None:
        return {"cpu_count": 0, "total_ram_gb": 0}
    return {
        "cpu_count": psutil.cpu_count(),
        "total_ram_gb": psutil.virtual_memory().total / (1024 ** 3),
    }


def _device_mem_mb(device) -> tuple[float, float, bool]:
    """(allocated now, peak allocated, available) in MB from the caching
    allocator of a CUDA torch.device; (0, 0, False) for a CPU device."""
    if device.type != "cuda":
        return 0.0, 0.0, False
    import torch

    stats = torch.cuda.memory_stats(device)
    mb = 1024 * 1024
    return (
        stats.get("allocated_bytes.all.current", 0) / mb,
        torch.cuda.max_memory_allocated(device) / mb,
        True,
    )


def _latency_summary(window: deque, with_range: bool = False) -> Dict:
    if not window:
        out = {"average_ms": 0, "unit": "milliseconds"}
        if with_range:
            out.update({"max_ms": 0, "min_ms": 0})
        return out
    arr = np.asarray(window)
    out = {
        "average_ms": float(arr.mean()),
        "p50_ms": float(np.percentile(arr, 50)),
        "p95_ms": float(np.percentile(arr, 95)),
        "p99_ms": float(np.percentile(arr, 99)),
        "unit": "milliseconds",
    }
    if with_range:
        out["max_ms"] = float(arr.max())
        out["min_ms"] = float(arr.min())
    return out


#: the marker span the calling thread opens to put the program's spans on the profiler's clock
CLOCK_MARK = "trace.clock"


@contextlib.contextmanager
def profile_trace(log_dir: str, tracer: Optional[Tracer] = None):
    """Capture a torch.profiler trace (host and, with a card, device
    activity) around a code block; the Chrome trace lands in `log_dir`.
    With a `tracer` (started and stopped here), the program's spans join
    the trace: one row per thread, frame and step ids in `args`. The
    profiler records no `record_function` of the batcher's threads, and
    its clock is not `perf_counter_ns()`: the offset is read from a marker
    span the calling thread opens at the start. The device spans meet the
    profiler's kernels only in a process's first profiler session: in a
    later one the profiler's device timestamps slide against its host ones
    (0.2-0.7 ms on an H100)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    marks = []
    trace = None
    try:
        if tracer is not None:
            tracer.start()
            for _ in range(2):  # the first record_function pays a first-use cost
                t0 = time.perf_counter_ns()
                with torch.profiler.record_function(CLOCK_MARK):
                    pass
                marks.append((t0, time.perf_counter_ns()))
        yield prof
    finally:
        if marks:
            trace = tracer.stop()
        prof.stop()
        stamp = datetime.now().strftime("%Y%m%d_%H%M%S_%f")
        path = os.path.join(log_dir, f"trace_{stamp}.json")
        prof.export_chrome_trace(path)
        if trace is not None:
            _merge_spans(path, trace, marks)


def _merge_spans(path: str, trace, marks: list) -> None:
    """Write `trace`'s spans into the Chrome trace at `path`, on its clock:
    the last marker event's midpoint is the midpoint of the host readings
    taken around it."""
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    found = [e for e in events if e.get("name") == CLOCK_MARK and e.get("ph") == "X"]
    if not found:
        raise RuntimeError(f"the profiler recorded no {CLOCK_MARK!r} marker; spans not merged")
    m = max(found, key=lambda e: e["ts"])
    t0, t1 = marks[-1]
    offset_us = m["ts"] + m["dur"] / 2 - (t0 + t1) / 2e3
    pid = m["pid"]
    tids: dict = {}
    for s in trace.spans:
        if s.thread not in tids:
            tids[s.thread] = 10**9 + len(tids)
            events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tids[s.thread],
                           "args": {"name": f"spans: {s.thread}"}})
        ids = list(s.id) if isinstance(s.id, tuple) else s.id
        events.append({"ph": "X", "cat": "program_span", "name": s.name, "pid": pid,
                       "tid": tids[s.thread], "ts": s.start_ns / 1e3 + offset_us,
                       "dur": (s.end_ns - s.start_ns) / 1e3,
                       "args": {"id": ids, "parent": s.parent}})
    doc["programCounters"] = trace.counters
    with open(path, "w") as f:
        json.dump(doc, f)


class PerformanceMonitorServer:
    """Request-path telemetry for the recognition server."""

    def __init__(
        self,
        model_identifier: str,
        session_name: str,
        output_dir: str,
        enable_gpu_monitoring: bool = True,
        latency_window_size: int = 100,
        device="cuda",
        tracer: Optional[Tracer] = None,
    ):
        """device: the device whose memory the `gpu_vram` slots report (the
        server's); 'cuda' raises without a card, CPU servers pass 'cpu'.
        tracer: the server's span recorder (an off one of its own if None)."""
        # torch is imported here, not by the module: the camera client
        # shares this module and needs no torch
        from facerecognitionpipeline_tpu_torch.utils.device import resolve_device

        self.device = resolve_device(device)
        self.tracer = tracer if tracer is not None else Tracer()
        self.model_identifier = model_identifier
        self.session_name = session_name
        self.output_dir = output_dir
        os.makedirs(output_dir, exist_ok=True)

        self.session_start = datetime.now()
        self.session_end: Optional[datetime] = None
        self.total_requests = 0
        self.total_faces_processed = 0
        self.total_faces_recognized = 0
        self.total_faces_unknown = 0

        self.latency_recognition: deque = deque(maxlen=latency_window_size)
        self.latency_network: deque = deque(maxlen=latency_window_size)
        self.latency_e2e_server: deque = deque(maxlen=latency_window_size)

        self.baseline_cpu_ram_mb = _cpu_ram_mb()
        self.peak_cpu_ram_mb = self.baseline_cpu_ram_mb
        mem, _, available = _device_mem_mb(self.device)
        self.enable_gpu_monitoring = enable_gpu_monitoring and available
        self.baseline_gpu_vram_mb = mem if self.enable_gpu_monitoring else 0.0
        self.peak_gpu_vram_mb = self.baseline_gpu_vram_mb

        self.detailed_request_logs: list = []
        self.log_detailed_requests = False
        self.lock = threading.Lock()

    # ------------------------------------------------------------- timings

    def start_request(self) -> Dict[str, float]:
        return {"request_start": time.perf_counter(), "recognition_start": None}

    def mark_recognition_start(self, timings: Dict) -> None:
        timings["recognition_start"] = time.perf_counter()

    def mark_recognition_end(self, timings: Dict) -> None:
        timings["recognition_end"] = time.perf_counter()

    def end_request(
        self,
        timings: Dict,
        num_faces_processed: int = 0,
        num_faces_recognized: int = 0,
        num_faces_unknown: int = 0,
    ) -> Dict[str, float]:
        with self.lock:
            request_end = time.perf_counter()
            rec_ms = 0.0
            if timings.get("recognition_start") and timings.get("recognition_end"):
                rec_ms = (
                    timings["recognition_end"] - timings["recognition_start"]
                ) * 1000
                self.latency_recognition.append(rec_ms)
            e2e_ms = (request_end - timings["request_start"]) * 1000
            self.latency_e2e_server.append(e2e_ms)
            net_ms = e2e_ms - rec_ms
            self.latency_network.append(net_ms)

            self.total_requests += 1
            self.total_faces_processed += num_faces_processed
            self.total_faces_recognized += num_faces_recognized
            self.total_faces_unknown += num_faces_unknown

            self.peak_cpu_ram_mb = max(self.peak_cpu_ram_mb, _cpu_ram_mb())
            if self.enable_gpu_monitoring:
                _, peak, _ = _device_mem_mb(self.device)
                self.peak_gpu_vram_mb = max(self.peak_gpu_vram_mb, peak)

            if self.tracer.on:
                self._record_spans(timings, request_end)
            if self.log_detailed_requests:
                self.detailed_request_logs.append(
                    {
                        "request_number": self.total_requests,
                        "timestamp": datetime.now().isoformat(),
                        "latency_e2e_server_ms": e2e_ms,
                        "latency_recognition_ms": rec_ms,
                        "latency_network_ms": net_ms,
                        "faces_processed": num_faces_processed,
                        "faces_recognized": num_faces_recognized,
                        "faces_unknown": num_faces_unknown,
                    }
                )
            return {
                "latency_e2e_server_ms": e2e_ms,
                "latency_recognition_ms": rec_ms,
                "latency_network_ms": net_ms,
            }

    def _record_spans(self, timings: Dict, request_end: float) -> None:
        """The request's spans, children of `server.request`, under the id of
        the frame it submitted (-1 if it submitted none)."""
        frame = timings.get("frame", -1)
        tr = self.tracer
        tr.span("server.request", int(timings["request_start"] * 1e9), int(request_end * 1e9),
                frame)
        marks = [(n, timings.get(k)) for n, k in (("server.read_body", "read_body"),
                                                  ("server.decode", "decode"))]
        if timings.get("recognition_start") and timings.get("recognition_end"):
            marks.append(("server.recognition",
                          (timings["recognition_start"], timings["recognition_end"])))
        for name, pair in marks:
            if pair is not None:
                tr.span(name, int(pair[0] * 1e9), int(pair[1] * 1e9), frame, frame)

    # --------------------------------------------------------------- reports

    def get_current_stats(self) -> Dict:
        with self.lock:
            def avg(d):
                return sum(d) / len(d) if d else 0

            mem = _device_mem_mb(self.device)[0] if self.enable_gpu_monitoring else 0
            return {
                "total_requests": self.total_requests,
                "total_faces_processed": self.total_faces_processed,
                "total_faces_recognized": self.total_faces_recognized,
                "total_faces_unknown": self.total_faces_unknown,
                "avg_latency_recognition_ms": avg(self.latency_recognition),
                "avg_latency_network_ms": avg(self.latency_network),
                "avg_latency_e2e_server_ms": avg(self.latency_e2e_server),
                "current_cpu_ram_mb": _cpu_ram_mb(),
                "peak_cpu_ram_mb": self.peak_cpu_ram_mb,
                "current_gpu_vram_mb": mem,
                "peak_gpu_vram_mb": self.peak_gpu_vram_mb
                if self.enable_gpu_monitoring
                else 0,
            }

    def finalize_session(self, client_report: Optional[Dict] = None) -> Dict:
        self.session_end = datetime.now()
        duration = (self.session_end - self.session_start).total_seconds()

        with self.lock:
            # a request thread may still be inside end_request appending to
            # the latency deques; iterating them unlocked raises 'deque
            # mutated during iteration' mid-shutdown
            data = self._build_report(duration)

        report_path = os.path.join(self.output_dir, "performance_report_server.json")
        with open(report_path, "w") as f:
            json.dump(data, f, indent=2)
        if client_report:
            with open(
                os.path.join(self.output_dir, "performance_report_client.json"), "w"
            ) as f:
                json.dump(client_report, f, indent=2)
        if self.log_detailed_requests and self.detailed_request_logs:
            with open(
                os.path.join(self.output_dir, "detailed_request_logs_server.json"),
                "w",
            ) as f:
                json.dump(self.detailed_request_logs, f, indent=2)
        print(
            f"SERVER PERFORMANCE: {self.total_requests} requests, "
            f"rec avg {data['latency_metrics']['recognition']['average_ms']:.2f} ms, "
            f"e2e avg {data['latency_metrics']['end_to_end_server']['average_ms']:.2f} ms "
            f"-> {report_path}"
        )
        return data

    def _build_report(self, duration: float) -> Dict:
        """Reference report schema; caller holds self.lock."""
        return {
            "session_info": {
                "session_name": self.session_name,
                "model_identifier": self.model_identifier,
                "start_time": self.session_start.isoformat(),
                "end_time": self.session_end.isoformat(),
                "duration_seconds": duration,
                "component": "server",
            },
            "request_statistics": {
                "total_requests_processed": self.total_requests,
                "total_faces_processed": self.total_faces_processed,
                "total_faces_recognized": self.total_faces_recognized,
                "total_faces_unknown": self.total_faces_unknown,
                "avg_faces_per_request": self.total_faces_processed
                / self.total_requests
                if self.total_requests
                else 0,
                "recognition_rate": self.total_faces_recognized
                / self.total_faces_processed
                if self.total_faces_processed
                else 0,
                "requests_per_second": self.total_requests / duration
                if duration > 0
                else 0,
            },
            "latency_metrics": {
                "recognition": _latency_summary(self.latency_recognition, True),
                "network_overhead": _latency_summary(self.latency_network),
                "end_to_end_server": _latency_summary(self.latency_e2e_server),
            },
            "memory_usage": {
                "cpu_ram": {
                    "baseline_mb": self.baseline_cpu_ram_mb,
                    "peak_mb": self.peak_cpu_ram_mb,
                    "delta_mb": self.peak_cpu_ram_mb - self.baseline_cpu_ram_mb,
                    "unit": "megabytes",
                },
                "gpu_vram": {
                    "baseline_mb": self.baseline_gpu_vram_mb,
                    "peak_mb": self.peak_gpu_vram_mb,
                    "delta_mb": self.peak_gpu_vram_mb - self.baseline_gpu_vram_mb,
                    "unit": "megabytes",
                    "available": self.enable_gpu_monitoring,
                },
            },
            "system_info": {
                **_system_info(),
                "gpu_available": self.enable_gpu_monitoring,
            },
        }


# The name the reference live app imports for the server monitor.
PerformanceMonitor = PerformanceMonitorServer


class PerformanceMonitorClient:
    """Frame-path telemetry for the camera client."""

    def __init__(
        self,
        session_name: str,
        output_dir: str,
        latency_window_size: int = 100,
    ):
        self.session_name = session_name
        self.output_dir = output_dir
        os.makedirs(output_dir, exist_ok=True)

        self.session_start = datetime.now()
        self.session_end: Optional[datetime] = None
        self.total_frames = 0
        self.total_faces_detected = 0
        self.total_network_requests = 0

        self.latency_capture: deque = deque(maxlen=latency_window_size)
        self.latency_detection: deque = deque(maxlen=latency_window_size)
        self.latency_network_send: deque = deque(maxlen=latency_window_size)
        self.latency_e2e_client: deque = deque(maxlen=latency_window_size)

        self.fps_start_time = time.time()
        self.fps_frame_count = 0
        self.current_fps = 0.0
        self.fps_history: list = []

        self.baseline_cpu_ram_mb = _cpu_ram_mb()
        self.peak_cpu_ram_mb = self.baseline_cpu_ram_mb
        self.detailed_frame_logs: list = []
        self.log_detailed_frames = False
        self.lock = threading.Lock()

    def start_frame(self) -> Dict[str, float]:
        now = time.perf_counter()
        return {"frame_start": now, "capture_start": now}

    def mark_capture_end(self, timings: Dict) -> None:
        timings["capture_end"] = time.perf_counter()
        timings["detection_start"] = time.perf_counter()

    def mark_detection_end(self, timings: Dict) -> None:
        timings["detection_end"] = time.perf_counter()

    def mark_network_start(self, timings: Dict) -> None:
        timings["network_start"] = time.perf_counter()

    def mark_network_end(self, timings: Dict) -> None:
        timings["network_end"] = time.perf_counter()

    def end_frame(
        self,
        timings: Dict,
        num_faces_detected: int = 0,
        network_request_sent: bool = False,
    ) -> Dict[str, float]:
        with self.lock:
            frame_end = time.perf_counter()
            cap_ms = (
                timings.get("capture_end", timings["frame_start"])
                - timings.get("capture_start", timings["frame_start"])
            ) * 1000
            det_ms = (
                timings.get("detection_end", frame_end)
                - timings.get("detection_start", frame_end)
            ) * 1000
            net_ms = 0.0
            if timings.get("network_start") and timings.get("network_end"):
                net_ms = (timings["network_end"] - timings["network_start"]) * 1000
                self.latency_network_send.append(net_ms)
            e2e_ms = (frame_end - timings["frame_start"]) * 1000

            self.latency_capture.append(cap_ms)
            self.latency_detection.append(det_ms)
            self.latency_e2e_client.append(e2e_ms)
            self.total_frames += 1
            self.total_faces_detected += num_faces_detected
            self.total_network_requests += network_request_sent

            self.fps_frame_count += 1
            if self.fps_frame_count >= 30:
                now = time.time()
                elapsed = now - self.fps_start_time
                self.current_fps = self.fps_frame_count / elapsed if elapsed else 0
                self.fps_history.append(
                    {
                        "timestamp": now,
                        "fps": self.current_fps,
                        "frame_number": self.total_frames,
                    }
                )
                self.fps_start_time = now
                self.fps_frame_count = 0

            self.peak_cpu_ram_mb = max(self.peak_cpu_ram_mb, _cpu_ram_mb())
            if self.log_detailed_frames:
                self.detailed_frame_logs.append(
                    {
                        "frame_number": self.total_frames,
                        "timestamp": datetime.now().isoformat(),
                        "latency_e2e_client_ms": e2e_ms,
                        "latency_capture_ms": cap_ms,
                        "latency_detection_ms": det_ms,
                        "latency_network_send_ms": net_ms,
                        "faces_detected": num_faces_detected,
                    }
                )
            return {
                "latency_e2e_client_ms": e2e_ms,
                "latency_capture_ms": cap_ms,
                "latency_detection_ms": det_ms,
                "latency_network_send_ms": net_ms,
                "current_fps": self.current_fps,
            }

    def get_current_stats(self) -> Dict:
        with self.lock:
            def avg(d):
                return sum(d) / len(d) if d else 0

            return {
                "total_frames": self.total_frames,
                "total_faces_detected": self.total_faces_detected,
                "total_network_requests": self.total_network_requests,
                "current_fps": self.current_fps,
                "avg_latency_capture_ms": avg(self.latency_capture),
                "avg_latency_detection_ms": avg(self.latency_detection),
                "avg_latency_network_send_ms": avg(self.latency_network_send),
                "avg_latency_e2e_client_ms": avg(self.latency_e2e_client),
                "current_cpu_ram_mb": _cpu_ram_mb(),
                "peak_cpu_ram_mb": self.peak_cpu_ram_mb,
            }

    def finalize_session(self) -> Dict:
        self.session_end = datetime.now()
        duration = (self.session_end - self.session_start).total_seconds()
        avg_fps = self.total_frames / duration if duration > 0 else 0

        # hold the lock while reading the latency deques: the capture loop
        # may still be appending (deque mutated during iteration otherwise)
        with self.lock:
            data = self._build_report(duration, avg_fps)
        with open(
            os.path.join(self.output_dir, "performance_report_client_temp.json"), "w"
        ) as f:
            json.dump(data, f, indent=2)
        if self.log_detailed_frames and self.detailed_frame_logs:
            with open(
                os.path.join(self.output_dir, "detailed_frame_logs_client.json"), "w"
            ) as f:
                json.dump(self.detailed_frame_logs, f, indent=2)
        print(
            f"CLIENT PERFORMANCE: {self.total_frames} frames, avg fps {avg_fps:.2f}"
        )
        return data

    def _build_report(self, duration: float, avg_fps: float) -> Dict:
        """Reference report schema; caller holds self.lock."""
        return {
            "session_info": {
                "session_name": self.session_name,
                "start_time": self.session_start.isoformat(),
                "end_time": self.session_end.isoformat(),
                "duration_seconds": duration,
                "component": "client",
            },
            "frame_statistics": {
                "total_frames_processed": self.total_frames,
                "total_faces_detected": self.total_faces_detected,
                "total_network_requests": self.total_network_requests,
                "avg_faces_per_frame": self.total_faces_detected / self.total_frames
                if self.total_frames
                else 0,
            },
            "fps_metrics": {
                "average_fps": avg_fps,
                "current_fps": self.current_fps,
                "fps_history": self.fps_history,
            },
            "latency_metrics": {
                "capture": _latency_summary(self.latency_capture),
                "detection": _latency_summary(self.latency_detection, True),
                "network_send": _latency_summary(self.latency_network_send),
                "end_to_end_client": _latency_summary(self.latency_e2e_client),
            },
            "memory_usage": {
                "cpu_ram": {
                    "baseline_mb": self.baseline_cpu_ram_mb,
                    "peak_mb": self.peak_cpu_ram_mb,
                    "delta_mb": self.peak_cpu_ram_mb - self.baseline_cpu_ram_mb,
                    "unit": "megabytes",
                }
            },
            "system_info": _system_info(),
        }
