"""Per-layer readings taken on the chip after the window, for --trace 1.

A stage is timed as its own CUDA graph (captured after two eager calls on
a side stream, each graph with a memory pool of its own), `CHAIN` replays
chained between two CUDA events, the total over the count. The step is the
engine's own graph, replayed through `process_frames` as the batcher calls
it. Kernel device times come from torch.profiler over `PROFILED` step
replays in this process. The trace of the 3 s of the cell's
traffic traced after the window (`device_activity`) give the busy
seconds, the idle gaps and the device operations that took the most time.
"""

from __future__ import annotations

import statistics
import time

import torch

CHAIN = 20
PROFILED = 10


def chained_ms(run, device, chain: int = CHAIN, warm: int = 2) -> float:
    for _ in range(warm):
        run()
    torch.cuda.synchronize(device)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(chain):
        run()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / chain


def capture(fn, device):
    """fn() as a CUDA graph; returns replay()."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.inference_mode():
        with torch.cuda.stream(side):
            for _ in range(2):
                fn()
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            fn()
    torch.cuda.synchronize(device)
    return graph.replay


class Stages:
    """Lazily taken stage readings of one built system at batch B."""

    def __init__(self, system, frames_dev: torch.Tensor, top_k: int, dtype: torch.dtype):
        self.sys = system
        self.dtype = dtype
        self.frames = frames_dev
        self.k = top_k
        self.dev = frames_dev.device
        self._cache: dict = {}

    def _once(self, key, fn):
        if key not in self._cache:
            self._cache[key] = fn()
        return self._cache[key]

    def _snapshot(self):
        return self.sys.gallery.device_snapshot()

    def step_run(self):
        t, v, _ = self._snapshot()
        eng = self.sys.engine
        return lambda: eng.process_frames(self.frames, t, v, gallery_k=self.k)

    def step_ms(self) -> float:
        return self._once("step", lambda: chained_ms(self.step_run(), self.dev))

    def detect_ms(self) -> float:
        det = self.sys.engine.detector
        fr = self.frames.float()
        return self._once("detect", lambda: chained_ms(
            capture(lambda: det.detect_device(fr), self.dev), self.dev))

    def embed_ms(self) -> float:
        def measure():
            out = self.step_run()()
            aligned = out["aligned"]
            b, f, s = aligned.shape[:3]
            x = ((aligned.flip(-1).float() - 127.5) / 127.5).to(
                self.dtype).reshape(b * f, s, s, 3)
            emb = self.sys.engine.embedder
            return chained_ms(capture(lambda: emb.forward(x), self.dev), self.dev)
        return self._once("embed", measure)

    def kernel_ms(self) -> dict:
        """{profiler kernel name: device ms per step} over PROFILED replays."""
        def measure():
            from torch.autograd import DeviceType
            from torch.profiler import ProfilerActivity, profile

            run = self.step_run()
            run()
            torch.cuda.synchronize(self.dev)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(PROFILED):
                    run()
                torch.cuda.synchronize(self.dev)
            out: dict = {}
            for e in prof.key_averages():
                if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
                    out[e.key] = out.get(e.key, 0.0) + e.self_device_time_total / 1e3 / PROFILED
            return out
        return self._once("kernels", measure)

    def snapshot_ms(self) -> float:
        def measure():
            times = []
            for _ in range(20):
                t0 = time.perf_counter()
                self.sys.gallery.device_snapshot()
                times.append((time.perf_counter() - t0) * 1e3)
            return statistics.median(times)
        return self._once("snapshot", measure)


def _intervals(prof) -> tuple:
    """([(start, end, name)] of device operations, of host operations), in
    microseconds, from the profiler's raw events."""
    from torch.autograd import DeviceType

    dev, host = [], []
    try:
        raw = prof.profiler.kineto_results.events()
    except AttributeError:
        raw = None
    if raw is not None:
        for e in raw:
            if hasattr(e, "start_ns"):
                a, d = e.start_ns() / 1e3, e.duration_ns() / 1e3
            else:
                a, d = e.start_us(), e.duration_us()
            (dev if e.device_type() == DeviceType.CUDA else host).append((a, a + d, e.name()))
    else:
        for e in prof.events():
            a, b = e.time_range.start, e.time_range.end
            (dev if e.device_type == DeviceType.CUDA else host).append((a, b, e.name))
    return dev, host


def device_activity(prof, mark: str) -> dict:
    """From a profile of the cell's traffic, within the host span named
    `mark` (the traced traffic and its drain, in the profiler's own clock) and the span of
    the device operations recorded: {'window_s' (the length of both), 'busy_s'
    (the union of the device operations' intervals inside it), 'device_ops' [[name, s]] (the 10 that took the most time),
    'idle_gaps' [[name, s]] (the 10 longest gaps between device
    operations, each named by the shortest other host operation running at
    its middle)}; {} where the profile holds no device operation."""
    kern, host = _intervals(prof)
    spans = [(a, b) for a, b, n in host if n == mark]
    if not kern or not spans:
        return {"n_device_ops": len(kern), "n_host_ops": len(host), "marked": len(spans)}
    lo, hi = spans[0]
    # where the trace recorded: CUPTI can start recording late in a session
    lo = max(lo, min(a for a, _, _ in kern))
    hi = min(hi, max(b for _, b, _ in kern))
    host = [h for h in host if h[2] != mark]
    inside = sorted((max(a, lo), min(b, hi), n) for a, b, n in kern if b > lo and a < hi)
    if not inside:
        return {"n_device_ops": len(kern), "n_host_ops": len(host), "marked": len(spans),
                "device_span_us": [min(a for a, _, _ in kern), max(b for _, b, _ in kern)],
                "mark_us": [lo, hi]}
    kern = inside
    busy, gaps = 0.0, []
    cur_s, cur_e = kern[0][0], kern[0][1]
    by_name: dict = {}
    for s, e, name in kern:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((s - cur_e, cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    gaps.sort(reverse=True)
    named = []
    for length, a, b in gaps[:10]:
        mid = (a + b) / 2
        inner = [h for h in host if h[0] <= mid <= h[1]]
        name = min(inner, key=lambda h: h[1] - h[0])[2] if inner else "no host operation"
        named.append([name, length / 1e6])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": (hi - lo) / 1e6, "busy_s": busy / 1e6,
            "device_ops": [[n, v] for n, v in ops], "idle_gaps": named,
            "n_device_ops": len(kern), "n_host_ops": len(host)}
