"""The program's own spans and counters: one recorder per server.

A `Tracer` is built off and handed to the server's `DeviceBatcher` and its
`PerformanceMonitorServer`. `start()` anchors the clocks and starts
recording; `stop()` stops and returns a `Trace`: the spans, the counters'
deltas over the trace and the anchor.

* A span is `(name, start_ns, end_ns, thread, id, parent)`. Times are
  `time.perf_counter_ns()`. Spans of one frame share the frame's id, taken
  at `DeviceBatcher.submit()`; an upload group's spans carry the tuple of
  its frames' ids. Spans of one step share the step's number, and each
  frame's `batcher.fanout` names its step as parent.
* Off, every site costs one attribute test (`tracer.on`): no allocation,
  no clock read, no timing event, no call.
* Spans live in memory, at most `capacity` of them; what does not fit is
  counted in `dropped`, and every reading over a trace that dropped spans
  is None.
* Counters are plain integers (`Counter`), bumped on or off by the one
  thread that owns them; `watch(read)` names a source of counts, read at
  `start()` and at `stop()`.
* The device on the same clock: on a card, `start()` synchronizes it,
  records one timing event on an idle stream and reads the host clock
  around it. A step's CUDA events become host times as the anchor's host
  time plus `anchor.elapsed_time(event)`. `stop()` anchors again; where
  the two clocks drifted apart by more than `DRIFT_NS` over the trace, the
  device spans are put back on the host clock by the line through both
  anchors (`elapsed_time` is a float32 of ms: about 4 us of resolution
  40 s from the anchor). On the CPU the step's spans are host times.
* Collections: `gc.callbacks` gets a hook from `start()` to `stop()` that
  records `gc.gen0/1/2` spans.

`telemetry/monitor.py::profile_trace` writes a trace beside torch.profiler's
kernels. `summary(trace)`, `idle_split(trace)` and `device_ms(trace)` are
the readings.

Importing this module imports no torch.
"""

from __future__ import annotations

import gc
import itertools
import threading
import time
from typing import Callable, NamedTuple, Optional

import numpy as np

CAPACITY = 1 << 21  # spans one trace holds
DRIFT_NS = 50_000  # clock drift over a trace beyond which device spans are re-anchored
ANCHOR_TRIES = 5
DEVICE = "step.device"
#: the dispatch thread's spans, which with gc's the idle split names
DISPATCH = ("batcher.await", "batcher.window", "batcher.assemble", "batcher.provider",
            "batcher.enqueue", "batcher.handoff")
STALL_S = 0.3


class Counter:
    """A plain count, bumped by the one thread that owns it."""

    __slots__ = ("count",)

    def __init__(self) -> None:
        self.count = 0

    def bump(self, n: int = 1) -> None:
        self.count += n


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    thread: str
    id: object  # a frame's id, a step's number or a group's tuple of frame ids
    parent: int


class Trace(NamedTuple):
    spans: list
    counters: dict  # name -> delta over the trace, with "dropped"
    anchor: dict  # start_ns, stop_ns, drift_ns (0 without a card)


class _Anchor(NamedTuple):
    host_ns: int
    event: object


def _anchor(device) -> _Anchor:
    """One timing event on an idle stream of `device` and the host time it
    ran at: the midpoint of the tightest of `ANCHOR_TRIES` readings."""
    import torch

    torch.cuda.synchronize(device)
    stream = torch.cuda.Stream(device)
    best = None
    for _ in range(ANCHOR_TRIES):
        ev = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter_ns()
        ev.record(stream)
        ev.synchronize()
        t1 = time.perf_counter_ns()
        if best is None or t1 - t0 < best[0]:
            best = (t1 - t0, _Anchor((t0 + t1) // 2, ev))
    return best[1]


class Tracer:
    """The recorder (see the module docstring)."""

    def __init__(self, capacity: int = CAPACITY):
        self.on = False
        self.capacity = capacity
        self.dropped = Counter()
        self._ids = itertools.count()
        self._sources: list[Callable[[], dict]] = []
        self._spans: list = []
        self._device = None  # a CUDA device whose events are put on the clock
        self._anchor: Optional[_Anchor] = None
        self._counts0: dict = {}
        self.start_ns = 0  # when the current trace started
        self._gc_ns = 0

    # ---------------------------------------------------------- set-up

    def watch(self, read: Callable[[], dict], device=None) -> None:
        """`read() -> {name: count}` is read at start() and stop(); a CUDA
        `device` is the one whose step events `device_span` converts."""
        self._sources.append(read)
        if device is not None and device.type == "cuda":
            self._device = device

    def _counts(self) -> dict:
        out = {"dropped": self.dropped.count}
        for read in self._sources:
            out.update(read())
        return out

    # ---------------------------------------------------------- switch

    def start(self) -> None:
        if self.on:
            raise RuntimeError("the tracer is already recording")
        self._spans = []
        self._anchor = _anchor(self._device) if self._device is not None else None
        self._counts0 = self._counts()
        self.start_ns = time.perf_counter_ns()
        gc.callbacks.append(self._gc)
        self.on = True

    def stop(self) -> Trace:
        if not self.on:
            raise RuntimeError("the tracer is not recording")
        self.on = False
        gc.callbacks.remove(self._gc)
        stop_ns = time.perf_counter_ns()
        spans, self._spans = self._spans, []
        now = self._counts()
        counters = {k: v - self._counts0.get(k, 0) for k, v in now.items()}
        anchor = {"start_ns": self.start_ns, "stop_ns": stop_ns, "drift_ns": 0}
        if self._anchor is not None:
            anchor["drift_ns"] = self._reanchor(spans)
        return Trace(spans, counters, anchor)

    def _reanchor(self, spans: list) -> int:
        """The host clock's lead over the device's since start(); device
        spans rescaled through both anchors where it exceeds DRIFT_NS."""
        a0, a1 = self._anchor, _anchor(self._device)
        dev_ns = a0.event.elapsed_time(a1.event) * 1e6
        host_ns = a1.host_ns - a0.host_ns
        drift = int(host_ns - dev_ns)
        if abs(drift) > DRIFT_NS and dev_ns > 0:
            scale = host_ns / dev_ns
            for i, s in enumerate(spans):
                if s.name == DEVICE:
                    spans[i] = s._replace(
                        start_ns=a0.host_ns + int((s.start_ns - a0.host_ns) * scale),
                        end_ns=a0.host_ns + int((s.end_ns - a0.host_ns) * scale))
        return drift

    # -------------------------------------------------------- recording

    def next_id(self) -> int:
        return next(self._ids)

    def span(self, name: str, start_ns: int, end_ns: int, id=-1, parent: int = -1) -> None:
        """Record a closed span (call only while `on`)."""
        if len(self._spans) < self.capacity:
            self._spans.append(Span(name, start_ns, end_ns, threading.current_thread().name,
                                    id, parent))
        else:  # any thread may land here; a lost bump leaves the count above 0
            self.dropped.bump()

    def device_span(self, start_event, end_event, step: int) -> None:
        """The step's compute-stream span from its two timing events, both
        complete (the caller has waited on the end one)."""
        a = self._anchor
        self.span(DEVICE, a.host_ns + int(a.event.elapsed_time(start_event) * 1e6),
                  a.host_ns + int(a.event.elapsed_time(end_event) * 1e6), step)

    def _gc(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._gc_ns = time.perf_counter_ns()
        elif self.on:
            self.span(f"gc.gen{info['generation']}", self._gc_ns, time.perf_counter_ns())


# ------------------------------------------------------------- readings


def _by_name(trace: Trace) -> dict:
    out: dict = {}
    for s in trace.spans:
        out.setdefault(s.name, []).append(s)
    return out


def frame_segments(trace: Trace) -> Optional[np.ndarray]:
    """[n, 5] host ns per frame traced from submit() to its answer:
    submit(), its step's `batcher.enqueue` start, `step.device` start and
    end, its `set_result`. None where spans were dropped."""
    if trace.counters.get("dropped"):
        return None
    by = _by_name(trace)
    submit = {s.id: s.start_ns for s in by.get("batcher.ingress", ())}
    enq = {s.id: s.start_ns for s in by.get("batcher.enqueue", ())}
    dev = {s.id: (s.start_ns, s.end_ns) for s in by.get(DEVICE, ())}
    rows = []
    for s in by.get("batcher.fanout", ()):
        if s.id in submit and s.parent in enq and s.parent in dev:
            rows.append((submit[s.id], enq[s.parent], *dev[s.parent], s.end_ns))
    return np.asarray(rows, dtype=np.int64).reshape(-1, 5)


def _union(intervals) -> list:
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap(intervals: list, gaps: list) -> int:
    """ns of the (unioned) intervals that fall inside the sorted, disjoint
    gaps (one pass over both)."""
    total = j = 0
    for a, b in _union(intervals):
        while j < len(gaps) and gaps[j][1] <= a:
            j += 1
        k = j
        while k < len(gaps) and gaps[k][0] < b:
            total += min(b, gaps[k][1]) - max(a, gaps[k][0])
            k += 1
    return total


def idle_split(trace: Trace) -> Optional[dict]:
    """The compute stream's idle time in the window (first submit() to last
    answer) and the spans open across it. Seconds: window, idle, idle under
    each span name, under any of the dispatch thread's spans or gc's
    (`covered_s`), under any span at all (`any_s`); the idle gaps of STALL_S or more with the spans open
    across them."""
    seg = frame_segments(trace)
    if seg is None or not len(seg):
        return None
    w0, w1 = int(seg[:, 0].min()), int(seg[:, 4].max())
    by = _by_name(trace)
    busy = _union((max(s.start_ns, w0), min(s.end_ns, w1)) for s in by.get(DEVICE, ())
                  if s.end_ns > w0 and s.start_ns < w1)
    gaps, at = [], w0
    for a, b in busy:
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if at < w1:
        gaps.append((at, w1))
    under = {n: _overlap([(s.start_ns, s.end_ns) for s in by[n]], gaps) / 1e9
             for n in by if n != DEVICE}
    named = [n for n in by if n in DISPATCH or n.startswith("gc.")]
    covered = _overlap([(s.start_ns, s.end_ns) for n in named for s in by[n]], gaps) / 1e9
    any_ = _overlap([(s.start_ns, s.end_ns) for n in by if n != DEVICE for s in by[n]],
                    gaps) / 1e9
    stalls = []
    for g0, g1 in gaps:
        if g1 - g0 >= STALL_S * 1e9:
            open_ = sorted({s.name for n in by for s in by[n]
                            if s.start_ns < g1 and s.end_ns > g0 and s.name != DEVICE})
            stalls.append({"start_s": (g0 - w0) / 1e9, "s": (g1 - g0) / 1e9, "open": open_})
    idle = sum(b - a for a, b in gaps) / 1e9
    return {"window_s": (w1 - w0) / 1e9, "idle_s": idle, "under": under,
            "covered_s": covered, "any_s": any_, "stalls": stalls}


def device_ms(trace: Trace) -> list:
    """The steps' `step.device` lengths (ms), in the order they completed."""
    return [(s.end_ns - s.start_ns) / 1e6 for s in trace.spans if s.name == DEVICE]


def _median_ms(spans) -> Optional[float]:
    d = [s.end_ns - s.start_ns for s in spans]
    return float(np.median(d)) / 1e6 if d else None


def summary(trace: Trace) -> Optional[dict]:
    """The trace's readings: the medians over frames of the four segments
    of a frame's wait (host queue, device queue, the step on the device,
    fan-out; ms), the median `step.device` and `batcher.provider` lengths
    (ms), carried dispatches over dispatches and the compute stream's idle
    share of the window (%). None where spans were dropped."""
    seg = frame_segments(trace)
    if seg is None or not len(seg):
        return None
    parts = np.diff(seg, axis=1) / 1e6
    by = _by_name(trace)
    steps = trace.counters.get("batcher.steps", 0)
    idle = idle_split(trace)
    return {
        "frames": len(seg),
        "host_queue_ms": float(np.median(parts[:, 0])),
        "device_queue_ms": float(np.median(parts[:, 1])),
        "step_device_ms": _median_ms(by.get(DEVICE, ())),
        "fanout_ms": float(np.median(parts[:, 3])),
        "frame_ms": float(np.median(parts.sum(axis=1))),
        "provider_ms": _median_ms(by.get("batcher.provider", ())),
        "carry_pct": 100.0 * trace.counters.get("batcher.carried", 0) / steps if steps else None,
        "step_idle_pct": 100.0 * idle["idle_s"] / idle["window_s"] if idle["window_s"] else None,
    }
