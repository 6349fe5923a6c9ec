"""The measured window: frames submitted to the batcher as the traffic mix
says, each timed from when it was due to when its future resolved.

Open loop: one thread submits each frame at its due time (how late it
ran is recorded), whatever the system does. Closed loop: each stream sends
its next frame the moment the previous one resolves, until the window
closes. Completions are stamped in the futures' callbacks. A seeded
reservoir keeps `sample` resolved futures, whose answers are judged after
the window; every other answer is dropped as it comes, and no kept answer
holds the gallery's id list.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Window:
    seconds: float = 0.0  # the window's length
    latency_s: list = field(default_factory=list)  # every frame due in the window
    answered_in_window: int = 0  # frames whose answer came before the close
    attempted: int = 0
    failed: int = 0
    late_s: list = field(default_factory=list)  # open loop: how late each submit ran
    sample: list = field(default_factory=list)  # [(pool index, future)]
    drain_s: float = 0.0  # from the close to the last answer
    per_second: list = field(default_factory=list)  # answers in each second of the window


class _Collector:
    """Stamps completions (any thread) and keeps a seeded reservoir."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k = k
        self.rng = rng
        self.lock = threading.Lock()
        self.seen = 0
        self.sample: list = []
        self.done = []  # (due, finished, ok)
        self.cv = threading.Condition(self.lock)

    def finish(self, due: float, frame: int, fut) -> None:
        t = time.perf_counter()
        ok = fut.exception() is None
        with self.lock:
            self.done.append((due, t, ok))
            if ok:
                self.seen += 1
                if len(self.sample) < self.k:
                    self.sample.append((frame, _kept(fut)))
                else:
                    j = int(self.rng.integers(self.seen))
                    if j < self.k:
                        self.sample[j] = (frame, _kept(fut))
            self.cv.notify_all()

    def wait_for(self, n: int, timeout: float) -> bool:
        end = time.perf_counter() + timeout
        with self.lock:
            while len(self.done) < n:
                left = end - time.perf_counter()
                if left <= 0:
                    return False
                self.cv.wait(left)
        return True


def _kept(fut):
    """A sampled future, its answer without the id list the batcher
    attaches (the comparison reads match indices). At 1 048 576 ids each
    list is a million-item container that the interpreter's full
    collections walk; a client drops it with the answer, and so does the
    harness while it holds the sample through the window."""
    res = fut.result()
    if isinstance(res, dict):
        res.pop("gallery_ids", None)
    return fut


def _sleep_until(t: float) -> None:
    """Sleep (no spinning: the batcher's threads share the interpreter)."""
    left = t - time.perf_counter()
    if left > 0:
        time.sleep(left)


def run_open(submit, pool: np.ndarray, sched: dict, sample: int,
             rng: np.random.Generator, grace_s: float = 60.0) -> Window:
    """Submit pool[sched['frame'][i]] at sched['due'][i] seconds."""
    col = _Collector(sample, rng)
    due, frames = sched["due"], sched["frame"]
    n = len(due)
    late = np.empty(n)
    t0 = time.perf_counter() + 0.01
    for i in range(n):
        at = t0 + due[i]
        _sleep_until(at)
        late[i] = time.perf_counter() - at
        fut = submit(pool[frames[i]])
        fut.add_done_callback(lambda f, a=at, fr=int(frames[i]): col.finish(a, fr, f))
    close = t0 + float(due[-1])
    col.wait_for(n, grace_s + (time.perf_counter() - close))
    return _result(col, n, t0, close, late)


def run_closed(submit, pool: np.ndarray, streams: np.ndarray, seconds: float,
               sample: int, rng: np.random.Generator, grace_s: float = 60.0) -> Window:
    """Each stream keeps one frame outstanding until `seconds` pass."""
    col = _Collector(sample, rng)
    state = {"sent": 0}
    lock = threading.Lock()
    t0 = time.perf_counter()
    close = t0 + seconds

    def send(s: int, j: int) -> None:
        at = time.perf_counter()
        if at >= close:
            return
        with lock:
            state["sent"] += 1
        fr = int(streams[s, j % streams.shape[1]])
        fut = submit(pool[fr])

        def done(f, a=at, fr=fr):
            col.finish(a, fr, f)
            if f.exception() is None:  # a failed stream stops
                send(s, j + 1)

        fut.add_done_callback(done)

    for s in range(streams.shape[0]):
        send(s, 0)
    _sleep_until(close)
    with lock:
        n = state["sent"]
    col.wait_for(n, grace_s)
    with lock:
        n = state["sent"]
    col.wait_for(n, 1.0)
    return _result(col, n, t0, close, None)


def _result(col: _Collector, n: int, t0: float, close: float, late) -> Window:
    with col.lock:
        done = list(col.done)
        sample = list(col.sample)
    w = Window(seconds=close - t0, attempted=n)
    w.failed = n - sum(1 for _, _, ok in done if ok)
    # a frame that failed or never came misses every latency limit
    w.latency_s = [t - a if ok else float("inf") for a, t, ok in done]
    w.latency_s += [float("inf")] * (n - len(done))
    w.answered_in_window = sum(1 for _, t, ok in done if ok and t <= close)
    w.late_s = [] if late is None else list(late)
    w.sample = sample
    w.drain_s = max((t for _, t, _ in done), default=close) - close
    secs = int(np.ceil(close - t0))
    w.per_second = np.bincount(
        [int(t - t0) for _, t, ok in done if ok and t0 <= t < close], minlength=secs
    )[:secs].tolist()
    return w
