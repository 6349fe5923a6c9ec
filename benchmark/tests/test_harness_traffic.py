"""The generator is deterministic per seed and gives every seed the same
work; the open loop's latency counts a stall."""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future

import numpy as np

from benchmark.lib import frames, system, traffic, window

MIX = {"loop": "open", "cameras": 16, "rate_per_s": 270.0, "arrivals": "poisson", "pool": 64}


def test_open_schedule_deterministic_and_same_work():
    a = traffic.open_schedule(MIX, 20.0, np.random.default_rng(7))
    b = traffic.open_schedule(MIX, 20.0, np.random.default_rng(7))
    c = traffic.open_schedule(MIX, 20.0, np.random.default_rng(8))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert not np.array_equal(a["due"], c["due"])
    assert len(a["due"]) == len(c["due"]) == 16 * round(270 / 16 * 20)
    n = round(270 / 16 * 20)
    q = (np.arange(n) + 0.5) / n
    every = -np.log1p(-q)
    every *= 20.0 / every.sum()
    for s in (a, c):  # each camera's gaps: the same quantiles, in another order
        d = np.diff(s["due"][s["camera"] == 3])
        assert np.abs(d[:, None] - every[None]).min(axis=1).max() < 1e-9
    assert a["due"].min() >= 0 and a["due"].max() < 20.0 + 16 / 270.0


def test_periodic_and_closed_deterministic():
    mix = {**MIX, "arrivals": "periodic", "phase_spread_ms": 5.0}
    a = traffic.open_schedule(mix, 4.0, np.random.default_rng(3))
    assert np.ptp(a["due"][:16]) <= 5e-3
    s1 = traffic.closed_streams({"streams": 32, "pool": 64}, np.random.default_rng(5))
    s2 = traffic.closed_streams({"streams": 32, "pool": 64}, np.random.default_rng(5))
    assert s1.shape[0] == 32 and np.array_equal(s1, s2)


def test_seeds_and_mosaics_deterministic_for_large_seeds():
    for seed in (0, 2**31 + 5, 2**40 + 3):
        s = system.seeds(seed)
        assert s == system.seeds(seed) and len(set(s.values())) == len(s)
        assert all(0 <= v < 2**63 for v in s.values())
    fx = frames.fixture()
    f1, o1 = frames.mosaics(fx, 3, 4, np.random.default_rng(11))
    f2, o2 = frames.mosaics(fx, 3, 4, np.random.default_rng(11))
    assert f1.shape == (3, 640, 640, 3) and np.array_equal(f1, f2) and np.array_equal(o1, o2)
    assert sorted(o1[0]) == list(range(16))


class _FakeBatcher:
    """Answers each frame 5 ms after it comes, one at a time; `stall`
    holds the worker once for that many seconds at the 20th frame."""

    def __init__(self, stall: float):
        self.stall = stall
        self.n = 0
        self.lock = threading.Lock()
        self.q: list = []
        self.cv = threading.Condition(self.lock)
        self.stop = False
        self.th = threading.Thread(target=self._run, daemon=True)
        self.th.start()

    def submit(self, frame):
        f = Future()
        with self.cv:
            self.q.append(f)
            self.cv.notify()
        return f

    def _run(self):
        while True:
            with self.cv:
                while not self.q and not self.stop:
                    self.cv.wait()
                if self.stop and not self.q:
                    return
                f = self.q.pop(0)
                self.n += 1
                n = self.n
            time.sleep(self.stall if n == 20 else 0.005)
            f.set_result({"n": n})


def _p95(stall: float) -> float:
    fb = _FakeBatcher(stall)
    mix = {"cameras": 4, "rate_per_s": 80.0, "arrivals": "periodic", "pool": 1}
    sched = traffic.open_schedule(mix, 1.5, np.random.default_rng(1))
    w = window.run_open(fb.submit, np.zeros((1, 2, 2, 3), np.uint8), sched, 2,
                        np.random.default_rng(2), grace_s=10.0)
    with fb.cv:
        fb.stop = True
        fb.cv.notify()
    fb.th.join(5)
    assert w.failed == 0 and w.attempted == len(sched["due"])
    return float(np.percentile(w.latency_s, 95))


def test_open_loop_latency_counts_a_stall():
    calm, stalled = _p95(0.0), _p95(0.4)
    assert calm < 0.05
    # the stall delays every frame due while it lasts, not only its own
    assert stalled > calm + 0.2


def test_sampled_answers_hold_no_id_list():
    ids = [f"id{j}" for j in range(1000)]

    def submit(frame):
        f = Future()
        f.set_result({"match_idx": np.zeros(3), "gallery_ids": ids})
        return f

    mix = {"cameras": 2, "rate_per_s": 40.0, "arrivals": "periodic", "pool": 1}
    sched = traffic.open_schedule(mix, 0.5, np.random.default_rng(1))
    w = window.run_open(submit, np.zeros((1, 2, 2, 3), np.uint8), sched, 4,
                        np.random.default_rng(2), grace_s=5.0)
    assert len(w.sample) == 4
    assert all(set(f.result()) == {"match_idx"} for _, f in w.sample)
