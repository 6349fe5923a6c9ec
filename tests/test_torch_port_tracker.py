"""The port's host-side trackers held against the JAX package's: the same
seeded detection sequences through both, under one fake clock. Everything
is exact (the trackers do float64 numpy and Python arithmetic on the same
inputs); no tolerance is needed or allowed."""

import json
import os

import numpy as np
import pytest

from facerecognitionpipeline_tpu.serve import tracker as jtracker
from facerecognitionpipeline_tpu_torch.serve import tracker as ttracker


class FakeClock:
    """Stands in for the `time` module inside both tracker modules."""

    def __init__(self):
        self.now = 1_000.0

    def time(self):
        return self.now

    def monotonic(self):
        return self.now

    def perf_counter(self):
        return self.now


@pytest.fixture
def clock(monkeypatch):
    c = FakeClock()
    monkeypatch.setattr(jtracker, "time", c)
    monkeypatch.setattr(ttracker, "time", c)
    return c


def _detections(rng, n_faces, step, drop=0.2, jump=6.0):
    """`n_faces` faces drifting by up to `jump` px a frame; each is missed
    with probability `drop`; an occasional newcomer."""
    out = []
    for i in range(n_faces):
        if rng.random() < drop:
            continue
        cx = 80 + 150 * i + step * rng.uniform(-jump, jump)
        cy = 100 + 40 * (i % 3) + step * rng.uniform(-jump, jump)
        s = 40 + 5 * i
        out.append({
            "bbox": np.array([cx - s, cy - s, cx + s, cy + s], np.float32),
            "det_score": float(rng.uniform(0.4, 1.0)),
            "quality_metrics": {"blur_score": float(rng.uniform(20, 300))},
            "match": [("S%d" % i, "Student %d" % i, float(rng.uniform(0.2, 0.95)))]
            if rng.random() < 0.8 else [],
        })
    if rng.random() < 0.15:
        out.append({
            "bbox": rng.uniform(0, 600, 4).astype(np.float32),
            "det_score": 0.9, "quality_metrics": {"blur_score": 150.0}, "match": [],
        })
    return out


def _copy(dets):
    return [dict(d, bbox=d["bbox"].copy(), match=list(d["match"])) for d in dets]


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("max_distance,max_disappeared", [(50, 30), (100, 3), (15, 1)])
def test_simple_tracker_assignments_equal(seed, max_distance, max_disappeared):
    rng = np.random.default_rng(seed)
    j = jtracker.SimpleTracker(max_disappeared=max_disappeared, max_distance=max_distance)
    t = ttracker.SimpleTracker(max_disappeared=max_disappeared, max_distance=max_distance)
    seen = set()
    for step in range(40):
        dets = _detections(rng, 4, step)
        jr = j.update(_copy(dets))
        tr = t.update(_copy(dets))
        assert [tid for tid, _ in tr] == [tid for tid, _ in jr]
        for (_, a), (_, b) in zip(jr, tr):
            np.testing.assert_array_equal(a["bbox"], b["bbox"])
        assert sorted(t.tracks) == sorted(j.tracks)
        assert t.next_track_id == j.next_track_id
        for tid in j.tracks:
            assert t.tracks[tid]["disappeared"] == j.tracks[tid]["disappeared"]
        seen.update(tid for tid, _ in tr)
    assert len(seen) >= 4  # the sequence did create and keep tracks


@pytest.mark.parametrize("a,b", [
    ((0, 0, 10, 10), (5, 5, 15, 15)), ((0, 0, 10, 10), (20, 20, 30, 30)),
    ((0, 0, 10, 10), (0, 0, 10, 10)), ((0, 0, 10, 10), (10, 0, 20, 10)),
])
def test_simple_tracker_geometry_equal(a, b):
    assert ttracker.SimpleTracker.compute_iou(a, b) == jtracker.SimpleTracker.compute_iou(a, b)
    np.testing.assert_array_equal(
        ttracker.SimpleTracker.compute_centroid(a), jtracker.SimpleTracker.compute_centroid(a)
    )


def _live_state(tr):
    return {
        "recognized": {k: dict(v) for k, v in tr.recognized_tracks.items()},
        "attempts": dict(tr.recognition_attempts),
        "buffers": {k: [f["det_score"] for f in v] for k, v in tr.track_frame_buffers.items()},
        "first_seen": dict(tr.track_first_seen),
        "last_seen": dict(tr.track_last_seen),
        "cooldowns": dict(tr.track_cooldowns),
        "monotonic": dict(tr._last_seen_monotonic),
    }


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("mode", ["server", "live"])
def test_live_recognition_tracker_decisions_equal(clock, seed, mode):
    """Gating decisions, best frames, attempts, cooldowns and clean-up over
    a 60-frame script with the clock stepping 0.7 s a frame."""
    import math

    live = mode == "live"
    kw = dict(
        recognition_interval=3, max_attempts=2, buffer_size=4,
        retry_cooldown=math.inf if live else 5.0, frame_interval_gating=live,
    )
    rng = np.random.default_rng(100 + seed)
    sides = [(jtracker.SimpleTracker(max_distance=100), jtracker.LiveRecognitionTracker(**kw)),
             (ttracker.SimpleTracker(max_distance=100), ttracker.LiveRecognitionTracker(**kw))]
    attempts_seen = cooldowns_seen = cleaned = 0
    for frame in range(1, 61):
        clock.now += 0.7 if frame % 20 else 40.0  # a long gap ages tracks out
        dets = _detections(rng, 3, frame)
        stamp = f"2026-01-01T00:00:{frame % 60:02d}"
        logs = []
        for motion, tr in sides:
            log = []
            tracked = motion.update(_copy(dets))
            for tid, face in tracked:
                tr.add_frame(tid, face, stamp)
                go = tr.should_recognize(tid, frame)
                log.append((tid, go))
                if not go:
                    continue
                best = tr.get_best_frame(tid)
                log.append(("best", best["det_score"], bool(best["match"])))
                if not best["match"]:
                    continue
                tr.increment_attempts(tid)
                sid, name, score = best["match"][0]
                if score >= 0.6:
                    tr.mark_recognized(tid, {"student_id": sid, "confidence": score})
                log.append(("duration", tr.get_track_duration(tid)))
            log.append(("cooling", sorted(t for t, _ in tracked if tr.is_track_in_cooldown(t))))
            before = len(tr.track_frame_buffers)
            tr.cleanup_stale_tracks([tid for tid, _ in tracked], max_age_seconds=30.0)
            log.append(("cleaned", before - len(tr.track_frame_buffers)))
            logs.append(log)
        assert logs[1] == logs[0], frame
        assert _live_state(sides[1][1]) == _live_state(sides[0][1]), frame
        attempts_seen += sum(1 for e in logs[1] if e[0] == "duration")
        cooldowns_seen += bool(logs[1][-2][1])
        cleaned += logs[1][-1][1]
    assert attempts_seen >= 3 and cleaned >= 1
    if not live:
        assert cooldowns_seen >= 1


def test_malformed_timestamp_gives_zero_duration_on_both():
    for mod in (jtracker, ttracker):
        tr = mod.LiveRecognitionTracker()
        tr.add_frame(1, {"det_score": 0.9}, "not a time")
        assert tr.get_track_duration(1) == 0.0
        assert tr.get_track_duration(2) == 0.0


@pytest.mark.parametrize("seed", range(3))
def test_frame_accumulator_scores_and_files_equal(tmp_path, seed):
    rng = np.random.default_rng(seed)
    accs = [
        mod.FrameAccumulator(output_dir=str(tmp_path / name), target_frames=3)
        for name, mod in (("jax", jtracker), ("torch", ttracker))
    ]
    for step in range(8):
        face = {
            "det_score": float(rng.uniform(0.5, 1.0)),
            "bbox": [10.0, 10.0, 60.0, 60.0],
            "quality_metrics": {
                "blur_score": float(rng.uniform(10, 400)),
                "yaw": float(rng.uniform(-40, 40)), "pitch": float(rng.uniform(-30, 30)),
                "roll": float(rng.uniform(-20, 20)),
            },
            "aligned_face": rng.integers(0, 256, (112, 112, 3)).astype(np.uint8),
        }
        scores = [a.compute_quality_score(face) for a in accs]
        assert scores[0] == scores[1]
        done = [a.add_frame(1 + step % 2, dict(face)) for a in accs]
        assert done[0] == done[1]
        assert accs[1].get_status(1) == accs[0].get_status(1)
    trees = []
    for a in accs:
        for tid in (1, 2):
            a.save_track(tid)
        tree = {}
        for d, _, names in os.walk(a.output_dir):
            for n in names:
                path = os.path.join(d, n)
                rel = os.path.relpath(path, a.output_dir)
                if n.endswith(".json"):
                    with open(path) as f:
                        tree[rel] = json.load(f)
                else:
                    with open(path, "rb") as f:
                        tree[rel] = f.read()
        trees.append(tree)
    assert trees[0].keys() == trees[1].keys() and len(trees[1]) >= 4
    for rel, doc in trees[0].items():
        if isinstance(doc, dict):
            doc = {k: v for k, v in doc.items() if "time" not in k and "saved" not in k}
            other = {k: v for k, v in trees[1][rel].items()
                     if "time" not in k and "saved" not in k}
            assert other == doc, rel
        else:
            assert trees[1][rel] == doc, rel  # the same PNG bytes (cv2 on both)
