"""Host-side tracking state machines (deliberately not part of the device step).

Counterpart of `facerecognitionpipeline_tpu/serve/tracker.py`, with
identical semantics:

* `SimpleTracker` — greedy nearest-centroid association with disappearance
  clean-up; numpy only.
* `FrameAccumulator` — per-track best-N frame collection with the
  0.4*det + 0.3*blur/200 + 0.3*pose quality score.
* `LiveRecognitionTracker` — recognition gating with attempt limits, in both
  variants: the server's retry-cooldown gate (the default) and the live
  app's every-Nth-frame gate with permanent attempts (select with
  frame_interval_gating=True + retry_cooldown=inf, as serve/live.py does).

Tracking is stateful, tiny and branch-heavy: it stays on the host. The
device step hands these classes fixed-shape arrays and they manage identity
over time.
"""

from __future__ import annotations

import json
import math
import os
import time
from collections import defaultdict, deque
from datetime import datetime
from typing import Dict, List, Optional, Tuple

import numpy as np

from facerecognitionpipeline_tpu_torch.utils.io import imwrite_rgb


class SimpleTracker:
    """Greedy nearest-centroid multi-object tracker."""

    def __init__(self, max_disappeared: int = 30, max_distance: float = 50):
        self.next_track_id = 1
        self.tracks: Dict[int, Dict] = {}
        self.max_disappeared = max_disappeared
        self.max_distance = max_distance

    @staticmethod
    def compute_centroid(bbox) -> np.ndarray:
        x1, y1, x2, y2 = bbox
        return np.array([(x1 + x2) / 2.0, (y1 + y2) / 2.0])

    @staticmethod
    def compute_iou(bbox1, bbox2) -> float:
        x1 = max(bbox1[0], bbox2[0])
        y1 = max(bbox1[1], bbox2[1])
        x2 = min(bbox1[2], bbox2[2])
        y2 = min(bbox1[3], bbox2[3])
        if x2 < x1 or y2 < y1:
            return 0.0
        inter = (x2 - x1) * (y2 - y1)
        a1 = (bbox1[2] - bbox1[0]) * (bbox1[3] - bbox1[1])
        a2 = (bbox2[2] - bbox2[0]) * (bbox2[3] - bbox2[1])
        union = a1 + a2 - inter
        return inter / union if union > 0 else 0.0

    def _new_track(self, detection: Dict) -> int:
        track_id = self.next_track_id
        self.next_track_id += 1
        self.tracks[track_id] = {
            "bbox": detection["bbox"],
            "centroid": self.compute_centroid(detection["bbox"]),
            "disappeared": 0,
            "last_seen": datetime.now(),
        }
        return track_id

    def update(self, detections: List[Dict]) -> List[Tuple[int, Dict]]:
        """detections: dicts with 'bbox'. Returns [(track_id, detection)]."""
        if not detections:
            for tid in list(self.tracks):
                self.tracks[tid]["disappeared"] += 1
                if self.tracks[tid]["disappeared"] > self.max_disappeared:
                    del self.tracks[tid]
            return []

        if not self.tracks:
            return [(self._new_track(d), d) for d in detections]

        track_ids = list(self.tracks)
        tc = np.array([self.tracks[t]["centroid"] for t in track_ids])
        dc = np.array([self.compute_centroid(d["bbox"]) for d in detections])
        distances = np.linalg.norm(tc[:, None, :] - dc[None, :, :], axis=-1)

        matched_tracks: set = set()
        matched_dets: set = set()
        results = []
        while distances.size and distances.min() < self.max_distance:
            t_idx, d_idx = np.unravel_index(distances.argmin(), distances.shape)
            if t_idx in matched_tracks or d_idx in matched_dets:
                distances[t_idx, d_idx] = np.inf
                continue
            tid = track_ids[t_idx]
            det = detections[d_idx]
            self.tracks[tid].update(
                bbox=det["bbox"],
                centroid=self.compute_centroid(det["bbox"]),
                disappeared=0,
                last_seen=datetime.now(),
            )
            results.append((tid, det))
            matched_tracks.add(t_idx)
            matched_dets.add(d_idx)
            distances[t_idx, d_idx] = np.inf

        for idx, tid in enumerate(track_ids):
            if idx not in matched_tracks:
                self.tracks[tid]["disappeared"] += 1
                if self.tracks[tid]["disappeared"] > self.max_disappeared:
                    del self.tracks[tid]

        for idx, det in enumerate(detections):
            if idx not in matched_dets:
                results.append((self._new_track(det), det))
        return results


class FrameAccumulator:
    """Collect the best N quality frames per track and persist them."""

    def __init__(
        self,
        target_frames: int = 12,
        min_quality_score: float = 0.5,
        output_dir: str = "output/camera_captures",
    ):
        self.target_frames = target_frames
        self.min_quality_score = min_quality_score
        self.output_dir = output_dir
        os.makedirs(output_dir, exist_ok=True)
        self.accumulated_frames: Dict[int, list] = defaultdict(list)
        self.completed_tracks: set = set()
        self.metadata: Dict[int, Dict] = {}

    @staticmethod
    def compute_quality_score(face_dict: Dict) -> float:
        """0.4*det + 0.3*min(blur/200,1) + 0.3*pose (face_detection.py:137-153)."""
        m = face_dict["quality_metrics"]
        det = face_dict["det_score"]
        blur = min(m.get("blur_score", 0) / 200.0, 1.0)
        pose = 1.0 - (
            abs(m.get("yaw", 0)) / 90.0
            + abs(m.get("pitch", 0)) / 90.0
            + abs(m.get("roll", 0)) / 90.0
        ) / 3.0
        return det * 0.4 + blur * 0.3 + max(0.0, pose) * 0.3

    def add_frame(self, track_id: int, face_dict: Dict, frame_rgb=None) -> bool:
        """Returns True once the track has its target frame count.

        frame_rgb is accepted and ignored for reference API parity: the
        reference accumulator takes the full frame too and never uses it
        (face_detection.py:154-178) — only aligned crops are buffered."""
        if track_id in self.completed_tracks:
            return True
        quality = self.compute_quality_score(face_dict)
        if quality < self.min_quality_score:
            return False
        self.accumulated_frames[track_id].append(
            {
                "aligned_face": face_dict["aligned_face"],
                "quality_score": quality,
                "det_score": face_dict["det_score"],
                "metrics": face_dict["quality_metrics"],
                "timestamp": datetime.now().isoformat(),
            }
        )
        if len(self.accumulated_frames[track_id]) >= self.target_frames:
            self.save_track(track_id)
            return True
        return False

    def save_track(self, track_id: int) -> None:
        if track_id in self.completed_tracks:
            return
        frames = self.accumulated_frames[track_id]
        if not frames:
            return
        frames.sort(key=lambda x: x["quality_score"], reverse=True)
        keep = frames[: self.target_frames]

        track_dir = os.path.join(self.output_dir, f"track_{track_id:03d}")
        os.makedirs(track_dir, exist_ok=True)
        files = []
        for idx, fd in enumerate(keep):
            fname = f"frame_{idx:03d}.jpg"
            imwrite_rgb(os.path.join(track_dir, fname), fd["aligned_face"])
            files.append(fname)

        metadata = {
            "track_id": track_id,
            "num_frames": len(keep),
            "avg_quality": float(np.mean([f["quality_score"] for f in keep])),
            "avg_det_score": float(np.mean([f["det_score"] for f in keep])),
            "saved_at": datetime.now().isoformat(),
            "files": files,
        }
        with open(os.path.join(track_dir, "metadata.json"), "w") as f:
            json.dump(metadata, f, indent=2)
        self.metadata[track_id] = metadata
        self.completed_tracks.add(track_id)
        print(f"Saved {len(keep)} frames for track_{track_id:03d} -> {track_dir}")

    def get_status(self, track_id: int) -> str:
        if track_id in self.completed_tracks:
            return "completed"
        return f"{len(self.accumulated_frames[track_id])}/{self.target_frames}"


class LiveRecognitionTracker:
    """Per-track recognition gating: buffers, attempt limits, retry cooldown."""

    def __init__(
        self,
        recognition_interval: int = 30,
        max_attempts: int = 3,
        buffer_size: int = 10,
        retry_cooldown: float = 10.0,
        frame_interval_gating: bool = False,
    ):
        """frame_interval_gating selects between the reference's two tracker
        variants: False = the SERVER gate (cooldown + buffered-quality;
        recognition_interval is stored but not consulted, faithful to
        face_recognition_server.py:39-60, which also ignores it); True = the
        LIVE gate (attempt only when frame_count % recognition_interval == 0,
        attempts permanent — pair with retry_cooldown=math.inf — faithful to
        face_recognition_live.py:30-41)."""
        self.recognized_tracks: Dict[int, Dict] = {}
        self.recognition_attempts: Dict[int, int] = {}
        self.track_frame_buffers: Dict[int, deque] = {}
        self.track_first_seen: Dict[int, str] = {}
        self.track_last_seen: Dict[int, str] = {}
        self._last_seen_monotonic: Dict[int, float] = {}
        self.track_last_attempt: Dict[int, str] = {}
        self.track_cooldowns: Dict[int, float] = {}
        self.recognition_interval = recognition_interval
        self.max_attempts = max_attempts
        self.buffer_size = buffer_size
        self.retry_cooldown = retry_cooldown
        self.frame_interval_gating = frame_interval_gating

    @staticmethod
    def _frame_quality(face: Dict) -> float:
        det = face.get("det_score", 0)
        blur = face.get("quality_metrics", {}).get("blur_score", 0)
        return det * min(blur / 100.0, 1.0)

    def add_frame(self, track_id: int, face_data: Dict, timestamp: str) -> None:
        if track_id not in self.track_frame_buffers:
            self.track_frame_buffers[track_id] = deque(maxlen=self.buffer_size)
            self.track_first_seen[track_id] = timestamp
        self.track_last_seen[track_id] = timestamp
        # Age tracks by SERVER monotonic time, not the client-supplied
        # timestamp string: client clock skew must not make the server drop
        # live track state prematurely (or never GC it). The ISO timestamp
        # is kept above for reporting only.
        self._last_seen_monotonic[track_id] = time.monotonic()
        self.track_frame_buffers[track_id].append(face_data)

    def should_recognize(self, track_id: int, frame_count: int = 0) -> bool:
        """Gate: unrecognized, not cooling down, attempts left, and a buffered
        frame with det_score > 0.6 (face_recognition_server.py:39-60)."""
        if track_id in self.recognized_tracks:
            return False
        if self.frame_interval_gating:
            # LIVE variant (face_recognition_live.py:30-41): every Nth frame,
            # attempts permanent, no cooldown or buffer-quality gate beyond
            # needing a frame to embed.
            if self.recognition_attempts.get(track_id, 0) >= self.max_attempts:
                return False
            if self.recognition_interval > 1 and (
                frame_count % self.recognition_interval != 0
            ):
                return False
            return bool(self.track_frame_buffers.get(track_id))
        if self.is_track_in_cooldown(track_id):
            return False
        if self.recognition_attempts.get(track_id, 0) >= self.max_attempts:
            if math.isfinite(self.retry_cooldown):
                self.set_track_cooldown(track_id, self.retry_cooldown)
            return False
        buffer = self.track_frame_buffers.get(track_id)
        if buffer:
            best = max(buffer, key=self._frame_quality)
            if best.get("det_score", 0) > 0.6:
                return True
        return False

    def get_best_frame(self, track_id: int) -> Optional[Dict]:
        buffer = self.track_frame_buffers.get(track_id)
        if not buffer:
            return None
        # Prefer frames that carry gallery matches: under an engine
        # embed_budget a buffered frame may be detected-but-not-embedded
        # (empty match list), and picking it would stall the track's
        # recognition until it ages out of the deque. Without a budget all
        # frames carry matches (or none do, e.g. empty gallery) and this is
        # exactly the reference best-of-buffer rule.
        with_match = [f for f in buffer if f.get("match")]
        return max(with_match or buffer, key=self._frame_quality)

    def mark_recognized(self, track_id: int, student_info: Dict) -> None:
        # Store a (shallow) copy: the caller keeps mutating its dict on the
        # disk-I/O path (saved_face_path insert, _first_seen/_duration pops
        # under the server's _io_lock) while concurrent frames iterate this
        # one building responses under _lock — sharing the object is a
        # dict-changed-during-iteration race, and the io-private keys would
        # leak into the recognized_tracks payload. Only top-level keys are
        # ever mutated, so a shallow copy suffices.
        self.recognized_tracks[track_id] = dict(student_info)

    def increment_attempts(self, track_id: int) -> None:
        self.recognition_attempts[track_id] = (
            self.recognition_attempts.get(track_id, 0) + 1
        )
        self.track_last_attempt[track_id] = datetime.now().isoformat()

    def get_track_duration(self, track_id: int) -> float:
        if track_id not in self.track_first_seen or track_id not in self.track_last_seen:
            return 0.0
        try:
            first = datetime.fromisoformat(self.track_first_seen[track_id])
            last = datetime.fromisoformat(self.track_last_seen[track_id])
        except ValueError:
            # Timestamps are client-supplied strings; a malformed one must
            # not raise AFTER mark_recognized and lose the attendance entry.
            return 0.0
        return (last - first).total_seconds()

    def is_track_in_cooldown(self, track_id: int) -> bool:
        """Expired cooldowns reset attempts and clear the buffer
        (face_recognition_server.py:109-120)."""
        if track_id in self.track_cooldowns:
            if time.time() < self.track_cooldowns[track_id]:
                return True
            del self.track_cooldowns[track_id]
            self.recognition_attempts[track_id] = 0
            if track_id in self.track_frame_buffers:
                self.track_frame_buffers[track_id].clear()
        return False

    def set_track_cooldown(self, track_id: int, cooldown_seconds: float = 3.0) -> None:
        self.track_cooldowns[track_id] = time.time() + cooldown_seconds

    def cleanup_stale_tracks(self, active_track_ids, max_age_seconds: float = 30.0):
        """Drop state for tracks the tracker no longer reports (fixes the
        reference's method-on-wrong-object bug, face_recognition_server.py:355).

        Ages by server-side ``time.monotonic()`` recorded at add_frame —
        client-supplied timestamps are reporting-only (clock skew must not
        drive GC decisions)."""
        active = set(active_track_ids)
        now = time.monotonic()
        for tid in list(self.track_frame_buffers):
            if tid in active:
                continue
            last = self._last_seen_monotonic.get(tid)
            age = (now - last) if last is not None else max_age_seconds + 1
            if age > max_age_seconds:
                for store in (
                    self.track_frame_buffers,
                    self.recognition_attempts,
                    self.track_first_seen,
                    self.track_last_seen,
                    self.track_last_attempt,
                    self.track_cooldowns,
                    self._last_seen_monotonic,
                ):
                    store.pop(tid, None)
