"""Live single-process recognition + attendance app.

Counterpart of `facerecognitionpipeline_tpu/serve/live.py`, a capability
rebuild of the reference `LiveFaceRecognition`: all-in-one camera -> detect
-> track -> recognize -> attendance, with per-event aligned/original crop
persistence, auto-snapshots, HUD, and session finalize with stats+FPS.
Composed from the server core (`FaceRecognitionServer` without the HTTP
layer, `tracker_mode='live'`) so the batched device step, attendance
schema, gating semantics and artifacts are identical between networked and
local operation. Camera and window code imports `cv2` at the call.
"""

from __future__ import annotations

import argparse
import base64
import os
import time
from datetime import datetime
from typing import Iterator, Optional

import numpy as np

from facerecognitionpipeline_tpu_torch.models.irse import BACKBONE_CONFIGS
from facerecognitionpipeline_tpu_torch.serve.server import (
    FaceRecognitionServer,
    _encode_png_bytes,
)


class LiveFaceRecognition:
    def __init__(
        self,
        gallery_path: str = "gallery/students.pkl",
        similarity_threshold: float = 0.4,
        session_name: Optional[str] = None,
        output_dir: str = "sessions",
        model_type: str = "adaface",
        architecture: str = "ir_101",
        model_path: Optional[str] = None,
        recognition_interval: int = 30,
        max_attempts: int = 3,
        camera_id: int = 0,
        video_path: Optional[str] = None,
        synthetic: bool = False,
        frame_skip: int = 5,
        max_frames: int = 0,
        display: bool = True,
        auto_snapshot_interval: float = 0.0,
        core: Optional[FaceRecognitionServer] = None,
        embed_budget: Optional[int] = None,
        quantize: Optional[str] = None,
        quantize_calib: Optional[str] = None,
        device="cuda",
    ):
        """device: as `FaceRecognitionServer` ('cuda' raises without a card;
        ignored when a pre-built `core` is given). quantize /
        quantize_calib: the int8 embedder and detector, as the server's
        (ignored with a pre-built `core`)."""
        self.core = core or FaceRecognitionServer(
            gallery_path=gallery_path,
            similarity_threshold=similarity_threshold,
            output_dir=output_dir,
            model_type=model_type,
            architecture=architecture,
            model_path=model_path,
            recognition_interval=recognition_interval,
            max_recognition_attempts=max_attempts,
            tracker_mode="live",
            embed_budget=embed_budget,
            quantize=quantize,
            quantize_calib=quantize_calib,
            device=device,
        )
        # recognition_interval keeps the reference's unit: CAPTURED frames
        # (face_recognition_live.py:38 processes every captured frame). This
        # app adds --frame_skip, and the core's live gate counts PROCESSED
        # frames, so convert: every `interval` captured ~= every
        # `interval // skip` processed. Without this, skip 5 x interval 30
        # attempts every 150 captured frames (5 s at 30 fps) instead of the
        # reference's every 30 (1 s) — and coprime combos compose into
        # lcm-scale droughts under raw-count gating.
        skip = max(1, int(frame_skip))
        eff = max(1, self.core.recognition_interval // skip)
        if eff != self.core.recognition_interval:
            self.core.recognition_interval = eff
        self.session_name = session_name or datetime.now().strftime(
            "live_%Y%m%d_%H%M%S"
        )
        self.core._create_session(self.session_name)
        self.camera_id = camera_id
        self.video_path = video_path
        self.synthetic = synthetic
        self.frame_skip = max(1, frame_skip)
        self.max_frames = max_frames
        self.display = display
        self.auto_snapshot_interval = auto_snapshot_interval
        self.frame_count = 0
        self.fps = 0.0
        self._last_result: dict = {}
        self._last_snapshot = time.time()

    def _source(self) -> Iterator[np.ndarray]:
        if self.synthetic:
            from facerecognitionpipeline_tpu_torch.serve.client import synthetic_frames

            return synthetic_frames()
        import cv2

        cap = cv2.VideoCapture(self.video_path or self.camera_id)
        if not cap.isOpened():
            raise RuntimeError("Could not open video source")

        def gen():
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                yield cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            cap.release()

        return gen()

    def _draw(self, frame_rgb: np.ndarray) -> np.ndarray:
        import cv2

        img = frame_rgb.copy()
        result = self._last_result
        recognized = result.get("recognized_tracks", {})
        attempts = result.get("recognition_attempts", {})
        failed = result.get("failed_tracks", {})
        for track in result.get("tracks", []):
            tid = str(track["track_id"])
            x1, y1, x2, y2 = [int(v) for v in track["bbox"]]
            if tid in recognized:
                info = recognized[tid]
                color = (0, 255, 0)
                label = f"{info['name']} {info['confidence']:.2f}"
            elif failed.get(tid):
                color = (255, 0, 0)
                label = "Unknown"
            else:
                color = (255, 255, 0)
                label = f"Identifying... ({attempts.get(tid, 0)})"
            cv2.rectangle(img, (x1, y1), (x2, y2), color, 2)
            cv2.putText(img, label, (x1, max(18, y1 - 6)),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.6, color, 2)
        cv2.putText(
            img,
            f"fps {self.fps:.1f} | recognized {len(recognized)}",
            (8, 22), cv2.FONT_HERSHEY_SIMPLEX, 0.6, (255, 255, 255), 2,
        )
        return img

    def run(self) -> int:
        last_time = datetime.now()
        processed = 0
        try:
            for frame in self._source():
                self.frame_count += 1
                if self.frame_count % self.frame_skip == 0:
                    processed += 1
                    # Gate recognition on the PROCESSED-frame count, not the
                    # raw capture count: the tracker's live gate is
                    # `count % recognition_interval == 0` (reference
                    # face_recognition_live.py:38, which processes every
                    # frame), so feeding the raw count composes with
                    # frame_skip into lcm(skip, interval) — e.g. skip 7 x
                    # interval 30 attempted every 210 captured frames, aging
                    # tracks out before their first attempt.
                    self._last_result = self.core.process_full_frame(
                        frame, processed, datetime.now().isoformat()
                    )
                now = datetime.now()
                dt = (now - last_time).total_seconds()
                if dt > 0:
                    self.fps = 0.9 * self.fps + 0.1 * (1.0 / dt)
                last_time = now

                if (
                    self.auto_snapshot_interval > 0
                    and time.time() - self._last_snapshot > self.auto_snapshot_interval
                ):
                    self.core.save_snapshot(
                        base64.b64encode(_encode_png_bytes(frame)).decode(),
                        self.frame_count,
                        datetime.now().strftime("%Y%m%d_%H%M%S"),
                    )
                    self._last_snapshot = time.time()

                if self.display:
                    import cv2

                    cv2.imshow(
                        "live recognition",
                        cv2.cvtColor(self._draw(frame), cv2.COLOR_RGB2BGR),
                    )
                    if (cv2.waitKey(1) & 0xFF) == ord("q"):
                        break
                if self.max_frames and self.frame_count >= self.max_frames:
                    break
        finally:
            self.core.finalize_session()
            self.core.shutdown()
            if self.display:
                try:
                    import cv2

                    cv2.destroyAllWindows()
                except Exception:
                    pass
        return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Live face recognition (single process)")
    p.add_argument("--gallery_path", type=str,
                   default=os.path.join("gallery", "students.pkl"))
    p.add_argument("--threshold", type=float, default=0.4)
    p.add_argument("--session_name", type=str, default=None)
    p.add_argument("--output_dir", type=str, default="sessions")
    p.add_argument("--model_type", type=str, default="adaface",
                   choices=["adaface", "arcface"])
    p.add_argument("--architecture", type=str, default="ir_101",
                   choices=sorted(BACKBONE_CONFIGS))
    p.add_argument("--model_path", type=str, default=None)
    p.add_argument("--recognition_interval", type=int, default=30)
    p.add_argument("--max_attempts", type=int, default=3)
    p.add_argument("--camera_id", type=int, default=0)
    p.add_argument("--video", type=str, default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--frame_skip", type=int, default=5)
    p.add_argument("--max_frames", type=int, default=0)
    p.add_argument("--no_display", action="store_true")
    p.add_argument("--auto_snapshot_interval", type=float, default=0.0)
    p.add_argument("--embed_budget", type=int, default=None,
                   help="per-frame embed budget (see server --embed_budget)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda; fails without a card)")
    p.add_argument("--quantize", type=str, default=None, choices=["int8"],
                   help="int8 post-training-quantized embedder "
                        "(see server --quantize)")
    p.add_argument("--quantize_calib", type=str, default=None,
                   help="directory of aligned crops for int8 calibration "
                        "(see server --quantize_calib)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    app = LiveFaceRecognition(
        gallery_path=args.gallery_path,
        similarity_threshold=args.threshold,
        session_name=args.session_name,
        output_dir=args.output_dir,
        model_type=args.model_type,
        architecture=args.architecture,
        model_path=args.model_path,
        recognition_interval=args.recognition_interval,
        max_attempts=args.max_attempts,
        camera_id=args.camera_id,
        video_path=args.video,
        synthetic=args.synthetic,
        frame_skip=args.frame_skip,
        max_frames=args.max_frames,
        display=not args.no_display,
        auto_snapshot_interval=args.auto_snapshot_interval,
        embed_budget=args.embed_budget,
        quantize=args.quantize,
        quantize_calib=args.quantize_calib,
        device=args.device,
    )
    return app.run()


if __name__ == "__main__":
    raise SystemExit(main())
