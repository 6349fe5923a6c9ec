"""Camera face capture: detect -> track -> accumulate best frames per person.

Counterpart of `facerecognitionpipeline_tpu/serve/capture.py`, the reference
`CameraFaceCapture` (`face_detection.py:230-405`): frame-skip detection,
centroid tracking, per-track best-N frame accumulation into
`output/camera_captures/track_NNN/` with `metadata.json`, q/s/r keyboard
controls, HUD overlay, and the final `session_summary.json`. Detection,
alignment and the gate run on the device (`FaceProcessor.process_numpy`);
tracking and disk IO stay on the host. Video-file and synthetic sources and
--max_frames serve headless runs; --device picks the card or the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
from datetime import datetime
from typing import Dict, Iterator, Optional

import numpy as np

from facerecognitionpipeline_tpu_torch.pipeline.processor import FaceProcessor
from facerecognitionpipeline_tpu_torch.serve.tracker import FrameAccumulator, SimpleTracker


class CameraFaceCapture:
    def __init__(
        self,
        camera_id: int = 0,
        video_path: Optional[str] = None,
        synthetic: bool = False,
        output_dir: str = "output/camera_captures",
        target_frames: int = 12,
        skip_frames: int = 5,
        min_quality_score: float = 0.5,
        max_frames: int = 0,
        display: bool = True,
        processor: Optional[FaceProcessor] = None,
        device="cuda",
    ):
        self.camera_id = camera_id
        self.video_path = video_path
        self.synthetic = synthetic
        self.skip_frames = max(1, skip_frames)
        self.max_frames = max_frames
        self.display = display

        self.processor = processor or FaceProcessor(
            output_size=112,
            det_size=(640, 640),
            det_thresh=0.5,
            quality_filter_config={
                "min_det_score": 0.5,
                "min_face_size": 40,
                "check_blur": True,
                "blur_threshold": 50,
            },
            device=device,
        )
        self.tracker = SimpleTracker(max_disappeared=30, max_distance=80)
        self.accumulator = FrameAccumulator(
            target_frames=target_frames,
            min_quality_score=min_quality_score,
            output_dir=output_dir,
        )
        self.frame_count = 0
        self.fps = 0.0
        self.last_time = datetime.now()
        self._last_tracked: list = []

    # -------------------------------------------------------------- pipeline

    def process_frame(self, frame_rgb: np.ndarray) -> None:
        """Detect every skip_frames-th frame; feed tracker + accumulator."""
        if self.frame_count % self.skip_frames != 0:
            return
        # All faces feed the tracker (so tracks survive momentary quality
        # dips and multiple people are tracked at once); is_valid gates only
        # at the accumulator — reference face_detection.py:271-281 semantics.
        faces = self.processor.process_numpy(frame_rgb, return_all=True)
        tracked = self.tracker.update(faces)
        self._last_tracked = tracked
        for track_id, face in tracked:
            if face.get("is_valid", True):
                self.accumulator.add_frame(track_id, face, frame_rgb)

    def _draw(self, frame_rgb: np.ndarray) -> np.ndarray:
        import cv2

        img = frame_rgb.copy()
        for track_id, face in self._last_tracked:
            x1, y1, x2, y2 = [int(v) for v in np.asarray(face["bbox"])]
            status = self.accumulator.get_status(track_id)
            color = (0, 255, 0) if status == "completed" else (255, 255, 0)
            cv2.rectangle(img, (x1, y1), (x2, y2), color, 2)
            cv2.putText(img, f"track {track_id} [{status}]",
                        (x1, max(18, y1 - 6)),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.6, color, 2)
        cv2.putText(img, f"fps {self.fps:.1f} frame {self.frame_count}",
                    (8, 22), cv2.FONT_HERSHEY_SIMPLEX, 0.6, (255, 255, 255), 2)
        return img

    def _source(self) -> Iterator[np.ndarray]:
        if self.synthetic:
            from facerecognitionpipeline_tpu_torch.serve.client import synthetic_frames

            return synthetic_frames()
        import cv2

        cap = cv2.VideoCapture(self.video_path or self.camera_id)
        if not cap.isOpened():
            raise RuntimeError("Could not open video source")
        if not self.video_path:
            cap.set(cv2.CAP_PROP_FRAME_WIDTH, 1280)
            cap.set(cv2.CAP_PROP_FRAME_HEIGHT, 720)

        def gen():
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                yield cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            cap.release()

        return gen()

    # ------------------------------------------------------------------- run

    def force_save_all(self) -> None:
        for track_id in list(self.accumulator.accumulated_frames):
            if track_id not in self.accumulator.completed_tracks:
                self.accumulator.save_track(track_id)

    def reset(self) -> None:
        self.tracker.tracks.clear()
        self.accumulator.accumulated_frames.clear()
        self.accumulator.completed_tracks.clear()

    def run(self) -> Dict:
        print("CAMERA FACE CAPTURE — controls: q quit, s force-save, r reset")
        try:
            for frame in self._source():
                self.process_frame(frame)
                now = datetime.now()
                dt = (now - self.last_time).total_seconds()
                if dt > 0:
                    self.fps = 0.9 * self.fps + 0.1 * (1.0 / dt)
                self.last_time = now

                if self.display:
                    import cv2

                    cv2.imshow(
                        "Face Capture System",
                        cv2.cvtColor(self._draw(frame), cv2.COLOR_RGB2BGR),
                    )
                    key = cv2.waitKey(1) & 0xFF
                    if key == ord("q"):
                        break
                    if key == ord("s"):
                        self.force_save_all()
                    if key == ord("r"):
                        self.reset()
                self.frame_count += 1
                if self.max_frames and self.frame_count >= self.max_frames:
                    break
        finally:
            if self.display:
                try:
                    import cv2

                    cv2.destroyAllWindows()
                except Exception:
                    pass
        return self.save_summary()

    def save_summary(self) -> Dict:
        summary = {
            "session_end": datetime.now().isoformat(),
            "total_frames_processed": self.frame_count,
            "total_tracks": self.tracker.next_track_id - 1,
            "completed_tracks": len(self.accumulator.completed_tracks),
            "tracks": {str(k): v for k, v in self.accumulator.metadata.items()},
        }
        path = os.path.join(self.accumulator.output_dir, "session_summary.json")
        with open(path, "w") as f:
            json.dump(summary, f, indent=2)
        print(
            f"CAPTURE SUMMARY: {summary['total_tracks']} tracks, "
            f"{summary['completed_tracks']} completed -> {path}"
        )
        return summary


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Camera face capture system")
    p.add_argument("--camera_id", type=int, default=0)
    p.add_argument("--video", type=str, default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--output_dir", type=str, default="output/camera_captures")
    p.add_argument("--target_frames", type=int, default=12)
    p.add_argument("--skip_frames", type=int, default=5)
    p.add_argument("--min_quality", type=float, default=0.5)
    p.add_argument("--max_frames", type=int, default=0)
    p.add_argument("--no_display", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    capture = CameraFaceCapture(
        camera_id=args.camera_id,
        video_path=args.video,
        synthetic=args.synthetic,
        output_dir=args.output_dir,
        target_frames=args.target_frames,
        skip_frames=args.skip_frames,
        min_quality_score=args.min_quality,
        max_frames=args.max_frames,
        display=not args.no_display,
        device=args.device,
    )
    capture.run()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
