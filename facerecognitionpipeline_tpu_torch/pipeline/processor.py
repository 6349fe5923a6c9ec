"""FaceProcessor: detect -> align -> quality-gate, the host pipeline's core.

Counterpart of `facerecognitionpipeline_tpu/pipeline/processor.py`, the
reference `FaceProcessor` (`face_recognition.py:160-216`): the same per-face
result schema ({aligned_face, bbox, landmarks, det_score, quality_metrics,
is_valid}) and best-face order by det_score x blur_score. Detection is the
MTCNN cascade on the device (`models/detector.py`); every face of an image
is aligned by one gather warp (`ops/warp.py::align_faces`) and gated by one
batched quality check (`_align_and_gate`), on the processor's device.
`process_frames_device` keeps detect -> align -> gate on the device for a
batch of det_size frames.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from facerecognitionpipeline_tpu_torch.ops.quality import QualityConfig, quality_check
from facerecognitionpipeline_tpu_torch.ops.warp import align_faces, reference_template
from facerecognitionpipeline_tpu_torch.utils.device import resolve_device
from facerecognitionpipeline_tpu_torch.utils.io import imread_rgb


class FaceProcessor:
    def __init__(
        self,
        output_size: int = 224,
        det_size: tuple[int, int] = (640, 640),
        det_thresh: float = 0.5,
        quality_filter_config: Optional[Dict] = None,
        detector=None,
        max_faces: int = 32,
        device="cuda",
    ):
        """detector: anything with `detect(image) -> list of face dicts`
        (and `detect_device` for `process_frames_device`); default an
        `MTCNNDetector` on `device` with the first default weights file.
        device: where alignment and the gate run ('cuda' raises without a
        card; CPU runs pass device='cpu')."""
        self.device = resolve_device(device)
        if detector is None:
            from facerecognitionpipeline_tpu_torch.models.detector import MTCNNDetector

            detector = MTCNNDetector(
                det_size=det_size, det_thresh=det_thresh, max_faces=max_faces,
                device=self.device,
            )
        self.detector = detector
        self.output_size = output_size
        self.template = torch.from_numpy(reference_template(output_size)).to(self.device)
        self.quality_config = QualityConfig(**(quality_filter_config or {}))

    # ------------------------------------------------------------- device op

    def _align_and_gate(self, image, landmarks, bboxes, scores, valid):
        """One image [H,W,3] float32 + its detections -> (aligned crops
        [F,S,S,3] rounded and clipped to 0..255, ok [F], metrics)."""
        aligned = align_faces(image, landmarks, self.template, self.output_size)
        aligned = torch.clamp(torch.round(aligned), 0, 255)
        ok, metrics = quality_check(
            scores,
            bboxes,
            landmarks,
            self.quality_config,
            aligned_faces=aligned if self.quality_config.check_blur else None,
            valid_mask=valid,
        )
        return aligned, ok, metrics

    def process_frames_device(self, frames: torch.Tensor):
        """[B,H,W,3] det_size frames on the device -> (detections dict,
        aligned [B,F,S,S,3], ok [B,F], metrics of [B,F])."""
        with torch.inference_mode():
            det = self.detector.detect_device(frames)
            f32 = frames.float()
            aligned = torch.stack([
                align_faces(f32[i], det["landmarks"][i], self.template, self.output_size)
                for i in range(frames.shape[0])
            ])
            aligned = torch.clamp(torch.round(aligned), 0, 255)
            ok, metrics = quality_check(
                det["scores"], det["bboxes"], det["landmarks"], self.quality_config,
                aligned_faces=aligned if self.quality_config.check_blur else None,
                valid_mask=det["valid"],
            )
        return det, aligned, ok, metrics

    # --------------------------------------------------------------- host API

    def process_image(self, image_path: str, return_all: bool = False) -> List[Dict]:
        """Read from disk, then `process_numpy`."""
        image = imread_rgb(image_path)
        if image is None:
            raise ValueError(f"Could not load image: {image_path}")
        return self.process_numpy(image, return_all)

    def process_numpy(self, image_rgb: np.ndarray, return_all: bool = False) -> List[Dict]:
        """RGB (or grayscale) array -> per-face dicts sorted by det_score *
        blur_score; the best face only unless return_all."""
        if image_rgb.ndim == 2:
            image_rgb = np.stack([image_rgb] * 3, axis=-1)
        faces = self.detector.detect(image_rgb)
        if not faces:
            return []

        f = len(faces)
        landmarks = np.stack([fc["landmarks"] for fc in faces]).astype(np.float32)
        bboxes = np.stack([fc["bbox"] for fc in faces]).astype(np.float32)
        scores = np.array([fc["det_score"] for fc in faces], np.float32)

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        with torch.inference_mode():
            aligned, ok, metrics = self._align_and_gate(
                dev(image_rgb.astype(np.float32)), dev(landmarks), dev(bboxes),
                dev(scores), torch.ones(f, dtype=torch.bool, device=self.device),
            )
        aligned = aligned.cpu().numpy().astype(np.uint8)
        ok = ok.cpu().numpy()
        metrics = {k: v.cpu().numpy() for k, v in metrics.items()}

        results = []
        for i, face in enumerate(faces):
            is_valid = bool(ok[i])
            if is_valid or return_all:
                results.append({
                    "aligned_face": aligned[i],
                    "bbox": np.asarray(face["bbox"], np.int32),
                    "landmarks": landmarks[i],
                    "det_score": float(scores[i]),
                    "quality_metrics": {k: float(v[i]) for k, v in metrics.items()},
                    "is_valid": is_valid,
                })

        results.sort(
            key=lambda r: r["det_score"] * r["quality_metrics"].get("blur_score", 1000),
            reverse=True,
        )
        if not return_all and results:
            return [results[0]]
        return results
