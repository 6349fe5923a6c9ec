"""Dataset preprocessing: classroom photos -> aligned probe crops + metadata.

Counterpart of `facerecognitionpipeline_tpu/pipeline/preprocessing.py`, the
reference `DatasetPreprocessor` (`dataset_preprocessor.py:11-254`): walks
`class_id/[center|left|right]/` angle folders (or infers the angle from the
filename), writes standardized `{class}_{angle}_{idx:03d}_face{k}.jpg` crops
with the permissive quality config (det 0.3, size 30, angles 90), and emits
the per-face `probe_positive_metadata.json` list (same entry schema) plus
the angle distribution report. Detection, alignment and the gate run in the
port's `FaceProcessor` on `device`; a bf16 cascade (`detector=`) takes the
K1 crop kernel on the card.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from facerecognitionpipeline_tpu_torch.pipeline.processor import FaceProcessor
from facerecognitionpipeline_tpu_torch.utils.io import imwrite_rgb, list_images

PERMISSIVE_QUALITY_CONFIG = {
    "min_det_score": 0.3,
    "min_face_size": 30,
    "max_yaw": 90,
    "max_pitch": 90,
    "max_roll": 90,
    "check_blur": True,
    "blur_threshold": 100,
}

ANGLE_FOLDERS = ("center", "left", "right")


class DatasetPreprocessor:
    def __init__(
        self,
        output_size: int = 224,
        det_size: tuple[int, int] = (640, 640),
        det_thresh: float = 0.3,
        quality_filter_config: Optional[Dict] = None,
        processor: Optional[FaceProcessor] = None,
        detector=None,
        device="cuda",
    ):
        """detector: the default processor's detector (default an
        `MTCNNDetector` at det_size/det_thresh with the first default weights
        file). device: where the default processor runs ('cuda' raises
        without a card; CPU runs pass device='cpu')."""
        self.processor = processor or FaceProcessor(
            output_size=output_size,
            det_size=det_size,
            det_thresh=det_thresh,
            quality_filter_config=quality_filter_config
            or dict(PERMISSIVE_QUALITY_CONFIG),
            detector=detector,
            device=device,
        )

    @staticmethod
    def standardize_filename(class_id: str, angle: str, image_idx: int) -> str:
        return f"{class_id}_{angle}_{image_idx:03d}"

    @staticmethod
    def infer_angle(filename: str) -> str:
        low = filename.lower()
        if "left" in low:
            return "left"
        if "right" in low:
            return "right"
        return "center"

    def process_single_image(
        self,
        image_path: str,
        class_id: str,
        angle: str,
        standardized_name: str,
        output_dir: str,
        metadata_list: List[Dict],
    ) -> int:
        """Detect/align every face of one photo; write crops + metadata rows."""
        try:
            faces = self.processor.process_image(image_path, return_all=True)
        except ValueError:
            return 0
        saved = 0
        for face_idx, face in enumerate(faces):
            out_name = f"{standardized_name}_face{face_idx}.jpg"
            imwrite_rgb(os.path.join(output_dir, out_name), face["aligned_face"])
            m = face["quality_metrics"]
            metadata_list.append(
                {
                    "filename": out_name,
                    "class_id": class_id,
                    "source_image": os.path.basename(image_path),
                    "standardized_name": f"{standardized_name}.jpg",
                    "face_index": face_idx,
                    "angle": angle,
                    "det_score": float(face["det_score"]),
                    "yaw": float(m.get("yaw", 0.0)),
                    "pitch": float(m.get("pitch", 0.0)),
                    "roll": float(m.get("roll", 0.0)),
                    "blur_score": float(m.get("blur_score", 0.0)),
                    "face_size": int(m.get("face_size", 0)),
                    "bbox": np.asarray(face["bbox"]).tolist(),
                }
            )
            saved += 1
        return saved

    def process_dataset(
        self,
        input_dir: str,
        output_dir: str,
        probe_dir_name: str = "probe_positive",
        metadata_filename: str = "probe_positive_metadata.json",
    ) -> Dict:
        probe_dir = os.path.join(output_dir, probe_dir_name)
        os.makedirs(probe_dir, exist_ok=True)

        all_metadata: List[Dict] = []
        totals = {"classes": 0, "images": 0, "faces": 0}

        class_dirs = sorted(
            d for d in os.listdir(input_dir)
            if os.path.isdir(os.path.join(input_dir, d))
        )
        if not class_dirs:
            print("No class directories found!")
            return {"error": "no_classes"}

        for class_id in class_dirs:
            class_path = os.path.join(input_dir, class_id)
            totals["classes"] += 1
            has_angles = any(
                os.path.isdir(os.path.join(class_path, a)) for a in ANGLE_FOLDERS
            )
            if has_angles:
                jobs = [
                    (os.path.join(class_path, a), a)
                    for a in ANGLE_FOLDERS
                    if os.path.isdir(os.path.join(class_path, a))
                ]
            else:
                jobs = [(class_path, None)]

            for folder, fixed_angle in jobs:
                for idx, path in enumerate(list_images(folder), start=1):
                    angle = fixed_angle or self.infer_angle(os.path.basename(path))
                    name = self.standardize_filename(class_id, angle, idx)
                    n = self.process_single_image(
                        path, class_id, angle, name, probe_dir, all_metadata
                    )
                    totals["images"] += 1
                    totals["faces"] += n

        metadata_path = os.path.join(output_dir, metadata_filename)
        with open(metadata_path, "w") as f:
            json.dump(all_metadata, f, indent=2)

        angle_counts: Dict[str, int] = {}
        for entry in all_metadata:
            angle_counts[entry["angle"]] = angle_counts.get(entry["angle"], 0) + 1

        print(
            f"PREPROCESSING COMPLETE: {totals['classes']} classes, "
            f"{totals['images']} images, {totals['faces']} faces "
            f"-> {probe_dir} (metadata: {metadata_path})"
        )
        if angle_counts:
            print("Angle distribution: " + ", ".join(
                f"{a}={c}" for a, c in sorted(angle_counts.items())
            ))
        return {**totals, "angle_counts": angle_counts, "metadata_path": metadata_path}
