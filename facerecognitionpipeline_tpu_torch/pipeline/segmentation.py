"""Probe segmentation: bucket aligned probe crops by difficulty.

Counterpart of `facerecognitionpipeline_tpu/pipeline/segmentation.py` (the
reference `ProbeSegmenter`, `segment_dataset.py:8-281`), numpy and the
filesystem only: 10 categories (baseline, pose_easy/medium/hard at 15deg/30deg
of sqrt(yaw^2+pitch^2), face_large/medium/small at 150/80 px,
blur_sharp/blurry at the dataset's 50th/20th percentiles, low_quality
det<0.7), copy-or-symlink into category directories, per-category metadata
JSON, quality-insights report. The percentile fallbacks at the boundaries
and the baseline gate's fixed 0.7 are kept as the JAX package has them.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, List

import numpy as np

CATEGORIES = (
    "baseline",
    "pose_easy",
    "pose_medium",
    "pose_hard",
    "face_large",
    "face_medium",
    "face_small",
    "blur_sharp",
    "blur_blurry",
    "low_quality",
)


class ProbeSegmenter:
    def __init__(
        self,
        pose_easy_threshold: float = 15.0,
        pose_medium_threshold: float = 30.0,
        face_large_threshold: float = 150,
        face_medium_threshold: float = 80,
        blur_sharp_percentile: float = 50.0,
        blur_blurry_percentile: float = 20.0,
        det_score_threshold: float = 0.7,
    ):
        self.pose_easy_threshold = pose_easy_threshold
        self.pose_medium_threshold = pose_medium_threshold
        self.face_large_threshold = face_large_threshold
        self.face_medium_threshold = face_medium_threshold
        self.blur_sharp_percentile = blur_sharp_percentile
        self.blur_blurry_percentile = blur_blurry_percentile
        self.det_score_threshold = det_score_threshold
        self.blur_sharp_threshold: float | None = None
        self.blur_blurry_threshold: float | None = None
        self.categories = list(CATEGORIES)

    def compute_blur_thresholds(self, metadata_list: List[Dict]) -> None:
        """Dataset-relative blur cutoffs (reference segment_dataset.py:38-49)."""
        scores = sorted(m.get("blur_score", 0.0) for m in metadata_list)
        sharp_idx = int(len(scores) * (1 - self.blur_sharp_percentile / 100.0))
        # Out-of-range fallbacks keep the requested semantics at the
        # percentile boundaries (the reference falls back to 0 for both,
        # which inverts them: sharp_percentile=0 would mark EVERYTHING
        # sharp — segment_dataset.py:42-46).  sharp_idx==len means "top 0%
        # sharp" -> +inf admits nothing; blurry_idx==len means "bottom 100%
        # blurry" -> the max score admits everything.
        self.blur_sharp_threshold = (
            scores[sharp_idx] if sharp_idx < len(scores) else float("inf")
        )
        blurry_idx = int(len(scores) * (self.blur_blurry_percentile / 100.0))
        self.blur_blurry_threshold = (
            scores[blurry_idx]
            if blurry_idx < len(scores)
            else (scores[-1] if scores else 0.0)
        )

    def categorize_face(self, metadata: Dict) -> List[str]:
        """Category memberships for one face (reference segment_dataset.py:51-94)."""
        yaw = abs(metadata.get("yaw", 0.0))
        pitch = abs(metadata.get("pitch", 0.0))
        blur = metadata.get("blur_score", 0.0)
        det = metadata.get("det_score", 1.0)
        size = metadata.get("face_size", 0)
        pose = (yaw ** 2 + pitch ** 2) ** 0.5

        cats = []
        if (
            pose <= self.pose_easy_threshold
            and size >= self.face_medium_threshold
            and blur >= self.blur_sharp_threshold
            # 0.7 is hardcoded for parity: the reference's baseline gate does
            # not use det_score_threshold either (segment_dataset.py:62-66);
            # the configurable threshold only drives 'low_quality'.
            and det >= 0.7
        ):
            cats.append("baseline")
        if pose <= self.pose_easy_threshold:
            cats.append("pose_easy")
        elif pose <= self.pose_medium_threshold:
            cats.append("pose_medium")
        else:
            cats.append("pose_hard")
        if size >= self.face_large_threshold:
            cats.append("face_large")
        elif size >= self.face_medium_threshold:
            cats.append("face_medium")
        else:
            cats.append("face_small")
        if blur >= self.blur_sharp_threshold:
            cats.append("blur_sharp")
        if blur <= self.blur_blurry_threshold:
            cats.append("blur_blurry")
        if det < self.det_score_threshold:
            cats.append("low_quality")
        return cats

    def build_filename_mapping(
        self, input_dir: str, metadata_list: List[Dict]
    ) -> Dict[str, str]:
        """Map metadata filenames to actual files (suffix match, handles
        label-prefixed renames — reference segment_dataset.py:95-123)."""
        actual = sorted(os.listdir(input_dir))
        mapping = {}
        for m in metadata_list:
            name = m["filename"]
            for f in actual:
                # Exact match or a label-prefixed rename ('Jane_' + name).
                # The reference's bare endswith (segment_dataset.py:106) can
                # bind class-1 metadata to class-11's file ('...11_x.jpg'
                # ends with '1_x.jpg'); requiring the '_' separator before
                # the suffix removes that cross-class aliasing.
                if f == name or f.endswith("_" + name):
                    mapping[name] = f
                    break
        missing = len(metadata_list) - len(mapping)
        if missing:
            print(f"Warning: {missing} metadata entries without matching files")
        return mapping

    def segment_dataset(
        self,
        input_dir: str,
        metadata_file: str,
        output_dir: str,
        copy_files: bool = True,
    ) -> Dict:
        with open(metadata_file) as f:
            metadata_list = json.load(f)
        self.compute_blur_thresholds(metadata_list)
        mapping = self.build_filename_mapping(input_dir, metadata_list)

        category_dirs = {}
        for cat in self.categories:
            category_dirs[cat] = os.path.join(output_dir, cat)
            os.makedirs(category_dirs[cat], exist_ok=True)

        counts = {c: 0 for c in self.categories}
        category_metadata: Dict[str, List[Dict]] = {c: [] for c in self.categories}
        processed = skipped = 0

        for m in metadata_list:
            name = m["filename"]
            if name not in mapping:
                skipped += 1
                continue
            actual = mapping[name]
            src = os.path.join(input_dir, actual)
            if not os.path.exists(src):
                skipped += 1
                continue
            for cat in self.categorize_face(m):
                dst = os.path.join(category_dirs[cat], actual)
                if copy_files:
                    shutil.copy2(src, dst)
                else:
                    if os.path.lexists(dst):
                        os.remove(dst)
                    os.symlink(os.path.relpath(src, category_dirs[cat]), dst)
                counts[cat] += 1
                entry = dict(m)
                entry["labeled_filename"] = actual
                category_metadata[cat].append(entry)
            processed += 1

        for cat in self.categories:
            with open(
                os.path.join(category_dirs[cat], f"{cat}_metadata.json"), "w"
            ) as f:
                json.dump(category_metadata[cat], f, indent=2)

        print(f"SEGMENTATION COMPLETE: {processed} faces, {skipped} skipped")
        for cat in self.categories:
            pct = counts[cat] / processed * 100 if processed else 0
            print(f"  {cat:15s}: {counts[cat]:5d} faces ({pct:5.1f}%)")
        insights = self.quality_insights(metadata_list)
        return {
            "processed": processed,
            "skipped": skipped,
            "category_counts": counts,
            "insights": insights,
            "blur_sharp_threshold": self.blur_sharp_threshold,
            "blur_blurry_threshold": self.blur_blurry_threshold,
        }

    def quality_insights(self, metadata_list: List[Dict]) -> Dict:
        """Vectorized distribution report (reference segment_dataset.py:235-281)."""
        yaw = np.array([abs(m.get("yaw", 0.0)) for m in metadata_list])
        pitch = np.array([abs(m.get("pitch", 0.0)) for m in metadata_list])
        blur = np.array([m.get("blur_score", 0.0) for m in metadata_list])
        det = np.array([m.get("det_score", 1.0) for m in metadata_list])
        size = np.array([m.get("face_size", 0) for m in metadata_list])
        pose = np.sqrt(yaw ** 2 + pitch ** 2)
        total = max(len(metadata_list), 1)

        insights = {
            "total": len(metadata_list),
            "baseline": int(
                np.sum(
                    (pose <= self.pose_easy_threshold)
                    & (size >= self.face_medium_threshold)
                    & (blur >= self.blur_sharp_threshold)
                    & (det >= 0.7)
                )
            ),
            "pose_easy": int(np.sum(pose <= self.pose_easy_threshold)),
            "pose_medium": int(
                np.sum(
                    (pose > self.pose_easy_threshold)
                    & (pose <= self.pose_medium_threshold)
                )
            ),
            "pose_hard": int(np.sum(pose > self.pose_medium_threshold)),
            "face_large": int(np.sum(size >= self.face_large_threshold)),
            "face_medium": int(
                np.sum(
                    (size >= self.face_medium_threshold)
                    & (size < self.face_large_threshold)
                )
            ),
            "face_small": int(np.sum(size < self.face_medium_threshold)),
            "blur_sharp": int(np.sum(blur >= self.blur_sharp_threshold)),
            "blur_blurry": int(np.sum(blur <= self.blur_blurry_threshold)),
            "low_det": int(np.sum(det < self.det_score_threshold)),
        }
        print(
            f"Quality insights: baseline {insights['baseline']}/{total}, pose "
            f"e/m/h {insights['pose_easy']}/{insights['pose_medium']}/"
            f"{insights['pose_hard']}, size l/m/s {insights['face_large']}/"
            f"{insights['face_medium']}/{insights['face_small']}"
        )
        return insights
