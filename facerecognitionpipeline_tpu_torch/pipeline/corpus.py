"""Embedding corpus generation for evaluation (the eval-data factory).

Counterpart of `facerecognitionpipeline_tpu/pipeline/corpus.py`, the
reference `EmbeddingGenerator` (`embedding_generator.py:54-433`): produces
the pickled+JSON embedding corpus the evaluation harness consumes — gallery
one-shot/few-shot x base/augmented, probe positive unsegmented/segmented
(per difficulty category), probe negative with real/LFW filename split —
with the same artifact names (`gallery_{type}_{suffix}.pkl`,
`probe_positive_{suffix}.pkl`, `probe_negative.pkl`,
`generation_summary.json`) and dict schemas, so either package's
`load_model_corpus` reads the other's. Embeddings in the pickles are float32
numpy arrays. Every directory's crops embed in one batched forward on the
embedder's device; augmentation is `ops/augment.py::augment_batch` there.
"""

from __future__ import annotations

import json
import os
import pickle
from datetime import datetime
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from facerecognitionpipeline_tpu_torch.ops.augment import augment_batch
from facerecognitionpipeline_tpu_torch.pipeline.embedder import FaceEmbedder
from facerecognitionpipeline_tpu_torch.pipeline.processor import FaceProcessor
from facerecognitionpipeline_tpu_torch.utils.io import imread_rgb, list_images

# The reference has a category-name mismatch: its embedding generator looks
# for 'high_quality' (embedding_generator.py:223) while its segmenter emits
# 'baseline' (segment_dataset.py:27), so the best-quality bucket silently
# vanished from its segmented corpus.  We scan both names so the bucket
# survives regardless of which tool produced the directories.
SEGMENT_CATEGORIES = [
    "baseline", "high_quality", "blur_blurry", "blur_sharp", "face_large",
    "face_medium", "face_small", "pose_easy", "pose_medium", "pose_hard",
    "low_quality",
]


def extract_name_from_filename(filename: str) -> str:
    """'Jane_Doe_001_face0.jpg' -> 'Jane_Doe' (split at the first numeric
    part — reference embedding_generator.py:97-106)."""
    parts = Path(filename).stem.split("_")
    name_parts = []
    for part in parts:
        if part.isdigit():
            break
        name_parts.append(part)
    return "_".join(name_parts) if name_parts else parts[0]


def _to_serializable(obj):
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, dict):
        return {k: _to_serializable(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_to_serializable(v) for v in obj]
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    return obj


class EmbeddingGenerator:
    def __init__(
        self,
        model_type: str = "adaface",
        architecture: str = "ir_101",
        dataset_root: Optional[str] = None,
        output_root: Optional[str] = None,
        embedder: Optional[FaceEmbedder] = None,
        processor: Optional[FaceProcessor] = None,
        model_path: Optional[str] = None,
        detector=None,
        device="cuda",
    ):
        """model_path: the default embedder's weights (default the zoo
        table's file for model_type/architecture); detector: the default
        processor's detector (default an `MTCNNDetector` with the first
        default weights file). device: where the default embedder and
        processor run ('cuda' raises without a card; CPU runs pass
        device='cpu'). Parts passed in keep their own devices."""
        self.model_type = model_type
        self.architecture = architecture
        self.model_name = f"{model_type}_{architecture}"
        self.dataset_root = Path(dataset_root or "dataset")
        self.output_root = Path(output_root or os.path.join("output", "v0"))

        self.embedder = embedder or FaceEmbedder(
            architecture=architecture, model_type=model_type,
            model_path=model_path, device=device,
        )
        self.face_processor = processor or FaceProcessor(
            output_size=112,
            det_size=(640, 640),
            det_thresh=0.5,
            quality_filter_config={"min_det_score": 0.5, "min_face_size": 40},
            detector=detector,
            device=device,
        )
        self.output_dir = self.output_root / "embeddings" / self.model_name
        self.output_dir.mkdir(parents=True, exist_ok=True)

    # ------------------------------------------------------------- artifacts

    def _save(self, data: Dict, output_path: Path) -> None:
        with open(output_path, "wb") as f:
            pickle.dump(data, f)
        with open(output_path.with_suffix(".json"), "w") as f:
            json.dump(_to_serializable(data), f, indent=2)

    def _embed_batch(self, images: List[np.ndarray]) -> np.ndarray:
        return self.embedder.extract_embeddings_batch(images, normalize=True)

    @staticmethod
    def _load_resized(path: str) -> Optional[np.ndarray]:
        """Raw probe crops are embedded without re-detecting
        (embedding_generator.py:265-266); resizing to 112 happens inside
        extract_embeddings_batch (FaceEmbedder._resize_host) so corpus
        embeddings share the serving path's exact resize semantics —
        a second resize implementation here had already drifted (uint8
        default-interp vs float32 INTER_LINEAR)."""
        return imread_rgb(path)

    # --------------------------------------------------------------- gallery

    def process_gallery_enrollment(
        self, enrollment_type: str = "one-shot", use_augmentation: bool = False
    ) -> Dict:
        suffix = "augmented" if use_augmentation else "base"
        gallery_dir = self.dataset_root / "enrollment" / enrollment_type
        if not gallery_dir.exists():
            print(f"Warning: Gallery directory not found: {gallery_dir}")
            return {}

        gallery_embeddings: Dict[str, Dict] = {}
        for person_dir in sorted(d for d in gallery_dir.iterdir() if d.is_dir()):
            person_name = person_dir.name
            faces, valid_files = [], []
            for img_path in list_images(str(person_dir)):
                try:
                    detected = self.face_processor.process_image(
                        img_path, return_all=True
                    )
                except ValueError:
                    continue
                if not detected:
                    continue
                faces.append(detected[0]["aligned_face"])
                valid_files.append(os.path.basename(img_path))
            if not faces:
                print(f"Warning: No usable images for {person_name}")
                continue

            crops = np.stack(faces)
            if use_augmentation:
                aug = augment_batch(
                    torch.from_numpy(crops).to(self.embedder.device), seed=0,
                    num_augmentations=8,
                ).cpu().numpy()
                crops = aug.reshape(-1, *aug.shape[2:])
            embeddings = self._embed_batch(crops)
            gallery_embeddings[person_name] = {
                "embeddings": embeddings,
                "num_images": len(valid_files),
                "num_embeddings": len(embeddings),
                "image_files": valid_files,
                "enrollment_type": enrollment_type,
                "augmented": use_augmentation,
            }

        out = self.output_dir / f"gallery_{enrollment_type}_{suffix}.pkl"
        self._save(gallery_embeddings, out)
        print(f"Gallery {enrollment_type}-{suffix}: "
              f"{len(gallery_embeddings)} persons -> {out}")
        return gallery_embeddings

    # ---------------------------------------------------------------- probes

    def _embed_directory_by_person(self, directory: Path) -> Dict:
        """All crops of one directory -> {person: {embeddings, filenames}},
        via a single batched forward."""
        paths = list_images(str(directory))
        names, images = [], []
        for p in paths:
            img = self._load_resized(p)
            if img is not None:
                names.append(os.path.basename(p))
                images.append(img)
        if not images:
            return {}
        # Pass the list (not a pre-stacked array): raw probe crops can mix
        # sizes (e.g. 250x250 LFW next to real crops) and the embedder
        # resizes per image when given a sequence.
        embeddings = self._embed_batch(images)

        data: Dict[str, Dict] = {}
        for fname, emb in zip(names, embeddings):
            person = extract_name_from_filename(fname)
            entry = data.setdefault(person, {"embeddings": [], "filenames": []})
            entry["embeddings"].append(emb)
            entry["filenames"].append(fname)
        for person in data:
            data[person]["embeddings"] = np.array(data[person]["embeddings"])
        return data

    def process_probe_positive(self, segmented: bool = False) -> Dict:
        if segmented:
            probe_dir = self.output_root / "probe_labeled" / "segmented"
            categories = SEGMENT_CATEGORIES
        else:
            probe_dir = self.output_root / "probe_labeled" / "positive"
            categories = ["."]
        if not probe_dir.exists():
            print(f"Warning: Probe directory not found: {probe_dir}")
            return {}

        probe_embeddings = {}
        for category in categories:
            cat_dir = probe_dir if category == "." else probe_dir / category
            cat_name = "all" if category == "." else category
            if not cat_dir.exists():
                continue
            data = self._embed_directory_by_person(cat_dir)
            if data:
                probe_embeddings[cat_name] = data

        suffix = "segmented" if segmented else "unsegmented"
        out = self.output_dir / f"probe_positive_{suffix}.pkl"
        self._save(probe_embeddings, out)
        print(f"Probe positive ({suffix}): "
              f"{sum(len(v) for v in probe_embeddings.values())} persons -> {out}")
        return probe_embeddings

    def process_probe_negative(self) -> Dict:
        probe_dir = self.output_root / "probe_labeled" / "negative"
        if not probe_dir.exists():
            print(f"Warning: Probe directory not found: {probe_dir}")
            return {}

        paths = list_images(str(probe_dir))
        names, images = [], []
        for p in paths:
            img = self._load_resized(p)
            if img is not None:
                names.append(os.path.basename(p))
                images.append(img)

        negative = {
            "real": {"embeddings": [], "filenames": []},
            "lfw": {"embeddings": [], "filenames": []},
        }
        if images:
            # List, not np.stack: the negative dir deliberately mixes real
            # crops with LFW images of a different size.
            embeddings = self._embed_batch(images)
            for fname, emb in zip(names, embeddings):
                cat = "lfw" if "lfw" in fname.lower() else "real"
                negative[cat]["embeddings"].append(emb)
                negative[cat]["filenames"].append(fname)
        for cat in negative:
            if negative[cat]["embeddings"]:
                negative[cat]["embeddings"] = np.array(negative[cat]["embeddings"])

        out = self.output_dir / "probe_negative.pkl"
        self._save(negative, out)
        return negative

    # ------------------------------------------------------------------- all

    def generate_all_embeddings(self) -> Dict:
        """The 7-pass corpus (embedding_generator.py:360-433)."""
        start = datetime.now()
        g_os_base = self.process_gallery_enrollment("one-shot", False)
        g_os_aug = self.process_gallery_enrollment("one-shot", True)
        g_fs_base = self.process_gallery_enrollment("few-shot", False)
        g_fs_aug = self.process_gallery_enrollment("few-shot", True)
        p_pos_unseg = self.process_probe_positive(segmented=False)
        p_pos_seg = self.process_probe_positive(segmented=True)
        p_neg = self.process_probe_negative()
        duration = (datetime.now() - start).total_seconds()

        summary = {
            "model_type": self.model_type,
            "architecture": self.architecture,
            "model_name": self.model_name,
            "timestamp": datetime.now().isoformat(),
            "duration_seconds": duration,
            "gallery": {
                "one_shot_base_persons": len(g_os_base),
                "one_shot_augmented_persons": len(g_os_aug),
                "few_shot_base_persons": len(g_fs_base),
                "few_shot_augmented_persons": len(g_fs_aug),
            },
            "probe_positive": {
                "unsegmented_categories": list(p_pos_unseg),
                "segmented_categories": list(p_pos_seg),
            },
            "probe_negative": {
                "real_images": len(p_neg.get("real", {}).get("embeddings", [])),
                "lfw_images": len(p_neg.get("lfw", {}).get("embeddings", [])),
            },
            "output_directory": str(self.output_dir),
        }
        with open(self.output_dir / "generation_summary.json", "w") as f:
            json.dump(summary, f, indent=2)
        print(f"EMBEDDING GENERATION COMPLETE ({self.model_name}, {duration:.1f}s)")
        return summary
