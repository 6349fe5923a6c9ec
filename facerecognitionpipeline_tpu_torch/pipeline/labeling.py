"""Probe labeling: semi-automatic ground-truthing against the gallery.

Counterpart of `facerecognitionpipeline_tpu/pipeline/labeling.py`, the
reference `ProbeLabeler` (`probe_labeler.py:19-234`): SURE (>=0.5) / UNSURE
(>=0.4) / IMPOSTOR labels, copies into label dirs with a `{matched_name}_`
prefix, `labeling_results.json` with the same summary schema. All probe
crops embed in one batched forward and match in one
`GalleryManager.search_batch`: at streaming scale (from 32 768 identities)
that search is one K3 launch on the card, or one K4 launch for an int8
gallery. On the card those kernels take top_k 1-14 528 (`MAX_TOP_K`) and raise a
ValueError beyond.
"""

from __future__ import annotations

import json
import os
import shutil
from datetime import datetime
from typing import Dict, Optional, Tuple

from facerecognitionpipeline_tpu_torch.gallery.manager import GalleryManager
from facerecognitionpipeline_tpu_torch.pipeline.embedder import FaceEmbedder
from facerecognitionpipeline_tpu_torch.utils.io import imread_rgb, list_images

LABELS = ("SURE", "UNSURE", "IMPOSTOR")


class ProbeLabeler:
    def __init__(
        self,
        gallery_path: Optional[str] = None,
        model_type: str = "adaface",
        architecture: str = "ir_101",
        sure_threshold: float = 0.5,
        unsure_threshold: float = 0.4,
        embedder: Optional[FaceEmbedder] = None,
        gallery: Optional[GalleryManager] = None,
        model_path: Optional[str] = None,
        device="cuda",
    ):
        """model_path: the default embedder's weights (default the zoo
        table's file). device: where the default embedder and gallery run
        ('cuda' raises without a card; CPU runs pass device='cpu'). Parts
        passed in keep their own devices."""
        self.sure_threshold = sure_threshold
        self.unsure_threshold = unsure_threshold
        self.model_type = model_type
        self.architecture = architecture
        self.embedder = embedder or FaceEmbedder(
            architecture=architecture, model_type=model_type,
            model_path=model_path, device=device,
        )
        self.gallery = gallery or GalleryManager(gallery_path=gallery_path, device=device)
        if not self.gallery.get_all_students():
            print("WARNING: Gallery is empty! Please enroll students first.")

    def determine_label(self, confidence: float) -> str:
        if confidence >= self.sure_threshold:
            return "SURE"
        if confidence >= self.unsure_threshold:
            return "UNSURE"
        return "IMPOSTOR"

    def match_face(self, face_image, top_k: int = 3) -> Tuple:
        """Single-probe variant of the batch path (probe_labeler.py:61-77)."""
        emb = self.embedder.extract_embedding(face_image, normalize=True)
        results = self.gallery.search(emb, top_k=top_k)
        if not results:
            return None, "UNKNOWN", 0.0, "IMPOSTOR", []
        sid, name, conf = results[0]
        top = [
            {"student_id": s, "name": n, "score": float(sc), "rank": i + 1}
            for i, (s, n, sc) in enumerate(results)
        ]
        return sid, name, float(conf), self.determine_label(conf), top

    def process_probe_directory(
        self,
        probe_dir: str,
        output_dir: Optional[str] = None,
        metadata_file: Optional[str] = None,
        copy_files: bool = True,
        top_k: int = 3,
    ) -> Dict:
        if not os.path.exists(probe_dir):
            raise ValueError(f"Probe directory not found: {probe_dir}")
        output_dir = output_dir or probe_dir + "_labeled"
        os.makedirs(output_dir, exist_ok=True)
        label_dirs = {}
        if copy_files:
            for lab in LABELS:
                label_dirs[lab] = os.path.join(output_dir, lab)
                os.makedirs(label_dirs[lab], exist_ok=True)

        input_metadata = {}
        if metadata_file and os.path.exists(metadata_file):
            with open(metadata_file) as f:
                for entry in json.load(f):
                    input_metadata[entry["filename"]] = entry

        paths = list_images(probe_dir)
        if not paths:
            print("No image files found in probe directory!")
            return {"error": "no_images"}

        # Batched: read all crops, ONE embed forward, ONE gallery search.
        names, images = [], []
        for p in paths:
            img = imread_rgb(p)
            if img is not None:
                names.append(os.path.basename(p))
                images.append(img)
        if not images:
            # paths existed but none decoded (corrupt files): report it
            # instead of handing a (0,)-shaped batch to the embedder and
            # failing in the gallery search with an opaque shape error
            print(f"No readable images among {len(paths)} files in {probe_dir}")
            return {"error": "no_readable_images", "num_files": len(paths)}
        embeddings = self.embedder.extract_embeddings_batch(images, normalize=True)
        all_matches = self.gallery.search_batch(embeddings, top_k=top_k)

        results = []
        label_counts = {lab: 0 for lab in LABELS}
        for fname, matches in zip(names, all_matches):
            if matches:
                sid, name, conf = matches[0]
                label = self.determine_label(conf)
                top = [
                    {"student_id": s, "name": n, "score": float(sc), "rank": i + 1}
                    for i, (s, n, sc) in enumerate(matches)
                ]
            else:
                sid, name, conf, label, top = None, "UNKNOWN", 0.0, "IMPOSTOR", []
            label_counts[label] += 1
            result = {
                "filename": fname,
                "matched_student_id": sid,
                "matched_name": name,
                "confidence": float(conf),
                "label": label,
                "top_matches": top,
                "original_metadata": input_metadata.get(fname, {}),
            }
            if copy_files:
                dest = os.path.join(label_dirs[label], f"{name}_{fname}")
                shutil.copy2(os.path.join(probe_dir, fname), dest)
                result["labeled_path"] = dest
            results.append(result)

        n = len(results)
        summary = {
            "total_images": len(paths),
            "processed": n,
            "label_distribution": label_counts,
            "sure_percentage": label_counts["SURE"] / n * 100 if n else 0,
            "unsure_percentage": label_counts["UNSURE"] / n * 100 if n else 0,
            "impostor_percentage": label_counts["IMPOSTOR"] / n * 100 if n else 0,
            "settings": {
                "model_type": self.model_type,
                "architecture": self.architecture,
                "sure_threshold": self.sure_threshold,
                "unsure_threshold": self.unsure_threshold,
            },
            "timestamp": datetime.now().isoformat(),
        }
        with open(os.path.join(output_dir, "labeling_results.json"), "w") as f:
            json.dump({"summary": summary, "results": results}, f, indent=2)

        print(
            f"LABELING SUMMARY: {n} processed — SURE {label_counts['SURE']}, "
            f"UNSURE {label_counts['UNSURE']}, IMPOSTOR {label_counts['IMPOSTOR']}"
        )
        return summary
