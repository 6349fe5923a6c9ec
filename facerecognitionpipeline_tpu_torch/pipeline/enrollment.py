"""Student enrollment: directory of face images -> gallery identities.

Counterpart of `facerecognitionpipeline_tpu/pipeline/enrollment.py`, the
reference `StudentEnrollment` (`enroll_students.py:50-402`): per-student
best-face selection, top-N by det_score x blur quality, x8 augmentation,
batched embedding, intra-class similarity check, weighted-mean gallery
aggregation, post-enrollment rank-1 self-verification with inter-class
warnings, `{model}_{arch}` backups. Augmentation of all kept faces is one
batched op on the embedder's device (`ops/augment.py`) and every variant
embeds in one bucketed batch. The gallery file is the port's
`GalleryManager`'s, which the JAX package's manager loads too.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from facerecognitionpipeline_tpu_torch.gallery.manager import GalleryManager
from facerecognitionpipeline_tpu_torch.ops.augment import augment_batch
from facerecognitionpipeline_tpu_torch.pipeline.embedder import FaceEmbedder
from facerecognitionpipeline_tpu_torch.pipeline.processor import FaceProcessor
from facerecognitionpipeline_tpu_torch.utils.io import list_images

ENROLLMENT_QUALITY_CONFIG = {
    "min_det_score": 0.6,
    "min_face_size": 60,
    "max_yaw": 45,
    "max_pitch": 30,
    "max_roll": 30,
    "check_blur": True,
    "blur_threshold": 100,
}


class StudentEnrollment:
    def __init__(
        self,
        gallery_path: Optional[str] = None,
        min_faces_per_student: int = 3,
        max_faces_per_student: int = 5,
        limit_images: int = 0,
        image_indices: Optional[List[int]] = None,
        model_type: str = "adaface",
        architecture: str = "ir_101",
        augmentations_per_face: int = 8,
        processor: Optional[FaceProcessor] = None,
        embedder: Optional[FaceEmbedder] = None,
        gallery: Optional[GalleryManager] = None,
        device="cuda",
    ):
        """device: where the default processor, embedder and gallery run
        ('cuda' raises without a card; CPU runs pass device='cpu'). Parts
        passed in keep their own devices."""
        self.min_faces = min_faces_per_student
        self.max_faces = max_faces_per_student
        self.limit_images = limit_images
        self.image_indices = image_indices
        self.augmentations_per_face = augmentations_per_face
        self.model_type = model_type
        self.architecture = architecture

        self.face_processor = processor or FaceProcessor(
            output_size=224,
            det_size=(640, 640),
            det_thresh=0.5,
            quality_filter_config=dict(ENROLLMENT_QUALITY_CONFIG),
            device=device,
        )
        self.embedder = embedder or FaceEmbedder(
            architecture=architecture, model_type=model_type, device=device
        )
        self.gallery = gallery or GalleryManager(
            gallery_path=gallery_path, aggregation_method="weighted_mean",
            device=device,
        )

    # -------------------------------------------------------------- students

    def process_student_directory(
        self, student_dir: str, student_id: Optional[str] = None
    ) -> Tuple[bool, Dict]:
        student_name = os.path.basename(student_dir)
        if student_id is None:
            # Next free numeric suffix — NOT len(students)+1 (the reference's
            # enroll_students.py:125-126 scheme): after any deletion that
            # collides with a live ID and the overwrite=True below would
            # silently replace an unrelated student.
            taken = {
                int(s[3:]) for s in self.gallery.get_all_students()
                if s.startswith("STU") and s[3:].isdigit()
            }
            student_id = f"STU{max(taken, default=0) + 1:04d}"
        print(f"\nProcessing: {student_name} ({student_id})")

        image_files = list_images(student_dir)
        if not image_files:
            print(f"No images found in {student_dir}")
            return False, {"error": "no_images"}

        if self.image_indices:
            selected = [
                image_files[i - 1]
                for i in self.image_indices
                if 1 <= i <= len(image_files)
            ]
            image_files = selected
        elif self.limit_images > 0:
            image_files = image_files[: self.limit_images]

        all_faces, valid_faces = [], []
        for img_path in image_files:
            try:
                faces = self.face_processor.process_image(img_path, return_all=True)
            except ValueError:
                continue
            if not faces:
                continue
            best = faces[0]
            all_faces.append(best)
            if best["is_valid"]:
                valid_faces.append(best)

        print(f"  {len(valid_faces)}/{len(all_faces)} valid faces")
        if len(valid_faces) < self.min_faces:
            print(f"  Insufficient valid faces ({len(valid_faces)} < {self.min_faces})")
            return False, {
                "error": "insufficient_faces",
                "valid_faces": len(valid_faces),
                "required": self.min_faces,
            }

        if len(valid_faces) > self.max_faces:
            valid_faces.sort(
                key=lambda x: x["det_score"]
                * x["quality_metrics"].get("blur_score", 1000),
                reverse=True,
            )
            valid_faces = valid_faces[: self.max_faces]

        # one batched augmentation over all kept faces, then one batched
        # embed over every variant
        crops = torch.from_numpy(np.stack([f["aligned_face"] for f in valid_faces]))
        augmented = augment_batch(
            crops.to(self.embedder.device), seed=0,
            num_augmentations=self.augmentations_per_face,
        ).cpu().numpy()
        n, a = augmented.shape[:2]
        flat = augmented.reshape(n * a, *augmented.shape[2:])
        embeddings = self.embedder.extract_embeddings_batch(flat, normalize=True)

        sims = np.dot(embeddings, embeddings.T)
        m = len(embeddings)
        avg_similarity = (np.sum(sims) - m) / (m * (m - 1)) if m > 1 else 1.0
        print(f"  {m} embeddings, avg intra-class similarity {avg_similarity:.4f}")
        if avg_similarity < 0.3:
            print(
                f"  Warning: low intra-class similarity ({avg_similarity:.4f}) — "
                f"images may contain different people"
            )

        success = self.gallery.add_student(
            student_id=student_id,
            name=student_name,
            embeddings=embeddings,
            metadata={
                "num_images": len(image_files),
                "num_valid_faces": len(valid_faces),
                "num_augmented_faces": m,
                "augmentation_per_face": self.augmentations_per_face,
                "avg_similarity": float(avg_similarity),
                "source_directory": student_dir,
            },
            overwrite=True,
        )
        return success, {
            "student_id": student_id,
            "name": student_name,
            "num_images": len(image_files),
            "num_valid_faces": len(valid_faces),
            "num_embeddings": m,
            "avg_similarity": float(avg_similarity),
        }

    # ------------------------------------------------------------- directory

    def enroll_from_directory(self, enrollment_dir: str) -> Dict:
        if not os.path.exists(enrollment_dir):
            raise ValueError(f"Enrollment directory not found: {enrollment_dir}")
        student_dirs = [
            os.path.join(enrollment_dir, d)
            for d in sorted(os.listdir(enrollment_dir))
            if os.path.isdir(os.path.join(enrollment_dir, d))
        ]
        if not student_dirs:
            print("No student directories found!")
            return {"error": "no_directories"}

        results, successful, failed = [], 0, 0
        for sd in student_dirs:
            success, info = self.process_student_directory(sd)
            successful += success
            failed += not success
            results.append({"directory": sd, "success": success, "info": info})

        self.gallery.save()
        stats = self.gallery.get_statistics()
        print(
            f"\nENROLLMENT SUMMARY: {successful} enrolled, {failed} failed, "
            f"{stats['num_students']} students / {stats['total_embeddings']} "
            f"embeddings in gallery"
        )
        verification = self.verify_enrollment() if successful > 0 else None
        return {
            "total": len(student_dirs),
            "successful": successful,
            "failed": failed,
            "results": results,
            "gallery_stats": stats,
            "verification": verification,
        }

    # ------------------------------------------------------------ validation

    def verify_enrollment(self) -> Optional[Dict]:
        """Rank-1 self-match over each student's first embedding + inter-class
        similarity stats (reference enroll_students.py:350-402)."""
        students = self.gallery.get_all_students()
        if len(students) < 2:
            print("Need at least 2 students for verification")
            return None

        correct, total, inter = 0, 0, []
        for sid, student in students.items():
            results = self.gallery.search(student.embeddings[0], top_k=3)
            # compare by student_id, not display name: duplicate-named
            # records would otherwise mask a cross-record mismatch exactly
            # when the gallery is corrupted
            if results[0][0] == sid:
                correct += 1
            else:
                print(
                    f"  Mismatch {student.name}: matched {results[0][1]} "
                    f"({results[0][2]:.3f})"
                )
            total += 1
            inter.extend(score for _, _, score in results[1:])

        accuracy = correct / total * 100
        avg_inter = float(np.mean(inter)) if inter else 0.0
        max_inter = float(np.max(inter)) if inter else 0.0
        print(
            f"Verification: rank-1 {correct}/{total} ({accuracy:.1f}%), "
            f"inter-class avg {avg_inter:.3f} / max {max_inter:.3f}"
        )
        if max_inter > 0.6:
            print(f"Warning: high inter-class similarity ({max_inter:.3f})")
        return {
            "rank1_accuracy": accuracy,
            "correct": correct,
            "total": total,
            "avg_inter_class": avg_inter,
            "max_inter_class": max_inter,
        }

    def backup(self, backup_dir: str) -> str:
        """Timestamped `{model}_{arch}`-named backup (enroll_students.py:477-483)."""
        return self.gallery.export_for_backup(
            backup_dir, f"{self.model_type}_{self.architecture}"
        )
