"""enroll_students CLI: build the gallery from per-student image directories.

The JAX package's flags (the reference `enroll_students.py:405-462`:
--enrollment_dir, --gallery_path, --min_faces, --max_faces, --limit_images,
--image_indices, --model_type, --architecture, --backup_dir, and
--model_path, --augmentations) plus --device (default cuda; cpu for a run
without a card). --model_path takes an AdaFace `.ckpt`, an ArcFace `.onnx`
or a JAX-format `.npz`.
"""

from __future__ import annotations

import argparse
import os

from facerecognitionpipeline_tpu_torch.models.irse import BACKBONE_CONFIGS


def _positive_int(value: str) -> int:
    n = int(value)
    if n < 1:
        raise argparse.ArgumentTypeError(
            f"must be >= 1 (got {n}); enrollment always keeps at least the "
            "original crop"
        )
    return n


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Enroll students into the face-recognition gallery"
    )
    p.add_argument("--enrollment_dir", type=str, default="enrollment",
                   help="Directory of per-student image subdirectories")
    p.add_argument("--gallery_path", type=str,
                   default=os.path.join("gallery", "students.pkl"))
    p.add_argument("--min_faces", type=int, default=3,
                   help="Minimum valid faces required per student")
    p.add_argument("--max_faces", type=int, default=5,
                   help="Maximum faces kept per student (best by quality)")
    p.add_argument("--limit_images", type=int, default=0,
                   help="Use only the first N images per student (0 = all)")
    p.add_argument("--image_indices", type=int, nargs="*", default=None,
                   help="Explicit 1-based image indices to use")
    p.add_argument("--model_type", type=str, default="adaface",
                   choices=["adaface", "arcface"])
    p.add_argument("--architecture", type=str, default="ir_101",
                   choices=sorted(BACKBONE_CONFIGS))
    p.add_argument("--model_path", type=str, default=None)
    p.add_argument("--backup_dir", type=str, default=None,
                   help="Write a timestamped {model}_{arch} backup here")
    p.add_argument("--augmentations", type=_positive_int, default=8,
                   help="Augmented variants per kept face (max 16)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from facerecognitionpipeline_tpu_torch.pipeline.embedder import FaceEmbedder
    from facerecognitionpipeline_tpu_torch.pipeline.enrollment import StudentEnrollment

    embedder = FaceEmbedder(
        architecture=args.architecture,
        model_type=args.model_type,
        model_path=args.model_path,
        device=args.device,
    )
    enrollment = StudentEnrollment(
        gallery_path=args.gallery_path,
        min_faces_per_student=args.min_faces,
        max_faces_per_student=args.max_faces,
        limit_images=args.limit_images,
        image_indices=args.image_indices,
        model_type=args.model_type,
        architecture=args.architecture,
        augmentations_per_face=args.augmentations,
        embedder=embedder,
        device=args.device,
    )
    summary = enrollment.enroll_from_directory(args.enrollment_dir)
    if args.backup_dir and summary.get("successful"):
        enrollment.backup(args.backup_dir)
    return 0 if not summary.get("error") else 1


if __name__ == "__main__":
    raise SystemExit(main())
