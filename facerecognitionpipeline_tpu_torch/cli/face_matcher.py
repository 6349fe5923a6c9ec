"""face_matcher CLI: match camera-capture tracks or a single image.

The JAX package's flags (the reference `face_matcher.py:503-589`:
--capture_dir, --gallery_path, --threshold, --aggregation, --no_save,
--single_image, --top_k, --model_type, --architecture, and --model_path,
--detector_weights) plus --device (default cuda; cpu for a run without a
card). --top_k goes to the gallery search: on the card at streaming scale
the kernels take 1 to 1024.
"""

from __future__ import annotations

import argparse
import os

from facerecognitionpipeline_tpu_torch.models.irse import BACKBONE_CONFIGS
from facerecognitionpipeline_tpu_torch.pipeline.matcher import (
    AGGREGATION_METHODS,
    FaceMatcher,
)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Match detected faces against the student gallery"
    )
    parser.add_argument(
        "--capture_dir", type=str,
        default=os.path.join("output", "camera_captures"),
        help="Directory containing camera capture tracks",
    )
    parser.add_argument(
        "--gallery_path", type=str,
        default=os.path.join("gallery", "students.pkl"),
        help="Path to student gallery database",
    )
    parser.add_argument("--threshold", type=float, default=0.35,
                        help="Similarity threshold for positive match (0-1)")
    parser.add_argument("--aggregation", type=str, default="consensus",
                        choices=list(AGGREGATION_METHODS),
                        help="Method to aggregate multi-frame matches")
    parser.add_argument("--no_save", action="store_true",
                        help="Do not save recognition results to files")
    parser.add_argument("--single_image", type=str, default=None,
                        help="Path to a single image to match instead")
    parser.add_argument("--top_k", type=int, default=5,
                        help="Number of top matches to show per face")
    parser.add_argument("--model_type", type=str, default="adaface",
                        choices=["adaface", "arcface"])
    parser.add_argument("--architecture", type=str, default="ir_101",
                        choices=sorted(BACKBONE_CONFIGS))
    parser.add_argument("--model_path", type=str, default=None,
                        help="Explicit weights path (overrides the zoo table)")
    parser.add_argument("--detector_weights", type=str, default=None,
                        help="Detector cascade weights (.npz / torch file)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from facerecognitionpipeline_tpu_torch.pipeline.embedder import FaceEmbedder

    embedder = FaceEmbedder(
        architecture=args.architecture,
        model_type=args.model_type,
        model_path=args.model_path,
        device=args.device,
    )
    matcher = FaceMatcher(
        gallery_path=args.gallery_path,
        similarity_threshold=args.threshold,
        aggregation_method=args.aggregation,
        model_type=args.model_type,
        architecture=args.architecture,
        embedder=embedder,
        detector_weights=args.detector_weights,
        device=args.device,
    )

    if args.single_image:
        matcher.match_single_image(
            image_path=args.single_image, top_k=args.top_k, save_visualization=True
        )
    else:
        matcher.process_capture_directory(
            capture_dir=args.capture_dir, save_results=not args.no_save
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
