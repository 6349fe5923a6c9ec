"""segment_dataset CLI (the reference flag surface, segment_dataset.py:284-389).

Plus --device (default cuda, as every CLI of the offline chain, so one
--device flag drives the whole chain): the segmenter itself is numpy and the
filesystem, so the flag is only checked (cuda raises without a card).
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Segment probe dataset based on quality metrics for evaluation"
    )
    p.add_argument("--input_dir", type=str,
                   default="output/preprocessed/probe_positive")
    p.add_argument("--metadata_file", type=str,
                   default="output/preprocessed/probe_positive_metadata.json")
    p.add_argument("--output_dir", type=str,
                   default="output/preprocessed/segmented")
    p.add_argument("--symlink", action="store_true",
                   help="Create symlinks instead of copying files")
    p.add_argument("--pose_easy_threshold", type=float, default=15.0)
    p.add_argument("--pose_medium_threshold", type=float, default=30.0)
    p.add_argument("--face_large_threshold", type=int, default=150)
    p.add_argument("--face_medium_threshold", type=int, default=80)
    p.add_argument("--blur_sharp_percentile", type=float, default=50.0)
    p.add_argument("--blur_blurry_percentile", type=float, default=20.0)
    p.add_argument("--det_score_threshold", type=float, default=0.7)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from facerecognitionpipeline_tpu_torch.pipeline.segmentation import ProbeSegmenter
    from facerecognitionpipeline_tpu_torch.utils.device import resolve_device

    resolve_device(args.device)

    segmenter = ProbeSegmenter(
        pose_easy_threshold=args.pose_easy_threshold,
        pose_medium_threshold=args.pose_medium_threshold,
        face_large_threshold=args.face_large_threshold,
        face_medium_threshold=args.face_medium_threshold,
        blur_sharp_percentile=args.blur_sharp_percentile,
        blur_blurry_percentile=args.blur_blurry_percentile,
        det_score_threshold=args.det_score_threshold,
    )
    segmenter.segment_dataset(
        input_dir=args.input_dir,
        metadata_file=args.metadata_file,
        output_dir=args.output_dir,
        copy_files=not args.symlink,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
