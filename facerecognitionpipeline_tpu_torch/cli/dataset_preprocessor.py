"""dataset_preprocessor CLI: classroom photos -> aligned probe crops.

The JAX package's flags (the reference `dataset_preprocessor.py:256-311`:
--input_dir, --output_dir, --probe_dir, --metadata_file, --output_size,
--det_thresh) plus --device (default cuda; cpu for a run without a card),
--detector_weights and --detector_dtype (bfloat16 takes K1 on the card).
"""

from __future__ import annotations

import argparse

from facerecognitionpipeline_tpu_torch.cli._detector import add_detector_flags, build_detector


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Preprocess classroom dataset for face recognition evaluation"
    )
    p.add_argument("--input_dir", type=str, default="samples/classroom",
                   help="Input directory containing class subdirectories")
    p.add_argument("--output_dir", type=str, default="output/preprocessed")
    p.add_argument("--probe_dir", type=str, default="probe_positive",
                   help="Name of subdirectory for probe images")
    p.add_argument("--metadata_file", type=str,
                   default="probe_positive_metadata.json")
    p.add_argument("--output_size", type=int, default=224)
    p.add_argument("--det_thresh", type=float, default=0.3,
                   help="Detection threshold (lower = more detections)")
    add_detector_flags(p)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from facerecognitionpipeline_tpu_torch.pipeline.preprocessing import DatasetPreprocessor

    pre = DatasetPreprocessor(
        output_size=args.output_size, det_thresh=args.det_thresh,
        detector=build_detector(args, args.det_thresh), device=args.device,
    )
    result = pre.process_dataset(
        input_dir=args.input_dir,
        output_dir=args.output_dir,
        probe_dir_name=args.probe_dir,
        metadata_filename=args.metadata_file,
    )
    return 0 if not result.get("error") else 1


if __name__ == "__main__":
    raise SystemExit(main())
