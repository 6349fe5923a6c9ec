"""The detector flags shared by the CLIs that detect faces."""

from __future__ import annotations

import argparse


def add_detector_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--detector_weights", type=str, default=None,
                   help="Detector cascade weights (.npz / torch file); default "
                        "the first default weights file")
    p.add_argument("--detector_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="Cascade dtype; bfloat16 takes the K1 crop kernel on "
                        "the card")


def build_detector(args, det_thresh: float):
    """An `MTCNNDetector` at 640x640 from the parsed flags, on --device."""
    import torch

    from facerecognitionpipeline_tpu_torch.models.detector import MTCNNDetector

    return MTCNNDetector(
        det_size=(640, 640), det_thresh=det_thresh,
        weights_path=args.detector_weights,
        dtype=getattr(torch, args.detector_dtype), device=args.device,
    )
