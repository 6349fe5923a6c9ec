"""embedding_generator CLI: produce the eval corpus for one or all models.

The JAX package's flags (the reference `embedding_generator.py:435-498`:
--model_type {adaface,arcface,all}, --architecture {...,all},
--dataset_root, --output_root) plus --device (default cuda; cpu for a run
without a card), --model_path (one weights file, for a single model type
and architecture), --detector_weights and --detector_dtype (bfloat16 takes
K1 on the card).
"""

from __future__ import annotations

import argparse

from facerecognitionpipeline_tpu_torch.cli._detector import add_detector_flags, build_detector
from facerecognitionpipeline_tpu_torch.models.irse import BACKBONE_CONFIGS


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Generate face embeddings for evaluation using multiple models"
    )
    p.add_argument("--model_type", type=str, default="all",
                   choices=["adaface", "arcface", "all"])
    p.add_argument("--architecture", type=str, default="all",
                   choices=sorted(BACKBONE_CONFIGS) + ["all"])
    p.add_argument("--dataset_root", type=str, default="dataset")
    p.add_argument("--output_root", type=str, default="output/v0")
    p.add_argument("--model_path", type=str, default=None,
                   help="Explicit weights path (overrides the zoo table; needs one "
                        "--model_type and one --architecture)")
    add_detector_flags(p)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)

    from facerecognitionpipeline_tpu_torch.pipeline.corpus import EmbeddingGenerator

    model_types = (
        ["adaface", "arcface"] if args.model_type == "all" else [args.model_type]
    )
    architectures = (
        ["ir_50", "ir_101"] if args.architecture == "all" else [args.architecture]
    )
    if args.model_path and len(model_types) * len(architectures) > 1:
        parser.error("--model_path needs one --model_type and one --architecture")

    detector = build_detector(args, det_thresh=0.5)
    for model_type in model_types:
        for arch in architectures:
            gen = EmbeddingGenerator(
                model_type=model_type,
                architecture=arch,
                dataset_root=args.dataset_root,
                output_root=args.output_root,
                model_path=args.model_path,
                detector=detector,
                device=args.device,
            )
            gen.generate_all_embeddings()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
