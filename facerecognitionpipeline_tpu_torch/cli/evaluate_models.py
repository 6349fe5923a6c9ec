"""evaluate_models CLI: the notebook pipeline (temp.py:968-1141) as a command.

The JAX package's flags (--models, --embeddings_root, --output_dir, the
threshold sweep, --aggregations, --no_plots) plus --device (default cuda;
cpu for a run without a card), where the probes are scored.
"""

from __future__ import annotations

import argparse

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Run the complete identification/verification evaluation"
    )
    p.add_argument(
        "--models", type=str, nargs="+",
        default=["adaface_ir_50", "adaface_ir_101", "arcface_ir_50",
                 "arcface_ir_101"],
        help="Model config names (subdirectories of <embeddings_root>)",
    )
    p.add_argument("--embeddings_root", type=str,
                   default="output/v0/embeddings")
    p.add_argument("--output_dir", type=str, default="output/v0/evaluation")
    p.add_argument("--threshold_start", type=float, default=0.20)
    p.add_argument("--threshold_stop", type=float, default=0.90)
    p.add_argument("--threshold_step", type=float, default=0.05)
    p.add_argument("--aggregations", type=str, nargs="+",
                   default=["max", "mean", "topk"],
                   choices=["max", "mean", "topk"])
    p.add_argument("--no_plots", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from facerecognitionpipeline_tpu_torch.evalharness.pipeline import (
        run_complete_evaluation_pipeline,
    )

    thresholds = [
        round(float(t), 4)
        for t in np.arange(
            args.threshold_start, args.threshold_stop + 1e-9, args.threshold_step
        )
    ]
    out = run_complete_evaluation_pipeline(
        models=args.models,
        embeddings_root=args.embeddings_root,
        output_dir=args.output_dir,
        thresholds=thresholds,
        aggregations=tuple(args.aggregations),
        make_plots=not args.no_plots,
        device=args.device,
    )
    return 0 if out["results"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
