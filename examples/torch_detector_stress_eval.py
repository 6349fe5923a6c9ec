"""Detector stress report of the PyTorch port (and the stress retrain).

The flags and defaults of `examples/detector_stress_eval.py`, plus
`--device`: the stress suites (occlusion, crowding, scale extremes, hard
negatives, face-like distractors, domain shift, motion blur, ...) at 12
scenes from seed 0 on the base cascade, and with --retrain the stress
recipe (1500 steps a net at batch 256, OHEM 0.7, 30% faceless stress
scenes) trained by the port, its three nets in parallel processes. Writes
reports/detector_stress_torch/report.json and, with --retrain,
pretrained/mtcnn_stress_torch.npz with its .meta.json; the JAX package's
reports and weights are left alone.

Run:  python examples/torch_detector_stress_eval.py [--retrain] [--weights PATH]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from facerecognitionpipeline_tpu_torch.evalharness import detector_reports  # noqa: E402


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--weights", default=None)
    p.add_argument("--retrain", action="store_true")
    p.add_argument("--steps", type=int, default=1500, help="per-net training steps")
    p.add_argument("--n_scenes", type=int, default=12)
    p.add_argument("--pure_negative_p", type=float, default=0.3,
                   help="probability a stress training scene is faceless")
    p.add_argument("--class_balance", default=None, metavar="POS,PART",
                   help="fix the patch-label quota per batch (e.g. '0.24,0.23')")
    p.add_argument("--output_dir", default=detector_reports.STRESS_REPORT_DIR)
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    report = detector_reports.run_stress_report(
        args.weights, args.retrain, args.steps, args.n_scenes, args.pure_negative_p,
        args.class_balance, device=args.device)
    detector_reports.write_report(report, args.output_dir)
    print(json.dumps({k: v["summary"] for k, v in report.items()}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
