"""Detector out-of-distribution report of the PyTorch port (and the
domain-randomized retrain).

The flags and defaults of `examples/detector_ood_eval.py`, plus
`--device`: the OOD suite (the facegen renderer, which no training
renderer shares code with, and JPEG, defocus, low-light and banding
corruptions) at 12 scenes from seed 0 on the base cascade (default: the
first of the shipped weights; held out), and with --retrain the
domain-randomized recipe (2500 steps a net, OHEM 0.7, class balance
0.24/0.23; plain, stress and facegen scenes) trained by the port, its
three nets in parallel processes, then the OOD suite (no longer held out)
and the in-distribution stress suite on it. Writes
reports/detector_ood_torch/report.json and, with --retrain,
pretrained/mtcnn_dr_torch.npz with its .meta.json; the JAX package's
reports and weights are left alone.

Run:  python examples/torch_detector_ood_eval.py [--retrain] [--weights PATH]
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
    p.add_argument("--steps", type=int, default=2500)
    p.add_argument("--class_balance", default="0.24,0.23", metavar="POS,PART",
                   help="per-batch patch-label quota (pos,part fractions)")
    p.add_argument("--n_scenes", type=int, default=12)
    p.add_argument("--output_dir", default=detector_reports.OOD_REPORT_DIR)
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    report = detector_reports.run_ood_report(
        args.weights, args.retrain, args.steps, args.n_scenes, args.class_balance,
        device=args.device)
    path = detector_reports.write_report(report, args.output_dir)
    print(json.dumps({k: v["summary"] for k, v in report.items()}, indent=1))
    print(f"report -> {path}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
