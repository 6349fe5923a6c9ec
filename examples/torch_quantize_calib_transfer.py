"""The int8 tier's calibration transfer under input shift, on the PyTorch
port.

`examples/quantize_calib_transfer.py` on the port (`evalharness/
quantize_transfer.py`): 96 probes (16 identities x 6) shifted in
brightness (-60..60), contrast (0.4..1.3) and Gaussian noise (0..40); per
shift the int8-vs-fp32 cosine with the shipped synthetic calibration and
with oracle scales recalibrated on the shifted renders, and rank-1 of fp32
and int8 probes against clean fp32 templates. Reads the ir_micro weights
of examples/torch_synthetic_end_to_end.py and writes
reports/quantize_transfer_torch/report.json; the JAX report is left alone.

Run:  python examples/torch_quantize_calib_transfer.py [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from facerecognitionpipeline_tpu_torch.evalharness import quantize_transfer  # noqa: E402


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", type=str, default="ir_micro")
    ap.add_argument("--weights", type=str, default="pretrained/ir_micro_synthetic_torch.npz")
    ap.add_argument("--output_dir", type=str, default="reports/quantize_transfer_torch")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not os.path.exists(args.weights):
        print(f"weights {args.weights} not found — run "
              f"examples/torch_synthetic_end_to_end.py first", file=sys.stderr)
        return 1
    quantize_transfer.run_transfer(args.arch, args.weights, device=args.device,
                                   out_dir=args.output_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
