"""Marginal attribution of the PyTorch port's train step.

`examples/train_profile.py` on the port (`train/profile.py`): the full
`Trainer.train_step` (1024 classes, AdaFace, bf16) and the variants
recomposed from the trainer's pieces (no_opt, fwd_train, fwd_infer,
dummy_head), a bf16 conv stack forward and backward, each p50 ms over CUDA
events, their margins, and the recomposed loss held to the trainer's.
Prints the report and writes reports/train_profile_torch/<arch>_b<batch>.json
with the card's name and power limit.

Run:  python examples/torch_train_profile.py [batch] [arch] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from facerecognitionpipeline_tpu_torch.train import profile  # noqa: E402


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("batch", type=int, nargs="?", default=128)
    ap.add_argument("arch", nargs="?", default="ir_101")
    ap.add_argument("--out_dir", default="reports/train_profile_torch")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    report = profile.train_profile(args.batch, args.arch, device=args.device)
    print(json.dumps(report, indent=2))
    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, f"{args.arch}_b{args.batch}.json"), "w") as f:
        json.dump(report, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
