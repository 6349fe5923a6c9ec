"""Does the int8 forward move the PyTorch port's training throughput?

`examples/train_int8_probe.py` on the port (`train/profile.py::
int8_probe`): the bf16 train step against the step whose res convs run an
int8 forward (`TrainConfig(int8_forward=True)`, float backward), each p50
ms over CUDA events on a chain of steps on one device-resident batch, then
the loss every 25 steps from a fresh state over 4 batches. Writes the
report (with the card's name and power limit) to --out.

Run:  python examples/torch_train_int8_probe.py [--arch ir_18] [--device cuda]
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
    ap.add_argument("--arch", default="ir_18")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--classes", type=int, default=256)
    ap.add_argument("--converge_steps", type=int, default=200)
    ap.add_argument("--out", default="reports/train_profile_torch/int8_probe.json")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    report = profile.int8_probe(args.arch, args.batch, args.classes, args.converge_steps,
                                device=args.device)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps({k: report[k] for k in ("arch", "batch", "speedup_int8_fwd")}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
