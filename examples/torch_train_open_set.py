"""Train a headline-family backbone with the PyTorch port, for the open-set
evaluation in `examples/torch_open_set_eval.py`.

The flags and defaults of `examples/train_ir18_open_set.py`, plus
`--device`: ir_18, 360 training identities x 72 crops, B=256 bf16, 6000
steps, AdaFace, cosine schedule after 300 warm-up steps, a held-out probe
every 1000 steps. The recipe of `pretrained/ir_50_synthetic.meta.json`:
`--architecture ir_50 --steps 4500`. Output: pretrained/<arch>_synthetic_torch.npz
and its .meta.json (the JAX package's files are left alone).

Run:  python examples/torch_train_open_set.py [--architecture ir_50 --steps 4500]
      (--probe measures the step time over 30 steps; --device cpu on a machine
      without a card)
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from facerecognitionpipeline_tpu_torch.train.open_set import train_open_set  # noqa: E402


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--architecture", default="ir_18")
    ap.add_argument("--n_ids", type=int, default=360)
    ap.add_argument("--per_id", type=int, default=72)
    ap.add_argument("--steps", type=int, default=6000)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--warmup", type=int, default=300)
    ap.add_argument("--out", default=None,
                    help="weights path (default pretrained/<arch>_synthetic_torch.npz)")
    ap.add_argument("--probe", action="store_true",
                    help="measure step time over 30 steps and exit")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    train_open_set(args.architecture, args.n_ids, args.per_id, args.steps, args.batch,
                   args.lr, args.warmup, args.out, args.probe, args.seed, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
