"""The all-synthetic end-to-end demo on the PyTorch port: it trains,
enrols and recognises with no asset from outside the repository.

`examples/synthetic_end_to_end.py` on the port (`evalharness/
synthetic_demo.py`): the shipped float32 cascade
(pretrained/mtcnn_synthetic.npz, trained and saved when missing), ir_micro
trained for 400 steps on 16 rendered identities with half of each batch
detector-aligned (cached at pretrained/ir_micro_synthetic_torch.npz), 4
aligned crops enrolled per identity, 20 rendered scenes recognised through
detect -> align -> embed -> match, then again with the int8 embedder
calibrated on the enrolment crops, and its drift over 32 probes. Writes
reports/synthetic_e2e_torch/{report.json,report.txt}; exits 1 when rank-1
falls below 0.6 in fp32 or int8, as the JAX script does.

Run:  python examples/torch_synthetic_end_to_end.py [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from facerecognitionpipeline_tpu_torch.evalharness import synthetic_demo  # noqa: E402


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    rep = synthetic_demo.run_demo(device=args.device)
    return 0 if rep["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
