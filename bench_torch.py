#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port: `bench.py`'s JSON line, measured on
one CUDA card.

The fused recognition step (MTCNN cascade on 640x640 frames, alignment,
quality gate, ir_101 bf16 embedding, gallery top-k) through the port's
engine, B=8 frames x 32 face slots against 1024 ids, with `bench.py`'s
auxiliary routes (embed budget 8, the int8 embedder, full int8, budget 8 on
full int8, 1 048 576 streaming ids in bf16 and int8) and `e2e_rank1`, timed
by `bench.py`'s rule (`facerecognitionpipeline_tpu_torch/pipeline/
step_bench.py`). Prints exactly one JSON line on stdout: `bench.py`'s keys
in its order, then the card's name and power limit (`card`,
`power_limit`); everything else goes to stderr. Without a card it prints
`bench.py`'s error line and exits 1; it never falls back to the CPU unless
asked.

    python3 bench_torch.py               # one CUDA card
    python3 bench_torch.py --device cpu  # the same measurement on the CPU
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import traceback

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def stdout_to_stderr():
    """Whatever the run writes to stdout, from Python or below it, goes to
    stderr: stdout holds the line alone."""
    sys.stdout.flush()
    saved = os.dup(1)
    os.dup2(2, 1)
    try:
        with contextlib.redirect_stdout(sys.stderr):
            yield
    finally:
        sys.stdout.flush()
        os.dup2(saved, 1)
        os.close(saved)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default; needs a card) or 'cpu'")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from facerecognitionpipeline_tpu_torch.pipeline import step_bench

    try:  # without a card `run` raises before it builds anything
        with stdout_to_stderr():
            res = step_bench.run(device=args.device)
    except Exception as e:
        traceback.print_exc()
        print(json.dumps(step_bench.error_line(f"{type(e).__name__}: {e}")), flush=True)
        return 1
    print(json.dumps(res["line"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
