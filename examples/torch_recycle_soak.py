"""RSS across worker recycles (--max_requests) of the PyTorch port's server.

The flags and defaults of `examples/recycle_soak.py`, plus `--device`: the
server CLI under its supervisor as a process of its own (ir_18, max_faces
8, batch_max 2, 3 students with seeded random embeddings), one client
process streaming one seeded 480x640 noise frame as base64 PNG to
/process_frame, the serving worker's RSS (pid from /health) and device
memory (/stats) sampled every 10 answers, each generation's start seconds,
the downtime of each recycle and its drain as the client saw them, and the
supervisor stopped with SIGTERM (`serve/soak.py`). Writes the example's
report with those figures to reports/serving_recycle_soak_torch.json (the
JAX package's report is left alone) and exits non-zero when a bound of
`soak.check_soak` is missed.

Run:  python examples/torch_recycle_soak.py [--frames 300] [--max_requests 120]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from facerecognitionpipeline_tpu_torch.serve import soak  # noqa: E402


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--frames", type=int, default=300)
    p.add_argument("--max_requests", type=int, default=120)
    p.add_argument("--port", type=int, default=5181)
    p.add_argument("--output", type=str,
                   default=os.path.join("reports", "serving_recycle_soak_torch.json"))
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    report = soak.example_soak(args.frames, args.max_requests, args.port, device=args.device)
    bad = soak.check_soak(report)
    soak.write_report(args.output, example=report)
    gens = report["generations"]
    print(f"\n{len(gens)} worker generation(s) observed; per-generation growth: "
          f"{[g['growth_mb'] for g in gens]} MB")
    print(f"RSS at each generation's first sample: {[g['rss_first_mb'] for g in gens]} MB; "
          f"start seconds {[round(g['start_s'], 2) for g in gens]}; downtime of each "
          f"recycle {[round(g['downtime_s'], 2) for g in gens[1:]]} s")
    for line in bad:
        print(f"FAIL: {line}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
