"""Multi-client serving benchmark of the PyTorch port over real HTTP.

The flags and defaults of `examples/serving_bench.py`, plus `--device`: the
full server (ir_101 bf16, 640 px detection, max_faces 16, batch_max 8, 23
students of seeded embeddings) on 127.0.0.1 in this process, driven by N
concurrent synthetic 720p camera clients, each a process of its own
(`serve/bench.py`; the JAX script runs them as threads of the server's
process). Per client count a settle run of min(5, seconds / 4) s, then the
measured run: one JSON line with requests/s, latency p50/p95 as the clients
saw them, the server's own request count, steps dispatched, frames per
step, kernel launches, the device, the card and its power limit. Last, one
line with the server's launch report. Exits non-zero without a row when
any client fails.

Run:  python examples/torch_serving_bench.py [--clients 1 4] [--seconds 30]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from facerecognitionpipeline_tpu_torch.serve import bench  # noqa: E402


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--clients", type=int, nargs="+", default=[1, 4])
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--det", type=int, default=640)
    p.add_argument("--batch_max", type=int, default=8)
    p.add_argument("--architecture", default="ir_101")
    p.add_argument("--image_format", choices=("png", "jpeg", "raw", "raw-i420"),
                   default="png")
    p.add_argument("--transport", choices=("rgb", "i420"), default="rgb")
    p.add_argument("--quantize", choices=("int8",), default=None,
                   help="serve the int8-quantized embedder and detector (server --quantize)")
    p.add_argument("--embed_budget", type=int, default=None,
                   help="per-frame embed budget (see server --embed_budget)")
    p.add_argument("--rss_interval", type=float, default=0.0,
                   help="sample this process's RSS (the server's) every N seconds during "
                        "the measured run")
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    print("Starting server...", file=sys.stderr)
    try:
        res = bench.run_serving_bench(
            clients=args.clients, seconds=args.seconds, det=args.det,
            batch_max=args.batch_max, architecture=args.architecture,
            image_format=args.image_format, transport=args.transport,
            quantize=args.quantize, embed_budget=args.embed_budget,
            rss_interval=args.rss_interval, device=args.device,
            on_row=lambda row: print(json.dumps(row), flush=True),
        )
    except bench.BenchError as e:
        print(f"{e}", file=sys.stderr)
        return 1
    print(json.dumps({"server": res["server"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
