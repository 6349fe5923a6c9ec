"""Host-path serving ceiling of the PyTorch port: the full HTTP edge with
the step stubbed.

The flags and defaults of `examples/serving_host_ceiling.py`, plus
`--device`: the real serving path (ThreadingHTTPServer, rawproto parse,
the batcher with its pinned upload and copies back on a card, tracking,
JSON answers) against `serve/bench.py::ZeroCostEngine`, whose outputs lie
on `--device` and cost nothing to make. Whatever requests/s this sustains
is the most any faster step could give the real server on this host. One
raw frame in the transport's own format (I420 by default), clients as
processes of their own (the JAX script runs threads). One JSON line per
client count, then the server's launch report (no kernel may launch).

Run:  python examples/torch_serving_host_ceiling.py [--clients 1 4 8 12]
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
    p.add_argument("--clients", type=int, nargs="+", default=[1, 4, 8, 12])
    p.add_argument("--seconds", type=float, default=12.0)
    p.add_argument("--det", type=int, default=640)
    p.add_argument("--transport", choices=("rgb", "i420"), default="i420",
                   help="i420 (default) matches the raw-i420 serving configuration this "
                        "ceiling is compared against")
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        res = bench.run_host_ceiling(
            clients=args.clients, seconds=args.seconds, det=args.det,
            transport=args.transport, device=args.device,
            on_row=lambda row: print(json.dumps(row), flush=True),
        )
    except bench.BenchError as e:
        print(f"{e}", file=sys.stderr)
        return 1
    print(json.dumps({"server": res["server"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
