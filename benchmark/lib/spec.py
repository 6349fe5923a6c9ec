"""Where the benchmark finds its parts: `BENCHMARK.json` at the checkout's
root, and for each name in it one file of its own under `benchmark/`:

  configs/<config>.json     the configuration as it is run (the `file` of
                            its entry), with the limits of its comparison
  traffic/<traffic>.json    the parameters the one generator reads
  metrics/<metric>.py       the reader of one per-layer metric: read(ctx)

A later cell, configuration, traffic mix or metric is new files and new
entries; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell(spec: dict, workload: str) -> dict:
    """The workload entry named `workload`."""
    for w in spec["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def config(spec: dict, name: str, root: str = ROOT) -> dict:
    """The configuration file of the config entry `name`."""
    for c in spec["configs"]:
        if c["name"] == name:
            return load_json(os.path.join(root, c["file"]))
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str, bench_dir: str = BENCH_DIR) -> dict:
    return load_json(os.path.join(bench_dir, "traffic", f"{name}.json"))


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def metrics_of(spec: dict, workload: str, trace: bool) -> list:
    """The metric entries a run of `workload` reports: the end-to-end ones
    with --trace 0, the per-layer ones with --trace 1."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group if applies(m, workload)]


def reader(name: str, bench_dir: str = BENCH_DIR):
    """The module metrics/<name>.py (its `read(ctx)` returns a number, or
    None where it finds nothing to read)."""
    path = os.path.join(bench_dir, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
