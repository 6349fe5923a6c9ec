"""Fixtures of the benchmark's CPU tests: a checkout-like root in a
temporary directory holding `BENCHMARK.json` and a copy of `benchmark/`
with tiny cells (ir_micro, 160 px frames of one fixture tile, a few ids)
that run on the CPU in seconds. Card-only tests carry the `cuda` marker
and ask the `card` fixture, which skips without one."""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY = {"architecture": "ir_micro", "units": [1, 1, 1, 1], "det_size": [160, 160],
        "max_faces": 4, "batch_max": 2, "buckets": [1, 2], "gallery_ids": 64,
        "dtype": "float32",
        # float32 against the float32 reference: what the tiny runs read
        # and some room (an altered answer reads far above these)
        "limits": {"det_miss": 0, "det_box_px": 0.01, "det_lmk_px": 0.01, "align_levels": 1.0,
                   "gate_flips": 0, "embed_gap": 1e-5, "match_gap": 1e-5, "failed": 0}}


def make_root(path) -> str:
    root = str(path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    cfgs = os.path.join(root, "benchmark", "configs")
    base = json.load(open(os.path.join(cfgs, "ir101_bf16_class1k.json")))
    tiny = {**base, **TINY}
    tiny8 = {**tiny, "quantize": "int8", "gallery_quantize": "int8",
             "limits": {**TINY["limits"], "det_box_px": 1.0, "det_lmk_px": 1.0,
                        "match_gap": 1e-5}}
    for name, c in (("tiny", tiny), ("tiny8", tiny8)):
        json.dump(c, open(os.path.join(cfgs, f"{name}.json"), "w"))
        spec["configs"].append({"name": name, "source": "https://github.com/mk-minchul/AdaFace",
                                "file": f"benchmark/configs/{name}.json", "reduced": [],
                                "why": "a CPU test's size"})
    tr = os.path.join(root, "benchmark", "traffic")
    json.dump({"loop": "open", "cameras": 2, "rate_per_s": 6.0, "arrivals": "poisson",
               "pool": 4, "grid": 1}, open(os.path.join(tr, "tiny_open.json"), "w"))
    json.dump({"loop": "closed", "streams": 3, "pool": 4, "grid": 1},
              open(os.path.join(tr, "tiny_closed.json"), "w"))
    spec["workloads"] += [
        {"name": "tiny_open", "config": "tiny", "traffic": "tiny_open", "chips": 1, "why": "t"},
        {"name": "tiny_closed", "config": "tiny8", "traffic": "tiny_closed", "chips": 1,
         "why": "t"}]
    for m in spec["end_to_end"] + spec["per_layer"]:
        cells = m.get("workloads")
        if cells is not None:
            if "class1k_rate80" in cells:
                cells.append("tiny_open")
            if "campus1m_int8_saturated" in cells:
                cells.append("tiny_closed")
    json.dump(spec, open(os.path.join(root, "BENCHMARK.json"), "w"))
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def run_tiny(root, workload="tiny_open", seed=20240607, seconds=1.5, **kw):
    import time

    from benchmark.lib import runner

    kw.setdefault("sample", 3)
    return runner.run(workload, seed, seconds, False, time.perf_counter(), device="cpu",
                      root=root, **kw)
