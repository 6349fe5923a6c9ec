"""The harness finds every part of a cell by its name, and a new cell,
configuration, traffic mix or metric is new files and entries only."""

from __future__ import annotations

import json
import os
import re
import shutil

from benchmark.lib import spec as spec_mod
from benchmark.tests.conftest import ROOT, run_tiny

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")


def test_every_part_found_by_name():
    spec = spec_mod.benchmark(ROOT)
    for w in spec["workloads"]:
        cfg = spec_mod.config(spec, w["config"], ROOT)
        assert cfg["limits"] and cfg["units"]
        mix = spec_mod.traffic(w["traffic"])
        assert mix["loop"] in ("open", "closed")
        for trace in (False, True):
            for m in spec_mod.metrics_of(spec, w["name"], trace):
                assert callable(spec_mod.reader(m["name"]).read)


def test_benchmark_json_keeps_the_contract():
    spec = spec_mod.benchmark(ROOT)
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"] and 1 <= spec["run_seconds"] <= 51
    names = [c["name"] for c in spec["configs"]]
    cells = [w["name"] for w in spec["workloads"]]
    metrics = spec["end_to_end"] + spec["per_layer"]
    for n in names + cells + [m["name"] for m in metrics]:
        assert NAME.fullmatch(n), n
    assert len(set(names)) == len(names) and len(set(cells)) == len(cells)
    assert len({m["name"] for m in metrics}) == len(metrics)
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    for m in metrics:
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= set(cells)
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert m["moves"] in e2e and "workloads" in m
        moved = next(x for x in spec["end_to_end"] if x["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    for c in spec["configs"]:
        assert c["file"].startswith("benchmark/configs/") and os.path.isfile(
            os.path.join(ROOT, c["file"]))
        assert c["name"] in {w["config"] for w in spec["workloads"]}
    for w in spec["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        reported = [m for m in spec["end_to_end"] if spec_mod.applies(m, w["name"])]
        assert len(reported) >= 2
        assert any(spec_mod.applies(m, w["name"]) for m in spec["per_layer"])


def test_new_cell_config_mix_and_metric_are_files_and_entries(tiny_root):
    bench = os.path.join(tiny_root, "benchmark")
    before = {os.path.join(d, f): open(os.path.join(d, f), "rb").read()
              for d, _, fs in os.walk(bench) for f in fs}
    shutil.copy(os.path.join(bench, "configs", "tiny.json"),
                os.path.join(bench, "configs", "tiny_b.json"))
    json.dump({"loop": "open", "cameras": 1, "rate_per_s": 4.0, "arrivals": "periodic",
               "pool": 2, "grid": 1}, open(os.path.join(bench, "traffic", "one_cam.json"), "w"))
    with open(os.path.join(bench, "metrics", "answered_frames.py"), "w") as f:
        f.write("def read(ctx):\n    return ctx.window.attempted - ctx.window.failed\n")
    path = os.path.join(tiny_root, "BENCHMARK.json")
    spec = json.load(open(path))
    spec["configs"].append({"name": "tiny_b", "source": "https://github.com/mk-minchul/AdaFace",
                            "file": "benchmark/configs/tiny_b.json", "reduced": [], "why": "t"})
    spec["workloads"].append({"name": "tiny_new", "config": "tiny_b", "traffic": "one_cam",
                              "chips": 1, "why": "t"})
    spec["per_layer"].append({"name": "answered_frames", "unit": "frames", "better": "higher",
                              "source": "program_counter", "layer": "request batcher",
                              "moves": "setup_s", "workloads": ["tiny_new"]})
    json.dump(spec, open(path, "w"))
    after = {p: open(p, "rb").read() for p in before}
    assert after == before  # nothing that was there changed
    import time

    from benchmark.lib import runner

    rc, res = runner.run("tiny_new", 99, 1.0, True, time.perf_counter(), device="cpu",
                         root=tiny_root, sample=2)
    assert rc == 0 and res["correct"]
    assert res["metrics"]["answered_frames"]["value"] == res["attempted"] > 0


def test_result_line_keys_and_checks_last(tiny_root):
    rc, res = run_tiny(tiny_root)
    assert rc == 0
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {"setup_s", "frame_p50_ms", "frame_p95_ms"}
    assert all(set(v) == {"value", "limit"} for v in res["checks"].values())
