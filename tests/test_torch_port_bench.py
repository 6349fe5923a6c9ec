"""The port's counterpart of `bench.py` (`bench_torch.py`,
`pipeline/step_bench.py`) held to `bench.py` itself, on the CPU.

(a) The line has `bench.py`'s keys in its order, then `card` and
    `power_limit`: the keys are read by `ast` from `bench.py`'s
    `json.dumps({...})` literal (its `**accuracy` spread from
    `_accuracy_block`'s `out`), and so are B, MAX_FACES, GALLERY,
    GALLERY_1M, CHAIN, SAMPLES, the embed budget, the baseline, the metric
    and the uncorrected `sync` text, which the port's constants must equal.
(b) The build's templates and frames are bit-equal to what `bench.py`'s
    own statements draw from `default_rng(0)`, run in numpy in its order.
(c) The timing rule on a fake clock and a fake step: 2 warm steps, then
    SAMPLES windows of CHAIN steps ended by a fetch; the least of 5 probes;
    the correction only when every window exceeds 1.05 x the round trip,
    else (in `run`) every window uncorrected;
    the median to p50, the mean to faces/s; an auxiliary route's keys null
    when a window does not exceed 1.05 x the headline's correction.
(d) The step the bench times equals a direct `engine.step` on the same
    inputs on all 12 result fields (2 frames of 96 px, 4 slots, ir_18,
    64 ids); `measure_route` (on a fake engine) compares the first step to
    the eager step and counts the launches of one more.
(e) `run` at that size with its measurement stubbed: each route's engine
    has `bench.py`'s options (embed_budget, quantize, gallery_impl), the int8
    embedder is built once, and without the ir_micro weights the accuracy
    keys are null with the reason naming the script that trains them.
(f) `bench_torch.py` without a card prints the error line alone and exits 1;
    with one (here: `--device cpu` and `run` stubbed) its stdout holds the
    line alone, whatever the run prints.
(g) The committed `reports/bench_line_torch.jsonl` (runs on the card)
    parses, with every timing key non-null, a card name and a power limit.

The card's run is `chip_smoke.py --bench-only` (and phase 20).
"""

import ast
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from facerecognitionpipeline_tpu_torch.pipeline import stage_profile as sp
from facerecognitionpipeline_tpu_torch.pipeline import step_bench as S

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "bench.py")
RECORD = os.path.join(REPO, "reports", "bench_line_torch.jsonl")
SMALL = dict(b=2, faces=4, det=96, gallery=64, gallery_1m=4096, budget=2,
             architecture="ir_18", chain=2, samples=2)
E2E_FLOOR = 0.75  # chip_smoke.py's, phase 11
ABSENT = os.path.join(REPO, "build", "absent.npz")


def _function(name: str) -> ast.FunctionDef:
    with open(BENCH) as f:
        tree = ast.parse(f.read())
    return next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == name)


def bench_keys() -> list:
    """The keys of `bench.py`'s printed line, in its order."""
    acc = next(n.value for n in ast.walk(_function("_accuracy_block"))
               if isinstance(n, ast.Assign) and isinstance(n.value, ast.Dict)
               and [t.id for t in n.targets] == ["out"])
    line = next(n.args[0] for n in ast.walk(_function("main"))
                if isinstance(n, ast.Call) and getattr(n.func, "attr", None) == "dumps"
                and isinstance(n.args[0], ast.Dict))
    keys = []
    for k in line.keys:
        keys += [ast.literal_eval(a) for a in acc.keys] if k is None else [ast.literal_eval(k)]
    return keys


def bench_constants() -> dict:
    return {n.targets[0].id: ast.literal_eval(n.value) for n in ast.walk(_function("main"))
            if isinstance(n, ast.Assign) and isinstance(n.targets[0], ast.Name)
            and isinstance(n.value, ast.Constant)}


def timing_keys() -> list:
    return [k for k in bench_keys() if k.startswith(("p50_", "faces_per_sec"))
            or k in ("value", "vs_baseline", "sync_roundtrip_ms")]


# ------------------------------------------------ (a) keys and constants


def test_constants_are_bench_pys():
    c = bench_constants()
    assert (S.B, S.MAX_FACES, S.GALLERY, S.GALLERY_1M, S.CHAIN, S.SAMPLES) == (
        c["B"], c["MAX_FACES"], c["GALLERY"], c["GALLERY_1M"], c["CHAIN"], c["SAMPLES"])
    calls = [n for n in ast.walk(_function("main")) if isinstance(n, ast.Call)]
    budgets = {ast.literal_eval(k.value) for n in calls for k in n.keywords
               if k.arg == "embed_budget"}
    assert budgets == {S.EMBED_BUDGET}
    assert {ast.literal_eval(k.value) for n in calls for k in n.keywords
            if k.arg in ("top_k", "gallery_k")} == {sp.TOP_K}
    with open(BENCH) as f:
        source = f.read()
    assert f"1000.0 / {S.BASELINE_MS_PER_FACE}" in source
    assert source.count(f'"{S.METRIC}"') == 2  # the error line and the line
    assert f'"{S.UNCORRECTED}"' in source and "roundtrip * 1.05" in source


def test_the_line_has_bench_pys_keys_in_order_then_the_card(stubbed):
    line = stubbed["res"]["line"]
    assert list(line) == bench_keys() + ["card", "power_limit"]
    assert len(bench_keys()) == 23 and line["metric"] == S.METRIC
    assert (line["frames_per_step"], line["face_slots_per_frame"], line["gallery_size"]) == (
        2, 4, 64)
    assert line["card"] is None and line["power_limit"] is None  # the CPU has no card
    assert list(S.error_line("x")) == ["metric", "value", "unit", "vs_baseline", "error"]
    # LINE_KEYS names every timing key but the two the headline derives
    named = [k for pairs in S.LINE_KEYS.values() for k, _ in pairs]
    assert sorted(named + ["vs_baseline", "sync_roundtrip_ms"]) == sorted(timing_keys())


# -------------------------------------------------------------- (b) build


def test_the_build_draws_bench_pys_arrays():
    """`bench.py`'s own statements for rng, templates and frames, run in
    its order with numpy for jnp."""
    c = bench_constants()
    env = {"np": np, "jnp": types.SimpleNamespace(asarray=np.asarray), **c}
    for node in _function("main").body:
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            target = node.targets[0] if isinstance(node, ast.Assign) else node.target
            if isinstance(target, ast.Name) and target.id in ("rng", "templates", "frames"):
                exec(compile(ast.Module([node], []), BENCH, "exec"), env)
    templates, valid, frames = S.build_inputs(c["B"], S.DET, c["GALLERY"], "cpu")
    assert frames.dtype == torch.uint8
    np.testing.assert_array_equal(frames.numpy(), env["frames"])
    assert templates.dtype == torch.float32
    np.testing.assert_array_equal(templates.numpy()[:c["GALLERY"]], env["templates"])
    assert bool(valid[:c["GALLERY"]].all()) and not bool(valid[c["GALLERY"]:].any())


# --------------------------------------------------------- (c) the rule


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_measure_walls_warms_twice_then_times_the_windows():
    clock, calls, firsts = FakeClock(), [], []
    durations = iter([9.0, 9.0] + [0.1, 0.2, 0.3, 0.4, 0.5, 0.6])

    def step():
        clock.t += next(durations)
        calls.append(clock.t)
        return {"match_scores": torch.zeros((1, 1, 3))}

    walls, events = S.measure_walls(step, samples=3, chain=2, clock=clock,
                                    on_first=firsts.append)
    assert len(calls) == 8 and len(firsts) == 1 and events is None
    np.testing.assert_allclose(walls, [0.3, 0.7, 1.1], rtol=1e-12)
    probes = iter([5.0, 3.0, 4.0, 9.0, 6.0])

    def probe():
        clock.t += next(probes)

    assert S.roundtrip_s(probe, clock) == 3.0


def test_the_correction_applies_only_when_every_window_exceeds_the_round_trip():
    walls, chain, slots = [0.50, 0.30, 0.40], 5, 256
    got = S.figures(walls, 0.1, slots, chain)
    times = (np.array(walls) - 0.1) / chain
    assert got["sync_ok"] and got["correction"] == 0.1
    assert got["p50_ms"] == pytest.approx(np.median(times) * 1e3, rel=1e-12)
    assert got["faces_per_sec"] == pytest.approx(slots / times.mean(), rel=1e-12)
    # one window at 1.05 x the round trip: its figures are null, and the
    # headline takes every window uncorrected
    low = [0.50, 0.105, 0.40]
    short = S.figures(low, 0.1, slots, chain)
    assert not short["sync_ok"] and short["p50_ms"] is None and short["faces_per_sec"] is None
    plain = S.figures(low, 0.0, slots, chain)
    assert plain["sync_ok"] and plain["correction"] == 0.0
    assert plain["p50_ms"] == pytest.approx(0.40 / chain * 1e3, rel=1e-12)
    assert plain["faces_per_sec"] == pytest.approx(slots / (np.mean(low) / chain))
    # the auxiliary routes hold to the headline's correction
    aux = S.figures([0.6, 0.2, 0.4], 0.1, slots, chain)
    assert aux["p50_ms"] == pytest.approx((0.4 - 0.1) / chain * 1e3, rel=1e-12)
    assert aux["faces_per_sec"] == pytest.approx(slots / np.mean([0.1, 0.02, 0.06]), rel=1e-12)
    assert S.figures([0.6, 0.104, 0.4], 0.1, slots, chain)["p50_ms"] is None
    assert S.figures([0.6, 0.104, 0.4], 0.1, slots, chain)["faces_per_sec"] is None
    assert S.figures([0.6, 0.001, 0.4], 0.0, slots, chain)["p50_ms"] == pytest.approx(
        0.4 / chain * 1e3, rel=1e-12)


def test_the_headline_falls_back_to_uncorrected_windows(monkeypatch):
    """`run` with a window under 1.05 x the round trip: `sync` says so and
    p50 and faces/s come from the uncorrected windows."""
    low = [0.0050, 0.000105, 0.0040]

    def measured(engine, templates, valid, frames, dev, samples, chain, warm_first=False):
        return {"options": {}, "walls_s": low, "event_ms": None, "launches": {},
                "fields": [], "differs": [], "roundtrip_s": 1e-4}

    monkeypatch.setattr(S, "measure_route", measured)
    res = S.run(**{**SMALL, "chain": 5, "samples": 3}, aux=(), accuracy=False, device="cpu")
    head, line = res["routes"]["bf16"], res["line"]
    assert not head["sync_ok"] and head["correction"] == 0.0
    assert line["sync"] == S.UNCORRECTED and line["sync_roundtrip_ms"] == 0.1
    assert line["p50_step_ms"] == round(0.0040 / 5 * 1e3, 2)
    assert line["value"] == round(8 / (np.mean(low) / 5), 2)
    assert all(line[k] is None for name in S.AUX for k, _ in S.LINE_KEYS[name])


# ------------------------------------------------------ (d) the step


def test_the_bench_step_equals_engine_step_on_every_field():
    from facerecognitionpipeline_tpu_torch.pipeline.embedder import FaceEmbedder
    from facerecognitionpipeline_tpu_torch.pipeline.engine import RecognitionEngine

    dev = torch.device("cpu")
    engine = RecognitionEngine(
        sp.profile_detector(96, 4, dev),
        FaceEmbedder(architecture="ir_18", dtype=sp.DTYPE, random_ok=True, device=dev),
        top_k=3)
    templates, valid, frames = S.build_inputs(2, 96, 64, dev)
    got = S.bench_step(engine, frames, templates, valid)()
    want = engine.step(templates, valid, frames, gallery_k=3)
    assert len(want) == 12 and got.keys() == want.keys()
    for k in want:
        assert sp.same_tree(got[k], want[k]), k
    assert got["match_scores"].shape == (2, 4, 3)


class FakeEngine:
    """process_frames (the bench's step) and step (the eager yardstick),
    with the attributes `options` reads."""

    def __init__(self, differ: bool):
        self.differ, self.calls = differ, []
        self.embed_budget, self.gallery_impl = None, "auto"
        self.detector = types.SimpleNamespace(quantized=False)
        self.embedder = types.SimpleNamespace(quantized=True)

    def _out(self, x):
        return {"match_scores": torch.full((1, 1, 3), x), "embeddings": torch.zeros(2)}

    def process_frames(self, frames, templates, valid, gallery_k):
        self.calls.append("graph")
        return self._out(1.0)

    def step(self, templates, valid, frames, gallery_k):
        self.calls.append("eager")
        return self._out(2.0 if self.differ else 1.0)


@pytest.mark.parametrize("differ", [False, True])
def test_measure_route_holds_the_first_step_to_the_eager_step(differ):
    engine = FakeEngine(differ)
    t = torch.zeros((8, 512))
    rec = S.measure_route(engine, t, None, None, torch.device("cpu"), samples=2, chain=3)
    assert engine.calls == ["graph", "eager", "graph"] + ["graph"] * 6 + ["graph"]
    assert rec["differs"] == (["match_scores"] if differ else [])
    assert rec["fields"] == ["embeddings", "match_scores"] and rec["launches"] == {}
    assert len(rec["walls_s"]) == 2 and rec["event_ms"] is None and "roundtrip_s" not in rec
    assert rec["options"] == {"embed_budget": None, "detector_quantized": False,
                              "embedder_quantized": True, "gallery_impl": "auto",
                              "gallery_rows": 8, "gallery_dtype": "float32"}
    head = S.measure_route(FakeEngine(False), t, None, None, torch.device("cpu"), 2, 3,
                           warm_first=True)
    assert head["roundtrip_s"] > 0 and head["differs"] == []


# ------------------------------------------------ (e) the routes, stubbed


@pytest.fixture(scope="module")
def stubbed():
    """`run` at the small size with every route's engine built as `bench.py`
    builds it and its measurement stubbed (2 ms windows, a 0.1 ms round
    trip); the int8 detector calibrated on 2 noise frames (the default
    calibration scenes need 224 px or more); the ir_micro weights absent."""
    from facerecognitionpipeline_tpu_torch.models import quantize

    seen = []

    def measured(engine, templates, valid, frames, dev, samples, chain, warm_first=False):
        seen.append((engine, S.options(engine, templates)))
        rec = {"options": S.options(engine, templates), "walls_s": [0.002] * samples,
               "event_ms": None, "launches": {}, "fields": [str(i) for i in range(12)],
               "differs": []}
        if warm_first:
            rec["roundtrip_s"] = 1e-4
        return rec

    def noise(det_size=(640, 640), n=6, seed=0):
        return np.random.default_rng(seed).integers(0, 256, size=(2, *det_size, 3),
                                                    dtype=np.uint8)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(S, "measure_route", measured)
        mp.setattr(quantize, "default_calibration_frames", noise)
        mp.setattr(S, "EMBEDDER_WEIGHTS", ABSENT)
        res = S.run(**SMALL, device="cpu")
    return {"res": res, "seen": seen}


def test_each_route_has_bench_pys_options(stubbed):
    routes = stubbed["res"]["routes"]
    assert list(routes) == ["bf16", *S.AUX]
    rows = S.build_inputs(2, 96, 64, "cpu")[0].shape[0]  # 64 ids, as DeviceGallery pads them
    common = {"embed_budget": None, "detector_quantized": False, "embedder_quantized": False,
              "gallery_impl": "auto", "gallery_rows": rows, "gallery_dtype": "float32"}
    want = {
        "bf16": common,
        "embed_budget8": {**common, "embed_budget": 2},
        "int8": {**common, "embedder_quantized": True},
        "full_int8": {**common, "detector_quantized": True, "embedder_quantized": True},
        "budget8_full_int8": {**common, "embed_budget": 2, "detector_quantized": True,
                              "embedder_quantized": True},
        "gallery_1m_bf16": {**common, "gallery_impl": "streaming", "gallery_rows": 4096,
                            "gallery_dtype": "bfloat16"},
        "gallery_1m_int8": {**common, "gallery_impl": "streaming", "gallery_rows": 4096,
                            "gallery_dtype": "int8"},
    }
    assert {n: r["options"] for n, r in routes.items()} == want
    engines = dict(zip(routes, (e for e, _ in stubbed["seen"])))
    # one int8 embedder for the three int8 routes; one int8 detector for two
    assert engines["int8"].embedder is engines["full_int8"].embedder \
        is engines["budget8_full_int8"].embedder
    assert engines["full_int8"].detector is engines["budget8_full_int8"].detector
    assert engines["bf16"].detector is engines["gallery_1m_int8"].detector


def test_the_stubbed_line_carries_the_rule(stubbed):
    line = stubbed["res"]["line"]
    times = (0.002 - 1e-4) / 2
    assert line["sync"] == "fetch-verified" and line["sync_roundtrip_ms"] == 0.1
    assert line["p50_step_ms"] == round(times * 1e3, 2)
    assert line["value"] == round(8 / times, 2)
    assert line["vs_baseline"] == round(8 / times / (1000.0 / 74.85), 2)
    for key in timing_keys():
        assert line[key] is not None, key
    assert line["pretrained"] is False and line["pretrained_int8"] is False


def test_absent_weights_give_null_accuracy_keys_and_the_reason(stubbed):
    line = stubbed["res"]["line"]
    assert (line["e2e_rank1"], line["e2e_rank1_n"]) == (None, None)
    assert line["accuracy_skipped"] == (
        "build/absent.npz absent — retrain via examples/torch_synthetic_end_to_end.py")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(S, "EMBEDDER_WEIGHTS", ABSENT)
        assert S.accuracy_block(torch.device("cpu")) == {
            "e2e_rank1": None, "e2e_rank1_n": None, "accuracy_skipped": line["accuracy_skipped"]}
    from facerecognitionpipeline_tpu_torch.evalharness import synthetic_demo

    # the file the demo writes (`chip_smoke.py --bench-only` trains it there)
    assert S.EMBEDDER_WEIGHTS == synthetic_demo.EMBEDDER_WEIGHTS == os.path.join(
        REPO, "pretrained", "ir_micro_synthetic_torch.npz")


def test_an_unknown_route_is_refused_and_cuda_is_the_default(monkeypatch):
    with pytest.raises(ValueError, match="unknown auxiliary route"):
        S.run(aux=("sparse",), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        S.run()


# ------------------------------------------------- (f) bench_torch.py


def test_bench_torch_without_a_card_prints_the_error_line_and_exits_1():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    p = subprocess.run([sys.executable, os.path.join(REPO, "bench_torch.py")],
                       capture_output=True, text=True, timeout=120, env=env, cwd=REPO)
    assert p.returncode == 1, p.stderr
    lines = p.stdout.splitlines()
    assert len(lines) == 1
    got = json.loads(lines[0])
    assert list(got) == ["metric", "value", "unit", "vs_baseline", "error"]
    assert (got["metric"], got["value"], got["unit"], got["vs_baseline"]) == (
        S.METRIC, None, "faces/sec", None)
    assert "torch.cuda.is_available() is False" in got["error"]


def test_bench_torch_prints_the_line_alone_on_stdout(monkeypatch, capfd):
    """What the run writes to stdout (from Python or a child process) goes
    to stderr; stdout holds the line alone."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("_bench_torch", os.path.join(REPO,
                                                                                "bench_torch.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    asked = []

    def run(device):
        asked.append(device)
        print("from python")
        subprocess.run([sys.executable, "-c", "print('from a child')"], check=True)
        return {"line": {"metric": S.METRIC, "value": 1.0}}

    monkeypatch.setattr(S, "run", run)
    assert script.main(["--device", "cpu"]) == 0
    out, err = capfd.readouterr()
    assert out.splitlines() == [json.dumps({"metric": S.METRIC, "value": 1.0})]
    assert "from python" in err and "from a child" in err and asked == ["cpu"]


# ------------------------------------------------- (g) the committed runs


def test_the_committed_record_holds_runs_on_a_card():
    with open(RECORD) as f:
        lines = [json.loads(x) for x in f if x.strip()]
    assert len(lines) >= 2
    for line in lines:
        assert list(line) == bench_keys() + ["card", "power_limit"]
        for key in timing_keys():
            assert isinstance(line[key], float) and line[key] > 0, key
        assert line["sync"] in ("fetch-verified", S.UNCORRECTED)
        assert isinstance(line["card"], str) and line["card"]
        assert isinstance(line["power_limit"], str) and line["power_limit"].endswith("W")
        assert line["e2e_rank1"] >= E2E_FLOOR and line["e2e_rank1_n"] > 0
        assert line["accuracy_skipped"] is None
        assert (line["frames_per_step"], line["face_slots_per_frame"], line["gallery_size"]) == (
            S.B, S.MAX_FACES, S.GALLERY)
