"""One run of one cell: set-up, the window, the readings, the comparison
and the result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (counted in `setup_s`, from the process's start to the window's):
the inputs from the seed, the program built around them with its own
warm-up (every bucket's CUDA graph), then a short burst of the cell's own
frames through the batcher. The window follows the traffic mix. With
--trace 1, after the window, torch.profiler traces 3 s more of the same
traffic, and each per-layer metric's reader takes its reading. The device's
peak memory is read before the program is freed; then the reference runs
and the comparison decides `correct`.
"""

from __future__ import annotations

import gc
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from benchmark.lib import check, faults, frames as frames_mod, spec as spec_mod, system, traffic, window
from benchmark.reference import irse as ref_irse
from benchmark.reference import mtcnn as ref_mtcnn

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "facerecognitionpipeline_tpu")
SAMPLE = 24  # answers the comparison judges
CALIB_FRAMES = 4
TRACE_S = 3.0  # seconds of the cell's traffic that --trace 1 profiles after the window
MARK = "bench.traced_window"


class Context:
    """What a metric's reader reads: the run's window, the configuration,
    the mix, the stage readings (None off the chip), the steps the window
    dispatched (None where the kernels' counters do not count), the
    device's activity in the traffic traced after the window and `setup_s`."""

    def __init__(self, cfg, mix, win, setup_s, stages=None, steps=None, activity=None):
        self.cfg, self.mix, self.window = cfg, mix, win
        self.setup_s = setup_s
        self.stages, self.steps, self.activity = stages, steps, activity


def forbidden_modules() -> list:
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def launches():
    from facerecognitionpipeline_tpu_torch.ops.launches import kernel_counts

    return kernel_counts()


def _build_kernels(log) -> None:
    """The program's kernel libraries built (nvcc, into the checkout's
    build/kernels/) before this process starts CUDA: a run whose process
    forked nvcc after CUDA had started read nothing in torch.profiler.
    Cached libraries make this a no-op."""
    from facerecognitionpipeline_tpu_torch.ops import cuda_build

    took = cuda_build.build_all()
    if took:
        print(f"[bench] built {', '.join(sorted(took))} in {max(took.values()):.1f} s", file=log)


def _host(answer: dict) -> dict:
    """An answer's fields as numpy arrays (device views fetched)."""
    out = {}
    for k, v in answer.items():
        if k == "gallery_ids":
            continue
        out[k] = {a: np.asarray(b) for a, b in v.items()} if isinstance(v, dict) else np.asarray(v)
    return out


def warm(batcher, pool, cfg) -> None:
    """The cell's own path once more before the window: a full batch and
    a lone frame (pinned staging buffers, the streams' first use)."""
    futs = [batcher.submit(pool[i % len(pool)]) for i in range(2 * cfg["batch_max"])]
    for f in futs:
        f.result(timeout=600)
    batcher.submit(pool[0]).result(timeout=600)


def reference_side(cfg: dict, s: dict, fx: dict, inputs: dict, device, root: str):
    """The reference built anew from the seed and the inputs the run
    handed to the program (nothing the program made): float32, or for an
    int8 configuration its own calibration and codes."""
    state = system.seeded_state(cfg["units"], s["weights"], device)
    _, rows, _ = system.gallery_rows(cfg, inputs["identity_rows"].to(device), s["gallery"],
                                     device)
    weights = ref_mtcnn.load_weights(system.detector_weights(cfg, root), device)
    casc = ref_mtcnn.Cascade(weights, cfg["det_size"], cfg["max_faces"], cfg["min_face_size"],
                             device=device)
    emb = ref_irse.Embedder(state, cfg["units"])
    amax = None
    if cfg.get("quantize") == "int8":
        with torch.inference_mode():
            casc.quantize(casc.calibrate(inputs["calib_frames"]))
            amax = emb.calibrate(ref_irse.preprocess(system.fixture_faces(fx, device).round()))
            emb.quantize(amax)
    return check.Reference(cfg, casc, emb, rows, device), state, amax


def prepare(cfg: dict, mix: dict, s: dict, fx: dict, dev, tmp: str, root: str,
            control: bool = False):
    """The inputs from the seeds and the program built around them ->
    (system, frame pool, the inputs the reference shares: calibration
    frames and the identities' gallery rows on the host). `control` builds
    a float configuration's program with its own int8 path instead."""
    prog_cfg = dict(cfg)
    if control and cfg.get("quantize") is None:
        prog_cfg["quantize"] = "int8"  # the program's own lower-precision path
    pool, _ = frames_mod.mosaics(fx, int(mix["pool"]), int(mix["grid"]),
                                 np.random.default_rng(s["frames"]))
    state = system.seeded_state(cfg["units"], s["weights"], dev)
    faces = system.fixture_faces(fx, dev)
    ident = system.identity_rows(cfg, state, faces)
    ids, rows, _ = system.gallery_rows(cfg, ident, s["gallery"], dev)
    calib_faces = faces.round().to(torch.uint8).cpu().numpy()
    calib_frames = pool[:CALIB_FRAMES]
    sut = system.build(prog_cfg, state, ids, rows, calib_faces, calib_frames, tmp, dev, root)
    return sut, pool, {"calib_frames": calib_frames, "identity_rows": ident.cpu()}


def run(workload: str, seed: int, seconds: float, trace: bool, t_start: float,
        device: str = "cuda", root: str = spec_mod.ROOT, control: bool = False,
        sample: int = SAMPLE, fault: str = "", log=sys.stderr):
    """-> (exit code, result dict or None). `control` and `fault` check the
    comparison itself (see `benchmark/lib/faults.py`), never a measurement."""
    spec = spec_mod.benchmark(root)
    w = spec_mod.cell(spec, workload)
    cfg = spec_mod.config(spec, w["config"], root)
    mix = spec_mod.traffic(w["traffic"], os.path.join(root, "benchmark"))
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
            print(f"needs {w['chips']} CUDA device(s); torch sees "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=log)
            return 2, None
        _build_kernels(log)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats(dev)
    s = system.seeds(seed)
    fx = frames_mod.fixture()
    tmp = tempfile.mkdtemp(prefix="bench-")
    try:
        sut, pool, inputs = prepare(cfg, mix, s, fx, dev, tmp, root, control)
        if fault:
            faults.plant(sut.engine, fault)
        warm(sut.batcher, pool, cfg)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        before = launches()
        setup_s = time.perf_counter() - t_start
        print(f"[bench] set-up {setup_s:.3f} s", file=log)
        rng = np.random.default_rng(s["traffic"])
        srng = np.random.default_rng(s["sample"])
        if mix["loop"] == "open":
            sched = traffic.open_schedule(mix, seconds, rng)
            go = lambda: window.run_open(sut.batcher.submit, pool, sched, sample, srng)  # noqa: E731
        else:
            streams = traffic.closed_streams(mix, rng)
            go = lambda: window.run_closed(sut.batcher.submit, pool, streams, seconds,  # noqa: E731
                                           sample, srng)
        win = go()
        after = launches()
        steps = after["warp_patches"] - before["warp_patches"]
        late = np.asarray(win.late_s) * 1e3
        print(f"[bench] window {win.seconds:.3f} s: {win.attempted} frames, {win.failed} failed, "
              f"{win.answered_in_window} answered in it, {steps} steps, drain {win.drain_s:.3f} s"
              + (f", generator late p50 {np.median(late):.3f} ms max {late.max():.3f} ms"
                 if len(late) else ""), file=log)
        print(f"[bench] answered each second: {win.per_second}", file=log)
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        answers = [(fi, _host(f.result())) for fi, f in win.sample]
        activity = None
        if trace and dev.type == "cuda":
            activity = _traced(sut.batcher.submit, pool, mix, np.random.default_rng(s["traffic"]))
        ctx = Context(cfg, mix, win, setup_s, steps=steps or None, activity=activity)
        metrics = {}
        if trace:
            if dev.type == "cuda":
                from benchmark.lib.stages import Stages

                b = int(cfg["batch_max"])
                fr = torch.from_numpy(pool[:b]).to(dev)
                ctx.stages = Stages(sut, fr, int(cfg["top_k"]), getattr(torch, cfg["dtype"]))
        for m in spec_mod.metrics_of(spec, workload, trace):
            v = spec_mod.reader(m["name"], os.path.join(root, "benchmark")).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        ctx.stages = None
        sut.server.shutdown()  # stops the batcher's threads
        del sut
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    with torch.inference_mode():
        ref, state, amax = reference_side(cfg, s, fx, inputs, dev, root)
        control_embed = None
        if control and amax is not None:
            # the reference in the program's place, one precision below
            # the configuration's: int4 codes from the same calibration
            low = ref_irse.Embedder(state, cfg["units"])
            low.quantize(amax, bits=4)
            control_embed = lambda faces: check.embed(low, faces, dev)  # noqa: E731
        vals = check.compare(ref, pool, answers, win.failed, control_embed)
    print(f"[bench] reference {time.perf_counter() - t_ref:.3f} s over {len(answers)} answers",
          file=log)
    limits = cfg["limits"]
    correct = check.verdict(vals, limits) and len(answers) > 0
    found = forbidden_modules()
    if found:
        print(f"[bench] the process holds modules it must not: {', '.join(found)}", file=log)
        return 3, None
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": w["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": win.attempted, "failed": win.failed,
              "metrics": metrics, "device": device_info}
    if trace and activity:
        device_info["busy_s"] = activity["busy_s"]
        device_info["window_s"] = activity["window_s"]
        result["breakdown"] = {"device_ops": activity["device_ops"],
                               "idle_gaps": activity["idle_gaps"]}
    result["checks"] = {n: {"value": vals[n], "limit": limits[n]} for n in check.NAMES}
    for n in check.NAMES:
        print(f"check {n} {vals[n]!r} limit {limits[n]!r}", file=log)
    return 0, result


def _traced(submit, pool, mix: dict, rng):
    """TRACE_S more of the cell's traffic under torch.profiler, after the
    window: the profiler starts and stops while the system is idle (started
    or stopped while the batcher's threads launched kernels, it read
    nothing in some sessions and hung one run), and the marked span is the
    traffic and its drain."""
    from torch.profiler import ProfilerActivity, profile

    from benchmark.lib.stages import device_activity

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(MARK):
            if mix["loop"] == "open":
                window.run_open(submit, pool, traffic.open_schedule(mix, TRACE_S, rng), 0, rng)
            else:
                window.run_closed(submit, pool, traffic.closed_streams(mix, rng), TRACE_S, 0,
                                  rng)
            torch.cuda.synchronize()
    act = device_activity(prof, MARK)
    print(f"[bench] traced {act.get('window_s', 0):.3f} s of the cell's traffic: "
          f"{act.get('n_device_ops', 0)} device and {act.get('n_host_ops', 0)} host operations"
          + ("" if "busy_s" in act else f" (nothing read: {act})"), file=sys.stderr)
    return act if "busy_s" in act else None
