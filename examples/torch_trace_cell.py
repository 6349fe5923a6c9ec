"""Run one benchmark cell as `benchmark/run.py --trace 0` does, with the
serving batcher's span recorder on across the measured window, and print
what the spans say about it.

    python3 examples/torch_trace_cell.py --workload class1k_rate80 --seed 7 --seconds 40

The last line of standard output is one JSON object: the harness's result
(the end-to-end metrics, `correct`, the device), and under "trace" the
readings of `telemetry/trace.py::summary` (the medians of a frame's four
segments: host queue, device queue, the step on the device, fan-out; the
step's device time, the gallery provider's time, carried dispatches, the
compute stream's idle share), the idle split (seconds of the stream's idle
time under each dispatch-thread span and collection, and the stalls of
0.3 s or more with the spans open across them), the counters over the
window (steps, frames, carried, graph captures, dropped spans) and the
drift between the card's clock and the host's over the window. The same
cell with the recorder off is `benchmark/run.py --trace 0`.

The harness is used as it is: the recorder is switched on and off around
the window's generator (`benchmark/lib/window.py`), where the harness
hands it the batcher's `submit`.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def traced(run, out: list):
    """`run` (a window generator whose first argument is the batcher's
    submit) with the batcher's tracer on around it; the trace goes to
    `out`."""

    def window(submit, *a, **k):
        tracer = submit.__self__.tracer
        tracer.start()
        try:
            return run(submit, *a, **k)
        finally:
            out.append(tracer.stop())

    return window


def span_stats(trace) -> dict:
    """name -> [count, median ms, p95 ms] of the trace's spans."""
    import numpy as np

    by: dict = {}
    for s in trace.spans:
        by.setdefault(s.name, []).append((s.end_ns - s.start_ns) / 1e6)
    return {n: [len(d), float(np.median(d)), float(np.percentile(d, 95))]
            for n, d in sorted(by.items())}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    a = p.parse_args(argv)
    from benchmark.lib import runner, window
    from facerecognitionpipeline_tpu_torch.telemetry import trace as ttrace

    traces: list = []
    window.run_open = traced(window.run_open, traces)
    window.run_closed = traced(window.run_closed, traces)
    rc, result = runner.run(a.workload, a.seed, a.seconds, False, T_START)
    if rc or result is None:
        return rc or 1
    tr = traces[0]
    result["trace"] = {"summary": ttrace.summary(tr), "idle": ttrace.idle_split(tr),
                       "counters": tr.counters, "drift_ns": tr.anchor["drift_ns"],
                       "window_s": (tr.anchor["stop_ns"] - tr.anchor["start_ns"]) / 1e9,
                       "spans": len(tr.spans), "spans_ms": span_stats(tr)}
    result["workload"], result["seed"] = a.workload, a.seed
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
