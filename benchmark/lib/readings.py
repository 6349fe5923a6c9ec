"""The arithmetic the metrics' readers share. Each returns None where it
finds nothing to read (off the chip, or a counter that did not count)."""

from __future__ import annotations

import numpy as np

from benchmark.lib import counts


def latency_ms(ctx, q: float):
    lat = np.asarray(ctx.window.latency_s, dtype=np.float64)
    if not len(lat):
        return None
    return float(np.percentile(lat, q)) * 1e3


def frames_per_s(ctx):
    return ctx.window.answered_in_window / ctx.window.seconds


def frames_per_step(ctx):
    if not ctx.steps:
        return None
    return (ctx.window.attempted - ctx.window.failed) / ctx.steps


def stage_ms(ctx, stage: str):
    if ctx.stages is None:
        return None
    return getattr(ctx.stages, f"{stage}_ms")()


def kernels_roofline(ctx):
    """Percent: the kernels' least time over their device time, summed
    over the hand-written kernels a B = batch_max step launches. None where
    one of them shows no device time under its profiler name: the share
    would leave that kernel out unseen."""
    if ctx.stages is None:
        return None
    dev = ctx.stages.kernel_ms()
    bounds = counts.kernel_bounds(ctx.cfg, int(ctx.cfg["batch_max"]))
    least = spent = 0.0
    for kernel, bound_s in bounds.items():
        ms = sum(v for name, v in dev.items()
                 if any(n in name for n in counts.KERNEL_NAMES[kernel]))
        if ms <= 0:
            return None
        least += bound_s * 1e3
        spent += ms
    return 100.0 * least / spent


def step_mfu(ctx):
    """Percent: the step's least time at the peaks over its time."""
    ms = stage_ms(ctx, "step")
    if not ms:
        return None
    return 100.0 * counts.step_least_s(ctx.cfg, int(ctx.cfg["batch_max"])) * 1e3 / ms


def device_idle_pct(ctx):
    a = ctx.activity
    if not a or a.get("window_s", 0) <= 0:
        return None
    return 100.0 * (1.0 - a["busy_s"] / a["window_s"])


def snapshot_ms(ctx):
    return None if ctx.stages is None else ctx.stages.snapshot_ms()
