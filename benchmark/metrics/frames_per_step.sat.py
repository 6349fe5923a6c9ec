"""Frames answered over the steps the batcher dispatched in the window (K2's launch counter: one a step)."""

from benchmark.lib import readings


def read(ctx):
    return readings.frames_per_step(ctx)
