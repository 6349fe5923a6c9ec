"""Frames answered inside the window over the window's seconds."""

from benchmark.lib import readings


def read(ctx):
    return readings.frames_per_s(ctx)
