"""Median of every frame's time from when it was due to its answer, in ms."""

from benchmark.lib import readings


def read(ctx):
    return readings.latency_ms(ctx, 50)
