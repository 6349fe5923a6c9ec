"""Percent of their rooflines the hand-written kernels of one step reach together (least time over profiled device time)."""

from benchmark.lib import readings


def read(ctx):
    return readings.kernels_roofline(ctx)
