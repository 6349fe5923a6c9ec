"""Percent of the chip's peak one step reaches: its least time at the peaks over step_ms."""

from benchmark.lib import readings


def read(ctx):
    return readings.step_mfu(ctx)
