"""Percent of the 3 s of the cell's traffic traced after the window in which no operation ran on the device (torch.profiler)."""

from benchmark.lib import readings


def read(ctx):
    return readings.device_idle_pct(ctx)
