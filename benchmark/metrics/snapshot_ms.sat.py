"""Host ms of one GalleryManager.device_snapshot() after the window, the median of 20 calls."""

from benchmark.lib import readings


def read(ctx):
    return readings.snapshot_ms(ctx)
