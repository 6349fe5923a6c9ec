"""ms of the detect stage alone at B = batch_max frames, its own CUDA graph, CUDA events."""

from benchmark.lib import readings


def read(ctx):
    return readings.stage_ms(ctx, "detect")
