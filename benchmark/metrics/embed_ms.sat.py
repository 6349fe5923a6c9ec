"""ms of the embed stage alone at B = batch_max x max_faces slots, its own CUDA graph, CUDA events."""

from benchmark.lib import readings


def read(ctx):
    return readings.stage_ms(ctx, "embed")
