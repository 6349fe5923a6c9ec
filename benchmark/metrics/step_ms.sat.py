"""ms of one B = batch_max step: the engine's graph replayed back to back, CUDA events."""

from benchmark.lib import readings


def read(ctx):
    return readings.stage_ms(ctx, "step")
