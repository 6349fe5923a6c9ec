"""Seconds from the process's start to the window's: loading, the inputs made, the build, calibration, graph capture and warm-up."""


def read(ctx):
    return ctx.setup_s
