"""Frames from the seed: mosaics of the fixture's face tiles.

`benchmark/data/smoke_scenes.npz` holds 16 tiles of 160 x 160 px, one
rendered face each, with its box and five landmarks. A frame is a grid x
grid mosaic of tiles in an order drawn from the seed, so every frame holds
grid**2 faces at known places.
"""

from __future__ import annotations

import os

import numpy as np

from benchmark.lib.spec import BENCH_DIR

FIXTURE = os.path.join(BENCH_DIR, "data", "smoke_scenes.npz")


def fixture(path: str = FIXTURE) -> dict:
    with np.load(path, allow_pickle=False) as blob:
        return {k: blob[k] for k in blob.files}


def mosaics(fx: dict, n: int, grid: int, rng: np.random.Generator):
    """n frames [n, grid*t, grid*t, 3] uint8 and their tile order [n, grid**2]."""
    tiles = fx["tiles"]
    t = tiles.shape[1]
    order = np.stack([rng.permutation(len(tiles))[:grid * grid] for _ in range(n)])
    frames = np.zeros((n, grid * t, grid * t, 3), np.uint8)
    for f in range(n):
        for p, i in enumerate(order[f]):
            r, c = divmod(p, grid)
            frames[f, r * t:(r + 1) * t, c * t:(c + 1) * t] = tiles[i]
    return frames, order
