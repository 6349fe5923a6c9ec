"""The one traffic generator. A mix is a data file of parameters
(`benchmark/traffic/<name>.json`):

  loop      "open": cameras send on a schedule whatever the system does;
            "closed": streams that each keep one frame outstanding
  cameras   open loop: how many cameras
  rate_per_s  open loop: frames a second of all cameras together
  arrivals  open loop: "poisson" (exponential gaps) or "periodic" (each
            camera every cameras / rate_per_s seconds, its phase drawn
            within phase_spread_ms)
  streams   closed loop: how many streams
  pool      how many distinct frames the seed draws (mosaics of the fixture)
  grid      faces a frame holds: grid x grid tiles

Every seed gets the same amount of work: a camera's Poisson gaps are the
quantiles of the exponential distribution (so each camera sends
round(rate x seconds / cameras) frames) in an order drawn from the seed,
and the frames are drawn from a pool of the same size.
"""

from __future__ import annotations

import numpy as np


def open_schedule(mix: dict, seconds: float, rng: np.random.Generator) -> dict:
    """-> {'due' [N] seconds from the window's start (sorted), 'camera' [N],
    'frame' [N] pool indices}."""
    cams = int(mix["cameras"])
    rate_c = float(mix["rate_per_s"]) / cams
    n = max(1, int(round(rate_c * seconds)))
    due, cam = [], []
    for c in range(cams):
        if mix.get("arrivals", "poisson") == "poisson":
            q = (np.arange(n) + 0.5) / n
            g = rng.permutation(-np.log1p(-q))
            g *= seconds / g.sum()
        else:  # periodic
            g = np.full(n, seconds / n)
        phase = rng.random() * (mix.get("phase_spread_ms", 1e3 * seconds / n) / 1e3)
        due.append(phase + np.concatenate([[0.0], np.cumsum(g)[:-1]]))
        cam.append(np.full(n, c))
    due, cam = np.concatenate(due), np.concatenate(cam)
    order = np.argsort(due, kind="stable")
    frame = rng.integers(0, int(mix["pool"]), size=len(due))
    return {"due": due[order], "camera": cam[order], "frame": frame}


def closed_streams(mix: dict, rng: np.random.Generator, length: int = 1 << 14) -> np.ndarray:
    """[streams, length] pool indices: the frames each stream sends in turn."""
    return rng.integers(0, int(mix["pool"]), size=(int(mix["streams"]), length))
