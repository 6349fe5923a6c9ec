"""Fault injection for serving-path resilience testing.

Counterpart of `facerecognitionpipeline_tpu/telemetry/faults.py`: a
deterministic fault plan for client/server chaos tests: drop, delay, or
corrupt a fraction of frames before they reach the HTTP edge, so retry /
catch-and-continue behavior is testable instead of hoped-for.
"""

from __future__ import annotations

import base64
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class FaultPlan:
    """Per-frame fault schedule (deterministic given `seed`)."""

    drop_rate: float = 0.0       # frame silently not sent
    corrupt_rate: float = 0.0    # payload bytes garbled
    delay_rate: float = 0.0      # frame delayed by `delay_seconds`
    delay_seconds: float = 0.05
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self.dropped = 0
        self.corrupted = 0
        self.delayed = 0

    def apply(self, payload_b64: str) -> Optional[str]:
        """Returns the (possibly corrupted) payload, None when dropped;
        sleeps when delayed."""
        r = self._rng.random()
        if r < self.drop_rate:
            self.dropped += 1
            return None
        r -= self.drop_rate
        if r < self.corrupt_rate:
            self.corrupted += 1
            raw = bytearray(base64.b64decode(payload_b64))
            if raw:
                for i in self._rng.integers(0, len(raw), size=min(64, len(raw))):
                    raw[i] ^= 0xFF
            return base64.b64encode(bytes(raw)).decode()
        r -= self.corrupt_rate
        if r < self.delay_rate:
            self.delayed += 1
            time.sleep(self.delay_seconds)
        return payload_b64

    def stats(self) -> dict:
        return {
            "dropped": self.dropped,
            "corrupted": self.corrupted,
            "delayed": self.delayed,
        }


class FaultyClientTransport:
    """Wraps a session object with `get(url, ...)` / `post(url, json=...,
    ...)` (the client's `HTTPSession`, or a requests session): applies a
    FaultPlan to /process_frame payloads. Drop -> raises ConnectionError (as
    a network drop would)."""

    def __init__(self, session, plan: FaultPlan):
        self._session = session
        self.plan = plan

    def get(self, *a, **k):
        return self._session.get(*a, **k)

    def close(self) -> None:
        close = getattr(self._session, "close", None)
        if close is not None:
            close()

    def post(self, url, json=None, **k):
        if json and "frame" in json:
            frame = self.plan.apply(json["frame"])
            if frame is None:
                raise ConnectionError("injected frame drop")
            json = dict(json, frame=frame)
        return self._session.post(url, json=json, **k)
