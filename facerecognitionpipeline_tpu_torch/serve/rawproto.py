"""Raw binary frame transport shared by the server and the camera client.

Counterpart of `facerecognitionpipeline_tpu/serve/rawproto.py`. The legacy
`/process_frame` contract ships every frame as base64 PNG/JPEG inside JSON;
the server then pays base64 decode + image decode + letterbox (+ RGB->I420
for the i420 engine) per frame on its host cores.

`/process_frame_raw` moves that work to the clients: each client letterboxes
to the server's detection canvas and POSTs the raw planes as
`application/octet-stream`. The server's hot path is then a zero-copy
`np.frombuffer` + reshape.

Wire format (HTTP headers + body):

  X-Frame-Format : "rgb24" (H*W*3 bytes, RGB row-major) or
                   "i420"  (H*3//2 * W bytes, cv2 planar I420 layout)
  X-Frame-Width  : canvas width  == server det_size width
  X-Frame-Height : canvas height == server det_size height
  X-Frame-Scale  : letterbox scale the client applied (server divides
                   canvas-space bboxes by this to report client coords)
  X-Frame-Count  : client frame counter (optional, default 0)
  X-Timestamp    : ISO timestamp (optional)

This module is host-only (numpy, and `cv2` imported at the call) so the
camera client never imports torch.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

HEADER_FORMAT = "X-Frame-Format"
HEADER_WIDTH = "X-Frame-Width"
HEADER_HEIGHT = "X-Frame-Height"
HEADER_SCALE = "X-Frame-Scale"
HEADER_COUNT = "X-Frame-Count"
HEADER_TIMESTAMP = "X-Timestamp"

RAW_FORMATS = ("rgb24", "i420")


def payload_nbytes(fmt: str, height: int, width: int) -> int:
    if fmt == "rgb24":
        return height * width * 3
    if fmt == "i420":
        return height * 3 // 2 * width
    raise ValueError(f"unknown raw frame format: {fmt!r} (allowed: {RAW_FORMATS})")


def letterbox_rgb(frame_rgb: np.ndarray, det_size: Tuple[int, int]):
    """Resize-with-aspect onto a zero-padded canvas. Returns (canvas, scale);
    identical math to the server's letterbox so raw clients pre-compute it."""
    import cv2

    dh, dw = det_size
    ih, iw = frame_rgb.shape[:2]
    scale = min(dw / iw, dh / ih)
    nw, nh = int(round(iw * scale)), int(round(ih * scale))
    canvas = np.zeros((dh, dw, 3), np.uint8)
    canvas[:nh, :nw] = cv2.resize(frame_rgb, (nw, nh))
    return canvas, scale


def rgb_to_i420(frame_rgb: np.ndarray) -> np.ndarray:
    """RGB uint8 [H,W,3] -> planar I420 [H*3//2, W] uint8 (cv2 layout)."""
    import cv2

    return cv2.cvtColor(np.ascontiguousarray(frame_rgb), cv2.COLOR_RGB2YUV_I420)


def i420_to_rgb(yuv: np.ndarray) -> np.ndarray:
    """Planar I420 [H*3//2, W] uint8 -> RGB uint8 [H,W,3] (cv2 layout)."""
    import cv2

    return cv2.cvtColor(np.ascontiguousarray(yuv), cv2.COLOR_YUV2RGB_I420)
