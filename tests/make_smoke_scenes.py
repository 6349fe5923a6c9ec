"""Regenerate the port's smoke-scene fixture.

`facerecognitionpipeline_tpu_torch/testdata/smoke_scenes.npz` holds 16
rendered 160x160 scenes (uint8 RGB tiles) with their ground-truth face boxes
and landmarks. `chip_smoke.py` composes 640x640 frames from them as 4x4
mosaics; the machine it runs on has neither cv2 nor JAX, so the tiles are
rendered here with `train/detector_train.render_scene` and committed.

The archive is written with fixed zip metadata so the same seed gives the
same bytes (`tests/test_torch_port_imports.py` checks this).

    python tests/make_smoke_scenes.py
"""

from __future__ import annotations

import io
import os
import zipfile

import numpy as np

SEED = 20260101
N_TILES = 16
TILE = 160
MAX_FACES = 1  # per tile
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_PATH = os.path.join(
    REPO_ROOT, "facerecognitionpipeline_tpu_torch", "testdata",
    "smoke_scenes.npz",
)


def build(seed: int = SEED) -> dict[str, np.ndarray]:
    """tiles [16,160,160,3] u8, boxes [16,1,4] f32, landmarks [16,1,5,2]
    f32, counts [16] i32 (padded slots are zero)."""
    from facerecognitionpipeline_tpu.train.detector_train import render_scene

    rng = np.random.default_rng(seed)
    tiles = np.zeros((N_TILES, TILE, TILE, 3), np.uint8)
    boxes = np.zeros((N_TILES, MAX_FACES, 4), np.float32)
    landmarks = np.zeros((N_TILES, MAX_FACES, 5, 2), np.float32)
    counts = np.zeros((N_TILES,), np.int32)
    for i in range(N_TILES):
        img, bx, lm = render_scene(
            rng, size=TILE, max_faces=MAX_FACES, min_face=56, max_face=84
        )
        tiles[i] = img
        boxes[i, : len(bx)] = bx
        landmarks[i, : len(lm)] = lm
        counts[i] = len(bx)
    return {
        "tiles": tiles, "boxes": boxes, "landmarks": landmarks,
        "counts": counts,
    }


def to_bytes(arrays: dict[str, np.ndarray]) -> bytes:
    """A deterministic .npz (np.load-compatible): sorted entries, fixed
    timestamps, deflate."""
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", compression=zipfile.ZIP_DEFLATED) as zf:
        for name in sorted(arrays):
            info = zipfile.ZipInfo(f"{name}.npy", date_time=(1980, 1, 1, 0, 0, 0))
            info.compress_type = zipfile.ZIP_DEFLATED
            arr = io.BytesIO()
            np.lib.format.write_array(arr, np.ascontiguousarray(arrays[name]))
            zf.writestr(info, arr.getvalue())
    return buf.getvalue()


def main() -> None:
    data = to_bytes(build())
    os.makedirs(os.path.dirname(OUT_PATH), exist_ok=True)
    with open(OUT_PATH, "wb") as f:
        f.write(data)
    print(f"wrote {OUT_PATH} ({len(data)} bytes)")


if __name__ == "__main__":
    import sys

    sys.path.insert(0, REPO_ROOT)
    main()
