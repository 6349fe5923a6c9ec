"""The synthetic face renderer of the detector trainer: only what the int8
calibration, the tests and `chip_smoke.py` need.

A copy of `make_identity`, `draw_identity_face`, `render_identity_crop` and
`render_identity_scene` from `facerecognitionpipeline_tpu/train/
detector_train.py` (numpy and cv2, cv2 imported at the call), so
`models/quantize.py::default_calibration_faces` renders the same crops and
the enrolment checks the same scenes, byte for byte, without the JAX
package. The trainer
itself (patch sampling, the P/R/O-net training loops) is queued in
ROADMAP.md with the rest of `train/`.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np


def make_identity(seed: int) -> Dict[str, float]:
    """Persistent procedural 'identity': facial-geometry + color parameters.

    Rendering the same identity twice gives the same face up to pose/size/
    lighting jitter — enough signal for the embedder trainer to learn a
    synthetic-identity metric (the all-synthetic end-to-end demo/test)."""
    r = np.random.default_rng(seed)
    return {
        "skin": r.integers(150, 240, 3).tolist(),
        "eye_dx": float(r.uniform(0.28, 0.42)),
        "eye_dy": float(r.uniform(-0.38, -0.22)),
        "eye_r": float(r.uniform(0.08, 0.16)),
        "mouth_w": float(r.uniform(0.18, 0.38)),
        "mouth_dy": float(r.uniform(0.45, 0.65)),
        "aspect": float(r.uniform(0.7, 0.95)),
        "nose_dy": float(r.uniform(0.0, 0.2)),
        "nose_shade": float(r.uniform(0.5, 0.9)),
        "brow": bool(r.random() < 0.5),
    }


def draw_identity_face(
    img: np.ndarray,
    identity: Dict[str, float],
    cx: float,
    cy: float,
    s: float,
    theta: float,
) -> Tuple[np.ndarray, np.ndarray]:
    """Draw one identity's face at (cx, cy), half-size s, rotation theta.
    Returns (bbox [4], landmarks [5,2])."""
    import cv2

    ct, st = math.cos(theta), math.sin(theta)

    def rot(dx, dy):
        return (cx + ct * dx - st * dy, cy + st * dx + ct * dy)

    skin = tuple(int(c) for c in identity["skin"])
    cv2.ellipse(
        img, (int(cx), int(cy)), (int(identity["aspect"] * s), int(s * 1.05)),
        math.degrees(theta), 0, 360, skin, -1,
    )
    dark = (30, 25, 25)
    le = rot(-identity["eye_dx"] * s, identity["eye_dy"] * s)
    re = rot(identity["eye_dx"] * s, identity["eye_dy"] * s)
    no = rot(0.0, identity["nose_dy"] * s)
    lm = rot(-identity["mouth_w"] * s, identity["mouth_dy"] * s)
    rm = rot(identity["mouth_w"] * s, identity["mouth_dy"] * s)
    er = max(1, int(identity["eye_r"] * s))
    cv2.circle(img, (int(le[0]), int(le[1])), er, dark, -1)
    cv2.circle(img, (int(re[0]), int(re[1])), er, dark, -1)
    cv2.circle(
        img, (int(no[0]), int(no[1])), max(1, int(0.08 * s)),
        tuple(int(c * identity["nose_shade"]) for c in skin), -1,
    )
    cv2.line(img, (int(lm[0]), int(lm[1])), (int(rm[0]), int(rm[1])), dark,
             max(1, int(0.08 * s)))
    if identity["brow"]:
        bl = rot(-identity["eye_dx"] * s, (identity["eye_dy"] - 0.18) * s)
        br = rot(identity["eye_dx"] * s, (identity["eye_dy"] - 0.18) * s)
        cv2.line(img, (int(bl[0]), int(bl[1])), (int(br[0]), int(br[1])), dark,
                 max(1, int(0.05 * s)))

    bbox = np.array(
        [cx - 0.85 * s, cy - 1.1 * s, cx + 0.85 * s, cy + 1.1 * s], np.float32
    )
    return bbox, np.asarray([le, re, no, lm, rm], np.float32)


def render_identity_crop(
    identity: Dict[str, float],
    rng: np.random.Generator,
    size: int = 112,
) -> np.ndarray:
    """One aligned-style 112x112 crop of an identity with pose/light jitter."""
    img = rng.integers(0, 100, size=(size, size, 3), dtype=np.uint8)
    s = size * rng.uniform(0.36, 0.44)
    cx = size / 2 + rng.uniform(-3, 3)
    cy = size / 2 + rng.uniform(-3, 3)
    theta = rng.uniform(-0.15, 0.15)
    draw_identity_face(img, identity, cx, cy, s, theta)
    gain = rng.uniform(0.8, 1.2)
    return np.clip(img.astype(np.float32) * gain, 0, 255).astype(np.uint8)


def render_identity_scene(
    identities: list,
    rng: np.random.Generator,
    size: int = 160,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, list]:
    """Scene with one face per given identity. Returns
    (image, boxes, landmarks, identity_indices)."""
    img = rng.integers(0, 100, size=(size, size, 3), dtype=np.uint8)
    boxes, lms, used = [], [], []
    for idx, ident in enumerate(identities):
        fsize = rng.integers(36, 64)
        s = fsize / 2.0
        cx = rng.uniform(s + 2, size - s - 2)
        cy = rng.uniform(s * 1.2 + 2, size - s * 1.2 - 2)
        if any(abs(cx - b[0]) < s * 2 and abs(cy - b[1]) < s * 2
               for b in [((bb[0] + bb[2]) / 2, (bb[1] + bb[3]) / 2) for bb in boxes]):
            continue
        box, lm = draw_identity_face(
            img, ident, cx, cy, s, rng.uniform(-0.15, 0.15)
        )
        boxes.append(box)
        lms.append(lm)
        used.append(idx)
    return img, np.asarray(boxes, np.float32), np.asarray(lms, np.float32), used
