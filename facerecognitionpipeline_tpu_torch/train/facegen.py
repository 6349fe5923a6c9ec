"""Procedural face corpus generator: rich identities, pose, expression, light.

The port's copy of `facerecognitionpipeline_tpu/train/facegen.py` (numpy,
cv2 imported at the call), so the port renders the same identities, crops,
scenes and corpora byte for byte without the JAX package; only
`to_model_input` differs: it returns a tensor.

It serves two jobs the small renderer of `detector_train.py` cannot:
embedder-scale identity corpora (about 30 continuous identity parameters:
face geometry, eye, brow, nose and mouth shape, skin tone, hair, glasses,
facial hair, moles), and a held-out rendering distribution for the
detector's out-of-distribution suite (`evalharness/detection_ood.py`):
jaw-polygon outlines, sclera-and-iris eyes, curved mouths, hair masses,
glasses, directional lighting and photographic backgrounds share no drawing
code with the detector's training renderer.

Canonical face frame: u (horizontal) and v (vertical) in [-1, 1] with
(0, 0) the face center, +v down. A feature at (u, v, z) with depth z
(toward the camera) projects under yaw/pitch like a crude 3D head:
    u' = u * cos(yaw)  + z * sin(yaw)
    v' = v * cos(pitch) + z * sin(pitch) * 0.6
which shifts near features (nose) more than deep ones.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from facerecognitionpipeline_tpu_torch.ops.numerics import div

# 5-point landmark order matches the aligner contract (ops/warp.py):
# left eye, right eye, nose tip, left mouth corner, right mouth corner.


def sample_identity(seed: int) -> Dict:
    """~30-parameter persistent identity. Continuous attributes are sampled
    from wide ranges so that identity discrimination requires METRIC
    learning, not attribute lookup; discrete attributes (glasses, beard,
    bald) partition the population like real-world accessories."""
    r = np.random.default_rng(np.random.SeedSequence([0xFACE, seed]))
    skin_base = r.uniform(95, 235)
    skin = np.clip(
        skin_base * np.array([1.0, r.uniform(0.82, 0.98), r.uniform(0.66, 0.92)]),
        40, 255,
    )  # RGB, warm-biased
    hair_tone = r.uniform(15, 200)
    return {
        "seed": seed,
        # head geometry
        "face_w": float(r.uniform(0.62, 0.86)),      # half-width / half-height
        "jaw": float(r.uniform(0.55, 1.0)),          # chin narrowing (1 = round)
        "cheek": float(r.uniform(0.9, 1.1)),         # mid-face width factor
        # eyes
        "eye_u": float(r.uniform(0.30, 0.44)),       # eye horizontal offset
        "eye_v": float(r.uniform(-0.34, -0.18)),
        "eye_w": float(r.uniform(0.10, 0.17)),       # half-width of the eye
        "eye_h": float(r.uniform(0.045, 0.085)),     # half-height (openness base)
        "iris": [float(x) for x in r.uniform(20, 150, 3)],
        "iris_r": float(r.uniform(0.45, 0.7)),       # iris radius / eye height
        # brows
        "brow_v": float(r.uniform(-0.13, -0.06)),    # offset above the eye
        "brow_len": float(r.uniform(0.9, 1.5)),      # length / eye width
        "brow_th": float(r.uniform(0.015, 0.05)),
        "brow_angle": float(r.uniform(-0.25, 0.35)), # radians, + = outer-down
        "brow_tone": float(r.uniform(0.1, 0.5)),     # darkness vs hair
        # nose
        "nose_len": float(r.uniform(0.28, 0.46)),    # eyes midpoint -> tip
        "nose_w": float(r.uniform(0.06, 0.14)),
        "nose_z": float(r.uniform(0.18, 0.34)),      # protrusion (parallax)
        # mouth
        "mouth_v": float(r.uniform(0.42, 0.60)),
        "mouth_w": float(r.uniform(0.16, 0.34)),
        "lip_th": float(r.uniform(0.02, 0.06)),
        "mouth_curve": float(r.uniform(-0.06, 0.10)),  # resting curvature
        "lip_tone": float(r.uniform(0.45, 0.8)),       # multiplier on skin
        # hair
        "bald": bool(r.random() < 0.12),
        "hair": [float(hair_tone * x) for x in
                 (1.0, r.uniform(0.7, 1.0), r.uniform(0.45, 0.95))],
        "hairline": float(r.uniform(-0.95, -0.55)),  # v where hair mass ends
        "hair_width": float(r.uniform(1.02, 1.25)),  # vs face width
        # accessories
        "glasses": bool(r.random() < 0.25),
        "glasses_tone": float(r.uniform(20, 90)),
        "mustache": bool(r.random() < 0.18),
        "beard": bool(r.random() < 0.15),
        "moles": [
            [float(r.uniform(-0.7, 0.7)), float(r.uniform(-0.3, 0.75))]
            for _ in range(int(r.integers(0, 3)))
        ],
        "skin": [float(x) for x in skin],
        "cheek_shade": float(r.uniform(0.88, 1.0)),
    }


def _project(u: float, v: float, z: float, yaw: float, pitch: float
             ) -> Tuple[float, float]:
    return (
        u * math.cos(yaw) + z * math.sin(yaw),
        v * math.cos(pitch) + z * math.sin(pitch) * 0.6,
    )


def render_face(
    ident: Dict,
    *,
    size: int = 112,
    center: Optional[Tuple[float, float]] = None,
    half: Optional[float] = None,
    yaw: float = 0.0,
    pitch: float = 0.0,
    roll: float = 0.0,
    smile: float = 0.0,
    mouth_open: float = 0.0,
    eye_open: float = 1.0,
    canvas: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Draw one face. Returns (canvas, bbox [4] xyxy, landmarks [5,2]).

    With no canvas, a fresh `size`x`size` RGB uint8 image is created (the
    caller composes backgrounds/lighting separately — see render_crop /
    compose_scene). `center`/`half` place the face; default fills the frame
    like an aligned 112x112 crop.
    """
    import cv2

    if canvas is None:
        canvas = np.zeros((size, size, 3), np.uint8)
    H, W = canvas.shape[:2]
    cx, cy = center if center is not None else (W / 2.0, H / 2.0 + 0.04 * H)
    s = half if half is not None else 0.46 * min(H, W)

    cr, sr = math.cos(roll), math.sin(roll)

    def pt(u: float, v: float, z: float = 0.0) -> Tuple[int, int]:
        up, vp = _project(u, v, z, yaw, pitch)
        x = cx + (cr * up - sr * vp) * s
        y = cy + (sr * up + cr * vp) * s
        return int(round(x)), int(round(y))

    def fpt(u: float, v: float, z: float = 0.0) -> Tuple[float, float]:
        up, vp = _project(u, v, z, yaw, pitch)
        return (cx + (cr * up - sr * vp) * s, cy + (sr * up + cr * vp) * s)

    skin = tuple(int(c) for c in ident["skin"])
    fw = ident["face_w"]

    # ---- head outline: upper ellipse + jaw polygon (chin narrowing) ----
    wvis = fw * (0.75 + 0.25 * abs(math.cos(yaw)))  # far side narrows
    # upper head
    cv2.ellipse(
        canvas, pt(0, -0.15), (max(2, int(wvis * s)), max(2, int(0.85 * s))),
        math.degrees(roll), 180, 360, skin, -1,
    )
    # mid+jaw: polygon from cheeks to chin
    jawpts = []
    for t in np.linspace(0.0, 1.0, 9):
        u = wvis * (1 - t) ** 0.8 * ident["cheek"] * (1 if t < 1 else 0)
        u = wvis * math.cos(t * math.pi / 2) * (ident["jaw"] + (1 - ident["jaw"]) * (1 - t))
        v = -0.15 + 1.15 * t
        jawpts.append(pt(u, v))
    for t in np.linspace(1.0, 0.0, 9):
        u = -wvis * math.cos(t * math.pi / 2) * (ident["jaw"] + (1 - ident["jaw"]) * (1 - t))
        v = -0.15 + 1.15 * t
        jawpts.append(pt(u, v))
    cv2.fillPoly(canvas, [np.asarray(jawpts, np.int32)], skin)

    # cheek shading (side away from camera darker under yaw)
    if abs(yaw) > 0.05:
        shade = tuple(int(c * ident["cheek_shade"] * 0.92) for c in skin)
        side = -1 if yaw > 0 else 1
        cv2.ellipse(
            canvas, pt(side * wvis * 0.55, 0.1),
            (max(1, int(0.25 * s)), max(1, int(0.5 * s))),
            math.degrees(roll), 0, 360, shade, -1,
        )

    # ---- hair ----
    if not ident["bald"]:
        hair = tuple(int(c) for c in ident["hair"])
        hw = fw * ident["hair_width"]
        cv2.ellipse(
            canvas, pt(0, -0.35), (max(2, int(hw * s)), max(2, int(0.75 * s))),
            math.degrees(roll), 180, 360, hair, -1,
        )
        # hairline: re-fill the forehead with skin below the hair mass
        fl = []
        for t in np.linspace(-1.0, 1.0, 7):
            fl.append(pt(t * wvis * 0.92, ident["hairline"] + 0.06 * math.cos(t * 2.2)))
        fl += [pt(wvis * 0.92, 0.0), pt(-wvis * 0.92, 0.0)]
        cv2.fillPoly(canvas, [np.asarray(fl, np.int32)], skin)

    # ---- eyes ----
    eu, ev = ident["eye_u"], ident["eye_v"]
    ew, eh = ident["eye_w"], ident["eye_h"] * max(0.15, eye_open)
    iris = tuple(int(c) for c in ident["iris"])
    eyes_xy = []
    for sgn in (-1, 1):
        ex, ey = fpt(sgn * eu, ev, 0.05)
        eyes_xy.append((ex, ey))
        cv2.ellipse(
            canvas, (int(ex), int(ey)),
            (max(1, int(ew * s)), max(1, int(eh * s))),
            math.degrees(roll), 0, 360, (245, 242, 238), -1,
        )
        ir = max(1, int(ident["iris_r"] * eh * s * 1.6))
        cv2.circle(canvas, (int(ex), int(ey)), ir, iris, -1)
        cv2.circle(canvas, (int(ex), int(ey)), max(1, ir // 2), (15, 12, 12), -1)
        # brow
        bt = ident["brow_tone"]
        btone = tuple(int(c * bt) for c in ident["hair"]) if not ident["bald"] \
            else (int(60 * bt), int(45 * bt), int(40 * bt))
        bl = ident["brow_len"] * ew
        ba = ident["brow_angle"] * sgn
        b0 = pt(sgn * eu - bl * math.cos(ba), ev + ident["brow_v"] + sgn * 0 - bl * math.sin(ba) * sgn, 0.05)
        b1 = pt(sgn * eu + bl * math.cos(ba), ev + ident["brow_v"] + bl * math.sin(ba) * sgn, 0.05)
        cv2.line(canvas, b0, b1, btone, max(1, int(ident["brow_th"] * s * 2)))

    # ---- nose: bridge + tip + nostrils, with parallax ----
    nz = ident["nose_z"]
    ntip_v = (ident["eye_v"] + ident["nose_len"])
    bridge_tone = tuple(int(c * 0.93) for c in skin)
    cv2.line(canvas, pt(0, ev + 0.05, 0.1), pt(0, ntip_v, nz), bridge_tone,
             max(1, int(0.05 * s)))
    tip_tone = tuple(int(c * 0.85) for c in skin)
    nose_xy = fpt(0, ntip_v, nz)
    cv2.circle(canvas, (int(nose_xy[0]), int(nose_xy[1])),
               max(1, int(ident["nose_w"] * s * 0.9)), tip_tone, -1)
    ndark = tuple(int(c * 0.55) for c in skin)
    for sgn in (-1, 1):
        nx, ny = pt(sgn * ident["nose_w"], ntip_v + 0.02, nz * 0.8)
        cv2.circle(canvas, (nx, ny), max(1, int(0.025 * s)), ndark, -1)

    # ---- mouth: curved polyline through 5 points ----
    mv = ident["mouth_v"]
    mw = ident["mouth_w"]
    curve = ident["mouth_curve"] + 0.12 * smile
    lip = tuple(int(min(255, c * ident["lip_tone"] + 30)) for c in skin[:1]) \
        + tuple(int(c * ident["lip_tone"] * 0.6) for c in skin[1:])
    mpts = []
    for t in np.linspace(-1.0, 1.0, 7):
        mpts.append(pt(t * mw, mv - curve * (1 - t * t), 0.12))
    th = max(1, int(ident["lip_th"] * s * 2 * (1 + 0.6 * mouth_open)))
    cv2.polylines(canvas, [np.asarray(mpts, np.int32)], False, lip, th)
    if mouth_open > 0.15:
        mx, my = pt(0, mv - curve * 0.6, 0.12)
        cv2.ellipse(canvas, (mx, my),
                    (max(1, int(mw * s * 0.6)), max(1, int(mouth_open * 0.08 * s))),
                    math.degrees(roll), 0, 360, (40, 20, 20), -1)
    mouth_l = fpt(-mw, mv - 0 * curve, 0.12)
    mouth_r = fpt(mw, mv, 0.12)

    # ---- facial hair ----
    fh_tone = tuple(int(c * 0.45) for c in ident["hair"]) if not ident["bald"] \
        else (40, 32, 28)
    if ident["mustache"]:
        m0 = pt(-mw * 1.1, mv - 0.08, 0.1)
        m1 = pt(mw * 1.1, mv - 0.08, 0.1)
        cv2.line(canvas, m0, m1, fh_tone, max(1, int(0.05 * s)))
    if ident["beard"]:
        bpts = [pt(-mw * 1.4, mv + 0.02, 0.05), pt(0, mv + 0.34, 0.1),
                pt(mw * 1.4, mv + 0.02, 0.05)]
        cv2.polylines(canvas, [np.asarray(bpts, np.int32)], False, fh_tone,
                      max(1, int(0.12 * s)))

    # ---- moles ----
    for mu, mvv in ident["moles"]:
        mxy = pt(mu * fw, mvv, 0.02)
        cv2.circle(canvas, mxy, max(1, int(0.018 * s)),
                   tuple(int(c * 0.5) for c in skin), -1)

    # ---- glasses (after eyes so the rims sit on top) ----
    if ident["glasses"]:
        g = (int(ident["glasses_tone"]),) * 3
        rr = max(2, int(ew * s * 1.5))
        for ex, ey in eyes_xy:
            cv2.circle(canvas, (int(ex), int(ey)), rr, g, max(1, int(0.025 * s)))
        cv2.line(canvas, (int(eyes_xy[0][0] + rr * 0.8), int(eyes_xy[0][1])),
                 (int(eyes_xy[1][0] - rr * 0.8), int(eyes_xy[1][1])), g,
                 max(1, int(0.02 * s)))

    lms = np.asarray(
        [eyes_xy[0], eyes_xy[1], nose_xy, mouth_l, mouth_r], np.float32
    )
    bbox = np.asarray(
        [cx - fw * s * 1.05, cy - 1.05 * s, cx + fw * s * 1.05, cy + 1.15 * s],
        np.float32,
    )
    return canvas, bbox, lms


# ------------------------------------------------------------------ scenes


def textured_background(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """Photographic-ish background: smooth low-frequency color field +
    rectangles/lines clutter + sensor noise. Different statistics from
    detector_train.render_scene's flat dark field (held-out distribution)."""
    import cv2

    # low-frequency field from an upsampled tiny random image
    base = rng.integers(30, 225, size=(4, 4, 3)).astype(np.uint8)
    img = cv2.resize(base, (w, h), interpolation=cv2.INTER_CUBIC)
    for _ in range(int(rng.integers(3, 10))):
        x, y = int(rng.integers(0, w)), int(rng.integers(0, h))
        ww, hh = int(rng.integers(6, w // 2)), int(rng.integers(6, h // 2))
        color = tuple(int(c) for c in rng.integers(0, 255, 3))
        if rng.random() < 0.5:
            cv2.rectangle(img, (x, y), (x + ww, y + hh), color, -1)
        else:
            cv2.line(img, (x, y), (x + ww, y + hh), color,
                     int(rng.integers(1, 4)))
    return img


def apply_lighting(
    img: np.ndarray,
    rng: np.random.Generator,
    *,
    strength: float = 1.0,
) -> np.ndarray:
    """Directional illumination gradient + gain + color temperature."""
    h, w = img.shape[:2]
    theta = rng.uniform(0, 2 * math.pi)
    gx, gy = math.cos(theta), math.sin(theta)
    yy, xx = np.mgrid[0:h, 0:w]
    ramp = ((xx / max(w - 1, 1) - 0.5) * gx + (yy / max(h - 1, 1) - 0.5) * gy)
    grad = 1.0 + rng.uniform(0.0, 0.55) * strength * ramp
    gain = rng.uniform(1 - 0.25 * strength, 1 + 0.2 * strength)
    warm = rng.uniform(1 - 0.12 * strength, 1 + 0.12 * strength)
    out = img.astype(np.float32) * grad[..., None] * gain
    out[..., 0] *= warm
    out[..., 2] *= 2 - warm
    return np.clip(out, 0, 255).astype(np.uint8)


def render_crop(
    ident: Dict,
    rng: np.random.Generator,
    size: int = 112,
    *,
    pose_scale: float = 1.0,
    light_scale: float = 1.0,
) -> np.ndarray:
    """One aligned-style training/eval crop with pose/expression/lighting
    jitter. The face fills the frame like a real aligned 112x112 crop."""
    img = textured_background(rng, size, size)
    img, _, _ = render_face(
        ident,
        canvas=img,
        center=(size / 2 + rng.uniform(-2.5, 2.5),
                size / 2 + 0.04 * size + rng.uniform(-2.5, 2.5)),
        half=size * rng.uniform(0.42, 0.50),
        yaw=rng.uniform(-0.45, 0.45) * pose_scale,
        pitch=rng.uniform(-0.2, 0.2) * pose_scale,
        roll=rng.uniform(-0.12, 0.12) * pose_scale,
        smile=rng.uniform(-0.4, 1.0),
        mouth_open=max(0.0, rng.uniform(-0.5, 0.8)),
        eye_open=rng.uniform(0.6, 1.15),
    )
    img = apply_lighting(img, rng, strength=light_scale)
    if rng.random() < 0.25:
        import cv2

        k = 3
        img = cv2.GaussianBlur(img, (k, k), 0)
    noise = rng.normal(0, rng.uniform(0, 6), size=img.shape)
    return np.clip(img.astype(np.float32) + noise, 0, 255).astype(np.uint8)


def compose_scene(
    identities: list,
    rng: np.random.Generator,
    size: int = 160,
    *,
    min_face: int = 28,
    max_face: int = 72,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, list]:
    """Detector-eval scene from THIS renderer (held-out distribution):
    photographic background, posed/lit faces. Returns
    (image, boxes [N,4], landmarks [N,5,2], used identity indices)."""
    img = textured_background(rng, size, size)
    boxes, lms, used = [], [], []
    for idx, ident in enumerate(identities):
        fsize = int(rng.integers(min_face, max_face + 1))
        half = fsize / 2.0
        cx = rng.uniform(half + 2, size - half - 2)
        cy = rng.uniform(half * 1.15 + 2, size - half * 1.15 - 2)
        centers = [((b[0] + b[2]) / 2, (b[1] + b[3]) / 2) for b in boxes]
        if any(abs(cx - px) < half * 2 and abs(cy - py) < half * 2
               for px, py in centers):
            continue
        img, box, lm = render_face(
            ident, canvas=img, center=(cx, cy), half=half,
            yaw=rng.uniform(-0.4, 0.4), pitch=rng.uniform(-0.15, 0.15),
            roll=rng.uniform(-0.15, 0.15), smile=rng.uniform(-0.3, 0.8),
            mouth_open=max(0.0, rng.uniform(-0.5, 0.6)),
            eye_open=rng.uniform(0.7, 1.1),
        )
        boxes.append(box)
        lms.append(lm)
        used.append(idx)
    img = apply_lighting(img, rng, strength=0.8)
    noise = rng.normal(0, rng.uniform(0, 5), size=img.shape)
    img = np.clip(img.astype(np.float32) + noise, 0, 255).astype(np.uint8)
    return (
        img,
        np.asarray(boxes, np.float32).reshape(-1, 4),
        np.asarray(lms, np.float32).reshape(-1, 5, 2),
        used,
    )


# ------------------------------------------------------------------ corpus


def build_corpus(
    n_identities: int,
    per_identity: int,
    seed: int = 0,
    size: int = 112,
    id_offset: int = 0,
    **crop_kw,
) -> Tuple[np.ndarray, np.ndarray]:
    """Pre-rendered crop corpus: (images [N,s,s,3] uint8, labels [N] i32).

    Rendering is host work, so the corpus is rendered once up front and
    batches are sampled from memory during training: the device step never
    waits on the renderer. Identity seeds are `id_offset + i`, so disjoint offset ranges give
    GUARANTEED disjoint train/held-out identity sets.
    """
    rng = np.random.default_rng(np.random.SeedSequence([0xC095, seed]))
    images = np.empty((n_identities * per_identity, size, size, 3), np.uint8)
    labels = np.empty(n_identities * per_identity, np.int32)
    k = 0
    for i in range(n_identities):
        ident = sample_identity(id_offset + i)
        for _ in range(per_identity):
            images[k] = render_crop(ident, rng, size, **crop_kw)
            labels[k] = i
            k += 1
    return images, labels


def corpus_batches(
    images: np.ndarray,
    labels: np.ndarray,
    batch_size: int,
    seed: int = 0,
):
    """Infinite shuffled batches from a pre-rendered corpus, with flip/gain
    augmentation. Yields (images [B,s,s,3] uint8 RGB, labels [B] i32).

    Batches stay uint8, a quarter of the float32 bytes to upload; the
    model-input conversion (RGB->BGR, [-1,1] float32) runs on the device:
    see `to_model_input`."""
    rng = np.random.default_rng(seed)
    n = len(images)
    while True:
        idx = rng.integers(0, n, size=batch_size)
        batch = images[idx]
        flip = rng.random(batch_size) < 0.5
        batch[flip] = batch[flip, :, ::-1]
        gain = rng.uniform(0.85, 1.15, size=(batch_size, 1, 1, 1))
        batch = np.clip(batch.astype(np.float32) * gain, 0, 255).astype(
            np.uint8
        )
        yield batch, labels[idx].astype(np.int32)


def to_model_input(u8_rgb) -> torch.Tensor:
    """uint8 RGB [B,H,W,3] (a tensor on the device, or an array) -> float32
    BGR in [-1, 1] (the embedder's convention, train/data.py), on the
    tensor's device."""
    x = torch.as_tensor(u8_rgb).flip(-1).to(torch.float32)
    return div(x - 127.5, 127.5)
