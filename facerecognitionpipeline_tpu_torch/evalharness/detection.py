"""Detector stress evaluation: synthetic stress scenes and PR metrics.

Counterpart of `facerecognitionpipeline_tpu/evalharness/detection.py`
(numpy and cv2, cv2 imported at the call): `render_stress_scene` and its
helpers, copied so `models/quantize.py::default_calibration_frames` renders
the same frames byte for byte; greedy IoU matching, the precision/recall
curve with VOC-interpolated AP, and `run_stress_suite` over any detector
with `detect(image) -> list of face dicts` (the port's `MTCNNDetector`: a
bf16 cascade launches K1 twice per scene on the card). The training-scene
variant `render_stress_training_scene` comes with `train/`.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np

# --------------------------------------------------------------- rendering


def _draw_face(img, cx, cy, s, theta, rng, contrast: float = 1.0):
    """One synthetic face (same visual family as train.detector_train's
    renderer: skin ellipse + eyes/nose/mouth). Returns (box, landmarks)."""
    import cv2

    ct, st = math.cos(theta), math.sin(theta)

    def rot(dx, dy):
        return (cx + ct * dx - st * dy, cy + st * dx + ct * dy)

    lo, hi = 170, 230
    mid = (lo + hi) / 2
    lo = int(mid + (lo - mid) * contrast)
    hi = int(mid + (hi - mid) * contrast)
    skin = tuple(int(c) for c in rng.integers(lo, max(hi, lo + 1), 3))
    cv2.ellipse(
        img, (int(cx), int(cy)), (int(0.8 * s), int(s * 1.05)),
        math.degrees(theta), 0, 360, skin, -1,
    )
    dmax = max(10, int(10 + 50 * contrast))
    dark = tuple(int(c) for c in rng.integers(10, dmax + 1, 3))
    le = rot(-0.35 * s, -0.3 * s)
    re = rot(0.35 * s, -0.3 * s)
    no = rot(0.0, 0.1 * s)
    lm = rot(-0.28 * s, 0.55 * s)
    rm = rot(0.28 * s, 0.55 * s)
    cv2.circle(img, (int(le[0]), int(le[1])), max(1, int(0.12 * s)), dark, -1)
    cv2.circle(img, (int(re[0]), int(re[1])), max(1, int(0.12 * s)), dark, -1)
    cv2.circle(img, (int(no[0]), int(no[1])), max(1, int(0.08 * s)),
               tuple(int(c * 0.7) for c in skin), -1)
    cv2.line(img, (int(lm[0]), int(lm[1])), (int(rm[0]), int(rm[1])), dark,
             max(1, int(0.08 * s)))
    box = [cx - 0.85 * s, cy - 1.1 * s, cx + 0.85 * s, cy + 1.1 * s]
    return box, [le, re, no, lm, rm]


def _draw_distractor(img, rng, size):
    """Face-LIKE hard negative: featureless skin ellipse, scrambled feature
    blob, or skin rectangle — things a weak detector fires on. Returns the
    distractor's bounding box (for hard-negative patch sampling)."""
    import cv2

    kind = rng.integers(0, 3)
    s = float(rng.integers(14, 36))
    cx = rng.uniform(s + 2, size - s - 2)
    cy = rng.uniform(s + 2, size - s - 2)
    skin = tuple(int(c) for c in rng.integers(170, 230, 3))
    dark = tuple(int(c) for c in rng.integers(10, 60, 3))
    if kind == 0:  # featureless ellipse
        cv2.ellipse(img, (int(cx), int(cy)), (int(0.8 * s), int(1.05 * s)),
                    float(rng.uniform(0, 180)), 0, 360, skin, -1)
    elif kind == 1:  # scrambled features (eyes below mouth)
        cv2.ellipse(img, (int(cx), int(cy)), (int(0.8 * s), int(1.05 * s)),
                    0, 0, 360, skin, -1)
        cv2.circle(img, (int(cx - 0.3 * s), int(cy + 0.5 * s)),
                   max(1, int(0.12 * s)), dark, -1)
        cv2.circle(img, (int(cx + 0.3 * s), int(cy + 0.5 * s)),
                   max(1, int(0.12 * s)), dark, -1)
        cv2.line(img, (int(cx - 0.3 * s), int(cy - 0.5 * s)),
                 (int(cx + 0.3 * s), int(cy - 0.5 * s)), dark,
                 max(1, int(0.08 * s)))
    else:  # skin rectangle
        cv2.rectangle(img, (int(cx - 0.8 * s), int(cy - s)),
                      (int(cx + 0.8 * s), int(cy + s)), skin, -1)
    return [cx - 0.85 * s, cy - 1.1 * s, cx + 0.85 * s, cy + 1.1 * s]


def _draw_nonface_distractor(img, rng, size):
    """NON-face-like distractor: things real scenes contain that must never
    fire — hands (skin blob + finger strokes), patterned clothing
    (stripes/checks, including skin-adjacent colors), object clutter.
    Returns the distractor's bounding box."""
    import cv2

    kind = rng.integers(0, 3)
    s = float(rng.integers(16, 44))
    cx = rng.uniform(s + 2, size - s - 2)
    cy = rng.uniform(s + 2, size - s - 2)
    skin = tuple(int(c) for c in rng.integers(170, 230, 3))
    if kind == 0:  # hand: palm ellipse + finger strokes
        cv2.ellipse(img, (int(cx), int(cy + 0.3 * s)), (int(0.55 * s), int(0.45 * s)),
                    float(rng.uniform(-20, 20)), 0, 360, skin, -1)
        for i in range(5):
            ang = math.radians(-60 + 30 * i + rng.uniform(-8, 8))
            fx = cx + math.sin(ang) * s * 0.9
            fy = cy - 0.1 * s - math.cos(ang) * s * 0.8
            cv2.line(img, (int(cx + math.sin(ang) * 0.3 * s),
                           int(cy + 0.1 * s - math.cos(ang) * 0.3 * s)),
                     (int(fx), int(fy)), skin, max(2, int(0.16 * s)))
    elif kind == 1:  # patterned clothing: striped or checkered rectangle
        x1, y1 = int(cx - s), int(cy - 0.8 * s)
        x2, y2 = int(cx + s), int(cy + 0.8 * s)
        base = skin if rng.random() < 0.5 else tuple(
            int(c) for c in rng.integers(40, 220, 3))
        other = tuple(int(c) for c in rng.integers(10, 240, 3))
        cv2.rectangle(img, (x1, y1), (x2, y2), base, -1)
        step = int(rng.integers(3, 9))
        if rng.random() < 0.5:  # stripes
            for x in range(x1, x2, 2 * step):
                cv2.rectangle(img, (x, y1), (min(x + step, x2), y2), other, -1)
        else:  # checks
            for x in range(x1, x2, 2 * step):
                for y in range(y1, y2, 2 * step):
                    cv2.rectangle(img, (x, y), (min(x + step, x2), min(y + step, y2)),
                                  other, -1)
    else:  # object clutter: overlapping circles
        for _ in range(int(rng.integers(3, 7))):
            r = int(rng.integers(3, max(4, int(0.4 * s))))
            ox = int(cx + rng.uniform(-s, s))
            oy = int(cy + rng.uniform(-s, s))
            color = tuple(int(c) for c in rng.integers(30, 230, 3))
            cv2.circle(img, (ox, oy), r, color, -1)
    return [cx - s, cy - s, cx + s, cy + s]


def _apply_domain_shift(img, rng):
    """Lighting/texture domain shift: illumination gradient, gamma, color
    cast, and a fine texture the training background never shows."""
    h, w = img.shape[:2]
    x = np.linspace(-1.0, 1.0, w, dtype=np.float32)[None, :, None]
    y = np.linspace(-1.0, 1.0, h, dtype=np.float32)[:, None, None]
    gx, gy = rng.uniform(-0.35, 0.35, 2)
    illum = 1.0 + gx * x + gy * y  # directional lighting ramp
    gamma = rng.uniform(0.6, 1.6)
    cast = rng.uniform(0.8, 1.2, 3).astype(np.float32)
    texture = rng.normal(0.0, rng.uniform(2.0, 8.0), img.shape).astype(np.float32)
    out = (img.astype(np.float32) / 255.0) ** gamma
    out = out * illum * cast * 255.0 + texture
    img[:] = np.clip(out, 0, 255).astype(np.uint8)


def _apply_motion_blur(img, rng, max_len: int = 13):
    """Directional motion blur over the whole scene."""
    import cv2

    length = int(rng.integers(7, max_len + 1))
    kernel = np.zeros((length, length), np.float32)
    ang = rng.uniform(0, math.pi)
    cv2.line(
        kernel,
        (int(length / 2 * (1 - math.cos(ang))), int(length / 2 * (1 - math.sin(ang)))),
        (int(length / 2 * (1 + math.cos(ang))), int(length / 2 * (1 + math.sin(ang)))),
        1.0,
        1,
    )
    kernel /= kernel.sum()
    img[:] = cv2.filter2D(img, -1, kernel)


def _background(rng, size):
    import cv2

    img = rng.integers(0, 120, size=(size, size, 3), dtype=np.uint8)
    for _ in range(8):
        x, y = rng.integers(0, size, 2)
        w, h = rng.integers(8, 50, 2)
        color = tuple(int(c) for c in rng.integers(0, 140, 3))
        cv2.rectangle(img, (x, y), (x + w, y + h), color, -1)
    return img


def _place_faces(img, rng, size, n, smin, smax, theta_max=0.2, contrast=1.0,
                 min_sep=2.0):
    boxes, lms = [], []
    centers = []
    for _ in range(n * 4):  # attempts
        if len(boxes) >= n:
            break
        s = float(rng.integers(smin, smax + 1)) / 2.0
        cx = rng.uniform(s + 2, size - s - 2)
        cy = rng.uniform(s * 1.2 + 2, size - s * 1.2 - 2)
        # one unit throughout: s and ps are HALF-extents, so min_sep=2.0
        # means centers at least one full (larger) face apart — the previous
        # form compared a half-extent against a stored full extent, which
        # doubled the exclusion radius and quietly de-crowded the 'crowded'
        # suite (and the stress training scenes)
        if any(abs(cx - px) < min_sep * max(s, ps)
               and abs(cy - py) < min_sep * max(s, ps)
               for px, py, ps in centers):
            continue
        theta = rng.uniform(-theta_max, theta_max)
        box, lm = _draw_face(img, cx, cy, s, theta, rng, contrast=contrast)
        boxes.append(box)
        lms.append(lm)
        centers.append((cx, cy, s))
    return boxes, lms


def render_stress_scene(
    rng: np.random.Generator, category: str, size: int = 320
) -> Tuple[np.ndarray, np.ndarray]:
    """One scene for a stress category. Returns (image u8 [S,S,3],
    gt_boxes [N,4]); N may be 0 (hard_negatives)."""
    import cv2

    img = _background(rng, size)

    if category == "baseline":
        boxes, _ = _place_faces(img, rng, size, n=3, smin=40, smax=90)
    elif category == "crowded":
        boxes, _ = _place_faces(img, rng, size, n=20, smin=28, smax=44,
                                min_sep=1.1)
    elif category == "tiny":
        boxes, _ = _place_faces(img, rng, size, n=6, smin=20, smax=28)
    elif category == "huge":
        boxes, _ = _place_faces(img, rng, size, n=1, smin=int(size * 0.55),
                                smax=int(size * 0.8))
    elif category == "occlusion":
        boxes, _ = _place_faces(img, rng, size, n=3, smin=44, smax=90)
        for box in boxes:
            # occlude ~25% of the face with a random rectangle
            x1, y1, x2, y2 = box
            w, h = x2 - x1, y2 - y1
            ox = rng.uniform(x1, x2 - 0.4 * w)
            oy = rng.uniform(y1, y2 - 0.4 * h)
            color = tuple(int(c) for c in rng.integers(0, 255, 3))
            cv2.rectangle(img, (int(ox), int(oy)),
                          (int(ox + 0.45 * w), int(oy + 0.45 * h)), color, -1)
    elif category == "rotated":
        boxes, _ = _place_faces(img, rng, size, n=3, smin=40, smax=90,
                                theta_max=0.5)
    elif category == "low_contrast":
        boxes, _ = _place_faces(img, rng, size, n=3, smin=40, smax=90,
                                contrast=0.45)
    elif category == "noisy":
        boxes, _ = _place_faces(img, rng, size, n=3, smin=40, smax=90)
        noise = rng.normal(0, 18, img.shape)
        img[:] = np.clip(img.astype(np.float32) + noise, 0, 255).astype(np.uint8)
    elif category == "hard_negatives":
        for _ in range(8):
            _draw_distractor(img, rng, size)
        boxes = []
    elif category == "nonface_distractors":
        # hands / patterned clothing / clutter NEXT TO faces: recall must
        # hold and nothing may fire on the distractors
        boxes, _ = _place_faces(img, rng, size, n=2, smin=40, smax=80)
        for _ in range(6):
            _draw_nonface_distractor(img, rng, size)
    elif category == "domain_shift":
        boxes, _ = _place_faces(img, rng, size, n=3, smin=40, smax=90)
        _apply_domain_shift(img, rng)
    elif category == "motion_blur":
        boxes, _ = _place_faces(img, rng, size, n=3, smin=44, smax=90)
        _apply_motion_blur(img, rng)
    else:
        raise ValueError(f"unknown stress category: {category}")
    return img, np.asarray(boxes, np.float32).reshape(-1, 4)


STRESS_CATEGORIES = (
    "baseline", "crowded", "tiny", "huge", "occlusion", "rotated",
    "low_contrast", "noisy", "hard_negatives", "nonface_distractors",
    "domain_shift", "motion_blur",
)

# -------------------------------------------------------------- evaluation


def iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[N,4] x [M,4] -> [N,M] IoU."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    x1 = np.maximum(a[:, None, 0], b[None, :, 0])
    y1 = np.maximum(a[:, None, 1], b[None, :, 1])
    x2 = np.minimum(a[:, None, 2], b[None, :, 2])
    y2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter, 1e-9)


def match_detections(
    pred_boxes: np.ndarray,
    pred_scores: np.ndarray,
    gt_boxes: np.ndarray,
    iou_thresh: float = 0.5,
) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy score-ordered matching. Returns (scores_desc, is_tp) for this
    image; each GT matches at most one prediction."""
    order = np.argsort(-pred_scores)
    pred_boxes = pred_boxes[order]
    scores = pred_scores[order]
    ious = iou_matrix(pred_boxes, gt_boxes)
    taken = np.zeros(len(gt_boxes), bool)
    tp = np.zeros(len(pred_boxes), bool)
    for i in range(len(pred_boxes)):
        if len(gt_boxes) == 0:
            break
        j = int(np.argmax(np.where(taken, -1.0, ious[i])))
        if not taken[j] and ious[i, j] >= iou_thresh:
            taken[j] = True
            tp[i] = True
    return scores, tp


def pr_curve(
    scores: np.ndarray, is_tp: np.ndarray, n_gt: int
) -> Dict[str, np.ndarray]:
    """Precision/recall over the descending-score sweep + VOC-interpolated
    AP (the standard detection protocol)."""
    if len(scores) == 0:
        z = np.zeros(0, np.float32)
        return {"precision": z, "recall": z, "thresholds": z, "ap": 0.0}
    order = np.argsort(-scores)
    tp = np.cumsum(is_tp[order]).astype(np.float64)
    fp = np.cumsum(~is_tp[order]).astype(np.float64)
    precision = tp / np.maximum(tp + fp, 1e-9)
    recall = tp / max(n_gt, 1)
    # interpolated precision (monotone non-increasing)
    interp = np.maximum.accumulate(precision[::-1])[::-1]
    ap = 0.0
    prev_r = 0.0
    for p, r in zip(interp, recall):
        ap += p * (r - prev_r)
        prev_r = r
    return {
        "precision": precision.astype(np.float32),
        "recall": recall.astype(np.float32),
        "thresholds": scores[order].astype(np.float32),
        "ap": float(ap),
    }


def evaluate_detector_category(
    detector,
    category: str,
    n_scenes: int = 12,
    seed: int = 0,
    size: int = 320,
    iou_thresh: float = 0.5,
    operating_threshold: Optional[float] = None,
) -> Dict:
    """Run the detector over one stress suite -> PR metrics."""
    rng = np.random.default_rng(seed)
    all_scores: List[np.ndarray] = []
    all_tp: List[np.ndarray] = []
    n_gt = 0
    n_images = 0
    for _ in range(n_scenes):
        img, gt = render_stress_scene(rng, category, size=size)
        faces = detector.detect(img)
        pb = np.asarray([f["bbox"] for f in faces], np.float32).reshape(-1, 4)
        ps = np.asarray([f["det_score"] for f in faces], np.float32)
        s, tp = match_detections(pb, ps, gt, iou_thresh)
        all_scores.append(s)
        all_tp.append(tp)
        n_gt += len(gt)
        n_images += 1
    scores = np.concatenate(all_scores) if all_scores else np.zeros(0)
    is_tp = np.concatenate(all_tp) if all_tp else np.zeros(0, bool)
    curve = pr_curve(scores, is_tp, n_gt)

    out = {
        "category": category,
        "n_images": n_images,
        "n_gt_faces": int(n_gt),
        "n_detections": int(len(scores)),
        "ap": curve["ap"] if n_gt else None,
        "pr_curve": {
            "precision": curve["precision"].tolist(),
            "recall": curve["recall"].tolist(),
            "thresholds": curve["thresholds"].tolist(),
        },
    }
    if operating_threshold is not None:
        keep = scores >= operating_threshold
        tp_k = int(is_tp[keep].sum())
        fp_k = int((~is_tp[keep]).sum())
        out["operating_point"] = {
            "threshold": operating_threshold,
            "recall": tp_k / n_gt if n_gt else None,
            "precision": tp_k / max(tp_k + fp_k, 1) if (tp_k + fp_k) else 1.0,
            "false_positives_per_image": fp_k / max(n_images, 1),
        }
    return out


def run_stress_suite(
    detector,
    categories=STRESS_CATEGORIES,
    n_scenes: int = 12,
    seed: int = 0,
    size: int = 320,
    operating_threshold: float = 0.5,
) -> Dict:
    """Full stress report across categories."""
    results = {
        cat: evaluate_detector_category(
            detector, cat, n_scenes=n_scenes, seed=seed + i, size=size,
            operating_threshold=operating_threshold,
        )
        for i, cat in enumerate(categories)
    }
    summary = {}
    for cat, r in results.items():
        op = r.get("operating_point", {})
        summary[cat] = {
            "ap": r["ap"],
            "recall": op.get("recall"),
            "precision": op.get("precision"),
            "fp_per_image": op.get("false_positives_per_image"),
        }
    return {"summary": summary, "detail": results}
