"""Out-of-distribution detector evaluation.

Counterpart of `facerecognitionpipeline_tpu/evalharness/detection_ood.py`.
The stress suite in `detection.py` renders from the same procedural family
the cascade trains on, so its APs measure fit, not generalization. This
module bounds generalization on two held-out axes:

1. A different renderer: scenes come from `train/facegen.py`, which shares
   no drawing code with any training renderer (jaw-polygon outlines,
   sclera-and-iris eyes, curved mouths, hair, glasses, facial hair, yaw and
   pitch parallax, photographic backgrounds, directional lighting).

2. Photometric corruptions the training mix never applies: JPEG artifacts,
   defocus (Gaussian) blur, low light with signal-dependent shot noise,
   sensor banding with a channel cast.

Scoring (`match_detections`, `pr_curve`) is the in-distribution suite's:
the same protocol on another distribution. Any detector with
`detect(image) -> list of face dicts` is scored; the port's bf16 cascade
launches K1 twice per scene on the card.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from facerecognitionpipeline_tpu_torch.evalharness.detection import (
    match_detections,
    pr_curve,
)
from facerecognitionpipeline_tpu_torch.train.facegen import (
    compose_scene,
    sample_identity,
)

# Identity seeds for OOD scenes: any range works (the detector never saw a
# facegen face), but stay away from the embedder eval's held-out block for
# hygiene.
_OOD_ID_OFFSET = 20_000


# ----------------------------------------------------------- corruptions


def _jpeg(img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    import cv2

    q = int(rng.integers(8, 21))
    ok, enc = cv2.imencode(".jpg", img[:, :, ::-1],
                           [int(cv2.IMWRITE_JPEG_QUALITY), q])
    if not ok:  # pragma: no cover - imencode failure
        return img
    return cv2.imdecode(enc, cv2.IMREAD_COLOR)[:, :, ::-1]


def _defocus(img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    import cv2

    k = int(rng.choice([5, 7, 9]))
    return cv2.GaussianBlur(img, (k, k), 0)


def _lowlight(img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Exposure drop with signal-dependent (shot) noise + read noise."""
    scale = rng.uniform(0.18, 0.38)
    signal = img.astype(np.float32) * scale
    shot = rng.normal(0, 1, img.shape) * np.sqrt(np.maximum(signal, 1.0))
    read = rng.normal(0, rng.uniform(2, 6), img.shape)
    return np.clip(signal + shot + read, 0, 255).astype(np.uint8)


def _banding(img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Rolling-shutter style horizontal banding + channel cast."""
    h = img.shape[0]
    period = float(rng.uniform(6, 18))
    phase = rng.uniform(0, 2 * np.pi)
    amp = rng.uniform(0.08, 0.2)
    rows = 1.0 + amp * np.sin(np.arange(h) * 2 * np.pi / period + phase)
    cast = rng.uniform(0.85, 1.15, 3)
    out = img.astype(np.float32) * rows[:, None, None] * cast[None, None, :]
    return np.clip(out, 0, 255).astype(np.uint8)


_CORRUPTIONS = {
    "jpeg": _jpeg,
    "defocus": _defocus,
    "lowlight": _lowlight,
    "banding": _banding,
}


# ---------------------------------------------------------------- scenes


def _identities(rng: np.random.Generator, n: int, force: Optional[Dict] = None):
    idents = [
        sample_identity(_OOD_ID_OFFSET + int(rng.integers(0, 100_000)))
        for _ in range(n)
    ]
    if force:
        for ident in idents:
            ident.update(force)
    return idents


def render_ood_scene(
    rng: np.random.Generator, category: str, size: int = 320
):
    """(image uint8 [S,S,3], gt boxes [N,4]) for one OOD category."""
    base = category.split("+")[0]
    corruption = category.split("+")[1] if "+" in category else None

    if base == "facegen":
        idents = _identities(rng, int(rng.integers(2, 4)))
        img, boxes, _, _ = compose_scene(idents, rng, size=size,
                                         min_face=48, max_face=110)
    elif base == "facegen_crowded":
        idents = _identities(rng, 5)
        img, boxes, _, _ = compose_scene(idents, rng, size=size,
                                         min_face=44, max_face=80)
    elif base == "facegen_accessories":
        # glasses + facial hair + bald: the accessory-heavy end of the
        # held-out population (training faces have none of these)
        idents = _identities(
            rng, int(rng.integers(2, 4)),
            force={"glasses": True, "beard": True, "mustache": True,
                   "bald": bool(rng.random() < 0.5)},
        )
        img, boxes, _, _ = compose_scene(idents, rng, size=size,
                                         min_face=48, max_face=110)
    else:
        raise ValueError(f"unknown OOD base category: {base}")

    if corruption is not None:
        img = _CORRUPTIONS[corruption](img, rng)
    return img, boxes


OOD_CATEGORIES = (
    "facegen",
    "facegen_crowded",
    "facegen_accessories",
    "facegen+jpeg",
    "facegen+defocus",
    "facegen+lowlight",
    "facegen+banding",
)


# ------------------------------------------------------------- evaluation


def evaluate_detector_ood_category(
    detector,
    category: str,
    n_scenes: int = 12,
    seed: int = 0,
    size: int = 320,
    iou_thresh: float = 0.5,
    operating_threshold: Optional[float] = 0.5,
) -> Dict:
    """One OOD suite -> PR metrics (same schema as the in-distribution
    stress suite, detection.py::evaluate_detector_category)."""
    rng = np.random.default_rng(seed)
    all_scores, all_tp = [], []
    n_gt = 0
    for _ in range(n_scenes):
        img, gt = render_ood_scene(rng, category, size=size)
        faces = detector.detect(img)
        pb = np.asarray([f["bbox"] for f in faces], np.float32).reshape(-1, 4)
        ps = np.asarray([f["det_score"] for f in faces], np.float32)
        s, tp = match_detections(pb, ps, gt, iou_thresh)
        all_scores.append(s)
        all_tp.append(tp)
        n_gt += len(gt)
    scores = np.concatenate(all_scores) if all_scores else np.zeros(0)
    is_tp = np.concatenate(all_tp) if all_tp else np.zeros(0, bool)
    curve = pr_curve(scores, is_tp, n_gt)
    out = {
        "category": category,
        "n_images": n_scenes,
        "n_gt_faces": int(n_gt),
        "n_detections": int(len(scores)),
        "ap": curve["ap"] if n_gt else None,
    }
    if operating_threshold is not None:
        keep = scores >= operating_threshold
        tp_k = int(is_tp[keep].sum())
        fp_k = int((~is_tp[keep]).sum())
        out["operating_point"] = {
            "threshold": operating_threshold,
            "recall": tp_k / n_gt if n_gt else None,
            "precision": tp_k / max(tp_k + fp_k, 1) if (tp_k + fp_k) else 1.0,
            "false_positives_per_image": fp_k / max(n_scenes, 1),
        }
    return out


def run_ood_suite(
    detector,
    categories=OOD_CATEGORIES,
    n_scenes: int = 12,
    seed: int = 0,
    size: int = 320,
    operating_threshold: float = 0.5,
) -> Dict:
    """Full OOD report: {summary: {cat: {ap, recall, ...}}, detail: ...}."""
    results = {
        cat: evaluate_detector_ood_category(
            detector, cat, n_scenes=n_scenes, seed=seed + 100 * i, size=size,
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
