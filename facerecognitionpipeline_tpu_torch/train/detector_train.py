"""Detector training: P/R/O-nets learn from rendered synthetic faces.

Counterpart of `facerecognitionpipeline_tpu/train/detector_train.py`: the
MTCNN patch recipe (classification + box regression [+ landmarks];
positives IoU >= 0.65, parts 0.4-0.65, negatives < 0.3 against the ground
truth) against the built-in synthetic renderer, Adam with lr 1e-3, and
online hard-example mining at `ohem_fraction < 1`.

The renderers and the patch sampler are the JAX package's numpy and cv2
code (cv2 imported at the call), so the same seed gives the same scenes
and patches byte for byte; `models/quantize.py::default_calibration_faces`
renders its crops here too. `torch.optim.Adam`'s update is optax.adam's
(lr, betas 0.9/0.999, eps 1e-8). `train_detector` returns JAX-format
variables {'pnet'|'rnet'|'onet': {'params': ...}} that
`MTCNNDetector(variables=...)` loads.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from facerecognitionpipeline_tpu_torch.models.convert import params_from_state
from facerecognitionpipeline_tpu_torch.models.detector_nets import ONet, PNet, RNet
from facerecognitionpipeline_tpu_torch.models.layers import lecun_truncated_normal_
from facerecognitionpipeline_tpu_torch.utils.device import resolve_device


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


def render_scene(
    rng: np.random.Generator,
    size: int = 160,
    max_faces: int = 2,
    min_face: int = 24,
    max_face: int = 64,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Random background + N synthetic 'faces' (skin ellipse, eyes, nose,
    mouth). Returns (image uint8 [S,S,3], boxes [N,4], landmarks [N,5,2])."""
    import cv2

    img = rng.integers(0, 120, size=(size, size, 3), dtype=np.uint8)
    # texture the background a little
    for _ in range(6):
        x, y = rng.integers(0, size, 2)
        w, h = rng.integers(8, 40, 2)
        color = tuple(int(c) for c in rng.integers(0, 140, 3))
        cv2.rectangle(img, (x, y), (x + w, y + h), color, -1)

    n = rng.integers(1, max_faces + 1)
    boxes, landmarks = [], []
    for _ in range(n):
        fsize = rng.integers(min_face, max_face + 1)
        s = fsize / 2.0
        cx = rng.uniform(s + 2, size - s - 2)
        cy = rng.uniform(s * 1.2 + 2, size - s * 1.2 - 2)
        theta = rng.uniform(-0.2, 0.2)
        ct, st = math.cos(theta), math.sin(theta)

        def rot(dx, dy):
            return (cx + ct * dx - st * dy, cy + st * dx + ct * dy)

        skin = tuple(int(c) for c in rng.integers(170, 230, 3))
        cv2.ellipse(
            img, (int(cx), int(cy)), (int(0.8 * s), int(s * 1.05)),
            math.degrees(theta), 0, 360, skin, -1,
        )
        dark = tuple(int(c) for c in rng.integers(10, 60, 3))
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

        boxes.append([cx - 0.85 * s, cy - 1.1 * s, cx + 0.85 * s, cy + 1.1 * s])
        landmarks.append([le, re, no, lm, rm])
    return img, np.asarray(boxes, np.float32), np.asarray(landmarks, np.float32)


def _iou(box: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    x1 = np.maximum(box[0], boxes[:, 0])
    y1 = np.maximum(box[1], boxes[:, 1])
    x2 = np.minimum(box[2], boxes[:, 2])
    y2 = np.minimum(box[3], boxes[:, 3])
    inter = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
    a = (box[2] - box[0]) * (box[3] - box[1])
    b = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    return inter / np.maximum(a + b - inter, 1e-9)


def sample_patches(
    rng: np.random.Generator,
    patch_size: int,
    batch: int,
    scene_fn: Optional[Callable] = None,
    with_landmarks: bool = False,
    class_balance: Optional[Tuple[float, float]] = None,
) -> Dict[str, np.ndarray]:
    """MTCNN patch sampler. Returns images [B,p,p,3] f32 (raw 0-255 RGB),
    cls labels [B] (1 pos / 0 neg / -1 part: ignored by cls loss), reg
    targets [B,4], reg mask [B], landmark targets [B,5,2] + mask [B].

    class_balance — optional (pos_fraction, part_fraction) quota. Without
    it the batch's label mix follows the scene distribution, so raising the
    stress renderer's pure-negative fraction STARVES positives (measured:
    pos 23.7% -> 20.3% of patches going pure_negative_p 0.30 -> 0.45) and
    the classifier turns conservative exactly on weak-evidence faces —
    the blur/occlusion-recall cost documented in
    reports/detector_stress/pure_negative_tradeoff.md. With a quota the
    batch always carries the same positive supervision and extra faceless
    scenes only add negative DIVERSITY."""
    import cv2

    scene_fn = scene_fn or (lambda r: render_scene(r))
    quota = None
    if class_balance is not None:
        n_pos = int(round(batch * class_balance[0]))
        n_part = int(round(batch * class_balance[1]))
        quota = {1: n_pos, -1: n_part, 0: batch - n_pos - n_part}
    imgs = np.zeros((batch, patch_size, patch_size, 3), np.float32)
    cls = np.zeros(batch, np.int32)
    reg = np.zeros((batch, 4), np.float32)
    reg_mask = np.zeros(batch, bool)
    lmk = np.zeros((batch, 5, 2), np.float32)
    lmk_mask = np.zeros(batch, bool)

    i = 0
    while i < batch:
        out = scene_fn(rng)
        scene, boxes, lms = out[:3]
        # optional 4th element: explicit hard-negative boxes (face-like
        # distractors) — sampled as negative windows so the classifier sees
        # them; random windows almost never land on them otherwise
        neg_boxes = out[3] if len(out) > 3 else np.zeros((0, 4), np.float32)
        size = scene.shape[0]
        # ~half positives/parts (jittered gt windows), half random negatives
        for _ in range(8):
            if i >= batch:
                break
            r = rng.random()
            if quota is not None:
                want_face = quota[1] > 0 or quota[-1] > 0
                if not want_face:
                    r = 1.0  # only negatives still needed
                elif quota[0] <= 0:
                    if not len(boxes):
                        break  # faceless scene can't fill a face quota
                    r = 0.0  # force the jittered-gt branch
            if r < 0.55 and len(boxes):
                j = rng.integers(0, len(boxes))
                bx = boxes[j]
                side = (bx[2] - bx[0] + bx[3] - bx[1]) / 2
                jitter = 0.35 if rng.random() < 0.5 else 0.12
                w = side * rng.uniform(0.8, 1.25)
                cxn = (bx[0] + bx[2]) / 2 + rng.uniform(-jitter, jitter) * side
                cyn = (bx[1] + bx[3]) / 2 + rng.uniform(-jitter, jitter) * side
                win = np.array([cxn - w / 2, cyn - w / 2, cxn + w / 2, cyn + w / 2])
            elif r < 0.75 and len(neg_boxes):
                # hard negative: a jittered window on a distractor
                j = rng.integers(0, len(neg_boxes))
                bx = neg_boxes[j]
                side = max((bx[2] - bx[0] + bx[3] - bx[1]) / 2, 8.0)
                w = side * rng.uniform(0.8, 1.3)
                cxn = (bx[0] + bx[2]) / 2 + rng.uniform(-0.15, 0.15) * side
                cyn = (bx[1] + bx[3]) / 2 + rng.uniform(-0.15, 0.15) * side
                win = np.array([cxn - w / 2, cyn - w / 2, cxn + w / 2, cyn + w / 2])
            else:
                w = rng.uniform(patch_size * 0.6, size * 0.7)
                x = rng.uniform(0, size - w)
                y = rng.uniform(0, size - w)
                win = np.array([x, y, x + w, y + w])

            win = np.clip(win, 0, size)
            if win[2] - win[0] < 8 or win[3] - win[1] < 8:
                continue
            ious = _iou(win, boxes) if len(boxes) else np.zeros(1)
            best = int(np.argmax(ious))
            iou = float(ious.max()) if len(boxes) else 0.0

            crop = scene[int(win[1]):int(win[3]), int(win[0]):int(win[2])]
            if crop.size == 0:
                continue
            crop = cv2.resize(crop.astype(np.float32), (patch_size, patch_size))

            if iou >= 0.65:
                label = 1
            elif iou < 0.3:
                label = 0
            elif iou >= 0.4:
                label = -1  # part: reg only
            else:
                continue
            if quota is not None:
                if quota[label] <= 0:
                    continue
                quota[label] -= 1

            imgs[i] = crop
            cls[i] = label
            if label != 0:
                bw, bh = win[2] - win[0], win[3] - win[1]
                gt = boxes[best]
                reg[i] = [
                    (gt[0] - win[0]) / bw,
                    (gt[1] - win[1]) / bh,
                    (gt[2] - win[2]) / bw,
                    (gt[3] - win[3]) / bh,
                ]
                reg_mask[i] = True
                if with_landmarks and label == 1:
                    lmk[i] = (lms[best] - win[None, :2]) / np.array([bw, bh])
                    lmk_mask[i] = True
            i += 1

    return {
        "images": imgs,
        "cls": cls,
        "reg": reg,
        "reg_mask": reg_mask,
        "lmk": lmk,
        "lmk_mask": lmk_mask,
    }


# ------------------------------------------------------------------ trainer


def _loss_fn(net, batch: Dict[str, torch.Tensor], with_landmarks: bool,
             ohem_fraction: float = 1.0):
    """(loss, accuracy) of a patch batch (tensors on the net's device).
    With ohem_fraction < 1 only the hardest fraction of the CLASSIFIED
    samples (label >= 0) keeps its classification loss: k counts those
    only, and the threshold is the k-th largest loss from the sort."""
    x = (batch["images"] - 127.5) / 128.0
    out = net(x)
    if with_landmarks:
        prob, reg, lmk = out
    else:
        prob, reg = out
    if prob.dim() > 1:  # P-net's map on a 12x12 input: [B, 1, 1]
        prob = prob.reshape(prob.shape[0], -1)[:, 0]
        reg = reg.reshape(reg.shape[0], -1)[:, :4]

    labels = batch["cls"]
    cls_mask = labels >= 0
    p = prob.clamp(1e-6, 1 - 1e-6)
    ce = -(labels * torch.log(p) + (1 - labels) * torch.log(1 - p))
    if ohem_fraction < 1.0:
        masked_ce = torch.where(cls_mask, ce, torch.full_like(ce, -1.0))
        n_cls = cls_mask.sum()
        k = torch.clamp_min(torch.floor(ohem_fraction * n_cls), 1).long()
        srt = torch.sort(masked_ce.detach()).values
        thresh = srt[srt.shape[0] - k]
        cls_mask = cls_mask & (masked_ce >= thresh)
    cls_w = cls_mask.to(ce.dtype)
    cls_loss = (ce * cls_w).sum() / cls_w.sum().clamp_min(1)

    reg_err = ((reg - batch["reg"]) ** 2).sum(dim=1)
    reg_w = batch["reg_mask"].to(reg_err.dtype)
    loss = cls_loss + 0.5 * (reg_err * reg_w).sum() / reg_w.sum().clamp_min(1)
    if with_landmarks:
        lmk_err = ((lmk - batch["lmk"]) ** 2).sum(dim=(1, 2))
        lmk_w = batch["lmk_mask"].to(lmk_err.dtype)
        loss = loss + 0.5 * (lmk_err * lmk_w).sum() / lmk_w.sum().clamp_min(1)
    correct = ((prob > 0.5) == (labels == 1)).to(cls_w.dtype)
    acc = (correct * cls_w).sum() / cls_w.sum().clamp_min(1)
    return loss, acc


def net_train_step(net, opt: torch.optim.Optimizer, batch: Dict[str, torch.Tensor],
                   with_landmarks: bool, ohem_fraction: float = 1.0):
    """One Adam step of a cascade net on a patch batch; (loss, accuracy)
    stay on the device."""
    opt.zero_grad(set_to_none=True)
    loss, acc = _loss_fn(net, batch, with_landmarks, ohem_fraction)
    loss.backward()
    opt.step()
    return loss.detach(), acc.detach()


def train_net(
    net,
    patch_size: int,
    steps: int = 400,
    batch: int = 256,
    lr: float = 1e-3,
    seed: int = 0,
    with_landmarks: bool = False,
    scene_fn: Optional[Callable] = None,
    log_every: int = 100,
    ohem_fraction: float = 1.0,
    class_balance: Optional[Tuple[float, float]] = None,
    device="cuda",
    history: Optional[list] = None,
) -> dict:
    """Train one cascade net (a PNet, RNet or ONet) on synthetic patches;
    returns its JAX-format variables {'params': ...}. The weights start
    from flax's initialisers in distribution, drawn from `seed`; the
    patches come from numpy's generator seeded with `seed`. `history`, if
    given, receives every step's loss (fetched once, at the end)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    lecun_truncated_normal_(net, torch.Generator().manual_seed(seed))
    net = net.to(dev).float().train()
    opt = torch.optim.Adam(net.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    losses = []
    for i in range(steps):
        data = sample_patches(
            rng, patch_size, batch, scene_fn=scene_fn,
            with_landmarks=with_landmarks, class_balance=class_balance,
        )
        data = {k: torch.from_numpy(v).to(dev, non_blocking=True) for k, v in data.items()}
        loss, acc = net_train_step(net, opt, data, with_landmarks, ohem_fraction)
        losses.append(loss)
        if (i + 1) % log_every == 0:
            print(
                f"  {net.__class__.__name__} step {i+1}/{steps}: "
                f"loss {float(loss):.4f} cls-acc {float(acc):.3f}"
            )
    if history is not None and losses:
        history.extend(torch.stack(losses).cpu().tolist())
    return {"params": params_from_state(net.state_dict())}


# the cascade's nets as train_detector trains them: (name, class, patch
# size, with landmarks, seed offset)
CASCADE_NETS = (("pnet", PNet, 12, False, 0),
                ("rnet", RNet, 24, False, 1),
                ("onet", ONet, 48, True, 2))


def train_detector(
    steps: int = 400,
    batch: int = 256,
    seed: int = 0,
    scene_fn: Optional[Callable] = None,
    log_every: int = 100,
    ohem_fraction: float = 1.0,
    class_balance: Optional[Tuple[float, float]] = None,
    device="cuda",
    history: Optional[dict] = None,
) -> dict:
    """Train the full cascade; returns MTCNNDetector-compatible variables.
    `history`, if given, maps 'pnet'/'rnet'/'onet' to each net's losses."""
    out = {}
    for name, net, size, lmk, offset in CASCADE_NETS:
        print(f"Training {name[0].upper()}-Net...")
        log = None if history is None else history.setdefault(name, [])
        out[name] = train_net(net(), size, steps, batch, seed=seed + offset,
                              with_landmarks=lmk, scene_fn=scene_fn, log_every=log_every,
                              ohem_fraction=ohem_fraction, class_balance=class_balance,
                              device=device, history=log)
    return out
