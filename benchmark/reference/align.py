"""Plain alignment, quality gate and gallery match: the yardsticks of the
align, gate and match layers.

Alignment: the least-squares non-reflective similarity that maps a face's
five landmarks onto the template (fractions (0.34, 0.46), (0.66, 0.46),
(0.50, 0.61), (0.37, 0.74), (0.63, 0.74) of 112 px), a 128 px window of
the frame around the face, then one bilinear sample of the window per
output pixel, rounded and clipped to 0..255 (see `align`).

Gate: a face passes when it is a valid detection, its score is at least
0.5, its box's short side at least 40 px, |yaw| <= 45, |pitch| <= 30,
|roll| <= 30 degrees (angles from the landmarks) and the variance of the
3x3 Laplacian of its aligned crop's luma (BT.601, rounded, reflect-101
border) at least 50.

Match: cosine top-k of unit queries against the gallery rows: float32
rows, or per-row symmetric int8 codes with queries quantised per row the
same way (scale max|row| / 127) and exact integer dot products.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

TEMPLATE_FRACTIONS = np.array(
    [[0.34, 0.46], [0.66, 0.46], [0.50, 0.61], [0.37, 0.74], [0.63, 0.74]], np.float32)


def similarity(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """src [F, 5, 2], dst [5, 2] -> forward maps [F, 2, 3]."""
    src = src.float()
    dst = dst.float().expand(src.shape)
    sm, dm = src.mean(1, keepdim=True), dst.mean(1, keepdim=True)
    x, y = src - sm, dst - dm
    den = (x * x).sum((1, 2))
    den = torch.where(den > 0, den, torch.ones_like(den))
    a = (x * y).sum((1, 2)) / den
    b = (x[..., 0] * y[..., 1] - x[..., 1] * y[..., 0]).sum(1) / den
    rot = torch.stack([torch.stack([a, -b], -1), torch.stack([b, a], -1)], 1)
    t = dm[:, 0] - torch.einsum("fij,fj->fi", rot, sm[:, 0])
    return torch.cat([rot, t[..., None]], 2)


def invert(m: torch.Tensor) -> torch.Tensor:
    """Inverse of affine maps [F, 2, 3]."""
    a, t = m[:, :, :2], m[:, :, 2]
    det = a[:, 0, 0] * a[:, 1, 1] - a[:, 0, 1] * a[:, 1, 0]
    det = torch.where(det.abs() > 1e-12, det, torch.full_like(det, 1e-12))
    inv = torch.stack([torch.stack([a[:, 1, 1], -a[:, 0, 1]], -1),
                       torch.stack([-a[:, 1, 0], a[:, 0, 0]], -1)], 1) / det[:, None, None]
    return torch.cat([inv, -torch.einsum("fij,fj->fi", inv, t)[..., None]], 2)


def align(frame: torch.Tensor, landmarks: torch.Tensor, size: int = 112,
          patch: int = 128) -> torch.Tensor:
    """One frame [H, W, 3], landmarks [F, 5, 2] -> [F, size, size, 3]
    float32 aligned crops, rounded and clipped (what is served as uint8).

    Two resamplings, as the served alignment specifies them: stage A cuts
    a `patch` px window around the face's source extent (plus 2 px) out of
    the frame, a pixel copy where the extent fits the window (its start
    snapped to an integer), a bilinear resize of the extent otherwise;
    stage B samples the patch bilinearly (zero outside it) at each output
    pixel's source position."""
    dst = torch.from_numpy(TEMPLATE_FRACTIONS * float(size)).to(frame.device)
    inv = invert(similarity(landmarks, dst))
    dev = frame.device
    c = torch.tensor([[0, 0], [size - 1, 0], [0, size - 1], [size - 1, size - 1]],
                     dtype=torch.float32, device=dev)
    src_c = torch.einsum("fij,kj->fki", inv[:, :, :2], c) + inv[:, None, :, 2]

    def axis(lo, hi):
        lo, hi = lo - 2.0, hi + 2.0
        fits = (hi - lo) <= patch
        start = torch.floor(0.5 * (lo + hi) - 0.5 * patch + 0.5)
        return torch.where(fits, start, lo), torch.where(fits, start + patch, hi)

    x1, x2 = axis(src_c[..., 0].amin(1), src_c[..., 0].amax(1))
    y1, y2 = axis(src_c[..., 1].amin(1), src_c[..., 1].amax(1))
    from benchmark.reference.mtcnn import crop_resize

    pt = crop_resize(frame.float(), torch.stack([x1, y1, x2, y2], 1), patch)  # [F, k, k, 3]
    g = torch.arange(size, dtype=torch.float32, device=dev)
    gy, gx = torch.meshgrid(g, g, indexing="ij")
    sx = inv[:, 0, 0, None, None] * gx + inv[:, 0, 1, None, None] * gy + inv[:, 0, 2, None, None]
    sy = inv[:, 1, 0, None, None] * gx + inv[:, 1, 1, None, None] * gy + inv[:, 1, 2, None, None]
    px = (sx + 0.5 - x1[:, None, None]) * (patch / (x2 - x1).clamp_min(1e-6))[:, None, None] - 0.5
    py = (sy + 0.5 - y1[:, None, None]) * (patch / (y2 - y1).clamp_min(1e-6))[:, None, None] - 0.5
    x0, y0 = torch.floor(px), torch.floor(py)
    wx, wy = (px - x0)[..., None], (py - y0)[..., None]
    x0, y0 = x0.long(), y0.long()
    f = torch.arange(pt.shape[0], device=dev)[:, None, None]

    def tap(yy, xx):
        inb = ((yy >= 0) & (yy < patch) & (xx >= 0) & (xx < patch))[..., None].float()
        return pt[f, yy.clamp(0, patch - 1), xx.clamp(0, patch - 1)] * inb

    top = tap(y0, x0) * (1 - wx) + tap(y0, x0 + 1) * wx
    bot = tap(y0 + 1, x0) * (1 - wx) + tap(y0 + 1, x0 + 1) * wx
    return (top * (1 - wy) + bot * wy).round().clamp(0, 255)


def blur(faces: torch.Tensor) -> torch.Tensor:
    """[F, H, W, 3] RGB -> [F] variance of the Laplacian of the luma."""
    w = torch.tensor([0.299, 0.587, 0.114], device=faces.device)
    gray = torch.round(faces.float() @ w)
    n, h, wd = gray.shape
    g = F.pad(gray[:, None], (1, 1, 1, 1), mode="reflect")[:, 0]
    lap = g[:, :-2, 1:-1] + g[:, 2:, 1:-1] + g[:, 1:-1, :-2] + g[:, 1:-1, 2:] - 4 * g[:, 1:-1, 1:-1]
    return lap.reshape(n, -1).var(dim=1, unbiased=False)


def gate(scores, boxes, landmarks, valid, aligned, cfg: dict) -> torch.Tensor:
    """The quality gate of every face -> [F] bool."""
    lm = landmarks.float()
    le, re, nose, lmth, rmth = (lm[:, i] for i in range(5))
    deg = 180.0 / math.pi
    ec = (le + re) * 0.5
    d = re - le
    roll = torch.atan2(d[:, 1], d[:, 0]) * deg
    dist = torch.linalg.vector_norm(d, dim=-1)
    dist = torch.where(dist > 0, dist, torch.ones_like(dist))
    yaw = torch.asin(((nose[:, 0] - ec[:, 0]) / dist).clamp(-1, 1)) * deg * 2
    fh = (lmth[:, 1] + rmth[:, 1]) * 0.5 - ec[:, 1]
    fh = torch.where(fh != 0, fh, torch.ones_like(fh))
    pitch = ((nose[:, 1] - ec[:, 1]) / fh - 0.5) * 60.0
    size = torch.minimum(boxes[:, 2] - boxes[:, 0], boxes[:, 3] - boxes[:, 1])
    ok = (scores >= cfg["min_det_score"]) & (size >= cfg["min_face_size"])
    ok &= (yaw.abs() <= 45) & (pitch.abs() <= 30) & (roll.abs() <= 30)
    ok &= blur(aligned) >= cfg["blur_threshold"]
    return ok & valid


def quantize_rows(x: torch.Tensor, bits: int = 8):
    """[N, D] -> (codes float32 [N, D], scales [N]): scale = max|row| /
    qmax (1 for a zero row), codes rounded half to even and clipped."""
    qmax = float(2 ** (bits - 1) - 1)
    amax = x.abs().amax(1, keepdim=True)
    scale = torch.where(amax > 0, amax / qmax, torch.ones_like(amax))
    return torch.round(x / scale).clamp(-qmax, qmax), scale[:, 0]


def match(queries: torch.Tensor, rows: torch.Tensor, k: int, row_scales=None,
          block: int = 64) -> tuple:
    """queries [Q, D] -> (scores [Q, k], indices [Q, k]) of the cosine
    top-k against float32 rows [G, D], or, with `row_scales`, against the
    int8 codes `rows` (from `quantize_rows`) with the queries quantised the
    same way. Needs TF32 off."""
    q = queries.float()
    q = q / (torch.linalg.vector_norm(q, dim=1, keepdim=True) + 1e-8)
    if row_scales is not None:
        qc, qs = quantize_rows(q)
    out_s, out_i = [], []
    for i in range(0, q.shape[0], block):
        if row_scales is not None:
            # integer codes: every partial sum is below 2**24, exact in float32
            s = (qc[i:i + block] @ rows.T) * row_scales[None] * qs[i:i + block, None]
        else:
            s = q[i:i + block] @ rows.T
        v, j = torch.topk(s, k, dim=1)
        out_s.append(v)
        out_i.append(j)
    return torch.cat(out_s), torch.cat(out_i)
