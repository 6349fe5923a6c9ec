"""Masked fixed-shape non-maximum suppression, and a stable top-k.

Counterpart of `facerecognitionpipeline_tpu/ops/nms.py`. Every function
takes optional leading batch dims, so the detector runs one NMS over all
frames of a batch instead of one per frame.
"""

from __future__ import annotations

import torch

from facerecognitionpipeline_tpu_torch.ops.nms_kernel import nms_fixpoint_kernel

_NEG = -1e9


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the last dim with ties broken to the LOWER index, as
    `jax.lax.top_k` does (`torch.topk` promises no tie order, and padded
    -1e9 slots tie constantly). A stable descending sort gives exactly
    that order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def pairwise_iou(boxes: torch.Tensor, mode: str = "union") -> torch.Tensor:
    """[..., N, 4] (x1,y1,x2,y2) -> [..., N, N] IoU. mode='min' divides by
    the smaller area (MTCNN's final-stage convention)."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1).clamp_min(0) * (y2 - y1).clamp_min(0)
    ix1 = torch.maximum(x1[..., :, None], x1[..., None, :])
    iy1 = torch.maximum(y1[..., :, None], y1[..., None, :])
    ix2 = torch.minimum(x2[..., :, None], x2[..., None, :])
    iy2 = torch.minimum(y2[..., :, None], y2[..., None, :])
    inter = (ix2 - ix1).clamp_min(0) * (iy2 - iy1).clamp_min(0)
    if mode == "min":
        denom = torch.minimum(area[..., :, None], area[..., None, :])
    else:
        denom = area[..., :, None] + area[..., None, :] - inter
    return inter / denom.clamp_min(1e-9)


def nms_mask(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    valid: torch.Tensor,
    iou_threshold: float = 0.5,
    mode: str = "union",
) -> torch.Tensor:
    """Greedy NMS keep-mask over padded boxes [..., N, 4], scores [..., N],
    valid [..., N] bool -> keep [..., N] bool in the original order.

    Exact greedy NMS as a Jacobi fixpoint: keep(i) = valid(i) and no KEPT
    higher-ranked box conflicts with i. Seven sweeps run unconditionally
    (real scenes' suppression chains are shallow), then pairs of sweeps
    while the keep mask still changes, as in the JAX package's
    `while_loop`: kernel K5
    (`ops/nms_kernel.py`) on a CUDA tensor, with no host read, its plain
    version on a CPU tensor. The sort, the IoU matrix and the scatter back
    stay torch ops."""
    n = boxes.shape[-2]
    masked = torch.where(valid, scores, torch.full_like(scores, _NEG))
    order = torch.sort(masked, dim=-1, descending=True, stable=True).indices
    b = torch.gather(boxes, -2, order[..., None].expand(*order.shape, 4))
    v = torch.gather(valid, -1, order)

    iou = pairwise_iou(b, mode=mode)
    idx = torch.arange(n, device=boxes.device)
    conflict = (iou > iou_threshold) & (idx[None, :] < idx[:, None])

    keep = nms_fixpoint_kernel(conflict, v)
    return torch.zeros_like(valid).scatter(-1, order, keep)


def topk_boxes(
    boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k by masked score into a fixed [..., k] layout."""
    masked = torch.where(valid, scores, torch.full_like(scores, _NEG))
    top_scores, top_idx = top_k(masked, k)
    top_boxes = torch.gather(
        boxes, -2, top_idx[..., None].expand(*top_idx.shape, 4)
    )
    return top_boxes, top_scores, top_scores > _NEG / 2
