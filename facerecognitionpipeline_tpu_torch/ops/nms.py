"""Masked fixed-shape non-maximum suppression, and a stable top-k.

Counterpart of `facerecognitionpipeline_tpu/ops/nms.py`. Every function
takes optional leading batch dims, so the detector runs one NMS over all
frames of a batch instead of one per frame.
"""

from __future__ import annotations

import torch

from facerecognitionpipeline_tpu_torch.ops.nms_kernel import (  # noqa: F401 (re-exported)
    nms_sorted_kernel,
    pairwise_iou,
)

_NEG = -1e9


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the last dim with ties broken to the LOWER index, as
    `jax.lax.top_k` does (`torch.topk` promises no tie order, and padded
    -1e9 slots tie constantly). A stable descending sort gives exactly
    that order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


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
    `while_loop`. The masked score, the stable sort, the gathers and the
    scatter back are torch ops; the IoUs, the conflict mask and the loop
    are kernel K5 (`ops/nms_kernel.py`) on a CUDA tensor, computed from the
    sorted boxes with no [..., N, N] tensor and no host read, and its plain
    version (`pairwise_iou`, the mask, the loop) on a CPU tensor."""
    masked = torch.where(valid, scores, torch.full_like(scores, _NEG))
    order = torch.sort(masked, dim=-1, descending=True, stable=True).indices
    b = torch.gather(boxes, -2, order[..., None].expand(*order.shape, 4))
    v = torch.gather(valid, -1, order)

    keep = nms_sorted_kernel(b, v, iou_threshold, mode)
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
