"""Batched similarity-transform face alignment.

Counterpart of `facerecognitionpipeline_tpu/ops/warp.py`: the closed-form
similarity fit, the stage-A source windows with the integer-window snap,
the stage-B coefficients, the plain `crop_resize` (the detector's
half-resolution R-net source frame) and the two-kernel batch alignment
`align_faces_batch` (K1 for stage A, K2 for stage B) of the serving step.

The engine's 'matmul' alignment is `align_faces_matmul`: the same stage-A
windows cut by the plain `crop_resize`, then stage B as a dense bilinear
contraction (`warp_affine_single_matmul`), all plain PyTorch.

The host pipeline's alignment (`FaceProcessor`, enrolment, matching) is the
gather path: `warp_affine`, `bilinear_sample` (zero or replicate border),
`warp_affine_single`, `crop_resize_gather` and `align_faces`. The JAX
package runs these as XLA gathers, no Pallas kernel; here they are plain
PyTorch on whatever device the image lies on, with the same arithmetic
order (a product of two terms then a sum, no contraction asked for).
"""

from __future__ import annotations

import numpy as np
import torch

from facerecognitionpipeline_tpu_torch.ops.crop_kernel import (
    crop_resize_kernel,
    crop_resize_plain,
    hat_weights,
)
from facerecognitionpipeline_tpu_torch.ops.numerics import device_constant, rdiv, round_to
from facerecognitionpipeline_tpu_torch.ops.warp_kernel import warp_patches_kernel

# insightface/ArcFace canonical 112x112 5-point template.
ARCFACE_TEMPLATE = np.array(
    [
        [38.2946, 51.6963],
        [73.5318, 51.5014],
        [56.0252, 71.7366],
        [41.5493, 92.3655],
        [70.7299, 92.2041],
    ],
    dtype=np.float32,
)

# The reference pipeline's fractional 5-point template (left eye, right
# eye, nose, left mouth, right mouth), scaled by the output size.
_REFERENCE_FRACTIONS = np.array(
    [[0.34, 0.46], [0.66, 0.46], [0.50, 0.61], [0.37, 0.74], [0.63, 0.74]],
    dtype=np.float32,
)


def reference_template(output_size: int = 112) -> np.ndarray:
    """The 5-point template scaled to `output_size` ([5, 2] float32)."""
    return _REFERENCE_FRACTIONS * float(output_size)


def similarity_transform(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Least-squares non-reflective similarity mapping src [F,K,2] onto dst
    ([K,2] or [F,K,2]) -> forward affine matrices [F,2,3] (the
    cv2.estimateAffinePartial2D convention)."""
    src = src.float()
    dst = dst.float().to(src.device).expand(src.shape)
    src_mean = src.mean(dim=1, keepdim=True)
    dst_mean = dst.mean(dim=1, keepdim=True)
    x = src - src_mean
    y = dst - dst_mean
    denom = (x * x).sum(dim=(1, 2))
    denom = torch.where(denom > 0, denom, torch.ones_like(denom))
    a = (x * y).sum(dim=(1, 2)) / denom
    b = (x[:, :, 0] * y[:, :, 1] - x[:, :, 1] * y[:, :, 0]).sum(dim=1) / denom
    rot = torch.stack(
        [torch.stack([a, -b], dim=-1), torch.stack([b, a], dim=-1)], dim=1
    )  # [F,2,2]
    t = dst_mean[:, 0, :] - torch.einsum("fij,fj->fi", rot, src_mean[:, 0, :])
    return torch.cat([rot, t[:, :, None]], dim=2)


def invert_affine(m: torch.Tensor) -> torch.Tensor:
    """Invert batched 2x3 affine matrices [F,2,3]."""
    a = m[:, :, :2]
    t = m[:, :, 2]
    det = a[:, 0, 0] * a[:, 1, 1] - a[:, 0, 1] * a[:, 1, 0]
    det = torch.where(det.abs() > 1e-12, det, torch.full_like(det, 1e-12))
    inv = torch.stack(
        [
            torch.stack([a[:, 1, 1], -a[:, 0, 1]], dim=-1),
            torch.stack([-a[:, 1, 0], a[:, 0, 0]], dim=-1),
        ],
        dim=1,
    ) / det[:, None, None]
    inv_t = -torch.einsum("fij,fj->fi", inv, t)
    return torch.cat([inv, inv_t[:, :, None]], dim=2)


def source_windows(
    matrices: torch.Tensor, out_h: int, out_w: int, patch_size: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Stage-A source windows: forward maps [F,2,3] -> (inverse maps
    [F,2,3], boxes [F,4]). A window snaps to an integer offset of exactly
    `patch_size` pixels whenever the face's source extent (plus a 2 px
    margin) fits it, which makes the stage-A hat weights one-hot: a
    lossless pixel copy."""
    k = patch_size
    inv = invert_affine(matrices)
    corners = device_constant(
        (0, 0, out_w - 1, 0, 0, out_h - 1, out_w - 1, out_h - 1), matrices.device
    ).reshape(4, 2)  # (x, y)
    src_c = torch.einsum("fij,kj->fki", inv[:, :, :2], corners) + inv[:, None, :, 2]
    pad = 2.0

    def axis_box(lo, hi):
        lo = lo - pad
        hi = hi + pad
        fits = (hi - lo) <= k
        start = torch.floor(0.5 * (lo + hi) - 0.5 * k + 0.5)
        return torch.where(fits, start, lo), torch.where(fits, start + k, hi)

    x1, x2 = axis_box(src_c[:, :, 0].amin(dim=1), src_c[:, :, 0].amax(dim=1))
    y1, y2 = axis_box(src_c[:, :, 1].amin(dim=1), src_c[:, :, 1].amax(dim=1))
    return inv, torch.stack([x1, y1, x2, y2], dim=1)


def warp_coeffs(
    matrices: torch.Tensor, out_h: int, out_w: int, patch_size: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Stage-B geometry: forward maps [F,2,3] -> (stage-A boxes [F,4],
    coeffs [F,6]) such that output pixel (x, y) samples patch coordinates
    px = a0*x + a1*y + a2, py = b0*x + b1*y + b2."""
    k = patch_size
    inv, boxes = source_windows(matrices, out_h, out_w, k)
    x1, y1, x2, y2 = boxes.unbind(1)
    sw = rdiv(k, (x2 - x1).clamp_min(1e-6))
    sh = rdiv(k, (y2 - y1).clamp_min(1e-6))
    coeffs = torch.stack(
        [
            inv[:, 0, 0] * sw,
            inv[:, 0, 1] * sw,
            (inv[:, 0, 2] + 0.5 - x1) * sw - 0.5,
            inv[:, 1, 0] * sh,
            inv[:, 1, 1] * sh,
            (inv[:, 1, 2] + 0.5 - y1) * sh - 0.5,
        ],
        dim=1,
    )
    return boxes, coeffs


def warp_geometry(
    matrices: torch.Tensor, out_h: int, out_w: int, patch_size: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stage-A/B geometry of the two-stage dense warp: forward maps [F,2,3]
    -> (stage-A boxes [F,4], px [F, out_h*out_w], py [F, out_h*out_w]), the
    patch coordinates each output pixel samples: crop_resize samples patch
    pixel i at src = x1 + bw*(i+0.5)/k - 0.5, so i = (src + 0.5 - x1)*k/bw
    - 0.5."""
    f = matrices.shape[0]
    k = patch_size
    inv, boxes = source_windows(matrices, out_h, out_w, k)
    x1, y1, x2, y2 = boxes.unbind(1)
    gx, gy = _grid(out_h, out_w, matrices.device)
    sx, sy = _source_coords(inv, gx, gy)
    sw = rdiv(k, (x2 - x1).clamp_min(1e-6))[:, None, None]
    sh = rdiv(k, (y2 - y1).clamp_min(1e-6))[:, None, None]
    px = ((sx + 0.5 - x1[:, None, None]) * sw - 0.5).reshape(f, -1)
    py = ((sy + 0.5 - y1[:, None, None]) * sh - 0.5).reshape(f, -1)
    return boxes, px, py


def _interp_matrix(
    starts: torch.Tensor, sizes: torch.Tensor, out_size: int, src_dim: int
) -> torch.Tensor:
    """Per-box 1-D bilinear interpolation matrices: starts/sizes [N] ->
    [N, out_size, src_dim], row o the weights max(0, 1 - |src(o) - p|) of
    output sample o over source pixels p (zero border included)."""
    return hat_weights(starts.float(), sizes.float(), out_size, src_dim)


# the JAX package's private name of the stage-A windows
_source_windows = source_windows


def _grid(out_h: int, out_w: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    ys = torch.arange(out_h, dtype=torch.float32, device=device)
    xs = torch.arange(out_w, dtype=torch.float32, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")  # [out_h, out_w]
    return gx, gy


def _source_coords(inv: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor):
    """Inverse maps [F,2,3] over an output grid -> source (sx, sy), each
    [F, out_h, out_w]: a0 * x + a1 * y + a2, in that order."""
    def row(r):
        return (inv[:, r, 0, None, None] * gx + inv[:, r, 1, None, None] * gy
                + inv[:, r, 2, None, None])
    return row(0), row(1)


def bilinear_sample(
    image: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor, border: str = "zero"
) -> torch.Tensor:
    """Bilinear-sample ONE image [H,W,C] at float coordinates sx, sy (any
    shape S) -> [*S, C] float32. border='zero' (cv2 BORDER_CONSTANT 0: a
    tap outside the image reads 0) or 'replicate' (cv2 BORDER_REPLICATE:
    taps clamp to the edge)."""
    if border not in ("zero", "replicate"):
        raise ValueError(f"border must be 'zero' or 'replicate', got {border!r}")
    h, w, c = image.shape
    flat = image.float().reshape(h * w, c)
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    wx = (sx - x0)[..., None]
    wy = (sy - y0)[..., None]
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)

    def tap(yi, xi):
        v = flat[(yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(-1)]
        v = v.reshape(*sx.shape, c)
        if border == "zero":
            inb = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
            v = v * inb[..., None].float()
        return v

    top = tap(y0i, x0i) * (1 - wx) + tap(y0i, x0i + 1) * wx
    bot = tap(y0i + 1, x0i) * (1 - wx) + tap(y0i + 1, x0i + 1) * wx
    return top * (1 - wy) + bot * wy


def warp_affine(
    images: torch.Tensor, matrices: torch.Tensor, out_h: int, out_w: int
) -> torch.Tensor:
    """Batched bilinear affine warp with a zero border: images [B,H,W,C],
    FORWARD maps [B,2,3] (src -> dst, the cv2.warpAffine convention) ->
    [B,out_h,out_w,C] float32; output pixel p samples M^-1 p."""
    gx, gy = _grid(out_h, out_w, images.device)
    sx, sy = _source_coords(invert_affine(matrices.float()), gx, gy)
    b, c = images.shape[0], images.shape[-1]
    if b == 0:
        return torch.zeros((0, out_h, out_w, c), device=images.device)
    return torch.stack([bilinear_sample(images[i], sx[i], sy[i]) for i in range(b)])


def warp_affine_single(
    image: torch.Tensor, matrices: torch.Tensor, out_h: int, out_w: int
) -> torch.Tensor:
    """F affine-warped crops of ONE image [H,W,C]: FORWARD maps [F,2,3] ->
    [F,out_h,out_w,C] float32 (zero border), without F image copies."""
    gx, gy = _grid(out_h, out_w, image.device)
    sx, sy = _source_coords(invert_affine(matrices.float()), gx, gy)
    return bilinear_sample(image, sx, sy)


def crop_resize_gather(
    image: torch.Tensor, boxes: torch.Tensor, out_size: int
) -> torch.Tensor:
    """Gather crop + resize of boxes [N,4] (x1, y1, x2, y2) from ONE image
    [H,W,C] -> [N,out,out,C] float32: half-pixel centres, zero border."""
    boxes = boxes.float()
    x1, y1, x2, y2 = boxes.unbind(1)
    bw = (x2 - x1).clamp_min(1e-6)
    bh = (y2 - y1).clamp_min(1e-6)
    t = (torch.arange(out_size, dtype=torch.float32, device=image.device) + 0.5) / out_size
    sx = x1[:, None, None] + bw[:, None, None] * t[None, None, :] - 0.5
    sy = y1[:, None, None] + bh[:, None, None] * t[None, :, None] - 0.5
    n = boxes.shape[0]
    sx = sx.expand(n, out_size, out_size)
    sy = sy.expand(n, out_size, out_size)
    return bilinear_sample(image, sx, sy)


def align_faces(
    image: torch.Tensor,
    landmarks: torch.Tensor,
    template: torch.Tensor,
    output_size: int = 112,
) -> torch.Tensor:
    """Align every face of ONE image [H,W,C] to the template: landmarks
    [F,5,2], template [5,2] -> [F,out,out,C] float32 (the vectorized
    reference `FaceAligner.align`; the host pipeline's path)."""
    mats = similarity_transform(landmarks, template)
    return warp_affine_single(image, mats, output_size, output_size)


def crop_resize(
    image: torch.Tensor,
    boxes: torch.Tensor,
    out_size: int,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Crop boxes [N,4] from ONE frame [H,W,C] and resize to
    [N,out,out,C] float32 (bilinear, half-pixel centres, zero outside).
    Plain PyTorch, the counterpart of the JAX package's XLA `crop_resize`
    (operands and rows in `compute_dtype`, float32 sums)."""
    return crop_resize_plain(image[None], boxes[None], out_size, compute_dtype)[0]


def align_faces_batch(
    images: torch.Tensor,
    landmarks: torch.Tensor,
    template: torch.Tensor,
    output_size: int = 112,
    patch_size: int = 128,
) -> torch.Tensor:
    """Whole-batch alignment, the counterpart of `align_faces_batch_pallas`:
    images [B,H,W,C] float32, landmarks [B,F,5,2] -> [B,F,out,out,C]
    float32. Stage A cuts a patch per face with K1 (`crop_resize_kernel`),
    stage B warps every patch with K2 (`warp_patches_kernel`)."""
    b, f = landmarks.shape[:2]
    mats = similarity_transform(landmarks.reshape(b * f, 5, 2), template)
    boxes, coeffs = warp_coeffs(mats, output_size, output_size, patch_size)
    patches = crop_resize_kernel(images, boxes.reshape(b, f, 4), patch_size)
    c = patches.shape[-1]
    out = warp_patches_kernel(
        patches.reshape(b * f, patch_size, patch_size, c),
        coeffs, output_size, output_size,
    )
    return out.reshape(b, f, output_size, output_size, c)


def warp_affine_single_matmul(
    image: torch.Tensor,
    matrices: torch.Tensor,
    out_h: int,
    out_w: int,
    patch_size: int = 128,
    compute_dtype: torch.dtype = torch.bfloat16,
    face_chunk: int = 8,
) -> torch.Tensor:
    """F affine-warped crops of ONE image [H,W,C] with dense contractions
    instead of gathers: FORWARD maps [F,2,3] -> [F,out_h,out_w,C] float32.

    A. each face's source window into a [patch, patch] patch with
       `crop_resize` (a lossless pixel copy when the face fits the patch);
    B. out[o,c] = sum_v Wy[o,v] sum_u Wx[o,u] P[v,u,c] with hat weights
       Wx, Wy rounded to `compute_dtype`, the inner sum rounded to it too
       and the outer one float32, `face_chunk` faces at a time."""
    c = image.shape[-1]
    f = matrices.shape[0]
    k = patch_size
    boxes, px, py = warp_geometry(matrices.float(), out_h, out_w, k)
    patches = crop_resize(image, boxes, k, compute_dtype=compute_dtype)
    pix = torch.arange(k, dtype=torch.float32, device=image.device)
    outs = []
    for s in range(0, f, max(1, face_chunk)):
        e = min(s + face_chunk, f)
        wx = round_to((1.0 - (px[s:e, :, None] - pix).abs()).clamp_min(0.0), compute_dtype)
        wy = round_to((1.0 - (py[s:e, :, None] - pix).abs()).clamp_min(0.0), compute_dtype)
        rows = round_to(
            torch.einsum("fou,fvuc->fovc", wx, round_to(patches[s:e], compute_dtype)),
            compute_dtype,
        )
        outs.append(torch.einsum("fov,fovc->foc", wy, rows))
    if not outs:
        return torch.zeros((0, out_h, out_w, c), device=image.device)
    return torch.cat(outs).reshape(f, out_h, out_w, c)


def align_faces_matmul(
    image: torch.Tensor,
    landmarks: torch.Tensor,
    template: torch.Tensor,
    output_size: int = 112,
    patch_size: int = 128,
    compute_dtype: torch.dtype = torch.bfloat16,
    face_chunk: int = 8,
) -> torch.Tensor:
    """`align_faces` through `warp_affine_single_matmul`: ONE image
    [H,W,C], landmarks [F,5,2] -> [F,out,out,C] float32."""
    mats = similarity_transform(landmarks, torch.as_tensor(template))
    return warp_affine_single_matmul(
        image, mats, output_size, output_size, patch_size=patch_size,
        compute_dtype=compute_dtype, face_chunk=face_chunk,
    )
