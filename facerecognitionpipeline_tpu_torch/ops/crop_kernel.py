"""Batched bilinear crop+resize from shared frames: kernel K1 and its plain
version.

Replaces `facerecognitionpipeline_tpu/ops/pallas_crop.py::crop_resize_pallas`
(its `pl.pallas_call` in `_crop_resize_pallas`). The CUDA kernel is
`csrc/crop_resize.cu`: a 4-tap gather per output sample, bound by
device-memory bytes (one read of the float32 frames, one write of the
float32 crops; see the source note there for the design).

Semantics, shared by the kernel and `crop_resize_plain`: boxes (x1,y1,x2,y2)
in frame pixels, half-pixel centres, hat weights max(0, 1-|p-i|), zero
outside the frame. The frame and both hat weights are rounded to bf16; the
rows pass sums in float32 and ROUNDS TO BF16 (as the TPU kernel does, in
spite of its module docstring); the columns pass sums in float32.

The wrapper `crop_resize_kernel` launches the kernel for CUDA tensors and
takes the plain version only for CPU tensors. It is used three times per
serving step: R-net crops (k=24), O-net crops (k=48) and alignment stage A
(k=128).
"""

from __future__ import annotations

import ctypes

import torch

from facerecognitionpipeline_tpu_torch.ops import cuda_build
from facerecognitionpipeline_tpu_torch.ops.numerics import div, round_to

LAUNCHES = cuda_build.LaunchCounter()


def hat_weights(
    starts: torch.Tensor, sizes: torch.Tensor, out_size: int, src_dim: int
) -> torch.Tensor:
    """Per-box 1-D bilinear weights: starts/sizes [...] -> [..., out, src]
    with row o holding max(0, 1-|p(o)-i|) over source pixels i, where
    p(o) = start + size * (o + 0.5) / out - 0.5."""
    dev = starts.device
    t = div(torch.arange(out_size, dtype=torch.float32, device=dev) + 0.5, out_size)
    src = starts[..., None] + sizes[..., None] * t - 0.5
    pix = torch.arange(src_dim, dtype=torch.float32, device=dev)
    return (1.0 - (src[..., None] - pix).abs()).clamp_min(0.0)


def crop_resize_plain(
    images: torch.Tensor,
    boxes: torch.Tensor,
    out_size: int,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """images [B,H,W,C], boxes [B,N,4] -> [B,N,k,k,C] float32, as two dense
    float32 matmuls on operands rounded to `compute_dtype`, with the rows
    rounded to `compute_dtype` between them. With bf16 this is K1's plain
    version; the float32 form is the JAX package's `crop_resize` in f32.

    A hat row has at most two non-zero weights, and a product of two bf16
    values is exact in float32, so each matmul sum rounds once whatever the
    order: the plain version agrees with the kernel bit for bit."""
    b, h, w, c = images.shape
    n = boxes.shape[1]
    k = out_size
    boxes = boxes.float()
    x1, y1, x2, y2 = boxes.unbind(-1)
    bw = (x2 - x1).clamp_min(1e-6)
    bh = (y2 - y1).clamp_min(1e-6)
    my = round_to(hat_weights(y1, bh, k, h), compute_dtype)  # [B,N,k,H]
    mx = round_to(hat_weights(x1, bw, k, w), compute_dtype)  # [B,N,k,W]
    img = round_to(images.float(), compute_dtype).reshape(b, h, w * c)
    rows = torch.matmul(my.reshape(b, n * k, h), img)  # [B, N*k, W*C]
    rows = round_to(rows, compute_dtype).reshape(b * n, k, w, c)
    out = torch.einsum("nxw,nywc->nyxc", mx.reshape(b * n, k, w), rows)
    return out.reshape(b, n, k, k, c)


def crop_resize_kernel(
    images: torch.Tensor, boxes: torch.Tensor, out_size: int
) -> torch.Tensor:
    """K1: images [B,H,W,C] (or one frame [H,W,C]) float32, boxes [B,N,4]
    (or [N,4]) -> [B,N,k,k,C] (or [N,k,k,C]) float32.

    CUDA tensors launch the CUDA kernel (and count the launch); CPU tensors
    take `crop_resize_plain`. Any other device raises."""
    single = images.dim() == 3
    if single:
        images, boxes = images[None], boxes[None]
    if images.dim() != 4 or boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(
            f"expected images [B,H,W,C] and boxes [B,N,4], got "
            f"{tuple(images.shape)} and {tuple(boxes.shape)}"
        )
    if images.shape[0] != boxes.shape[0]:
        raise ValueError("images and boxes disagree on the batch size")
    if images.device.type == "cpu":
        out = crop_resize_plain(images, boxes, out_size)
    elif images.device.type == "cuda":
        out = _launch(images, boxes, out_size)
    else:
        raise ValueError(f"crop_resize_kernel: unsupported device {images.device}")
    return out[0] if single else out


def _launch(images: torch.Tensor, boxes: torch.Tensor, k: int) -> torch.Tensor:
    if images.dtype != torch.float32 or boxes.dtype != torch.float32:
        raise TypeError("crop_resize_kernel takes float32 images and boxes")
    if boxes.device != images.device:
        raise ValueError("images and boxes must be on the same device")
    b, h, w, c = images.shape
    n = boxes.shape[1]
    images = images.contiguous()
    boxes = boxes.contiguous()
    out = torch.empty((b, n, k, k, c), dtype=torch.float32, device=images.device)
    if out.numel() == 0:
        return out
    lib = cuda_build.load("crop_resize")
    fn = lib.frp_crop_resize
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(images.device).cuda_stream
    rc = fn(
        images.data_ptr(), boxes.data_ptr(), out.data_ptr(),
        b, h, w, c, n, k, stream,
    )
    if rc != 0:
        raise RuntimeError(f"crop_resize kernel launch failed (cudaError {rc})")
    LAUNCHES.bump()
    return out
