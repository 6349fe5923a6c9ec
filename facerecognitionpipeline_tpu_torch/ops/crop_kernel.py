"""Batched bilinear crop+resize from shared frames: kernel K1 and its plain
version.

Replaces `facerecognitionpipeline_tpu/ops/pallas_crop.py::crop_resize_pallas`
(its `pl.pallas_call` in `_crop_resize_pallas`). The CUDA kernel is
`csrc/crop_resize.cu`: a 4-tap gather per output sample, bound on an H100 by
device-memory bytes (one read of the float32 frames, one write of the
float32 crops), not by arithmetic, so the tensor cores have no part in it.
Its design keeps the instructions per byte low: a grid of (box, band of
output rows); the separable taps of a block computed once into shared-memory
tables (`K*C + rows` coordinate chains per block, not two per pixel); one
thread per output float with the lanes of a warp on consecutive floats, so
loads touch few cache lines and stores are contiguous; zero-weight taps not
loaded. `crop_launch_geometry` holds the launch arithmetic, where the CPU
tests reach it.

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
import functools
from typing import NamedTuple

import torch

from facerecognitionpipeline_tpu_torch.ops import cuda_build
from facerecognitionpipeline_tpu_torch.ops.numerics import div, round_to

LAUNCHES = cuda_build.LaunchCounter()

#: output floats one block aims at: enough to spread the tap tables' cost,
#: few enough that every serving call gives the 132 SMs many blocks each.
#: Timed on an H100 with bands of 4 to 48 rows: 24 rows at k=24, 16 at k=48
#: and 8 or 16 at k=128 were the fastest, which this value gives.
_BLOCK_FLOATS = 3072
_MAX_THREADS = 256  # the kernel's __launch_bounds__
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_void_p]


class CropGeometry(NamedTuple):
    """How one `frp_crop_resize` launch is cut (see `csrc/crop_resize.cu`)."""

    grid: tuple[int, int]  # (boxes, bands of output rows)
    band_rows: int  # output rows per band (the last band may hold fewer)
    threads: int  # per block
    smem_bytes: int  # the two tap tables, 16 bytes per entry


@functools.lru_cache(maxsize=64)
def crop_launch_geometry(
    b: int, n: int, h: int, w: int, c: int, k: int
) -> CropGeometry:
    """The launch geometry of K1 for frames [b,h,w,c], n boxes per frame and
    k x k crops. Raises ValueError for what the kernel's 32-bit offsets,
    CUDA's grid limits or a block's shared memory do not hold."""
    if min(b, n, h, w, c, k) < 1:
        raise ValueError("crop_resize_kernel: every dimension must be at least 1")
    kc = k * c
    if h * w * c >= 2**31 or k * kc >= 2**31 or b * n >= 2**31:
        raise ValueError(
            "crop_resize_kernel: a frame, a crop or the box count exceeds the "
            "kernel's 32-bit offsets (2**31 floats)"
        )
    bands = -(-k // max(1, _BLOCK_FLOATS // kc))
    band_rows = -(-k // bands)
    bands = -(-k // band_rows)
    if bands > 65535:
        raise ValueError(f"crop_resize_kernel: {bands} bands exceed CUDA's grid limit")
    threads = min(_MAX_THREADS, 32 * -(-band_rows * kc // 32))
    smem = 16 * (kc + band_rows)
    if smem > cuda_build.SMEM_LIMIT_BYTES:
        raise ValueError(
            f"crop_resize_kernel: the tap tables of a {k}x{k}x{c} crop need {smem} "
            f"bytes of shared memory, over the {cuda_build.SMEM_LIMIT_BYTES} a "
            f"block may use"
        )
    return CropGeometry((b * n, bands), band_rows, threads, smem)


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
    geo = crop_launch_geometry(b, n, h, w, c, k)
    fn = cuda_build.function("crop_resize", "frp_crop_resize", _ARGTYPES)
    with torch.cuda.device(images.device):  # the launch goes to the tensors' card
        rc = fn(
            images.data_ptr(), boxes.data_ptr(), out.data_ptr(),
            b, h, w, c, n, k, geo.band_rows, geo.threads, geo.smem_bytes,
            torch.cuda.current_stream(images.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"crop_resize kernel launch failed (cudaError {rc})")
    LAUNCHES.bump()
    return out
