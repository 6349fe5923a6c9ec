"""Stage-B affine warp of face patches: kernel K2 and its plain version.

Replaces `facerecognitionpipeline_tpu/ops/pallas_warp.py::warp_patches_affine`
(its `pl.pallas_call` in `_warp_patches_affine`). The CUDA kernel is
`csrc/warp_patches.cu`: a 4-tap gather per output pixel, bound on an H100 by
device-memory bytes (one read of the float32 patches, one write of the
float32 faces), not by arithmetic, so the tensor cores have no part in it.
Its design: one face per block with the whole patch brought into shared
memory by Hopper's bulk asynchronous copy in 16 KB chunks (each patch byte
leaves device memory once, every tap is a shared-memory read, and pixels
start as soon as their chunks have arrived); coefficients read once per
block; one thread per output pixel; float4 stores through a per-warp staging
buffer. `warp_launch_geometry` holds the launch arithmetic, where the CPU
tests reach it; a patch too large for a block's shared memory, or one the
bulk copy cannot take (not 16-byte aligned, or not a multiple of 16 bytes
long), is refused.

Semantics, shared by the kernel and `warp_patches_plain`: patch coordinates
of output pixel (x, y) are px = a0*x + a1*y + a2, py = b0*x + b1*y + b2
(coefficients from `ops/warp.py::warp_coeffs`); rows = sum_u bf16(P) *
bf16(hat(px-u)) in float32 and KEPT float32; out = sum_v rows * hat(py-v)
with the column weights in float32. Taps outside the patch contribute
nothing. Used once per serving step (alignment stage B).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from facerecognitionpipeline_tpu_torch.ops import cuda_build

LAUNCHES = cuda_build.LaunchCounter()

_MAX_THREADS = 1024  # the kernel's __launch_bounds__
_BARRIER_BYTES = 256  # 32 mbarriers ahead of the patch
_CHUNK_FLOATS = 4096  # floats per bulk copy (16 KB)
_MAX_CHUNKS = 32  # one bit each in a thread's mask of arrived chunks
_STATIC_SMEM_BYTES = 64  # the kernel's own static shared memory, rounded up
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_void_p]


class WarpGeometry(NamedTuple):
    """How one `frp_warp_patches` launch is cut (see `csrc/warp_patches.cu`)."""

    grid: int  # one block per face
    threads: int  # per block, a multiple of 32
    vec: int  # 4: float4 stores through the warps' staging buffers; 1: direct
    # (always for the channel-planar output, whose stores are coalesced as
    # they are)
    chunks: int  # 16 KB pieces of one patch
    smem_bytes: int  # dynamic: barriers + patch + staging


@functools.lru_cache(maxsize=64)
def warp_launch_geometry(
    f: int, k: int, c: int, out_h: int, out_w: int, planar: bool = False
) -> WarpGeometry:
    """The launch geometry of K2 for f patches [k,k,c] warped to
    [out_h,out_w,c] (or channel-planar [c,out_h,out_w] with `planar`), with
    float4 stores where a face's float count allows them. Raises ValueError for a patch that does not fit a block's shared
    memory or whose byte count the bulk copy cannot take, and for what the
    kernel's 32-bit offsets do not hold."""
    if min(f, k, c, out_h, out_w) < 1:
        raise ValueError("warp_patches_kernel: every dimension must be at least 1")
    patch_floats = k * k * c
    face_floats = out_h * out_w * c
    if face_floats >= 2**31 or f * 6 >= 2**31:
        raise ValueError(
            "warp_patches_kernel: a face or the face count exceeds the kernel's "
            "32-bit offsets"
        )
    if patch_floats % 4:
        raise ValueError(
            f"warp_patches_kernel: a {k}x{k}x{c} float32 patch is {patch_floats * 4} "
            f"bytes; the kernel's bulk copy takes patches that are a multiple of "
            f"16 bytes long and start on a 16-byte address"
        )
    threads = min(_MAX_THREADS, 32 * -(-(out_h * out_w) // 32))
    chunks = -(-patch_floats // _CHUNK_FLOATS)
    base = _BARRIER_BYTES + 4 * patch_floats
    staging = threads * c * 4
    limit = cuda_build.SMEM_LIMIT_BYTES - _STATIC_SMEM_BYTES
    # float4 stores where they are possible and still fit
    vec = 4 if not planar and face_floats % 4 == 0 and base + staging <= limit else 1
    smem = base + (staging if vec == 4 else 0)
    if smem > limit or chunks > _MAX_CHUNKS:
        raise ValueError(
            f"warp_patches_kernel: a {k}x{k}x{c} float32 patch needs {smem} bytes "
            f"of shared memory in {chunks} chunks; a block may use {limit} bytes "
            f"and {_MAX_CHUNKS} chunks"
        )
    return WarpGeometry(f, threads, vec, chunks, smem)


#: faces per dense chunk of the plain version (bounds its [F,O,K,C] rows)
_PLAIN_CHUNK = 8


def _hat(p: torch.Tensor, k: int) -> torch.Tensor:
    """p [...] -> [..., k] weights max(0, 1-|p-i|) over i in [0, k)."""
    ids = torch.arange(k, dtype=torch.float32, device=p.device)
    return (1.0 - (p[..., None] - ids).abs()).clamp_min(0.0)


def _pixel_coords(coeffs: torch.Tensor, out_h: int, out_w: int):
    """coeffs [F,6] -> (px, py) [F, out_h*out_w], row-major pixels, each
    as (a0*x + a1*y) + a2 with separate float32 multiplies and adds."""
    dev = coeffs.device
    o = torch.arange(out_h * out_w, device=dev)
    x = (o % out_w).float()
    y = (o // out_w).float()
    c = coeffs.float()
    px = c[:, 0:1] * x + c[:, 1:2] * y + c[:, 2:3]
    py = c[:, 3:4] * x + c[:, 4:5] * y + c[:, 5:6]
    return px, py


def warp_patches_plain(
    patches: torch.Tensor, coeffs: torch.Tensor, out_h: int, out_w: int,
    planar: bool = False,
) -> torch.Tensor:
    """patches [F,K,K,C], coeffs [F,6] -> [F,out_h,out_w,C] float32 (or
    [F,C,out_h,out_w] with `planar`), as a dense float32 matmul on
    bf16-rounded operands (rows, kept float32) and a multiply-then-sum over
    v. Each rows sum has at most two non-zero exact products, so it agrees
    with the kernel to the bit; the column sum rounds each product first,
    as the kernel does."""
    f, k, _, c = patches.shape
    px, py = _pixel_coords(coeffs, out_h, out_w)
    p16 = patches.float().to(torch.bfloat16).float()
    outs = []
    for s in range(0, f, _PLAIN_CHUNK):
        e = min(f, s + _PLAIN_CHUNK)
        wu = _hat(px[s:e], k).to(torch.bfloat16).float()  # [f,O,K(u)]
        wy = _hat(py[s:e], k)  # [f,O,K(v)]
        # rows[f, o, v, c] = sum_u wu[f, o, u] P[f, v, u, c]
        rows = torch.einsum("fou,fvuc->fovc", wu, p16[s:e])
        outs.append((rows * wy[..., None]).sum(dim=2))
    out = torch.cat(outs) if outs else patches.new_zeros((0, out_h * out_w, c))
    out = out.reshape(f, out_h, out_w, c)
    return out.permute(0, 3, 1, 2).contiguous() if planar else out


def warp_patches_kernel(
    patches: torch.Tensor, coeffs: torch.Tensor, out_h: int, out_w: int,
    planar: bool = False,
) -> torch.Tensor:
    """K2: patches [F,K,K,C] float32, coeffs [F,6] float32 ->
    [F,out_h,out_w,C] float32, or with `planar` the channel-planar
    [F,C,out_h,out_w] that `warp_patches_affine(planar=True)` returns.

    CUDA tensors launch the CUDA kernel (and count the launch); CPU tensors
    take `warp_patches_plain`. Any other device raises, and so does a patch
    on the card that is too large for a block's shared memory, or not
    16-byte aligned, or not a multiple of 16 bytes long."""
    if patches.dim() != 4 or patches.shape[1] != patches.shape[2]:
        raise ValueError(f"expected square patches [F,K,K,C], got {tuple(patches.shape)}")
    if coeffs.shape != (patches.shape[0], 6):
        raise ValueError(f"expected coeffs [F,6], got {tuple(coeffs.shape)}")
    if patches.device.type == "cpu":
        return warp_patches_plain(patches, coeffs, out_h, out_w, planar)
    if patches.device.type != "cuda":
        raise ValueError(f"warp_patches_kernel: unsupported device {patches.device}")
    if patches.dtype != torch.float32 or coeffs.dtype != torch.float32:
        raise TypeError("warp_patches_kernel takes float32 patches and coeffs")
    if coeffs.device != patches.device:
        raise ValueError("patches and coeffs must be on the same device")
    f, k, _, c = patches.shape
    patches = patches.contiguous()
    coeffs = coeffs.contiguous()
    shape = (f, c, out_h, out_w) if planar else (f, out_h, out_w, c)
    out = torch.empty(shape, dtype=torch.float32, device=patches.device)
    if out.numel() == 0:
        return out
    geo = warp_launch_geometry(f, k, c, out_h, out_w, planar)
    if patches.data_ptr() % 16:
        raise ValueError(
            "warp_patches_kernel: the kernel's bulk copy takes patches that "
            "start on a 16-byte address (copy the view into a tensor of its own)"
        )
    fn = cuda_build.function("warp_patches", "frp_warp_patches", _ARGTYPES)
    with torch.cuda.device(patches.device):  # the launch goes to the tensors' card
        rc = fn(
            patches.data_ptr(), coeffs.data_ptr(), out.data_ptr(),
            f, k, c, out_h, out_w, geo.threads, geo.vec, int(planar), geo.smem_bytes,
            torch.cuda.current_stream(patches.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"warp_patches kernel launch failed (cudaError {rc})")
    LAUNCHES.bump()
    return out
