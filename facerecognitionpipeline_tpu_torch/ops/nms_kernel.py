"""NMS from score-sorted boxes on the device: kernel K5 and its plain version.

Counterpart of `facerecognitionpipeline_tpu/ops/nms.py::nms_mask`'s
`pairwise_iou`, conflict mask and `jax.lax.while_loop`, which XLA fuses into
one program on the TPU inside the jitted step. The CUDA kernel is
`csrc/nms_fixpoint.cu`: one thread-block cluster per frame
(`nms_launch_geometry`: 1 to 16 blocks), whose warps compute the conflict
bits of the valid boxes straight from the sorted boxes into a bit packing of
the triangle (`group_offset`) held in the shared memory of the block that
owns each band of rows (`band_bounds`), then run the loop's sweeps with the
cluster's keep masks exchanged through distributed shared memory, one
cluster barrier per sweep. Bound on an H100 by the IoUs' float32
operations, then by the chain of sweeps. No [B, N, N] tensor exists on the
card's path, and with no host read of the convergence flag the serving
step can be captured into a CUDA graph (`pipeline/step_graph.py`).

`nms_sorted_plain` is the plain PyTorch version: `pairwise_iou`, the
threshold and the below-diagonal mask as torch ops, then
`nms_fixpoint_plain`, the seven unconditional sweeps and pairs of sweeps
while `it < n` and the last check saw a change, over the whole batch at once
(a host read per check). The kernel rounds every step of the IoU as those
torch ops do and runs the same schedule per frame, so it is bit-equal to it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from facerecognitionpipeline_tpu_torch.ops import cuda_build

LAUNCHES = cuda_build.LaunchCounter()

PROLOGUE_SWEEPS = 7
MAX_CLUSTER = 16  # blocks of one frame; above 8 a non-portable cluster size
PAIRS_PER_BLOCK = 8192  # the IoUs a block should take before the cluster grows
# a block: 16 warps, so that two blocks share an SM and eight clusters of 16
# fit the card at once (of 1024 threads only seven do, on an H100 80GB HBM3)
THREADS = 512
_STATIC_SMEM_BYTES = 64  # the kernel's two flag slots, rounded up
_ARGTYPES = (
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_float] + [ctypes.c_int] * 3
    + [ctypes.c_longlong] + [ctypes.c_int] * 2 + [ctypes.c_void_p]
)


def group_offset(g: int) -> int:
    """Words of the conflict rows of 32-row groups 0 .. g - 1 in the kernel's
    packing: group h keeps words 0 .. h of its 32 rows (bits j < i) as
    [word][row], 32 (h + 1) words."""
    return 16 * g * (g + 1)


def band_bounds(n: int, c: int) -> tuple[int, ...]:
    """The c + 1 bounds of the bands of 32-row groups the c blocks of a
    frame's cluster own (block k: groups bounds[k] .. bounds[k + 1], keep
    words of the same numbers, rows 32 bounds[k] .. min(32 bounds[k + 1],
    n)): bound k is the first group whose groups before it hold at least
    k / c of the frame's packed words (`band_start` in the kernel)."""
    w = -(-n // 32)
    bounds = [0]
    for k in range(1, c):
        lo, hi = 0, w
        while lo < hi:
            mid = (lo + hi) // 2
            if mid * (mid + 1) * c >= k * w * (w + 1):
                hi = mid
            else:
                lo = mid + 1
        bounds.append(lo)
    bounds.append(w)
    return tuple(bounds)


def _pow2_at_least(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


class NmsGeometry(NamedTuple):
    """How one `frp_nms_fixpoint` launch is cut (see `csrc/nms_fixpoint.cu`)."""

    grid: int  # batch x cluster blocks
    cluster: int  # blocks of one frame
    threads: int
    words: int  # 32-bit words of each keep mask (v, keep, prev, spare)
    row_words: int  # words of one frame's packed conflict rows
    bands: tuple[int, ...]  # cluster + 1 bounds, in 32-row groups
    band_words: int  # the most packed words of one band
    rows_in_smem: bool  # else a [batch, row_words] scratch buffer on the device
    smem_bytes: int  # dynamic


def _smem_bytes(in_smem: bool, n: int, w: int, band_words: int) -> int:
    """`smem_bytes_for` of the kernel: with the rows in shared memory the
    boxes (16 n), the four keep masks (16 w), the areas (4 n rounded up to
    16 bytes) and the band's rows; else the masks alone."""
    masks = 16 * w
    if not in_smem:
        return masks
    return 16 * n + masks + 4 * (-(-n // 4) * 4) + 4 * band_words


@functools.lru_cache(maxsize=64)
def nms_launch_geometry(b: int, n: int) -> NmsGeometry:
    """The launch geometry of K5 for b frames of n sorted boxes: a cluster
    of the smallest power of two of blocks that gives each at most
    PAIRS_PER_BLOCK IoUs, at most 16 and at most half the keep words (so no
    band is one 32-row group against another's many); blocks of THREADS
    threads; the band's packed rows
    and the boxes in shared memory when they fit beside the keep masks,
    else in device memory. Raises ValueError for what the kernel's 32-bit
    row indices, CUDA's grid or a block's shared memory do not hold."""
    if b < 1 or n < 1:
        raise ValueError("nms_sorted_kernel: batch and box count must be at least 1")
    w = -(-n // 32)
    pairs = n * (n - 1) // 2
    c = min(_pow2_at_least(-(-pairs // PAIRS_PER_BLOCK)), MAX_CLUSTER,
            1 << (max(1, w // 2).bit_length() - 1))
    if b * c > 2**31 - 1 or n >= 2**20:
        raise ValueError(f"nms_sorted_kernel: {b} x {n} boxes exceed the kernel's indices")
    bounds = band_bounds(n, c)
    band_words = max(group_offset(hi) - group_offset(lo) for lo, hi in zip(bounds, bounds[1:]))
    limit = cuda_build.SMEM_LIMIT_BYTES - _STATIC_SMEM_BYTES
    in_smem = _smem_bytes(True, n, w, band_words) <= limit
    smem = _smem_bytes(in_smem, n, w, band_words)
    if smem > limit:
        raise ValueError(
            f"nms_sorted_kernel: the keep masks of {n} boxes need {smem} bytes "
            f"of shared memory, over the {limit} a block may use"
        )
    return NmsGeometry(b * c, c, THREADS, w, group_offset(w), bounds, band_words, in_smem,
                       smem)


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


def nms_fixpoint_plain(conflict: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """conflict [..., N, N] bool (conflict[i, j]: higher-ranked j < i
    suppresses i), v [..., N] bool -> keep [..., N] bool, the greedy NMS
    keep mask in the sorted order: seven sweeps `v & ~any_j(conflict[i, j]
    & keep[j])`, then pairs of sweeps while `it < n` and two checks apart
    the keep mask changed (the JAX package's `while_loop`). Reads the
    convergence flag on the host once per check."""
    n = v.shape[-1]

    def sweep(keep):
        return v & ~(conflict & keep[..., None, :]).any(dim=-1)

    keep = sweep(v)
    prev = v
    for _ in range(PROLOGUE_SWEEPS - 1):
        keep, prev = sweep(keep), keep
    it = PROLOGUE_SWEEPS
    while it < n and bool((keep != prev).any()):
        keep, prev = sweep(sweep(keep)), keep
        it += 2
    return keep


def nms_sorted_plain(
    boxes: torch.Tensor, v: torch.Tensor, iou_threshold: float, mode: str = "union"
) -> torch.Tensor:
    """boxes [..., N, 4] float, score-sorted; v [..., N] bool, sorted ->
    keep [..., N] bool in the sorted order: the conflict mask
    `(pairwise_iou > iou_threshold) & (j < i)` as torch ops, then
    `nms_fixpoint_plain`."""
    n = v.shape[-1]
    iou = pairwise_iou(boxes, mode=mode)
    idx = torch.arange(n, device=boxes.device)
    conflict = (iou > iou_threshold) & (idx[None, :] < idx[:, None])
    return nms_fixpoint_plain(conflict, v)


def nms_sorted_kernel(
    boxes: torch.Tensor, v: torch.Tensor, iou_threshold: float, mode: str = "union"
) -> torch.Tensor:
    """K5: boxes [..., N, 4] float32, v [..., N] bool, both score-sorted ->
    keep [..., N] bool, bit-equal to `nms_sorted_plain`.

    CUDA tensors launch the CUDA kernel on the current stream (and count the
    launch) without a host synchronisation; CPU tensors take
    `nms_sorted_plain`. Any other device raises."""
    if boxes.dim() < 2 or boxes.shape[-1] != 4:
        raise ValueError(f"expected boxes [..., N, 4], got {tuple(boxes.shape)}")
    if v.shape != boxes.shape[:-1]:
        raise ValueError(f"expected v {tuple(boxes.shape[:-1])}, got {tuple(v.shape)}")
    if boxes.device.type == "cpu":
        return nms_sorted_plain(boxes, v, iou_threshold, mode)
    if boxes.device.type != "cuda":
        raise ValueError(f"nms_sorted_kernel: unsupported device {boxes.device}")
    if boxes.dtype != torch.float32 or v.dtype != torch.bool:
        raise TypeError("nms_sorted_kernel takes float32 boxes and bool v")
    if v.device != boxes.device:
        raise ValueError("boxes and v must be on the same device")
    n = v.shape[-1]
    keep = torch.empty(v.shape, dtype=torch.bool, device=v.device)
    if keep.numel() == 0:
        return keep
    b = v.numel() // n
    geo = nms_launch_geometry(b, n)
    boxes = boxes.reshape(b, n, 4).contiguous()
    if boxes.data_ptr() % 16:  # a view off a 16-byte address: the kernel loads float4
        boxes = boxes.clone()
    v = v.reshape(b, n).contiguous()
    scratch = None
    if not geo.rows_in_smem:
        scratch = torch.empty((b, geo.row_words), dtype=torch.int32, device=v.device)
    fn = cuda_build.function("nms_fixpoint", "frp_nms_fixpoint", _ARGTYPES)
    with torch.cuda.device(v.device):  # the launch goes to the tensors' card
        rc = fn(
            boxes.data_ptr(), v.data_ptr(), keep.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            b, n, iou_threshold, int(mode == "min"), geo.cluster, geo.threads,
            geo.band_words, int(geo.rows_in_smem), geo.smem_bytes,
            torch.cuda.current_stream(v.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"nms_fixpoint kernel launch failed (cudaError {rc})")
    LAUNCHES.bump()
    return keep
