"""NMS's convergence loop on the device: kernel K5 and its plain version.

Counterpart of the `jax.lax.while_loop` of
`facerecognitionpipeline_tpu/ops/nms.py::nms_mask`, which stays on the TPU
inside the jitted step. The CUDA kernel is `csrc/nms_fixpoint.cu`: one
block per batch element packs the strictly lower-triangular conflict rows
into 32-bit words (in shared memory while they fit,
`nms_launch_geometry`), then runs the loop's sweeps with the keep masks in
shared memory and a block-wide "changed" flag. Bound on an H100 by the
bytes of the conflict mask, read once. With no host read of the
convergence flag, the serving step holds no host synchronisation and can
be captured into a CUDA graph (`pipeline/step_graph.py`).

`nms_fixpoint_plain` is the plain PyTorch loop: the seven unconditional
sweeps, then pairs of sweeps while `it < n` and the last check saw a
change, over the whole batch at once (a host read per check).
The kernel runs the same schedule per batch element and is bit-equal to
it on the conflict masks `nms_mask` builds: true only below the diagonal
(a higher-ranked j < i), the only entries the kernel reads.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from facerecognitionpipeline_tpu_torch.ops import cuda_build

LAUNCHES = cuda_build.LaunchCounter()

THREADS = 1024  # the kernel's block
PROLOGUE_SWEEPS = 7
_STATIC_SMEM_BYTES = 64  # the kernel's own flag, rounded up
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def row_words(i: int) -> int:
    """32-bit words of conflict row i in the triangular packing (bits j < i)."""
    return -(-i // 32)


def row_offset(i: int) -> int:
    """First word of row i in the packing: the sum of `row_words(t)` over
    t < i (the closed form the kernel computes)."""
    m = i + 30
    a = m // 32
    return 16 * a * (a - 1) + a * (m - 32 * a + 1)


class NmsGeometry(NamedTuple):
    """How one `frp_nms_fixpoint` launch is cut (see `csrc/nms_fixpoint.cu`)."""

    grid: int  # one block per batch element
    threads: int
    words: int  # 32-bit words of each keep mask (v, keep, prev, mid)
    row_words: int  # words of one element's packed conflict rows
    rows_in_smem: bool  # else a [grid, row_words] scratch buffer on the device
    smem_bytes: int  # dynamic


@functools.lru_cache(maxsize=64)
def nms_launch_geometry(b: int, n: int) -> NmsGeometry:
    """The launch geometry of K5 for a [b, n, n] conflict mask: the packed
    rows in shared memory when they fit beside the four keep masks, else in
    a device scratch buffer. Raises ValueError for what the kernel's 32-bit
    row indices or CUDA's grid do not hold."""
    if b < 1 or n < 1:
        raise ValueError("nms_fixpoint_kernel: batch and box count must be at least 1")
    if b > 2**31 - 1 or n >= 2**20:
        raise ValueError(f"nms_fixpoint_kernel: {b} x {n} boxes exceed the kernel's indices")
    words = row_words(n)
    tri = row_offset(n)
    masks = 4 * 4 * words
    limit = cuda_build.SMEM_LIMIT_BYTES - _STATIC_SMEM_BYTES
    in_smem = masks + 4 * tri <= limit
    if masks > limit:
        raise ValueError(
            f"nms_fixpoint_kernel: the keep masks of {n} boxes need {masks} bytes "
            f"of shared memory, over the {limit} a block may use"
        )
    return NmsGeometry(b, THREADS, words, tri, in_smem, masks + (4 * tri if in_smem else 0))


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


def nms_fixpoint_kernel(conflict: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """K5: conflict [..., N, N] bool, v [..., N] bool -> keep [..., N] bool,
    bit-equal to `nms_fixpoint_plain`.

    CUDA tensors launch the CUDA kernel on the current stream (and count the
    launch) without a host synchronisation; CPU tensors take
    `nms_fixpoint_plain`. Any other device raises."""
    if conflict.dim() < 2 or conflict.shape[-1] != conflict.shape[-2]:
        raise ValueError(f"expected conflict [..., N, N], got {tuple(conflict.shape)}")
    if v.shape != conflict.shape[:-1]:
        raise ValueError(
            f"expected v {tuple(conflict.shape[:-1])}, got {tuple(v.shape)}"
        )
    if conflict.device.type == "cpu":
        return nms_fixpoint_plain(conflict, v)
    if conflict.device.type != "cuda":
        raise ValueError(f"nms_fixpoint_kernel: unsupported device {conflict.device}")
    if conflict.dtype != torch.bool or v.dtype != torch.bool:
        raise TypeError("nms_fixpoint_kernel takes bool conflict and v")
    if v.device != conflict.device:
        raise ValueError("conflict and v must be on the same device")
    n = v.shape[-1]
    b = v.numel() // n if n else 0
    keep = torch.empty(v.shape, dtype=torch.bool, device=v.device)
    if keep.numel() == 0:
        return keep
    geo = nms_launch_geometry(b, n)
    conflict = conflict.reshape(b, n, n).contiguous()
    v = v.reshape(b, n).contiguous()
    scratch = None
    if not geo.rows_in_smem:
        scratch = torch.empty((b, geo.row_words), dtype=torch.int32, device=v.device)
    vec = int(n % 16 == 0 and conflict.data_ptr() % 16 == 0)
    fn = cuda_build.function("nms_fixpoint", "frp_nms_fixpoint", _ARGTYPES)
    with torch.cuda.device(v.device):  # the launch goes to the tensors' card
        rc = fn(
            conflict.data_ptr(), v.data_ptr(), keep.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            b, n, int(geo.rows_in_smem), vec, geo.smem_bytes,
            torch.cuda.current_stream(v.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"nms_fixpoint kernel launch failed (cudaError {rc})")
    LAUNCHES.bump()
    return keep
