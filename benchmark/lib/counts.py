"""Operations and bytes from shapes, and the chip's published peaks.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit): 989 TFLOP/s bf16, 1979 TOP/s int8, 67 TFLOP/s float32 outside the
tensor cores, 3.35 TB/s of HBM3.

`step_flops` counts the multiply-adds (x2) of every conv and dense layer
of one served step: the embedder on every one of the B x max_faces slots
and the cascade on B frames (P-net over each pyramid level, R-net on 256
and O-net on 96 candidates a frame), each with the peak of the type it
runs in. `kernel_bounds` gives the least time of each hand-written kernel
the step launches, the larger of its bytes over the memory rate and its
operations over its peak, counting each input byte read once and each
output byte written once.
"""

from __future__ import annotations

import math

from benchmark.reference.irse import STAGE_CHANNELS, units_of
from benchmark.reference.mtcnn import P_KEEP, R_KEEP, pyramid_scales

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
INT8_OPS_PER_S = 1979e12


def _conv(h, w, cin, cout, k, stride=1, pad=0):
    """(multiply-adds, out h, out w) of one conv."""
    ho = (h + 2 * pad - k) // stride + 1
    wo = (w + 2 * pad - k) // stride + 1
    return ho * wo * cin * cout * k * k, ho, wo


def embedder_macs(units, size: int = 112) -> tuple:
    """(multiply-adds of the two 3x3 convs of every unit, of the rest) of
    one face."""
    res = other = 0
    m, h, w = _conv(size, size, 3, 64, 3, 1, 1)
    other += m
    for _, cin, d, s in units_of(units):
        m, _, _ = _conv(h, w, cin, d, 3, 1, 1)
        res += m
        m, ho, wo = _conv(h, w, d, d, 3, s, 1)
        res += m
        if cin != d:
            other += _conv(h, w, cin, d, 1, s, 0)[0]
        h, w = ho, wo
    other += STAGE_CHANNELS[-1] * h * w * 512
    return res, other


def _pool_out(n, k, s):
    return -(-(n - k) // s) + 1


def cascade_macs(det_size, min_face: float) -> tuple:
    """(P-net multiply-adds of one frame, R-net and O-net ones of one
    frame): P-net over every pyramid level, R-net on P_KEEP and O-net on
    R_KEEP candidates."""
    h0, w0 = det_size
    p = 0
    for s in pyramid_scales(h0, w0, min_face):
        h, w = math.ceil(h0 * s), math.ceil(w0 * s)
        m, h, w = _conv(h, w, 3, 10, 3)
        p += m
        h, w = _pool_out(h, 2, 2), _pool_out(w, 2, 2)
        m, h, w = _conv(h, w, 10, 16, 3)
        p += m
        m, h, w = _conv(h, w, 16, 32, 3)
        p += m + h * w * 32 * 6
    r, h, w = _conv(24, 24, 3, 28, 3)
    h = w = _pool_out(h, 3, 2)
    m, h, w = _conv(h, w, 28, 48, 3)
    r += m
    h = w = _pool_out(h, 3, 2)
    m, h, w = _conv(h, w, 48, 64, 2)
    r += m + h * w * 64 * 128 + 128 * 6
    o, h, w = _conv(48, 48, 3, 32, 3)
    h = w = _pool_out(h, 3, 2)
    m, h, w = _conv(h, w, 32, 64, 3)
    o += m
    h = w = _pool_out(h, 3, 2)
    m, h, w = _conv(h, w, 64, 64, 3)
    o += m
    h = w = _pool_out(h, 2, 2)
    m, h, w = _conv(h, w, 64, 128, 2)
    o += m + h * w * 128 * 256 + 256 * 16
    return p, P_KEEP * r + R_KEEP * o


def step_least_s(cfg: dict, batch: int) -> float:
    """Least seconds one step of `batch` frames takes at the peaks."""
    int8 = cfg.get("quantize") == "int8"
    res, other = embedder_macs(cfg["units"])
    slots = batch * cfg["max_faces"]
    t = 2 * slots * res / (INT8_OPS_PER_S if int8 else BF16_FLOPS_PER_S)
    t += 2 * slots * other / BF16_FLOPS_PER_S
    p, ro = cascade_macs(cfg["det_size"], cfg["min_face_size"])
    t += 2 * batch * p / BF16_FLOPS_PER_S
    t += 2 * batch * ro / (INT8_OPS_PER_S if int8 else BF16_FLOPS_PER_S)
    return t


def kernel_bounds(cfg: dict, batch: int) -> dict:
    """{kernel: least seconds per step}: K1 crop_resize (R-net crops from
    the half-size frame, O-net crops, alignment stage A), K2 warp_patches,
    K5 nms_fixpoint (three NMS; their bytes only: the pairs they compare
    depend on the frames) and, with an int8 gallery at streaming scale, K4
    gallery_topk_int8."""
    h, w = cfg["det_size"]
    f = cfg["max_faces"]
    n_scales = len(pyramid_scales(h, w, cfg["min_face_size"]))
    half = max(h, w) // 2

    def crop(src, n, k):
        nbytes = 4 * (src + batch * n * 4 + batch * n * k * k * 3)
        return max(nbytes / HBM_BYTES_PER_S, batch * n * k * k * 3 * 12 / F32_FLOPS_PER_S)

    k1 = (crop(batch * half * half * 3, P_KEEP, 24) + crop(batch * h * w * 3, R_KEEP, 48)
          + crop(batch * h * w * 3, f, 128))
    out = batch * f * 112 * 112 * 3
    k2 = max(4 * (batch * f * 128 * 128 * 3 + batch * f * 6 + out) / HBM_BYTES_PER_S,
             out * 12 / F32_FLOPS_PER_S)
    k5 = sum(18 * batch * n for n in (128 * n_scales, P_KEEP, R_KEEP)) / HBM_BYTES_PER_S
    bounds = {"crop_resize": k1, "warp_patches": k2, "nms_fixpoint": k5}
    g = int(cfg["gallery_ids"])
    if cfg.get("gallery_quantize") == "int8" and g >= 32768:
        q = batch * f
        gp = -(-g // 4096) * 4096
        nbytes = 4 * q * 512 + gp * (512 + 4 + 1) + q * cfg["top_k"] * 8
        bounds["gallery_topk_int8"] = max(nbytes / HBM_BYTES_PER_S,
                                          2 * q * gp * 512 / INT8_OPS_PER_S)
    return bounds


# the kernels' names as the profiler reports them, by the names above
KERNEL_NAMES = {
    "crop_resize": ("crop_resize_kernel",),
    "warp_patches": ("warp_patches_kernel",),
    "nms_fixpoint": ("nms_fixpoint_kernel",),
    "gallery_topk_int8": ("stream_topk_kernel", "merge_topk_kernel", "merge_lists_kernel"),
}
