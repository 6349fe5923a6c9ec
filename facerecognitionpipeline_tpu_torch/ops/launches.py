"""The launch counters of the port's kernels (`ops/*_kernel.py`) and the
int8 products (`ops/int8_gemm.py`), read together by name."""

from __future__ import annotations

from typing import Dict

from facerecognitionpipeline_tpu_torch.ops import (
    crop_kernel,
    gallery_kernel,
    int8_gemm,
    nms_kernel,
    warp_kernel,
)


def kernel_counts() -> Dict[str, int]:
    """The launch counters of the port's kernels, by kernel."""
    return {
        "crop_resize": crop_kernel.LAUNCHES.count,
        "warp_patches": warp_kernel.LAUNCHES.count,
        "gallery_topk": gallery_kernel.LAUNCHES.count,
        "gallery_topk_int8": gallery_kernel.LAUNCHES_INT8.count,
        "gallery_topk_f32": gallery_kernel.LAUNCHES_F32.count,
        "nms_fixpoint": nms_kernel.LAUNCHES.count,
    }


def launch_counts() -> Dict[str, int]:
    """The kernels' launch counters and the int8 products, by name."""
    return {**kernel_counts(), "int8_products": int8_gemm.PRODUCTS.count}
