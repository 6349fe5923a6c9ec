#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py                # needs one CUDA card

Phases, in order; any failure exits non-zero before the final line:
  1. build the CUDA kernels (K1 crop_resize, K2 warp_patches, K3
     gallery_topk, K4 gallery_topk_int8, K3 on float32 rows
     gallery_topk_f32) with nvcc, all at once, and print what the assembler
     reports (registers, spills) for every list length;
  2. hold each kernel against its plain PyTorch version on the card, at the
     shapes the serving step gives it, and time kernel, plain version and a
     PyTorch yardstick (F.grid_sample; matmul + topk with the similarity
     matrix stored) beside the kernel's bound. K1 and K2 must equal their
     plain versions to the bit, there and at odd shapes (channel counts,
     non-square frames, boxes off the frame, rotations to 90 degrees, more
     faces than SMs; a patch too large for shared memory, off a 16-byte
     address or not a multiple of 16 bytes long is refused); their
     device time alone is read from torch.profiler, warm and with the L2
     cache flushed, beside the host's cost of one wrapper call. K3 and K4
     run at 128 queries x 1 048 576 gallery rows (K3 also at 64 queries),
     at one small shape and at odd ones (query counts around the tile sizes,
     a gallery that ends inside a tile, depths that end inside a K-panel,
     top_k 1 and 8, no valid row, a gallery view off a 16-byte address
     refused); the device time of their stream and merge kernels alone and
     of the query preparation around them is read from torch.profiler. K3
     on float32 rows at 128 x 1 048 576 x 512 within 1e-5 of its plain
     version, timed beside its bound (operations on CUDA cores) and a stored
     float32 matmul + topk; K3 (bf16 and float32 rows) and K4 at top_k 16,
     33 and 64 against their plain versions, with the ring each list length
     leaves;
  3. the fused serving step at the server's build: ir_101 (seeded random
     weights), bf16, det_size 640x640, 16 face slots, min face 40, top-3,
     a 1024-row float32 gallery (dense match), B=8 frames composed from the
     in-repo smoke fixture. Checks detection recall against the fixture's
     ground truth, planted gallery matches, finite outputs, and that every
     step launched K1 three times and K2 once; times the step, and reads
     K1's and K2's device time inside the step from torch.profiler;
  4. 16 requests from two client threads through DeviceBatcher, each held
     against the direct step on the same frame;
  5. the same step against a DeviceGallery of 1 048 576 identities, once
     bf16 (K3) and once quantize='int8' (K4), gallery_impl='auto': planted
     rows come back top-1 and every step launched its streaming kernel
     once; one embed_budget=4 step on the int8 gallery;
  6. requests through DeviceBatcher with a GalleryManager (add, save, load)
     as the gallery provider;
  7. the HTTP server on the card, at the same build (ir_101 bf16, 640x640,
     16 face slots, batch_max 8, buckets (1, 8)), made by
     FaceRecognitionServer's constructor and served on 127.0.0.1: students
     enrolled through a GalleryManager file and POST /reload_gallery, then
     the port's own client over all three transports (base64 PNG to
     /process_frame, raw rgb24 and raw I420 to /process_frame_raw, the last
     against a server built with transport='i420'), each from one client
     (200 requests) and from four client threads at once (100 each). Every
     answer is held against a direct step of the server's engine on the
     same frame (face count, boxes within
     1 px, the enrolled students and no others, attendance.json), the launch
     counts against the steps dispatched (K1 x3, K2 x1 per step; fewer steps
     than requests under four clients), /stats against torch.cuda, bad
     requests against their 400s on a kept-alive connection. Then one server
     per compact gallery of 1 048 576 identities, each loading one
     GalleryManager file through its constructor's gallery_path (bf16: K3
     once per step; gallery_quantize='int8': K4 once per step), 120 requests
     from one client and 60 each from four. Prints request latency
     p50/p95 as the client saw it, requests per second, steps dispatched and
     frames per step, the server monitor's own p50, the share of a request
     that is not the device step, the host stages timed alone, and the host
     cost of GalleryManager.device_snapshot;
  8. the int8 tier at the same build: MTCNNDetector(quantize='int8') and
     FaceEmbedder(quantize='int8') calibrated on their synthetic defaults.
     The int8 product (im2col + cuBLASLt s8 x s8 -> s32) at every distinct
     int8 layer shape of the step and at odd ones (fewer than 17 rows,
     K = 27, N = 28) equals its plain version (float64 sums) to the bit,
     timed apart from its im2col beside a bf16 cuDNN conv of the same shape
     and the bound by operations; the int8 step: recall, planted rows
     top-1, K1 x3 and K2 x1 per step, identical embeddings with the plain
     product, cosine against the bf16 embeddings of the same faces, p50,
     device time, embed and detect alone beside the bf16 step's; the int8
     step against 1 048 576 int8 rows (K4 once per step); one server built
     with quantize='int8' serving 200 raw rgb24 requests, every answer held
     against its direct int8 step;
  9. enrolment and offline matching with the weight formats users have:
     seeded ir_101 weights written as an AdaFace Lightning .ckpt (the port's
     save_adaface_checkpoint) and a JAX-format .npz, seeded iresnet_100
     weights as an ArcFace .onnx (an initializer-only protobuf written
     here); 8 students x 4 photos rendered with render_identity_scene (each
     checked through a bf16 FaceProcessor, K1 twice per image, timed as
     images per second), enrolled through cli/enroll_students on the card
     from the .ckpt and from the .npz (the two galleries within 1e-5);
     face_matcher --single_image and FaceMatcher.match_single_image return
     each student top-1 at confidence > 0.99; the .onnx embedder on the card
     against the CPU; FaceMatcher.match_faces_batch against 1 048 576
     identities, bf16 (K3) then int8 (K4), at top_k 5, 16 and 64: enrolled
     students top-1, one launch per search, answers equal to the plain
     version on the same compact rows; the step with gallery_impl=
     'streaming' on a float32 gallery launches K3 on float32 rows once per
     step and equals the dense step.
  10. the offline dataset and evaluation path: a classroom dataset of 48
     enrolled identities (a one-shot photo, 5 few-shot photos and 4 session
     photos each) and 48 visitors (one photo each), 528 renders of
     render_identity_scene; seeded ir_101 weights (.npz), the bf16 cascade
     with pretrained/mtcnn_synthetic.npz; through the CLIs with --device
     cuda: dataset_preprocessor (K1 twice per photo; images/s),
     lfw_impostor_helper and segment_dataset over the reviewed labels,
     embedding_generator (all seven corpus pickles with their JSON twins and
     generation_summary.json; K1 twice per gallery photo), probe_labeler
     against the 48 students (dense, against a float32 product), then
     ProbeLabeler against 1 048 576 identities, bf16 (K3) and int8 (K4), one
     launch per search, labels and top matches equal to the plain version on
     the same compact rows; evaluate_models (its files, thresholds 0.20-0.90,
     max/mean/topk), and evaluate_model on the card against the CPU (scores
     within 1e-5; counts and rates differ only by decisions within 1e-5 of a
     threshold or a rival); identity_scores_batch alone at 4096 probes x
     10 000 identities x 5 x 512 within 1e-5 of float64, timed beside its
     bound; run_stress_suite over 4 categories with a bf16 cascade (K1).
     `python3 chip_smoke.py --offline-only` builds the kernels and runs this
     phase alone.
Then it prints the card's name and power limit, JSON lines of phase 8's, 9's
and 10's numbers, a JSON line describing the kernels, and as its last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet), used for the kernels' bounds.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12  # CUDA cores
BF16_FLOPS_PER_S = 989e12  # tensor cores, dense
INT8_OPS_PER_S = 1979e12  # tensor cores, dense

DEVICE = "cuda"
ARCH = "ir_101"
DET_SIZE = (640, 640)
MAX_FACES = 16
BATCH = 8
GALLERY_ROWS = 1024
STEP_ITERS = 12
BIG_GALLERY_ROWS = 1 << 20
BIG_STEP_ITERS = 6
STREAM_CHUNK = 4096
K3_TOL = 2e-5  # two-part bf16 query split, float32 sums in another order


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_time_ms(fn, match: str, iters: int = 10, flush=None):
    """Device time per call of `fn` spent in kernels whose name contains
    `match`, from torch.profiler (None where the profiler saw none). With
    `flush`, that runs before every call to evict the L2 cache; its own
    kernels do not match and are not counted."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            if flush is not None:
                flush()
            fn()
        torch.cuda.synchronize()
    us = sum(
        e.self_device_time_total for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and match in e.key
    )
    return us / iters / 1e3 if us > 0 else None


def host_enqueue_ms(fn, iters: int = 50) -> float:
    """Host-clock time of one call of `fn` with no synchronisation inside
    the loop: what the wrapper costs the host to enqueue its launch."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = 1e3 * (time.perf_counter() - t0) / iters
    torch.cuda.synchronize()
    return ms


def resampler_times(kernel, library, plain, kernel_name: str, plain_iters: int,
                    flush) -> dict:
    """Times of one resampler call shape: kernel, library call and kernel
    again in turns (CUDA events over 20 back-to-back calls, inputs warm in
    L2 where they fit), the kernel's device time alone warm and with the
    L2 cache evicted by `flush` before every launch, and the host's enqueue
    cost."""
    ms = cuda_time_ms(kernel)
    library_ms = cuda_time_ms(library)
    return {
        "ms": ms, "library_ms": library_ms, "ms_again": cuda_time_ms(kernel),
        "plain_ms": cuda_time_ms(plain, iters=plain_iters),
        "device_ms": device_time_ms(kernel, kernel_name),
        "cold_device_ms": device_time_ms(kernel, kernel_name, flush=flush),
        "library_device_ms": device_time_ms(library, "grid_sampler"),
        "host_ms": host_enqueue_ms(kernel),
    }


def mosaics(fixture: dict, n: int):
    """n 640x640 frames, each a 4x4 mosaic of the 16 fixture tiles (rolled
    by the frame index), with their ground-truth boxes."""
    import numpy as np

    tiles, boxes, counts = fixture["tiles"], fixture["boxes"], fixture["counts"]
    t = tiles.shape[1]
    frames = np.zeros((n, 4 * t, 4 * t, 3), np.uint8)
    gts = []
    for f in range(n):
        gt = []
        for p in range(16):
            i = (p + f) % 16
            r, c = divmod(p, 4)
            frames[f, r * t:(r + 1) * t, c * t:(c + 1) * t] = tiles[i]
            off = np.array([c * t, r * t, c * t, r * t], np.float32)
            gt.extend(boxes[i, j] + off for j in range(counts[i]))
        gts.append(np.array(gt, np.float32))
    return frames, gts


def iou(a, b):
    import numpy as np

    x1 = np.maximum(a[0], b[:, 0])
    y1 = np.maximum(a[1], b[:, 1])
    x2 = np.minimum(a[2], b[:, 2])
    y2 = np.minimum(a[3], b[:, 3])
    inter = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
    area = lambda z: (z[..., 2] - z[..., 0]) * (z[..., 3] - z[..., 1])  # noqa: E731
    return inter / (area(a) + area(b) - inter)


def detection_recall(out, gts):
    """Recall of a step's detections against the fixture's ground truth at
    IoU >= 0.5: (recall, hits, faces)."""
    valid = out["face_valid"].cpu().numpy()
    boxes = out["bboxes"].cpu().numpy()
    hits = total = 0
    for f in range(len(gts)):
        pb = boxes[f][valid[f]]
        for gt in gts[f]:
            total += 1
            hits += bool(len(pb)) and float(iou(gt, pb).max()) >= 0.5
    return hits / total, hits, total


def grid_for_boxes(boxes, k, h, w):
    """F.grid_sample grid [B, N*k, k, 2] sampling each box like K1."""
    import torch

    t = (torch.arange(k, device=boxes.device, dtype=torch.float32) + 0.5) / k
    x1, y1, x2, y2 = boxes.unbind(-1)
    px = x1[..., None] + (x2 - x1)[..., None] * t - 0.5  # [B,N,k]
    py = y1[..., None] + (y2 - y1)[..., None] * t - 0.5
    gx = (px + 0.5) / w * 2 - 1
    gy = (py + 0.5) / h * 2 - 1
    b, n = boxes.shape[:2]
    grid = torch.stack(
        [gx[:, :, None, :].expand(b, n, k, k), gy[:, :, :, None].expand(b, n, k, k)],
        dim=-1,
    )
    return grid.reshape(b, n * k, k, 2)


def grid_for_coeffs(coeffs, k, oh, ow):
    """F.grid_sample grid [F, oh, ow, 2] sampling each patch like K2."""
    import torch

    from facerecognitionpipeline_tpu_torch.ops.warp_kernel import _pixel_coords

    px, py = _pixel_coords(coeffs, oh, ow)
    gx = (px + 0.5) / k * 2 - 1
    gy = (py + 0.5) / k * 2 - 1
    return torch.stack([gx, gy], dim=-1).reshape(-1, oh, ow, 2)


def kernel_phase(fixture) -> dict:
    """Phase 2: kernels vs plain versions at the serving step's shapes (held
    to max |kernel - plain| = 0) and at odd shapes."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from facerecognitionpipeline_tpu_torch.ops.crop_kernel import (
        crop_resize_kernel,
        crop_resize_plain,
    )
    from facerecognitionpipeline_tpu_torch.ops.warp import (
        reference_template,
        similarity_transform,
        warp_coeffs,
    )
    from facerecognitionpipeline_tpu_torch.ops.warp_kernel import (
        warp_patches_kernel,
        warp_patches_plain,
    )

    dev = torch.device(DEVICE)
    g = torch.Generator(device="cpu").manual_seed(0)
    frames_u8, _ = mosaics(fixture, BATCH)
    frames = torch.from_numpy(frames_u8).to(dev).float()  # raw 0..255
    img = (frames - 127.5) / 128.0  # the cascade's normalized frame
    h, w = DET_SIZE

    def rand_boxes(n, size_lo, size_hi, extent):
        side = size_lo + (size_hi - size_lo) * torch.rand((BATCH, n), generator=g)
        x1 = -8 + (extent - side + 16) * torch.rand((BATCH, n), generator=g)
        y1 = -8 + (extent - side + 16) * torch.rand((BATCH, n), generator=g)
        return torch.stack([x1, y1, x1 + side, y1 + side], -1).to(dev)

    # alignment stage A: integer-snapped windows from the fixture's faces
    lm = np.zeros((BATCH, MAX_FACES, 5, 2), np.float32)
    for f in range(BATCH):
        for p in range(16):
            i = (p + f) % 16
            r, c = divmod(p, 4)
            lm[f, p] = fixture["landmarks"][i, 0] + np.array([c * 160, r * 160])
    mats = similarity_transform(
        torch.from_numpy(lm).to(dev).reshape(-1, 5, 2),
        torch.from_numpy(reference_template(112)).to(dev),
    )
    align_boxes, coeffs = warp_coeffs(mats, 112, 112, 128)

    small = crop_resize_plain(
        img, img.new_tensor([0.0, 0.0, w, h]).expand(BATCH, 1, 4), h // 2
    )[:, 0].contiguous()
    k1_cases = [
        # (label, frames, boxes, k, tolerance)
        ("rnet k=24", small, rand_boxes(256, 12.0, 160.0, h // 2), 24, 0.0),
        ("onet k=48", img, rand_boxes(96, 24.0, 320.0, h), 48, 0.0),
        ("align_a k=128", frames, align_boxes.reshape(BATCH, MAX_FACES, 4), 128, 0.0),
    ]
    report = {"crop_resize": [], "warp_patches": []}
    patches = None
    # five times the 50 MB L2: reading and writing it evicts what was there
    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    flush = lambda: flush_buf.add_(1)  # noqa: E731
    for label, src, boxes, k, tol in k1_cases:
        out = crop_resize_kernel(src, boxes, k)
        ref = crop_resize_plain(src, boxes, k)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        print(f"[kernels] K1 crop_resize {label}: frames {tuple(src.shape)} boxes "
              f"{tuple(boxes.shape)} max|kernel-plain| {err:.3g} (tol {tol:g})")
        if not err <= tol or not torch.isfinite(out).all():
            fail(f"K1 {label} disagrees with its plain version: {err}")
        if label.startswith("align_a"):
            patches = out.reshape(-1, 128, 128, 3)
        hh, ww = src.shape[1:3]
        nbytes = 4 * (src.numel() + boxes.numel() + out.numel())
        flops = out.numel() * 12  # 2 columns x (2 row taps x mul+add, mul+add)
        src_nchw = src.permute(0, 3, 1, 2).contiguous()
        grid = grid_for_boxes(boxes, k, hh, ww)
        report["crop_resize"].append({
            "shape": label, "err": err,
            **resampler_times(
                lambda: crop_resize_kernel(src, boxes, k),
                lambda: F.grid_sample(src_nchw, grid, align_corners=False),
                lambda: crop_resize_plain(src, boxes, k),
                "crop_resize", plain_iters=5, flush=flush,
            ),
            "bytes": nbytes, "flops": flops, "peak": F32_FLOPS_PER_S,
        })

    tol = 0.0  # every sum has at most two exact products: equal to the bit
    out = warp_patches_kernel(patches, coeffs, 112, 112)
    ref = warp_patches_plain(patches, coeffs, 112, 112)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    print(f"[kernels] K2 warp_patches: patches {tuple(patches.shape)} coeffs "
          f"{tuple(coeffs.shape)} max|kernel-plain| {err:.3g} (tol {tol:g})")
    if not err <= tol or not torch.isfinite(out).all():
        fail(f"K2 disagrees with its plain version: {err}")
    p_nchw = patches.permute(0, 3, 1, 2).contiguous()
    grid = grid_for_coeffs(coeffs, 128, 112, 112)
    report["warp_patches"].append({
        "shape": "align_b 128->112", "err": err,
        **resampler_times(
            lambda: warp_patches_kernel(patches, coeffs, 112, 112),
            lambda: F.grid_sample(p_nchw, grid, align_corners=False),
            lambda: warp_patches_plain(patches, coeffs, 112, 112),
            "warp_patches", plain_iters=3, flush=flush,
        ),
        "bytes": 4 * (patches.numel() + coeffs.numel() + out.numel()),
        "flops": out.numel() * 12, "peak": F32_FLOPS_PER_S,
    })
    print_bounds(report, "F.grid_sample")
    odd_shape_phase()
    return report


def rotation_coeffs(n: int, k: int, out: int, max_deg: float, g, shift: float = 0.0):
    """[n,6] coefficients that rotate an out x out face about the centre of
    a k x k patch by angles spread over [-max_deg, max_deg], scaled so the
    face covers most of the patch, and moved by `shift` patch pixels."""
    import math

    import torch

    th = torch.linspace(-max_deg, max_deg, n) * (math.pi / 180.0)
    sc = (k / out) * (0.8 + 0.2 * torch.rand(n, generator=g))
    a0, a1 = sc * torch.cos(th), -sc * torch.sin(th)
    b0, b1 = sc * torch.sin(th), sc * torch.cos(th)
    mid = (out - 1) / 2.0
    a2 = (k - 1) / 2.0 - (a0 + a1) * mid + shift
    b2 = (k - 1) / 2.0 - (b0 + b1) * mid + shift
    return torch.stack([a0, a1, a2, b0, b1, b2], dim=1).float()


def odd_shape_phase() -> None:
    """Phase 2, the shapes the serving step does not use: every one must
    equal its plain version to the bit (K2's shapes take both of its store
    paths), and K2 must refuse the patches its bulk copy cannot take."""
    import torch

    from facerecognitionpipeline_tpu_torch.ops.crop_kernel import (
        crop_resize_kernel,
        crop_resize_plain,
    )
    from facerecognitionpipeline_tpu_torch.ops.warp_kernel import (
        warp_patches_kernel,
        warp_patches_plain,
    )

    dev = torch.device(DEVICE)
    g = torch.Generator(device="cpu").manual_seed(3)

    def frames(b, h, w, c):
        return (255 * torch.rand((b, h, w, c), generator=g)).to(dev)

    def boxes(b, n, h, w):
        x1 = -6 + (w - 2) * torch.rand((b, n), generator=g)
        y1 = -6 + (h - 2) * torch.rand((b, n), generator=g)
        bw = 3 + w * torch.rand((b, n), generator=g)
        bh = 3 + h * torch.rand((b, n), generator=g)
        return torch.stack([x1, y1, x1 + bw, y1 + bh], -1).to(dev)

    edge = torch.tensor([[
        [-50.0, -50.0, -10.0, -10.0],  # wholly outside, up and left
        [70.0, 10.0, 90.0, 30.0],  # wholly outside, to the right
        [-7.5, -3.25, 20.0, 18.0],  # hangs over two edges
        [40.0, 30.0, 70.5, 55.0],  # hangs over the other two
        [30.0, 20.0, 10.0, 5.0],  # degenerate: x2 < x1, y2 < y1
        [-1e30, -1e30, 1e30, 1e30],  # far larger than the frame
        [8.0, 4.0, 32.0, 28.0],  # an integer 24-pixel window
    ]]).to(dev)
    k1_cases = [
        ("k=7 C=3, 33x45 frames", frames(2, 33, 45, 3), None, 7),
        ("C=1", frames(2, 40, 56, 1), None, 12),
        ("C=4", frames(1, 24, 31, 4), None, 8),
        ("N=1", frames(3, 64, 64, 3), 1, 24),
        ("boxes outside, degenerate, integer window", frames(1, 48, 64, 3), edge, 24),
    ]
    for label, src, bx, k in k1_cases:
        b, h, w, c = src.shape
        if bx is None or isinstance(bx, int):
            bx = boxes(b, bx or 5, h, w)
        ref = crop_resize_plain(src, bx, k)
        out = crop_resize_kernel(src, bx, k)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        if err != 0.0 or not torch.isfinite(out).all():
            fail(f"K1 odd shape '{label}': max|kernel-plain| {err}")
        if bx is edge:  # the integer window is a pixel copy of bf16(frame)
            want = src[0, 4:28, 8:32].to(torch.bfloat16).float()
            if not torch.equal(out[0, 6], want) or float(out[0, :2].abs().max()) != 0.0:
                fail("K1: the integer window is not a copy, or an outside box is not 0")
    print(f"[kernels] K1 crop_resize: {len(k1_cases)} odd shapes equal their plain "
          f"version to the bit")

    def patches(f, k, c):
        return (255 * torch.rand((f, k, k, c), generator=g)).to(dev)

    unaligned = torch.empty(2 * 16 * 16 * 3 + 1, device=dev)
    unaligned[1:] = patches(2, 16, 3).reshape(-1)
    k2_cases = [
        # (label, patches, coeffs, out size)
        ("128->112, rotations to 90 deg", patches(16, 128, 3),
         rotation_coeffs(16, 128, 112, 90.0, g), 112),
        ("128->112, pixels outside the patch", patches(8, 128, 3),
         rotation_coeffs(8, 128, 112, 30.0, g, shift=-40.0), 112),
        ("K=64", patches(4, 64, 3), rotation_coeffs(4, 64, 112, 20.0, g), 112),
        ("F=1", patches(1, 128, 3), rotation_coeffs(1, 128, 112, 10.0, g), 112),
        ("F=130", patches(130, 128, 3), rotation_coeffs(130, 128, 112, 45.0, g), 112),
        ("K=8 C=3 -> 5x5 (75 floats per face: direct stores)", patches(3, 8, 3),
         rotation_coeffs(3, 8, 5, 15.0, g), 5),
        ("C=1 -> 27x27 (direct stores)", patches(2, 32, 1),
         rotation_coeffs(2, 32, 27, 25.0, g), 27),
        ("C=4", patches(2, 32, 4), rotation_coeffs(2, 32, 28, 25.0, g), 28),
    ]
    for label, pt, cf, o in k2_cases:
        cf = cf.to(dev)
        ref = warp_patches_plain(pt, cf, o, o)
        out = warp_patches_kernel(pt, cf, o, o)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        if err != 0.0 or not torch.isfinite(out).all():
            fail(f"K2 odd shape '{label}': max|kernel-plain| {err}")
    refused = [
        # (label, patches, out size, what the message must name)
        ("a 160x160x3 patch", patches(1, 160, 3), 112, "shared memory"),
        ("a patch off a 16-byte address", unaligned[1:].view(2, 16, 16, 3), 12,
         "16-byte address"),
        ("a 7x7x3 patch (588 bytes)", patches(3, 7, 3), 5, "multiple of 16 bytes"),
    ]
    for label, pt, o, names in refused:
        cf = rotation_coeffs(pt.shape[0], pt.shape[1], o, 5.0, g).to(dev)
        try:
            warp_patches_kernel(pt, cf, o, o)
        except ValueError as e:
            if names not in str(e):
                fail(f"K2 refused {label} without naming the rule: {e}")
        else:
            fail(f"K2 took {label}, which its kernel cannot")
    print(f"[kernels] K2 warp_patches: {len(k2_cases)} odd shapes equal their plain "
          f"version to the bit; refused: {', '.join(r[0] for r in refused)}")


def print_bounds(report: dict, library: str) -> None:
    """Fill each row's bound (the larger of bytes over the memory rate and
    operations over the peak rate for their type) and print its times."""
    for name, rows in report.items():
        for r in rows:
            by_bytes = r["bytes"] / HBM_BYTES_PER_S
            by_ops = r["flops"] / r["peak"]
            r["bound_ms"] = 1e3 * max(by_bytes, by_ops)
            r["bound_by"] = "bytes" if by_bytes >= by_ops else "operations"
            print(f"[timing] {name} {r['shape']}: kernel {r['ms']:.4f} ms, "
                  f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), plain "
                  f"{r['plain_ms']:.4f} ms, {library} {r['library_ms']:.4f} ms")
            if "device_ms" in r:
                def ms(v):
                    return "not measured" if v is None else f"{v:.4f} ms"

                print(f"[timing] {name} {r['shape']}: kernel again after the library "
                      f"call {r['ms_again']:.4f} ms; device time of the kernel alone "
                      f"{ms(r['device_ms'])} warm in L2, {ms(r['cold_device_ms'])} with "
                      f"L2 flushed before each launch ({library} alone "
                      f"{ms(r['library_device_ms'])}); host enqueue {r['host_ms']:.4f} ms "
                      f"per wrapper call")


def print_build_report(name: str, log: str) -> None:
    """What `-Xptxas -v` said of each kernel of one library: registers,
    shared memory, stack and spills. A spill in a streaming kernel (its
    accumulators live in registers) is printed as a warning."""
    entry = "?"
    for line in log.splitlines():
        line = line.strip()
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            entry = next((n for n in ("stream_topk_kernel", "stream_topk_f32_kernel",
                                      "merge_topk_kernel", "crop_resize", "warp_patches")
                          if n in mangled), mangled)
            length = re.search(r"(?:TraitsE|kernelI)Li(\d+)E", mangled)
            if length:  # the list length this instance of the kernel keeps
                entry += f"<list of {length.group(1)}>"
        elif "registers" in line or "spill" in line or "smem" in line:
            print(f"[build] {name} {entry}: {line.replace('ptxas info    : ', '')}")
            if "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line \
                    and entry.startswith("stream_topk"):
                print(f"[build] WARNING: {name} {entry} spills registers: {line}")
        elif "warning" in line.lower():
            print(f"[build] {name}: {line}")


def make_gallery(rows: int, seed: int = 0):
    """rows x 512 float32 unit rows on the card, from a seed."""
    import torch

    g = torch.Generator(device=DEVICE).manual_seed(seed)
    t = torch.randn((rows, 512), generator=g, device=DEVICE)
    t /= torch.linalg.vector_norm(t, dim=1, keepdim=True)
    return t


def gallery_kernel_phase(gal) -> dict:
    """Phase 2, K3 and K4: the streaming top-k kernels against their plain
    versions at the serving shape (128 queries x the whole gallery, k=3)
    and at one small odd shape (1 query, k=8, 8192 rows)."""
    import torch

    from facerecognitionpipeline_tpu_torch.ops import gallery_kernel as gk

    big = gal.shape[0]
    n_bad = 1000
    dup_lo, dup_hi = 100, big - 300_000  # two exact duplicate rows
    t = gal.clone()
    t[-n_bad:] = 0
    t[dup_hi] = t[dup_lo]
    valid = torch.ones(big, dtype=torch.bool, device=DEVICE)
    valid[-n_bad:] = False
    g = torch.Generator(device=DEVICE).manual_seed(1)
    queries = torch.randn((128, 512), generator=g, device=DEVICE)
    rows_q = [dup_lo] + [5 + 131_071 * i for i in range(1, 8)]
    queries[:8] = t[rows_q] * 3.0  # eight queries equal to gallery rows
    tb = t.to(torch.bfloat16)
    codes, scales = gk.quantize_templates(t)

    def agree(label, kv, ki, pv, pi, tol):
        err = float((kv - pv).abs().max())
        gap = (pv[:, :-1] - pv[:, 1:]).abs() > 2 * tol
        clear = torch.ones_like(pi, dtype=torch.bool)
        clear[:, :-1] &= gap
        clear[:, 1:] &= gap
        same = bool(torch.equal(ki[clear], pi[clear]))
        print(f"[kernels] {label}: max|kernel-plain| {err:.3g} (tol {tol:g}), indices "
              f"equal on {int(clear.sum())}/{clear.numel()} clear slots: {same}")
        if not err <= tol or not same:
            fail(f"{label} disagrees with its plain version")
        return err

    report = {"gallery_topk": [], "gallery_topk_int8": []}
    for label, q, rows, k in (("serving", queries, big, 3), ("small", queries[:1], 8192, 8)):
        tb_s, codes_s, scales_s, valid_s = tb[:rows], codes[:rows], scales[:rows], valid[:rows]
        if rows < big:  # keep some invalid rows and the duplicate in play
            valid_s = valid_s.clone()
            valid_s[-50:] = False
            tb_s, codes_s, scales_s = tb_s.clone(), codes_s.clone(), scales_s.clone()
            tb_s[rows - 100], codes_s[rows - 100] = tb_s[dup_lo], codes_s[dup_lo]
            scales_s[rows - 100] = scales_s[dup_lo]
        dup = dup_hi if rows == big else rows - 100
        last_valid = rows - (n_bad if rows == big else 50)
        shape = f"{label} Q={q.shape[0]} G={rows} k={k}"

        kv, ki = gk.streaming_cosine_topk(q, tb_s, valid_s, top_k=k, chunk=STREAM_CHUNK)
        pv, pi = gk.streaming_cosine_topk_plain(q, tb_s, valid_s, top_k=k, chunk=STREAM_CHUNK)
        torch.cuda.synchronize()
        err3 = agree(f"K3 gallery_topk {shape}", kv, ki, pv, pi, K3_TOL)
        kv8, ki8 = gk.streaming_cosine_topk_int8(
            q, codes_s, scales_s, valid_s, top_k=k, chunk=STREAM_CHUNK
        )
        pv8, pi8 = gk.streaming_cosine_topk_int8_plain(
            q, codes_s, scales_s, valid_s, top_k=k, chunk=STREAM_CHUNK
        )
        torch.cuda.synchronize()
        err4 = float((kv8 - pv8).abs().max())
        print(f"[kernels] K4 gallery_topk_int8 {shape}: max|kernel-plain| {err4:.3g} "
              f"(must be 0), indices equal: {bool(torch.equal(ki8, pi8))}")
        if err4 != 0.0 or not torch.equal(ki8, pi8):
            fail(f"K4 {shape} is not equal to its plain version to the bit")
        for name, v, i in (("K3", kv, ki), ("K4", kv8, ki8)):
            if i[0, :2].tolist() != [dup_lo, dup]:
                fail(f"{name} {shape}: duplicate rows came back as {i[0, :2].tolist()}, "
                     f"expected [{dup_lo}, {dup}]")
            if int(i.max()) >= last_valid or float(v.min()) < -1.0:
                fail(f"{name} {shape}: a masked row was returned")
            if not torch.isfinite(v).all():
                fail(f"{name} {shape}: non-finite scores")
        n_self = min(8, q.shape[0])
        if ki[:n_self, 0].tolist() != rows_q[:n_self] or float(kv[:n_self, 0].min()) < 0.99:
            fail(f"K3 {shape}: queries equal to gallery rows did not come back top-1")
        if ki8[:n_self, 0].tolist() != rows_q[:n_self] or float(kv8[:n_self, 0].min()) < 0.98:
            fail(f"K4 {shape}: queries equal to gallery rows did not come back top-1")

        # yardsticks: one matmul with the [Q, G] matrix stored, then topk
        qn = q / torch.linalg.vector_norm(q, dim=1, keepdim=True)
        qb = qn.to(torch.bfloat16)
        neg = torch.tensor(-1e9, device=DEVICE)

        def lib3():
            sims = torch.where(valid_s, torch.matmul(qb, tb_s.T).float(), neg)
            return torch.topk(sims, k)

        qq = torch.round(qn * (127.0 / qn.abs().amax(dim=1, keepdim=True))).to(torch.int8)
        # torch._int_mm needs more than 16 rows; the small shape pads to 32
        qq_mm = qq if qq.shape[0] > 16 else torch.cat([qq, qq.new_zeros((32 - qq.shape[0], 512))])
        int_mm = getattr(torch, "_int_mm", None)
        if int_mm is not None:
            try:  # the yardstick only: which library call this PyTorch offers
                int_mm(qq_mm[:32], codes_s[:64].T)
            except RuntimeError as e:
                print(f"[kernels] torch._int_mm refused the layout ({e}); the K4 "
                      f"yardstick is the dequantised bf16 matmul")
                int_mm = None

        def lib4():
            if int_mm is not None:
                dots = int_mm(qq_mm, codes_s.T)[: qq.shape[0]].float()
            else:
                dots = torch.matmul(qq.to(torch.bfloat16), codes_s.to(torch.bfloat16).T).float()
            return torch.topk(torch.where(valid_s, dots * scales_s, neg), k)

        # the yardsticks answer the same question (torch.topk promises no
        # tie order, so query 0 may come back as either duplicate)
        for name, lib, ref in (("K3", lib3, ki), ("K4", lib4, ki8)):
            lv, li = lib()
            if li[0, 0] not in (dup_lo, dup) or not torch.equal(li[1:n_self, 0], ref[1:n_self, 0]):
                fail(f"the {name} yardstick disagrees on the planted queries ({shape})")
        qd = q.shape[0] * 512
        out_bytes = q.shape[0] * k * 8
        report["gallery_topk"].append({
            "shape": shape, "err": err3, "in_step": rows == big,
            "ms": cuda_time_ms(lambda: gk.streaming_cosine_topk(
                q, tb_s, valid_s, top_k=k, chunk=STREAM_CHUNK)),
            "plain_ms": cuda_time_ms(lambda: gk.streaming_cosine_topk_plain(
                q, tb_s, valid_s, top_k=k, chunk=STREAM_CHUNK), iters=2, warmup=1),
            "library_ms": cuda_time_ms(lib3, iters=5, warmup=1),
            "bytes": 4 * qd + rows * (512 * 2 + 1) + out_bytes,
            "flops": 2 * q.shape[0] * rows * 512, "peak": BF16_FLOPS_PER_S,
        })
        report["gallery_topk_int8"].append({
            "shape": shape, "err": err4, "in_step": rows == big,
            "ms": cuda_time_ms(lambda: gk.streaming_cosine_topk_int8(
                q, codes_s, scales_s, valid_s, top_k=k, chunk=STREAM_CHUNK)),
            "plain_ms": cuda_time_ms(lambda: gk.streaming_cosine_topk_int8_plain(
                q, codes_s, scales_s, valid_s, top_k=k, chunk=STREAM_CHUNK), iters=2, warmup=1),
            "library_ms": cuda_time_ms(lib4, iters=5, warmup=1),
            "bytes": 4 * qd + rows * (512 + 4 + 1) + out_bytes,
            "flops": 2 * q.shape[0] * rows * 512, "peak": INT8_OPS_PER_S,
        })
        if rows == big:
            k3 = lambda: gk.streaming_cosine_topk(  # noqa: E731
                q, tb_s, valid_s, top_k=k, chunk=STREAM_CHUNK)
            k3_q64 = lambda: gk.streaming_cosine_topk(  # noqa: E731
                q[:64], tb_s, valid_s, top_k=k, chunk=STREAM_CHUNK)
            k4 = lambda: gk.streaming_cosine_topk_int8(  # noqa: E731
                q, codes_s, scales_s, valid_s, top_k=k, chunk=STREAM_CHUNK)
            prep3 = lambda: gk.normalize_queries(q).contiguous()  # noqa: E731
            prep4 = lambda: gk._quantize_rows(gk.normalize_queries(q))  # noqa: E731
            for name, fn, prep in (("gallery_topk", k3, prep3), ("gallery_topk_int8", k4, prep4)):
                report[name][-1].update({
                    "ms_again": cuda_time_ms(fn),
                    "stream_device_ms": device_time_ms(fn, "stream_topk_kernel"),
                    "merge_device_ms": device_time_ms(fn, "merge_topk_kernel"),
                    "prep_device_ms": device_time_ms(prep, ""),
                    "prep_host_ms": host_enqueue_ms(prep),
                    "host_ms": host_enqueue_ms(fn),
                })
            report["gallery_topk"][-1].update({
                "q64_ms": cuda_time_ms(k3_q64),
                "q64_stream_device_ms": device_time_ms(k3_q64, "stream_topk_kernel"),
            })
    long_lists_and_float32_rows(gk, report, queries, t, tb, codes, scales, valid,
                                rows_q, agree)
    del t
    gallery_odd_shapes(gk, tb, codes, scales)
    print_bounds(report, "matmul+topk" if int_mm is None else "matmul/_int_mm+topk")
    for name in ("gallery_topk", "gallery_topk_int8"):
        r = report[name][0]

        def ms(v):
            return "not measured" if v is None else f"{v:.4f} ms"

        print(f"[timing] {name} {r['shape']}: the call again {r['ms_again']:.4f} ms; device "
              f"time alone: stream kernel {ms(r['stream_device_ms'])}, merge kernel "
              f"{ms(r['merge_device_ms'])}, the query preparation around them "
              f"{ms(r['prep_device_ms'])} (host {r['prep_host_ms']:.4f} ms); host enqueue "
              f"{r['host_ms']:.4f} ms per wrapper call")
    r = report["gallery_topk"][0]
    print(f"[timing] gallery_topk at Q=64 (one block per gallery tile): {r['q64_ms']:.4f} ms, "
          f"stream kernel {'not measured' if r['q64_stream_device_ms'] is None else format(r['q64_stream_device_ms'], '.4f')} ms; "
          f"at Q=128 two blocks read each tile")
    return report


def long_lists_and_float32_rows(gk, report, q, t, tb, codes, scales, valid, rows_q,
                                agree) -> None:
    """Phase 2, K3 on float32 rows (its own kernel, `csrc/gallery_topk_f32.cu`)
    at the serving shape, held within 1e-5 of its plain version and timed
    beside its bound (operations on CUDA cores) and the stored float32
    matmul + topk; then K3 (bf16 and float32 rows) and K4 at top_k 16, 33 and
    64, the lists that live in shared memory, against their plain versions,
    with the ring depth each length leaves."""
    import torch

    big = t.shape[0]
    qd = q.shape[0] * 512
    neg = torch.tensor(-1e9, device=DEVICE)
    qn = q / torch.linalg.vector_norm(q, dim=1, keepdim=True)
    k = 3

    def k3f(k=k):
        return gk.streaming_cosine_topk(q, t, valid, top_k=k, chunk=STREAM_CHUNK)

    def lib_f32(k=k):
        return torch.topk(torch.where(valid, torch.matmul(qn, t.T), neg), k)

    kv, ki = k3f()
    pv, pi = gk.streaming_cosine_topk_plain(q, t, valid, top_k=k, chunk=STREAM_CHUNK)
    torch.cuda.synchronize()
    shape = f"serving Q={q.shape[0]} G={big} k={k}"
    err = agree(f"K3 gallery_topk_f32 {shape}", kv, ki, pv, pi, 1e-5)
    if ki[:8, 0].tolist() != rows_q[:8] or float(kv[:8, 0].min()) < 0.99:
        fail("K3 on float32 rows: queries equal to gallery rows did not come back top-1")
    report["gallery_topk_f32"] = [{
        "shape": shape, "err": err, "in_step": True,
        "ms": cuda_time_ms(k3f, iters=10),
        "plain_ms": cuda_time_ms(lambda: gk.streaming_cosine_topk_plain(
            q, t, valid, top_k=k, chunk=STREAM_CHUNK), iters=2, warmup=1),
        "library_ms": cuda_time_ms(lib_f32, iters=5, warmup=1),
        "bytes": 4 * qd + big * (512 * 4 + 1) + q.shape[0] * k * 8,
        "flops": 2 * q.shape[0] * big * 512, "peak": F32_FLOPS_PER_S,
        "stream_device_ms": device_time_ms(k3f, "stream_topk_f32_kernel", iters=5),
        "merge_device_ms": device_time_ms(k3f, "merge_topk_kernel", iters=5),
    }]
    r = report["gallery_topk_f32"][0]
    print(f"[timing] gallery_topk_f32 {shape}: stream kernel "
          f"{'not measured' if r['stream_device_ms'] is None else format(r['stream_device_ms'], '.4f')}"
          f" ms device, merge "
          f"{'not measured' if r['merge_device_ms'] is None else format(r['merge_device_ms'], '.4f')}"
          f" ms")

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for k in (16, 33, 64):
        shape = f"long list Q={q.shape[0]} G={big} k={k}"
        out_bytes = q.shape[0] * k * 8
        for name, rows, plain_rows, tol, kind in (
                ("gallery_topk", tb, tb, K3_TOL, "bf16"),
                ("gallery_topk_f32", t, t, 1e-5, "f32"),
                ("gallery_topk_int8", codes, codes, 0.0, "int8")):
            if kind == "int8":
                def fn(k=k):
                    return gk.streaming_cosine_topk_int8(q, codes, scales, valid, top_k=k,
                                                         chunk=STREAM_CHUNK)

                def plain(k=k):
                    return gk.streaming_cosine_topk_int8_plain(q, codes, scales, valid,
                                                               top_k=k, chunk=STREAM_CHUNK)
            else:
                def fn(k=k, rows=rows):
                    return gk.streaming_cosine_topk(q, rows, valid, top_k=k, chunk=STREAM_CHUNK)

                def plain(k=k, rows=plain_rows):
                    return gk.streaming_cosine_topk_plain(q, rows, valid, top_k=k,
                                                          chunk=STREAM_CHUNK)
            kv, ki = fn()
            pv, pi = plain()
            torch.cuda.synchronize()
            if kind == "int8":
                err = float((kv - pv).abs().max())
                if err != 0.0 or not torch.equal(ki, pi):
                    fail(f"K4 {shape} is not equal to its plain version to the bit")
                print(f"[kernels] K4 gallery_topk_int8 {shape}: equal to its plain version")
            else:
                err = agree(f"K3 {name} {shape}", kv, ki, pv, pi, tol)
            geo = gk.gallery_launch_geometry(q.shape[0], big, 512, kind, sms, k)
            print(f"[kernels] {name} {shape}: list of {geo.list_len}, ring of "
                  f"{geo.stages} stages, {geo.smem_bytes} bytes of shared memory")
            elem = {"bf16": 2, "f32": 4, "int8": 1}[kind]
            report[name].append({
                "shape": shape, "err": err, "in_step": False,
                "ms": cuda_time_ms(fn, iters=5, warmup=1),
                "plain_ms": cuda_time_ms(plain, iters=1, warmup=0),
                "library_ms": cuda_time_ms(
                    (lambda k=k: torch.topk(torch.where(valid, torch.matmul(
                        qn.to(torch.bfloat16), tb.T).float(), neg), k)) if kind != "f32"
                    else (lambda k=k: lib_f32(k)), iters=3, warmup=1),
                "bytes": 4 * qd + big * (512 * elem + 1 + (4 if kind == "int8" else 0))
                + out_bytes,
                "flops": 2 * q.shape[0] * big * 512,
                "peak": {"bf16": BF16_FLOPS_PER_S, "f32": F32_FLOPS_PER_S,
                         "int8": INT8_OPS_PER_S}[kind],
            })


def gallery_odd_shapes(gk, tb, codes, scales) -> None:
    """Phase 2, K3 and K4 at the shapes the serving step does not use: query
    counts around the kernels' tiles of 64 and 128, a gallery that ends
    inside a 64-row tile, depths that end inside a 128-byte K-panel, top_k 1
    and 8, fewer valid rows than top_k and none. K4 must equal its plain
    version to the bit, K3 within K3_TOL with equal indices on clear slots."""
    import torch

    g = torch.Generator(device=DEVICE).manual_seed(5)
    cases = [
        # (Q, G, D, top_k, valid rows: None = all but the last 10)
        (64, 4096 + 32, 512, 3, None), (65, 4096 + 32, 512, 8, None),
        (129, 32, 512, 1, None), (200, 4096 + 32, 512, 5, None),
        (128, 8192, 96, 3, None), (128, 8192, 160, 3, None),
        (7, 256, 32, 4, [3, 200]), (5, 4096, 512, 3, []),
    ]
    for nq, rows, d, k, keep in cases:
        q = torch.randn((nq, d), generator=g, device=DEVICE)
        valid = torch.ones(rows, dtype=torch.bool, device=DEVICE)
        if keep is None:
            valid[-10:] = False
        else:
            valid[:] = False
            valid[keep] = True
        shape = f"Q={nq} G={rows} D={d} k={k}" + ("" if keep is None else f" valid={len(keep)}")
        chunk = 32
        t3, c4 = tb[:rows, :d].contiguous(), codes[:rows, :d].contiguous()
        s4 = scales[:rows].contiguous()
        if rows > 16:
            t3[rows - 9], c4[rows - 9] = t3[1], c4[1]  # an invalid twin of row 1
            q[0] = t3[1].float() * 2.0
        kv, ki = gk.streaming_cosine_topk(q, t3, valid, top_k=k, chunk=chunk)
        pv, pi = gk.streaming_cosine_topk_plain(q, t3, valid, top_k=k, chunk=chunk)
        torch.cuda.synchronize()
        err = float((kv - pv).abs().max())
        gap = (pv[:, :-1] - pv[:, 1:]).abs() > 2 * K3_TOL
        clear = torch.ones_like(pi, dtype=torch.bool)
        clear[:, :-1] &= gap
        clear[:, 1:] &= gap
        if not err <= K3_TOL or not torch.equal(ki[clear], pi[clear]):
            fail(f"K3 odd shape {shape}: max|kernel-plain| {err}")
        kv8, ki8 = gk.streaming_cosine_topk_int8(q, c4, s4, valid, top_k=k, chunk=chunk)
        pv8, pi8 = gk.streaming_cosine_topk_int8_plain(q, c4, s4, valid, top_k=k, chunk=chunk)
        torch.cuda.synchronize()
        if not torch.equal(kv8, pv8) or not torch.equal(ki8, pi8):
            fail(f"K4 odd shape {shape}: not equal to its plain version to the bit")
        for name, v, i in (("K3", kv, ki), ("K4", kv8, ki8)):
            n_valid = int(valid.sum())
            if n_valid < k and not (bool((v[:, n_valid:] == -1e9).all())
                                    and bool((i[:, n_valid:] == 0).all())):
                fail(f"{name} odd shape {shape}: surplus slots are not (-1e9, 0)")
            if not bool(valid[i[v > -1e9]].all()):
                fail(f"{name} odd shape {shape}: a masked row was returned")
    # a gallery view that starts off a 16-byte address is refused, not copied
    flat = torch.zeros(64 * 512 + 1, dtype=torch.int8, device=DEVICE)
    off = flat[1:].view(64, 512)
    ones = torch.ones(64, device=DEVICE)
    try:
        gk.streaming_cosine_topk_int8(
            torch.randn((2, 512), device=DEVICE), off, ones, ones.bool(), top_k=2, chunk=32)
    except ValueError as e:
        if "16-byte" not in str(e):
            fail(f"K4 refused a gallery off a 16-byte address without naming the rule: {e}")
    else:
        fail("K4 took a gallery view that starts off a 16-byte address")
    print(f"[kernels] K3/K4: {len(cases)} odd shapes agree with their plain versions (K4 to "
          f"the bit); a gallery off a 16-byte address is refused")


def breakdown(engine, frames, templates, valid, iters: int = 5,
              match_label: str = "match (dense top-k)", tag: str = "breakdown") -> dict:
    """Where the step's time goes: each layer timed alone (host clock
    around synchronized calls, median of `iters`), then the device's busy
    share over whole steps from torch.profiler (kernel time / wall time).
    Returns the device time per step of K1 (its three launches) and K2
    inside the profiled steps, in ms by kernel name, and under "layers",
    "device_ms" and "busy" the layer medians, the device time per step and
    the busy share."""
    import torch

    from facerecognitionpipeline_tpu_torch.ops.image import normalize_face_batch
    from facerecognitionpipeline_tpu_torch.ops.warp import align_faces_batch

    f32 = frames.float()
    with torch.inference_mode():
        det = engine.detector.detect_device(f32)
        b, f = det["valid"].shape
        layers = {
            "detect (cascade, K1 x2)": lambda: engine.detector.detect_device(f32),
            "align (K1 stage A + K2)": lambda: align_faces_batch(
                f32, det["landmarks"], engine._template, 112, 128
            ),
            f"embed ({ARCH}, B*F faces)": lambda: engine.embedder.forward(
                normalize_face_batch(
                    torch.zeros((b * f, 112, 112, 3), device=f32.device),
                    dtype=engine.embedder._dtype,
                )
            ),
            match_label: lambda: engine._match(
                torch.randn((b, f, 512), device=f32.device), templates, valid, 3
            ),
        }
        layer_ms = {}
        for name, fn in layers.items():
            times = []
            for _ in range(iters):
                torch.cuda.synchronize()
                s0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append(1e3 * (time.perf_counter() - s0))
            layer_ms[name] = sorted(times)[iters // 2]
            print(f"[{tag}] {name}: {layer_ms[name]:.3f} ms")

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        for _ in range(3):
            engine.process_frames(frames, templates, valid)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - s0)
    from torch.autograd import DeviceType

    # device-side events only (kernels, copies, sets); the CPU ops that
    # launched them carry the same time again
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in events)
    if dev_us <= 0:
        print(f"[{tag}] device busy share: not measured (profiler saw no device time)")
        return {"layers": layer_ms, "device_ms": None, "busy": None}
    launches = sum(e.count for e in events)
    print(f"[{tag}] device busy {dev_us / wall_us:.3f} of wall over 3 profiled steps "
          f"({dev_us / 3e3:.3f} ms device time and {launches / 3:.0f} device events per "
          f"step; profiled wall {wall_us / 3e3:.3f} ms per step)")
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    for e in top:
        print(f"[{tag}]   {e.self_device_time_total / 3e3:8.3f} ms/step  "
              f"x{e.count // 3:<5d} {e.key[:90]}")
    in_step = {"layers": layer_ms, "device_ms": dev_us / 3e3, "busy": dev_us / wall_us}
    for name in ("crop_resize", "warp_patches", "stream_topk_kernel", "merge_topk_kernel"):
        mine = [e for e in events if name in e.key]
        if not mine and name.endswith("topk_kernel"):
            continue  # the dense match launches no streaming kernel
        in_step[name] = sum(e.self_device_time_total for e in mine) / 3e3
        print(f"[{tag}]   {name} inside the step: {in_step[name]:.4f} ms device time "
              f"per step over {sum(e.count for e in mine) // 3} launches per step")
    return in_step


def serving_phases(fixture, report) -> dict:
    """Phases 3 and 4: the fused step and the request batcher. Returns what
    the later phases reuse (the engine's parts, the frames, the planted
    slots)."""
    import numpy as np
    import torch

    from facerecognitionpipeline_tpu_torch.gallery.search import DeviceGallery
    from facerecognitionpipeline_tpu_torch.models.detector import MTCNNDetector
    from facerecognitionpipeline_tpu_torch.ops import crop_kernel, gallery_kernel, warp_kernel
    from facerecognitionpipeline_tpu_torch.pipeline.embedder import FaceEmbedder
    from facerecognitionpipeline_tpu_torch.pipeline.engine import RecognitionEngine
    from facerecognitionpipeline_tpu_torch.serve.batcher import DeviceBatcher

    t0 = time.perf_counter()
    detector = MTCNNDetector(
        det_size=DET_SIZE, det_thresh=0.5, max_faces=MAX_FACES, min_face_size=40,
        dtype=torch.bfloat16, device=DEVICE,
        weights_path=os.path.join(REPO, "pretrained", "mtcnn_dr.npz"),
    )
    embedder = FaceEmbedder(
        ARCH, dtype=torch.bfloat16, random_ok=True, init_seed=0, device=DEVICE
    )
    engine = RecognitionEngine(detector, embedder, top_k=3)
    if detector.crop_impl != "kernel" or engine.align_impl != "kernel":
        fail("the serving build did not select the kernels")
    rng = np.random.default_rng(0)
    gal = rng.normal(size=(GALLERY_ROWS, 512)).astype(np.float32)
    gal /= np.linalg.norm(gal, axis=1, keepdims=True)
    gallery = DeviceGallery(device=DEVICE)
    gallery.rebuild([f"id{i}" for i in range(GALLERY_ROWS)], gal)
    frames_np, gts = mosaics(fixture, BATCH)
    frames = torch.from_numpy(frames_np).to(DEVICE)
    t, v, _ = gallery.device_snapshot()
    if t.dtype != torch.float32:
        fail(f"a {GALLERY_ROWS}-row gallery must stay float32, got {t.dtype}")
    out = engine.process_frames(frames, t, v)
    torch.cuda.synchronize()
    print(f"[step] built and warmed in {time.perf_counter() - t0:.1f} s")

    # detection recall against the fixture's ground truth
    recall, hits, total = detection_recall(out, gts)
    valid = out["face_valid"].cpu().numpy()
    print(f"[step] detection recall {recall:.3f} ({hits}/{total} faces, IoU>=0.5)")
    if recall < 0.8:
        fail(f"recall {recall} < 0.8")
    for key in ("bboxes", "landmarks", "embeddings", "match_scores", "embedding_norms"):
        if not torch.isfinite(out[key]).all():
            fail(f"non-finite {key}")
    shapes = {
        "bboxes": (BATCH, MAX_FACES, 4), "landmarks": (BATCH, MAX_FACES, 5, 2),
        "aligned": (BATCH, MAX_FACES, 112, 112, 3),
        "embeddings": (BATCH, MAX_FACES, 512), "match_idx": (BATCH, MAX_FACES, 3),
    }
    for key, shape in shapes.items():
        if tuple(out[key].shape) != shape:
            fail(f"{key} shape {tuple(out[key].shape)} != {shape}")

    # planted matches: step embeddings written into known gallery rows
    emb = out["embeddings"].float().cpu().numpy()
    slots = [(f, s) for f in range(BATCH) for s in range(MAX_FACES) if valid[f, s]][:8]
    planted = gal.copy()
    rows = [100 + 37 * i for i in range(len(slots))]
    for row, (f, s) in zip(rows, slots):
        planted[row] = emb[f, s]
    gallery.rebuild([f"id{i}" for i in range(GALLERY_ROWS)], planted)
    t, v, _ = gallery.device_snapshot()

    crop_kernel.LAUNCHES.reset()
    warp_kernel.LAUNCHES.reset()
    gallery_kernel.LAUNCHES.reset()
    gallery_kernel.LAUNCHES_INT8.reset()
    out, ms = timed_steps(engine, frames, t, v, STEP_ITERS)
    if gallery_kernel.LAUNCHES.count or gallery_kernel.LAUNCHES_INT8.count:
        fail("a 1024-row float32 gallery must take the dense match")
    launches = {
        "crop_resize": crop_kernel.LAUNCHES.count,
        "warp_patches": warp_kernel.LAUNCHES.count,
    }
    print(f"[step] launches over {STEP_ITERS} steps: {launches}")
    if launches != {"crop_resize": 3 * STEP_ITERS, "warp_patches": STEP_ITERS}:
        fail(f"expected K1 x3 and K2 x1 per step, got {launches}")
    idx = out["match_idx"].cpu().numpy()
    sc = out["match_scores"].cpu().numpy()
    for row, (f, s) in zip(rows, slots):
        if idx[f, s, 0] != row or sc[f, s, 0] <= 0.99:
            fail(f"planted row {row} came back as {idx[f, s, 0]} ({sc[f, s, 0]})")
    print(f"[step] {len(slots)} planted embeddings came back top-1 "
          f"(min score {min(sc[f, s, 0] for f, s in slots):.5f})")
    p50 = ms[len(ms) // 2]
    print(f"[timing] fused step B={BATCH} {DET_SIZE[0]}x{DET_SIZE[1]} {ARCH} bf16, "
          f"{GALLERY_ROWS}-row float32 gallery: "
          f"p50 {p50:.3f} ms, min {ms[0]:.3f}, max {ms[-1]:.3f} over {STEP_ITERS} "
          f"steps ({BATCH * 1e3 / p50:.1f} frames/s)")
    report["launches"] = launches
    report["step_p50_ms"] = p50
    report["in_step_device_ms"] = breakdown(engine, frames, t, v)

    # phase 4: requests through the batcher, from two client threads
    direct = engine.process_frames(frames, t, v)
    batcher = DeviceBatcher(
        engine, gallery.device_snapshot, max_batch=BATCH, max_wait_ms=5.0,
        top_k=3, bucket_sizes=(BATCH,),
    )
    batcher.warmup(DET_SIZE)
    batcher.start()
    n_req = 16
    futs = [None] * n_req
    try:
        def client(offset):
            for i in range(offset, n_req, 2):
                futs[i] = batcher.submit(frames_np[i % BATCH])

        threads = [threading.Thread(target=client, args=(o,)) for o in (0, 1)]
        r0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        results = [fu.result(timeout=120) for fu in futs]
        r_s = time.perf_counter() - r0
    finally:
        batcher.stop()
    direct = tuple(
        direct[k].cpu().numpy() for k in ("face_valid", "bboxes", "match_idx", "match_scores")
    )
    for i, r in enumerate(results):
        check_request(i, r, direct, i % BATCH)
    print(f"[requests] {n_req} DeviceBatcher requests from 2 threads answered in "
          f"{r_s:.3f} s, each equal to the direct step")
    return {
        "detector": detector, "embedder": embedder, "engine": engine,
        "frames": frames, "frames_np": frames_np, "slots": slots, "gts": gts,
        "emb": torch.from_numpy(emb).to(DEVICE),
    }


def check_request(i, r, direct, f) -> None:
    """One batcher result against frame `f` of the direct step's outputs
    (numpy): same detections, same top-1 where the margin is clear."""
    import numpy as np

    dv, db, di, ds = direct
    if not np.array_equal(r["face_valid"], dv[f]):
        fail(f"request {i}: face_valid differs from the direct step")
    if np.abs(r["bboxes"][dv[f]] - db[f][dv[f]]).max(initial=0) > 0.5:
        fail(f"request {i}: boxes differ from the direct step")
    clear = (ds[f, :, 0] - ds[f, :, 1]) > 5e-3
    if not np.array_equal(r["match_idx"][clear, 0], di[f][clear, 0]):
        fail(f"request {i}: top-1 matches differ from the direct step")
    if np.asarray(r["aligned"]).shape != (MAX_FACES, 112, 112, 3):
        fail(f"request {i}: aligned crops have the wrong shape")


def timed_steps(engine, frames, t, v, iters):
    """`iters` synchronized steps -> (last output, sorted times in ms)."""
    import torch

    times = []
    out = None
    for _ in range(iters):
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        out = engine.process_frames(frames, t, v)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - s0))
    return out, sorted(times)


def large_gallery_phase(ctx, gal, report) -> None:
    """Phase 5: the step against 1 048 576 identities, bf16 then int8."""
    import numpy as np
    import torch

    from facerecognitionpipeline_tpu_torch.gallery.search import DeviceGallery
    from facerecognitionpipeline_tpu_torch.ops import crop_kernel, gallery_kernel, warp_kernel
    from facerecognitionpipeline_tpu_torch.pipeline.engine import RecognitionEngine

    engine, frames, slots = ctx["engine"], ctx["frames"], ctx["slots"]
    if engine.gallery_impl != "auto":
        fail("the serving build does not route the gallery with 'auto'")
    big = gal.shape[0]
    ids = [f"id{i}" for i in range(big)]
    rows = [4099 + 131_101 * i for i in range(len(slots))]
    for row, (f, s) in zip(rows, slots):
        gal[row] = ctx["emb"][f, s]  # the step's own embeddings, planted
    counters = {
        "crop_resize": crop_kernel.LAUNCHES, "warp_patches": warp_kernel.LAUNCHES,
        "gallery_topk": gallery_kernel.LAUNCHES,
        "gallery_topk_int8": gallery_kernel.LAUNCHES_INT8,
    }
    for quantize, kernel, floor in ((None, "gallery_topk", 0.99), ("int8", "gallery_topk_int8", 0.98)):
        label = quantize or "bf16"
        t0 = time.perf_counter()
        gallery = DeviceGallery(device=DEVICE, quantize=quantize)
        gallery.rebuild(ids, gal)
        t, v, snap_ids = gallery.device_snapshot()
        torch.cuda.synchronize()
        rows_pad = (t[0] if isinstance(t, tuple) else t).shape[0]
        dtype = "int8 codes + f32 scales" if isinstance(t, tuple) else str(t.dtype)
        print(f"[big-gallery {label}] DeviceGallery of {len(snap_ids)} identities rebuilt in "
              f"{time.perf_counter() - t0:.2f} s: {rows_pad} rows, {dtype}")
        if rows_pad != big or (quantize is None and t.dtype != torch.bfloat16):
            fail(f"unexpected compact gallery for {label}")
        engine.process_frames(frames, t, v)  # warm
        for c in counters.values():
            c.reset()
        out, ms = timed_steps(engine, frames, t, v, BIG_STEP_ITERS)
        got = {k: c.count for k, c in counters.items()}
        want = {k: 0 for k in counters}
        want.update({"crop_resize": 3 * BIG_STEP_ITERS, "warp_patches": BIG_STEP_ITERS,
                     kernel: BIG_STEP_ITERS})
        print(f"[big-gallery {label}] launches over {BIG_STEP_ITERS} steps: {got} (the "
              f"merge kernel that follows each streaming launch is not counted)")
        if got != want:
            fail(f"expected {want}, got {got}")
        report["launches"][kernel] = got[kernel]
        idx = out["match_idx"].cpu().numpy()
        sc = out["match_scores"].cpu().numpy()
        if out["match_idx"].dtype != torch.int64 or not np.isfinite(sc).all():
            fail(f"{label}: match outputs have the wrong type or are not finite")
        for row, (f, s) in zip(rows, slots):
            if idx[f, s, 0] != row or sc[f, s, 0] <= floor:
                fail(f"{label}: planted row {row} came back as {idx[f, s, 0]} ({sc[f, s, 0]})")
        p50 = ms[len(ms) // 2]
        print(f"[big-gallery {label}] {len(slots)} planted embeddings came back top-1 (min "
              f"score {min(sc[f, s, 0] for f, s in slots):.5f}, floor {floor})")
        print(f"[timing] fused step B={BATCH} {ARCH} bf16, {big}-row {label} gallery: p50 "
              f"{p50:.3f} ms, min {ms[0]:.3f}, max {ms[-1]:.3f} over {BIG_STEP_ITERS} steps "
              f"({BATCH * 1e3 / p50:.1f} frames/s)")
        report[f"step_p50_ms_1m_{label}"] = p50
        breakdown(engine, frames, t, v, iters=3,
                  match_label=f"match (streaming {label}, {big} rows)")
        if quantize == "int8":
            full_idx, full_sc = idx, sc
            budget = RecognitionEngine(
                ctx["detector"], ctx["embedder"], top_k=3, embed_budget=4
            )
            for c in counters.values():
                c.reset()
            bout = budget.process_frames(frames, t, v)
            torch.cuda.synchronize()
            if counters["gallery_topk_int8"].count != 1 or counters["gallery_topk"].count:
                fail("the embed_budget step did not launch K4 exactly once")
            emb = bout["embedded"].cpu().numpy()
            bidx = bout["match_idx"].cpu().numpy()
            bsc = bout["match_scores"].cpu().numpy()
            if not emb.any() or (emb.sum(axis=1) > 4).any():
                fail("embed_budget=4 embedded no slot, or more than 4 in a frame")
            n_planted = 0
            for row, (f, s) in zip(rows, slots):
                if emb[f, s]:
                    n_planted += 1
                    if bidx[f, s, 0] != row or bsc[f, s, 0] <= floor:
                        fail(f"budget step: planted row {row} came back as {bidx[f, s, 0]}")
            clear = emb & ((full_sc[..., 0] - full_sc[..., 1]) > 5e-3)
            if not np.array_equal(bidx[clear, 0], full_idx[clear, 0]):
                fail("budget step: embedded slots match other rows than the full step")
            if (bsc[~emb] != -1.0).any() or (bidx[~emb] != 0).any():
                fail("budget step: unembedded slots must report score -1 and index 0")
            print(f"[big-gallery int8] embed_budget=4 step: {int(emb.sum())} slots embedded, "
                  f"{n_planted} of them planted and top-1, {int(clear.sum())} clear slots "
                  f"equal to the full step")
        del gallery, t, v, out
        torch.cuda.empty_cache()


def manager_phase(ctx) -> None:
    """Phase 6: requests through DeviceBatcher with a GalleryManager that
    was filled, saved and loaded again as the gallery provider."""
    import numpy as np
    import torch

    from facerecognitionpipeline_tpu_torch.gallery.manager import GalleryManager
    from facerecognitionpipeline_tpu_torch.serve.batcher import DeviceBatcher

    engine, frames, frames_np, slots = ctx["engine"], ctx["frames"], ctx["frames_np"], ctx["slots"]
    rng = np.random.default_rng(2)
    emb = ctx["emb"].cpu().numpy()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "gallery", "students.pkl")
        writer = GalleryManager(path, verbose=False, device=DEVICE)
        for i in range(200):
            samples = rng.normal(size=(2, 512)).astype(np.float32)
            if i < len(slots):  # enrolled from the step's own embeddings
                samples = np.repeat(emb[slots[i][0], slots[i][1]][None], 2, axis=0)
            writer.add_student(f"s{i:03d}", f"Student {i}", samples)
        writer.update_embeddings("s150", rng.normal(size=(1, 512)).astype(np.float32))
        writer.delete_student("s199")
        writer.save()
        manager = GalleryManager(path, verbose=False, device=DEVICE)  # loads the files
    if manager.get_statistics()["num_students"] != 199:
        fail("the loaded gallery does not hold the saved students")
    t, v, ids = manager.device_snapshot()
    if t.dtype != torch.float32 or t.shape != (256, 512) or len(ids) != 199:
        fail(f"unexpected manager snapshot {t.dtype} {tuple(t.shape)} {len(ids)}")
    direct = engine.process_frames(frames, t, v)
    direct = tuple(
        direct[k].cpu().numpy() for k in ("face_valid", "bboxes", "match_idx", "match_scores")
    )
    for i, (f, s) in enumerate(slots):
        if ids[direct[2][f, s, 0]] != f"s{i:03d}" or direct[3][f, s, 0] <= 0.99:
            fail(f"enrolled slot {(f, s)} matched {ids[direct[2][f, s, 0]]}")
    hit = manager.search(emb[slots[0][0], slots[0][1]], top_k=2)
    if hit[0][:2] != ("s000", "Student 0") or hit[0][2] <= 0.99:
        fail(f"GalleryManager.search returned {hit}")
    batcher = DeviceBatcher(
        engine, manager.device_snapshot, max_batch=BATCH, max_wait_ms=5.0,
        top_k=3, bucket_sizes=(BATCH,),
    )
    batcher.warmup(DET_SIZE)
    batcher.start()
    try:
        futs = [batcher.submit(frames_np[i % BATCH]) for i in range(8)]
        results = [fu.result(timeout=120) for fu in futs]
    finally:
        batcher.stop()
    for i, r in enumerate(results):
        if r["gallery_ids"] != ids:
            fail(f"request {i}: the result carries another generation's ids")
        check_request(i, r, direct, i % BATCH)
    print(f"[requests] 8 DeviceBatcher requests with a GalleryManager provider (199 "
          f"students, saved and loaded) answered, each equal to the direct step")


# ------------------------------------------------------------ phase 7

SERVER_THRESHOLD = 0.9
# requests of one timed run: (clients, requests each). A p95 is read from at
# least 200 requests at the enrolled gallery and 120 at 1 048 576 identities.
SERVER_RUNS = ((1, 200), (4, 100))
BIG_SERVER_RUNS = ((1, 120), (4, 60))


def pct(values, q):
    import numpy as np

    return float(np.percentile(np.asarray(values, np.float64), q))


def start_server(tmp, name, **kw):
    """A FaceRecognitionServer built by its constructor (it makes its own
    detector, embedder, engine and batcher on the card) and served on a
    thread. Returns (server, httpd, thread, url)."""
    from facerecognitionpipeline_tpu_torch.serve.server import FaceRecognitionServer, serve

    t0 = time.perf_counter()
    server = FaceRecognitionServer(
        similarity_threshold=SERVER_THRESHOLD,
        output_dir=os.path.join(tmp, name, "sessions"),
        architecture=ARCH,
        detector_weights=os.path.join(REPO, "pretrained", "mtcnn_dr.npz"),
        det_size=DET_SIZE, max_faces=MAX_FACES, batch_max=BATCH,
        batch_buckets=(1, BATCH), device=DEVICE, **kw,
    )
    if server.device.type != "cuda" or server.engine.detector.crop_impl != "kernel":
        fail(f"server {name}: not on the card with the kernels selected")
    if server.batcher.bucket_sizes != [1, BATCH]:
        fail(f"server {name}: buckets {server.batcher.bucket_sizes}")
    httpd = serve(server, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    print(f"[server {name}] built, warmed (buckets {server.batcher.bucket_sizes}) and "
          f"listening in {time.perf_counter() - t0:.1f} s")
    return server, httpd, thread, url


def stop_server(server, httpd, thread) -> None:
    httpd.shutdown()
    httpd.server_close()
    server.shutdown()
    thread.join(timeout=30)
    if thread.is_alive():
        fail("a server thread did not stop")


class StepTimer:
    """Times every step the server's batcher dispatches while it is open: a
    pair of CUDA events around `engine.process_frames`, read after the run,
    so the dispatch thread is not made to wait. The time between the events
    is the step as the device saw it, its waits for the host included."""

    def __init__(self, server):
        self.engine = server.engine
        self.events = []

    def __enter__(self):
        import torch

        inner = self.engine.process_frames

        def timed(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = inner(*args, **kwargs)
            end.record()
            self.events.append((start, end))
            return out

        self.engine.process_frames = timed
        return self

    def __exit__(self, *exc):
        del self.engine.process_frames  # the instance attribute; the method stays

    def ms(self):
        import torch

        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.events]


def direct_faces(server, canvas):
    """One direct step of the server's engine on one prepared canvas, against
    the snapshot the batcher would dispatch with: per quality-passing face
    its box, detection score, embedding and top-1 (id, score)."""
    import torch

    t, v, ids = server.gallery.device_snapshot()
    out = server.engine.process_frames(canvas[None], t, v, gallery_k=3)
    torch.cuda.synchronize()
    ok = (out["face_valid"][0] & out["quality_ok"][0]).cpu().numpy()
    boxes = out["bboxes"][0].cpu().numpy()
    det = out["det_scores"][0].cpu().numpy()
    emb = out["embeddings"][0].float().cpu().numpy()
    idx = out["match_idx"][0].cpu().numpy()
    sc = out["match_scores"][0].cpu().numpy()
    faces = []
    for s in range(len(ok)):
        if ok[s]:
            i = int(idx[s, 0])
            faces.append({
                "bbox": boxes[s], "det": float(det[s]), "emb": emb[s],
                "top1": ids[i] if 0 <= i < len(ids) else None, "score": float(sc[s, 0]),
            })
    return faces


def expected_students(faces):
    """Students the tracker must end up recognizing for these direct faces
    (the gate attempts a track whose detection score exceeds 0.6), and those
    it may or may not (a score within 0.01 of a threshold: the served batch
    is another size than the direct step's, and bf16 sums differ with it)."""
    sure, maybe = set(), set()
    for f in faces:
        if f["top1"] is None or f["det"] <= 0.59 or f["score"] < SERVER_THRESHOLD - 0.01:
            continue
        firm = f["det"] > 0.61 and f["score"] >= SERVER_THRESHOLD + 0.01
        (sure if firm else maybe).add(f["top1"])
    return sure, maybe - sure


def check_response(tag, body, faces, scale) -> None:
    import numpy as np

    if body["faces_detected"] != len(faces):
        fail(f"{tag}: faces_detected {body['faces_detected']} != direct step's {len(faces)}")
    got = np.array([t["bbox"] for t in body["tracks"]], np.float32).reshape(-1, 4)
    for f in faces:
        want = f["bbox"] / scale
        if not len(got) or np.abs(got - want).max(axis=1).min() > 1.0:
            fail(f"{tag}: no served box within 1 px of the direct step's {want}")


def drive_clients(tag, server, url, tmp, image_format, frame, n_clients, n_each,
                  faces, enrolled):
    """One session: `n_clients` client threads, `n_each` frames each, every
    answer checked. Returns the numbers of the run."""
    import numpy as np

    from facerecognitionpipeline_tpu_torch.ops import crop_kernel, gallery_kernel, warp_kernel
    from facerecognitionpipeline_tpu_torch.serve.client import FaceRecognitionClient

    session = f"{tag.replace(' ', '_').replace('/', '-')}"
    clients = [
        FaceRecognitionClient(
            server_url=url, session_name=session, synthetic=True, frame_skip=1,
            display=False, output_dir=os.path.join(tmp, "client", f"c{i}"),
            image_format=image_format, det_size=DET_SIZE,
        )
        for i in range(n_clients)
    ]
    if not clients[0].check_server() or not clients[0].init_session():
        fail(f"{tag}: /health or /init_session failed")
    counters = {
        "crop_resize": crop_kernel.LAUNCHES, "warp_patches": warp_kernel.LAUNCHES,
        "gallery_topk": gallery_kernel.LAUNCHES,
        "gallery_topk_int8": gallery_kernel.LAUNCHES_INT8,
    }
    for c in counters.values():
        c.reset()
    steps0 = server.batcher._dispatch_count
    lat = [[] for _ in clients]
    bodies = [[] for _ in clients]
    errors = []

    def run(i):
        try:
            for _ in range(n_each):
                t0 = time.perf_counter()
                body = clients[i].process_frame(frame)
                lat[i].append(1e3 * (time.perf_counter() - t0))
                if body is None:
                    raise RuntimeError("a frame request was not answered with 200")
                bodies[i].append(body)
        except Exception as e:  # noqa: BLE001 - reported below, fails the run
            errors.append(f"client {i}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n_clients)]
    with StepTimer(server) as timer:
        w0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        wall = time.perf_counter() - w0
    step_ms = timer.ms()
    if errors or any(th.is_alive() for th in threads):
        fail(f"{tag}: {errors or 'a client thread hung'}")
    got = {k: c.count for k, c in counters.items()}
    steps = server.batcher._dispatch_count - steps0
    n_req = n_clients * n_each

    for i in range(n_clients):
        for j, body in enumerate(bodies[i]):
            check_response(f"{tag} client {i} frame {j}", body, faces, 1.0)
    sure, maybe = expected_students(faces)
    if not enrolled <= sure | maybe:
        fail(f"{tag}: enrolled {sorted(enrolled - sure - maybe)} not expected from the direct step")
    # by the third frame any client sent, every expected student is there
    for i in range(n_clients):
        rec = {r["student_id"] for r in bodies[i][2]["recognized_tracks"].values()}
        if not sure <= rec or not rec <= sure | maybe:
            fail(f"{tag} client {i}: recognized {sorted(rec)} by the third frame, "
                 f"expected {sorted(sure)} (+ maybe {sorted(maybe)})")
    want = {"crop_resize": 3 * steps, "warp_patches": steps}
    if any(got[k] != n for k, n in want.items()) or steps < 1 or steps > n_req \
            or len(step_ms) != steps:
        fail(f"{tag}: {steps} steps for {n_req} requests launched {got}")
    if n_clients > 1 and steps >= n_req:
        fail(f"{tag}: {n_clients} clients at once, yet {steps} steps for {n_req} requests")

    clients[0].finalize_session()
    for c in clients[1:]:
        c._session.close()
    session_dir = os.path.join(server.output_dir, session)
    with open(os.path.join(session_dir, "attendance.json")) as f:
        attendance = json.load(f)
    listed = {r["student_id"] for r in attendance["recognized"]}
    if not sure <= listed or not listed <= sure | maybe:
        fail(f"{tag}: attendance.json lists {sorted(listed)}, expected {sorted(sure)}")
    with open(os.path.join(session_dir, "performance_report_server.json")) as f:
        perf = json.load(f)
    if perf["request_statistics"]["total_requests_processed"] != n_req:
        fail(f"{tag}: the server's report counts "
             f"{perf['request_statistics']['total_requests_processed']} of {n_req} requests")
    if not perf["memory_usage"]["gpu_vram"]["available"] or \
            perf["memory_usage"]["gpu_vram"]["peak_mb"] <= 0:
        fail(f"{tag}: the report has no device memory from torch.cuda")
    all_lat = [x for row in lat for x in row]
    return {
        "tag": tag, "clients": n_clients, "requests": n_req, "steps": steps,
        "launches": got, "p50": pct(all_lat, 50), "p95": pct(all_lat, 95),
        "rps": n_req / wall, "step_p50": pct(step_ms, 50),
        "server_p50": perf["latency_metrics"]["end_to_end_server"]["p50_ms"],
        "recognized": len(listed), "unrecognized": len(attendance["unrecognized"]),
    }


def print_run(r) -> None:
    """One run's line. The share of a request that is not the device step:
    1 - (p50 of the steps dispatched in this run, from CUDA events) / (p50 of
    the request as the client saw it)."""
    share = 1.0 - r["step_p50"] / r["p50"]
    print(f"[serve] {r['tag']}: {r['requests']} requests from {r['clients']} client(s): "
          f"client p50 {r['p50']:.3f} ms, p95 {r['p95']:.3f} ms, {r['rps']:.2f} requests/s; "
          f"{r['steps']} steps, {r['requests'] / r['steps']:.2f} frames per step, step p50 "
          f"{r['step_p50']:.3f} ms inside the run; server monitor latency_e2e_server_ms "
          f"p50 {r['server_p50']:.3f}; {share:.3f} of a request is not the device step; "
          f"launches {r['launches']}; {r['recognized']} students recognized, "
          f"{r['unrecognized']} tracks unrecognized")


def host_stage_times(frame, response) -> None:
    """The host stages of a request, each timed alone (median of 20): what
    the server pays besides the queue and the step."""
    import base64

    import numpy as np

    from facerecognitionpipeline_tpu_torch.serve import rawproto
    from facerecognitionpipeline_tpu_torch.serve.client import _encode_image_base64
    from facerecognitionpipeline_tpu_torch.serve.server import _decode_image_b64

    def med(fn):
        times = []
        for _ in range(20):
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
        return sorted(times)[10]

    b64 = _encode_image_base64(frame)
    body = json.dumps({"frame": b64, "frame_count": 1, "timestamp": "t"}).encode()
    canvas, _ = rawproto.letterbox_rgb(frame, DET_SIZE)
    yuv = rawproto.rgb_to_i420(canvas)
    raw = canvas.tobytes()
    stages = {
        "client: PNG encode + base64": lambda: _encode_image_base64(frame),
        "client: letterbox": lambda: rawproto.letterbox_rgb(frame, DET_SIZE),
        "client: RGB -> I420": lambda: rawproto.rgb_to_i420(canvas),
        "server: JSON parse of the PNG body": lambda: json.loads(body),
        "server: base64 + PNG decode": lambda: _decode_image_b64(b64),
        "server: letterbox": lambda: rawproto.letterbox_rgb(frame, DET_SIZE),
        "server: frombuffer + reshape (raw)": lambda: np.frombuffer(raw, np.uint8).reshape(
            DET_SIZE[0], DET_SIZE[1], 3),
        "server: JSON encode of the response": lambda: json.dumps(response).encode(),
    }
    print(f"[serve-host] image codec: cv2; PNG body {len(body)} bytes, rgb24 "
          f"{len(raw)} bytes, i420 {yuv.nbytes} bytes, response {len(json.dumps(response))} "
          f"bytes; base64 alone {med(lambda: base64.b64decode(b64)):.3f} ms")
    for name, fn in stages.items():
        print(f"[serve-host] {name}: {med(fn):.3f} ms")


def snapshot_cost(label, manager) -> None:
    manager.device_snapshot()
    times = []
    for _ in range(20):
        t0 = time.perf_counter()
        snap = manager.device_snapshot()
        times.append(1e3 * (time.perf_counter() - t0))
    print(f"[serve-host] GalleryManager.device_snapshot with {len(snap[2])} ids "
          f"({label}): p50 {sorted(times)[10]:.4f} ms, max {max(times):.4f} ms of host "
          f"time per call (it copies the id list)")


def bad_requests(url) -> None:
    """A bad session name and a short raw body get 400, and the next request
    on the same connection still parses."""
    from facerecognitionpipeline_tpu_torch.serve import rawproto
    from facerecognitionpipeline_tpu_torch.serve.client import HTTPSession

    http = HTTPSession()
    try:
        if http.get(f"{url}/health", timeout=10).status_code != 200:
            fail("/health did not answer 200")
        conn = next(iter(http._conns.values()))
        r = http.post(f"{url}/init_session", json={"session_name": "../escape"}, timeout=10)
        if r.status_code != 400 or "invalid session_name" not in r.text:
            fail(f"a session name with '..' got {r.status_code}: {r.text[:200]}")
        r = http.post(
            f"{url}/process_frame_raw", data=b"\x00" * 1000, timeout=10,
            headers={rawproto.HEADER_FORMAT: "rgb24",
                     rawproto.HEADER_WIDTH: str(DET_SIZE[1]),
                     rawproto.HEADER_HEIGHT: str(DET_SIZE[0]),
                     rawproto.HEADER_SCALE: "1.0"},
        )
        if r.status_code != 400 or "must be exactly" not in r.text:
            fail(f"a short raw body got {r.status_code}: {r.text[:200]}")
        r = http.post(f"{url}/process_frame", json={"frame": "AAAA"}, timeout=10)
        if r.status_code != 400 or "could not decode frame" not in r.text:
            fail(f"an undecodable frame got {r.status_code}: {r.text[:200]}")
        r = http.get(f"{url}/health", timeout=10)
        if r.status_code != 200 or r.json()["status"] != "ok":
            fail("the request after the bad ones did not parse")
        if next(iter(http._conns.values())) is not conn:
            fail("the connection did not survive the 400s")
        times = []
        for _ in range(30):
            t0 = time.perf_counter()
            http.get(f"{url}/health", timeout=10)
            times.append(1e3 * (time.perf_counter() - t0))
        print(f"[serve-host] GET /health round trip on a kept-alive connection: p50 "
              f"{sorted(times)[15]:.3f} ms, max {max(times):.3f} ms (host clock)")
    finally:
        http.close()
    print("[serve] a '..' session name, a short raw body and an undecodable frame got "
          "400; the next request on the same connection parsed")


def enrol_students(name, server, url, canvas, gallery_path, rng):
    """Enrol through the manager's file: every other face of the server's
    direct step that the tracker's gate will attempt, among 200 seeded
    others; POST /reload_gallery twice (reloaded, then unchanged). Returns
    the direct step's faces after the reload, the enrolled ids and the first
    reload's answer."""
    import numpy as np

    from facerecognitionpipeline_tpu_torch.gallery.manager import GalleryManager
    from facerecognitionpipeline_tpu_torch.serve.client import HTTPSession

    faces = direct_faces(server, canvas)
    strong = [f for f in faces if f["det"] > 0.7]
    if len(strong) < 8:
        fail(f"{name}: only {len(strong)} of {len(faces)} faces pass the gate")
    writer = GalleryManager(gallery_path, verbose=False, device=DEVICE)
    enrolled = set()
    for i in range(200):
        writer.add_student(
            f"other{i:03d}", f"Other {i}",
            rng.normal(size=(2, 512)).astype(np.float32),
        )
        if i % 25 == 0 and i // 25 < len(strong[::2]):
            sid = f"face{i // 25:02d}"
            writer.add_student(
                sid, f"Face {i // 25}",
                np.repeat(strong[::2][i // 25]["emb"][None], 2, axis=0),
            )
            enrolled.add(sid)
    writer.save()
    http = HTTPSession()
    try:
        first = http.post(f"{url}/reload_gallery", json={}, timeout=60).json()
        second = http.post(f"{url}/reload_gallery", json={}, timeout=60).json()
    finally:
        http.close()
    if (first.get("status"), second.get("status")) != ("reloaded", "unchanged") \
            or first["num_students"] != 200 + len(enrolled):
        fail(f"{name}: /reload_gallery answered {first} then {second}")
    faces = direct_faces(server, canvas)
    own = {f["top1"] for f in faces if f["score"] > 0.99}
    if not enrolled <= own:
        fail(f"{name}: enrolled faces {sorted(enrolled - own)} are not their "
             f"own top-1 in the direct step")
    return faces, enrolled, first


def server_phase(ctx, gal, report) -> None:
    """Phase 7: the HTTP server on the card (see the module docstring)."""
    import numpy as np
    import torch

    from facerecognitionpipeline_tpu_torch.gallery.manager import GalleryManager, StudentRecord
    from facerecognitionpipeline_tpu_torch.serve import rawproto
    from facerecognitionpipeline_tpu_torch.serve.client import HTTPSession

    frame = ctx["frames_np"][0]
    rng = np.random.default_rng(5)
    report["server_launches"] = {}
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for transport, formats in (("rgb", ("png", "raw")), ("i420", ("raw-i420",))):
            name = f"transport={transport}"
            gallery_path = os.path.join(tmp, name, "gallery", "students.pkl")
            server, httpd, thread, url = start_server(
                tmp, name, gallery_path=gallery_path, transport=transport,
            )
            try:
                canvas, scale = rawproto.letterbox_rgb(frame, DET_SIZE)
                if scale != 1.0 or not np.array_equal(canvas, frame):
                    fail("a frame at det_size must letterbox to itself")
                if transport == "i420":
                    canvas = rawproto.rgb_to_i420(canvas)
                faces, enrolled, first = enrol_students(
                    name, server, url, canvas, gallery_path, rng)
                print(f"[server {name}] {len(enrolled)} of {len(faces)} faces enrolled among "
                      f"{first['num_students']} students; /reload_gallery: reloaded, then "
                      f"unchanged")
                times = []
                with StepTimer(server) as timer:
                    for _ in range(100):
                        t0 = time.perf_counter()
                        server.batcher.submit(canvas).result(timeout=120)
                        times.append(1e3 * (time.perf_counter() - t0))
                print(f"[serve-host] {name}: DeviceBatcher.submit().result() alone, 100 "
                      f"frames one at a time (upload, the {server.batcher.max_wait_s * 1e3:.0f} ms "
                      f"batching window, the step at B=1, results to the host): p50 "
                      f"{pct(times, 50):.3f} ms, p95 {pct(times, 95):.3f} ms; the step "
                      f"inside it p50 {pct(timer.ms(), 50):.3f} ms (CUDA events)")
                for image_format in formats:
                    for n_clients, n_each in SERVER_RUNS:
                        tag = f"{image_format} x{n_clients}"
                        r = drive_clients(tag, server, url, tmp, image_format, frame,
                                          n_clients, n_each, faces, enrolled)
                        print_run(r)
                        runs.append(r)
                http = HTTPSession()
                try:
                    stats = http.get(f"{url}/stats", timeout=10).json()
                finally:
                    http.close()
                allocated = torch.cuda.memory_allocated() / (1024 * 1024)
                if not stats["current_gpu_vram_mb"] > 0 or \
                        abs(stats["current_gpu_vram_mb"] - allocated) > 0.5 * allocated:
                    fail(f"{name}: /stats reports {stats['current_gpu_vram_mb']} MB, "
                         f"torch.cuda {allocated:.1f} MB")
                print(f"[server {name}] /stats: current_gpu_vram_mb "
                      f"{stats['current_gpu_vram_mb']:.1f} (torch.cuda.memory_allocated "
                      f"{allocated:.1f} MB), peak_gpu_vram_mb {stats['peak_gpu_vram_mb']:.1f}")
                if transport == "rgb":
                    bad_requests(url)
                    snapshot_cost("the enrolled gallery", server.gallery)
                    http = HTTPSession()
                    try:
                        body = http.post(
                            f"{url}/process_frame_raw", data=frame.tobytes(), timeout=60,
                            headers={rawproto.HEADER_FORMAT: "rgb24",
                                     rawproto.HEADER_WIDTH: str(DET_SIZE[1]),
                                     rawproto.HEADER_HEIGHT: str(DET_SIZE[0]),
                                     rawproto.HEADER_SCALE: "1.0"},
                        ).json()
                    finally:
                        http.close()
                    host_stage_times(frame, body)
            finally:
                stop_server(server, httpd, thread)
            del server
            torch.cuda.empty_cache()
        for k in ("crop_resize", "warp_patches"):
            report["server_launches"][k] = sum(r["launches"][k] for r in runs)
        report["serve_runs"] = runs
        if any(r["launches"]["gallery_topk"] or r["launches"]["gallery_topk_int8"] for r in runs):
            fail("a gallery of a few hundred students must take the dense match")

        # the compact galleries of 1 048 576 identities behind the server. The
        # records are made in bulk as views of the matrix (what add_student
        # stores for one unit-norm sample) and saved to the manager's pickle
        # once; each server then loads that file through its own constructor
        # (gallery_path, gallery_quantize) and makes the device copy itself.
        gal = gal.cpu().numpy()
        big = gal.shape[0]
        now = "2026-01-01T00:00:00"
        big_path = os.path.join(tmp, "big", "students.pkl")
        t0 = time.perf_counter()
        writer = GalleryManager(big_path, verbose=False, device=DEVICE)
        writer.students = {
            f"id{i}": StudentRecord(f"id{i}", f"Identity {i}", gal[i:i + 1], gal[i], 1, now, now)
            for i in range(big)
        }
        writer.save()
        del writer
        print(f"[server big] GalleryManager file of {big} identities written in "
              f"{time.perf_counter() - t0:.1f} s ({os.path.getsize(big_path) / 2**30:.2f} GiB)")
        # phase 5 planted the direct step's embeddings of these faces
        planted_rows = {f"id{4099 + 131_101 * i}" for i in range(len(ctx["slots"]))
                        if ctx["slots"][i][0] == 0}
        for quantize, kernel in ((None, "gallery_topk"), ("int8", "gallery_topk_int8")):
            label = quantize or "bf16"
            server, httpd, thread, url = start_server(
                tmp, f"big-{label}", gallery_path=big_path, gallery_quantize=quantize,
                transport="rgb",
            )
            try:
                t, v, ids = server.gallery.device_snapshot()
                if server.gallery.gallery_path != big_path or len(ids) != big or \
                        (quantize is None and t.dtype != torch.bfloat16) or \
                        (quantize == "int8" and not (isinstance(t, tuple)
                                                     and t[0].dtype == torch.int8)):
                    fail(f"big-{label}: the server's own gallery is not the {label} compact "
                         f"copy of the file")
                del t, v, ids
                snapshot_cost(f"{label} compact copy", server.gallery)
                faces = direct_faces(server, frame)
                planted = planted_rows & expected_students(faces)[0]
                if len(planted) < 4:
                    fail(f"big-{label}: only {sorted(planted)} of the planted rows "
                         f"{sorted(planted_rows)} are firm top-1 matches of the direct step")
                for n_clients, n_each in BIG_SERVER_RUNS:
                    r = drive_clients(f"raw x{n_clients} {big} ids {label}", server, url, tmp,
                                      "raw", frame, n_clients, n_each, faces, planted)
                    other = "gallery_topk_int8" if kernel == "gallery_topk" else "gallery_topk"
                    if r["launches"][kernel] != r["steps"] or r["launches"][other]:
                        fail(f"big-{label}: {r['steps']} steps launched {r['launches']}")
                    print_run(r)
                    report["server_launches"][kernel] = \
                        report["server_launches"].get(kernel, 0) + r["launches"][kernel]
            finally:
                stop_server(server, httpd, thread)
            del server
            torch.cuda.empty_cache()
    for name, n in report["server_launches"].items():
        if n < 1:
            fail(f"the server's path never launched {name}")
    print(f"[serve] launches on the server's path: {report['server_launches']}")


# ------------------------------------------------------------ phase 8

INT8_STEP_ITERS = 12
INT8_SERVER_REQUESTS = 200
# int8 layers' shapes that no serving step gives, each held to its plain
# version as well: one row (K = 45, N = 28), K = 27 with N = 28 (27 rows), and
# a dense layer of 5 rows with K = 27 and N = 28
INT8_ODD_SHAPES = (("conv", 1, 3, 3, 5, 3, 1, 0, 28), ("conv", 3, 5, 5, 3, 3, 1, 0, 28),
                   ("dense", 5, 27, 28))


def quant_layers(*modules):
    from facerecognitionpipeline_tpu_torch.models.irse import QuantConv, QuantDense

    return [m for mod in modules for m in mod.modules() if isinstance(m, (QuantConv, QuantDense))]


def int8_step_shapes(engine, frames, t, v) -> dict:
    """The int8 layers' input shapes in one step of `engine`, with how many
    layers of the step take each: {("conv", B, H, W, C, k, stride, padding,
    N) or ("dense", M, K, N): count}."""
    import torch

    from facerecognitionpipeline_tpu_torch.models.irse import QuantConv

    seen: dict = {}

    def hook(module, inputs):
        x = inputs[0]
        if isinstance(module, QuantConv):
            b, c, h, w = x.shape
            key = ("conv", b, h, w, c, module.ksize[0], module.stride, module.padding,
                   module.features)
        else:
            key = ("dense", x.shape[0], x.shape[1], module.features)
        seen[key] = seen.get(key, 0) + 1

    hooks = [m.register_forward_pre_hook(hook)
             for m in quant_layers(engine.detector.nets, engine.embedder.model)]
    try:
        engine.process_frames(frames, t, v)
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    return seen


def int8_product_phase(shapes: dict) -> dict:
    """The int8 product at every distinct shape of the step and at the odd
    ones: the card route (im2col + cuBLASLt int8) against its plain version
    (the same im2col, float64 sums) on the same random codes, which must be
    equal; the im2col and the product timed apart (CUDA events), beside a
    bf16 cuDNN conv (or matmul) of the same shape and the bound by
    operations. Returns the sums over one step's layers."""
    import torch
    import torch.nn.functional as F

    from facerecognitionpipeline_tpu_torch.ops import int8_gemm

    g = torch.Generator(device=DEVICE).manual_seed(8)
    total = {"im2col_ms": 0.0, "product_ms": 0.0, "cudnn_bf16_ms": 0.0, "bound_ms": 0.0,
             "layers": 0}
    for key, count in list(shapes.items()) + [(k, 0) for k in INT8_ODD_SHAPES]:
        def codes(*shape):
            return torch.randint(-127, 128, shape, generator=g, device=DEVICE,
                                 dtype=torch.int8)

        if key[0] == "conv":
            _, b, h, w, c, k, stride, pad, n = key
            x = codes(b, h, w, c)
            wq = codes(k * k * c, n)
            packed = int8_gemm.pack_weight(wq)
            ho = (h + 2 * pad - k) // stride + 1
            wo = (w + 2 * pad - k) // stride + 1
            m, kk = b * ho * wo, k * k * c

            def col(x=x, k=k, stride=stride, pad=pad, kp=packed.shape[1]):
                return int8_gemm.im2col(x, (k, k), stride, pad, kp)

            xb = x.permute(0, 3, 1, 2).to(torch.bfloat16)  # NCHW view, channels last
            wb = wq.reshape(k, k, c, n).permute(3, 2, 0, 1).to(torch.bfloat16).contiguous()

            def lib(xb=xb, wb=wb, stride=stride, pad=pad):
                return F.conv2d(xb, wb, stride=stride, padding=pad)

            desc = f"conv {k}x{k}/{stride} pad {pad} [{b},{h},{w},{c}] -> {n}"
        else:
            _, m, kk, n = key
            x = codes(m, kk)
            wq = codes(kk, n)
            packed = int8_gemm.pack_weight(wq)

            def col(x=x, kp=packed.shape[1]):
                return torch.cat([x, x.new_zeros((x.shape[0], kp - x.shape[1]))], dim=1) \
                    if kp > x.shape[1] else x

            xb = x.to(torch.bfloat16)
            wb = wq.t().to(torch.bfloat16).contiguous()

            def lib(xb=xb, wb=wb):
                return F.linear(xb, wb)

            desc = f"dense [{m},{kk}] -> {n}"
        a = col()
        int8_gemm.PRODUCTS.reset()
        got = int8_gemm.int8_product(a, packed, n)
        if int8_gemm.PRODUCTS.count != 1:
            fail(f"int8 product {desc} did not take the card route")
        want = int8_gemm.int8_product(a, packed, n, plain=True)
        err = int((got.long() - want.long()).abs().max().item()) if got.numel() else 0
        if got.dtype != torch.int32 or tuple(got.shape) != (m, n) or not torch.equal(got, want):
            fail(f"int8 product {desc}: card route differs from its plain version "
                 f"(max |card - plain| {err})")
        ms_col = cuda_time_ms(col) if a is not x else 0.0
        ms_prod = cuda_time_ms(lambda a=a, packed=packed, n=n: int8_gemm.int8_product(a, packed, n))
        ms_lib = cuda_time_ms(lib)
        bound = 2.0 * m * kk * n / INT8_OPS_PER_S * 1e3
        print(f"[int8] product {desc} (x{count} per step; M={m} K={kk} N={n}): im2col "
              f"{ms_col:.4f} ms, product {ms_prod:.4f} ms, bf16 cuDNN "
              f"{'conv' if key[0] == 'conv' else 'matmul'} {ms_lib:.4f} ms, bound "
              f"{bound:.4f} ms (operations at 1979 TOPS); max |card - plain| {err}")
        total["im2col_ms"] += count * ms_col
        total["product_ms"] += count * ms_prod
        total["cudnn_bf16_ms"] += count * ms_lib
        total["bound_ms"] += count * bound
        total["layers"] += count
        del a, got, want, x, wq, packed, xb, wb
    torch.cuda.empty_cache()
    share = total["im2col_ms"] / (total["im2col_ms"] + total["product_ms"])
    print(f"[int8] the step's {total['layers']} int8 layers, summed: im2col "
          f"{total['im2col_ms']:.3f} ms + product {total['product_ms']:.3f} ms (im2col share "
          f"{share:.3f}); the same shapes as bf16 cuDNN {total['cudnn_bf16_ms']:.3f} ms; bound "
          f"{total['bound_ms']:.3f} ms; every shape equal to its plain version")
    return {**total, "im2col_share": share}


def int8_phase(ctx, gal, report) -> None:
    """Phase 8: the int8 tier (see the module docstring)."""
    import numpy as np
    import torch

    from facerecognitionpipeline_tpu_torch.gallery.search import DeviceGallery
    from facerecognitionpipeline_tpu_torch.models.detector import MTCNNDetector
    from facerecognitionpipeline_tpu_torch.ops import crop_kernel, gallery_kernel, int8_gemm
    from facerecognitionpipeline_tpu_torch.ops import warp_kernel
    from facerecognitionpipeline_tpu_torch.pipeline.embedder import FaceEmbedder
    from facerecognitionpipeline_tpu_torch.pipeline.engine import RecognitionEngine

    res: dict = {}
    t0 = time.perf_counter()
    detector = MTCNNDetector(
        det_size=DET_SIZE, det_thresh=0.5, max_faces=MAX_FACES, min_face_size=40,
        dtype=torch.bfloat16, device=DEVICE, quantize="int8",
        weights_path=os.path.join(REPO, "pretrained", "mtcnn_dr.npz"),
    )
    torch.cuda.synchronize()
    res["detector_calibration_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    embedder = FaceEmbedder(ARCH, dtype=torch.bfloat16, random_ok=True, init_seed=0,
                            quantize="int8", device=DEVICE)
    torch.cuda.synchronize()
    res["embedder_calibration_s"] = time.perf_counter() - t0
    print(f"[int8] MTCNNDetector(quantize='int8') calibrated on 6 synthetic frames and "
          f"quantized in {res['detector_calibration_s']:.1f} s; FaceEmbedder({ARCH}, "
          f"quantize='int8') on 64 synthetic crops in {res['embedder_calibration_s']:.1f} s")
    engine = RecognitionEngine(detector, embedder, top_k=3)
    if not (detector.quantized and embedder.quantized) or detector.crop_impl != "kernel" \
            or engine.align_impl != "kernel":
        fail("the int8 build is not quantized or did not select the kernels")
    frames, frames_np = ctx["frames"], ctx["frames_np"]
    rng = np.random.default_rng(8)
    rows_f32 = rng.normal(size=(GALLERY_ROWS, 512)).astype(np.float32)
    rows_f32 /= np.linalg.norm(rows_f32, axis=1, keepdims=True)
    ids = [f"id{i}" for i in range(GALLERY_ROWS)]
    gallery = DeviceGallery(device=DEVICE)
    gallery.rebuild(ids, rows_f32)
    t, v, _ = gallery.device_snapshot()

    # 8a: the int8 product at the step's shapes
    shapes = int8_step_shapes(engine, frames, t, v)
    per_step = sum(shapes.values())
    res["int8_layers_per_step"] = per_step
    res["product"] = int8_product_phase(shapes)

    # 8b: the quantized step
    out = engine.process_frames(frames, t, v)
    recall, hits, total = detection_recall(out, ctx["gts"])
    print(f"[int8] detection recall {recall:.3f} ({hits}/{total} faces, IoU>=0.5) with the "
          f"int8 R-net and O-net")
    if recall < 0.8:
        fail(f"int8 recall {recall} < 0.8")
    for key in ("bboxes", "landmarks", "embeddings", "match_scores", "embedding_norms"):
        if not torch.isfinite(out[key]).all():
            fail(f"int8 step: non-finite {key}")
    valid = out["face_valid"].cpu().numpy()
    emb = out["embeddings"].float().cpu().numpy()
    slots = [(f, s) for f in range(BATCH) for s in range(MAX_FACES) if valid[f, s]][:8]
    planted = rows_f32.copy()
    rows = [100 + 37 * i for i in range(len(slots))]
    for row, (f, s) in zip(rows, slots):
        planted[row] = emb[f, s]
    gallery.rebuild(ids, planted)
    t, v, _ = gallery.device_snapshot()
    counters = {
        "crop_resize": crop_kernel.LAUNCHES, "warp_patches": warp_kernel.LAUNCHES,
        "gallery_topk": gallery_kernel.LAUNCHES,
        "gallery_topk_int8": gallery_kernel.LAUNCHES_INT8, "int8_products": int8_gemm.PRODUCTS,
    }
    for c in counters.values():
        c.reset()
    out, ms8 = timed_steps(engine, frames, t, v, INT8_STEP_ITERS)
    got = {k: c.count for k, c in counters.items()}
    want = {"crop_resize": 3 * INT8_STEP_ITERS, "warp_patches": INT8_STEP_ITERS,
            "gallery_topk": 0, "gallery_topk_int8": 0,
            "int8_products": per_step * INT8_STEP_ITERS}
    print(f"[int8] launches over {INT8_STEP_ITERS} int8 steps: {got}")
    if got != want:
        fail(f"int8 step: expected {want}, got {got}")
    res["launches"] = got
    idx = out["match_idx"].cpu().numpy()
    sc = out["match_scores"].cpu().numpy()
    for row, (f, s) in zip(rows, slots):
        if idx[f, s, 0] != row or sc[f, s, 0] <= 0.99:
            fail(f"int8 step: planted row {row} came back as {idx[f, s, 0]} ({sc[f, s, 0]})")
    print(f"[int8] {len(slots)} planted int8 embeddings came back top-1 (min score "
          f"{min(sc[f, s, 0] for f, s in slots):.5f})")

    # the same step with every int8 layer on the plain product: both sums are
    # exact, so the embeddings must be identical (cuDNN held deterministic
    # for the float layers around them)
    layers = quant_layers(detector.nets, embedder.model)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        card = engine.process_frames(frames, t, v)
        for m in layers:
            m.plain = True
        int8_gemm.PRODUCTS.reset()
        plain = engine.process_frames(frames, t, v)
        torch.cuda.synchronize()
    finally:
        for m in layers:
            m.plain = False
        torch.backends.cudnn.deterministic = deterministic
    if int8_gemm.PRODUCTS.count:
        fail("the plain step still took the card route")
    diff = (card["embeddings"].float() - plain["embeddings"].float()).abs().max().item()
    if not (torch.equal(card["face_valid"], plain["face_valid"])
            and torch.equal(card["bboxes"], plain["bboxes"])
            and torch.equal(card["embeddings"], plain["embeddings"])):
        fail(f"int8 step: the card's product and the plain product give different answers "
             f"(embeddings max |diff| {diff})")
    print("[int8] the same step with the plain product (float64 sums) on the card: identical "
          "detections and embeddings")

    # int8 against bf16 on the same detected faces
    ok = card["face_valid"]
    faces = card["aligned"][ok].float()
    with torch.inference_mode():
        e8 = embedder.embed_batch_device(faces)[0]
        e16 = ctx["embedder"].embed_batch_device(faces)[0]
    cos = (e8 * e16).sum(-1).float().cpu().numpy()
    res["cos_int8_bf16_min"] = float(cos.min())
    res["cos_int8_bf16_median"] = float(np.median(cos))
    print(f"[int8] cosine of int8 against bf16 embeddings of the same {len(cos)} detected "
          f"faces: min {cos.min():.5f}, median {np.median(cos):.5f} (random {ARCH} weights; "
          f"no limit set)")

    # timing, bf16 then int8 again, in this run
    _, ms16 = timed_steps(ctx["engine"], frames, t, v, INT8_STEP_ITERS)
    _, ms8b = timed_steps(engine, frames, t, v, INT8_STEP_ITERS)
    for label, ms in (("int8", ms8), ("bf16", ms16), ("int8 again", ms8b)):
        p50 = ms[len(ms) // 2]
        res[f"step_p50_ms_{label.replace(' ', '_')}"] = p50
        print(f"[int8] fused step B={BATCH} {ARCH} {label}, {GALLERY_ROWS}-row gallery: p50 "
              f"{p50:.3f} ms, min {ms[0]:.3f}, max {ms[-1]:.3f} over {INT8_STEP_ITERS} steps")
    bd8 = breakdown(engine, frames, t, v, tag="int8 breakdown")
    bd16 = breakdown(ctx["engine"], frames, t, v, tag="bf16 breakdown")
    for label, bd in (("int8", bd8), ("bf16", bd16)):
        res[f"device_ms_{label}"] = bd["device_ms"]
        res[f"busy_{label}"] = bd["busy"]
        for name, ms in bd["layers"].items():
            res[f"{name.split(' ')[0]}_ms_{label}"] = ms
    print(f"[int8] device time per step (torch.profiler): int8 {bd8['device_ms']} ms, bf16 "
          f"{bd16['device_ms']} ms; embed alone {res['embed_ms_int8']:.3f} against "
          f"{res['embed_ms_bf16']:.3f} ms, detect alone {res['detect_ms_int8']:.3f} against "
          f"{res['detect_ms_bf16']:.3f} ms")
    del gallery, t, v, out, card, plain

    # 8c: the all-int8 deployment: the int8 step against 1 048 576 int8 rows
    big = gal.shape[0]
    big_rows = [7001 + 131_101 * i for i in range(len(slots))]
    for row, (f, s) in zip(big_rows, slots):
        gal[row] = torch.from_numpy(emb[f, s]).to(DEVICE)
    t0 = time.perf_counter()
    big_gallery = DeviceGallery(device=DEVICE, quantize="int8")
    big_gallery.rebuild([f"id{i}" for i in range(big)], gal)
    t, v, _ = big_gallery.device_snapshot()
    torch.cuda.synchronize()
    if not (isinstance(t, tuple) and t[0].dtype == torch.int8):
        fail("the 1 048 576-row gallery is not the int8 pair")
    print(f"[int8] int8 DeviceGallery of {big} identities rebuilt in "
          f"{time.perf_counter() - t0:.2f} s")
    engine.process_frames(frames, t, v)  # warm
    for c in counters.values():
        c.reset()
    out, ms = timed_steps(engine, frames, t, v, BIG_STEP_ITERS)
    got = {k: c.count for k, c in counters.items()}
    want = {"crop_resize": 3 * BIG_STEP_ITERS, "warp_patches": BIG_STEP_ITERS,
            "gallery_topk": 0, "gallery_topk_int8": BIG_STEP_ITERS,
            "int8_products": per_step * BIG_STEP_ITERS}
    if got != want:
        fail(f"all-int8 step: expected {want}, got {got}")
    idx = out["match_idx"].cpu().numpy()
    sc = out["match_scores"].cpu().numpy()
    for row, (f, s) in zip(big_rows, slots):
        if idx[f, s, 0] != row or sc[f, s, 0] <= 0.98:
            fail(f"all-int8 step: planted row {row} came back as {idx[f, s, 0]} ({sc[f, s, 0]})")
    p50 = ms[len(ms) // 2]
    res["step_p50_ms_1m_int8_gallery"] = p50
    res["launches_1m_int8_gallery"] = got
    print(f"[int8] all-int8 step against {big} int8 rows: {len(slots)} planted rows top-1 (min "
          f"score {min(sc[f, s, 0] for f, s in slots):.5f}, floor 0.98); launches {got}; p50 "
          f"{p50:.3f} ms, min {ms[0]:.3f}, max {ms[-1]:.3f} over {BIG_STEP_ITERS} steps")
    del big_gallery, t, v, out, engine, detector, embedder
    torch.cuda.empty_cache()

    # 8d: one int8 server, built by its constructor, one raw rgb24 client
    frame = frames_np[0]
    with tempfile.TemporaryDirectory() as tmp:
        gallery_path = os.path.join(tmp, "int8", "gallery", "students.pkl")
        server, httpd, thread, url = start_server(
            tmp, "int8", gallery_path=gallery_path, transport="rgb", quantize="int8")
        try:
            if not (server.engine.detector.quantized and server.engine.embedder.quantized):
                fail("the server's quantize='int8' build is not quantized")
            faces, enrolled, first = enrol_students(
                "int8", server, url, frame, gallery_path, np.random.default_rng(5))
            print(f"[int8] server: {len(enrolled)} of {len(faces)} faces of its direct int8 step "
                  f"enrolled among {first['num_students']} students")
            int8_gemm.PRODUCTS.reset()
            r = drive_clients("raw x1 int8", server, url, tmp, "raw", frame, 1,
                              INT8_SERVER_REQUESTS, faces, enrolled)
            if int8_gemm.PRODUCTS.count != per_step * r["steps"]:
                fail(f"int8 server: {int8_gemm.PRODUCTS.count} int8 products over "
                     f"{r['steps']} steps, expected {per_step} per step")
            print_run(r)
        finally:
            stop_server(server, httpd, thread)
        del server
        torch.cuda.empty_cache()
    bf16 = next(x for x in report["serve_runs"] if x["tag"] == "raw x1")
    res["server"] = {k: r[k] for k in ("requests", "steps", "p50", "p95", "rps", "step_p50",
                                       "server_p50", "launches")}
    res["server_bf16_phase7"] = {k: bf16[k] for k in ("requests", "p50", "p95", "rps",
                                                      "step_p50")}
    print(f"[int8] server raw rgb24 x1, {r['requests']} requests: int8 p50 {r['p50']:.3f} ms, "
          f"p95 {r['p95']:.3f} ms, {r['rps']:.2f} requests/s; bf16 (phase 7) p50 "
          f"{bf16['p50']:.3f} ms, p95 {bf16['p95']:.3f} ms, {bf16['rps']:.2f} requests/s")
    report["int8"] = res


# ------------------------------------------------------------ phase 9

ENROL_STUDENTS = 8
ENROL_PHOTOS = 4
MATCH_TOP_KS = (5, 16, 64)


def onnx_initializers_bytes(tensors: dict) -> bytes:
    """A minimal ONNX ModelProto whose graph holds only initializers: per
    tensor a TensorProto with its dims (field 1), data type float32 (2),
    name (8) and little-endian raw data (9), written from the protobuf wire
    format (no onnx package). What `models/onnx_import.py` reads."""
    import numpy as np

    def varint(v):
        out = b""
        while True:
            b, v = v & 0x7F, v >> 7
            if v:
                out += bytes([b | 0x80])
            else:
                return out + bytes([b])

    def tag(field, wire):
        return varint((field << 3) | wire)

    def field(num, payload):
        return tag(num, 2) + varint(len(payload)) + payload

    parts = []
    for name, arr in tensors.items():
        arr = np.asarray(arr, np.float32)
        body = b"".join(tag(1, 0) + varint(d) for d in arr.shape)
        body += tag(2, 0) + varint(1) + field(8, name.encode()) + field(9, arr.tobytes())
        parts.append(field(5, body))
    graph = b"".join(parts)
    return tag(1, 0) + varint(7) + field(7, graph)


def seeded_unfolded_tree(arch: str, seed: int) -> dict:
    """JAX-format {'params', 'batch_stats'} of the port's unfolded `arch`,
    weights from a seed."""
    import torch

    from facerecognitionpipeline_tpu_torch.models.convert import backbone_variables_from_state
    from facerecognitionpipeline_tpu_torch.models.irse import build_backbone
    from facerecognitionpipeline_tpu_torch.models.layers import lecun_normal_

    model = build_backbone(arch, folded=False)
    lecun_normal_(model, torch.Generator().manual_seed(seed))
    return backbone_variables_from_state(model.state_dict())


def render_students(tmp: str, gate) -> list:
    """ENROL_STUDENTS directories of ENROL_PHOTOS photos. A student is one
    `render_identity_scene` face, upscaled 3x so it meets the enrolment gate
    (faces of 60 px, blur 100); the photos differ in a 40 px corner patch, as
    the JAX package's enrolment tests vary theirs. A face whose best detection
    fails the gate is drawn again. Returns the photo paths per student."""
    import cv2
    import numpy as np

    from facerecognitionpipeline_tpu_torch.train.detector_train import (
        make_identity,
        render_identity_scene,
    )

    rng = np.random.default_rng(9)
    paths, seed = [], 0
    while len(paths) < ENROL_STUDENTS:
        img, *_ = render_identity_scene([make_identity(1000 + seed)], rng, size=160)
        seed += 1
        if seed > 200:
            fail("could not render enough students that pass the enrolment gate")
        img = cv2.resize(img, (480, 480), interpolation=cv2.INTER_LINEAR)
        faces = gate.process_numpy(img)
        if not faces or not faces[0]["is_valid"] or \
                faces[0]["quality_metrics"]["blur_score"] < 120:
            continue
        d = os.path.join(tmp, "enrol", f"student_{len(paths)}")
        os.makedirs(d)
        mine = []
        for i in range(ENROL_PHOTOS):
            photo = img.copy()
            photo[:40, :40] = rng.integers(0, 256, (40, 40, 3))
            mine.append(os.path.join(d, f"photo_{i}.png"))
            cv2.imwrite(mine[-1], cv2.cvtColor(photo, cv2.COLOR_RGB2BGR))
        paths.append(mine)
    return paths


def run_cli(main, argv) -> tuple[int, str]:
    """A CLI's main(argv) with its standard output captured."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def enrolment_phase(ctx, gal, report) -> None:
    """Phase 9: enrolment and offline matching with the weight formats users
    have. Seeded ir_101 weights written as an AdaFace Lightning .ckpt (the
    port's save_adaface_checkpoint) and as a JAX-format .npz, seeded
    iresnet_100 weights as an ArcFace .onnx; students rendered and enrolled
    through cli/enroll_students on the card; face_matcher --single_image;
    the .onnx embedder on the card against the CPU; FaceMatcher against
    1 048 576 identities, bf16 (K3) then int8 (K4), at top_k 5, 16 and 64;
    the engine with gallery_impl='streaming' on a float32 gallery (K3 on
    float32 rows)."""
    import re as _re
    import shutil

    import numpy as np
    import torch

    from facerecognitionpipeline_tpu_torch.cli import enroll_students, face_matcher
    from facerecognitionpipeline_tpu_torch.gallery.manager import GalleryManager, StudentRecord
    from facerecognitionpipeline_tpu_torch.models import detector as detector_module
    from facerecognitionpipeline_tpu_torch.models.detector import MTCNNDetector
    from facerecognitionpipeline_tpu_torch.models.torch_export import (
        export_iresnet_statedict,
        save_adaface_checkpoint,
    )
    from facerecognitionpipeline_tpu_torch.ops import crop_kernel, gallery_kernel, warp_kernel
    from facerecognitionpipeline_tpu_torch.pipeline.embedder import FaceEmbedder
    from facerecognitionpipeline_tpu_torch.pipeline.engine import RecognitionEngine
    from facerecognitionpipeline_tpu_torch.pipeline.enrollment import ENROLLMENT_QUALITY_CONFIG
    from facerecognitionpipeline_tpu_torch.pipeline.matcher import FaceMatcher
    from facerecognitionpipeline_tpu_torch.pipeline.processor import FaceProcessor
    from facerecognitionpipeline_tpu_torch.utils.io import save_npz_variables

    t_phase = time.perf_counter()
    res = {}
    det_path = os.path.join(REPO, "pretrained", "mtcnn_synthetic.npz")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_enrol_")
    try:
        # 9a: the weight files
        t0 = time.perf_counter()
        tree = seeded_unfolded_tree(ARCH, 9)
        ckpt = os.path.join(tmp, "adaface_ir101.ckpt")
        save_adaface_checkpoint(tree, ARCH, ckpt)
        npz = os.path.join(tmp, "ir101.npz")
        save_npz_variables(npz, tree)
        del tree
        isd = export_iresnet_statedict(seeded_unfolded_tree("iresnet_100", 10), "iresnet_100")
        onnx = os.path.join(tmp, "arcface_ir101.onnx")
        with open(onnx, "wb") as f:
            f.write(onnx_initializers_bytes(
                {k: v for k, v in isd.items() if not k.endswith("num_batches_tracked")}))
        del isd
        mb = {p: os.path.getsize(p) / 2**20 for p in (ckpt, npz, onnx)}
        print(f"[enrol] weights written in {time.perf_counter() - t0:.1f} s: AdaFace .ckpt "
              f"{mb[ckpt]:.0f} MiB, .npz {mb[npz]:.0f} MiB, ArcFace .onnx {mb[onnx]:.0f} MiB")

        # 9b: the students, through a bf16 processor (K1 crops) on the card
        gate = FaceProcessor(
            output_size=224, quality_filter_config=dict(ENROLLMENT_QUALITY_CONFIG),
            detector=MTCNNDetector(weights_path=det_path, dtype=torch.bfloat16, device=DEVICE),
            device=DEVICE,
        )
        if gate.detector.crop_impl != "kernel":
            fail("a bf16 cascade must take the K1 crop")
        photos = render_students(tmp, gate)
        flat = [p for mine in photos for p in mine]
        for c in (crop_kernel.LAUNCHES, warp_kernel.LAUNCHES):
            c.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for p in flat:
            if not gate.process_image(p):
                fail(f"the bf16 processor found no face in {p}")
        torch.cuda.synchronize()
        res["process_image_per_s"] = len(flat) / (time.perf_counter() - t0)
        res["launches_k1"] = crop_kernel.LAUNCHES.count
        if res["launches_k1"] != 2 * len(flat) or warp_kernel.LAUNCHES.count:
            fail(f"the bf16 processor launched K1 {res['launches_k1']} times for "
                 f"{len(flat)} images (want 2 each) and K2 {warp_kernel.LAUNCHES.count}")
        print(f"[enrol] {len(flat)} photos of {ENROL_STUDENTS} students through "
              f"FaceProcessor.process_image (bf16 cascade, 640x640): "
              f"{res['process_image_per_s']:.2f} images/s; K1 launched {res['launches_k1']} "
              f"times (R-net and O-net crops of each detect)")

        # 9c: enrol through the CLI, from the .ckpt and from the .npz. The CLI
        # has no detector flag: its processor takes the first default weights
        # file, which here is set to the synthetic cascade.
        galleries = {}
        saved = detector_module.DEFAULT_DETECTOR_WEIGHTS
        detector_module.DEFAULT_DETECTOR_WEIGHTS = (det_path,)
        try:
            for name, path in (("ckpt", ckpt), ("npz", npz)):
                gpath = os.path.join(tmp, f"gallery_{name}", "students.pkl")
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                rc, out = run_cli(enroll_students.main, [
                    "--enrollment_dir", os.path.join(tmp, "enrol"), "--gallery_path", gpath,
                    "--model_path", path, "--architecture", ARCH, "--augmentations", "1",
                    "--device", DEVICE])
                secs = time.perf_counter() - t0
                summary = [ln for ln in out.splitlines()
                           if ln.startswith(("ENROLLMENT SUMMARY", "Verification"))]
                if rc != 0 or not summary:
                    fail(f"enroll_students --model_path {name} failed:\n{out[-3000:]}")
                print(f"[enrol] enroll_students --model_path .{name}: {secs:.1f} s "
                      f"({secs / ENROL_STUDENTS:.2f} s per student, the {ARCH} load and the "
                      f"detector build included); " + "; ".join(summary))
                res[f"enrol_s_per_student_{name}"] = secs / ENROL_STUDENTS
                galleries[name] = GalleryManager(gpath, verbose=False, device=DEVICE)
        finally:
            detector_module.DEFAULT_DETECTOR_WEIGHTS = saved
        a, b = (g.get_all_students() for g in (galleries["ckpt"], galleries["npz"]))
        want_ids = [f"STU{i + 1:04d}" for i in range(ENROL_STUDENTS)]
        if sorted(a) != want_ids or sorted(b) != want_ids:
            fail(f"enrolled ids {sorted(a)} / {sorted(b)}, expected {want_ids}")
        err = max(float(np.abs(a[s].template_embedding - b[s].template_embedding).max())
                  for s in a)
        names = {s: a[s].name for s in a}
        if err > 1e-5 or any(a[s].name != b[s].name for s in a):
            fail(f"the .ckpt and .npz galleries differ: max |template diff| {err}")
        res["ckpt_vs_npz_template_err"] = err
        print(f"[enrol] the .ckpt and .npz galleries agree: {len(a)} students, same names, "
              f"max |template difference| {err:.3g} (limit 1e-5)")

        # 9d: face_matcher --single_image re-detects enrolment photos (the CLI
        # for two students, the same FaceMatcher build for all of them)
        pattern = _re.compile(r"Face 1: Recognized: (\S+) \((STU\d{4})\) - ([0-9.]+)")
        gpath = galleries["ckpt"].gallery_path
        for s in (0, ENROL_STUDENTS - 1):
            rc, out = run_cli(face_matcher.main, [
                "--single_image", photos[s][1], "--gallery_path", gpath, "--model_path", ckpt,
                "--architecture", ARCH, "--detector_weights", det_path, "--top_k", "3",
                "--device", DEVICE])
            m = pattern.search(out)
            if rc != 0 or not m or m.group(2) != want_ids[s] or float(m.group(3)) <= 0.99:
                fail(f"face_matcher --single_image on student {s}: {out[-2000:]}")
            print(f"[match] face_matcher --single_image {os.path.basename(photos[s][1])} of "
                  f"student_{s}: {m.group(0)}")
        embedder = FaceEmbedder(ARCH, model_path=ckpt, device=DEVICE)
        matcher = FaceMatcher(embedder=embedder, gallery=galleries["ckpt"],
                              detector_weights=det_path, device=DEVICE)
        confidences, crops = [], []
        for s in range(ENROL_STUDENTS):
            r = matcher.match_single_image(photos[s][2], top_k=3, save_visualization=False)
            top = r["matches"][0]["top_matches"][0] if r["num_faces"] else {}
            if top.get("student_id") != want_ids[s] or top.get("score", 0) <= 0.99:
                fail(f"student_{s} came back as {top} from its own photo")
            confidences.append(top["score"])
            crops.append(matcher._get_processor().process_image(photos[s][2])[0]["aligned_face"])
        res["single_image_min_confidence"] = min(confidences)
        print(f"[match] all {ENROL_STUDENTS} students top-1 from their own photos "
              f"(min confidence {min(confidences):.5f}, limit 0.99)")

        # 9e: the ArcFace .onnx embedder, card against CPU
        t0 = time.perf_counter()
        e_card = FaceEmbedder(ARCH, model_type="arcface", model_path=onnx, device=DEVICE)
        e_cpu = FaceEmbedder(ARCH, model_type="arcface", model_path=onnx, device="cpu")
        if e_card._build_arch != "iresnet_100":
            fail(f"an ArcFace .onnx must build iresnet_100, got {e_card._build_arch}")
        x_card = e_card.extract_embeddings_batch(crops)
        x_cpu = e_cpu.extract_embeddings_batch(crops)
        err = float(np.abs(x_card - x_cpu).max())
        cos = float(np.sum(x_card * x_cpu, axis=1).min())
        res["onnx_card_vs_cpu_err"] = err
        if not np.isfinite(x_card).all() or err > 1e-4:
            fail(f"the .onnx embedder on the card and on the CPU differ by {err}")
        print(f"[enrol] ArcFace .onnx (iresnet_100) embeddings of {len(crops)} crops: card "
              f"against CPU max |difference| {err:.3g} (limit 1e-4: float32 sums in "
              f"other orders), min cosine {cos:.7f}; both built and run in "
              f"{time.perf_counter() - t0:.1f} s")
        del e_card, e_cpu

        # 9f: the matcher against 1 048 576 identities, bf16 then int8
        queries = embedder.extract_embeddings_batch(crops)
        big = gal.shape[0]
        others = gal[: big - ENROL_STUDENTS].cpu().numpy()
        now = "2026-01-01T00:00:00"
        enrolled = galleries["ckpt"].get_all_students()
        records = {
            f"id{i}": StudentRecord(f"id{i}", f"Identity {i}", others[i:i + 1], others[i],
                                    1, now, now)
            for i in range(len(others))
        }
        records.update(enrolled)
        counters = {"gallery_topk": gallery_kernel.LAUNCHES,
                    "gallery_topk_int8": gallery_kernel.LAUNCHES_INT8}
        res["matcher_launches"] = {}
        for quantize, kernel, floor in ((None, "gallery_topk", 0.99),
                                        ("int8", "gallery_topk_int8", 0.98)):
            label = quantize or "bf16"
            gm = GalleryManager(os.path.join(tmp, f"big_{label}.pkl"), verbose=False,
                                device=DEVICE, quantize=quantize)
            gm.students = dict(records)
            gm._dirty = True
            t0 = time.perf_counter()
            _, v, ids = gm.device_snapshot()
            torch.cuda.synchronize()
            compact = gm._device.snapshot()[3]
            print(f"[match {label}] {len(ids)} identities ({ENROL_STUDENTS} enrolled, the rest "
                  f"seeded) on the card in {time.perf_counter() - t0:.1f} s")
            m = FaceMatcher(embedder=embedder, gallery=gm, device=DEVICE)
            launches = 0
            for k in MATCH_TOP_KS:
                for c in counters.values():
                    c.reset()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = m.match_faces_batch(crops, top_k=k)
                ms = 1e3 * (time.perf_counter() - t0)
                n = {name: c.count for name, c in counters.items()}
                launches += n[kernel]
                if n[kernel] != 1 or sum(n.values()) != 1:
                    fail(f"{label} k={k}: one search launched {n}")
                if [r[0][0] for r in got] != want_ids or min(r[0][2] for r in got) <= floor:
                    fail(f"{label} k={k}: enrolled students did not come back top-1: "
                         f"{[r[0] for r in got]}")
                # the same compact rows through the plain version
                q = torch.from_numpy(queries).to(DEVICE)
                if quantize:
                    pv, pi = gallery_kernel.streaming_cosine_topk_int8_plain(
                        q, compact[0], compact[1], v, top_k=k, chunk=STREAM_CHUNK)
                else:
                    pv, pi = gallery_kernel.streaming_cosine_topk_plain(
                        q, compact, v, top_k=k, chunk=STREAM_CHUNK)
                pv, pi = pv.cpu().numpy(), pi.cpu().numpy()
                sv = np.array([[x[2] for x in r] for r in got], np.float32)
                si = [[x[0] for x in r] for r in got]
                err = float(np.abs(sv - pv).max())
                tol = 0.0 if quantize else K3_TOL
                clear = np.ones(pv.shape, bool)
                gap = np.abs(pv[:, :-1] - pv[:, 1:]) > 2 * max(tol, 1e-7)
                clear[:, :-1] &= gap
                clear[:, 1:] &= gap
                same = all(si[r][j] == ids[pi[r, j]] for r, j in zip(*np.nonzero(clear)))
                if err > tol or not same:
                    fail(f"{label} k={k}: the matcher differs from the plain version "
                         f"(max |score difference| {err}, ids equal on clear slots: {same})")
                print(f"[match {label}] match_faces_batch of {len(crops)} crops, top_k={k}: "
                      f"{ms:.1f} ms host clock (embed, one search, results); "
                      f"{kernel} launched once; enrolled students top-1 (min "
                      f"{min(r[0][2] for r in got):.5f}); equal to the plain version on the "
                      f"same compact rows (max |score difference| {err:.3g}, ids equal on "
                      f"{int(clear.sum())}/{clear.size} clear slots)")
            res["matcher_launches"][kernel] = launches
            del gm, m, compact, v, ids
            torch.cuda.empty_cache()

        # 9g: gallery_impl='streaming' on a float32 gallery: K3 on float32 rows
        eng = RecognitionEngine(ctx["detector"], ctx["embedder"], top_k=3,
                                gallery_impl="streaming", gallery_chunk=128)
        dense = ctx["engine"]
        rng = np.random.default_rng(3)
        small = rng.normal(size=(GALLERY_ROWS, 512)).astype(np.float32)
        small /= np.linalg.norm(small, axis=1, keepdims=True)
        emb = ctx["emb"].cpu().numpy()
        slots = ctx["slots"]
        for i, (f, s) in enumerate(slots):
            small[7 + 97 * i] = emb[f, s]
        t = torch.from_numpy(small).to(DEVICE)
        vv = torch.ones(GALLERY_ROWS, dtype=torch.bool, device=DEVICE)
        want = dense.process_frames(ctx["frames"], t, vv)
        gallery_kernel.LAUNCHES_F32.reset()
        steps = 3
        for _ in range(steps):
            got = eng.process_frames(ctx["frames"], t, vv)
        torch.cuda.synchronize()
        res["matcher_launches"]["gallery_topk_f32"] = gallery_kernel.LAUNCHES_F32.count
        if gallery_kernel.LAUNCHES_F32.count != steps:
            fail(f"gallery_impl='streaming' on float32 rows launched K3-f32 "
                 f"{gallery_kernel.LAUNCHES_F32.count} times in {steps} steps")
        fv = got["face_valid"].cpu().numpy()
        gs, ws = got["match_scores"].cpu().numpy(), want["match_scores"].cpu().numpy()
        gi, wi = got["match_idx"].cpu().numpy(), want["match_idx"].cpu().numpy()
        err = float(np.abs(gs[fv] - ws[fv]).max())
        gap = np.abs(ws[..., :-1] - ws[..., 1:]) > 1e-5
        clear = fv[..., None] & np.concatenate([gap, np.ones_like(gap[..., :1])], -1) & \
            np.concatenate([np.ones_like(gap[..., :1]), gap], -1)
        if err > 1e-5 or not np.array_equal(gi[clear], wi[clear]):
            fail(f"the streaming float32 step differs from the dense step ({err})")
        for i, (f, s) in enumerate(slots):
            if gi[f, s, 0] != 7 + 97 * i:
                fail("the streaming float32 step lost a planted row")
        print(f"[match f32] the step with gallery_impl='streaming' on a {GALLERY_ROWS}-row "
              f"float32 gallery: K3 on float32 rows launched once per step ({steps} steps), "
              f"scores within {err:.3g} of the dense step (limit 1e-5), planted rows top-1")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    res["seconds"] = time.perf_counter() - t_phase
    print(f"[enrol] phase 9 took {res['seconds']:.1f} s")
    report["enrol"] = res



# ------------------------------------------------------------ phase 10

# the classroom dataset: a large lecture's roster
OFFLINE_ENROLLED = 48
OFFLINE_VISITORS = 48
OFFLINE_FEW_SHOT = 5
OFFLINE_SESSIONS = 4  # probe photos per enrolled identity, one per session
OFFLINE_ANGLES = ("center", "center", "left", "right")  # per session
OFFLINE_TOP_K = 5
EVAL_TOL = 1e-5
SCORER_SHAPE = (4096, 10000, 5)  # probes, identities, embeddings per identity
STRESS_RUN = ("baseline", "crowded", "occlusion", "hard_negatives")
STRESS_SCENES = 6


def offline_name(prefix: str, i: int) -> str:
    """'Student_AB': letters only after the prefix, so the corpus's name
    rule (split at the first numeric part) gives the name back."""
    return f"{prefix}_{chr(65 + i // 26)}{chr(65 + i % 26)}"


def render_offline_dataset(tmp: str) -> tuple:
    """The classroom dataset: for each enrolled identity a one-shot photo,
    OFFLINE_FEW_SHOT few-shot photos (dataset/enrollment/{one-shot,few-shot}/
    <name>/) and one photo per session (raw/<session>/<angle>/<name>.png);
    each visitor once in one session. Every photo is its own
    `render_identity_scene` of the identity at 160 px, upscaled 3x."""
    import cv2
    import numpy as np

    from facerecognitionpipeline_tpu_torch.train.detector_train import (
        make_identity,
        render_identity_scene,
    )

    rng = np.random.default_rng(10)
    count = 0

    def photo(path, seed):
        nonlocal count
        img, *_ = render_identity_scene([make_identity(seed)], rng, size=160)
        img = cv2.resize(img, (480, 480), interpolation=cv2.INTER_LINEAR)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        cv2.imwrite(path, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        count += 1

    enrolled = [offline_name("Student", i) for i in range(OFFLINE_ENROLLED)]
    visitors = [offline_name("Visitor", i) for i in range(OFFLINE_VISITORS)]
    for i, name in enumerate(enrolled):
        photo(os.path.join(tmp, "dataset", "enrollment", "one-shot", name, "photo_0.png"),
              2000 + i)
        for j in range(OFFLINE_FEW_SHOT):
            photo(os.path.join(tmp, "dataset", "enrollment", "few-shot", name,
                               f"photo_{j}.png"), 2000 + i)
        for s in range(OFFLINE_SESSIONS):
            photo(os.path.join(tmp, "raw", f"{s + 1:02d}", OFFLINE_ANGLES[s], f"{name}.png"),
                  2000 + i)
    for i, name in enumerate(visitors):
        s = i % OFFLINE_SESSIONS
        photo(os.path.join(tmp, "raw", f"{s + 1:02d}", OFFLINE_ANGLES[s], f"{name}.png"),
              3000 + i)
    return enrolled, visitors, count


def probe_score_matrix(gallery: dict, probes: dict, aggregation: str):
    """The [P, I] score matrix an identification run computes, on the CPU,
    with the true identity index of every probe (-1 when not enrolled)."""
    import numpy as np

    from facerecognitionpipeline_tpu_torch.evalharness.identification import _score_probes
    from facerecognitionpipeline_tpu_torch.evalharness.metrics import pack_gallery

    names, packed, mask = pack_gallery(gallery, "cpu")
    data = probes.get("all", probes)
    rows, truth = [], []
    for name, d in data.items():
        for e in np.atleast_2d(np.asarray(d["embeddings"], np.float32)):
            rows.append(e)
            truth.append(names.index(name) if name in names else -1)
    return _score_probes(np.stack(rows), packed, mask, aggregation, 3), np.array(truth)


def near_decisions(scores, truth, thresholds) -> int:
    """Probes whose decision a last-bit difference in a score may flip: the
    best score within EVAL_TOL of a threshold or of the runner-up, or the
    true identity's score within EVAL_TOL of another identity's."""
    import numpy as np

    top = np.sort(scores, axis=1)[:, ::-1]
    near = np.abs(top[:, :1] - np.asarray(thresholds)[None, :]).min(axis=1) < EVAL_TOL
    if scores.shape[1] > 1:
        near |= top[:, 0] - top[:, 1] < EVAL_TOL
        t = scores[np.arange(len(truth)), np.clip(truth, 0, None)]
        close = np.abs(scores - t[:, None]) < EVAL_TOL
        close[np.arange(len(truth)), np.clip(truth, 0, None)] = False
        near |= (truth >= 0) & close.any(axis=1)
    return int(near.sum())


def close_pairs(values) -> int:
    """Adjacent pairs of sorted values within EVAL_TOL (an ROC curve's order
    can swap there)."""
    import numpy as np

    v = np.sort(np.asarray(values, np.float64))
    return int((np.diff(v) < EVAL_TOL).sum())


def compare_results(tag, got, want, n, near, pairs) -> float:
    """One evaluation result on the card against the CPU's: score lists
    within EVAL_TOL; threshold-table counts within `near` probes and rates
    within near / n; bootstrap CIs within EVAL_TOL; ROC-AUC, AP, d' and EER
    within EVAL_TOL plus what `near` decisions and `pairs` close pairs may
    move. Returns the largest score difference."""
    import numpy as np

    err = 0.0
    for key in ("genuine_scores", "impostor_scores"):
        if key in want:
            a, b = np.asarray(got[key]), np.asarray(want[key])
            if a.shape != b.shape:
                fail(f"{tag}: {key} has {a.shape} against {b.shape} on the CPU")
            if a.size:
                err = max(err, float(np.abs(a - b).max()))
    for p, q in zip(got.get("all_predictions", []), want.get("all_predictions", [])):
        err = max(err, abs(p["score"] - q["score"]))
    if err > EVAL_TOL:
        fail(f"{tag}: scores differ from the CPU's by {err} (limit {EVAL_TOL})")
    slack = EVAL_TOL + near / max(n, 1)
    gd, wd = got["threshold_results"], want["threshold_results"]
    if list(gd.columns) != list(wd.columns) or len(gd) != len(wd):
        fail(f"{tag}: threshold tables of different shapes")
    for col in wd.columns:
        a, b = gd[col].to_numpy(np.float64), wd[col].to_numpy(np.float64)
        limit = near if col in ("tp", "fp", "fn", "tn") else slack
        if np.abs(a - b).max() > limit:
            fail(f"{tag}: threshold table column {col} differs by {np.abs(a - b).max()} "
                 f"(limit {limit}, {near} near decisions)")
    for key in ("genuine_ci", "impostor_ci"):
        if key in want and max(abs(x - y) for x, y in zip(got[key], want[key])) > EVAL_TOL:
            fail(f"{tag}: {key} {got[key]} against {want[key]} on the CPU")
    for key in ("roc_auc", "average_precision", "dprime", "eer", "separation",
                "tar_at_far_0.01", "mean_impostor_score"):
        if key not in want or want[key] is None or got[key] is None:
            if key in want and (want[key] is None) != (got[key] is None):
                fail(f"{tag}: {key} defined on one device only")
            continue
        limit = slack + pairs / max(n, 1) + EVAL_TOL * abs(want[key])
        if abs(got[key] - want[key]) > limit:
            fail(f"{tag}: {key} {got[key]} against {want[key]} on the CPU (limit {limit})")
    return err


def compare_evaluations(card: dict, cpu: dict, corpus: dict, thresholds) -> dict:
    """evaluate_model on the card against the CPU, result by result."""
    import numpy as np

    probes, negatives = corpus["probe_positive"], corpus["probe_negative"]
    seg = corpus["probe_positive_segmented"]
    worst, n_results, n_near = 0.0, 0, 0
    for gname, gallery in corpus["galleries"].items():
        for agg in card["basic_probe"][gname]:
            scores, truth = probe_score_matrix(gallery, probes, agg)
            near = near_decisions(scores, truth, thresholds)
            pairs = close_pairs(scores.max(axis=1))
            worst = max(worst, compare_results(
                f"basic_probe {gname} {agg}", card["basic_probe"][gname][agg],
                cpu["basic_probe"][gname][agg], len(truth), near, pairs))
            n_near += near
            n_results += 1
            if gname in card["impostor"]:
                neg, _ = probe_score_matrix(
                    gallery, {n: d for n, d in negatives.items() if len(d["embeddings"])},
                    agg)
                best = neg.max(axis=1)
                near_i = int((np.abs(best[:, None] - np.asarray(thresholds)[None, :])
                              .min(axis=1) < EVAL_TOL).sum())
                worst = max(worst, compare_results(
                    f"impostor {gname} {agg}", card["impostor"][gname][agg],
                    cpu["impostor"][gname][agg], len(best), near_i, 0))
                genuine = scores[np.arange(len(truth)), np.clip(truth, 0, None)][truth >= 0]
                both = np.r_[genuine, best]
                near_v = int((np.abs(both[:, None] - np.asarray(thresholds)[None, :])
                              .min(axis=1) < EVAL_TOL).sum())
                worst = max(worst, compare_results(
                    f"verification {gname} {agg}", card["verification"][gname][agg],
                    cpu["verification"][gname][agg], min(len(genuine), len(best)), near_v,
                    close_pairs(both)))
                n_near += near_i + near_v
                n_results += 2
        for segment, res in card["segmented"].get(gname, {}).items():
            scores, truth = probe_score_matrix(gallery, {"all": seg[segment]}, "mean")
            near = near_decisions(scores, truth, thresholds)
            worst = max(worst, compare_results(
                f"segmented {gname} {segment}", res, cpu["segmented"][gname][segment],
                len(truth), near, close_pairs(scores.max(axis=1))))
            n_near += near
            n_results += 1
    return {"results_compared": n_results, "max_score_err": worst, "near_decisions": n_near}


def scorer_alone(res: dict) -> None:
    """identity_scores_batch at SCORER_SHAPE x 512 on the card: within
    EVAL_TOL of the same function in float64, timed beside its bound (the
    larger of the float32 operations over the CUDA cores' peak, TF32 off,
    and the bytes of its inputs and output over the memory rate)."""
    import torch

    from facerecognitionpipeline_tpu_torch.evalharness.metrics import identity_scores_batch

    p, i, m = SCORER_SHAPE
    d = 512
    g = torch.Generator(device=DEVICE).manual_seed(10)
    probes = torch.randn((p, d), generator=g, device=DEVICE)
    gallery = torch.randn((i, m, d), generator=g, device=DEVICE)
    gallery /= torch.linalg.vector_norm(gallery, dim=2, keepdim=True)
    mask = torch.arange(m, device=DEVICE)[None, :] <= (torch.arange(i, device=DEVICE) % m)[:, None]
    gallery *= mask[..., None]  # identity j holds 1 + j % 5 embeddings
    flops = 2.0 * p * i * m * d
    nbytes = 4.0 * (p * d + i * m * d + p * i) + i * m
    bound = max(flops / F32_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
    res["scorer"] = {"shape": [p, i, m, d], "bound_ms": bound,
                     "bound_by": "operations" if flops / F32_FLOPS_PER_S >
                     nbytes / HBM_BYTES_PER_S else "bytes"}
    g64 = gallery.double()
    for agg in ("max", "mean", "topk"):
        out = identity_scores_batch(probes, gallery, mask, agg, 3)
        ref = identity_scores_batch(probes.double(), g64, mask, agg, 3, dtype=torch.float64)
        err = float((out.double() - ref).abs().max())
        if not torch.isfinite(out).all() or out.shape != (p, i) or err > EVAL_TOL:
            fail(f"identity_scores_batch ({agg}) at {p}x{i}x{m}x{d} is {err} from float64")
        del out, ref
        ms = cuda_time_ms(lambda: identity_scores_batch(probes, gallery, mask, agg, 3),
                          iters=5, warmup=1)
        res["scorer"][agg] = {"ms": ms, "max_abs_err_vs_f64": err}
        print(f"[offline] identity_scores_batch {agg} at {p} probes x {i} identities x {m} x "
              f"{d}: {ms:.3f} ms (bound {bound:.3f} ms by {res['scorer']['bound_by']}), "
              f"max |float32 - float64| {err:.3g} (limit {EVAL_TOL})")
    del probes, gallery, g64, mask
    torch.cuda.empty_cache()


def offline_phase(gal, report) -> None:
    """Phase 10: the offline dataset and evaluation path through its CLIs on
    the card (dataset_preprocessor, segment_dataset, embedding_generator,
    probe_labeler, evaluate_models), the labeler against 1 048 576
    identities (bf16 then int8), the evaluation on the card against the CPU,
    the device scorer alone at a large shape, and the detector stress
    suite."""
    import pickle
    import shutil

    import numpy as np
    import torch

    from facerecognitionpipeline_tpu_torch.cli import (
        dataset_preprocessor,
        embedding_generator,
        evaluate_models,
        lfw_impostor_helper,
        probe_labeler,
        segment_dataset,
    )
    from facerecognitionpipeline_tpu_torch.evalharness.detection import run_stress_suite
    from facerecognitionpipeline_tpu_torch.evalharness.pipeline import (
        DEFAULT_THRESHOLDS,
        evaluate_model,
        load_model_corpus,
    )
    from facerecognitionpipeline_tpu_torch.gallery.manager import GalleryManager, StudentRecord
    from facerecognitionpipeline_tpu_torch.models.detector import MTCNNDetector
    from facerecognitionpipeline_tpu_torch.ops import crop_kernel, gallery_kernel, warp_kernel
    from facerecognitionpipeline_tpu_torch.pipeline.embedder import FaceEmbedder
    from facerecognitionpipeline_tpu_torch.pipeline.labeling import ProbeLabeler
    from facerecognitionpipeline_tpu_torch.utils.io import (
        imread_rgb,
        list_images,
        save_npz_variables,
    )
    from facerecognitionpipeline_tpu_torch.utils.xlsx import read_xlsx_rows

    t_phase = time.perf_counter()
    res = {"launches": {"crop_resize": 0, "warp_patches": 0, "gallery_topk": 0,
                        "gallery_topk_int8": 0, "gallery_topk_f32": 0}}
    counters = {"crop_resize": crop_kernel.LAUNCHES, "warp_patches": warp_kernel.LAUNCHES,
                "gallery_topk": gallery_kernel.LAUNCHES,
                "gallery_topk_int8": gallery_kernel.LAUNCHES_INT8,
                "gallery_topk_f32": gallery_kernel.LAUNCHES_F32}

    def reset():
        for c in counters.values():
            c.reset()
        torch.cuda.synchronize()

    def read():
        torch.cuda.synchronize()
        n = {k: c.count for k, c in counters.items()}
        for k, v in n.items():
            res["launches"][k] += v
        return n

    det_path = os.path.join(REPO, "pretrained", "mtcnn_synthetic.npz")
    det_flags = ["--detector_weights", det_path, "--detector_dtype", "bfloat16",
                 "--device", DEVICE]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_offline_")
    try:
        t0 = time.perf_counter()
        enrolled, visitors, n_photos = render_offline_dataset(tmp)
        weights = os.path.join(tmp, "ir101.npz")
        save_npz_variables(weights, seeded_unfolded_tree(ARCH, 10))
        print(f"[offline] {n_photos} photos of {len(enrolled)} enrolled identities and "
              f"{len(visitors)} visitors rendered, seeded {ARCH} weights written, in "
              f"{time.perf_counter() - t0:.1f} s")
        raw, prep, out = (os.path.join(tmp, d) for d in ("raw", "prep", "out"))
        meta_path = os.path.join(prep, "probe_positive_metadata.json")
        crops_dir = os.path.join(prep, "probe_positive")

        # 10a: dataset_preprocessor, bf16 cascade (K1 twice per photo)
        n_raw = sum(len(list_images(os.path.join(raw, s, a)))
                    for s in os.listdir(raw) for a in os.listdir(os.path.join(raw, s)))
        reset()
        t0 = time.perf_counter()
        rc, log = run_cli(dataset_preprocessor.main,
                          ["--input_dir", raw, "--output_dir", prep] + det_flags)
        secs = time.perf_counter() - t0
        n = read()
        with open(meta_path) as f:
            meta = json.load(f)
        first = [e for e in meta if e["face_index"] == 0]  # one per photo with a face
        if rc != 0 or n["crop_resize"] != 2 * n_raw or n["warp_patches"]:
            fail(f"dataset_preprocessor: rc {rc}, launches {n} for {n_raw} photos "
                 f"(want K1 twice each):\n{log[-2000:]}")
        if len(first) < 0.95 * n_raw:
            fail(f"dataset_preprocessor found a face in {len(first)} of {n_raw} photos")
        res["preprocess_images_per_s"] = n_raw / secs
        print(f"[offline] dataset_preprocessor: {n_raw} photos in {secs:.1f} s "
              f"({res['preprocess_images_per_s']:.2f} images/s, the detector build "
              f"included), {len(meta)} crops, a face in {len(first)} photos; K1 launched "
              f"{n['crop_resize']} times")

        # 10b: the reviewed labels (what label_rename_utility fixes by hand
        # comes from the photos' names here), visitors half as an LFW-style
        # tree sampled by lfw_impostor_helper, half as real impostors
        positive = os.path.join(out, "probe_labeled", "positive")
        negative = os.path.join(out, "probe_labeled", "negative")
        lfw_tree = os.path.join(tmp, "lfw")
        for d in (positive, negative):
            os.makedirs(d)
        truth = {e["filename"]: e["source_image"][:-4] for e in meta if e["face_index"] == 0}
        for fname, who in truth.items():
            src = os.path.join(crops_dir, fname)
            if who in enrolled:
                shutil.copy(src, os.path.join(positive, f"{who}_{fname}"))
            elif visitors.index(who) % 2:
                shutil.copy(src, os.path.join(negative, f"{who}_{fname}"))
            else:
                os.makedirs(os.path.join(lfw_tree, who))
                shutil.copy(src, os.path.join(lfw_tree, who, fname))
        n_lfw = len(os.listdir(lfw_tree))
        rc, log = run_cli(lfw_impostor_helper.main, [
            "--lfw_dir", lfw_tree, "--output_dir", negative, "--num_identities", str(n_lfw)])
        if rc != 0 or len([f for f in os.listdir(negative) if f.startswith("lfw_")]) != n_lfw:
            fail(f"lfw_impostor_helper: {log[-1000:]}")

        # 10c: segment_dataset over the reviewed positives
        rc, log = run_cli(segment_dataset.main, [
            "--input_dir", positive, "--metadata_file", meta_path, "--output_dir",
            os.path.join(out, "probe_labeled", "segmented"), "--device", DEVICE])
        done = [ln for ln in log.splitlines() if ln.startswith("SEGMENTATION COMPLETE")]
        if rc != 0 or not done:
            fail(f"segment_dataset: {log[-2000:]}")
        print(f"[offline] segment_dataset: {done[0]}")

        # 10d: embedding_generator (K1 twice per gallery photo, base and
        # augmented passes)
        model = f"adaface_{ARCH}"
        emb_dir = os.path.join(out, "embeddings", model)
        n_gallery = 2 * len(enrolled) * (1 + OFFLINE_FEW_SHOT)
        reset()
        t0 = time.perf_counter()
        rc, log = run_cli(embedding_generator.main, [
            "--dataset_root", os.path.join(tmp, "dataset"), "--output_root", out,
            "--model_type", "adaface", "--architecture", ARCH, "--model_path", weights,
        ] + det_flags)
        secs = time.perf_counter() - t0
        n = read()
        if rc != 0 or n["crop_resize"] != 2 * n_gallery:
            fail(f"embedding_generator: rc {rc}, launches {n} for {n_gallery} gallery "
                 f"photos (want K1 twice each):\n{log[-2000:]}")
        stems = ["gallery_one-shot_base", "gallery_one-shot_augmented",
                 "gallery_few-shot_base", "gallery_few-shot_augmented",
                 "probe_positive_unsegmented", "probe_positive_segmented", "probe_negative"]
        artifacts = {}
        for stem in stems:
            with open(os.path.join(emb_dir, f"{stem}.pkl"), "rb") as f:
                artifacts[stem] = pickle.load(f)
            with open(os.path.join(emb_dir, f"{stem}.json")) as f:
                json.load(f)
        with open(os.path.join(emb_dir, "generation_summary.json")) as f:
            summary = json.load(f)
        n_probe_embs = 0
        for stem, blob in artifacts.items():
            groups = blob.values() if stem.startswith(("gallery", "probe_negative")) else \
                [d for cat in blob.values() for d in cat.values()]
            for d in groups:
                e = np.asarray(d["embeddings"])
                if len(e) and (e.dtype != np.float32 or e.shape[1] != 512
                               or not np.isfinite(e).all()):
                    fail(f"{stem}: embeddings {e.dtype} {e.shape}")
                if stem.startswith("probe"):
                    n_probe_embs += len(e)
        want = {"one_shot_base_persons": len(enrolled), "few_shot_base_persons": len(enrolled),
                "one_shot_augmented_persons": len(enrolled),
                "few_shot_augmented_persons": len(enrolled)}
        if summary["gallery"] != want or artifacts["gallery_few-shot_augmented"][
                enrolled[0]]["embeddings"].shape[0] != 8 * OFFLINE_FEW_SHOT:
            fail(f"embedding_generator galleries: {summary['gallery']}")
        res["corpus_images_per_s"] = (n_gallery + n_probe_embs) / secs
        print(f"[offline] embedding_generator: {n_gallery} gallery photos (detect, align, "
              f"embed; x8 augmented) and {n_probe_embs} probe crops in {secs:.1f} s "
              f"({res['corpus_images_per_s']:.2f} images/s, the {ARCH} load included); "
              f"K1 launched {n['crop_resize']} times; 7 pickles with their JSON twins and "
              f"generation_summary.json: {summary['probe_negative']}, segmented "
              f"{summary['probe_positive']['segmented_categories']}")

        # 10e: probe_labeler against the 48 students (dense match)
        few = artifacts["gallery_few-shot_base"]
        g48 = os.path.join(tmp, "gallery48", "students.pkl")
        gm = GalleryManager(g48, verbose=False, device=DEVICE)
        for j, name in enumerate(enrolled):
            gm.add_student(f"STU{j + 1:04d}", name, few[name]["embeddings"])
        gm.save()
        reset()
        t0 = time.perf_counter()
        rc, log = run_cli(probe_labeler.main, [
            "--probe_dir", crops_dir, "--metadata_file", meta_path, "--gallery_path", g48,
            "--architecture", ARCH, "--model_path", weights, "--top_k", str(OFFLINE_TOP_K),
            "--output_dir", os.path.join(tmp, "labeled48"), "--device", DEVICE])
        secs = time.perf_counter() - t0
        n = read()
        if rc != 0 or any(n.values()):
            fail(f"probe_labeler (48 students): rc {rc}, launches {n}:\n{log[-2000:]}")
        with open(os.path.join(tmp, "labeled48", "labeling_results.json")) as f:
            blob = json.load(f)
        embedder = FaceEmbedder(ARCH, model_path=weights, device=DEVICE)
        paths = list_images(crops_dir)
        queries = embedder.extract_embeddings_batch([imread_rgb(p) for p in paths])
        t, ids = gm.get_gallery_embeddings()
        dense = queries @ (t / np.linalg.norm(t, axis=1, keepdims=True)).T
        order = np.argsort(-dense, axis=1, kind="stable")[:, :OFFLINE_TOP_K]
        err, n_ok = 0.0, 0
        for r, (p, row) in enumerate(zip(paths, blob["results"])):
            top = row["top_matches"]
            err = max(err, max(abs(m["score"] - dense[r, j]) for m, j in zip(top, order[r])))
            if row["filename"] != os.path.basename(p) or top[0]["student_id"] != ids[order[r, 0]]:
                if dense[r, order[r, 0]] - dense[r, order[r, 1]] > 2 * EVAL_TOL:
                    fail(f"probe_labeler (48): {row['filename']} matched {top[0]}")
            n_ok += truth.get(row["filename"]) == row["matched_name"]
        if err > EVAL_TOL or blob["summary"]["processed"] != len(paths):
            fail(f"probe_labeler (48): scores {err} from a float32 dense product")
        res["labeler_ms_48"] = 1e3 * secs
        res["labeler_truth_top1_48"] = n_ok / len(paths)
        print(f"[offline] probe_labeler --top_k {OFFLINE_TOP_K} against {len(enrolled)} "
              f"students: {len(paths)} crops in {secs:.1f} s (the {ARCH} load included), "
              f"labels {blob['summary']['label_distribution']}, scores within {err:.3g} of a "
              f"dense float32 product; matched name = true name for {n_ok}/{len(paths)} "
              f"(random weights); no streaming kernel (dense match)")

        # 10f: the labeler against 1 048 576 identities, bf16 (K3) then int8 (K4)
        big = gal.shape[0]
        others = gal[: big - len(enrolled)].cpu().numpy()
        now = "2026-01-01T00:00:00"
        records = {
            f"id{i}": StudentRecord(f"id{i}", f"Identity {i}", others[i:i + 1], others[i],
                                    1, now, now)
            for i in range(len(others))
        }
        records.update(gm.get_all_students())
        del others
        q = torch.from_numpy(queries).to(DEVICE)
        for quantize, kernel in ((None, "gallery_topk"), ("int8", "gallery_topk_int8")):
            label = quantize or "bf16"
            big_gm = GalleryManager(os.path.join(tmp, f"big_{label}.pkl"), verbose=False,
                                    device=DEVICE, quantize=quantize)
            big_gm.students = dict(records)
            big_gm._dirty = True
            _, v, big_ids = big_gm.device_snapshot()
            compact = big_gm._device.snapshot()[3]
            labeler = ProbeLabeler(embedder=embedder, gallery=big_gm, architecture=ARCH)
            reset()
            t0 = time.perf_counter()
            labeler.process_probe_directory(
                crops_dir, output_dir=os.path.join(tmp, f"labeled_{label}"),
                metadata_file=meta_path, copy_files=False, top_k=OFFLINE_TOP_K)
            secs = time.perf_counter() - t0
            n = read()
            if n[kernel] != 1 or sum(n.values()) != 1:
                fail(f"probe_labeler against {big} ({label}): one search launched {n}")
            with open(os.path.join(tmp, f"labeled_{label}", "labeling_results.json")) as f:
                rows = json.load(f)["results"]
            if quantize:
                pv, pi = gallery_kernel.streaming_cosine_topk_int8_plain(
                    q, compact[0], compact[1], v, top_k=OFFLINE_TOP_K, chunk=STREAM_CHUNK)
            else:
                pv, pi = gallery_kernel.streaming_cosine_topk_plain(
                    q, compact, v, top_k=OFFLINE_TOP_K, chunk=STREAM_CHUNK)
            pv, pi = pv.cpu().numpy(), pi.cpu().numpy()
            sv = np.array([[m["score"] for m in r["top_matches"]] for r in rows], np.float32)
            tol = 0.0 if quantize else K3_TOL
            err = float(np.abs(sv - pv).max())
            clear = np.ones(pv.shape, bool)
            gap = np.abs(pv[:, :-1] - pv[:, 1:]) > 2 * max(tol, 1e-7)
            clear[:, :-1] &= gap
            clear[:, 1:] &= gap
            same = all(rows[r]["top_matches"][j]["student_id"] == big_ids[pi[r, j]]
                       for r, j in zip(*np.nonzero(clear)))
            labels_ok = all(
                r["label"] == labeler.determine_label(float(pv[i, 0]))
                for i, r in enumerate(rows)
                if min(abs(pv[i, 0] - labeler.sure_threshold),
                       abs(pv[i, 0] - labeler.unsure_threshold)) > 2 * max(tol, 1e-7))
            if err > tol or not same or not labels_ok:
                fail(f"probe_labeler against {big} ({label}) differs from the plain version "
                     f"(score {err}, ids on clear slots {same}, labels {labels_ok})")
            for c in counters.values():
                c.reset()
            t1 = time.perf_counter()
            big_gm.search_batch(queries, top_k=OFFLINE_TOP_K)
            torch.cuda.synchronize()
            search_ms = 1e3 * (time.perf_counter() - t1)
            res[f"labeler_ms_{label}"] = 1e3 * secs
            res[f"search_ms_{label}"] = search_ms
            print(f"[offline] ProbeLabeler.process_probe_directory against {big} identities "
                  f"({label}): {len(rows)} crops in {1e3 * secs:.1f} ms (read, embed, one "
                  f"search, results); the search alone {search_ms:.2f} ms; {kernel} launched "
                  f"once; equal to the plain version on the same compact rows (max |score "
                  f"difference| {err:.3g}, ids equal on {int(clear.sum())}/{clear.size} clear "
                  f"slots, labels equal)")
            del big_gm, labeler, compact, v, big_ids
            torch.cuda.empty_cache()
        del records, q

        # 10g: evaluate_models on the card, then the same corpus on the card
        # and on the CPU in process
        eval_dir = os.path.join(out, "evaluation")
        argv = ["--models", model, "--embeddings_root", os.path.join(out, "embeddings"),
                "--output_dir", eval_dir, "--device", DEVICE]
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            argv.append("--no_plots")
        t0 = time.perf_counter()
        rc, log = run_cli(evaluate_models.main, argv)
        res["evaluate_models_s"] = time.perf_counter() - t0
        files = ["identification_summary.csv", "identification_summary.tex",
                 "verification_summary.csv", "verification_summary.tex",
                 "gallery_strategies.csv", "gallery_strategies.tex",
                 "evaluation_results.json", "evaluation_results.xlsx", "executive_summary.txt"]
        missing = [f for f in files if not os.path.exists(os.path.join(eval_dir, f))]
        if rc != 0 or missing:
            fail(f"evaluate_models: rc {rc}, missing {missing}:\n{log[-2000:]}")
        sheets = read_xlsx_rows(os.path.join(eval_dir, "evaluation_results.xlsx"))
        with open(os.path.join(eval_dir, "executive_summary.txt")) as f:
            exec_summary = f.read()
        print(f"[offline] evaluate_models --device {DEVICE}: {res['evaluate_models_s']:.1f} s; "
              f"{len(files)} files, sheets {sorted(sheets)}")
        print("[offline] " + exec_summary.strip().replace("\n", "\n[offline] "))

        corpus = load_model_corpus(emb_dir)
        t0 = time.perf_counter()
        card = evaluate_model(corpus, device=DEVICE)
        res["evaluate_model_card_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu = evaluate_model(corpus, device="cpu")
        res["evaluate_model_cpu_s"] = time.perf_counter() - t0
        res["card_vs_cpu"] = compare_evaluations(card, cpu, corpus, DEFAULT_THRESHOLDS)
        print(f"[offline] evaluate_model on the card ({res['evaluate_model_card_s']:.1f} s) "
              f"against the CPU ({res['evaluate_model_cpu_s']:.1f} s): "
              f"{res['card_vs_cpu']['results_compared']} results, threshold tables, rank "
              f"metrics and CIs equal, scores within {res['card_vs_cpu']['max_score_err']:.3g} "
              f"(limit {EVAL_TOL}); {res['card_vs_cpu']['near_decisions']} decisions within "
              f"{EVAL_TOL} of a threshold or a rival")
        del card, cpu, corpus

        # 10h: the device scorer alone at a large shape
        scorer_alone(res)

        # 10i: the detector stress suite through a bf16 cascade (K1)
        detector = MTCNNDetector(weights_path=det_path, dtype=torch.bfloat16, device=DEVICE)
        reset()
        t0 = time.perf_counter()
        stress = run_stress_suite(detector, categories=STRESS_RUN, n_scenes=STRESS_SCENES)
        secs = time.perf_counter() - t0
        n = read()
        if n["crop_resize"] != 2 * len(STRESS_RUN) * STRESS_SCENES:
            fail(f"run_stress_suite launched {n} for {len(STRESS_RUN) * STRESS_SCENES} scenes")
        res["stress"] = stress["summary"]
        for cat, s in stress["summary"].items():
            if s["recall"] is not None and not 0.0 <= s["recall"] <= 1.0:
                fail(f"run_stress_suite {cat}: recall {s['recall']}")
        print(f"[offline] run_stress_suite ({STRESS_SCENES} scenes x {len(STRESS_RUN)} "
              f"categories, 320 px, bf16 cascade) in {secs:.1f} s, K1 launched "
              f"{n['crop_resize']} times: " + "; ".join(
                  f"{c} AP {s['ap'] if s['ap'] is None else round(s['ap'], 4)} recall "
                  f"{s['recall'] if s['recall'] is None else round(s['recall'], 4)} fp/img "
                  f"{s['fp_per_image']:.3f}" for c, s in stress["summary"].items()))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    res["seconds"] = time.perf_counter() - t_phase
    print(f"[offline] phase 10 took {res['seconds']:.1f} s; launches {res['launches']}")
    report["offline"] = res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import numpy as np

    from facerecognitionpipeline_tpu_torch.ops import cuda_build
    from facerecognitionpipeline_tpu_torch.utils.device import resolve_device

    resolve_device("cuda")  # pins the TF32 settings
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    import importlib

    found = []
    for lib in ("cv2", "requests", "psutil", "PIL", "pandas", "scipy", "sklearn", "matplotlib"):
        try:
            found.append(f"{lib} {getattr(importlib.import_module(lib), '__version__', '?')}")
        except ImportError:
            found.append(f"{lib} missing")
    print(f"[env] optional host libraries: {', '.join(found)} (the port's host codecs need "
          f"cv2; it reads process memory through psutil where that imports; the evaluation "
          f"harness needs pandas and scipy, computes ROC-AUC and AP without sklearn, and "
          f"plots only with matplotlib, else evaluate_models runs with --no_plots)")
    t0 = time.perf_counter()
    took = cuda_build.build_all()
    print(f"[build] kernels built in {time.perf_counter() - t0:.1f} s "
          f"(per kernel, from the parallel start: "
          f"{ {k: round(s, 1) for k, s in took.items()} })")
    for name, log in cuda_build.BUILD_LOGS.items():
        print_build_report(name, log)
    with np.load(os.path.join(
        REPO, "facerecognitionpipeline_tpu_torch", "testdata", "smoke_scenes.npz"
    )) as z:
        fixture = {k: z[k] for k in z.files}

    if "--offline-only" in sys.argv[1:]:
        # phase 10 alone, after the build: for work on that phase; prints no
        # kernels line and no result line
        report = {}
        offline_phase(make_gallery(BIG_GALLERY_ROWS), report)
        print(json.dumps({"offline": report["offline"]}))
        return 0

    report = kernel_phase(fixture)
    gal = make_gallery(BIG_GALLERY_ROWS)
    report.update(gallery_kernel_phase(gal))
    ctx = serving_phases(fixture, report)
    large_gallery_phase(ctx, gal, report)
    manager_phase(ctx)
    server_phase(ctx, gal, report)
    int8_phase(ctx, gal, report)
    enrolment_phase(ctx, gal, report)
    offline_phase(gal, report)
    del gal

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi gave no card name and power limit: {smi.stderr.strip()}")
    # the card's name and power limit, as nvidia-smi prints them
    print(smi.stdout.strip().splitlines()[0])

    sources = {
        "crop_resize": ("facerecognitionpipeline_tpu_torch/csrc/crop_resize.cu",
                        "facerecognitionpipeline_tpu/ops/pallas_crop.py:186"),
        "warp_patches": ("facerecognitionpipeline_tpu_torch/csrc/warp_patches.cu",
                         "facerecognitionpipeline_tpu/ops/pallas_warp.py:150"),
        "gallery_topk": ("facerecognitionpipeline_tpu_torch/csrc/gallery_topk.cu",
                         "facerecognitionpipeline_tpu/ops/pallas_gallery.py:277"),
        "gallery_topk_int8": ("facerecognitionpipeline_tpu_torch/csrc/gallery_topk_int8.cu",
                              "facerecognitionpipeline_tpu/ops/pallas_gallery.py:207"),
        # K3's float32-row case of the same Pallas kernel, a kernel of its own
        "gallery_topk_f32": ("facerecognitionpipeline_tpu_torch/csrc/gallery_topk_f32.cu",
                             "facerecognitionpipeline_tpu/ops/pallas_gallery.py:277"),
    }
    enrol = report["enrol"]
    offline_launches = report["offline"]["launches"]
    matcher_launches = {"crop_resize": enrol["launches_k1"], "warp_patches": 0,
                        **enrol["matcher_launches"]}
    # K1's and K2's first designs (one thread per output pixel), as timed when
    # they were the port's kernels: NVIDIA H100 80GB HBM3, 700 W, the same
    # shapes and the same 20-launch event timing. History, not of this run.
    print("[history] first design, ms per step: crop_resize 0.1703, warp_patches 0.0430")
    # K3's and K4's earlier design (wmma on 32-row tiles, a cp.async ring of
    # two, the score tile folded out of shared memory), same card model and
    # limit, same shapes and timing.
    print("[history] earlier design, ms per call: gallery_topk 2.4066, gallery_topk_int8 1.3388")
    kernels = []
    for name in sources:
        # times and bounds are of the shapes one serving step calls the
        # kernel with; the error is the largest over every shape checked
        all_rows = report[name]
        rows = [r for r in all_rows if r.get("in_step", True)]
        bound = sum(r["bound_ms"] for r in rows)
        by_bytes = sum(r["bytes"] for r in rows) / HBM_BYTES_PER_S
        by_ops = sum(r["flops"] / r["peak"] for r in rows)
        f32 = name == "gallery_topk_f32"
        kernels.append({
            "name": "k3_f32" if f32 else name,
            "route": "cuda",
            "source": sources[name][0],
            "replaces": sources[name][1],
            # launches: over the timed steps of phases 3 (K1, K2) and 5 (K3,
            # K4), and for K3 on float32 rows over phase 9's steps with
            # gallery_impl='streaming'; server_launches: over phase 7's
            # served requests (no server path streams float32 rows);
            # matcher_launches: phase 9 (K1 in the bf16 processor's
            # process_image, K3 and K4 in FaceMatcher.match_faces_batch
            # against 1 048 576 identities); offline_launches: phase 10 (K1
            # in dataset_preprocessor, embedding_generator and
            # run_stress_suite; K3 and K4 in ProbeLabeler against 1 048 576
            # identities). The counts were set to 0 before each of those and
            # read after.
            "launches": matcher_launches[name] if f32 else report["launches"][name],
            "server_launches": None if f32 else report["server_launches"][name],
            "matcher_launches": matcher_launches[name],
            "offline_launches": offline_launches[name],
            "max_abs_err": max(r["err"] for r in all_rows),
            # ms, plain_ms, bound_ms and library_ms are sums over the call
            # shapes of one serving step (K1: R-net, O-net, align stage A)
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": bound,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "library_ms": sum(r["library_ms"] for r in rows),
            "shapes": [r["shape"] for r in all_rows],
        })
        if name in ("crop_resize", "warp_patches"):
            kernels[-1].update({
                "in_step_device_ms": report["in_step_device_ms"].get(name),
                **{key: (None if any(r[key] is None for r in rows)
                         else sum(r[key] for r in rows))
                   for key in ("ms_again", "device_ms", "cold_device_ms",
                               "library_device_ms", "host_ms")},
            })
        else:  # K3, K4: one call shape per step
            kernels[-1].update({
                key: rows[0].get(key) for key in (
                    "ms_again", "stream_device_ms", "merge_device_ms", "prep_device_ms",
                    "prep_host_ms", "host_ms", "q64_ms", "q64_stream_device_ms")
                if key in rows[0]
            })
        if kernels[-1]["launches"] < 1 or (not f32 and kernels[-1]["server_launches"] < 1):
            fail(f"a main path never launched {name}")
        if name != "warp_patches" and matcher_launches[name] < 1:
            fail(f"phase 9 never launched {name}")
        if name in ("crop_resize", "gallery_topk", "gallery_topk_int8") and \
                offline_launches[name] < 1:
            fail(f"phase 10 never launched {name}")
    print(json.dumps({"int8": report["int8"]}))
    print(json.dumps({"enrol": enrol}))
    print(json.dumps({"offline": report["offline"]}))
    print(json.dumps({
        "kernels": kernels,
        **{k: v for k, v in report.items() if k.startswith("step_p50_ms")},
    }))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
