#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py    # needs one CUDA card

Phases, in order; any failure exits non-zero before the final line:
  1. build the CUDA kernels (K1 crop_resize, K2 warp_patches) with nvcc;
  2. hold each kernel against its plain PyTorch version on the card, at the
     shapes the serving step gives it, and time kernel, plain version and a
     one-call PyTorch yardstick (F.grid_sample) beside the kernel's bound;
  3. the fused serving step at the server's build: ir_101 (seeded random
     weights), bf16, det_size 640x640, 16 face slots, min face 40, top-3,
     a 1024-row bf16 gallery, B=8 frames composed from the in-repo smoke
     fixture. Checks detection recall against the fixture's ground truth,
     planted gallery matches, finite outputs, and that every step launched
     K1 three times and K2 once; times the step;
  4. 16 requests from two client threads through DeviceBatcher, each held
     against the direct step on the same frame.
Then it prints the card's name and power limit, a JSON line describing the
kernels, and as its last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet), used for the kernels' bounds.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

DEVICE = "cuda"
ARCH = "ir_101"
DET_SIZE = (640, 640)
MAX_FACES = 16
BATCH = 8
GALLERY_ROWS = 1024
STEP_ITERS = 12


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
    """Phase 2: kernels vs plain versions at the serving step's shapes."""
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
        ("rnet k=24", small, rand_boxes(256, 12.0, 160.0, h // 2), 24, 1e-5),
        ("onet k=48", img, rand_boxes(96, 24.0, 320.0, h), 48, 1e-5),
        ("align_a k=128", frames, align_boxes.reshape(BATCH, MAX_FACES, 4), 128, 1e-3),
    ]
    report = {"crop_resize": [], "warp_patches": []}
    patches = None
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
            "ms": cuda_time_ms(lambda: crop_resize_kernel(src, boxes, k)),
            "plain_ms": cuda_time_ms(lambda: crop_resize_plain(src, boxes, k), iters=5),
            "library_ms": cuda_time_ms(
                lambda: F.grid_sample(src_nchw, grid, align_corners=False)
            ),
            "bytes": nbytes, "flops": flops,
        })

    tol = 1e-3  # 0..255 scale
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
        "ms": cuda_time_ms(lambda: warp_patches_kernel(patches, coeffs, 112, 112)),
        "plain_ms": cuda_time_ms(
            lambda: warp_patches_plain(patches, coeffs, 112, 112), iters=3
        ),
        "library_ms": cuda_time_ms(
            lambda: F.grid_sample(p_nchw, grid, align_corners=False)
        ),
        "bytes": 4 * (patches.numel() + coeffs.numel() + out.numel()),
        "flops": out.numel() * 12,
    })
    for name, rows in report.items():
        for r in rows:
            bound = 1e3 * max(r["bytes"] / HBM_BYTES_PER_S, r["flops"] / F32_FLOPS_PER_S)
            r["bound_ms"] = bound
            r["bound_by"] = (
                "bytes" if r["bytes"] / HBM_BYTES_PER_S >= r["flops"] / F32_FLOPS_PER_S
                else "operations"
            )
            print(f"[timing] {name} {r['shape']}: kernel {r['ms']:.4f} ms, "
                  f"bound {bound:.4f} ms ({r['bound_by']}), plain {r['plain_ms']:.4f} ms, "
                  f"F.grid_sample {r['library_ms']:.4f} ms")
    return report


def breakdown(engine, frames, templates, valid, iters: int = 5) -> None:
    """Where the step's time goes: each layer timed alone (host clock
    around synchronized calls, median of `iters`), then the device's busy
    share over whole steps from torch.profiler (kernel time / wall time)."""
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
            "match (dense top-k)": lambda: engine._match(
                torch.randn((b, f, 512), device=f32.device), templates, valid, 3
            ),
        }
        for name, fn in layers.items():
            times = []
            for _ in range(iters):
                torch.cuda.synchronize()
                s0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append(1e3 * (time.perf_counter() - s0))
            print(f"[breakdown] {name}: {sorted(times)[iters // 2]:.3f} ms")

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
        print("[breakdown] device busy share: not measured (profiler saw no device time)")
        return
    launches = sum(e.count for e in events)
    print(f"[breakdown] device busy {dev_us / wall_us:.3f} of wall over 3 profiled steps "
          f"({dev_us / 3e3:.3f} ms device time and {launches / 3:.0f} device events per "
          f"step; profiled wall {wall_us / 3e3:.3f} ms per step)")
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    for e in top:
        print(f"[breakdown]   {e.self_device_time_total / 3e3:8.3f} ms/step  "
              f"x{e.count // 3:<5d} {e.key[:90]}")


def serving_phases(fixture, report) -> None:
    """Phases 3 and 4: the fused step and the request batcher."""
    import numpy as np
    import torch

    from facerecognitionpipeline_tpu_torch.gallery.search import DeviceGallery
    from facerecognitionpipeline_tpu_torch.models.detector import MTCNNDetector
    from facerecognitionpipeline_tpu_torch.ops import crop_kernel, warp_kernel
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
    out = engine.process_frames(frames, t, v)
    torch.cuda.synchronize()
    print(f"[step] built and warmed in {time.perf_counter() - t0:.1f} s")

    # detection recall against the fixture's ground truth
    valid = out["face_valid"].cpu().numpy()
    boxes = out["bboxes"].cpu().numpy()
    hits = total = 0
    for f in range(BATCH):
        pb = boxes[f][valid[f]]
        for gt in gts[f]:
            total += 1
            hits += bool(len(pb)) and float(iou(gt, pb).max()) >= 0.5
    recall = hits / total
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
    times = []
    for _ in range(STEP_ITERS):
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        out = engine.process_frames(frames, t, v)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - s0)
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
    ms = sorted(1e3 * x for x in times)
    p50 = ms[len(ms) // 2]
    print(f"[timing] fused step B={BATCH} {DET_SIZE[0]}x{DET_SIZE[1]} {ARCH} bf16: "
          f"p50 {p50:.3f} ms, min {ms[0]:.3f}, max {ms[-1]:.3f} over {STEP_ITERS} "
          f"steps ({BATCH * 1e3 / p50:.1f} frames/s)")
    report["launches"] = launches
    report["step_p50_ms"] = p50
    breakdown(engine, frames, t, v)

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
    dv = direct["face_valid"].cpu().numpy()
    db = direct["bboxes"].cpu().numpy()
    di = direct["match_idx"].cpu().numpy()
    ds = direct["match_scores"].cpu().numpy()
    for i, r in enumerate(results):
        f = i % BATCH
        if not np.array_equal(r["face_valid"], dv[f]):
            fail(f"request {i}: face_valid differs from the direct step")
        if np.abs(r["bboxes"][dv[f]] - db[f][dv[f]]).max(initial=0) > 0.5:
            fail(f"request {i}: boxes differ from the direct step")
        clear = (ds[f, :, 0] - ds[f, :, 1]) > 5e-3
        if not np.array_equal(r["match_idx"][clear, 0], di[f][clear, 0]):
            fail(f"request {i}: top-1 matches differ from the direct step")
        if np.asarray(r["aligned"]).shape != (MAX_FACES, 112, 112, 3):
            fail(f"request {i}: aligned crops have the wrong shape")
    print(f"[requests] {n_req} DeviceBatcher requests from 2 threads answered in "
          f"{r_s:.3f} s, each equal to the direct step")


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
    t0 = time.perf_counter()
    took = cuda_build.build_all()
    print(f"[build] kernels built in {time.perf_counter() - t0:.1f} s "
          f"(per kernel, from the parallel start: "
          f"{ {k: round(s, 1) for k, s in took.items()} })")
    with np.load(os.path.join(
        REPO, "facerecognitionpipeline_tpu_torch", "testdata", "smoke_scenes.npz"
    )) as z:
        fixture = {k: z[k] for k in z.files}

    report = kernel_phase(fixture)
    serving_phases(fixture, report)

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
    }
    kernels = []
    for name, rows in (("crop_resize", report["crop_resize"]),
                       ("warp_patches", report["warp_patches"])):
        bound = sum(r["bound_ms"] for r in rows)
        by_bytes = sum(r["bytes"] for r in rows) / HBM_BYTES_PER_S
        by_ops = sum(r["flops"] for r in rows) / F32_FLOPS_PER_S
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": sources[name][0],
            "replaces": sources[name][1],
            "launches": report["launches"][name],
            "max_abs_err": max(r["err"] for r in rows),
            # ms, plain_ms, bound_ms and library_ms are sums over the call
            # shapes of one serving step (K1: R-net, O-net, align stage A)
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": bound,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "library_ms": sum(r["library_ms"] for r in rows),
            "shapes": [r["shape"] for r in rows],
        })
    print(json.dumps({"kernels": kernels, "step_p50_ms": report["step_p50_ms"]}))
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
