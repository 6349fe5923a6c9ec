"""The system under test, built from a configuration file and the seed.

What the benchmark makes itself, from the seed, and hands to both the
program and the reference: the embedder's float32 weights (one draw on the
device, in the served model's state-dict names), the gallery rows (the
reference's own embeddings of the fixture's faces at seeded places, and
seeded unit rows around them), the frames, and for an int8 configuration
the calibration inputs. The detector's weights are the configuration's
`detector_weights`, an `.npz` under `benchmark/data/`.

The program is the port's serving stack as the server CLI builds it: an
`MTCNNDetector` and a `FaceEmbedder` in bf16 (or int8), a
`RecognitionEngine`, a `GalleryManager`, and a `FaceRecognitionServer`
built in-process around them (no HTTP listener), whose `DeviceBatcher`
the window drives. Only this module imports the program.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple

import numpy as np
import torch

from benchmark.lib.spec import BENCH_DIR
from benchmark.reference import align as ref_align
from benchmark.reference import irse as ref_irse

ROOT = os.path.dirname(BENCH_DIR)
_MASK = (1 << 63) - 1


def seeds(seed: int) -> dict:
    """Independent seeds of each input, from the run's --seed."""
    base = np.random.SeedSequence(seed % (1 << 64))
    names = ("weights", "gallery", "frames", "traffic", "sample")
    return {n: int(s.generate_state(2, np.uint64)[0]) & _MASK
            for n, s in zip(names, base.spawn(len(names)))}


def seeded_state(units, seed: int, device) -> dict:
    """The embedder's float32 weights, drawn on the device in one call:
    conv and dense weights N(0, 1/fan_in), biases N(0, 0.01^2), PReLU
    slopes 0.25 + N(0, 0.05^2), the folded affines' scales 1 + N(0, 0.1^2)
    and shifts N(0, 0.1^2)."""
    tab = ref_irse.table(units)
    sizes = [math.prod(shape) for _, shape, _ in tab]
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    z = torch.randn(sum(sizes), generator=g, device=device)
    state, at = {}, 0
    for (name, shape, kind), n in zip(tab, sizes):
        v = z[at:at + n].view(shape)
        at += n
        if kind in ("conv", "dense"):
            v = v * (n // shape[0]) ** -0.5
        elif kind == "bias":
            v = v * 0.01
        elif kind == "alpha":
            v = 0.25 + 0.05 * v
        elif kind == "scale":
            v = 1.0 + 0.1 * v
        else:  # shift
            v = 0.1 * v
        state[name] = v.contiguous()
    return state


def fixture_faces(fx: dict, device) -> torch.Tensor:
    """The fixture's 16 faces aligned at their true landmarks by the
    reference aligner: [16, 112, 112, 3] float32 holding 0..255."""
    tiles = torch.from_numpy(fx["tiles"]).to(device)
    lmk = torch.from_numpy(fx["landmarks"][:, 0]).to(device)
    return torch.cat([ref_align.align(tiles[i], lmk[i:i + 1]) for i in range(len(tiles))])


def gallery_rows(cfg: dict, identity_rows: torch.Tensor, seed: int, device):
    """(ids, float32 rows [G, 512] on the device, the places of the
    traffic's identities [16]): unit rows from the seed, and the
    identities' rows at seeded places."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    n = int(cfg["gallery_ids"])
    rows = torch.randn((n, identity_rows.shape[1]), generator=g, device=device)
    rows /= torch.linalg.vector_norm(rows, dim=1, keepdim=True)
    places = torch.randperm(n, generator=g, device=device)[:len(identity_rows)]
    rows[places] = identity_rows
    return [f"id{j:07d}" for j in range(n)], rows, places


def identity_rows(cfg: dict, state: dict, faces: torch.Tensor) -> torch.Tensor:
    """The reference's embeddings of the fixture faces [16, 512]: the rows
    of the traffic's identities. Made once a run and handed to both sides
    (a convolution's algorithm may differ between two calls)."""
    emb = ref_irse.Embedder(state, cfg["units"])
    with torch.inference_mode():
        return emb(ref_irse.preprocess(faces))


class System(NamedTuple):
    server: object
    engine: object
    gallery: object
    batcher: object


def detector_weights(cfg: dict, root: str = ROOT) -> str:
    return os.path.join(root, cfg["detector_weights"])


def build(cfg: dict, state: dict, ids, rows, calib_faces, calib_frames,
          tmpdir: str, device, root: str = ROOT) -> System:
    """The serving stack of `cfg` around the benchmark's inputs, warmed
    (each bucket's CUDA graph captured by the server's own warm-up)."""
    from facerecognitionpipeline_tpu_torch.gallery.manager import GalleryManager
    from facerecognitionpipeline_tpu_torch.models.detector import MTCNNDetector
    from facerecognitionpipeline_tpu_torch.ops.quality import QualityConfig
    from facerecognitionpipeline_tpu_torch.pipeline.embedder import FaceEmbedder
    from facerecognitionpipeline_tpu_torch.pipeline.engine import RecognitionEngine
    from facerecognitionpipeline_tpu_torch.serve.server import FaceRecognitionServer

    quant = cfg.get("quantize")
    dtype = getattr(torch, cfg["dtype"])
    det = MTCNNDetector(
        det_size=tuple(cfg["det_size"]), det_thresh=0.5, max_faces=cfg["max_faces"],
        min_face_size=cfg["min_face_size"], dtype=dtype, weights_path=detector_weights(cfg, root),
        quantize=quant, calib_frames=calib_frames if quant else None, device=device,
    )
    emb = FaceEmbedder(
        architecture=cfg["architecture"], model_type="adaface", state_dict=state,
        dtype=dtype, quantize=quant, calib_faces=calib_faces if quant else None,
        device=device,
    )
    q = cfg["quality"]
    engine = RecognitionEngine(
        det, emb, top_k=cfg["top_k"], input_format="rgb",
        quality_config=QualityConfig(
            min_det_score=q["min_det_score"], min_face_size=q["min_face_size"],
            check_blur=True, blur_threshold=q["blur_threshold"]),
    )
    gallery = GalleryManager(
        gallery_path=os.path.join(tmpdir, "gallery", "students.pkl"), verbose=False,
        quantize=cfg.get("gallery_quantize"), device=device,
    )
    _enrol(gallery, ids, rows)
    server = FaceRecognitionServer(
        gallery_path=gallery.gallery_path, output_dir=os.path.join(tmpdir, "sessions"),
        architecture=cfg["architecture"], det_size=tuple(cfg["det_size"]),
        max_faces=cfg["max_faces"], batch_max=cfg["batch_max"],
        batch_wait_ms=cfg["batch_wait_ms"], batch_buckets=tuple(cfg["buckets"]),
        engine=engine, gallery=gallery, warmup=True,
        enable_performance_monitoring=False, device=device,
    )
    return System(server, engine, gallery, server.batcher)


def _enrol(gallery, ids, rows) -> None:
    """Put the rows on the gallery's device as one generation. The manager
    has no bulk enrolment of device rows, so this rebuilds its device
    gallery directly; a program without these parts fails the run."""
    with gallery._sync_lock:
        gallery._device.rebuild(list(ids), rows)
        gallery._dirty = False
