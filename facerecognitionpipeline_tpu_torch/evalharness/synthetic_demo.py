"""The all-synthetic end-to-end demo: the port trains, enrols and recognises.

Counterpart of `examples/synthetic_end_to_end.py:38-200` (the JAX package's
zero-asset demo, `reports/synthetic_e2e/report.txt`):

* `get_detector`: a float32 MTCNN cascade at det 160 on
  `pretrained/mtcnn_synthetic.npz`, trained with `train_detector` (500
  steps, batch 256) and saved there when the file is missing;
* the embedder: ir_micro trained with the AdaFace loss for EMBEDDER_STEPS
  steps on N_IDENTITIES rendered identities, half of each batch
  detector-aligned crops (`e2e_accuracy.aligned_pool` and
  `train_synthetic_embedder`, the example's loop), exported to
  `pretrained/ir_micro_synthetic_torch.npz` (or weights given);
* enrolment: ENROL_PER_ID detector-aligned crops per identity into a
  `GalleryManager`;
* `run_recognition`: TRIALS rendered scenes (seed TRIAL_SEED) through
  detect -> align -> embed -> match at threshold 0.5, scored rank-1 as the
  example scores it (a scene with no face rendered is skipped, one with no
  face detected counts as a miss);
* the int8 pass: the same weights quantized with scales calibrated on the
  enrolment crops, matched against the fp32-enrolled gallery, and the
  int8-vs-fp32 cosine of DRIFT_PROBES rendered probes.

Each trial comes back with its top-2 scores, so two runs (the port against
the JAX package, or the card against the CPU) can be held trial by trial.
The module constants are read at call time, as the example's are.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Optional

import numpy as np

from facerecognitionpipeline_tpu_torch.evalharness.e2e_accuracy import (
    QUALITY,
    aligned_pool,
    train_synthetic_embedder,
)
from facerecognitionpipeline_tpu_torch.train.detector_train import (
    make_identity,
    render_identity_crop,
    render_identity_scene,
)
from facerecognitionpipeline_tpu_torch.utils.device import card_line, resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
N_IDENTITIES = 16
EMBEDDER_STEPS = 400
EMBEDDER_BATCH = 64
POOL_PER_ID = 20  # aligned crops per identity for training
ENROL_PER_ID = 4
TRIALS = 20
TRIAL_SEED = 1234
DRIFT_PROBES = 32
FLOOR = 0.6  # the example's exit condition, fp32 and int8 rank-1
DETECTOR_WEIGHTS = os.path.join(REPO, "pretrained", "mtcnn_synthetic.npz")
EMBEDDER_WEIGHTS = os.path.join(REPO, "pretrained", "ir_micro_synthetic_torch.npz")
REPORT_DIR = os.path.join(REPO, "reports", "synthetic_e2e_torch")


def identities() -> list:
    return [make_identity(i) for i in range(N_IDENTITIES)]


def get_detector(device="cuda", say=print):
    """The example's cascade: float32, det 160, 8 faces, min face 20,
    stage thresholds 0.6/0.6/0.5, on DETECTOR_WEIGHTS, trained and saved
    there when the file is missing."""
    from facerecognitionpipeline_tpu_torch.models.detector import MTCNNDetector

    kw = dict(det_size=(160, 160), max_faces=8, min_face_size=20,
              stage_thresholds=(0.6, 0.6, 0.5), device=device)
    if os.path.exists(DETECTOR_WEIGHTS):
        say(f"Using shipped detector weights: {os.path.relpath(DETECTOR_WEIGHTS, REPO)}")
        return MTCNNDetector(weights_path=DETECTOR_WEIGHTS, **kw)
    from facerecognitionpipeline_tpu_torch.train.detector_train import train_detector

    say("Training the detector cascade on rendered faces...")
    det = MTCNNDetector(variables=train_detector(steps=500, batch=256, device=device), **kw)
    det.save_npz(DETECTOR_WEIGHTS)
    return det


def make_processor(detector, device="cuda"):
    """The example's FaceProcessor: aligned at 112 behind a permissive gate."""
    from facerecognitionpipeline_tpu_torch.pipeline.processor import FaceProcessor

    return FaceProcessor(output_size=112, detector=detector,
                         quality_filter_config=dict(QUALITY), device=device)


class _Counted:
    """A detector that counts its `detect` calls (the float32 cascade
    launches K5 three times a detect)."""

    def __init__(self, detector):
        self.detector, self.detects = detector, 0

    def detect(self, image):
        self.detects += 1
        return self.detector.detect(image)

    def __getattr__(self, name):
        return getattr(self.detector, name)


def _sizes(pool: dict) -> dict:
    counts = [len(v) for v in pool.values()]
    return {"min": min(counts), "max": max(counts)}


def enrol(embedder, processor, idents: list, device="cuda"):
    """ENROL_PER_ID detector-aligned crops per identity (the example's
    enrolment pool, seed 7) into a GalleryManager as SYN000, SYN001, ...;
    an identity without one is enrolled from a rendered crop (seed 42).
    Returns (gallery, pool)."""
    from facerecognitionpipeline_tpu_torch.gallery.manager import GalleryManager

    rng = np.random.default_rng(42)
    pool = aligned_pool(idents, processor, per_identity=ENROL_PER_ID)
    with tempfile.TemporaryDirectory() as td:  # never saved: a new, empty gallery
        gallery = GalleryManager(gallery_path=os.path.join(td, "students.pkl"),
                                 verbose=False, device=device)
    for i, ident in enumerate(idents):
        crops = pool[i] or [render_identity_crop(ident, rng)]
        gallery.add_student(f"SYN{i:03d}", f"Identity {i}",
                            embedder.extract_embeddings_batch(crops))
    return gallery, pool


def run_recognition(embedder, processor, gallery, idents: list, seed: int = TRIAL_SEED,
                    device="cuda") -> dict:
    """TRIALS scenes of one identity each (drawn with `choice`, as the
    example draws them) through the processor and FaceMatcher at threshold
    0.5. Returns {'correct', 'total', 'trials'}: per trial
    (identity, detected, top-1 id or None, top-1 score, top-2 score). The
    top-1 is the example's `top_k=1` answer: the search sorts by score, so
    asking for two changes not the first."""
    from facerecognitionpipeline_tpu_torch.pipeline.matcher import FaceMatcher

    matcher = FaceMatcher(embedder=embedder, gallery=gallery, similarity_threshold=0.5,
                          processor=processor, device=device)
    trial_rng = np.random.default_rng(seed)
    trials = []
    for _ in range(TRIALS):
        idx = trial_rng.choice(len(idents), size=1)
        scene, boxes, _, _ = render_identity_scene([idents[i] for i in idx], trial_rng,
                                                   size=160)
        if not len(boxes):
            continue
        faces = processor.process_numpy(scene, return_all=True)
        if not faces:
            trials.append((int(idx[0]), False, None, None, None))
            continue
        top = matcher.match_faces_batch([f["aligned_face"] for f in faces[:1]], top_k=2)[0]
        trials.append((int(idx[0]), True, top[0][0] if top else None,
                       float(top[0][2]) if top else None,
                       float(top[1][2]) if len(top) > 1 else None))
    correct = sum(1 for idx, _, sid, _, _ in trials if sid == f"SYN{idx:03d}")
    return {"correct": correct, "total": len(trials), "trials": trials}


def drift_probes(idents: list) -> np.ndarray:
    """The example's drift probes: crop i of identity i % N from seed 500 + i."""
    return np.stack([render_identity_crop(idents[i % len(idents)],
                                          np.random.default_rng(500 + i))
                     for i in range(DRIFT_PROBES)])


def _rate(r: dict) -> str:
    return f"{r['correct']}/{r['total']} ({100 * r['correct'] / max(r['total'], 1):.0f}%)"


def run_demo(device="cuda", weights: Optional[str] = None, retrain: bool = False,
             out_dir: str = REPORT_DIR) -> dict:
    """The whole demo. `weights`: an ir_micro `.npz` to use as it is;
    without one the demo uses EMBEDDER_WEIGHTS where it exists and
    `retrain` is False, else trains and exports there. Writes
    out_dir/report.json (the figures) and out_dir/report.txt (the example's
    printed layout). Returns the figures; 'ok' is the example's exit
    condition (rank-1 >= FLOOR, fp32 and int8)."""
    import torch

    from facerecognitionpipeline_tpu_torch.pipeline.embedder import FaceEmbedder
    from facerecognitionpipeline_tpu_torch.train.checkpoint import export_backbone

    device = resolve_device(device)  # before the renders: no card, no work
    t_start = time.perf_counter()
    lines: list = []

    def say(text: str = "") -> None:
        print(text, flush=True)
        lines.append(text)

    idents = identities()
    detector = _Counted(get_detector(device, say))
    processor = make_processor(detector, device)
    rep: dict = {"device": str(device), "card": card_line(device),
                 "n_identities": len(idents)}
    trained = weights is None and (retrain or not os.path.exists(EMBEDDER_WEIGHTS))
    weights = weights or EMBEDDER_WEIGHTS
    if trained:
        say(f"Training the embedder on {len(idents)} synthetic identities "
            f"({EMBEDDER_STEPS} steps)...")
        t0 = time.perf_counter()
        pool = aligned_pool(idents, processor, per_identity=POOL_PER_ID)
        rep["aligned_pool_sizes"] = _sizes(pool)
        say(f"  aligned pool sizes: min {rep['aligned_pool_sizes']['min']} "
            f"max {rep['aligned_pool_sizes']['max']}")
        t1 = time.perf_counter()
        _, state, losses = train_synthetic_embedder(idents, pool, steps=EMBEDDER_STEPS,
                                                    batch=EMBEDDER_BATCH,
                                                    dtype=torch.bfloat16, device=device)
        rep["loss_at_step"] = {}
        for step in range(100, EMBEDDER_STEPS + 1, 100):
            rep["loss_at_step"][str(step)] = round(losses[step - 1], 4)
            say(f"  step {step}: loss {losses[step - 1]:.4f}")
        rep["pool_seconds"], rep["train_seconds"] = t1 - t0, time.perf_counter() - t1
        rep["first_loss"] = losses[0] if losses else None
        export_backbone(state, weights)
        del state
    else:
        say(f"Using cached embedder weights: {os.path.relpath(weights, REPO)}")
    rep["embedder_trained"] = trained
    rep["weights"] = os.path.relpath(weights, REPO)
    say(f"Loading adaface weights (ir_micro) from {rep['weights']}...")
    embedder = FaceEmbedder(architecture="ir_micro", model_path=weights, device=device)

    say()
    say("Enrolling identities from detector-aligned crops...")
    t0 = time.perf_counter()
    gallery, enrol_pool = enrol(embedder, processor, idents, device)
    rep["enrol_pool_sizes"] = _sizes(enrol_pool)
    say(f"  aligned pool sizes: min {rep['enrol_pool_sizes']['min']} "
        f"max {rep['enrol_pool_sizes']['max']}")
    say("Recognizing rendered scenes through the FULL pipeline "
        "(real detection + alignment + embedding + matching)...")
    say(f"Face Matcher ready — {len(idents)} enrolled students")
    fp32 = run_recognition(embedder, processor, gallery, idents, device=device)
    rep["rank1_fp32"] = fp32
    say()
    say(f"Scene recognition rank-1: {_rate(fp32)}")

    say()
    say("Re-running recognition with the int8-quantized embedder...")
    calib = np.stack([c for crops in enrol_pool.values() for c in crops])
    say(f"Loading adaface weights (ir_micro) from {rep['weights']}...")
    embedder_q = FaceEmbedder(architecture="ir_micro", model_path=weights, quantize="int8",
                              calib_faces=calib, device=device)
    probes = drift_probes(idents)
    cos = np.sum(embedder.extract_embeddings_batch(probes)
                 * embedder_q.extract_embeddings_batch(probes), axis=1)
    say(f"Face Matcher ready — {len(idents)} enrolled students")
    int8 = run_recognition(embedder_q, processor, gallery, idents, device=device)
    rep["rank1_int8"] = int8
    rep["int8_drift_cosine"] = {"min": round(float(cos.min()), 5),
                                "mean": round(float(cos.mean()), 5),
                                "values": cos.astype(float).tolist()}
    say(f"int8 embedding drift vs fp32: cosine min {cos.min():.5f} mean {cos.mean():.5f}")
    say(f"Scene recognition rank-1 (int8): {_rate(int8)}")
    rep["recognise_seconds"] = time.perf_counter() - t0
    rep["detects"] = detector.detects
    rep["ok"] = bool(fp32["correct"] / max(fp32["total"], 1) >= FLOOR
                     and int8["correct"] / max(int8["total"], 1) >= FLOOR)
    rep["seconds"] = time.perf_counter() - t_start
    write_report(rep, lines, out_dir)
    return rep


def write_report(rep: dict, lines: list, out_dir: str) -> None:
    """out_dir/report.json (the figures) and out_dir/report.txt (the
    example's printed lines)."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "report.json"), "w") as f:
        json.dump(rep, f, indent=2)
    with open(os.path.join(out_dir, "report.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
