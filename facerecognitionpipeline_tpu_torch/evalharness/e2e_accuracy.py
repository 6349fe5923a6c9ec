"""End-to-end recognition accuracy on synthetic identities, with weights the
port trains itself.

The recipe of the repository's accuracy figure (`e2e_rank1` in the bench
output, `bench.py:48-151`), with the embedder trained as
`examples/synthetic_end_to_end.py:84-119` trains it:

* `train_synthetic_embedder`: ir_micro with the AdaFace loss on 16
  `make_identity` identities, B=64, lr 0.05; half of each batch rendered
  crops (`render_identity_crop`), half detector-aligned crops of rendered
  scenes (`aligned_pool`, the deployment's distribution);
* `e2e_rank1`: 3 detector-aligned crops per identity enrolled into a
  GalleryManager, then 24 fresh scenes (seed 4321) through detect -> align
  -> embed -> match, scored rank-1 over the scenes with a face in them.

Every trial's outcome comes back with its top-2 scores, so two runs (the
port against the JAX package, or the card against the CPU) can be held
trial by trial.
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional

import numpy as np
import torch

from facerecognitionpipeline_tpu_torch.train.detector_train import (
    make_identity,
    render_identity_crop,
    render_identity_scene,
)

N_IDENTITIES = 16
ENROL_CROPS = 3
TRIALS = 24
TRIAL_SEED = 4321
QUALITY = {"min_det_score": 0.5, "min_face_size": 15, "max_yaw": 90, "max_pitch": 90,
           "max_roll": 90, "check_blur": False}


def identities(n: int = N_IDENTITIES) -> list:
    return [make_identity(i) for i in range(n)]


def make_processor(weights_path: str, dtype=torch.float32, device="cuda"):
    """The recipe's FaceProcessor: a 160x160 cascade (8 faces, min face 20,
    stage thresholds 0.6/0.6/0.5) with a permissive gate, aligned at 112."""
    from facerecognitionpipeline_tpu_torch.models.detector import MTCNNDetector
    from facerecognitionpipeline_tpu_torch.pipeline.processor import FaceProcessor

    detector = MTCNNDetector(
        det_size=(160, 160), max_faces=8, min_face_size=20, weights_path=weights_path,
        stage_thresholds=(0.6, 0.6, 0.5), dtype=dtype, device=device,
    )
    return FaceProcessor(output_size=112, detector=detector, quality_filter_config=QUALITY,
                         device=device)


def aligned_pool(idents: list, processor, per_identity: int = 20, seed: int = 7) -> dict:
    """Detector-aligned crops per identity, from rendered scenes."""
    rng = np.random.default_rng(seed)
    pool = {i: [] for i in range(len(idents))}
    for i, ident in enumerate(idents):
        attempts = 0
        while len(pool[i]) < per_identity and attempts < per_identity * 3:
            attempts += 1
            scene, boxes, _, _ = render_identity_scene([ident], rng, size=160)
            if not len(boxes):
                continue
            faces = processor.process_numpy(scene, return_all=True)
            if faces:
                pool[i].append(faces[0]["aligned_face"])
    return pool


def train_synthetic_embedder(idents: list, pool: Optional[dict], steps: int = 400,
                             batch: int = 64, dtype=torch.bfloat16, device="cuda",
                             seed: int = 0):
    """The example's embedder training loop through the port's Trainer.
    Returns (trainer, state, losses as floats)."""
    from facerecognitionpipeline_tpu_torch.train.trainer import (
        TrainConfig,
        Trainer,
        dropout_generator,
    )

    rng = np.random.default_rng(seed)
    trainer = Trainer(TrainConfig(architecture="ir_micro", num_classes=len(idents),
                                  loss="adaface", learning_rate=0.05, dtype=dtype),
                      device=device)
    state = trainer.init_state(seed)
    losses = []
    for step in range(steps):
        labels = rng.integers(0, len(idents), size=batch).astype(np.int32)
        imgs = []
        for lab in labels:
            # half rendered crops, half detector-aligned ones
            if pool and pool[int(lab)] and rng.random() < 0.5:
                imgs.append(pool[int(lab)][rng.integers(0, len(pool[int(lab)]))])
            else:
                imgs.append(render_identity_crop(idents[lab], rng))
        imgs = np.stack(imgs)
        x = (imgs[:, :, :, ::-1].astype(np.float32) - 127.5) / 127.5
        state, metrics = trainer.train_step(state, x, labels,
                                            dropout_generator(seed, step, trainer.device))
        losses.append(metrics["loss"])
    return trainer, state, torch.stack(losses).cpu().tolist() if losses else []


def e2e_rank1(embedder, processor, idents: list, device="cuda") -> dict:
    """Enrol ENROL_CROPS detector-aligned crops per identity, then score
    TRIALS fresh scenes. Returns {'e2e_rank1', 'e2e_rank1_n', 'trials'}:
    per trial (identity, detected, top-1 id or None, top-1 score, top-2
    score)."""
    from facerecognitionpipeline_tpu_torch.gallery.manager import GalleryManager
    from facerecognitionpipeline_tpu_torch.pipeline.matcher import FaceMatcher

    rng = np.random.default_rng(123)
    trials = []
    with tempfile.TemporaryDirectory() as td:
        gallery = GalleryManager(gallery_path=os.path.join(td, "g.pkl"), verbose=False,
                                 device=device)
        for i, ident in enumerate(idents):
            crops, attempts = [], 0
            while len(crops) < ENROL_CROPS and attempts < 12:
                attempts += 1
                scene, boxes, _, _ = render_identity_scene([ident], rng, size=160)
                if not len(boxes):
                    continue
                faces = processor.process_numpy(scene, return_all=True)
                if faces:
                    crops.append(faces[0]["aligned_face"])
            if crops:
                gallery.add_student(f"SYN{i:03d}", f"Identity {i}",
                                    embedder.extract_embeddings_batch(crops))
        matcher = FaceMatcher(embedder=embedder, gallery=gallery, similarity_threshold=0.5,
                              processor=processor, device=device)
        trial_rng = np.random.default_rng(TRIAL_SEED)
        for _ in range(TRIALS):
            idx = int(trial_rng.integers(0, len(idents)))
            scene, boxes, _, _ = render_identity_scene([idents[idx]], trial_rng, size=160)
            if not len(boxes):
                continue
            faces = processor.process_numpy(scene, return_all=True)
            if not faces:
                trials.append((idx, False, None, None, None))
                continue
            top = matcher.match_faces_batch([faces[0]["aligned_face"]], top_k=2)[0]
            trials.append((idx, True, top[0][0] if top else None,
                           float(top[0][2]) if top else None,
                           float(top[1][2]) if len(top) > 1 else None))
    correct = sum(1 for idx, _, sid, _, _ in trials if sid == f"SYN{idx:03d}")
    return {"e2e_rank1": round(correct / max(len(trials), 1), 4),
            "e2e_rank1_n": len(trials), "trials": trials}
