"""The accuracy recipe (`evalharness/e2e_accuracy.py`, after `bench.py:48-151`
and `examples/synthetic_end_to_end.py:84-119`) through both packages on the
CPU, with the same ir_micro weights that the port trains and exports here
(a short run: 12 steps at B=8, half detector-aligned crops).

The JAX side runs the recipe with the JAX package's detector, processor,
embedder, gallery and matcher on the exported `.npz`; the port's side runs
`e2e_rank1`. Both float32 cascades on `pretrained/mtcnn_dr.npz`. The trials
must agree one by one (the same scenes, the same detections, the same
top-1 identity, scores within 1e-4), except trials whose top-1 margin over
the second is under 1e-3 in either package: those are counted, and only
they may name another identity, so the rank-1 figures differ by at most
their share. At least half the trials must be clear of that margin.
"""

import os
import tempfile

import numpy as np
import pytest
import torch

from facerecognitionpipeline_tpu.gallery.manager import GalleryManager as JaxGallery
from facerecognitionpipeline_tpu.models.detector import MTCNNDetector as JaxDetector
from facerecognitionpipeline_tpu.pipeline.embedder import FaceEmbedder as JaxEmbedder
from facerecognitionpipeline_tpu.pipeline.matcher import FaceMatcher as JaxMatcher
from facerecognitionpipeline_tpu.pipeline.processor import FaceProcessor as JaxProcessor
from facerecognitionpipeline_tpu.train.detector_train import render_identity_scene
from facerecognitionpipeline_tpu_torch.evalharness import e2e_accuracy as E
from facerecognitionpipeline_tpu_torch.pipeline.embedder import FaceEmbedder
from facerecognitionpipeline_tpu_torch.train.checkpoint import export_backbone

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DETECTOR = os.path.join(REPO, "pretrained", "mtcnn_dr.npz")
POOL_DETECTOR = os.path.join(REPO, "pretrained", "mtcnn_synthetic.npz")


def _jax_trials(weights: str, idents: list) -> list:
    """bench.py's enrolment and trial loop with the JAX package, returning
    the same per-trial records as `e2e_rank1`."""
    detector = JaxDetector(det_size=(160, 160), max_faces=8, min_face_size=20,
                           weights_path=DETECTOR, stage_thresholds=(0.6, 0.6, 0.5))
    embedder = JaxEmbedder(architecture="ir_micro", model_path=weights)
    processor = JaxProcessor(output_size=112, detector=detector,
                             quality_filter_config=dict(E.QUALITY))
    rng = np.random.default_rng(123)
    trials = []
    with tempfile.TemporaryDirectory() as td:
        gallery = JaxGallery(gallery_path=os.path.join(td, "g.pkl"), verbose=False)
        for i, ident in enumerate(idents):
            crops, attempts = [], 0
            while len(crops) < E.ENROL_CROPS and attempts < 12:
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
        matcher = JaxMatcher(embedder=embedder, gallery=gallery, similarity_threshold=0.5,
                             processor=processor)
        trial_rng = np.random.default_rng(E.TRIAL_SEED)
        for _ in range(E.TRIALS):
            idx = int(trial_rng.integers(0, len(idents)))
            scene, boxes, _, _ = render_identity_scene([idents[idx]], trial_rng, size=160)
            if not len(boxes):
                continue
            faces = processor.process_numpy(scene, return_all=True)
            if not faces:
                trials.append((idx, False, None, None, None))
                continue
            top = matcher.match_faces_batch([faces[0]["aligned_face"]], top_k=2)[0]
            trials.append((idx, True, top[0][0], float(top[0][2]), float(top[1][2])))
    return trials


def _margin(trial) -> float:
    return np.inf if trial[3] is None or trial[4] is None else trial[3] - trial[4]


def test_accuracy_recipe_agrees_trial_by_trial(tmp_path):
    idents = E.identities()
    pool = E.aligned_pool(idents, E.make_processor(POOL_DETECTOR, device="cpu"),
                          per_identity=2)
    assert sum(len(v) for v in pool.values()) > 16
    _, state, losses = E.train_synthetic_embedder(idents, pool, steps=12, batch=8,
                                                  dtype=torch.float32, device="cpu")
    assert len(losses) == 12 and np.isfinite(losses).all()
    weights = str(tmp_path / "ir_micro.npz")
    export_backbone(state, weights)

    ours = E.e2e_rank1(FaceEmbedder("ir_micro", model_path=weights, device="cpu"),
                       E.make_processor(DETECTOR, device="cpu"), idents, device="cpu")
    theirs = _jax_trials(weights, idents)
    assert ours["e2e_rank1_n"] == len(theirs) > 0
    close = 0
    for a, b in zip(ours["trials"], theirs):
        assert a[:2] == b[:2]
        if min(_margin(a), _margin(b)) < 1e-3:
            close += 1
            continue
        assert a[2] == b[2]
        assert a[3] == pytest.approx(b[3], abs=1e-4) and a[4] == pytest.approx(b[4], abs=1e-4)
    correct = sum(1 for idx, _, sid, _, _ in theirs if sid == f"SYN{idx:03d}")
    assert abs(ours["e2e_rank1"] - correct / len(theirs)) <= close / len(theirs) + 1e-4
    assert close <= len(theirs) // 2
