"""The reference against the port, on the CPU at a tiny size, in float32:
the same answers where the port's arithmetic is float32 too."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.lib import frames, system
from benchmark.reference import align as ref_align
from benchmark.reference import irse as ref_irse
from benchmark.reference import mtcnn as ref_mtcnn
from benchmark.tests.conftest import ROOT, run_tiny

WEIGHTS = f"{ROOT}/benchmark/data/mtcnn_dr.npz"


@pytest.fixture(scope="module")
def scene():
    fx = frames.fixture()
    pool, _ = frames.mosaics(fx, 2, 2, np.random.default_rng(4))
    return fx, pool


def test_cascade_matches_the_port(scene):
    from facerecognitionpipeline_tpu_torch.models.detector import MTCNNDetector

    _, pool = scene
    det = MTCNNDetector(det_size=(320, 320), max_faces=8, min_face_size=40,
                        dtype=torch.float32, weights_path=WEIGHTS, device="cpu")
    casc = ref_mtcnn.Cascade(ref_mtcnn.load_weights(WEIGHTS, "cpu"), (320, 320), 8, 40.0)
    out = det.detect_device(torch.from_numpy(pool))
    for i in range(len(pool)):
        r = casc.detect(pool[i])
        v = out["valid"][i].numpy()
        assert np.array_equal(v, r["valid"]) and v.sum() >= 3
        np.testing.assert_allclose(out["bboxes"][i].numpy()[v], r["bboxes"][v], atol=1e-2)
        np.testing.assert_allclose(out["landmarks"][i].numpy()[v], r["landmarks"][v], atol=1e-2)


def test_embedder_matches_the_port(scene):
    from facerecognitionpipeline_tpu_torch.pipeline.embedder import FaceEmbedder

    fx, _ = scene
    units = [1, 1, 1, 1]
    state = system.seeded_state(units, 5, "cpu")
    faces = system.fixture_faces(fx, "cpu")[:4]
    port = FaceEmbedder("ir_micro", state_dict=state, dtype=torch.float32, device="cpu")
    x = ref_irse.preprocess(faces)
    got, _ = port.forward(x)
    want = ref_irse.Embedder(state, units)(x)
    assert float((got * want).sum(1).min()) > 1 - 1e-6


def test_int8_embedder_matches_the_port(scene):
    from facerecognitionpipeline_tpu_torch.pipeline.embedder import FaceEmbedder

    fx, _ = scene
    units = [1, 1, 1, 1]
    state = system.seeded_state(units, 6, "cpu")
    faces = system.fixture_faces(fx, "cpu").round()
    port = FaceEmbedder("ir_micro", state_dict=state, dtype=torch.float32, quantize="int8",
                        calib_faces=faces.to(torch.uint8).numpy(), device="cpu")
    ref = ref_irse.Embedder(state, units)
    ref.quantize(ref.calibrate(ref_irse.preprocess(faces)))
    x = ref_irse.preprocess(faces[:4])
    got, _ = port.forward(x)
    # a code that rounds the other way at a tie moves the cosine by ~1e-5
    assert float((got * ref(x)).sum(1).min()) > 1 - 1e-4


def test_align_and_gate_match_the_port(scene):
    from facerecognitionpipeline_tpu_torch.ops.quality import QualityConfig, quality_check
    from facerecognitionpipeline_tpu_torch.ops.warp import align_faces_batch, reference_template

    fx, _ = scene
    tile = torch.from_numpy(fx["tiles"][2]).float()
    lmk = torch.from_numpy(fx["landmarks"][2:3, 0])
    tmpl = torch.from_numpy(reference_template(112))
    # the port's plain versions round the window and the weights to bf16
    for scale in (1.0, 1.7):  # the window fits; it does not (a resize)
        lm = (lmk - lmk.mean(1, keepdim=True)) * scale + lmk.mean(1, keepdim=True)
        port = align_faces_batch(tile[None], lm[None], tmpl)[0].round().clamp(0, 255)
        assert float((port - ref_align.align(tile, lm)).abs().max()) <= 2.0
    ref = ref_align.align(tile, lmk)
    scores = torch.tensor([0.99])
    boxes = torch.from_numpy(fx["boxes"][2:3, 0])
    cfg = {"min_det_score": 0.5, "min_face_size": 40, "blur_threshold": 50.0}
    ok, _ = quality_check(scores, boxes, lmk, QualityConfig(0.5, 40, check_blur=True,
                                                            blur_threshold=50.0),
                          aligned_faces=ref, valid_mask=torch.tensor([True]))
    assert torch.equal(ok, ref_align.gate(scores, boxes, lmk, torch.tensor([True]), ref, cfg))


def test_int8_gallery_match_matches_the_port():
    from facerecognitionpipeline_tpu_torch.ops.gallery_kernel import (
        quantize_templates,
        streaming_cosine_topk_int8_plain,
    )

    g = torch.Generator().manual_seed(3)
    rows = torch.randn(8192, 512, generator=g)
    rows /= rows.norm(dim=1, keepdim=True)
    q = rows[:5] + 0.1 * torch.randn(5, 512, generator=g)
    codes, scales = quantize_templates(rows)
    s_port, i_port = streaming_cosine_topk_int8_plain(
        q, codes, scales, torch.ones(8192, dtype=torch.bool), top_k=3, chunk=4096)
    c, rs = ref_align.quantize_rows(rows)
    s_ref, i_ref = ref_align.match(q, c, 3, rs)
    assert torch.equal(i_port, i_ref)
    torch.testing.assert_close(s_port, s_ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("workload", ["tiny_open", "tiny_closed"])
def test_tiny_run_is_correct(tiny_root, workload):
    rc, res = run_tiny(tiny_root, workload)
    assert rc == 0 and res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
