"""The synthetic end-to-end demo of the port (`evalharness/
synthetic_demo.py`, `examples/torch_synthetic_end_to_end.py`) against the
JAX package's example (`examples/synthetic_end_to_end.py`, loaded from its
file), on the CPU.

Both packages detect with the float32 cascade on
`pretrained/mtcnn_synthetic.npz` and embed with one seeded ir_micro tree
(the port's `FaceEmbedder(variables=)`), shrunk to 4 identities, 2
enrolment crops and 6 trials:

* enrolment: the same pool of detector-aligned crops (the same scenes
  detected, crops within 1 grey level), enrolled embeddings within
  EMBED_TOL (a crop one grey level off moves an embedding by up to 1.4e-4,
  measured);
* `run_recognition` trial by trial against the example's loop: the same
  scenes and detections, the same top-1 identity and its scores within
  1e-4, except trials whose top-1 margin over the second is under
  MARGIN in either package (counted; the rank-1 figures differ by at most
  their share);
* the int8 pass: each package's int8 embedder calibrated on its own
  enrolment crops, the drift cosines of the probes within DRIFT_TOL;
* `run_demo`'s report (its keys, the example's printed layout, the exit
  condition), from given weights and with its own training.
"""

import importlib.util
import json
import os
import tempfile

import jax
import numpy as np
import pytest
import torch

from facerecognitionpipeline_tpu.gallery.manager import GalleryManager as JaxGallery
from facerecognitionpipeline_tpu.models.detector import MTCNNDetector as JaxDetector
from facerecognitionpipeline_tpu.models.irse import build_backbone as jax_backbone
from facerecognitionpipeline_tpu.pipeline.embedder import FaceEmbedder as JaxEmbedder
from facerecognitionpipeline_tpu.pipeline.matcher import FaceMatcher as JaxMatcher
from facerecognitionpipeline_tpu.pipeline.processor import FaceProcessor as JaxProcessor
from facerecognitionpipeline_tpu.train.detector_train import (
    render_identity_crop,
    render_identity_scene,
)
from facerecognitionpipeline_tpu_torch.evalharness import synthetic_demo as D
from facerecognitionpipeline_tpu_torch.pipeline.embedder import FaceEmbedder
from facerecognitionpipeline_tpu_torch.utils.io import save_npz_variables

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHRUNK = {"N_IDENTITIES": 4, "TRIALS": 6, "ENROL_PER_ID": 2, "DRIFT_PROBES": 8}
EMBED_TOL = 5e-4
MARGIN = 1e-3  # top-1 over top-2 below which a trial's identity is a rounding decision
DRIFT_TOL = 2e-4  # int8 drift cosine between the packages (measured up to 6.9e-5)


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


JAX_DEMO = _load("synthetic_end_to_end")


@pytest.fixture(scope="module")
def shrunk():
    mp = pytest.MonkeyPatch()
    for name, value in SHRUNK.items():
        mp.setattr(D, name, value)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def jax_variables():
    variables = jax.jit(jax_backbone("ir_micro").init)(
        jax.random.PRNGKey(4), np.zeros((1, 112, 112, 3), np.float32))
    return jax.tree_util.tree_map(np.asarray, dict(variables))


@pytest.fixture(scope="module")
def port_run(shrunk, jax_variables):
    idents = D.identities()
    processor = D.make_processor(D.get_detector("cpu"), "cpu")
    embedder = FaceEmbedder("ir_micro", variables=jax_variables, device="cpu")
    gallery, pool = D.enrol(embedder, processor, idents, "cpu")
    fp32 = D.run_recognition(embedder, processor, gallery, idents, device="cpu")
    calib = np.stack([c for crops in pool.values() for c in crops])
    int8 = FaceEmbedder("ir_micro", variables=jax_variables, quantize="int8",
                        calib_faces=calib, device="cpu")
    probes = D.drift_probes(idents)
    drift = (embedder.extract_embeddings_batch(probes)
             * int8.extract_embeddings_batch(probes)).sum(1)
    return {"pool": pool, "gallery": gallery, "fp32": fp32, "drift": drift}


@pytest.fixture(scope="module")
def jax_run(shrunk, jax_variables):
    """The example's enrolment, recognition loop (`:130-171`) and drift
    (`:176-194`) with the JAX package, at the shrunk sizes."""
    idents = [JAX_DEMO.make_identity(i) for i in range(SHRUNK["N_IDENTITIES"])]
    detector = JaxDetector(det_size=(160, 160), max_faces=8, min_face_size=20,
                           weights_path=os.path.join(REPO, JAX_DEMO.DETECTOR_WEIGHTS),
                           stage_thresholds=(0.6, 0.6, 0.5))
    processor = JaxProcessor(output_size=112, detector=detector, quality_filter_config={
        "min_det_score": 0.5, "min_face_size": 15, "max_yaw": 90, "max_pitch": 90,
        "max_roll": 90, "check_blur": False})
    embedder = JaxEmbedder("ir_micro", variables=jax_variables)
    pool = JAX_DEMO.build_aligned_pool(idents, processor, per_identity=SHRUNK["ENROL_PER_ID"])
    rng = np.random.default_rng(42)
    with tempfile.TemporaryDirectory() as td:
        gallery = JaxGallery(gallery_path=os.path.join(td, "students.pkl"), verbose=False)
        for i, ident in enumerate(idents):
            crops = pool[i] or [render_identity_crop(ident, rng)]
            gallery.add_student(f"SYN{i:03d}", f"Identity {i}",
                                embedder.extract_embeddings_batch(crops))
    matcher = JaxMatcher(embedder=embedder, gallery=gallery, similarity_threshold=0.5,
                         processor=processor)
    trial_rng = np.random.default_rng(1234)
    trials = []
    for _ in range(SHRUNK["TRIALS"]):
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
        trials.append((int(idx[0]), True, top[0][0], float(top[0][2]), float(top[1][2])))
    calib = np.stack([c for crops in pool.values() for c in crops])
    int8 = JaxEmbedder("ir_micro", variables=jax_variables, quantize="int8", calib_faces=calib)
    probes = np.stack([render_identity_crop(idents[i % len(idents)],
                                            np.random.default_rng(500 + i))
                       for i in range(SHRUNK["DRIFT_PROBES"])])
    drift = (embedder.extract_embeddings_batch(probes)
             * int8.extract_embeddings_batch(probes)).sum(1)
    return {"pool": pool, "gallery": gallery, "trials": trials, "drift": drift}


def test_enrolment_matches_jax(port_run, jax_run):
    assert sorted(port_run["pool"]) == sorted(jax_run["pool"])
    for i, crops in jax_run["pool"].items():
        got = port_run["pool"][i]
        assert len(got) == len(crops) == SHRUNK["ENROL_PER_ID"]
        for a, b in zip(got, crops):
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    ours, theirs = port_run["gallery"].students, jax_run["gallery"].students
    assert list(ours) == list(theirs) == [f"SYN{i:03d}" for i in range(4)]
    for sid in theirs:
        np.testing.assert_allclose(ours[sid].embeddings, theirs[sid].embeddings,
                                   rtol=0, atol=EMBED_TOL)


def _margin(trial) -> float:
    return np.inf if trial[3] is None or trial[4] is None else trial[3] - trial[4]


def test_recognition_agrees_trial_by_trial(port_run, jax_run):
    ours, theirs = port_run["fp32"], jax_run["trials"]
    assert ours["total"] == len(theirs) == len(ours["trials"]) > 0
    close = 0
    for a, b in zip(ours["trials"], theirs):
        assert a[:2] == b[:2]
        if min(_margin(a), _margin(b)) < MARGIN:
            close += 1
            continue
        assert a[2] == b[2]
        assert a[3] == pytest.approx(b[3], abs=1e-4) and a[4] == pytest.approx(b[4], abs=1e-4)
    correct = sum(1 for idx, _, sid, _, _ in theirs if sid == f"SYN{idx:03d}")
    assert abs(ours["correct"] - correct) <= close
    assert close <= len(theirs) // 2


def test_int8_drift_matches_jax(port_run, jax_run):
    got, want = port_run["drift"], jax_run["drift"]
    assert got.shape == want.shape == (SHRUNK["DRIFT_PROBES"],)
    np.testing.assert_allclose(got, want, rtol=0, atol=DRIFT_TOL)


JSON_KEYS = {"device", "card", "n_identities", "embedder_trained", "weights", "enrol_pool_sizes",
             "rank1_fp32", "rank1_int8", "int8_drift_cosine", "recognise_seconds", "detects",
             "ok", "seconds"}
TRAINED_KEYS = {"aligned_pool_sizes", "loss_at_step", "pool_seconds", "train_seconds",
                "first_loss"}
# the lines of the JAX report's layout (reports/synthetic_e2e/report.txt)
LINES = ("Using shipped detector weights: pretrained/mtcnn_synthetic.npz",
         "Enrolling identities from detector-aligned crops...",
         "  aligned pool sizes: min ", "Scene recognition rank-1: ",
         "Re-running recognition with the int8-quantized embedder...",
         "int8 embedding drift vs fp32: cosine min ", "Scene recognition rank-1 (int8): ")


def _in_order(text: str, lines) -> bool:
    at = 0
    for line in lines:
        at = text.find(line, at)
        if at < 0:
            return False
    return True


def test_run_demo_writes_the_reports(shrunk, jax_variables, tmp_path, port_run):
    weights = str(tmp_path / "ir_micro.npz")
    save_npz_variables(weights, jax_variables)
    rep = D.run_demo(device="cpu", weights=weights, out_dir=str(tmp_path / "out"))
    with open(tmp_path / "out" / "report.json") as f:
        assert json.load(f) == json.loads(json.dumps(rep))
    assert set(rep) == JSON_KEYS and not rep["embedder_trained"]
    # the demo's own run is the one the parity tests hold to JAX
    assert [list(t) for t in rep["rank1_fp32"]["trials"]] == \
        [list(t) for t in port_run["fp32"]["trials"]]
    np.testing.assert_allclose(rep["int8_drift_cosine"]["values"], port_run["drift"],
                               rtol=0, atol=1e-6)
    assert rep["ok"] == (rep["rank1_fp32"]["correct"] >= D.FLOOR * rep["rank1_fp32"]["total"]
                         and rep["rank1_int8"]["correct"]
                         >= D.FLOOR * rep["rank1_int8"]["total"])
    # every detect is one of the enrolment pool's or of the two passes' trials
    assert rep["detects"] >= rep["rank1_fp32"]["total"] + rep["rank1_int8"]["total"] + 8
    assert _in_order((tmp_path / "out" / "report.txt").read_text(), LINES)


def test_run_demo_trains_and_exports(shrunk, tmp_path, monkeypatch):
    weights = str(tmp_path / "ir_micro_synthetic_torch.npz")
    monkeypatch.setattr(D, "EMBEDDER_WEIGHTS", weights)
    monkeypatch.setattr(D, "EMBEDDER_STEPS", 2)
    monkeypatch.setattr(D, "EMBEDDER_BATCH", 8)
    monkeypatch.setattr(D, "POOL_PER_ID", 1)
    rep = D.run_demo(device="cpu", retrain=True, out_dir=str(tmp_path / "out"))
    assert set(rep) == JSON_KEYS | TRAINED_KEYS and rep["embedder_trained"]
    assert os.path.exists(weights) and np.isfinite(rep["first_loss"])
    assert rep["aligned_pool_sizes"]["max"] == 1 and rep["loss_at_step"] == {}
    assert "Training the embedder on 4 synthetic identities (2 steps)..." in \
        (tmp_path / "out" / "report.txt").read_text()


def test_committed_report():
    """reports/synthetic_e2e_torch/ (`chip_smoke.py --protocols-only demo`
    on the card): the example's exit condition, its layout, the card."""
    out = os.path.join(REPO, "reports", "synthetic_e2e_torch")
    with open(os.path.join(out, "report.json")) as f:
        rep = json.load(f)
    assert set(rep) == JSON_KEYS | TRAINED_KEYS and rep["embedder_trained"] and rep["ok"]
    assert rep["n_identities"] == 16 and "H100" in rep["card"]
    assert list(rep["loss_at_step"]) == ["100", "200", "300", "400"]
    for tier in ("rank1_fp32", "rank1_int8"):
        r = rep[tier]
        assert r["total"] == len(r["trials"]) == 20 and r["correct"] >= D.FLOOR * r["total"]
    drift = rep["int8_drift_cosine"]
    assert len(drift["values"]) == 32 and min(drift["values"]) == pytest.approx(drift["min"],
                                                                                abs=1e-5)
    with open(os.path.join(out, "report.txt")) as f:
        text = f.read()
    assert _in_order(text, ("  aligned pool sizes: min 20 max 20", "  step 400: loss ")
                     + LINES[1:])
    assert f"Scene recognition rank-1: {rep['rank1_fp32']['correct']}/20" in text
