"""`StudentEnrollment`, `FaceMatcher` and the new CLIs of the port against
the JAX package's, on the CPU.

Both packages load the same `ir_micro` weights (`.npz` written once from the
port's own module) and the same detector file
(`pretrained/mtcnn_synthetic.npz`, float32 cascade); photos are renders of
`render_identity_scene`, upscaled so the enrolment gate (faces of 60 px,
blur 100) passes. Tolerances: templates and scores within 1e-4 (two
frameworks' convolutions; aligned crops may differ by one grey level);
student ids, names, accepted faces and match decisions equal.
"""

import json
import os

import cv2
import numpy as np
import pytest
import torch

from facerecognitionpipeline_tpu.gallery.manager import GalleryManager as JGallery
from facerecognitionpipeline_tpu.models.detector import MTCNNDetector as JDetector
from facerecognitionpipeline_tpu.pipeline.embedder import FaceEmbedder as JEmbedder
from facerecognitionpipeline_tpu.pipeline.enrollment import StudentEnrollment as JEnrollment
from facerecognitionpipeline_tpu.pipeline.matcher import FaceMatcher as JMatcher
from facerecognitionpipeline_tpu.pipeline.processor import FaceProcessor as JProcessor
from facerecognitionpipeline_tpu_torch.gallery.manager import GalleryManager
from facerecognitionpipeline_tpu_torch.models.convert import backbone_variables_from_state
from facerecognitionpipeline_tpu_torch.models.detector import MTCNNDetector
from facerecognitionpipeline_tpu_torch.models.irse import build_backbone
from facerecognitionpipeline_tpu_torch.models.layers import lecun_normal_
from facerecognitionpipeline_tpu_torch.pipeline.embedder import FaceEmbedder
from facerecognitionpipeline_tpu_torch.pipeline.enrollment import (
    ENROLLMENT_QUALITY_CONFIG,
    StudentEnrollment,
)
from facerecognitionpipeline_tpu_torch.pipeline.matcher import AGGREGATION_METHODS, FaceMatcher
from facerecognitionpipeline_tpu_torch.pipeline.processor import FaceProcessor
from facerecognitionpipeline_tpu_torch.train.detector_train import (
    make_identity,
    render_identity_scene,
)
from facerecognitionpipeline_tpu_torch.utils.io import save_npz_variables

DETECTOR = "pretrained/mtcnn_synthetic.npz"
DET = (320, 320)


def write_photo(path, identity, rng, corner_rng=None):
    img, *_ = render_identity_scene([identity], rng, size=160)
    img = cv2.resize(img, (480, 480), interpolation=cv2.INTER_LINEAR)
    if corner_rng is not None:  # another photo of the same face: a corner differs
        img[:40, :40] = corner_rng.integers(0, 256, (40, 40, 3))
    cv2.imwrite(path, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    model = build_backbone("ir_micro", folded=False)
    lecun_normal_(model, torch.Generator().manual_seed(7))
    path = str(tmp_path_factory.mktemp("w") / "ir_micro.npz")
    save_npz_variables(path, backbone_variables_from_state(model.state_dict()))
    return path


@pytest.fixture(scope="module")
def enrol_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("enrol")
    rng = np.random.default_rng(0)
    for s in range(3):
        d = root / f"student_{s}"
        d.mkdir()
        for i in range(4):
            write_photo(str(d / f"img_{i:02d}.png"), make_identity(100 + s), rng)
    (root / "not_a_dir.txt").write_text("ignored")
    return str(root)


@pytest.fixture(scope="module")
def parts(weights):
    """(JAX, port) embedders, detectors and enrolment processors."""
    je = JEmbedder("ir_micro", model_path=weights)
    te = FaceEmbedder("ir_micro", model_path=weights, device="cpu")
    jd = JDetector(det_size=DET, weights_path=DETECTOR)
    td = MTCNNDetector(det_size=DET, weights_path=DETECTOR, device="cpu")
    cfg = dict(ENROLLMENT_QUALITY_CONFIG)
    jp = JProcessor(output_size=224, detector=jd, quality_filter_config=cfg)
    tp = FaceProcessor(output_size=224, detector=td, quality_filter_config=cfg, device="cpu")
    return {"jax": (je, jd, jp), "port": (te, td, tp)}


def _enrolments(parts, tmp, **kw):
    je, _, jp = parts["jax"]
    te, _, tp = parts["port"]
    jg = JGallery(gallery_path=os.path.join(tmp, "jax", "students.pkl"),
                  aggregation_method="weighted_mean", verbose=False)
    tg = GalleryManager(gallery_path=os.path.join(tmp, "port", "students.pkl"),
                        aggregation_method="weighted_mean", verbose=False, device="cpu")
    common = dict(architecture="ir_micro", min_faces_per_student=2, **kw)
    return (JEnrollment(processor=jp, embedder=je, gallery=jg, **common),
            StudentEnrollment(processor=tp, embedder=te, gallery=tg, device="cpu", **common))


@pytest.fixture(scope="module")
def enrolled(parts, enrol_dir, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("galleries"))
    jen, ten = _enrolments(parts, tmp)
    return jen, ten, jen.enroll_from_directory(enrol_dir), ten.enroll_from_directory(enrol_dir)


def test_enrol_from_directory_like_jax(enrolled):
    jen, ten, want, got = enrolled
    for key in ("total", "successful", "failed"):
        assert got[key] == want[key], key
    assert got["successful"] >= 2
    for g, w in zip(got["results"], want["results"]):
        assert g["success"] == w["success"]
        for key in ("student_id", "name", "num_images", "num_valid_faces", "num_embeddings",
                    "error"):
            assert g["info"].get(key) == w["info"].get(key), key
        if w["success"]:
            assert abs(g["info"]["avg_similarity"] - w["info"]["avg_similarity"]) <= 1e-4
    assert got["gallery_stats"]["num_students"] == want["gallery_stats"]["num_students"]
    assert got["verification"]["correct"] == want["verification"]["correct"]
    jstudents, tstudents = jen.gallery.get_all_students(), ten.gallery.get_all_students()
    assert sorted(tstudents) == sorted(jstudents)
    for sid, rec in jstudents.items():
        mine = tstudents[sid]
        assert mine.name == rec.name and mine.num_samples == rec.num_samples
        np.testing.assert_allclose(mine.template_embedding, rec.template_embedding, atol=1e-4)
        np.testing.assert_allclose(mine.embeddings, rec.embeddings, atol=1e-4)
        assert mine.metadata["augmentation_per_face"] == 8


def test_gallery_files_load_in_either_package(enrolled):
    jen, ten, _, _ = enrolled
    jpath, tpath = jen.gallery.gallery_path, ten.gallery.gallery_path
    into_jax = JGallery(gallery_path=tpath, verbose=False)
    into_port = GalleryManager(gallery_path=jpath, verbose=False, device="cpu")
    for a, b in ((into_jax, ten.gallery), (into_port, jen.gallery)):
        sa, sb = a.get_all_students(), b.get_all_students()
        assert sorted(sa) == sorted(sb)
        for sid in sa:
            assert sa[sid].name == sb[sid].name
            np.testing.assert_allclose(sa[sid].template_embedding, sb[sid].template_embedding, atol=1e-5)


def test_next_free_student_id_and_backup(parts, enrol_dir, tmp_path):
    _, ten = _enrolments(parts, str(tmp_path))
    ten.gallery.add_student("STU0007", "someone", np.ones((1, 512), np.float32) / 512**0.5)
    ok, info = ten.process_student_directory(os.path.join(enrol_dir, "student_0"))
    assert ok and info["student_id"] == "STU0008"
    path = ten.backup(str(tmp_path / "backups"))
    assert "adaface_ir_micro_backup_" in os.path.basename(path)


def test_insufficient_faces_and_empty_directory(parts, enrol_dir, tmp_path):
    jen, ten = _enrolments(parts, str(tmp_path))
    for en in (jen, ten):
        en.min_faces = 9
        ok, info = en.process_student_directory(os.path.join(enrol_dir, "student_0"))
        assert not ok and info["error"] == "insufficient_faces" and info["required"] == 9
    (tmp_path / "empty" / "dave").mkdir(parents=True)
    assert ten.process_student_directory(str(tmp_path / "empty" / "dave")) == (
        False, {"error": "no_images"})
    assert ten.enroll_from_directory(str(tmp_path / "empty" / "dave")) == {
        "error": "no_directories"}
    with pytest.raises(ValueError, match="not found"):
        ten.enroll_from_directory(str(tmp_path / "nowhere"))


def test_image_selection_like_jax(parts, enrol_dir, tmp_path):
    d = os.path.join(enrol_dir, "student_1")
    for kw in ({"limit_images": 2}, {"image_indices": [4, 1, 9]}):
        jen, ten = _enrolments(parts, str(tmp_path / str(len(kw))), **kw)
        jen.min_faces = ten.min_faces = 1
        w, g = jen.process_student_directory(d), ten.process_student_directory(d)
        assert g[0] == w[0]
        for key in ("num_images", "num_valid_faces", "valid_faces", "error"):
            assert g[1].get(key) == w[1].get(key), key


# ------------------------------------------------------------------ matcher

def _tracks(root, crops, n_frames=4):
    """track_* directories of PNG crops (lossless) with metadata.json."""
    for t, crop in enumerate(crops):
        d = os.path.join(root, f"track_{t + 1:03d}")
        os.makedirs(d)
        for i in range(n_frames):
            cv2.imwrite(os.path.join(d, f"frame_{i:03d}.png"),
                        cv2.cvtColor(crop, cv2.COLOR_RGB2BGR))
        with open(os.path.join(d, "metadata.json"), "w") as f:
            json.dump({"track_id": t + 1, "num_frames": n_frames}, f)
    os.makedirs(os.path.join(root, "not_a_track"))


@pytest.fixture(scope="module")
def matchers(parts, tmp_path_factory):
    """Galleries of three random crops in both packages, and both matchers."""
    rng = np.random.default_rng(42)
    people = [rng.integers(0, 256, (112, 112, 3), dtype=np.uint8) for _ in range(3)]
    tmp = tmp_path_factory.mktemp("match")
    je, jd, _ = parts["jax"]
    te, td, _ = parts["port"]
    jg = JGallery(gallery_path=str(tmp / "j.pkl"), verbose=False)
    tg = GalleryManager(gallery_path=str(tmp / "t.pkl"), verbose=False, device="cpu")
    for i, crop in enumerate(people):
        jg.add_student(f"STU{i:04d}", f"Person {i}", je.extract_embeddings_batch([crop]))
        tg.add_student(f"STU{i:04d}", f"Person {i}", te.extract_embeddings_batch([crop]))
    return people, jg, tg


def _pair(parts, matchers, method="consensus", threshold=0.35):
    people, jg, tg = matchers
    je, te = parts["jax"][0], parts["port"][0]
    return (JMatcher(embedder=je, gallery=jg, aggregation_method=method,
                     similarity_threshold=threshold),
            FaceMatcher(embedder=te, gallery=tg, aggregation_method=method,
                        similarity_threshold=threshold, device="cpu"))


def _same_matches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [m[:2] for m in g] == [m[:2] for m in w]
        np.testing.assert_allclose([m[2] for m in g], [m[2] for m in w], atol=1e-4)


def test_match_faces_batch_and_single_face_like_jax(parts, matchers):
    people = matchers[0]
    jm, tm = _pair(parts, matchers)
    crops = people + [np.ascontiguousarray(people[1][10:90, 5:100])]
    _same_matches(tm.match_faces_batch(crops, top_k=2), jm.match_faces_batch(crops, top_k=2))
    _same_matches([tm.match_single_face(people[2])], [jm.match_single_face(people[2])])
    assert tm.match_single_face(people[2])[0][0] == "STU0002"
    assert tm.match_faces_batch([]) == []


@pytest.mark.parametrize("method", AGGREGATION_METHODS)
def test_match_track_like_jax(parts, matchers, method, tmp_path):
    people = matchers[0]
    _tracks(str(tmp_path), [people[1]])
    jm, tm = _pair(parts, matchers, method)
    want = jm.match_track(str(tmp_path / "track_001"))
    got = tm.match_track(str(tmp_path / "track_001"))
    assert got["recognized"] == want["recognized"] is True
    for key in ("student_id", "name", "method", "num_frames", "track_id", "metadata"):
        assert got[key] == want[key], key
    assert abs(got["confidence"] - want["confidence"]) <= 1e-4
    assert [f["student_id"] for f in got["frame_matches"]] == [
        f["student_id"] for f in want["frame_matches"]]


def test_match_track_below_threshold_and_missing_metadata(parts, matchers, tmp_path):
    people = matchers[0]
    _tracks(str(tmp_path), [people[0]])
    jm, tm = _pair(parts, matchers, threshold=1.5)
    got, want = (m.match_track(str(tmp_path / "track_001")) for m in (tm, jm))
    assert got["recognized"] is want["recognized"] is False
    assert got["reason"] == want["reason"] == "below_threshold"
    assert got["best_candidate"]["student_id"] == want["best_candidate"]["student_id"]
    os.makedirs(tmp_path / "bare")
    assert tm.match_track(str(tmp_path / "bare")) is None


def test_process_capture_directory_like_jax(parts, matchers, tmp_path):
    people = matchers[0]
    _tracks(str(tmp_path / "cap"), people[::-1])
    jm, tm = _pair(parts, matchers)
    want = jm.process_capture_directory(str(tmp_path / "cap"), save_results=False)
    got = tm.process_capture_directory(str(tmp_path / "cap"), save_results=True)
    for key in ("total_tracks", "recognized", "unrecognized", "recognition_rate",
                "student_appearances", "unique_students", "settings"):
        assert got[key] == want[key], key
    assert abs(got["avg_confidence"] - want["avg_confidence"]) <= 1e-4
    summary = tmp_path / "cap" / "adaface_ir_101_results" / "recognition_summary.json"
    assert json.loads(summary.read_text())["recognized"] == 3
    assert (tmp_path / "cap" / "track_002" / "recognition_result.json").exists()
    with pytest.raises(ValueError, match="not found"):
        tm.process_capture_directory(str(tmp_path / "none"))
    os.makedirs(tmp_path / "empty")
    assert tm.process_capture_directory(str(tmp_path / "empty")) == {"error": "no_tracks"}


def test_match_single_image_like_jax(parts, tmp_path):
    """Real detection: enrol each face of a rendered two-person scene from
    the port's own detections, then both matchers re-detect the scene."""
    je, jd, _ = parts["jax"]
    te, td, _ = parts["port"]
    img, *_ = render_identity_scene([make_identity(1), make_identity(2)],
                                    np.random.default_rng(3), size=240)
    img = cv2.resize(img, (480, 480))
    path = str(tmp_path / "scene.png")
    cv2.imwrite(path, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    quality = {"min_det_score": 0.5, "min_face_size": 40, "max_yaw": 60, "max_pitch": 45,
               "max_roll": 45, "check_blur": True, "blur_threshold": 50}
    tp = FaceProcessor(output_size=112, detector=td, quality_filter_config=quality, device="cpu")
    jp = JProcessor(output_size=112, detector=jd, quality_filter_config=quality)
    faces = tp.process_image(path, return_all=True)
    assert len(faces) == 2
    jg = JGallery(gallery_path=str(tmp_path / "g.pkl"), verbose=False)
    tg = GalleryManager(gallery_path=str(tmp_path / "g.pkl"), verbose=False, device="cpu")
    for i, f in enumerate(faces):
        jg.add_student(f"STU{i + 1:04d}", f"P{i}", je.extract_embeddings_batch([f["aligned_face"]]))
        tg.add_student(f"STU{i + 1:04d}", f"P{i}", te.extract_embeddings_batch([f["aligned_face"]]))
    jm = JMatcher(embedder=je, gallery=jg, processor=jp)
    tm = FaceMatcher(embedder=te, gallery=tg, processor=tp, device="cpu")
    want = jm.match_single_image(path, top_k=2, save_visualization=False)
    got = tm.match_single_image(path, top_k=2, save_visualization=True)
    assert got["num_faces"] == want["num_faces"] == 2
    for g, w in zip(got["matches"], want["matches"]):
        assert g["recognized"] == w["recognized"] is True
        assert [m["student_id"] for m in g["top_matches"]] == [
            m["student_id"] for m in w["top_matches"]]
        assert abs(g["confidence"] - w["confidence"]) <= 1e-4 and g["confidence"] > 0.99
        assert np.abs(np.subtract(g["bbox"], w["bbox"])).max() <= 1
    assert os.path.exists(got["visualization_path"])
    assert got["visualization_path"].endswith(os.path.join("g_match_results", "matched_scene.png"))
    blank = str(tmp_path / "blank.png")
    cv2.imwrite(blank, np.zeros((200, 200, 3), np.uint8))
    assert tm.match_single_image(blank)["num_faces"] == 0
    with pytest.raises(ValueError, match="not found"):
        tm.match_single_image(str(tmp_path / "none.png"))


def test_invalid_aggregation():
    with pytest.raises(ValueError, match="Unknown aggregation"):
        FaceMatcher(aggregation_method="vote", device="cpu")


# --------------------------------------------------------------------- CLIs

@pytest.mark.parametrize("name", ["enroll_students", "face_matcher", "detect_faces"])
def test_cli_options_are_jax_plus_device(name, capsys):
    import importlib

    jmod = importlib.import_module(f"facerecognitionpipeline_tpu.cli.{name}")
    tmod = importlib.import_module(f"facerecognitionpipeline_tpu_torch.cli.{name}")

    def opts(p):
        return sorted(s for a in p._actions for s in a.option_strings)

    assert opts(tmod.build_parser()) == sorted(opts(jmod.build_parser()) + ["--device"])
    device = next(a for a in tmod.build_parser()._actions if "--device" in a.option_strings)
    assert device.default == "cuda"
    with pytest.raises(SystemExit) as e:
        tmod.main(["--help"])
    assert e.value.code == 0
    assert "--device" in capsys.readouterr().out


def test_face_detection_cli_is_the_capture_main():
    from facerecognitionpipeline_tpu_torch.cli import face_detection
    from facerecognitionpipeline_tpu_torch.serve import capture

    assert face_detection.main is capture.main


def test_face_matcher_cli_single_image(tmp_path, capsys):
    """face_matcher --single_image end to end at ir_micro: real detection,
    the deterministic random-init embedder re-embeds the enrolled crop."""
    from facerecognitionpipeline_tpu_torch.cli.face_matcher import main

    scene, *_ = render_identity_scene([make_identity(5)], np.random.default_rng(2), size=160)
    scene = cv2.resize(scene, (320, 320))
    path = str(tmp_path / "scene.png")
    cv2.imwrite(path, cv2.cvtColor(scene, cv2.COLOR_RGB2BGR))
    detector = MTCNNDetector(det_size=(640, 640), weights_path=DETECTOR, device="cpu")
    processor = FaceProcessor(output_size=112, detector=detector, device="cpu",
                              quality_filter_config={"min_det_score": 0.5, "min_face_size": 40,
                                                     "max_yaw": 60, "max_pitch": 45,
                                                     "max_roll": 45, "check_blur": True,
                                                     "blur_threshold": 50})
    faces = processor.process_image(path, return_all=True)
    assert faces
    embedder = FaceEmbedder("ir_micro", device="cpu", random_ok=True)
    gallery = GalleryManager(gallery_path=str(tmp_path / "g.pkl"), verbose=False, device="cpu")
    gallery.add_student("SYN0005", "Identity 5",
                        embedder.extract_embeddings_batch([faces[0]["aligned_face"]]))
    gallery.save()
    rc = main(["--single_image", path, "--gallery_path", str(tmp_path / "g.pkl"),
               "--architecture", "ir_micro", "--detector_weights", DETECTOR,
               "--threshold", "0.8", "--top_k", "1", "--device", "cpu"])
    assert rc == 0
    assert "Recognized: Identity 5" in capsys.readouterr().out
    assert (tmp_path / "g_match_results" / "matched_scene.png").exists()


def test_enroll_students_cli_end_to_end(enrol_dir, weights, tmp_path, capsys):
    from facerecognitionpipeline_tpu_torch.cli.enroll_students import main

    g = str(tmp_path / "gallery" / "students.pkl")
    rc = main(["--enrollment_dir", enrol_dir, "--gallery_path", g, "--architecture",
               "ir_micro", "--model_path", weights, "--min_faces", "2", "--augmentations",
               "2", "--backup_dir", str(tmp_path / "bk"), "--device", "cpu"])
    assert rc == 0
    students = GalleryManager(gallery_path=g, verbose=False, device="cpu").get_all_students()
    assert students and all(r.metadata["augmentation_per_face"] == 2 for r in students.values())
    assert os.listdir(tmp_path / "bk")
