"""`MTCNNDetector.detect`, `FaceProcessor` and `CameraFaceCapture` of the
port against the JAX package's, on the CPU.

Scenes come from `train/detector_train.py::render_identity_scene` (the port's
copy, byte-equal to the JAX renderer), upscaled with cv2 so faces are 60 px
and more; both detectors load `pretrained/mtcnn_synthetic.npz` and run the
float32 cascade. Tolerances: boxes and landmarks within 1 px (the boxes are
int32 after the map back, a sub-pixel difference may cross an integer),
scores within 1e-4, quality metrics within 1e-3 (relative, for the blur
variance), aligned crops within one grey level (round/clip of resamplers
with ulp-apart matrices).
"""

import json

import cv2
import numpy as np
import pytest
import torch

from facerecognitionpipeline_tpu.models.detector import MTCNNDetector as JDetector
from facerecognitionpipeline_tpu.pipeline.processor import FaceProcessor as JProcessor
from facerecognitionpipeline_tpu.serve.capture import CameraFaceCapture as JCapture
from facerecognitionpipeline_tpu.train import detector_train as jtrain
from facerecognitionpipeline_tpu_torch.models.detector import MTCNNDetector
from facerecognitionpipeline_tpu_torch.pipeline.processor import FaceProcessor
from facerecognitionpipeline_tpu_torch.serve.capture import CameraFaceCapture
from facerecognitionpipeline_tpu_torch.train import detector_train as ttrain
from tests.stubs import StubDetector, face_at

WEIGHTS = "pretrained/mtcnn_synthetic.npz"
DET = (320, 320)
QUALITY = {"min_det_score": 0.5, "min_face_size": 40, "max_yaw": 60, "max_pitch": 45,
           "max_roll": 45, "check_blur": True, "blur_threshold": 50}


def scene(seed, n_ids, size=160, up=2):
    rng = np.random.default_rng(seed)
    ids = [ttrain.make_identity(100 + seed * 10 + i) for i in range(n_ids)]
    img, boxes, lms, used = ttrain.render_identity_scene(ids, rng, size=size)
    return cv2.resize(img, (img.shape[1] * up, img.shape[0] * up)), boxes * up


@pytest.fixture(scope="module")
def detectors():
    kw = dict(det_size=DET, det_thresh=0.5, max_faces=8)
    return JDetector(weights_path=WEIGHTS, **kw), MTCNNDetector(
        weights_path=WEIGHTS, device="cpu", **kw)


def test_render_identity_scene_is_the_jax_renderer():
    for seed in range(3):
        ids = [jtrain.make_identity(s) for s in range(seed, seed + 3)]
        a = jtrain.render_identity_scene(ids, np.random.default_rng(seed), size=200)
        b = ttrain.render_identity_scene(ids, np.random.default_rng(seed), size=200)
        for x, y in zip(a[:3], b[:3]):
            np.testing.assert_array_equal(x, y)
        assert a[3] == b[3]


def _same_faces(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert np.abs(g["bbox"].astype(int) - w["bbox"].astype(int)).max() <= 1
        assert g["bbox"].dtype == w["bbox"].dtype == np.int32
        np.testing.assert_allclose(g["landmarks"], w["landmarks"], atol=1.0)
        assert abs(g["det_score"] - w["det_score"]) <= 1e-4


@pytest.mark.parametrize("case", ["one", "three", "non_square", "tall"])
def test_detect_like_jax(detectors, case):
    jd, td = detectors
    img, boxes = {
        "one": lambda: scene(0, 1),
        "three": lambda: scene(1, 3, size=240),
        "non_square": lambda: scene(2, 2, size=200),
        "tall": lambda: scene(3, 1),
    }[case]()
    if case == "non_square":
        img = np.ascontiguousarray(img[:300])  # 300 x 400
    if case == "tall":
        img = np.ascontiguousarray(img[:, :200])  # 320 x 200
    want, got = jd.detect(img), td.detect(img)
    _same_faces(got, want)
    h, w = img.shape[:2]
    for f in got:
        assert (f["bbox"] >= 0).all() and f["bbox"][2] <= w - 1 and f["bbox"][3] <= h - 1
    assert [f["det_score"] for f in got] == sorted((f["det_score"] for f in got), reverse=True)


def test_detect_finds_nothing_in_noise(detectors):
    jd, td = detectors
    img = np.random.default_rng(9).integers(0, 60, (200, 260, 3), dtype=np.uint8)
    assert td.detect(img) == [] == jd.detect(img)


def test_save_npz_round_trip(tmp_path):
    from facerecognitionpipeline_tpu.utils.io import load_npz_variables as jload
    from facerecognitionpipeline_tpu_torch.utils.io import load_npz_variables

    td = MTCNNDetector(det_size=(96, 96), weights_path="random", init_seed=3, device="cpu")
    path = str(tmp_path / "det.npz")
    td.save_npz(path)
    a, b = load_npz_variables(path), jload(path)
    for net in ("pnet", "rnet", "onet"):
        for layer, leaves in a[net]["params"].items():
            for k, v in leaves.items():
                np.testing.assert_array_equal(np.asarray(b[net]["params"][layer][k]), v)
    again = MTCNNDetector(det_size=(96, 96), weights_path=path, device="cpu")
    for k, v in td.nets.state_dict().items():
        assert torch.equal(again.nets.state_dict()[k], v), k
    jd = JDetector(det_size=(96, 96), weights_path=path)  # the JAX package reads it
    assert jd.pretrained


@pytest.fixture(scope="module")
def processors(detectors):
    jd, td = detectors
    return (JProcessor(output_size=112, detector=jd, quality_filter_config=QUALITY),
            FaceProcessor(output_size=112, detector=td, quality_filter_config=QUALITY,
                          device="cpu"))


def _same_results(got, want):
    _same_faces(got, want)
    for g, w in zip(got, want):
        assert g["is_valid"] == w["is_valid"]
        assert set(g) == set(w) and set(g["quality_metrics"]) == set(w["quality_metrics"])
        for k, v in w["quality_metrics"].items():
            assert abs(g["quality_metrics"][k] - v) <= 1e-3 * max(1.0, abs(v)), k
        assert g["aligned_face"].dtype == np.uint8 and g["aligned_face"].shape == (112, 112, 3)
        diff = np.abs(g["aligned_face"].astype(int) - w["aligned_face"].astype(int))
        assert diff.max() <= 1


@pytest.mark.parametrize("return_all", [False, True])
@pytest.mark.parametrize("case", ["three", "gray", "non_square"])
def test_process_numpy_like_jax(processors, case, return_all):
    jp, tp = processors
    img, _ = scene(1, 3, size=240) if case != "non_square" else scene(2, 2, size=200)
    if case == "gray":
        img = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
    if case == "non_square":
        img = np.ascontiguousarray(img[:300])
    want = jp.process_numpy(img, return_all=return_all)
    got = tp.process_numpy(img, return_all=return_all)
    _same_results(got, want)
    if not return_all:
        assert len(got) == 1


def test_process_image_and_missing_file(processors, tmp_path):
    jp, tp = processors
    img, _ = scene(4, 2, size=200)
    path = str(tmp_path / "a.png")
    cv2.imwrite(path, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    _same_results(tp.process_image(path, return_all=True), jp.process_image(path, return_all=True))
    with pytest.raises(ValueError, match="Could not load"):
        tp.process_image(str(tmp_path / "none.png"))


def test_no_faces(processors):
    jp, tp = processors
    blank = np.zeros((240, 320, 3), np.uint8)
    assert tp.process_numpy(blank) == [] == jp.process_numpy(blank)


def test_stub_detections_and_quality_gate_like_jax():
    """A fixed detection list (no cascade): the gate and the alignment alone,
    at the enrolment output size, with a face whose pose fails the gate."""
    faces = [face_at(60, 40, scale=1.2, det_score=0.9), face_at(180, 60, det_score=0.55)]
    faces[1]["landmarks"] = faces[1]["landmarks"] + np.array(
        [[0, 0], [0, 30], [0, 0], [0, 0], [0, 0]], np.float32)  # rolled
    img = np.random.default_rng(5).integers(0, 256, (240, 320, 3), dtype=np.uint8)
    cfg = {"min_det_score": 0.5, "min_face_size": 20, "check_blur": True, "blur_threshold": 10}
    jp = JProcessor(output_size=224, detector=StubDetector(faces), quality_filter_config=cfg)
    tp = FaceProcessor(output_size=224, detector=StubDetector(faces),
                       quality_filter_config=cfg, device="cpu")
    want, got = jp.process_numpy(img, return_all=True), tp.process_numpy(img, return_all=True)
    assert [g["is_valid"] for g in got] == [w["is_valid"] for w in want] == [True, False]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["bbox"], w["bbox"])
        assert np.abs(g["aligned_face"].astype(int) - w["aligned_face"].astype(int)).max() <= 1


def test_process_frames_device_matches_the_host_path(detectors):
    _, td = detectors
    tp = FaceProcessor(output_size=112, detector=td, quality_filter_config=QUALITY, device="cpu")
    frames = []
    for seed in (1, 4):
        img, _ = scene(seed, 2, size=160)
        frames.append(img)
    frames = torch.from_numpy(np.stack(frames))  # 320 x 320 = det_size, no letterbox
    det, aligned, ok, metrics = tp.process_frames_device(frames)
    assert aligned.shape == (2, 8, 112, 112, 3) and ok.shape == (2, 8)
    for b in range(2):
        host = tp.process_numpy(frames[b].numpy(), return_all=True)
        v = det["valid"][b].numpy()
        assert len(host) == int(v.sum()) > 0
        for face in host:  # each host face is one of the device slots
            i = int(np.argmin(np.abs(det["scores"][b].numpy() - face["det_score"])))
            assert bool(ok[b, i]) == face["is_valid"]
            assert np.abs(aligned[b, i].numpy() - face["aligned_face"]).max() <= 1


def _capture(cls, proc, out):
    cap = cls(synthetic=True, output_dir=out, target_frames=3, skip_frames=2,
              min_quality_score=0.3, max_frames=9, display=False, processor=proc,
              **({} if cls is JCapture else {"device": "cpu"}))
    return cap.run()


def test_camera_capture_over_a_synthetic_source_like_jax(tmp_path):
    cfg = {"min_det_score": 0.5, "min_face_size": 20, "check_blur": True, "blur_threshold": 0.0}
    faces = [face_at(150, 120, det_score=0.95), face_at(400, 200, scale=1.3, det_score=0.8)]
    jp = JProcessor(output_size=112, detector=StubDetector(faces), quality_filter_config=cfg)
    tp = FaceProcessor(output_size=112, detector=StubDetector(faces), quality_filter_config=cfg,
                       device="cpu")
    want = _capture(JCapture, jp, str(tmp_path / "jax"))
    got = _capture(CameraFaceCapture, tp, str(tmp_path / "port"))
    for key in ("total_frames_processed", "total_tracks", "completed_tracks"):
        assert got[key] == want[key], key
    assert got["completed_tracks"] == 2 and got["total_frames_processed"] == 9
    assert set(got["tracks"]) == set(want["tracks"])
    for tid, meta in want["tracks"].items():
        mine = got["tracks"][tid]
        assert mine["num_frames"] == meta["num_frames"] and mine["files"] == meta["files"]
        assert abs(mine["avg_quality"] - meta["avg_quality"]) <= 1e-3
        assert abs(mine["avg_det_score"] - meta["avg_det_score"]) <= 1e-6
    with open(tmp_path / "port" / "session_summary.json") as f:
        assert json.load(f)["completed_tracks"] == 2
    assert (tmp_path / "port" / "track_001" / "metadata.json").exists()


def test_capture_cli_parser_is_jax_plus_device():
    from facerecognitionpipeline_tpu.serve.capture import build_parser as jparser
    from facerecognitionpipeline_tpu_torch.serve.capture import build_parser

    def opts(p):
        return sorted(s for a in p._actions for s in a.option_strings)

    assert opts(build_parser()) == sorted(opts(jparser()) + ["--device"])
    assert build_parser().parse_args([]).device == "cuda"
