"""Boundaries of the PyTorch port: what it imports, where it runs, and the
committed smoke fixture."""

import ast
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "facerecognitionpipeline_tpu_torch")
# the JAX package, but not the port whose name starts the same way
FORBIDDEN = re.compile(
    r"^(jax|jaxlib|flax|optax|orbax|facerecognitionpipeline_tpu(?!_torch))(\.|$)")


def _port_sources():
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")
    yield os.path.join(REPO, "bench_torch.py")
    for script in ("torch_train_open_set.py", "torch_open_set_eval.py",
                   "torch_detector_stress_eval.py", "torch_detector_ood_eval.py",
                   "torch_recycle_soak.py", "torch_synthetic_end_to_end.py",
                   "torch_quantize_calib_transfer.py", "torch_train_profile.py",
                   "torch_train_int8_probe.py", "torch_serving_bench.py",
                   "torch_serving_host_ceiling.py", "torch_profile_budget.py",
                   "torch_profile_fused_step.py", "torch_profile_detect.py",
                   "torch_profile_gallery_scale.py"):
        yield os.path.join(REPO, "examples", script)


def test_port_never_imports_jax_or_the_jax_package():
    bad = []
    n = 0
    scanned = {os.path.relpath(p, PORT) for p in _port_sources()}
    for module in ("ops/gallery_kernel.py", "gallery/manager.py", "gallery/search.py",
                   "pipeline/engine.py", "ops/cuda_build.py", "serve/server.py",
                   "serve/tracker.py", "serve/rawproto.py", "serve/client.py",
                   "serve/live.py", "telemetry/__init__.py", "telemetry/monitor.py",
                   "telemetry/faults.py", "cli/face_recognition_server.py",
                   "cli/face_recognition_client.py", "cli/face_recognition_live.py",
                   "utils/io.py", "models/quantize.py", "ops/int8_gemm.py",
                   "train/detector_train.py", "evalharness/detection.py",
                   "models/torch_import.py", "models/onnx_import.py",
                   "models/torch_export.py", "ops/augment.py", "pipeline/processor.py",
                   "pipeline/enrollment.py", "pipeline/matcher.py", "serve/capture.py",
                   "cli/enroll_students.py", "cli/face_matcher.py", "cli/detect_faces.py",
                   "cli/face_detection.py", "utils/xlsx.py", "pipeline/preprocessing.py",
                   "pipeline/segmentation.py", "pipeline/corpus.py", "pipeline/labeling.py",
                   "evalharness/metrics.py", "evalharness/identification.py",
                   "evalharness/verification.py", "evalharness/comparison.py",
                   "evalharness/hardening.py", "evalharness/pipeline.py",
                   "cli/dataset_preprocessor.py", "cli/segment_dataset.py",
                   "cli/embedding_generator.py", "cli/probe_labeler.py",
                   "cli/label_rename_utility.py", "cli/lfw_impostor_helper.py",
                   "cli/evaluate_models.py", "cli/_detector.py", "train/losses.py",
                   "train/trainer.py", "train/checkpoint.py", "train/data.py",
                   "train/facegen.py", "train/__init__.py", "cli/train_embedder.py",
                   "evalharness/detection_ood.py", "evalharness/e2e_accuracy.py",
                   "models/irse.py", "models/convert.py", "models/layers.py",
                   "pipeline/embedder.py", "parallel/__init__.py", "parallel/mesh.py",
                   "pipeline/step_graph.py", "ops/nms_kernel.py", "../chip_smoke.py",
                   "evalharness/open_set.py", "train/open_set.py",
                   "../examples/torch_train_open_set.py",
                   "../examples/torch_open_set_eval.py", "train/detector_recipes.py",
                   "evalharness/detector_reports.py",
                   "../examples/torch_detector_stress_eval.py",
                   "../examples/torch_detector_ood_eval.py", "serve/soak.py",
                   "../examples/torch_recycle_soak.py", "evalharness/synthetic_demo.py",
                   "evalharness/quantize_transfer.py", "train/profile.py",
                   "../examples/torch_synthetic_end_to_end.py",
                   "../examples/torch_quantize_calib_transfer.py",
                   "../examples/torch_train_profile.py",
                   "../examples/torch_train_int8_probe.py", "serve/bench.py",
                   "pipeline/budget_profile.py", "../examples/torch_serving_bench.py",
                   "../examples/torch_serving_host_ceiling.py",
                   "../examples/torch_profile_budget.py", "pipeline/stage_profile.py",
                   "../examples/torch_profile_fused_step.py",
                   "../examples/torch_profile_detect.py",
                   "../examples/torch_profile_gallery_scale.py", "ops/launches.py",
                   "pipeline/step_bench.py", "../bench_torch.py"):
        assert module in scanned, module
    for path in _port_sources():
        n += 1
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
                assert node.level == 0, f"{path}: relative import"
            else:
                continue
            bad += [f"{os.path.relpath(path, REPO)}: {m}" for m in names if FORBIDDEN.match(m)]
    assert n > 30
    assert not bad, bad


def _imported(path) -> list:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    return names


@pytest.mark.parametrize("path", ["bench_torch.py",
                                  "facerecognitionpipeline_tpu_torch/pipeline/step_bench.py"])
def test_the_benchmark_entry_points_import_neither_jax_nor_bench_py(path):
    """The port's counterpart of bench.py measures the port alone: nothing of
    JAX, of the JAX package or of bench.py (a module named `bench` at the
    root) is imported, at the top or inside a function."""
    names = _imported(os.path.join(REPO, path))
    assert any(n.startswith("facerecognitionpipeline_tpu_torch") for n in names)
    bad = [n for n in names if FORBIDDEN.match(n) or re.match(r"^bench(\.|$)", n)]
    assert not bad, bad


@pytest.mark.parametrize("module,absent", [
    ("serve.server", ("cv2", "requests", "jax", "flax", "psutil", "PIL")),
    ("serve.live", ("cv2", "requests", "jax", "flax")),
    ("serve.client", ("cv2", "requests", "jax", "flax", "torch")),
    ("telemetry", ("cv2", "requests", "jax", "flax", "torch")),
    ("cli.face_recognition_server", ("cv2", "requests", "jax", "flax")),
    ("serve.soak", ("cv2", "requests", "jax", "flax", "torch")),
    ("serve.bench", ("cv2", "requests", "jax", "flax", "torch")),
])
def test_importing_the_serving_modules_pulls_in_no_optional_library(module, absent):
    """cv2, PIL and psutil are looked up at the call that needs them; requests
    and JAX are never needed."""
    code = (
        "import sys\n"
        f"import facerecognitionpipeline_tpu_torch.{module}\n"
        f"bad = [m for m in {absent!r} if m in sys.modules]\n"
        "assert not bad, bad\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        cwd=REPO, env={**os.environ, "PYTHONPATH": REPO},
    )
    assert r.returncode == 0, r.stderr[-2000:]


@pytest.mark.parametrize("module,absent", [
    ("evalharness.detection", ("pandas", "scipy", "sklearn", "matplotlib", "jax", "cv2")),
    ("evalharness.pipeline", ("sklearn", "matplotlib", "jax", "flax", "cv2")),
    ("cli.evaluate_models", ("pandas", "sklearn", "matplotlib", "jax", "cv2")),
    ("cli.lfw_impostor_helper", ("torch", "cv2", "jax", "pandas")),
    ("cli.label_rename_utility", ("torch", "cv2", "jax", "pandas")),
    ("cli.segment_dataset", ("pandas", "cv2", "jax")),
])
def test_offline_modules_import_only_what_they_need(module, absent):
    """The card has no scikit-learn and no matplotlib: the harness computes
    ROC-AUC and AP itself and plots only when asked. The int8 calibration
    imports evalharness.detection, which must stay numpy-only."""
    code = (
        "import sys\n"
        f"import facerecognitionpipeline_tpu_torch.{module}\n"
        f"bad = [m for m in {absent!r} if m in sys.modules]\n"
        "assert not bad, bad\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        cwd=REPO, env={**os.environ, "PYTHONPATH": REPO},
    )
    assert r.returncode == 0, r.stderr[-2000:]


@pytest.mark.parametrize("entry", ["preprocessor", "corpus", "labeler", "pack_gallery",
                                   "identification", "pipeline"])
def test_offline_entry_points_default_to_cuda(monkeypatch, tmp_path, entry):
    from facerecognitionpipeline_tpu_torch.evalharness import identification, metrics, pipeline
    from facerecognitionpipeline_tpu_torch.pipeline.corpus import EmbeddingGenerator
    from facerecognitionpipeline_tpu_torch.pipeline.labeling import ProbeLabeler
    from facerecognitionpipeline_tpu_torch.pipeline.preprocessing import DatasetPreprocessor

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gallery = {"a": {"embeddings": torch.ones(1, 512).numpy()}}
    make = {
        "preprocessor": lambda **kw: DatasetPreprocessor(det_size=(64, 64), **kw).processor,
        "corpus": lambda **kw: EmbeddingGenerator(
            architecture="ir_micro", output_root=str(tmp_path), **kw).embedder,
        "labeler": lambda **kw: ProbeLabeler(
            gallery_path=str(tmp_path / "g.pkl"), architecture="ir_micro", **kw).embedder,
        "pack_gallery": lambda **kw: metrics.pack_gallery(gallery, **kw)[1],
        "identification": lambda **kw: identification.evaluate_probes_comprehensive(
            gallery, {"a": gallery["a"]}, [0.5], **kw),
        "pipeline": lambda **kw: pipeline.run_complete_evaluation_pipeline(
            [], str(tmp_path), str(tmp_path / "out"), make_plots=False, **kw),
    }[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()
    assert make(device="cpu") is not None


@pytest.mark.parametrize("cli,argv", [
    ("dataset_preprocessor", ["--input_dir", "{tmp}", "--output_dir", "{tmp}/out"]),
    ("segment_dataset", ["--input_dir", "{tmp}", "--metadata_file", "{tmp}/m.json",
                         "--output_dir", "{tmp}/seg"]),
    ("embedding_generator", ["--dataset_root", "{tmp}", "--output_root", "{tmp}/out",
                             "--model_type", "adaface", "--architecture", "ir_micro"]),
    ("probe_labeler", ["--probe_dir", "{tmp}", "--gallery_path", "{tmp}/g.pkl",
                       "--architecture", "ir_micro"]),
    ("evaluate_models", ["--models", "m", "--embeddings_root", "{tmp}", "--output_dir",
                         "{tmp}/ev", "--no_plots"]),
])
def test_offline_clis_default_to_cuda_and_raise_without_it(monkeypatch, tmp_path, cli, argv):
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = importlib.import_module(f"facerecognitionpipeline_tpu_torch.cli.{cli}")
    assert module.build_parser().get_default("device") == "cuda"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        module.main([a.replace("{tmp}", str(tmp_path)) for a in argv])


@pytest.mark.parametrize("entry", ["server", "live", "monitor", "soak", "soak_example"])
def test_serving_entry_points_default_to_cuda(monkeypatch, tmp_path, entry):
    from facerecognitionpipeline_tpu_torch.serve import soak
    from facerecognitionpipeline_tpu_torch.serve.live import LiveFaceRecognition
    from facerecognitionpipeline_tpu_torch.serve.server import FaceRecognitionServer
    from facerecognitionpipeline_tpu_torch.telemetry import PerformanceMonitorServer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    make = {
        "server": lambda: FaceRecognitionServer(
            gallery_path=str(tmp_path / "g.pkl"), output_dir=str(tmp_path)),
        "live": lambda: LiveFaceRecognition(
            gallery_path=str(tmp_path / "g.pkl"), output_dir=str(tmp_path)),
        "monitor": lambda: PerformanceMonitorServer("M", "s", str(tmp_path)),
        "soak": lambda: soak.run_recycle_soak(
            [], {"path": "/process_frame", "json": {"frame": ""}}, 2, 1,
            workdir=str(tmp_path)),
        "soak_example": lambda: soak.example_soak(2, 1, workdir=str(tmp_path)),
    }[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()


@pytest.mark.parametrize("entry", ["processor", "enrollment", "matcher", "capture"])
def test_host_pipeline_entry_points_default_to_cuda(monkeypatch, tmp_path, entry):
    from facerecognitionpipeline_tpu_torch.pipeline.enrollment import StudentEnrollment
    from facerecognitionpipeline_tpu_torch.pipeline.matcher import FaceMatcher
    from facerecognitionpipeline_tpu_torch.pipeline.processor import FaceProcessor
    from facerecognitionpipeline_tpu_torch.serve.capture import CameraFaceCapture

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    make = {
        "processor": lambda **kw: FaceProcessor(det_size=(64, 64), **kw),
        "enrollment": lambda **kw: StudentEnrollment(
            gallery_path=str(tmp_path / "g.pkl"), architecture="ir_micro", **kw),
        "matcher": lambda **kw: FaceMatcher(
            gallery_path=str(tmp_path / "g.pkl"), architecture="ir_micro", **kw),
        "capture": lambda **kw: CameraFaceCapture(
            synthetic=True, output_dir=str(tmp_path / "cap"), display=False, **kw),
    }[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()


@pytest.mark.parametrize("cli,argv", [
    ("enroll_students", ["--enrollment_dir", "{tmp}", "--architecture", "ir_micro"]),
    ("face_matcher", ["--capture_dir", "{tmp}", "--architecture", "ir_micro"]),
    ("detect_faces", ["--input_dir", "{tmp}", "--output_dir", "{tmp}/out"]),
    ("face_detection", ["--synthetic", "--no_display", "--max_frames", "1",
                        "--output_dir", "{tmp}/cap"]),
])
def test_new_clis_default_to_cuda_and_raise_without_it(monkeypatch, tmp_path, cli, argv):
    """Without --device the CLIs ask for the card and raise without one; they
    never fall back to the CPU."""
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = importlib.import_module(f"facerecognitionpipeline_tpu_torch.cli.{cli}").main
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main([a.replace("{tmp}", str(tmp_path)) for a in argv])


@pytest.mark.parametrize("entry", ["demo", "transfer", "profile", "probe"])
def test_protocol_entry_points_default_to_cuda_and_raise_without_it(monkeypatch, tmp_path,
                                                                    entry):
    from facerecognitionpipeline_tpu_torch.evalharness import quantize_transfer, synthetic_demo
    from facerecognitionpipeline_tpu_torch.train import profile

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = {
        "demo": lambda: synthetic_demo.run_demo(out_dir=str(tmp_path / "out")),
        "transfer": lambda: quantize_transfer.run_transfer(weights=str(tmp_path / "w.npz")),
        "profile": lambda: profile.train_profile(batch=2, arch="ir_micro"),
        "probe": lambda: profile.int8_probe("ir_micro", 2, 8, 2),
    }[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("script", ["torch_synthetic_end_to_end", "torch_quantize_calib_transfer",
                                    "torch_train_profile", "torch_train_int8_probe"])
def test_protocol_scripts_default_to_cuda(script):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"_script_{script}", os.path.join(REPO, "examples", f"{script}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    assert module.build_parser().get_default("device") == "cuda"


def test_import_pattern_tells_the_packages_apart():
    assert FORBIDDEN.match("facerecognitionpipeline_tpu.ops.warp")
    assert FORBIDDEN.match("facerecognitionpipeline_tpu")
    assert FORBIDDEN.match("jax.numpy")
    assert FORBIDDEN.match("orbax.checkpoint") and FORBIDDEN.match("optax")
    assert not FORBIDDEN.match("facerecognitionpipeline_tpu_torch.ops.warp")
    assert not FORBIDDEN.match("jaxtyping_like")


@pytest.mark.parametrize("entry", ["detector", "embedder", "gallery", "manager"])
def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch, tmp_path, entry):
    from facerecognitionpipeline_tpu_torch.gallery.manager import GalleryManager
    from facerecognitionpipeline_tpu_torch.gallery.search import DeviceGallery
    from facerecognitionpipeline_tpu_torch.models.detector import MTCNNDetector
    from facerecognitionpipeline_tpu_torch.pipeline.embedder import FaceEmbedder

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    make = {
        "detector": lambda **kw: MTCNNDetector(det_size=(64, 64), **kw),
        "embedder": lambda **kw: FaceEmbedder("ir_micro", random_ok=True, **kw),
        "gallery": lambda **kw: DeviceGallery(**kw),
        "manager": lambda **kw: GalleryManager(
            str(tmp_path / "g.pkl"), verbose=False, **kw
        )._device,
    }[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()
    assert make(device="cpu").device.type == "cpu"


def test_gallery_kernels_are_registered_with_their_sources():
    from facerecognitionpipeline_tpu_torch.ops import cuda_build

    assert cuda_build.KERNEL_NAMES == (
        "crop_resize", "warp_patches", "gallery_topk", "gallery_topk_int8",
        "gallery_topk_f32", "nms_fixpoint",
    )
    for name in cuda_build.KERNEL_NAMES:
        assert os.path.exists(os.path.join(cuda_build.CSRC_DIR, f"{name}.cu"))
        assert os.path.basename(cuda_build._lib_path(name)).startswith(f"lib{name}-")


def test_engine_and_batcher_follow_their_parts_device():
    from facerecognitionpipeline_tpu_torch.gallery.search import DeviceGallery
    from facerecognitionpipeline_tpu_torch.models.detector import MTCNNDetector
    from facerecognitionpipeline_tpu_torch.pipeline.embedder import FaceEmbedder
    from facerecognitionpipeline_tpu_torch.pipeline.engine import RecognitionEngine
    from facerecognitionpipeline_tpu_torch.serve.batcher import DeviceBatcher

    det = MTCNNDetector(det_size=(64, 64), min_face_size=20, max_faces=2, device="cpu")
    emb = FaceEmbedder("ir_micro", random_ok=True, device="cpu")
    eng = RecognitionEngine(det, emb)
    assert eng.device.type == "cpu" and eng.align_impl == "kernel"
    b = DeviceBatcher(eng, DeviceGallery(device="cpu").device_snapshot)
    assert b.device.type == "cpu" and b.bucket_sizes == [1, 8]


def test_smoke_fixture_regenerates_byte_for_byte():
    sys.path.insert(0, os.path.join(REPO, "tests"))
    try:
        import make_smoke_scenes
    finally:
        sys.path.pop(0)
    with open(make_smoke_scenes.OUT_PATH, "rb") as f:
        committed = f.read()
    assert len(committed) <= 1_500_000
    assert make_smoke_scenes.to_bytes(make_smoke_scenes.build()) == committed


def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path):
    """No CUDA card here: the script exits non-zero and prints no result.
    Alone in a directory it fails too (here at the same check; on a card,
    at the import of the port)."""
    if torch.cuda.is_available():
        pytest.skip("this process has a CUDA card")
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), alone)
    for script in (os.path.join(REPO, "chip_smoke.py"), str(alone)):
        r = subprocess.run(
            [sys.executable, script], capture_output=True, text=True, timeout=120,
            cwd=os.path.dirname(script),
        )
        assert r.returncode != 0
        assert '"ok"' not in r.stdout
