"""The stage bisects of the port (`pipeline/stage_profile.py`,
`examples/torch_profile_{fused_step,detect,gallery_scale}.py`) held against
the JAX scripts they reproduce (`examples/profile_fused_step.py`,
`examples/profile_detect.py`, `examples/profile_gallery_scale.py`), on the
CPU.

(a) The nine cumulative detect programs against the JAX script's programs
    run through the JAX detector's methods (vmapped, one compiled program),
    B=2 (a noise frame from seed 0 as in the JAX script, and a smoke-fixture
    tile with a face), det 128, float32 cascade on `pretrained/mtcnn_dr.npz`.
    The timed [B] sums within 1e-6 relative: they carry -1e9 for every empty
    slot, reach 1e11, and so mostly count the empty slots. So each array the
    program sums is held too (`detect_parts`): the same empty (-1e9) slots,
    and every other value within 3e-4 + 1e-5 relative (measured: pyramid
    levels 3.6e-7 on [-1, 1], crops 1.1e-4 on [-1, 1], net outputs 1.4e-5,
    box corners 1.9e-4 at up to 140 px).
(b) `resize_antialiased` against `jax.image.resize(..., "linear")` (which
    antialiases on downscale) at the pyramid's sizes at det 128:
    within 5e-7 on [-1, 1] data (measured 3.6e-7, three float32 ulps at 1).
(c) The fused-step stages on the same inputs as their JAX stages: the
    quality gate (ok equal, metrics within 1e-4), the matmul alignment
    (bf16 stage B: within 2 grey levels, as the engine's 'matmul' route is
    held in test_torch_port_align_pyramid.py; measured 1.002, one bf16 ulp
    at 128-255), the embedder at ir_18 float32 on one seeded unfolded tree
    that each package folds (features within 1e-4), the gallery top-k
    (scores within 1e-5, indices equal).
(d) The sum rule: `sum of stages` adds the unindented rows but the full
    step; `align (kernel K1+K2)` is counted and the matmul row is not.
(e) Streaming is skipped where the size does not divide 4096.
(f) Every entry point on the CPU at a tiny size (ir_micro): its rows' keys
    are the JAX scripts' JSON keys (the detect bisect's without the fetch
    round trip, which the port does not subtract; the gallery rows' without
    "sync"), every replay equals its eager call, no launch counted (the
    plain versions count nothing).
(g) The three scripts take the JAX scripts' flags with their defaults,
    plus `--device` (default 'cuda'), and every entry point raises without
    a card unless given device='cpu'.

What needs the card is in `tests/test_torch_port_cuda.py`
(`test_stage_bisects_on_the_card`).
"""

import argparse
import importlib.util
import os
import re

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerecognitionpipeline_tpu.gallery.search import cosine_topk as jax_cosine_topk
from facerecognitionpipeline_tpu.models.detector import MTCNNDetector as JaxDetector
from facerecognitionpipeline_tpu.ops.image import normalize_face_batch as jax_normalize
from facerecognitionpipeline_tpu.ops.quality import QualityConfig as JaxQualityConfig
from facerecognitionpipeline_tpu.ops.quality import quality_check as jax_quality_check
from facerecognitionpipeline_tpu.ops.warp import align_faces_matmul as jax_align_matmul
from facerecognitionpipeline_tpu.ops.warp import crop_resize as jax_crop_resize
from facerecognitionpipeline_tpu.ops.warp import reference_template
from facerecognitionpipeline_tpu.pipeline.embedder import FaceEmbedder as JaxEmbedder
from facerecognitionpipeline_tpu_torch.gallery.search import DeviceGallery
from facerecognitionpipeline_tpu_torch.models.convert import backbone_variables_from_state
from facerecognitionpipeline_tpu_torch.models.detector import _NEG, MTCNNDetector
from facerecognitionpipeline_tpu_torch.models.irse import build_backbone
from facerecognitionpipeline_tpu_torch.models.layers import lecun_normal_
from facerecognitionpipeline_tpu_torch.pipeline import stage_profile as sp
from facerecognitionpipeline_tpu_torch.pipeline.embedder import FaceEmbedder
from facerecognitionpipeline_tpu_torch.pipeline.engine import RecognitionEngine

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, "pretrained", "mtcnn_dr.npz")
FIXTURE = os.path.join(REPO, "facerecognitionpipeline_tpu_torch", "testdata", "smoke_scenes.npz")
DET = 128
DET_KW = dict(det_size=(DET, DET), max_faces=8, min_face_size=40, weights_path=WEIGHTS)


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _source(name):
    with open(os.path.join(REPO, "examples", f"{name}.py")) as f:
        return f.read()


@pytest.fixture(scope="module")
def shared():
    """The float32 cascades of both packages on the same weights and the
    frames: a noise frame from seed 0 and a fixture tile with one face,
    both at det 128."""
    noise = np.random.default_rng(0).integers(0, 256, size=(DET, DET, 3), dtype=np.uint8)
    with np.load(FIXTURE) as d:
        tile = cv2.resize(d["tiles"][0], (DET, DET), interpolation=cv2.INTER_AREA)
    frames = np.stack([noise, tile])
    return {"jax": JaxDetector(**DET_KW), "port": MTCNNDetector(**DET_KW, device="cpu"),
            "frames": frames}


@pytest.fixture(scope="module")
def ir18():
    """ir_18 float32 on one seeded unfolded tree, built once for the file:
    the JAX embedder (its forward jitted, as the JAX package serves it) and
    the port's, each folding the tree itself."""
    model = build_backbone("ir_18", folded=False)
    lecun_normal_(model, torch.Generator().manual_seed(0))
    tree = backbone_variables_from_state(model.state_dict())
    jemb = JaxEmbedder("ir_18", variables=tree)
    return {"jax": jemb, "jax_apply": jax.jit(jemb.model.apply),
            "port": FaceEmbedder("ir_18", variables=tree, device="cpu")}


# ------------------------------------------------- (a) the detect programs


def _jax_programs(det):
    """The programs of `examples/profile_detect.py:60-179`, as written there
    (per frame, vmapped by the caller), each returning the tuple of arrays
    whose sums the JAX program adds."""
    from facerecognitionpipeline_tpu.models.detector import _square

    h = w = DET
    import math

    def norm(frame):
        return (frame.astype(jnp.float32) - 127.5) / 128.0

    def prog_pyr(v, frame):
        return tuple(det._pyramid(norm(frame)))

    def prog_pyr_direct(v, frame):
        img = norm(frame)
        outs = []
        for scale in det.scales:
            sh, sw = int(math.ceil(h * scale)), int(math.ceil(w * scale))
            outs.append(jax.image.resize(img, (sh, sw, 3), method="linear"))
        return tuple(outs)

    def prog_s1(v, frame):
        return det._stage1(v, norm(frame))

    def s2_crops(v, img, boxes):
        sq = jnp.clip(_square(boxes), 0, max(h, w))
        s = max(h, w) // det.rnet_crop_downscale
        small = jax_crop_resize(img, jnp.array([[0.0, 0.0, float(w), float(h)]], jnp.float32),
                                s, compute_dtype=det._crop_dtype)[0]
        sx, sy = s / float(w), s / float(h)
        return det._crop(small, sq * jnp.array([sx, sy, sx, sy], jnp.float32), 24)

    def prog_s2crop(v, frame):
        img = norm(frame)
        boxes, scores, valid = det._stage1(v, img)
        return s2_crops(v, img, boxes), scores, valid

    def prog_s2rnet(v, frame):
        img = norm(frame)
        boxes, scores, valid = det._stage1(v, img)
        prob, reg = det.rnet.apply(v["rnet"], s2_crops(v, img, boxes))
        return prob, reg, scores, valid

    def prog_s2(v, frame):
        img = norm(frame)
        return det._stage2(v, img, *det._stage1(v, img))

    def s3(v, frame):
        img = norm(frame)
        boxes, scores, valid = det._stage2(v, img, *det._stage1(v, img))
        sq = jnp.clip(_square(boxes), 0, max(h, w))
        return det._crop(img, sq, 48), scores, valid

    def prog_s3crop(v, frame):
        return s3(v, frame)

    def prog_s3onet(v, frame):
        crops, scores, valid = s3(v, frame)
        prob, reg, lmk = det.onet.apply(v["onet"], crops)
        return prob, reg, lmk, scores, valid

    def prog_full(v, frame):
        out = det._cascade(v, frame)
        return out["bboxes"], out["scores"], out["valid"]

    return [prog_pyr, prog_pyr_direct, prog_s1, prog_s2crop, prog_s2rnet, prog_s2,
            prog_s3crop, prog_s3onet, prog_full]


def _summed(prog):
    """The JAX program as the script times it: the sum of its arrays."""
    def fn(v, frame):
        parts = prog(v, frame)
        return sum(x.sum() for x in parts), parts

    return fn


def test_detect_programs_give_the_jax_programs_values(shared):
    jdet, frames = shared["jax"], shared["frames"]
    progs = [_summed(p) for p in _jax_programs(jdet)]
    every = jax.jit(lambda v, f: [jax.vmap(p, in_axes=(None, 0))(v, f) for p in progs])
    want = every(jdet.variables, jnp.asarray(frames))
    port_frames = torch.from_numpy(frames)
    port = sp.detect_programs(shared["port"], port_frames)
    parts = sp.detect_parts(shared["port"], port_frames)
    assert [name for name, _ in port] == [name for name, _ in parts] == list(sp.DETECT_PROGRAMS)
    for (name, fn), (_, parts_fn), (w_total, w_parts) in zip(port, parts, want):
        with torch.inference_mode():
            got, got_parts = fn().double().numpy(), parts_fn()
        assert got.shape == (2,), name
        np.testing.assert_allclose(got, np.asarray(w_total, np.float64), rtol=1e-6, atol=1e-3,
                                   err_msg=name)
        assert len(got_parts) == len(w_parts), name
        for i, (g, w) in enumerate(zip(got_parts, w_parts)):
            g, w = g.reshape(2, -1).float().numpy(), np.asarray(w, np.float32).reshape(2, -1)
            empty = w <= _NEG / 2
            np.testing.assert_array_equal(g <= _NEG / 2, empty, err_msg=f"{name} [{i}] empty")
            np.testing.assert_allclose(g[~empty], w[~empty], rtol=1e-5, atol=3e-4,
                                       err_msg=f"{name} [{i}]")
    # the face tile's cascade keeps a face: the later programs carry it
    out = shared["port"].detect_device(port_frames)
    assert bool(out["valid"][1].any())


def test_detect_program_names_are_the_jax_scripts():
    names = re.findall(r'\("([^"]+)", prog_\w+\)', _source("profile_detect"))
    assert names == list(sp.DETECT_PROGRAMS)


# --------------------------------------------------- (b) antialiased resize


def test_resize_antialiased_matches_jax_image_resize(shared):
    """Every level of the pyramid downscales: within 5e-7 on [-1, 1] data
    (measured 3.6e-7). Upscaling (which the pyramid never does) differs by
    up to 2.7e-5 through the weights' rounding, and is not held here."""
    img = (shared["frames"].astype(np.float32) - 127.5) / 128.0
    sizes = [(int(np.ceil(DET * s)), int(np.ceil(DET * s))) for s in shared["port"].scales]
    for sh, sw in sizes + [(50, 70), (DET, DET)]:  # off-square, and the same size
        want = np.stack([np.asarray(jax.image.resize(jnp.asarray(x), (sh, sw, 3), "linear"))
                         for x in img])
        got = sp.resize_antialiased(torch.from_numpy(img), sh, sw).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=5e-7, err_msg=str((sh, sw)))


# ------------------------------------------------ (c) the fused-step stages


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_np(v) for v in tree)
    return tree.numpy()


def test_fused_stages_give_the_jax_stages_outputs(shared, ir18):
    jemb = ir18["jax"]
    engine = RecognitionEngine(shared["port"], ir18["port"], top_k=3)
    t = np.random.default_rng(1).normal(size=(128, 512)).astype(np.float32)
    t /= np.linalg.norm(t, axis=1, keepdims=True)
    gallery = DeviceGallery(device="cpu")
    gallery.rebuild([f"id{i}" for i in range(128)], t)
    templates, valid, _ = gallery.device_snapshot()
    stages, inputs = sp.fused_stages(engine, torch.from_numpy(shared["frames"]), templates,
                                     valid)
    stages = dict(stages)
    with torch.inference_mode():
        got = {name: _np(fn()) for name, fn in stages.items()}
    det_out, aligned0 = _np(inputs["det_out"]), inputs["aligned0"].numpy()
    frames_f32 = inputs["frames_f32"].numpy()

    tmpl = jnp.asarray(reference_template(112))
    want = jax.jit(jax.vmap(lambda img, lmk: jax_align_matmul(img, lmk, tmpl, 112)))(
        jnp.asarray(frames_f32), jnp.asarray(det_out["landmarks"]))
    np.testing.assert_allclose(got["  align (matmul warp, alt)"], np.asarray(want), atol=2.0)
    np.testing.assert_array_equal(aligned0, got["  align (matmul warp, alt)"])

    cfg = JaxQualityConfig(min_det_score=0.5, min_face_size=40, check_blur=True,
                           blur_threshold=50.0)
    ok, metrics = jax.jit(jax.vmap(lambda s, b, lm, a, v: jax_quality_check(
        s, b, lm, cfg, aligned_faces=a, valid_mask=v)))(
        det_out["scores"], det_out["bboxes"], det_out["landmarks"], aligned0,
        det_out["valid"])
    got_ok, got_metrics = got["quality gate"]
    np.testing.assert_array_equal(got_ok, np.asarray(ok))
    assert got_metrics.keys() == metrics.keys()
    for k in metrics:
        np.testing.assert_allclose(got_metrics[k], np.asarray(metrics[k]), rtol=1e-4,
                                   atol=1e-4, err_msg=k)

    n = aligned0.shape[0] * aligned0.shape[1]
    feats, norms = ir18["jax_apply"](
        jemb.variables, jax_normalize(jnp.asarray(aligned0.reshape(n, 112, 112, 3))))
    got_feats, got_norms = got[f"embed (ir_18 x {n})"]
    np.testing.assert_allclose(got_feats, np.asarray(feats), atol=1e-4)
    np.testing.assert_allclose(got_norms, np.asarray(norms), rtol=1e-4)
    np.testing.assert_array_equal(inputs["feats0"].numpy(), got_feats)

    scores, idx = jax_cosine_topk(jnp.asarray(got_feats), jnp.asarray(templates.numpy()),
                                  jnp.asarray(valid.numpy()), 3)
    got_scores, got_idx = got["gallery topk (128)"]
    np.testing.assert_allclose(got_scores, np.asarray(scores), atol=1e-5)
    np.testing.assert_array_equal(got_idx, np.asarray(idx))


# -------------------------------------------------------- (d) the sum rule


def test_sum_of_stages_counts_the_unindented_rows_but_the_full_step():
    rows = [{"stage": name, "ms": ms} for name, ms in [
        ("detect (cascade)", 10.0), ("  stage1 (pnet pyramid+nms)", 100.0),
        ("  align (matmul warp, alt)", 1000.0), ("align (kernel K1+K2)", 2.0),
        ("quality gate", 0.5), ("embed (ir_101 x 256)", 7.0),
        ("gallery topk (1024)", 0.25), ("FULL fused step", 10000.0)]]
    assert sp.sum_of_stages(rows) == 19.75
    rows[3]["device_ms"] = None
    assert sp.sum_of_stages([{**r, "device_ms": r.get("device_ms", 1.0)} for r in rows],
                            "device_ms") is None


# ------------------------------------------------------- (e) the skip rule


def test_gallery_cases_skip_streaming_off_the_chunk():
    sizes, impls = (1024, 131072, 1048576, 5000), ("dense", "streaming", "streaming_int8")
    want = []
    for g in sizes:  # the JAX script's loop (`:129-134`)
        for impl in impls:
            if impl.startswith("streaming") and g % 4096:
                continue
            want.append((g, impl))
    assert sp.gallery_cases(sizes, impls) == want
    assert (1024, "streaming") not in want and (131072, "streaming_int8") in want


# ------------------------------------------ (f) the entry points, tiny size

FUSED_JAX_KEYS = ["detect (cascade)", "  stage1 (pnet pyramid+nms)", "  stage2 (rnet)",
                  "  stage3 (onet)", "  align (matmul warp, alt)", "align (pallas stage-B)",
                  "quality gate", "embed (ir_101 x %d)", "gallery topk (1024)",
                  "FULL fused step"]
COMMON = {"ms", "device_ms", "launches", "replay_equals_eager", "samples", "chain", "timing",
          "device", "card", "power_limit"}


def _on_cpu(row):
    assert (row["device"], row["card"], row["power_limit"], row["device_ms"]) == (
        "cpu", None, None, None)
    assert row["timing"] == "host-clock" and row["launches"] == {}
    assert row["replay_equals_eager"] is True


def test_profile_fused_step_rows_on_the_cpu():
    source = _source("profile_fused_step")
    for key in FUSED_JAX_KEYS:
        assert f'"{key}"' in source, key
    seen = []
    rows = sp.profile_fused_step(b=1, faces=2, det=64, chain=1, samples=1,
                                 architecture="ir_micro", device="cpu", on_row=seen.append)
    assert seen == rows
    want = [k.replace("align (pallas stage-B)", "align (kernel K1+K2)")
            .replace("ir_101 x %d", "ir_micro x 2") for k in FUSED_JAX_KEYS]
    assert [r["stage"] for r in rows] == want
    for r in rows:
        assert r.keys() == COMMON | {"stage", "config"}
        assert r["config"] == "B=1 F=2 det=64 ir_micro bf16" and r["ms"] > 0
        _on_cpu(r)
    counted = [r["ms"] for r in rows if r["stage"] in (
        "detect (cascade)", "align (kernel K1+K2)", "quality gate", "embed (ir_micro x 2)",
        "gallery topk (1024)")]
    assert sp.sum_of_stages(rows) == pytest.approx(sum(counted), rel=1e-12)


def test_profile_detect_rows_on_the_cpu():
    rows = sp.profile_detect(b=1, det=64, chain=1, samples=2, device="cpu")
    assert [r["program"] for r in rows] == list(sp.DETECT_PROGRAMS)
    prev = 0.0
    for r in rows:
        assert r.keys() == COMMON | {"program", "median_ms", "delta_ms"}
        assert r["ms"] <= r["median_ms"] and r["delta_ms"] == pytest.approx(r["ms"] - prev)
        prev = r["ms"]
        _on_cpu(r)


def test_profile_gallery_scale_rows_on_the_cpu():
    rows = sp.profile_gallery_scale(b=1, faces=2, det=64, sizes=(1024, 4096),
                                    impls=("dense", "streaming", "streaming_int8"), chain=1,
                                    samples=1, architecture="ir_micro", device="cpu")
    assert [(r["gallery_size"], r["gallery_impl"]) for r in rows] == [
        (1024, "dense"), (4096, "dense"), (4096, "streaming"), (4096, "streaming_int8")]
    jax_keys = set(re.findall(r'"(\w+)": ', _source("profile_gallery_scale"))) - {"sync"}
    assert jax_keys == {"gallery_size", "gallery_impl", "p50_step_ms", "faces_per_sec"}
    for r in rows:
        assert r.keys() == (COMMON - {"ms"}) | jax_keys
        assert r["faces_per_sec"] > 0
        _on_cpu(r)
    with pytest.raises(ValueError, match="unknown gallery impl"):
        sp.profile_gallery_scale(impls=("sparse",), device="cpu")


def test_seeded_templates_are_unit_rows_or_their_int8_pair():
    t = sp.seeded_templates(64, "streaming", torch.device("cpu"))
    assert t.dtype == torch.bfloat16 and t.shape == (64, 512)
    np.testing.assert_allclose(torch.linalg.vector_norm(t.float(), dim=1), 1.0, atol=1e-2)
    codes, scales = sp.seeded_templates(64, "streaming_int8", torch.device("cpu"))
    assert codes.dtype == torch.int8 and scales.shape == (64,)
    assert torch.equal(sp.seeded_templates(64, "dense", torch.device("cpu")), t)


# ------------------------------------------- (g) the scripts and the card


def _dests(parser) -> dict:
    return {a.dest: (a.default, a.choices) for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("name", ["profile_fused_step", "profile_detect",
                                  "profile_gallery_scale"])
def test_scripts_take_the_jax_scripts_flags_and_device(monkeypatch, name):
    class Parsed(Exception):
        pass

    def capture(self, *args, **kw):
        raise Parsed(self)

    jax_script, port = _example(name), _example(f"torch_{name}")
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(Parsed) as caught:
        jax_script.main()
    monkeypatch.undo()
    want, got = _dests(caught.value.args[0]), _dests(port.build_parser())
    assert got.pop("device") == ("cuda", None)
    assert got == want


@pytest.mark.parametrize("entry", ["fused", "detect", "gallery"])
def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = {"fused": sp.profile_fused_step, "detect": sp.profile_detect,
            "gallery": sp.profile_gallery_scale}[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()


def test_capture_stage_on_the_cpu_is_the_eager_function():
    calls = []

    def fn():
        calls.append(torch.is_inference_mode_enabled())
        return {"x": torch.arange(3)}

    stage = sp.capture_stage(fn, "cpu")
    assert stage.recorded == () and torch.equal(stage.outputs["x"], torch.arange(3))
    assert sp.same_tree(stage.run(), stage.outputs) and calls == [True, True]
    assert not sp.same_tree({"x": torch.arange(3)}, {"x": torch.arange(3.0)})
    nan = torch.tensor([1.0, float("nan")])
    assert sp.same_tree((nan,), (nan.clone(),))
    assert not sp.same_tree((nan,), (torch.tensor([1.0, 2.0]),))
