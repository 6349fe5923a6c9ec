"""The port's packed pyramid, dense ('matmul') alignment, alignment routes
of the engine and the single names it took from the JAX package, against
the JAX package on the CPU.

* `pack_pyramid`: the cases of tests/test_pyramid_pack.py on the port (the
  shelf layout equal to the JAX one, P-net's output extent, every region's
  submap of the canvas maps equal to P-net over that scale alone, packed
  and per-scale cascades finding the same faces), and the packed cascade
  against the JAX packed cascade: the same detections, boxes within 1e-2 px.
* `align_faces_matmul` / `warp_affine_single_matmul`: the cases of
  tests/test_warp.py at its tolerances (float32 within 0.02 of the gather
  path for in-patch faces, bf16 within 2.0; cv2 within 1.0; oversized faces
  mean error < 1 and max < 60; finite output for degenerate landmarks), and
  against the JAX functions: float32 within 0.02, the stage-A/B geometry
  within 1e-4 px (windows of in-patch faces are integers and equal), the
  hat matrices equal.
* the engine's align_impl 'matmul', 'gather' and 'pallas' (= 'kernel') on
  the same detections as the JAX engine's: aligned crops within 2 grey
  levels ('matmul', bf16 stage B) or 1 ('gather') of the JAX crops.
* `init_detector_variables`, `rgb_to_i420_host`, `ARCFACE_TEMPLATE` and the
  package re-exports.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import facerecognitionpipeline_tpu as jpkg
from facerecognitionpipeline_tpu.models import detector as jdet
from facerecognitionpipeline_tpu.models.detector_nets import (
    init_detector_variables as jax_init_detector_variables,
)
from facerecognitionpipeline_tpu.ops import warp as jwarp
from facerecognitionpipeline_tpu.ops.image import rgb_to_i420_host as jax_i420
from facerecognitionpipeline_tpu.pipeline.embedder import FaceEmbedder as JaxEmbedder
from facerecognitionpipeline_tpu.pipeline.engine import RecognitionEngine as JaxEngine
import facerecognitionpipeline_tpu_torch as tpkg
from facerecognitionpipeline_tpu_torch.models import detector as tdet
from facerecognitionpipeline_tpu_torch.models.detector_nets import (
    PNet,
    init_detector_variables,
)
from facerecognitionpipeline_tpu_torch.ops import warp as twarp
from facerecognitionpipeline_tpu_torch.ops.image import rgb_to_i420_host
from facerecognitionpipeline_tpu_torch.pipeline.embedder import FaceEmbedder
from facerecognitionpipeline_tpu_torch.pipeline.engine import RecognitionEngine
from facerecognitionpipeline_tpu_torch.serve.rawproto import rgb_to_i420

torch.set_num_threads(2)
WEIGHTS = "pretrained/mtcnn_dr.npz"


def _repo(path):
    import os

    return os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), path)


# ----------------------------------------------------------- pack_pyramid


def test_pack_layout_matches_jax_and_keeps_its_invariants():
    for h, w, minf in [(640, 640, 40), (320, 320, 18), (480, 640, 20)]:
        det = tdet.MTCNNDetector(det_size=(h, w), min_face_size=minf,
                                 weights_path="random", device="cpu")
        ch, cw, regions = tdet._pack_pyramid(h, w, det.scales)
        assert (ch, cw, regions) == jdet._pack_pyramid(h, w, det.scales)
        assert len(regions) == len(det.scales)
        assert ch % 2 == 0 and cw % 2 == 0
        occupied = np.zeros((ch, cw), bool)
        for sh, sw, oy, ox in regions:
            assert sh % 2 == 0 and sw % 2 == 0 and oy % 2 == 0 and ox % 2 == 0
            assert oy + sh <= ch and ox + sw <= cw
            assert not occupied[oy:oy + sh, ox:ox + sw].any()
            occupied[oy:oy + sh, ox:ox + sw] = True
        assert regions[0][0] >= regions[-1][0]


def test_pnet_out_dim_matches_network():
    net = PNet()
    for s in (14, 48, 192):
        prob, _ = net(torch.zeros((1, s, s, 3)))
        assert prob.shape[1] == tdet._pnet_out_dim(s) == jdet._pnet_out_dim(s)


def test_packed_submaps_equal_per_scale_pnet():
    """P-net over the canvas = P-net per scale inside every region."""
    det = tdet.MTCNNDetector(det_size=(320, 320), min_face_size=18, weights_path="random",
                             pack_pyramid=True, device="cpu")
    ch, cw, regions = det._canvas_hw
    img = torch.from_numpy(np.random.default_rng(0).normal(size=(1, 320, 320, 3))
                           .astype(np.float32))
    canvas = torch.zeros((1, ch, cw, 3))
    levels = det._pyramid(img)
    for (sh, sw, oy, ox), level in zip(regions, levels):
        assert level.shape[1:3] == (sh, sw)
        canvas[:, oy:oy + sh, ox:ox + sw] = level
    with torch.no_grad():
        prob, reg = det.nets.pnet(canvas)
        for (sh, sw, oy, ox), level in zip(regions, levels):
            p1, r1 = det.nets.pnet(level)
            fh, fw = tdet._pnet_out_dim(sh), tdet._pnet_out_dim(sw)
            a, b = oy // 2, ox // 2
            np.testing.assert_allclose(prob[0, a:a + fh, b:b + fw].numpy(), p1[0].numpy(),
                                       rtol=0, atol=1e-6)
            np.testing.assert_allclose(reg[0, a:a + fh, b:b + fw].numpy(), r1[0].numpy(),
                                       rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", [3, 11])
def test_packed_cascade_detection_parity(seed):
    """Packed vs per-scale in the port (the same faces, IoU > 0.8, as the
    JAX test), and the port's packed cascade against the JAX one."""
    from facerecognitionpipeline_tpu.evalharness.detection import iou_matrix, render_stress_scene

    kw = dict(det_size=(320, 320), max_faces=32, min_face_size=18,
              stage_thresholds=(0.6, 0.6, 0.5), weights_path=_repo(WEIGHTS))
    packed = tdet.MTCNNDetector(pack_pyramid=True, device="cpu", **kw)
    unpacked = tdet.MTCNNDetector(pack_pyramid=False, device="cpu", **kw)
    img, gt = render_stress_scene(np.random.default_rng(seed), "baseline", size=320)
    fp, fu = packed.detect(img), unpacked.detect(img)
    assert len(fp) == len(fu) == len(gt)
    bp = np.array([f["bbox"] for f in fp], np.float32)
    bu = np.array([f["bbox"] for f in fu], np.float32)
    assert (iou_matrix(bp, bu).max(axis=1) > 0.8).all()
    jd = jdet.MTCNNDetector(pack_pyramid=True, **kw)
    a = jax.device_get(jd._detect_batch(jd.variables, jnp.asarray(img[None], jnp.float32)))
    b = packed.detect_device(torch.from_numpy(img[None].astype(np.float32)))
    valid = a["valid"]
    np.testing.assert_array_equal(b["valid"].numpy(), valid)
    np.testing.assert_allclose(b["bboxes"].numpy()[valid], a["bboxes"][valid], atol=1e-2)
    np.testing.assert_allclose(b["landmarks"].numpy()[valid], a["landmarks"][valid], atol=1e-2)


# ------------------------------------------------------- dense alignment


def _mats(rng, n, s_lo, s_hi, t_lo=20, t_hi=100):
    out = []
    for _ in range(n):
        theta = rng.uniform(-0.4, 0.4)
        s = rng.uniform(s_lo, s_hi)
        tx, ty = rng.uniform(t_lo, t_hi, size=2)
        out.append(np.array([[s * np.cos(theta), -s * np.sin(theta), tx],
                             [s * np.sin(theta), s * np.cos(theta), ty]], np.float32))
    return np.stack(out)


# each case draws its data as the JAX test does (its `rng` fixture is
# default_rng(0) per test)


def test_warp_matmul_matches_gather_exactly_for_in_patch_faces():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, size=(320, 320, 3)).astype(np.float32)
    mats = _mats(rng, 6, 1.3, 2.0)
    ti, tm = torch.from_numpy(img), torch.from_numpy(mats)
    gather = twarp.warp_affine_single(ti, tm, 112, 112).numpy()
    dense = twarp.warp_affine_single_matmul(ti, tm, 112, 112,
                                            compute_dtype=torch.float32).numpy()
    np.testing.assert_allclose(dense, gather, atol=0.02)
    bf16 = twarp.warp_affine_single_matmul(ti, tm, 112, 112).numpy()
    np.testing.assert_allclose(bf16, gather, atol=2.0)
    jax_dense = np.asarray(jwarp.warp_affine_single_matmul(
        jnp.asarray(img), jnp.asarray(mats), 112, 112, compute_dtype=jnp.float32))
    np.testing.assert_allclose(dense, jax_dense, atol=0.02)


def test_warp_matmul_cv2_golden_in_patch():
    img = np.random.default_rng(0).integers(0, 256, size=(240, 300, 3)).astype(np.float32)
    theta, s, tx, ty = 0.25, 1.5, 60.0, 40.0
    m = np.array([[s * np.cos(theta), -s * np.sin(theta), tx],
                  [s * np.sin(theta), s * np.cos(theta), ty]], np.float32)
    ours = twarp.warp_affine_single_matmul(torch.from_numpy(img), torch.from_numpy(m[None]),
                                           112, 112, compute_dtype=torch.float32)[0].numpy()
    golden = cv2.warpAffine(img, m, (112, 112), flags=cv2.INTER_LINEAR,
                            borderMode=cv2.BORDER_CONSTANT, borderValue=0)
    np.testing.assert_allclose(ours, golden, atol=1.0)


def test_warp_matmul_oversized_faces_bounded():
    rng = np.random.default_rng(0)
    img = cv2.GaussianBlur(rng.integers(0, 256, size=(320, 320, 3)).astype(np.float32),
                           (9, 9), 3)
    theta, s = 0.2, 0.6
    m = np.array([[s * np.cos(theta), -s * np.sin(theta), 30.0],
                  [s * np.sin(theta), s * np.cos(theta), 20.0]], np.float32)
    ti, tm = torch.from_numpy(img), torch.from_numpy(m[None])
    gather = twarp.warp_affine_single(ti, tm, 112, 112).numpy()
    dense = twarp.warp_affine_single_matmul(ti, tm, 112, 112,
                                            compute_dtype=torch.float32).numpy()
    assert np.abs(dense - gather).mean() < 1.0
    np.testing.assert_allclose(dense, gather, atol=60.0)


def test_align_faces_matmul_matches_align_faces_and_jax():
    template = twarp.reference_template(112).astype(np.float32)
    image = np.random.default_rng(0).integers(0, 256, size=(240, 320, 3), dtype=np.uint8)
    theta, s = -0.3, 1.6
    m = np.array([[s * np.cos(theta), -s * np.sin(theta), 25.0],
                  [s * np.sin(theta), s * np.cos(theta), 35.0]], np.float32)
    inv = cv2.invertAffineTransform(m)
    lms = ((template @ inv[:, :2].T) + inv[:, 2])[None].astype(np.float32)
    ti, tl, tt = (torch.from_numpy(image.astype(np.float32)), torch.from_numpy(lms),
                  torch.from_numpy(template))
    ref = twarp.align_faces(ti, tl, tt, 112).numpy()
    got = twarp.align_faces_matmul(ti, tl, tt, 112, compute_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, ref, atol=0.02)
    jgot = np.asarray(jwarp.align_faces_matmul(image, lms, template, 112,
                                               compute_dtype=jnp.float32))
    np.testing.assert_allclose(got, jgot, atol=0.02)


def test_align_faces_matmul_degenerate_landmarks_are_finite():
    template = torch.from_numpy(twarp.reference_template(112).astype(np.float32))
    out = twarp.align_faces_matmul(torch.full((160, 160, 3), 128.0), torch.zeros((4, 5, 2)),
                                   template, 112)
    assert out.shape == (4, 112, 112, 3) and torch.isfinite(out).all()


def test_dense_warp_geometry_matches_jax():
    rng = np.random.default_rng(4)
    mats = np.concatenate([_mats(rng, 4, 1.3, 2.0), _mats(rng, 4, 0.5, 0.9)])
    jb, jpx, jpy = jwarp.warp_geometry(jnp.asarray(mats), 112, 112, 128)
    tb, tpx, tpy = twarp.warp_geometry(torch.from_numpy(mats), 112, 112, 128)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tpx.numpy(), np.asarray(jpx), atol=1e-4)
    np.testing.assert_allclose(tpy.numpy(), np.asarray(jpy), atol=1e-4)
    starts = jnp.asarray(rng.uniform(-5, 50, 6).astype(np.float32))
    sizes = jnp.asarray(rng.uniform(10, 90, 6).astype(np.float32))
    np.testing.assert_array_equal(
        twarp._interp_matrix(torch.from_numpy(np.array(starts)),
                             torch.from_numpy(np.array(sizes)), 24, 64).numpy(),
        np.asarray(jwarp._interp_matrix(starts, sizes, 24, 64)))
    jinv, jbox = jwarp._source_windows(jnp.asarray(mats), 112, 112, 128)
    tinv, tbox = twarp._source_windows(torch.from_numpy(mats), 112, 112, 128)
    np.testing.assert_allclose(tbox.numpy(), np.asarray(jbox), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(twarp.ARCFACE_TEMPLATE, jwarp.ARCFACE_TEMPLATE)


# ------------------------------------------------- the engine's routes


@pytest.fixture(scope="module")
def detections():
    """The JAX engine's detections on fixture tiles (float32 cascade), with
    the JAX and port embedders on the same ir_micro weights."""
    with np.load(_repo("facerecognitionpipeline_tpu_torch/testdata/smoke_scenes.npz")) as d:
        frames = np.ascontiguousarray(d["tiles"][:2])
    kw = dict(det_size=(160, 160), max_faces=4, min_face_size=40,
              weights_path=_repo(WEIGHTS))
    jd = jdet.MTCNNDetector(**kw)
    det = jax.device_get(jd._detect_batch(jd.variables, jnp.asarray(frames, jnp.float32)))
    assert det["valid"].any()
    jemb = JaxEmbedder("ir_micro", random_ok=True)
    params = jax.tree_util.tree_map(np.asarray, jemb.variables["params"])
    return {
        "frames": frames, "det": det, "jax": (jd, jemb),
        "port": (tdet.MTCNNDetector(**kw, crop_impl="matmul", device="cpu"),
                 FaceEmbedder("ir_micro", variables={"params": params}, device="cpu")),
    }


@pytest.mark.parametrize("impl,tol", [("matmul", 2), ("gather", 1)])
def test_engine_align_routes_match_jax(detections, impl, tol):
    frames, det = detections["frames"], detections["det"]
    jeng = JaxEngine(*detections["jax"], align_impl=impl)
    want = np.asarray(jax.jit(jeng._align_batch)(jnp.asarray(frames, jnp.float32),
                                                 jnp.asarray(det["landmarks"])))
    want = np.clip(np.round(want), 0, 255)
    teng = RecognitionEngine(*detections["port"], align_impl=impl)
    got = teng._align(teng._shards[0], torch.from_numpy(frames).float(),
                      torch.from_numpy(np.array(det["landmarks"]))).round().clamp(0, 255).numpy()
    valid = det["valid"]
    diff = np.abs(got[valid] - want[valid])
    assert diff.max() <= tol, diff.max()
    assert (diff == 0).mean() >= 0.99


def test_engine_pallas_route_is_the_kernel_route(detections):
    teng = RecognitionEngine(*detections["port"], align_impl="pallas")
    assert teng.align_impl == "kernel"
    assert RecognitionEngine(*detections["port"]).align_impl == "kernel"
    with pytest.raises(ValueError, match="align_impl"):
        RecognitionEngine(*detections["port"], align_impl="mxu")


# ------------------------------------------------------- single names


def test_init_detector_variables_match_the_jax_structure():
    ours, theirs = init_detector_variables(3), jax.eval_shape(jax_init_detector_variables, 3)
    flat = jax.tree_util.tree_flatten_with_path
    a, b = flat(ours)[0], flat(theirs)[0]
    assert [jax.tree_util.keystr(p) for p, _ in a] == [jax.tree_util.keystr(p) for p, _ in b]
    assert all(np.shape(u) == np.shape(v) for (_, u), (_, v) in zip(a, b))
    det = tdet.MTCNNDetector(det_size=(48, 48), weights_path="random", init_seed=3,
                             device="cpu")
    for (_, u), (_, v) in zip(a, flat(det.variables)[0]):
        np.testing.assert_array_equal(np.asarray(u), np.asarray(v))
    kernel = ["kernel" in jax.tree_util.keystr(p) for p, _ in a].index(True)
    other = flat(init_detector_variables(4))[0]
    assert not np.array_equal(np.asarray(a[kernel][1]), np.asarray(other[kernel][1]))


def test_rgb_to_i420_host_is_the_transport_conversion():
    frame = np.random.default_rng(5).integers(0, 256, (48, 64, 3), dtype=np.uint8)
    got = rgb_to_i420_host(frame)
    np.testing.assert_array_equal(got, rgb_to_i420(frame))
    np.testing.assert_array_equal(got, jax_i420(frame))


@pytest.mark.parametrize("sub", ["ops", "models", "gallery", "pipeline", "parallel"])
def test_packages_export_what_the_jax_packages_export(sub):
    import importlib

    jmod = importlib.import_module(f"facerecognitionpipeline_tpu.{sub}")
    tmod = importlib.import_module(f"facerecognitionpipeline_tpu_torch.{sub}")
    names = [n for n in vars(jmod) if not n.startswith("_") and not isinstance(
        getattr(jmod, n), type(jmod))]
    assert names
    for n in names:
        assert getattr(tmod, n) is not None, n


def test_top_level_lazy_names():
    for name in ("FaceEmbedder", "FaceProcessor", "GalleryManager", "StudentRecord"):
        assert getattr(tpkg, name).__name__ == getattr(jpkg, name).__name__
    with pytest.raises(AttributeError):
        tpkg.NoSuchName  # noqa: B018
    import facerecognitionpipeline_tpu_torch.evalharness as ev

    assert [n for n, v in vars(ev).items()
            if not n.startswith("_") and not isinstance(v, type(ev))] == []
