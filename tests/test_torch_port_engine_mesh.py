"""The port's fused step under a mesh against the JAX engine's, on the CPU.

The six serving combinations of `__graft_entry__.py::_serving_combos`
(dense data parallel, the row-sharded gallery in float32 and int8, the
streaming gallery data parallel and row-sharded, the embed budget data
parallel, and budget x sharded x int8), each on a 'data' mesh of 4: the
JAX engine on `jax.devices()[:4]`, the port on four CPU entries. Both
packages get the same detector weights (pretrained/mtcnn_dr.npz, float32,
dense crops), the same ir_micro embedder weights (the JAX random init), the
same gallery rows and the same frames (tiles of the port's smoke fixture),
and align with the gather route (exact bilinear, `align_impl='gather'`),
so the comparison holds the mesh plumbing to the reference without the
interpreted Pallas kernels.

Tolerances (the largest difference measured over the seven runs in
brackets): face_valid and embedded equal; boxes and landmarks within 1e-2
px [2.0e-4, 1.7e-4]; det scores within 1e-4 [0]; match scores within 1e-3
[6.6e-5; an aligned crop may round one grey level apart, 1 measured];
top-1 indices equal where the JAX top-1/top-2 margin exceeds 5e-3 (the
band of tests/test_engine_dp.py) [every index equal], and an int8 pair's
top-1 the float32 run's outside that band.

Each combination also runs the port's production route (bf16 cascade, K1
and K2 through their plain versions, `align_impl='kernel'`) under the mesh
against the same engine on one device: every field equal but the match
scores, which are within 1e-5 (the matmul of one shard's queries against
the gallery may sum in another order than the whole batch's).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerecognitionpipeline_tpu.gallery.search import DeviceGallery as JaxGallery
from facerecognitionpipeline_tpu.models.detector import MTCNNDetector as JaxDetector
from facerecognitionpipeline_tpu.ops.pallas_gallery import quantize_templates as jquantize
from facerecognitionpipeline_tpu.parallel.mesh import make_mesh as jax_make_mesh
from facerecognitionpipeline_tpu.pipeline.embedder import FaceEmbedder as JaxEmbedder
from facerecognitionpipeline_tpu.pipeline.engine import RecognitionEngine as JaxEngine
from facerecognitionpipeline_tpu_torch.gallery.search import DeviceGallery
from facerecognitionpipeline_tpu_torch.models.detector import MTCNNDetector
from facerecognitionpipeline_tpu_torch.ops.gallery_kernel import quantize_templates
from facerecognitionpipeline_tpu_torch.parallel.mesh import Mesh, Sharded, make_mesh
from facerecognitionpipeline_tpu_torch.pipeline.embedder import FaceEmbedder
from facerecognitionpipeline_tpu_torch.pipeline.engine import RecognitionEngine

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, "pretrained", "mtcnn_dr.npz")
FIXTURE = os.path.join(REPO, "facerecognitionpipeline_tpu_torch", "testdata",
                       "smoke_scenes.npz")
DET = dict(det_size=(160, 160), max_faces=4, min_face_size=40, weights_path=WEIGHTS)
N = 4

# name -> (engine options, gallery: 'plain' | 'sharded', templates: 'f32' | 'int8')
COMBOS = {
    "dense-dp": (dict(), "plain", "f32"),
    "shard-gallery-f32": (dict(shard_gallery=True), "sharded", "f32"),
    "shard-gallery-int8": (dict(shard_gallery=True), "sharded", "int8"),
    "streaming-dp": (dict(gallery_impl="streaming", gallery_chunk=64), "plain", "f32"),
    "streaming-shard-gallery": (
        dict(shard_gallery=True, gallery_impl="streaming", gallery_chunk=128), "sharded",
        "f32"),
    "budget-dp": (dict(embed_budget=2), "plain", "f32"),
    "budget-shard-gallery-int8": (dict(shard_gallery=True, embed_budget=2), "sharded",
                                  "int8"),
}


@pytest.fixture(scope="module")
def setup():
    with np.load(FIXTURE) as d:
        frames = np.ascontiguousarray(d["tiles"][:N])
    rng = np.random.default_rng(0)
    t = rng.normal(size=(96, 512)).astype(np.float32)
    t /= np.linalg.norm(t, axis=1, keepdims=True)
    ids = [f"id{i}" for i in range(96)]
    jmesh = jax_make_mesh(data=N, devices=jax.devices()[:N])
    tmesh = make_mesh(data=N, devices=["cpu"] * N)
    jemb = JaxEmbedder("ir_micro", random_ok=True)
    params = jax.tree_util.tree_map(np.asarray, jemb.variables["params"])
    galleries = {}
    for name, mesh in (("plain", None), ("sharded", "mesh")):
        jg = JaxGallery(mesh=jmesh if mesh else None)
        tg = DeviceGallery(mesh=tmesh) if mesh else DeviceGallery(device="cpu")
        jg.rebuild(ids, t)
        tg.rebuild(ids, t)
        galleries[name] = (jg, tg)
    return {
        "frames": frames,
        "jmesh": jmesh,
        "tmesh": tmesh,
        "jax": (JaxDetector(**DET), jemb),
        "port": (MTCNNDetector(**DET, crop_impl="matmul", device="cpu"),
                 FaceEmbedder("ir_micro", variables={"params": params}, device="cpu")),
        "port_bf16": (
            MTCNNDetector(**DET, dtype=torch.bfloat16, crop_impl="kernel", device="cpu"),
            FaceEmbedder("ir_micro", variables={"params": params}, dtype=torch.bfloat16,
                         device="cpu")),
        "galleries": galleries,
    }


def _jax_templates(jg, kind, jmesh):
    if kind == "f32":
        return jg._templates, jg._valid
    from jax.sharding import NamedSharding, PartitionSpec as P

    tq, sc = jquantize(np.asarray(jg._templates))
    if jg.mesh is not None:
        tq = jax.device_put(tq, NamedSharding(jmesh, P("data", None)))
        sc = jax.device_put(sc, NamedSharding(jmesh, P("data")))
    return (tq, sc), jg._valid


def _port_templates(tg, kind):
    _, t, v, _ = tg.snapshot()
    if kind == "f32":
        return t, v
    if isinstance(t, Sharded):
        pairs = [quantize_templates(b) for b in t.blocks]
        return (Sharded([c for c, _ in pairs]), Sharded([s for _, s in pairs])), v
    return quantize_templates(t), v


def _host(out):
    return {k: (_host(v) if isinstance(v, dict) else v.numpy()) for k, v in out.items()}


@pytest.mark.parametrize("combo", list(COMBOS))
def test_serving_combo_matches_jax_on_the_same_mesh(setup, combo):
    opts, gname, kind = COMBOS[combo]
    jg, tg = setup["galleries"][gname]
    frames = setup["frames"]
    jt, jv = _jax_templates(jg, kind, setup["jmesh"])
    tt, tv = _port_templates(tg, kind)

    jeng = JaxEngine(*setup["jax"], top_k=2, mesh=setup["jmesh"], align_impl="gather", **opts)
    a = jax.device_get(jeng.process_frames(frames, jt, jv, 2, rotation=1))
    teng = RecognitionEngine(*setup["port"], top_k=2, mesh=setup["tmesh"],
                             align_impl="gather", **opts)
    b = _host(teng.process_frames(frames, tt, tv, 2, rotation=1))

    assert b["match_scores"].shape == (N, 4, 2)
    valid = a["face_valid"]
    assert valid.any(), "fixture frames must hold detections"
    np.testing.assert_array_equal(b["face_valid"], valid)
    np.testing.assert_array_equal(b["embedded"], a["embedded"])
    np.testing.assert_allclose(b["bboxes"][valid], a["bboxes"][valid], atol=1e-2)
    np.testing.assert_allclose(b["landmarks"][valid], a["landmarks"][valid], atol=1e-2)
    np.testing.assert_allclose(b["det_scores"], a["det_scores"], atol=1e-4)
    np.testing.assert_allclose(b["match_scores"], a["match_scores"], atol=1e-3)
    margin = a["match_scores"][..., 0] - a["match_scores"][..., 1]
    clear = margin > 5e-3
    np.testing.assert_array_equal(b["match_idx"][..., 0][clear], a["match_idx"][..., 0][clear])

    if kind == "int8":
        # int8 top-1 equals the float32 run's outside the quantization band
        f32 = _host(teng.process_frames(frames, *_port_templates(tg, "f32"), 2, rotation=1))
        clear = (f32["match_scores"][..., 0] - f32["match_scores"][..., 1]) > 5e-3
        np.testing.assert_array_equal(b["match_idx"][..., 0][clear],
                                      f32["match_idx"][..., 0][clear])

    # the production route under the mesh = the same engine on one device
    single = RecognitionEngine(*setup["port_bf16"], top_k=2, **{
        k: v for k, v in opts.items() if k != "shard_gallery"})
    sharded = RecognitionEngine(*setup["port_bf16"], top_k=2, mesh=setup["tmesh"], **opts)
    st, sv = tt, tv
    if isinstance(tv, Sharded):  # one device holds the gathered rows
        st = tuple(x.gather("cpu") for x in tt) if isinstance(tt, tuple) else tt.gather("cpu")
        sv = tv.gather("cpu")
    c = _host(single.process_frames(frames, st, sv, 2, rotation=1))
    d = _host(sharded.process_frames(frames, tt, tv, 2, rotation=1))
    for key in c:
        if key == "match_scores":
            np.testing.assert_allclose(d[key], c[key], atol=1e-5)
        elif key == "quality_metrics":
            for m in c[key]:
                np.testing.assert_array_equal(d[key][m], c[key][m])
        else:
            np.testing.assert_array_equal(d[key], c[key], err_msg=key)


def test_engine_mesh_options_raise_as_jax(setup):
    det, emb = setup["port"]
    with pytest.raises(ValueError, match="shard_gallery"):
        RecognitionEngine(det, emb, shard_gallery=True)
    with pytest.raises(ValueError, match="'data' axis"):
        RecognitionEngine(det, emb, shard_gallery=True, mesh=Mesh(["cpu"] * 2, ("model",)))
    eng = RecognitionEngine(det, emb, mesh=setup["tmesh"])
    _, tg = setup["galleries"]["plain"]
    with pytest.raises(ValueError, match="multiple"):
        eng.process_frames(setup["frames"][:3], *tg.device_snapshot()[:2])
