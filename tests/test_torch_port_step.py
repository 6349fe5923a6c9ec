"""The port's fused serving step against the JAX engine, on the CPU.

Both engines get the same detector weights (pretrained/mtcnn_dr.npz), the
same ir_micro embedder weights (the JAX random init, carried over with
models/convert.py), the same bf16 gallery and the same frames (tiles of
the port's smoke fixture). The JAX side runs its Pallas kernels in
interpret mode (crop_impl='pallas' with bf16, align_impl='pallas'); the
port's wrappers take their kernels' plain versions on CPU tensors. The JAX
step is compiled with XLA's excess precision off, so that its bf16 rounds
where its code says (with it on, XLA:CPU keeps fused intermediates in f32,
which moves its own landmarks by up to ~1 px against its op-by-op run).

The detections are compared first (face_valid equal, boxes and landmarks
within 1 px). A sub-pixel landmark difference shifts the aligned crop, so
align -> gate -> embed -> match is then held to the JAX step on the JAX
step's OWN detections: quality_ok equal on valid slots, aligned crops within
+-1 on >= 99% of pixels (the round and clip after alignment), embeddings
cosine >= 0.99, and top-1 match_idx equal where the top-1/top-2 margin
exceeds 5e-3.
"""

import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerecognitionpipeline_tpu.models.detector import MTCNNDetector as JaxDetector
from facerecognitionpipeline_tpu.pipeline.embedder import FaceEmbedder as JaxEmbedder
from facerecognitionpipeline_tpu.pipeline.engine import RecognitionEngine as JaxEngine
from facerecognitionpipeline_tpu_torch.gallery.search import DeviceGallery, cosine_topk
from facerecognitionpipeline_tpu_torch.models.detector import MTCNNDetector
from facerecognitionpipeline_tpu_torch.parallel.mesh import make_mesh
from facerecognitionpipeline_tpu_torch.pipeline.embedder import FaceEmbedder
from facerecognitionpipeline_tpu_torch.pipeline.engine import RecognitionEngine
from facerecognitionpipeline_tpu_torch.serve.batcher import DeviceBatcher

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, "pretrained", "mtcnn_dr.npz")
FIXTURE = os.path.join(
    REPO, "facerecognitionpipeline_tpu_torch", "testdata", "smoke_scenes.npz"
)
DET = dict(det_size=(160, 160), max_faces=4, min_face_size=40)


@pytest.fixture(scope="module")
def frames():
    with np.load(FIXTURE) as d:
        return np.ascontiguousarray(d["tiles"][:3])


@pytest.fixture(scope="module")
def pair():
    """(jax_engine_parts, port_detector, port_embedder) on the same weights."""
    jdet = JaxDetector(
        **DET, dtype=jnp.bfloat16, weights_path=WEIGHTS, crop_impl="pallas"
    )
    jemb = JaxEmbedder("ir_micro", dtype=jnp.bfloat16, random_ok=True)
    tdet = MTCNNDetector(
        **DET, dtype=torch.bfloat16, weights_path=WEIGHTS, crop_impl="kernel",
        device="cpu",
    )
    vars_np = {"params": _to_numpy(jemb.variables["params"])}
    temb = FaceEmbedder(
        "ir_micro", dtype=torch.bfloat16, variables=vars_np, device="cpu"
    )
    return jdet, jemb, tdet, temb


@pytest.fixture(scope="module")
def gallery():
    rng = np.random.default_rng(7)
    t = rng.normal(size=(40, 512)).astype(np.float32)
    t /= np.linalg.norm(t, axis=1, keepdims=True)
    return t


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def _templates(t, kind="bf16"):
    """(JAX templates [128,512], valid) and (port templates, valid) of one
    gallery: the same bf16 rows, or with kind='int8' each package's own
    quantised (codes, scales) pair of the float32 rows."""
    dg = DeviceGallery(device="cpu")
    dg.rebuild([str(i) for i in range(len(t))], t)
    tt, tv, _ = dg.device_snapshot()
    assert tt.dtype == torch.float32
    jv = jnp.asarray(tv.numpy())
    if kind == "int8":
        from facerecognitionpipeline_tpu.ops.pallas_gallery import quantize_templates as jq
        from facerecognitionpipeline_tpu_torch.ops.gallery_kernel import quantize_templates

        return (jq(jnp.asarray(tt.numpy())), jv), (quantize_templates(tt), tv)
    tt = tt.to(torch.bfloat16)
    jt = jnp.asarray(tt.float().numpy()).astype(jnp.bfloat16)
    return (jt, jv), (tt, tv)


def _jax_step(eng, frames, templates, valid, k, rotation=0):
    """The JAX engine's step, compiled without excess precision."""
    args = (
        eng.detector.variables, eng.embedder.variables, templates, valid,
        jnp.asarray(frames),
    )
    rot = jnp.asarray(rotation, jnp.int32)
    compiled = (
        jax.jit(eng._step_impl, static_argnames=("gallery_k",))
        .lower(*args, gallery_k=k, rotation=rot)
        .compile(compiler_options={"xla_allow_excess_precision": False})
    )
    return compiled(*args, rotation=rot)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)


def _assert_step_parity(teng, frames, a, b, tt, tv, top_k, rotation=0):
    """a: the JAX step's outputs; b: the port's step on the same frames."""
    a, b = _np(a), _np(b)
    assert set(a) == set(b)
    assert set(a["quality_metrics"]) == set(b["quality_metrics"])
    # detection
    np.testing.assert_array_equal(b["face_valid"], a["face_valid"])
    valid = a["face_valid"]
    assert valid.any(), "fixture frames must hold detections"
    np.testing.assert_allclose(b["bboxes"][valid], a["bboxes"][valid], atol=1.0)
    np.testing.assert_allclose(b["landmarks"][valid], a["landmarks"][valid], atol=1.0)
    # align -> gate -> embed -> match on the JAX step's own detections
    det = {
        "bboxes": a["bboxes"], "scores": a["det_scores"],
        "landmarks": a["landmarks"], "valid": a["face_valid"],
    }
    with torch.inference_mode():
        st = teng._embed(
            teng._shards[0], torch.from_numpy(np.asarray(frames, np.float32)),
            {k: torch.from_numpy(np.array(v)) for k, v in det.items()}, rotation,
        )
        r = _np(teng._finish(st, *teng._match(st["q"], tt, tv, top_k), top_k))
    np.testing.assert_array_equal(r["quality_ok"][valid], a["quality_ok"][valid])
    np.testing.assert_array_equal(r["embedded"], a["embedded"])
    diff = np.abs(r["aligned"].astype(np.int16) - a["aligned"].astype(np.int16))
    assert (diff[valid] <= 1).mean() >= 0.99
    emb = r["embedded"]
    ea, eb = a["embeddings"][emb], r["embeddings"][emb]
    cos = (ea * eb).sum(-1) / (
        np.linalg.norm(ea, axis=-1) * np.linalg.norm(eb, axis=-1) + 1e-12
    )
    assert cos.min() >= 0.99, cos
    sa = a["match_scores"][emb]
    clear = (sa[:, 0] - sa[:, 1]) > 5e-3
    assert clear.any()
    np.testing.assert_array_equal(
        r["match_idx"][emb][clear, 0], a["match_idx"][emb][clear, 0]
    )
    assert a["match_scores"].shape[-1] == r["match_scores"].shape[-1] == top_k


def test_step_matches_jax(pair, frames, gallery):
    jdet, jemb, tdet, temb = pair
    (jt, jv), (tt, tv) = _templates(gallery)
    jeng = JaxEngine(jdet, jemb, top_k=3, align_impl="pallas")
    teng = RecognitionEngine(tdet, temb, top_k=3)
    a = _jax_step(jeng, frames, jt, jv, 3)
    b = teng.process_frames(frames, tt, tv)
    _assert_step_parity(teng, frames, a, b, tt, tv, 3)


@pytest.mark.parametrize("rotation", [0, 1])
def test_step_embed_budget_matches_jax(pair, frames, gallery, rotation):
    jdet, jemb, tdet, temb = pair
    (jt, jv), (tt, tv) = _templates(gallery)
    jeng = JaxEngine(jdet, jemb, top_k=2, align_impl="pallas", embed_budget=1)
    teng = RecognitionEngine(tdet, temb, top_k=2, embed_budget=1)
    a = _jax_step(jeng, frames, jt, jv, 2, rotation=rotation)
    b = teng.process_frames(frames, tt, tv, rotation=rotation)
    _assert_step_parity(teng, frames, a, b, tt, tv, 2, rotation)
    assert b["embedded"].sum(dim=1).le(1).all()


def test_i420_step_matches_rgb_of_same_frame(pair, frames, gallery):
    """I420 input: the port converts on the device exactly as the JAX
    package does, so the step on I420 equals the step on its RGB image."""
    from facerecognitionpipeline_tpu.serve.rawproto import rgb_to_i420
    from facerecognitionpipeline_tpu_torch.ops.image import i420_to_rgb

    _, _, tdet, temb = pair
    (_, _), (tt, tv) = _templates(gallery)
    yuv = np.stack([rgb_to_i420(f) for f in frames])
    rgb = i420_to_rgb(torch.from_numpy(yuv), 160, 160)
    e420 = RecognitionEngine(tdet, temb, top_k=2, input_format="i420")
    ergb = RecognitionEngine(tdet, temb, top_k=2)
    assert e420.host_frame_shape(160, 160) == (240, 160)
    a = e420.process_frames(yuv, tt, tv)
    b = ergb.step(tt, tv, rgb, gallery_k=2)
    for k in ("bboxes", "face_valid", "aligned", "embeddings", "match_idx"):
        np.testing.assert_array_equal(a[k].numpy(), b[k].numpy())


@pytest.mark.parametrize("kind", ["streaming", "int8"])
def test_step_with_a_streamed_gallery_matches_jax(pair, frames, gallery, kind):
    """The whole step with the gallery matched through the streaming arms:
    gallery_impl='streaming' on bf16 rows (K3), and an int8 (codes, scales)
    pair (K4), which streams whatever gallery_impl says."""
    jdet, jemb, tdet, temb = pair
    (jt, jv), (tt, tv) = _templates(gallery, "int8" if kind == "int8" else "bf16")
    impl = "streaming" if kind == "streaming" else "auto"
    jeng = JaxEngine(jdet, jemb, top_k=3, align_impl="pallas", gallery_impl=impl,
                     gallery_chunk=64)
    teng = RecognitionEngine(tdet, temb, top_k=3, gallery_impl=impl, gallery_chunk=64)
    a = _jax_step(jeng, frames, jt, jv, 3)
    b = teng.process_frames(frames, tt, tv)
    assert b["match_idx"].dtype == torch.int64 and b["match_scores"].dtype == torch.float32
    _assert_step_parity(teng, frames, a, b, tt, tv, 3)


def test_step_embed_budget_with_an_int8_pair(pair, frames, gallery):
    """Budget and pair together: unembedded slots report score -1 and index
    0 in one index type, embedded slots match like the full step."""
    _, _, tdet, temb = pair
    (_, _), (tt, tv) = _templates(gallery, "int8")
    full = RecognitionEngine(tdet, temb, top_k=2, gallery_chunk=64)
    budget = RecognitionEngine(tdet, temb, top_k=2, gallery_chunk=64, embed_budget=1)
    a = full.process_frames(frames, tt, tv)
    b = budget.process_frames(frames, tt, tv)
    emb = b["embedded"]
    assert emb.any() and emb.sum(dim=1).le(1).all()
    assert b["match_idx"].dtype == torch.int64
    assert torch.equal(b["match_idx"][emb], a["match_idx"][emb])
    np.testing.assert_allclose(
        b["match_scores"][emb].numpy(), a["match_scores"][emb].numpy(), atol=1e-6
    )
    assert (b["match_scores"][~emb] == -1.0).all() and (b["match_idx"][~emb] == 0).all()


def test_unported_options_raise(pair):
    """mesh= builds one shard per entry of the 'data' axis (the replicas on
    the weights' own device are the same objects); shard_gallery without a
    mesh, a batch that does not split over the mesh and the other bad
    options raise the JAX engine's ValueErrors."""
    _, _, tdet, temb = pair
    eng = RecognitionEngine(tdet, temb, mesh=make_mesh(data=2, devices=["cpu"] * 2))
    assert len(eng._shards) == 2 and eng._shards[1].detector is tdet
    with pytest.raises(ValueError, match="multiple"):
        eng.process_frames(np.zeros((3, 160, 160, 3), np.uint8), torch.zeros(128, 512),
                           torch.zeros(128, dtype=torch.bool))
    with pytest.raises(ValueError, match="shard_gallery"):
        RecognitionEngine(tdet, temb, shard_gallery=True)
    with pytest.raises(ValueError):
        RecognitionEngine(tdet, temb, embed_budget=5)
    with pytest.raises(ValueError, match="gallery_impl"):
        RecognitionEngine(tdet, temb, gallery_impl="sharded")


def test_streaming_and_pair_options_now_work(pair):
    """gallery_impl='streaming' and an int8 pair reach the streaming arms
    (their plain versions here) and agree with the dense match."""
    from facerecognitionpipeline_tpu_torch.ops.gallery_kernel import quantize_templates

    _, _, tdet, temb = pair
    rng = np.random.default_rng(5)
    t = rng.normal(size=(128, 512)).astype(np.float32)
    t /= np.linalg.norm(t, axis=1, keepdims=True)
    tt = torch.from_numpy(t)
    valid = torch.ones(128, dtype=torch.bool)
    feats = tt[[3, 77, 100, 9]].reshape(1, 4, 512)
    dense = RecognitionEngine(tdet, temb, gallery_impl="dense")
    stream = RecognitionEngine(tdet, temb, gallery_impl="streaming", gallery_chunk=64)
    assert (stream.gallery_chunk, stream.gallery_streaming_threshold) == (64, 32768)
    ds, di = dense._match(feats, tt.to(torch.bfloat16), valid, 2)
    ss, si = stream._match(feats, tt.to(torch.bfloat16), valid, 2)
    ps, pi = dense._match(feats, quantize_templates(tt), valid, 2)
    assert di[0, :, 0].tolist() == si[0, :, 0].tolist() == pi[0, :, 0].tolist() == [3, 77, 100, 9]
    assert si.dtype == pi.dtype == di.dtype == torch.int64
    np.testing.assert_allclose(ss.numpy(), ds.numpy(), atol=1e-5)
    np.testing.assert_allclose(ps.numpy(), ds.numpy(), atol=3e-3)


def test_gallery_search_matches_jax(gallery):
    from facerecognitionpipeline_tpu.gallery.search import cosine_topk as jax_topk

    rng = np.random.default_rng(3)
    q = rng.normal(size=(6, 512)).astype(np.float32)
    q[0] = gallery[5] * 3.0  # planted: exact top-1
    dg = DeviceGallery(device="cpu")
    dg.rebuild([f"s{i}" for i in range(len(gallery))], gallery)
    t, v, ids = dg.device_snapshot()
    assert t.shape == (128, 512)
    s, i = cosine_topk(torch.from_numpy(q), t, v, 4)
    js, ji = jax_topk(jnp.asarray(q), jnp.asarray(t.numpy()), jnp.asarray(v.numpy()), 4)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-5)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    assert i[0, 0] == 5 and s[0, 0] > 0.99
    scores, names = dg.search(q, top_k=3)
    assert names[0][0] == "s5" and scores.shape == (6, 3)


def test_topk_ties_break_to_lower_index():
    """Padded rows all score -1e9: top-k must list them lowest index first,
    as jax.lax.top_k does."""
    import jax

    from facerecognitionpipeline_tpu_torch.ops.nms import top_k

    x = np.array([[0.5, -1e9, 0.5, -1e9, 0.7, -1e9, -1e9, 0.5]], np.float32)
    tv, ti = top_k(torch.from_numpy(x), 8)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 8)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_batcher_matches_direct_step(pair, frames, gallery):
    """Frames from two client threads through DeviceBatcher give the same
    results as the direct step on each frame."""
    _, _, tdet, temb = pair
    dg = DeviceGallery(device="cpu")
    dg.rebuild([str(i) for i in range(len(gallery))], gallery)
    eng = RecognitionEngine(tdet, temb, top_k=3)
    batcher = DeviceBatcher(eng, dg.device_snapshot, max_batch=4, max_wait_ms=20)
    batcher.warmup((160, 160))
    batcher.start()
    inputs = [frames[i % len(frames)] for i in range(6)]
    futs = [None] * len(inputs)
    try:
        def client(offset):
            for i in range(offset, len(inputs), 2):
                futs[i] = batcher.submit(inputs[i])

        threads = [threading.Thread(target=client, args=(o,)) for o in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        results = [f.result(timeout=120) for f in futs]
    finally:
        batcher.stop()
    t, v, ids = dg.device_snapshot()
    direct = eng.process_frames(np.stack(frames), t, v)
    for i, r in enumerate(results):
        j = i % len(frames)
        assert r["gallery_ids"] == ids
        np.testing.assert_array_equal(r["face_valid"], direct["face_valid"][j].numpy())
        np.testing.assert_array_equal(r["match_idx"], direct["match_idx"][j].numpy())
        np.testing.assert_allclose(
            r["bboxes"], direct["bboxes"][j].numpy(), atol=1e-4
        )
        np.testing.assert_allclose(
            np.asarray(r["embeddings"]), direct["embeddings"][j].numpy(), atol=1e-3
        )
        assert r["aligned"].shape == (4, 112, 112, 3)
    late = batcher.submit(frames[0])
    with pytest.raises(RuntimeError, match="stopped"):
        late.result(timeout=5)


def test_batcher_carries_an_int8_pair_to_the_step(pair, frames, gallery):
    """A provider that serves (codes, scales) templates: the batcher hands
    the pair to the step untouched, in warmup and in dispatch."""
    _, _, tdet, temb = pair
    dg = DeviceGallery(device="cpu", streaming_threshold=32, quantize="int8")
    dg.STREAM_CHUNK = 64
    dg.rebuild([str(i) for i in range(len(gallery))], gallery)
    t, v, ids = dg.device_snapshot()
    assert isinstance(t, tuple) and t[0].dtype == torch.int8 and t[0].shape == (64, 512)
    eng = RecognitionEngine(tdet, temb, top_k=3, gallery_chunk=64)
    batcher = DeviceBatcher(eng, dg.device_snapshot, max_batch=2, max_wait_ms=20)
    batcher.warmup((160, 160))
    batcher.start()
    try:
        results = [batcher.submit(f).result(timeout=120) for f in frames[:2]]
    finally:
        batcher.stop()
    direct = eng.process_frames(np.stack(frames[:2]), t, v)
    for j, r in enumerate(results):
        assert r["gallery_ids"] == ids
        np.testing.assert_array_equal(r["face_valid"], direct["face_valid"][j].numpy())
        np.testing.assert_array_equal(r["match_idx"], direct["match_idx"][j].numpy())
        np.testing.assert_allclose(
            r["match_scores"], direct["match_scores"][j].numpy(), atol=1e-6
        )
