"""The port's mesh layer against the JAX package's, on the CPU.

The JAX side runs on `jax.devices()[:n]` (conftest gives 8 virtual CPU
devices); the port on meshes of n CPU entries (`make_mesh(devices=[cpu] *
n)`). Covered: `make_mesh` (shapes and its error text), `data_parallel_embed`,
`sharded_cosine_topk` and `dp_sharded_cosine_topk` over float32 rows, bf16
rows through the streaming arm (kernel K3's plain version here, the JAX
Pallas kernel in interpret mode) and int8 (codes, scales) pairs, every
ValueError with the JAX message, `DeviceGallery` and `GalleryManager` under
a mesh, and the batcher's bucket filter.

Tolerances: float32 scores within 1e-5 of the JAX package's and indices
equal (the same rows, each shard's top-k then one merge); bf16 and int8
scores within 1e-5 of the JAX package's on the same bf16 rows or codes
(both sum exact products in float32), and against the float32 dense search
within 5e-3 (bf16 rows) / 3e-3 (int8), with top-1 equal only where the
float32 top-1/top-2 margin is above 5e-3, the quantization band of
tests/test_engine_dp.py. The data-parallel embed within 1e-4 of the JAX
one (as tests/test_parallel.py holds it to the single device).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from facerecognitionpipeline_tpu.gallery import search as jsearch
from facerecognitionpipeline_tpu.gallery.manager import GalleryManager as JaxManager
from facerecognitionpipeline_tpu.ops.pallas_gallery import quantize_templates as jquantize
from facerecognitionpipeline_tpu.parallel import mesh as jmesh
from facerecognitionpipeline_tpu.pipeline.embedder import FaceEmbedder as JaxEmbedder
from facerecognitionpipeline_tpu.serve.batcher import DeviceBatcher as JaxBatcher
from facerecognitionpipeline_tpu_torch.gallery import search as tsearch
from facerecognitionpipeline_tpu_torch.gallery.manager import GalleryManager
from facerecognitionpipeline_tpu_torch.ops.gallery_kernel import quantize_templates
from facerecognitionpipeline_tpu_torch.parallel import mesh as tmesh
from facerecognitionpipeline_tpu_torch.pipeline.embedder import FaceEmbedder
from facerecognitionpipeline_tpu_torch.serve.batcher import DeviceBatcher

torch.set_num_threads(2)
CPU = torch.device("cpu")


def _jmesh(n, axis="data"):
    return JaxMesh(np.array(jax.devices()[:n]), axis_names=(axis,))


def _tmesh(n, axis="data"):
    return tmesh.Mesh([CPU] * n, (axis,))


def _unit_rows(rng, g, d=512):
    t = rng.normal(size=(g, d)).astype(np.float32)
    return t / np.linalg.norm(t, axis=1, keepdims=True)


# ------------------------------------------------------------------- mesh


def test_make_mesh_shapes_match_jax():
    cpu8 = [CPU] * 8
    for kw in (dict(model=2), dict(data=4, model=1), dict(data=2, model=4), dict()):
        got = tmesh.make_mesh(devices=cpu8, **kw)
        want = jmesh.make_mesh(**kw)
        assert got.shape == dict(want.shape)
        assert got.axis_names == want.axis_names
        assert got.devices.shape == want.devices.shape
    m = tmesh.make_mesh(data=2, model=2, devices=[CPU] * 4)
    assert m.axis_devices("data") == [CPU] * 2 and m.first == CPU
    assert m.distinct_devices() == [CPU]


def test_make_mesh_rejects_oversized_axes_with_the_jax_text():
    with pytest.raises(ValueError) as want:
        jmesh.make_mesh(model=64)  # 8-device test env
    with pytest.raises(ValueError, match="devices") as got:
        tmesh.make_mesh(model=64, devices=[CPU] * 8)
    assert str(got.value) == str(want.value)


def test_make_mesh_takes_distinct_cuda_devices(monkeypatch):
    """devices=None takes every CUDA device once: one card makes no mesh of
    two (as one TPU chip makes none in JAX); no card raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="devices="):
        tmesh.make_mesh(data=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        tmesh.make_mesh(data=2)
    assert tmesh.make_mesh(data=1).devices[0, 0] == torch.device("cuda", 0)


def test_data_parallel_embed_matches_jax():
    jemb = JaxEmbedder(architecture="ir_micro", random_ok=True)
    params = jax.tree_util.tree_map(np.asarray, jemb.variables["params"])
    temb = FaceEmbedder("ir_micro", variables={"params": params}, device="cpu")
    faces = np.random.default_rng(0).integers(0, 256, size=(8, 112, 112, 3), dtype=np.uint8)
    jf, _ = jmesh.data_parallel_embed(jemb, jmesh.make_mesh(data=4, model=1))(faces)
    embed = tmesh.data_parallel_embed(temb, tmesh.make_mesh(data=4, devices=[CPU] * 4))
    tf, tn = embed(faces)
    assert tf.shape == (8, 512) and tn.shape == (8, 1)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=1e-4)
    np.testing.assert_allclose(tf.numpy(), temb.extract_embeddings_batch(faces), atol=1e-4)
    with pytest.raises(ValueError, match="multiple"):
        embed(faces[:6])
    # replicas on the weights' own device are the embedder itself
    assert tmesh.replicate(temb, CPU) is temb


# ------------------------------------------------------- sharded searches


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_sharded_cosine_topk_matches_jax(kind):
    rng = np.random.default_rng(0)
    g, q, k = 1024, 16, 5
    t = _unit_rows(rng, g)
    valid = np.ones(g, bool)
    valid[-37:] = False
    t[-37:] = 0
    queries = t[rng.integers(0, g - 37, size=q)] + rng.normal(0, 0.05, (q, 512)).astype(
        np.float32)
    if kind == "int8":
        jt, tt = jquantize(t), quantize_templates(torch.from_numpy(t))
        np.testing.assert_array_equal(np.asarray(jt[0]), tt[0].numpy())
    else:
        jt, tt = t, torch.from_numpy(t)
    js, ji = jsearch.sharded_cosine_topk(_jmesh(8, "gallery"), queries, jt, valid, k)
    ts, ti = tsearch.sharded_cosine_topk(_tmesh(8, "gallery"), queries, tt,
                                         torch.from_numpy(valid), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)
    ds, di = tsearch.cosine_topk(torch.from_numpy(queries), torch.from_numpy(t),
                                 torch.from_numpy(valid), k)
    if kind == "f32":
        np.testing.assert_array_equal(ti.numpy(), di.numpy())
        np.testing.assert_allclose(ts.numpy(), ds.numpy(), atol=1e-5)
    else:
        clear = (ds[:, 0] - ds[:, 1]).numpy() > 5e-3
        np.testing.assert_array_equal(ti[clear, 0].numpy(), di[clear, 0].numpy())
        np.testing.assert_allclose(ts.numpy(), ds.numpy(), atol=3e-3)


def test_sharded_streaming_bf16_and_padded_slots_match_jax():
    """bf16 rows through the streaming arm per shard (chunk 64), with only 2
    valid rows and top_k 4: the surplus slots carry -1e9 and each shard's
    base row as their index, as in the JAX package."""
    rng = np.random.default_rng(1)
    g, k = 256, 4
    t = _unit_rows(rng, g)
    valid = np.zeros(g, bool)
    valid[:2] = True
    t[2:] = 0
    queries = rng.normal(size=(6, 512)).astype(np.float32)
    jt = jnp.asarray(t).astype(jnp.bfloat16)
    tt = torch.from_numpy(t).to(torch.bfloat16)
    js, ji = jsearch.sharded_cosine_topk(_jmesh(4, "gallery"), queries, jt, valid, k,
                                         streaming=True, chunk=64)
    ts, ti = tsearch.sharded_cosine_topk(_tmesh(4, "gallery"), queries, tt,
                                         torch.from_numpy(valid), k, streaming=True, chunk=64)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)
    assert (ts[:, 2:] == -1e9).all()


@pytest.mark.parametrize("kind", ["f32", "bf16_streaming", "int8"])
def test_dp_sharded_cosine_topk_matches_jax(kind):
    rng = np.random.default_rng(2)
    b, f, d, g, k = 8, 3, 64, 256, 4
    q = rng.normal(size=(b, f, d)).astype(np.float32)
    t = _unit_rows(rng, g, d)
    valid = np.ones(g, bool)
    valid[g - 7:] = False
    t[g - 7:] = 0
    kw = {}
    if kind == "int8":
        jt, tt = jquantize(t), quantize_templates(torch.from_numpy(t))
    elif kind == "bf16_streaming":
        jt = jnp.asarray(t).astype(jnp.bfloat16)
        tt = torch.from_numpy(t).to(torch.bfloat16)
        kw = dict(streaming=True, chunk=32)
    else:
        jt, tt = t, torch.from_numpy(t)
    js, ji = jsearch.dp_sharded_cosine_topk(_jmesh(4), q, jt, valid, k, **kw)
    ts, ti = tsearch.dp_sharded_cosine_topk(_tmesh(4), torch.from_numpy(q), tt,
                                            torch.from_numpy(valid), k, **kw)
    assert ts.shape == (b, f, k) and ti.dtype == torch.int64
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)
    ds, di = tsearch.cosine_topk(torch.from_numpy(q.reshape(-1, d)), torch.from_numpy(t),
                                 torch.from_numpy(valid), k)
    if kind == "f32":
        np.testing.assert_array_equal(ti.reshape(-1, k).numpy(), di.numpy())
    else:
        clear = (ds[:, 0] - ds[:, 1]).numpy() > 5e-3
        np.testing.assert_array_equal(ti.reshape(-1, k)[clear, 0].numpy(),
                                      di[clear, 0].numpy())
        np.testing.assert_allclose(ts.reshape(-1, k).numpy(), ds.numpy(), atol=5e-3)


def _raised(fn, *args, **kw):
    with pytest.raises(ValueError) as e:
        fn(*args, **kw)
    return str(e.value)


@pytest.mark.parametrize("case", ["rows", "batch", "top_k", "chunk"])
def test_dp_sharded_errors_are_the_jax_errors(case):
    rng = np.random.default_rng(3)
    q = rng.normal(size=(4, 2, 32)).astype(np.float32)
    g = 130 if case == "rows" else 128
    t = rng.normal(size=(g, 32)).astype(np.float32)
    args = {"rows": (q, 2), "batch": (q[:3], 2), "top_k": (q, 33), "chunk": (q, 2)}[case]
    kw = dict(streaming=True, chunk=24) if case == "chunk" else {}
    want = _raised(jsearch.dp_sharded_cosine_topk, _jmesh(4), args[0], t, np.ones(g, bool),
                   args[1], **kw)
    got = _raised(tsearch.dp_sharded_cosine_topk, _tmesh(4), torch.from_numpy(args[0]),
                  torch.from_numpy(t), torch.ones(g, dtype=torch.bool), args[1], **kw)
    assert got == want


def test_sharded_cosine_topk_errors():
    t = torch.zeros(128, 32)
    v = torch.ones(128, dtype=torch.bool)
    q = torch.zeros(2, 32)
    want = _raised(jsearch.sharded_cosine_topk, _jmesh(4, "gallery"), np.zeros((2, 32)),
                   np.zeros((128, 32), np.float32), np.ones(128, bool), 33)
    assert _raised(tsearch.sharded_cosine_topk, _tmesh(4, "gallery"), q, t, v, 33) == want
    assert "chunk" in _raised(tsearch.sharded_cosine_topk, _tmesh(4, "gallery"), q, t, v, 2,
                              streaming=True, chunk=24)
    assert "divide" in _raised(tsearch.sharded_cosine_topk, _tmesh(3, "gallery"), q, t, v, 2)


# --------------------------------------------------- gallery under a mesh


def test_device_gallery_sharded_placement_and_search_match_jax():
    rng = np.random.default_rng(4)
    g = 300
    t = _unit_rows(rng, g)
    ids = [f"id{i}" for i in range(g)]
    jg = jsearch.DeviceGallery(mesh=_jmesh(4))
    jg.rebuild(ids, t)
    tg = tsearch.DeviceGallery(mesh=_tmesh(4))
    tg.rebuild(ids, t)
    templates = tg.snapshot()[1]
    assert isinstance(templates, tmesh.Sharded)
    assert templates.shape == tuple(jg._templates.shape) == (512, 512)
    assert len(templates.blocks) == 4 and len({b.data_ptr() for b in templates.blocks}) == 4
    q = rng.normal(size=(5, 512)).astype(np.float32)
    js, jn = jg.search(q, top_k=4)
    ts, tn = tg.search(q, top_k=4)
    np.testing.assert_allclose(ts, js, atol=1e-5)
    assert tn == jn
    plain = tsearch.DeviceGallery(device="cpu")
    plain.rebuild(ids, t)
    assert plain.search(q, top_k=4)[1] == tn


def test_device_gallery_sharded_streaming_search_matches_jax():
    rng = np.random.default_rng(5)
    g = 100
    t = _unit_rows(rng, g)
    ids = [f"id{i}" for i in range(g)]
    q = rng.normal(size=(5, 512)).astype(np.float32)
    out = []
    for pkg, mesh in ((jsearch, _jmesh(4)), (tsearch, _tmesh(4))):
        dg = pkg.DeviceGallery(mesh=mesh, streaming_threshold=8)
        dg.STREAM_CHUNK = 32
        dg.rebuild(ids, t)
        assert dg.snapshot()[3] is not None
        out.append(dg.search(q, top_k=4))
    (js, jn), (ts, tn) = out
    np.testing.assert_allclose(ts, js, atol=1e-5)
    assert tn == jn


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_device_gallery_top_k_above_a_shard_takes_the_single_device_arms(quantize):
    """k larger than one shard's rows (toy sizes): the whole gallery is
    searched on the first device, as the JAX gallery falls through to its
    unsharded arms."""
    rng = np.random.default_rng(6)
    t = _unit_rows(rng, 6)
    ids = [str(i) for i in range(6)]
    kw = dict(pad_multiple=2, streaming_threshold=4 if quantize else 32768, quantize=quantize)
    tg = tsearch.DeviceGallery(mesh=_tmesh(4), **kw)
    tg.STREAM_CHUNK = 2
    tg.rebuild(ids, t)
    assert tg.snapshot()[1].shape == (8, 512)  # 2 rows per shard
    jg = jsearch.DeviceGallery(mesh=_jmesh(4), **kw)
    jg.STREAM_CHUNK = 2
    jg.rebuild(ids, t)
    q = t[[1, 4]]
    ts, tn = tg.search(q, top_k=5)
    js, jn = jg.search(q, top_k=5)
    assert tn == jn and [r[0] for r in tn] == ["1", "4"]
    np.testing.assert_allclose(ts, js, atol=1e-5)


def test_gallery_manager_mesh_passthrough(tmp_path):
    rng = np.random.default_rng(7)
    emb = rng.normal(size=(3, 512)).astype(np.float32)
    jm = JaxManager(gallery_path=str(tmp_path / "j.pkl"), verbose=False, mesh=_jmesh(2))
    tm = GalleryManager(gallery_path=str(tmp_path / "t.pkl"), verbose=False,
                        mesh=tmesh.make_mesh(data=2, devices=[CPU] * 2))
    for m in (jm, tm):
        m.add_student("S1", "One", emb)
        m.add_student("S2", "Two", -emb)
    jt, jv, jids = jm.device_snapshot()
    tt, tv, tids = tm.device_snapshot()
    assert isinstance(tt, tmesh.Sharded) and tids == jids == ["S1", "S2"]
    np.testing.assert_array_equal(tt.gather(CPU).numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tv.gather(CPU).numpy(), np.asarray(jv))
    got, want = tm.search(emb[0], top_k=2), jm.search(emb[0], top_k=2)
    assert [r[:2] for r in got] == [r[:2] for r in want]
    np.testing.assert_allclose([r[2] for r in got], [r[2] for r in want], atol=1e-5)


# ------------------------------------------------------------ the batcher


class _Engine:
    def __init__(self, mesh):
        self.mesh = mesh
        self.device = CPU


@pytest.mark.parametrize("max_batch,buckets", [
    (8, None), (8, (1, 2, 4, 8)), (8, (3, 6)), (4, (1, 2, 3)), (6, None), (5, None),
])
def test_batcher_buckets_filter_to_the_data_axis_as_jax(max_batch, buckets):
    class _JEngine:
        mesh = jmesh.make_mesh(data=2, model=1)

    tm = tmesh.make_mesh(data=2, devices=[CPU] * 2)
    try:
        want = JaxBatcher(_JEngine(), lambda: (None, None), max_batch=max_batch,
                          bucket_sizes=buckets).bucket_sizes
    except ValueError as e:
        with pytest.raises(ValueError, match="multiple") as got:
            DeviceBatcher(_Engine(tm), lambda: (None, None), max_batch=max_batch,
                          bucket_sizes=buckets)
        assert str(got.value) == str(e)
        return
    got = DeviceBatcher(_Engine(tm), lambda: (None, None), max_batch=max_batch,
                        bucket_sizes=buckets).bucket_sizes
    assert got == want


@pytest.mark.parametrize("max_batch,buckets,want", [
    (8, (1, 16, 32), [1, 8]), (8, None, [1, 8]), (4, (2, 4, 4), [2, 4]), (6, (1, 3), [1, 3, 6]),
])
def test_batcher_buckets_clamp_then_dedupe_without_a_mesh(max_batch, buckets, want):
    """One device: sizes above max_batch clamp to it and each size is kept
    once, so warmup compiles no step twice."""
    got = DeviceBatcher(_Engine(None), lambda: (None, None), max_batch=max_batch,
                        bucket_sizes=buckets).bucket_sizes
    assert got == want


def test_batcher_rejects_unshardable_max_batch():
    with pytest.raises(ValueError, match="multiple"):
        DeviceBatcher(_Engine(tmesh.make_mesh(data=4, devices=[CPU] * 4)),
                      lambda: (None, None), max_batch=6)
