"""The port's large-gallery matching against the JAX package, on the CPU.

The same numpy inputs (from a seeded generator) go through the JAX functions
and their counterparts in the port. The JAX streaming functions run their
Pallas kernels in interpret mode; the port's wrappers take their kernels'
plain versions, because the tensors lie on the CPU.

Tolerances, with their reasons:
* bf16 rows (K3): the JAX kernel multiplies the float32 query with the rows
  widened to float32; the port splits the query into two bf16 parts and
  drops a residual of at most 2^-17 per component, and both sum 512 float32
  products in their own order: scores within 1e-5, and indices equal
  wherever neighbouring scores are further apart than that;
* int8 rows (K4): the integer dot is exact in both packages and the two
  scales multiply in the same order; the scores differ only where the two
  frameworks' query norms differ in the last bit: within 1e-6, indices equal;
* `quantize_templates`: bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerecognitionpipeline_tpu.gallery import search as jsearch
from facerecognitionpipeline_tpu.ops import pallas_gallery as jpg
from facerecognitionpipeline_tpu.pipeline.engine import RecognitionEngine as JaxEngine
from facerecognitionpipeline_tpu_torch.gallery import search as tsearch
from facerecognitionpipeline_tpu_torch.ops import gallery_kernel as gk
from facerecognitionpipeline_tpu_torch.parallel.mesh import Mesh, make_mesh
from facerecognitionpipeline_tpu_torch.pipeline.engine import RecognitionEngine
from test_torch_port_gallery_kernel import (
    POOL_CASES,
    POOL_UNRESOLVED_CASES,
    _pool_route_model,
    pool_case,
    pool_scores,
)

torch.set_num_threads(2)

TOL = 1e-5


def _norm(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _gallery(seed, g, n_invalid=0):
    rng = np.random.default_rng(seed)
    t = _norm(rng.normal(size=(g, 512)).astype(np.float32))
    valid = np.ones(g, bool)
    if n_invalid:
        valid[-n_invalid:] = False
        t[-n_invalid:] = 0
    return rng, t, valid


def _queries(rng, t, n_rows, q):
    """Half exact copies of gallery rows, half noisy near-matches."""
    idx = rng.integers(0, n_rows, size=q)
    queries = t[idx].copy()
    queries[q // 2:] += 0.15 * rng.normal(size=(q - q // 2, 512)).astype(np.float32)
    return queries


def _bf16(t):
    """The same bf16 rows for both packages."""
    tt = torch.from_numpy(t).to(torch.bfloat16)
    return jnp.asarray(tt.float().numpy()).astype(jnp.bfloat16), tt


def _assert_topk_close(pv, pi, jv, ji, tol):
    pv, pi, jv, ji = (np.asarray(x) for x in (pv, pi, jv, ji))
    np.testing.assert_allclose(pv, jv, atol=tol)
    gap = np.abs(jv[:, :-1] - jv[:, 1:]) > 2 * tol
    clear = np.ones(ji.shape, bool)
    clear[:, :-1] &= gap
    clear[:, 1:] &= gap
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(pi[clear], ji[clear])


@pytest.mark.parametrize(
    "g,q,k,chunk", [(4096, 16, 8, 1024), (2048, 24, 3, 256), (1024, 1, 5, 512)]
)
def test_streaming_cosine_topk_matches_jax(g, q, k, chunk):
    rng, t, valid = _gallery(1, g, n_invalid=100)
    queries = _queries(rng, t, g - 100, q)
    jt, tt = _bf16(t)
    jv, ji = jpg.streaming_cosine_topk(queries, jt, valid, top_k=k, chunk=chunk, interpret=True)
    pv, pi = gk.streaming_cosine_topk(
        torch.from_numpy(queries), tt, torch.from_numpy(valid), top_k=k, chunk=chunk
    )
    assert pv.dtype == torch.float32 and pi.dtype == torch.int64
    _assert_topk_close(pv, pi, jv, ji, TOL)
    assert (np.asarray(pi) < g - 100).all()  # masked rows never appear


def test_streaming_cosine_topk_float32_rows_match_jax():
    rng, t, valid = _gallery(2, 2048, n_invalid=30)
    queries = _queries(rng, t, 2048 - 30, 12)
    jv, ji = jpg.streaming_cosine_topk(queries, t, valid, top_k=4, chunk=512, interpret=True)
    pv, pi = gk.streaming_cosine_topk(
        torch.from_numpy(queries), torch.from_numpy(t), torch.from_numpy(valid),
        top_k=4, chunk=512,
    )
    _assert_topk_close(pv, pi, jv, ji, TOL)


def test_streaming_query_split_keeps_float32_scores():
    """The two-part bf16 split of the query gives the float32 query's score
    (to ~1e-6), where one bf16 rounding of the query would be ~1e-3 off."""
    rng, t, valid = _gallery(3, 1024)
    queries = _queries(rng, t, 1024, 8)
    _, tt = _bf16(t)
    pv, pi = gk.streaming_cosine_topk(
        torch.from_numpy(queries), tt, torch.from_numpy(valid), top_k=3, chunk=256
    )
    dv, di = tsearch.cosine_topk(torch.from_numpy(queries), tt, torch.from_numpy(valid), 3)
    np.testing.assert_allclose(pv.numpy(), dv.numpy(), atol=TOL)
    np.testing.assert_array_equal(pi[:, 0].numpy(), di[:, 0].numpy())


@pytest.mark.parametrize("kind", ["bf16", "f32", "int8"])
@pytest.mark.parametrize("k", [65, 100])
def test_streaming_past_64_matches_jax(kind, k):
    """top_k 65 and 100 (the card keeps such lists in device memory): the
    plain versions equal the JAX streaming functions in interpret mode over
    four chunks of 64 rows, under the tolerances of the shorter lists."""
    rng, t, valid = _gallery(9, 256, n_invalid=20)
    t[150] = t[40]  # a tie: the lower index first
    queries = _queries(rng, t, 236, 6)
    queries[0] = t[40]
    tq, tv = torch.from_numpy(queries), torch.from_numpy(valid)
    if kind == "int8":
        jc, js = jpg.quantize_templates(t)
        pc, ps = gk.quantize_templates(t)
        jv, ji = jpg.streaming_cosine_topk_int8(queries, jc, js, valid, top_k=k, chunk=64,
                                                interpret=True)
        pv, pi = gk.streaming_cosine_topk_int8(tq, pc, ps, tv, top_k=k, chunk=64)
        np.testing.assert_allclose(pv.numpy(), np.asarray(jv), atol=1e-6)
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    else:
        jt, tt = _bf16(t) if kind == "bf16" else (t, torch.from_numpy(t))
        jv, ji = jpg.streaming_cosine_topk(queries, jt, valid, top_k=k, chunk=64,
                                           interpret=True)
        pv, pi = gk.streaming_cosine_topk(tq, tt, tv, top_k=k, chunk=64)
        _assert_topk_close(pv, pi, jv, ji, TOL)
    assert pv.shape == pi.shape == (6, k)
    assert pi[0, :2].tolist() == [40, 150]
    assert (np.asarray(pi) < 236).all()


@pytest.mark.parametrize("kind", ["bf16", "f32", "int8"])
@pytest.mark.parametrize("case", POOL_CASES)
def test_pool_route_model_matches_jax(kind, case):
    """The pool route's four stages (the numpy model of
    test_torch_port_gallery_kernel.py, the crossover forced down to top_k
    20 on 1024 rows: 4 sampled tiles, T_q the 10th best of them, pools of
    80) against the JAX streaming function in interpret mode, with the
    tolerances above; the adversarial cases send query 0 through the
    unresolved route."""
    queries, t, valid = pool_case(case, g=1024, nq=4)
    k = 20
    geo = gk.gallery_launch_geometry(4, 1024, t.shape[1], kind, 132, k, "pool")
    assert (geo.sample_tiles, geo.sample_rank, geo.pool_cap) == (4, 10, 80)
    scores, q_scale = pool_scores(kind, queries, t)
    got_v, got_i, unresolved = _pool_route_model(scores, valid, geo, np.random.default_rng(4))
    assert (0 in unresolved) == (case in POOL_UNRESOLVED_CASES)
    if kind == "int8":
        jc, js = jpg.quantize_templates(t)
        jv, ji = jpg.streaming_cosine_topk_int8(queries, jc, js, valid, top_k=k, chunk=256,
                                                interpret=True)
        got_v = gk._fold_query_scale(torch.from_numpy(got_v), q_scale).numpy()
        np.testing.assert_allclose(got_v, np.asarray(jv), atol=1e-6)
        np.testing.assert_array_equal(got_i, np.asarray(ji))
    else:
        jt = _bf16(t)[0] if kind == "bf16" else t
        jv, ji = jpg.streaming_cosine_topk(queries, jt, valid, top_k=k, chunk=256,
                                           interpret=True)
        np.testing.assert_allclose(got_v, np.asarray(jv), atol=TOL)
        gap = np.abs(np.diff(np.asarray(jv), axis=1)) > 2 * TOL
        clear = np.ones(got_i.shape, bool)
        clear[:, :-1] &= gap
        clear[:, 1:] &= gap
        np.testing.assert_array_equal(got_i[clear], np.asarray(ji)[clear])


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_streaming_ties_go_to_the_lower_index(kind):
    _, t, valid = _gallery(4, 1024)
    t[700] = t[100]  # exact duplicate, in another chunk
    q = t[100][None]
    if kind == "bf16":
        jt, tt = _bf16(t)
        _, ji = jpg.streaming_cosine_topk(q, jt, valid, top_k=2, chunk=256, interpret=True)
        _, pi = gk.streaming_cosine_topk(
            torch.from_numpy(q), tt, torch.from_numpy(valid), top_k=2, chunk=256
        )
    else:
        jc, js = jpg.quantize_templates(t)
        _, ji = jpg.streaming_cosine_topk_int8(q, jc, js, valid, top_k=2, chunk=256, interpret=True)
        pc, ps = gk.quantize_templates(t)
        _, pi = gk.streaming_cosine_topk_int8(
            torch.from_numpy(q), pc, ps, torch.from_numpy(valid), top_k=2, chunk=256
        )
    assert np.asarray(ji)[0].tolist() == [100, 700]
    assert pi[0].tolist() == [100, 700]


def test_quantize_templates_bit_for_bit():
    _, t, _ = _gallery(5, 512)
    t[10] = 0  # a padded row
    t[11] *= 37.5  # not unit norm
    jc, js = jpg.quantize_templates(t)
    pc, ps = gk.quantize_templates(t)
    assert pc.dtype == torch.int8 and ps.dtype == torch.float32 and ps.shape == (512,)
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    assert ps[10] == 1.0 and not pc[10].any()
    assert int(pc.abs().max()) == 127
    pc2, ps2 = gk.quantize_templates(torch.from_numpy(t))  # tensors too
    assert torch.equal(pc, pc2) and torch.equal(ps, ps2)


@pytest.mark.parametrize("g,q,k,chunk", [(4096, 24, 5, 1024), (1024, 1, 8, 256)])
def test_streaming_cosine_topk_int8_matches_jax(g, q, k, chunk):
    rng, t, valid = _gallery(6, g, n_invalid=50)
    queries = _queries(rng, t, g - 50, q)
    jc, js = jpg.quantize_templates(t)
    pc, ps = gk.quantize_templates(t)
    jv, ji = jpg.streaming_cosine_topk_int8(
        queries, jc, js, valid, top_k=k, chunk=chunk, interpret=True
    )
    pv, pi = gk.streaming_cosine_topk_int8(
        torch.from_numpy(queries), pc, ps, torch.from_numpy(valid), top_k=k, chunk=chunk
    )
    assert pv.dtype == torch.float32 and pi.dtype == torch.int64
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), atol=1e-6)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    # int8 decides like bf16: same top-1, scores within the quantisation step
    _, tt = _bf16(t)
    bv, bi = gk.streaming_cosine_topk(
        torch.from_numpy(queries), tt, torch.from_numpy(valid), top_k=k, chunk=chunk
    )
    np.testing.assert_array_equal(pi[:, 0].numpy(), bi[:, 0].numpy())
    np.testing.assert_allclose(pv.numpy(), bv.numpy(), atol=3e-3)


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_fewer_valid_rows_than_top_k(kind):
    """With fewer valid rows than top_k the JAX streaming functions fill the
    surplus slots with the sentinel (-1e9, index 0) -- not the masked rows'
    own indices, which the dense cosine_topk returns. The port returns the
    same."""
    rng, t, _ = _gallery(7, 1024)
    valid = np.zeros(1024, bool)
    valid[[7, 900]] = True
    queries = _queries(rng, t, 1024, 3)
    queries[0] = t[900]
    tq, tv = torch.from_numpy(queries), torch.from_numpy(valid)
    if kind == "bf16":
        jt, tt = _bf16(t)
        jv, ji = jpg.streaming_cosine_topk(queries, jt, valid, top_k=4, chunk=256, interpret=True)
        pv, pi = gk.streaming_cosine_topk(tq, tt, tv, top_k=4, chunk=256)
    else:
        jc, js = jpg.quantize_templates(t)
        pc, ps = gk.quantize_templates(t)
        jv, ji = jpg.streaming_cosine_topk_int8(
            queries, jc, js, valid, top_k=4, chunk=256, interpret=True
        )
        pv, pi = gk.streaming_cosine_topk_int8(tq, pc, ps, tv, top_k=4, chunk=256)
    jv, ji = np.asarray(jv), np.asarray(ji)
    assert ji[0].tolist() == [900, 7, 0, 0]
    assert (ji[:, 2:] == 0).all() and (jv[:, 2:] == np.float32(-1e9)).all()
    np.testing.assert_array_equal(pi.numpy(), ji)
    np.testing.assert_allclose(pv.numpy(), jv, atol=TOL)
    assert (pv[:, 2:].numpy() == np.float32(-1e9)).all()


def test_streaming_wrappers_check_their_arguments():
    _, t, valid = _gallery(8, 256)
    tq, tt, tv = torch.from_numpy(t[:2]), torch.from_numpy(t), torch.from_numpy(valid)
    with pytest.raises(AssertionError, match="multiple of the chunk"):
        jpg.streaming_cosine_topk(t[:2], t, valid, top_k=2, chunk=100, interpret=True)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        gk.streaming_cosine_topk(tq, tt, tv, top_k=2, chunk=100)
    pc, ps = gk.quantize_templates(t)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        gk.streaming_cosine_topk_int8(tq, pc, ps, tv, top_k=2, chunk=100)
    with pytest.raises(TypeError, match="int8"):
        gk.streaming_cosine_topk_int8(tq, tt, ps, tv, top_k=2, chunk=64)
    with pytest.raises(ValueError, match="scales"):
        gk.streaming_cosine_topk_int8(tq, pc, ps[:-1], tv, top_k=2, chunk=64)
    with pytest.raises(ValueError, match="valid"):
        gk.streaming_cosine_topk(tq, tt, tv[:-1], top_k=2, chunk=64)
    with pytest.raises(ValueError, match=r"\[Q,D\]"):
        gk.streaming_cosine_topk(tq[:, :100], tt, tv, top_k=2, chunk=64)
    with pytest.raises(ValueError, match="unsupported device"):
        gk.streaming_cosine_topk(tq.to("meta"), tt.to("meta"), tv.to("meta"), top_k=2, chunk=64)
    s, i = gk.streaming_cosine_topk(tq[:0], tt, tv, top_k=2, chunk=64)  # no queries
    assert s.shape == i.shape == (0, 2)
    s, i = gk.streaming_cosine_topk(tq, tt, tv, top_k=12, chunk=64)  # CPU: any top_k
    assert s.shape == (2, 12) and (s[:, :-1] >= s[:, 1:]).all()
    assert gk.LAUNCHES.count == 0 and gk.LAUNCHES_INT8.count == 0  # no kernel on the CPU


# ------------------------------------------------------------ DeviceGallery


def test_small_device_gallery_is_float32_like_jax():
    """Below the streaming threshold both packages keep float32 templates,
    so `search` scores agree to float32 accuracy (a bf16 store would be
    ~1e-3 off)."""
    rng, t, _ = _gallery(9, 40)
    ids = [f"s{i}" for i in range(40)]
    queries = _queries(rng, t, 40, 6)
    jg = jsearch.DeviceGallery()
    jg.rebuild(ids, t)
    tg = tsearch.DeviceGallery(device="cpu")
    tg.rebuild(ids, t)
    ti, tt, tv, compact = tg.snapshot()
    assert compact is None and tt.dtype == torch.float32 and tt.shape == (128, 512)
    assert tt.shape == jg._templates.shape and jg._templates.dtype == jnp.float32
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jg._templates))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jg._valid))
    snap_t, snap_v, snap_ids = tg.device_snapshot()
    assert snap_t is tt and snap_v is tv and snap_ids == ids == ti
    js, jn = jg.search(queries, top_k=4)
    ts, tn = tg.search(queries, top_k=4)
    assert tn == jn
    np.testing.assert_allclose(ts, js, atol=1e-5)
    # the fault this replaces: bf16 rows move the same scores by ~1e-3
    bs, _ = tsearch.cosine_topk(torch.from_numpy(queries), tt.to(torch.bfloat16), tv, 4)
    assert np.abs(bs.numpy() - js).max() > 1e-4


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_device_gallery_across_the_threshold_matches_jax(quantize):
    rng, t, _ = _gallery(10, 600)
    ids = [f"id{i}" for i in range(600)]
    queries = _queries(rng, t, 600, 5)
    jg = jsearch.DeviceGallery(streaming_threshold=512, quantize=quantize)
    jg.STREAM_CHUNK = 256
    jg.rebuild(ids, t)
    tg = tsearch.DeviceGallery(streaming_threshold=512, quantize=quantize, device="cpu")
    tg.STREAM_CHUNK = 256
    tg.rebuild(ids, t)
    _, tt, tv, compact = tg.snapshot()
    assert tt.shape == jg._templates.shape == (768, 512) and tt.dtype == torch.float32
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jg._valid))
    jc = jg._templates_bf16
    if quantize == "int8":
        assert isinstance(compact, tuple) and compact[0].dtype == torch.int8
        np.testing.assert_array_equal(compact[0].numpy(), np.asarray(jc[0]))
        np.testing.assert_array_equal(compact[1].numpy(), np.asarray(jc[1]))
        tol = 1e-6
    else:
        assert compact.dtype == torch.bfloat16 and jc.dtype == jnp.bfloat16
        np.testing.assert_array_equal(
            compact.float().numpy(), np.asarray(jc.astype(jnp.float32))
        )
        tol = TOL
    assert tg.device_snapshot()[0] is compact
    js, jn = jg.search(queries, top_k=3)
    ts, tn = tg.search(queries, top_k=3)
    assert [r[0] for r in tn] == [r[0] for r in jn]
    _assert_topk_close(ts, np.array(tn), js, np.array(jn), tol)
    # one query, as the manager's search sends it
    ts1, tn1 = tg.search(t[42], top_k=3)
    assert tn1[0][0] == "id42" and ts1[0, 0] == pytest.approx(1.0, abs=1e-2)
    # below the threshold the flag is inert
    tg.rebuild(ids[:100], t[:100])
    assert tg.snapshot()[3] is None and tg.snapshot()[1].shape == (128, 512)


def test_device_gallery_options():
    with pytest.raises(ValueError, match="quantize"):
        tsearch.DeviceGallery(quantize="int4", device="cpu")
    # a mesh without the shard axis raises, as the JAX DeviceGallery does;
    # with it the rows shard and the search equals the unsharded one
    with pytest.raises(ValueError, match="'data' axis"):
        tsearch.DeviceGallery(mesh=Mesh(["cpu"] * 2, ("gallery",)), device="cpu")
    sharded = tsearch.DeviceGallery(mesh=make_mesh(data=2, devices=["cpu"] * 2))
    plain = tsearch.DeviceGallery(device="cpu")
    rows = np.eye(6, 512, dtype=np.float32)
    for g in (sharded, plain):
        g.rebuild([str(i) for i in range(6)], rows)
    assert [b.shape for b in sharded.snapshot()[1].blocks] == [(128, 512)] * 2
    assert sharded.search(rows[4], top_k=2)[1] == plain.search(rows[4], top_k=2)[1]
    dg = tsearch.DeviceGallery(device="cpu")
    s, n = dg.search(np.zeros(512, np.float32))
    assert s.shape == (1, 0) and n == [[]]
    assert dg.device_snapshot() == (None, None, [])
    # a tensor is taken as it is, and the threshold counts identities
    dg = tsearch.DeviceGallery(streaming_threshold=130, device="cpu")
    dg.rebuild([str(i) for i in range(129)], torch.eye(129, 512))
    assert dg.snapshot()[3] is None and dg.snapshot()[1].shape == (256, 512)
    dg.rebuild([str(i) for i in range(130)], torch.eye(130, 512))
    assert dg.snapshot()[3].dtype == torch.bfloat16 and dg.snapshot()[1].shape == (4096, 512)
    assert dg.size == 130


# ------------------------------------------------------- engine._match routing


def _jax_engine(impl, chunk=256, threshold=512):
    eng = JaxEngine.__new__(JaxEngine)
    eng.gallery_impl = impl
    eng._stream_on_auto = False
    eng.gallery_streaming_threshold = threshold
    eng.gallery_chunk = chunk
    eng.shard_gallery = False
    eng.mesh = None
    return eng


@pytest.fixture(scope="module")
def parts():
    from facerecognitionpipeline_tpu_torch.models.detector import MTCNNDetector
    from facerecognitionpipeline_tpu_torch.pipeline.embedder import FaceEmbedder

    det = MTCNNDetector(det_size=(64, 64), min_face_size=20, max_faces=2, device="cpu")
    emb = FaceEmbedder("ir_micro", random_ok=True, device="cpu")
    return det, emb


@pytest.fixture
def spy(monkeypatch):
    """Names of the search functions `_match` reached."""
    calls = []
    for name in ("streaming_cosine_topk", "streaming_cosine_topk_int8", "cosine_topk"):
        fn = getattr(tsearch, name)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            calls.append(_name)
            return _fn(*a, **kw)

        monkeypatch.setattr(tsearch, name, wrapped)
    return calls


@pytest.mark.parametrize(
    "case", ["dense", "streaming", "pair_streams", "pair_dense", "auto_cpu", "auto_card"]
)
def test_engine_match_routing_matches_jax(parts, spy, case):
    g = 1000 if case == "pair_dense" else 1024
    rng, t, valid = _gallery(11, g, n_invalid=24)
    feats = _queries(rng, t, g - 24, 8).reshape(2, 4, 512)
    impl = {"dense": "dense", "streaming": "streaming"}.get(case, "auto")
    jeng = _jax_engine(impl)
    teng = RecognitionEngine(
        *parts, gallery_impl=impl, gallery_chunk=256, gallery_streaming_threshold=512
    )
    assert teng._stream_on_auto is False  # a CPU engine
    tf, tv = torch.from_numpy(feats), torch.from_numpy(valid)
    if case.startswith("pair"):
        jt = jpg.quantize_templates(t)
        tt = gk.quantize_templates(t)
        want = "streaming_cosine_topk_int8" if case == "pair_streams" else None
        tol = 1e-6
    else:
        jt, tt = _bf16(t)
        if case == "auto_card":  # what 'auto' does where the kernel runs
            jeng._stream_on_auto = teng._stream_on_auto = True
        want = {
            "dense": "cosine_topk", "auto_cpu": "cosine_topk",
            "streaming": "streaming_cosine_topk", "auto_card": "streaming_cosine_topk",
        }[case]
        tol = TOL
    js, ji = jeng._match(jnp.asarray(feats), jt, jnp.asarray(valid), 3)
    ts, ti = teng._match(tf, tt, tv, 3)
    assert spy == ([want] if want else [])  # pair_dense: the dequantising matmul
    assert ts.shape == ti.shape == (2, 4, 3) and ti.dtype == torch.int64
    _assert_topk_close(ts.reshape(8, 3), ti.reshape(8, 3), js.reshape(8, 3), ji.reshape(8, 3), tol)


def test_engine_match_auto_needs_bf16_rows_and_the_threshold(parts, spy):
    _, t, valid = _gallery(12, 1024)
    teng = RecognitionEngine(*parts, gallery_chunk=256, gallery_streaming_threshold=512)
    teng._stream_on_auto = True
    tf, tv = torch.from_numpy(t[:4].reshape(1, 4, 512)), torch.from_numpy(valid)
    teng._match(tf, torch.from_numpy(t), tv, 2)  # float32 rows
    teng._match(tf, torch.from_numpy(t[:256]).to(torch.bfloat16), tv[:256], 2)  # small
    teng._match(tf, torch.from_numpy(t[:1000]).to(torch.bfloat16), tv[:1000], 2)  # ragged
    assert spy == ["cosine_topk"] * 3


def test_engine_streaming_refuses_rows_that_do_not_divide_the_chunk(parts):
    _, t, valid = _gallery(13, 1000)
    feats = t[:4].reshape(1, 4, 512)
    jeng = _jax_engine("streaming")
    teng = RecognitionEngine(*parts, gallery_impl="streaming", gallery_chunk=256)
    with pytest.raises(ValueError, match="gallery_chunk"):
        jeng._match(jnp.asarray(feats), jnp.asarray(t), jnp.asarray(valid), 2)
    with pytest.raises(ValueError, match="gallery_chunk"):
        teng._match(torch.from_numpy(feats), torch.from_numpy(t), torch.from_numpy(valid), 2)
    with pytest.raises(ValueError, match="gallery_impl"):
        RecognitionEngine(*parts, gallery_impl="pallas")
