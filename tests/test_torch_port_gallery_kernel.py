"""The streaming kernels' launch arithmetic and decomposition, on the CPU.

K3 and K4 (`csrc/gallery_topk.cuh`) run only on a card. What surrounds them
is Python and is held here: `gallery_launch_geometry` (grid, ring depth,
shared-memory bytes, scratch shapes, what is refused), and the way the
kernels cut the work: gallery tiles of 64 rows dealt to P blocks in turn, a
sorted top-8 list with sentinels per block, and a merge under (value
descending, index ascending). The decomposition is written out in plain
PyTorch below and must equal `streaming_cosine_topk_int8_plain` bit for bit.
"""

import numpy as np
import pytest
import torch

from facerecognitionpipeline_tpu_torch.ops import cuda_build
from facerecognitionpipeline_tpu_torch.ops import gallery_kernel as gk
from facerecognitionpipeline_tpu_torch.ops.gallery_kernel import gallery_launch_geometry

_SMS = 132  # streaming multiprocessors of an H100
_QS = (1, 64, 65, 128, 129, 300)
_GS = (32, 4096 + 32, 1 << 20)
_DS = (32, 96, 512)


@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("d", _DS)
@pytest.mark.parametrize("g", _GS)
@pytest.mark.parametrize("q", _QS)
def test_gallery_launch_geometry(q, g, d, kind):
    for top_k in (1, 3, 8, 16, 33, 64):
        geo = gallery_launch_geometry(q, g, d, kind, _SMS, top_k)
        grid_x, q_tiles = geo.grid
        assert geo.q_tile == {"bf16": 64, "int8": 128}[kind]
        assert (q_tiles - 1) * geo.q_tile < q <= q_tiles * geo.q_tile
        assert geo.n_tiles == -(-g // 64)
        # one block per SM at most (no clusters), and none without a tile
        assert 1 <= grid_x * q_tiles <= _SMS
        assert grid_x <= geo.n_tiles
        assert geo.threads == 384
        # a ring of an even number of stages, half per consumer warpgroup
        assert 4 <= geo.stages <= 16 and geo.stages % 2 == 0
        elem = {"bf16": 2, "int8": 1}[kind]
        assert (geo.panels - 1) * 128 < d * elem <= geo.panels * 128
        assert top_k <= geo.list_len <= gk.MAX_TOP_K
        want = (
            1024 + geo.panels * 128 * 128 + geo.stages * (64 * 128 + 64 * 5 + 16)
            + 2 * geo.q_tile * geo.list_len * 8 + geo.q_tile * 4
        )
        assert geo.smem_bytes == want <= cuda_build.SMEM_LIMIT_BYTES == 232_448
        # the scratch lists cover every block of every real query
        assert geo.scratch == (q, grid_x, geo.list_len)
        # every gallery tile is owned by exactly one block of a query tile:
        # block x takes x, x + grid_x, ...
        owners = np.zeros(min(geo.n_tiles, 4 * grid_x + 7), np.int64)
        for x in range(grid_x):
            owners[x::grid_x] += 1
        assert (owners == 1).all()


def test_gallery_serving_geometry():
    """The shapes the serving step launches: 128 queries against 1 048 576
    rows, top-3. K4 reads the gallery once with a 16-stage ring; K3 holds 64
    queries as two bf16 parts, so two blocks share each tile and the ring is
    what the rest of shared memory holds."""
    k4 = gallery_launch_geometry(128, 1 << 20, 512, "int8", _SMS, 3)
    assert (k4.grid, k4.panels, k4.stages, k4.list_len) == ((132, 1), 4, 16, 3)
    k3 = gallery_launch_geometry(128, 1 << 20, 512, "bf16", _SMS, 3)
    assert (k3.grid, k3.panels, k3.stages, k3.list_len) == ((66, 2), 8, 10, 3)
    assert gallery_launch_geometry(64, 1 << 20, 512, "bf16", _SMS, 3).grid == (132, 1)
    # top_k 5..8 take the kernel built for lists of 8
    assert gallery_launch_geometry(1, 8192, 512, "bf16", _SMS, 5).list_len == 8
    assert gallery_launch_geometry(1, 8192, 512, "int8", _SMS, 4).list_len == 4


@pytest.mark.parametrize("args,match", [
    ((4, 4096, 48, "bf16", _SMS, 3), "D % 32"),
    ((4, 4096, 512, "bf16", _SMS, 65), "ROADMAP.md"),
    ((4, 4096, 512, "bf16", _SMS, 0), "top_k"),
    ((4, 4096, 768, "bf16", _SMS, 3), "shared memory"),  # 192 KB of queries
    ((4, 4096, 2048, "int8", _SMS, 3), "shared memory"),
    ((4, 2**31 - 8, 512, "int8", _SMS, 3), "32 bits"),
    ((0, 4096, 512, "int8", _SMS, 3), "at least 1"),
    ((4, 0, 512, "int8", _SMS, 3), "at least 1"),
    ((4, 4096, 512, "fp8", _SMS, 3), "kind"),
    ((64 * 70000, 64, 32, "bf16", _SMS, 1), "grid limit"),
])
def test_gallery_geometry_refuses(args, match):
    with pytest.raises(ValueError, match=match):
        gallery_launch_geometry(*args)


@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("top_k", [9, 16, 17, 32, 33, 64])
def test_long_lists_keep_a_ring_at_d512(kind, top_k):
    """Lists of 16, 32 and 64 entries live in shared memory beside the
    queries; at D = 512 the ring keeps at least _MIN_STAGES stages."""
    geo = gallery_launch_geometry(128, 1 << 20, 512, kind, _SMS, top_k)
    assert geo.list_len == min(n for n in (16, 32, 64) if n >= top_k)
    assert gk._MIN_STAGES <= geo.stages <= gk._MAX_STAGES
    assert geo.smem_bytes <= cuda_build.SMEM_LIMIT_BYTES
    assert geo.scratch == (128, geo.grid[0], geo.list_len)


def test_long_list_serving_geometry():
    """The ring depth each list length leaves at 128 x 1 048 576 x 512."""
    stages = {
        (kind, k): gallery_launch_geometry(128, 1 << 20, 512, kind, _SMS, k).stages
        for kind in ("bf16", "int8") for k in (8, 16, 32, 64)
    }
    assert stages == {
        ("bf16", 8): 10, ("bf16", 16): 8, ("bf16", 32): 6, ("bf16", 64): 4,
        ("int8", 8): 16, ("int8", 16): 14, ("int8", 32): 10, ("int8", 64): 4,
    }


@pytest.mark.parametrize("kind", ["bf16", "int8", "f32"])
@pytest.mark.parametrize("top_k", [65, 100, 1000])
def test_top_k_over_64_is_refused_before_a_launch(kind, top_k):
    """A CUDA-shaped call with top_k > 64 raises from the geometry, which the
    wrapper computes before it allocates or launches anything."""
    with pytest.raises(ValueError, match=r"top_k=64.*ROADMAP\.md"):
        gallery_launch_geometry(128, 1 << 20, 512, kind, _SMS, top_k)


@pytest.mark.parametrize("d", _DS)
@pytest.mark.parametrize("q", _QS)
def test_f32_launch_geometry(q, d):
    """K3 on float32 rows: 64 queries per block staged whole (rows padded by
    4 floats), a 64 x 36-float panel buffer and 64 valid bytes per
    warpgroup, the lists and thresholds; 256 threads, no ring."""
    for top_k in (1, 3, 8, 16, 33, 64):
        geo = gallery_launch_geometry(q, 1 << 20, d, "f32", _SMS, top_k)
        assert geo.q_tile == 64 and geo.threads == 256 and geo.stages == 0
        assert geo.panels == d // 32
        want = 64 * (d + 4) * 4 + 2 * 64 * (36 * 4 + 1) + 2 * 64 * geo.list_len * 8 + 64 * 4
        assert geo.smem_bytes == want <= cuda_build.SMEM_LIMIT_BYTES
        q_tiles = -(-q // 64)
        assert geo.grid == (max(1, _SMS // q_tiles), q_tiles)


def test_f32_geometry_refuses_queries_over_shared_memory():
    assert gallery_launch_geometry(128, 4096, 512, "f32", _SMS, 64).smem_bytes <= 232_448
    with pytest.raises(ValueError, match="shared memory"):
        gallery_launch_geometry(128, 4096, 768, "f32", _SMS, 64)


def test_gallery_geometry_more_query_tiles_than_sms():
    """Beyond one query tile per SM the blocks queue: one block per query
    tile walks the whole gallery."""
    geo = gallery_launch_geometry(64 * 200, 4096, 512, "bf16", _SMS, 3)
    assert geo.grid == (1, 200)


# ------------------------------------------------------------ decomposition

_NEG = -1e9


def _sorted_topk(v, i, k):
    """The k first of (v, i) pairs [Q, N] under (value descending, index
    ascending), padded with the sentinel (-1e9, 0)."""
    q, n = v.shape
    if n < k:
        v = torch.cat([v, torch.full((q, k - n), _NEG)], dim=1)
        i = torch.cat([i, torch.zeros((q, k - n), dtype=i.dtype)], dim=1)
    # a stable sort by index, then a stable sort by descending value
    order = torch.argsort(i, dim=1, stable=True)
    v, i = torch.gather(v, 1, order), torch.gather(i, 1, order)
    order = torch.argsort(v, dim=1, descending=True, stable=True)
    return torch.gather(v, 1, order)[:, :k], torch.gather(i, 1, order)[:, :k]


def _decomposed_int8_topk(queries, codes, scales, valid, top_k, parts):
    """K4's decomposition in plain PyTorch: 64-row tiles dealt to `parts`
    blocks in turn, a top-8 list with sentinels per block (invalid rows
    never enter), a merge of the lists, the query scale folded in last."""
    qq, q_scale = gk._quantize_rows(gk.normalize_queries(queries))
    qf = qq.float()
    g = codes.shape[0]
    n_tiles = -(-g // 64)
    lists_v, lists_i = [], []
    for x in range(parts):
        rows = [r for t in range(x, n_tiles, parts) for r in range(64 * t, min(g, 64 * t + 64))]
        rows = torch.tensor([r for r in rows if valid[r]], dtype=torch.int64)
        if rows.numel():
            score = (qf @ codes[rows].float().T) * scales[rows][None]
            idx = rows[None].expand(qf.shape[0], -1)
        else:  # a block that owns no tile, or no valid row
            score = torch.zeros((qf.shape[0], 0))
            idx = torch.zeros((qf.shape[0], 0), dtype=torch.int64)
        v, i = _sorted_topk(score, idx, gk.MAX_TOP_K)
        lists_v.append(v)
        lists_i.append(i)
    v, i = torch.cat(lists_v, dim=1), torch.cat(lists_i, dim=1)
    real = v > _NEG  # sentinels of several blocks are one sentinel
    v = torch.where(real, v, torch.full_like(v, -float("inf")))
    mv, mi = _sorted_topk(v, i, top_k)
    gone = torch.isinf(mv)
    mv = torch.where(gone, torch.full_like(mv, _NEG), mv)
    mi = torch.where(gone, torch.zeros_like(mi), mi)
    return gk._fold_query_scale(mv, q_scale), mi


@pytest.mark.parametrize("parts", [1, 2, 66, 132])
@pytest.mark.parametrize("top_k", [16, 33, 64])
def test_decomposition_with_long_lists(parts, top_k):
    """The same decomposition for list lengths past the register lists: 65
    tiles dealt to the blocks, 40 invalid rows, duplicate rows."""
    rng = np.random.default_rng(11)
    g = 4096 + 32
    t = rng.normal(size=(g, 64)).astype(np.float32)
    t /= np.linalg.norm(t, axis=1, keepdims=True)
    for r in (70, 700, 1500, 4000):
        t[r] = t[5]
    valid = np.ones(g, bool)
    valid[-40:] = False
    queries = rng.normal(size=(5, 64)).astype(np.float32)
    queries[0] = 3.0 * t[5]
    codes, scales = gk.quantize_templates(torch.from_numpy(t))
    qq, vv = torch.from_numpy(queries), torch.from_numpy(valid)
    want_v, want_i = gk.streaming_cosine_topk_int8_plain(qq, codes, scales, vv, top_k, chunk=32)
    got_v, got_i = _decomposed_int8_topk(qq, codes, scales, vv, top_k, parts)
    assert torch.equal(got_v, want_v) and torch.equal(got_i, want_i)
    assert want_i[0, :5].tolist() == [5, 70, 700, 1500, 4000]


@pytest.mark.parametrize("parts", [1, 2, 66, 132])
@pytest.mark.parametrize("case", ["duplicates", "few_valid", "ragged"])
def test_decomposition_equals_the_running_version(parts, case):
    """32 to 65 tiles dealt to 1, 2, 66 or 132 blocks: with 66 and 132 some
    blocks own one tile or none."""
    rng = np.random.default_rng(7)
    g = {"duplicates": 4096, "few_valid": 2048, "ragged": 4096 + 32}[case]
    t = rng.normal(size=(g, 64)).astype(np.float32)
    t /= np.linalg.norm(t, axis=1, keepdims=True)
    valid = np.ones(g, bool)
    valid[-40:] = False
    top_k = 5
    if case == "duplicates":  # equal rows in different tiles and blocks
        for r in (70, 700, 1500, 4000):
            t[r] = t[5]
    if case == "few_valid":  # fewer valid rows than top_k, in distant tiles
        valid[:] = False
        valid[[3, 900, 1999]] = True
    queries = rng.normal(size=(9, 64)).astype(np.float32)
    queries[0] = 3.0 * t[5]
    codes, scales = gk.quantize_templates(torch.from_numpy(t))
    qq, vv = torch.from_numpy(queries), torch.from_numpy(valid)
    want_v, want_i = gk.streaming_cosine_topk_int8_plain(qq, codes, scales, vv, top_k, chunk=32)
    got_v, got_i = _decomposed_int8_topk(qq, codes, scales, vv, top_k, parts)
    assert torch.equal(got_v, want_v) and torch.equal(got_i, want_i)
    if case == "duplicates":  # ties come back lower index first
        assert want_i[0, :5].tolist() == [5, 70, 700, 1500, 4000]
    if case == "few_valid":
        assert (want_i[:, 3:] == 0).all() and (want_v[:, 3:] == _NEG).all()


def test_cuda_wrappers_read_their_constants_once(monkeypatch):
    """The kernels' query tile and KMAX are asked of the library once per
    process, and the launch function's argument types are set once."""
    calls = []
    answers = {
        "frp_gallery_topk_qtile": 64, "frp_gallery_topk_int8_qtile": 128,
        "frp_gallery_topk_kmax": 64, "frp_gallery_topk_int8_kmax": 64,
    }

    def fake_function(name, symbol, argtypes):
        calls.append(symbol)
        return lambda: answers[symbol]

    monkeypatch.setattr(cuda_build, "function", fake_function)
    gk._checked_library.cache_clear()
    try:
        for _ in range(3):
            assert gk._checked_library("gallery_topk") == "gallery_topk"
            assert gk._checked_library("gallery_topk_int8") == "gallery_topk_int8"
        assert sorted(calls) == sorted(answers)
    finally:
        gk._checked_library.cache_clear()
