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


def _want_smem(geo, kind):
    """`frp::Layout::bytes`: alignment slack, the staged queries, the ring
    (a stage, its side bytes and two barriers each), the lists (or, in
    device memory, their buffers of 32, counts and fills), the thresholds."""
    qpanel = {"bf16": 128 * 128, "int8": 128 * 128, "f32": 64 * 128}[kind]
    per_query = 32 * 8 + 8 if geo.lists == "device" else geo.list_len * 8
    return (1024 + geo.panels * qpanel + geo.stages * (64 * 128 + 64 * 5 + 16)
            + 2 * geo.q_tile * per_query + geo.q_tile * 4)


@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("d", _DS)
@pytest.mark.parametrize("g", _GS)
@pytest.mark.parametrize("q", _QS)
def test_gallery_launch_geometry(q, g, d, kind):
    for top_k in (1, 3, 8, 16, 33, 64, 65, 1024):
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
        assert geo.smem_bytes == _want_smem(geo, kind) <= cuda_build.SMEM_LIMIT_BYTES == 232_448
        # the scratch lists cover every block (device lists: every block and
        # warpgroup) of every real query
        if geo.lists == "device":
            assert geo.scratch == (q, 2 * grid_x, top_k) and geo.buffer == 32
        else:
            assert geo.scratch == (q, grid_x, geo.list_len) and geo.buffer == 0
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
    ((4, 4096, 512, "bf16", _SMS, gk.MAX_TOP_K + 1), "shared memory"),
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
    """Lists of 9 to 16 entries live in shared memory beside the queries,
    from 17 on in device memory; at D = 512 the ring keeps at least
    _MIN_STAGES stages either way."""
    geo = gallery_launch_geometry(128, 1 << 20, 512, kind, _SMS, top_k)
    if top_k <= 16:
        assert (geo.lists, geo.list_len) == ("shared", 16)
        assert geo.scratch == (128, geo.grid[0], 16)
    else:
        assert (geo.lists, geo.list_len) == ("device", top_k)
        assert geo.scratch == (128, 2 * geo.grid[0], top_k)
    assert gk._MIN_STAGES <= geo.stages <= gk._MAX_STAGES
    assert geo.smem_bytes <= cuda_build.SMEM_LIMIT_BYTES


def test_long_list_serving_geometry():
    """The ring depth each list length leaves at 128 x 1 048 576 x 512: lists
    in shared memory take ring stages, lists in device memory (17 and on)
    only their buffers of 32."""
    stages = {
        (kind, k): gallery_launch_geometry(128, 1 << 20, 512, kind, _SMS, k).stages
        for kind in ("bf16", "int8", "f32") for k in (8, 16, 32, 64, 65, 1024)
    }
    assert stages == {
        ("bf16", 8): 10, ("bf16", 16): 8, ("bf16", 32): 6, ("bf16", 64): 6,
        ("bf16", 65): 6, ("bf16", 1024): 6,
        ("int8", 8): 16, ("int8", 16): 14, ("int8", 32): 10, ("int8", 64): 10,
        ("int8", 65): 10, ("int8", 1024): 10,
        ("f32", 8): 10, ("f32", 16): 8, ("f32", 32): 6, ("f32", 64): 6,
        ("f32", 65): 6, ("f32", 1024): 6,
    }


@pytest.mark.parametrize("kind", ["bf16", "int8", "f32"])
@pytest.mark.parametrize("top_k", [65, 100, 1000])
def test_top_k_over_64_takes_lists_in_device_memory(kind, top_k):
    """top_k past 64 to MAX_TOP_K: one sorted list per query, block and
    warpgroup in device memory, a buffer of 32 candidates per query in
    shared memory, a ring of at least _MIN_STAGES; the merge kernel gets a
    block per query and as many warps as a pair of lists each fits."""
    geo = gallery_launch_geometry(128, 1 << 20, 512, kind, _SMS, top_k)
    grid_x = geo.grid[0]
    assert (geo.lists, geo.list_len, geo.buffer) == ("device", top_k, 32)
    assert geo.scratch == (128, 2 * grid_x, top_k)
    assert gk._MIN_STAGES <= geo.stages <= gk._MAX_STAGES
    assert geo.smem_bytes == _want_smem(geo, kind) <= cuda_build.SMEM_LIMIT_BYTES
    warps = min(32, cuda_build.SMEM_LIMIT_BYTES // (16 * top_k))
    assert geo.merge == (128, 32 * warps, warps * 16 * top_k)
    assert geo.merge[2] <= cuda_build.SMEM_LIMIT_BYTES and geo.merge[1] <= 1024
    # the scratch at the limit: Q x 2 grid_x x k x 8 bytes
    top = gallery_launch_geometry(128, 1 << 20, 512, kind, _SMS, gk.MAX_TOP_K)
    assert np.prod(top.scratch) * 8 == {"bf16": 1_963_720_704, "f32": 1_963_720_704,
                                        "int8": 3_927_441_408}[kind]


def test_max_top_k_is_the_merge_shared_memory_bound():
    """F2's residue: the longest list the card answers is what the merge of
    lists in device memory holds, a pair of lists of top_k (16 top_k bytes)
    in one warp's shared memory, rounded down to whole 32-entry lane chunks:
    14 528 on an H100, and no longer 1024."""
    assert gk.MAX_TOP_K == cuda_build.SMEM_LIMIT_BYTES // 16 // 32 * 32 == 14_528
    assert 16 * gk.MAX_TOP_K <= cuda_build.SMEM_LIMIT_BYTES < 16 * (gk.MAX_TOP_K + 32)


@pytest.mark.parametrize("kind", ["bf16", "int8", "f32"])
@pytest.mark.parametrize("top_k", [1025, 4096, gk.MAX_TOP_K])
def test_long_lists_past_1024_launch_geometry(kind, top_k):
    """top_k 1025 to MAX_TOP_K: device lists, the stream kernel's shared
    memory as at any device-list top_k (it does not depend on k), the merge
    with 1-32 warps whose pairs of lists fit shared memory; at the labeler's
    query counts every offset of the scratch fits the kernels' 64-bit
    indices and every gallery index their int32 ones."""
    base = gallery_launch_geometry(128, 1 << 20, 512, kind, _SMS, 65)
    for q in (1, 128, 4096, 100_000):
        geo = gallery_launch_geometry(q, 1 << 20, 512, kind, _SMS, top_k)
        assert (geo.lists, geo.list_len) == ("device", top_k)
        if q == 128:
            assert (geo.smem_bytes, geo.stages) == (base.smem_bytes, base.stages)
        blocks, threads, smem = geo.merge
        assert blocks == q and 1 <= threads // 32 <= 32 and threads % 32 == 0
        assert smem == (threads // 32) * 16 * top_k <= cuda_build.SMEM_LIMIT_BYTES
        assert int(np.prod(geo.scratch)) < 2**63 and (1 << 20) < 2**31 - 64
    assert gallery_launch_geometry(4, 4096, 512, kind, _SMS, gk.MAX_TOP_K).merge[1] == 32


def test_top_k_past_the_bound_names_it():
    with pytest.raises(ValueError, match=r"top_k 1\.\.14528, got 14529: .*16 top_k bytes.*"
                                         r"232448 bytes of shared memory"):
        gallery_launch_geometry(4, 4096, 512, "bf16", _SMS, gk.MAX_TOP_K + 1)


@pytest.mark.parametrize("d", _DS)
@pytest.mark.parametrize("q", _QS)
def test_f32_launch_geometry(q, d):
    """K3 on float32 rows on the shared body: 64 queries per block staged
    whole (64 rows of 128 bytes per 32-float panel), the TMA ring of 8 KB
    stages (64 rows x 32 floats), the lists and thresholds; 384 threads."""
    for top_k in (1, 3, 8, 16, 33, 64, 65, 1024):
        geo = gallery_launch_geometry(q, 1 << 20, d, "f32", _SMS, top_k)
        assert geo.q_tile == 64 and geo.threads == 384
        assert 4 <= geo.stages <= 16 and geo.stages % 2 == 0
        assert geo.panels == d // 32
        assert geo.smem_bytes == _want_smem(geo, "f32") <= cuda_build.SMEM_LIMIT_BYTES
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
    """K4's decomposition in plain PyTorch, short lists: 64-row tiles dealt
    to `parts` blocks in turn, a sorted list of the kernel's length with
    sentinels per block (invalid rows never enter), a merge of the lists,
    the query scale folded in last."""
    qq, q_scale = gk._quantize_rows(gk.normalize_queries(queries))
    qf = qq.float()
    g = codes.shape[0]
    n_tiles = -(-g // 64)
    list_len = gk.list_placement(top_k)[1]
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
        v, i = _sorted_topk(score, idx, list_len)
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


def _before(av, ai, bv, bi):
    """The kernels' strict total order: value descending, index ascending."""
    return (av > bv) | ((av == bv) & (ai < bi))


def _flush(lv, li, fill, cv, ci, k):
    """`frp::flush_list` step for step: the buffer sorted best first, then
    the list (real entries below `fill`, sentinels above) rewritten from the
    top down in chunks of 32 x 4 entries, read whole before any write; entry
    i moves to i + c_i, candidates c_{i-1} .. c_i - 1 land at i + j; the
    walk stops below the first entry no candidate precedes. Returns the new
    fill."""
    order = np.lexsort((ci, -cv))  # value descending, then index ascending
    sv, si = cv[order], ci[order]
    n = len(sv)

    def count(v, i):  # candidates that precede (v, i), i.e. c
        return _before(sv[:, None], si[:, None], v[None, :], i[None, :]).sum(axis=0)

    hi = min(k, fill + n) - 1
    while hi >= 0:
        lo = max(0, hi - 128 + 1)
        pos = np.arange(lo, hi + 1)
        real = pos < fill
        v = np.where(real, lv[np.minimum(pos, k - 1)], _NEG)
        i = np.where(real, li[np.minimum(pos, k - 1)], 0)
        c = np.where(real, count(v, i), n)
        below = 0 if lo == 0 else (count(lv[lo - 1:lo], li[lo - 1:lo])[0] if lo - 1 < fill else n)
        cp = np.concatenate([[below], c[:-1]])
        new_v, new_i = lv.copy(), li.copy()
        for p, vv, ii, cc, pp, rr in zip(pos, v, i, c, cp, real):
            if rr and cc > 0 and p + cc < k:
                new_v[p + cc], new_i[p + cc] = vv, ii
            for j in range(pp, cc):
                if p + j < k:
                    new_v[p + j], new_i[p + j] = sv[j], si[j]
        lv[:], li[:] = new_v, new_i
        if below == 0:
            break
        hi = lo - 1
    return min(k, fill + n)


def _merge_pair(av, ai, bv, bi, k):
    """`frp::merge_lists_kernel` on one pair: lane l's first output o0 = l E
    and the binary search along the diagonal for how many of the first o0
    outputs come from list a (a wins ties); the outputs, first k of the
    merge."""
    per = -(-k // 32)
    for lane in range(32):
        o0 = min(k, lane * per)
        lo, hi = max(0, o0 - k), min(o0, k)
        while lo < hi:
            mid = (lo + hi) // 2
            b = o0 - 1 - mid
            if not _before(bv[b], bi[b], av[mid], ai[mid]):
                lo = mid + 1
            else:
                hi = mid
        # the split equals the sequential merge's
        a_n = 0
        a, b = 0, 0
        for _ in range(o0):
            if _before(bv[b], bi[b], av[a], ai[a]):
                b += 1
            else:
                a += 1
                a_n += 1
        assert lo == a_n
    out_v, out_i = np.empty(k, np.float32), np.empty(k, np.int64)
    a = b = 0
    for o in range(k):
        if _before(bv[b], bi[b], av[a], ai[a]):
            out_v[o], out_i[o] = bv[b], bi[b]
            b += 1
        else:
            out_v[o], out_i[o] = av[a], ai[a]
            a += 1
    return out_v, out_i


def _device_list_int8_topk(queries, codes, scales, valid, top_k, parts, buf=32):
    """K4 with lists in device memory, in numpy: tiles dealt as the kernel
    deals them (block x, warpgroup w: tiles x + w parts + 2 parts m), in
    tile order, so the two warpgroups of a block share the threshold as
    they do on the card; the threshold filter, buffers of `buf` flushed
    when full and at the end, sentinels behind each list's fill, the merge
    tree over the 2 parts lists, the query scale last."""
    qq, q_scale = gk._quantize_rows(gk.normalize_queries(queries))
    scores = ((qq.float() @ codes.float().T) * scales[None]).numpy()
    g = codes.shape[0]
    n_tiles = -(-g // 64)
    k = top_k
    out_v = np.empty((len(scores), k), np.float32)
    out_i = np.empty((len(scores), k), np.int64)
    for q, row in enumerate(scores):
        lv = np.full((2 * parts, k), _NEG, np.float32)
        li = np.zeros((2 * parts, k), np.int64)
        fill = np.zeros(2 * parts, np.int64)
        bufs = [([], []) for _ in range(2 * parts)]
        thr = np.full(parts, _NEG, np.float32)

        def flush(lst):
            cv, ci = bufs[lst]
            if cv:
                fill[lst] = _flush(lv[lst], li[lst], fill[lst], np.array(cv, np.float32),
                                   np.array(ci, np.int64), k)
                bufs[lst] = ([], [])
                if fill[lst] == k:
                    thr[lst // 2] = max(thr[lst // 2], lv[lst, k - 1])

        for t in range(n_tiles):
            x, w = t % parts, (t // parts) % 2
            lst = 2 * x + w
            bar = thr[x]  # read once per tile, as the fold does
            for r in range(64 * t, min(g, 64 * t + 64)):
                if valid[r] and row[r] >= bar:
                    bufs[lst][0].append(row[r])
                    bufs[lst][1].append(r)
                    if len(bufs[lst][0]) == buf:
                        flush(lst)
        for lst in range(2 * parts):
            flush(lst)
            lv[lst, fill[lst]:], li[lst, fill[lst]:] = _NEG, 0
        s = 1
        while s < 2 * parts:
            for m in range(0, 2 * parts - s, 2 * s):
                lv[m], li[m] = _merge_pair(lv[m], li[m], lv[m + s], li[m + s], k)
            s *= 2
        out_v[q], out_i[q] = lv[0], li[0]
    mv = torch.from_numpy(out_v)
    return gk._fold_query_scale(mv, q_scale), torch.from_numpy(out_i)


def _long_list_case(g=4096 + 32):
    rng = np.random.default_rng(11)
    t = rng.normal(size=(g, 64)).astype(np.float32)
    t /= np.linalg.norm(t, axis=1, keepdims=True)
    for r in (70, 700, 1500, 4000):
        if r < g:
            t[r] = t[5]
    valid = np.ones(g, bool)
    valid[-40:] = False
    queries = rng.normal(size=(5, 64)).astype(np.float32)
    queries[0] = 3.0 * t[5]
    codes, scales = gk.quantize_templates(torch.from_numpy(t))
    return torch.from_numpy(queries), codes, scales, torch.from_numpy(valid)


@pytest.mark.parametrize("parts", [1, 2, 66, 132])
@pytest.mark.parametrize("top_k", [16, 33, 64, 65, 100, 1024])
def test_decomposition_with_long_lists(parts, top_k):
    """The decomposition for list lengths past the register lists: 65 tiles
    dealt to the blocks, 40 invalid rows, duplicate rows. Up to 16 the
    lists of shared memory; from 17 the lists in device memory (buffers,
    flushes, threshold rises, the merge tree)."""
    qq, codes, scales, vv = _long_list_case()
    want_v, want_i = gk.streaming_cosine_topk_int8_plain(qq, codes, scales, vv, top_k, chunk=32)
    if gk.list_placement(top_k)[0] == "device":
        got_v, got_i = _device_list_int8_topk(qq, codes, scales, vv, top_k, parts)
    else:
        got_v, got_i = _decomposed_int8_topk(qq, codes, scales, vv, top_k, parts)
    assert torch.equal(got_v, want_v) and torch.equal(got_i, want_i)
    assert want_i[0, :5].tolist() == [5, 70, 700, 1500, 4000]


@pytest.mark.parametrize("parts", [1, 3, 66])
@pytest.mark.parametrize("buf", [32, 7, 1])
@pytest.mark.parametrize("case", ["few_valid", "ties"])
def test_device_lists_flush_at_any_fill(parts, buf, case):
    """Lists in device memory with buffers flushed at 32, 7 or 1 entries
    (every fill level of the last flush), fewer valid rows than top_k, and
    rows whose scores tie: the plain version's answer to the bit."""
    qq, codes, scales, vv = _long_list_case(2048)
    if case == "few_valid":
        vv = torch.zeros_like(vv)
        vv[torch.arange(3, 2048, 37)] = True  # 56 valid rows, top_k 100
    else:  # many equal scores: one row repeated 150 times
        codes = codes.clone()
        codes[100:250] = codes[5]
        scales = scales.clone()
        scales[100:250] = scales[5]
    want_v, want_i = gk.streaming_cosine_topk_int8_plain(qq, codes, scales, vv, 100, chunk=32)
    got_v, got_i = _device_list_int8_topk(qq, codes, scales, vv, 100, parts, buf)
    assert torch.equal(got_v, want_v) and torch.equal(got_i, want_i)
    if case == "few_valid":
        assert (want_i[:, 56:] == 0).all() and (want_v[:, 56:] == _NEG).all()


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
        "frp_gallery_topk_kmax": gk.MAX_TOP_K, "frp_gallery_topk_int8_kmax": gk.MAX_TOP_K,
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
