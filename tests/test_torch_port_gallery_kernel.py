"""The streaming kernels' launch arithmetic and decomposition, on the CPU.

K3 and K4 (`csrc/gallery_topk.cuh`) run only on a card. What surrounds them
is Python and is held here: `gallery_launch_geometry` (grid, ring depth,
shared-memory bytes, scratch shapes, what is refused), and the way the
kernels cut the work: gallery tiles of 64 rows dealt to P blocks in turn, a
sorted top-8 list with sentinels per block, and a merge under (value
descending, index ascending). The decomposition is written out in plain
PyTorch below and must equal `streaming_cosine_topk_int8_plain` bit for bit.
"""

import math

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
    device memory and on the pool route, their buffers of 32, counts and
    fills), the thresholds."""
    qpanel = {"bf16": 128 * 128, "int8": 128 * 128, "f32": 64 * 128}[kind]
    per_query = 32 * 8 + 8 if geo.lists in ("device", "pool") else geo.list_len * 8
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
        # the pool route's grid is that of a block of its queries
        rows_q = geo.block if geo.lists == "pool" else q
        assert (q_tiles - 1) * geo.q_tile < rows_q <= q_tiles * geo.q_tile
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
        # warpgroup; the pool route: a block's unresolved queries' lists on a
        # quarter of the blocks) of every real query
        if geo.lists == "device":
            assert geo.scratch == (q, 2 * grid_x, top_k) and geo.buffer == 32
        elif geo.lists == "pool":
            assert 1 <= geo.block <= q and geo.buffer == 32
            assert geo.unresolved_grid == max(1, grid_x // 4)
            assert geo.scratch == (geo.block, 2 * geo.unresolved_grid, top_k)
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
    from 17 on in device memory, from POOL_MIN_K (64) on the pool route
    with the device lists' layout; at D = 512 the ring keeps at least
    _MIN_STAGES stages either way."""
    geo = gallery_launch_geometry(128, 1 << 20, 512, kind, _SMS, top_k)
    if top_k <= 16:
        assert (geo.lists, geo.list_len) == ("shared", 16)
        assert geo.scratch == (128, geo.grid[0], 16)
    elif top_k < gk.POOL_MIN_K:
        assert (geo.lists, geo.list_len) == ("device", top_k)
        assert geo.scratch == (128, 2 * geo.grid[0], top_k)
    else:
        assert (geo.lists, geo.list_len) == ("pool", top_k)
        assert geo.scratch == (128, 2 * geo.unresolved_grid, top_k)
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
    """top_k past 64 to MAX_TOP_K on the device lists (the default from 17
    to POOL_MIN_K - 1, and the pool route's unresolved queries): one sorted
    list per query, block and warpgroup in device memory, a buffer of 32
    candidates per query in shared memory, a ring of at least _MIN_STAGES;
    the merge kernel gets a block per query and as many warps as a pair of
    lists each fits."""
    geo = gallery_launch_geometry(128, 1 << 20, 512, kind, _SMS, top_k, "device")
    grid_x = geo.grid[0]
    assert (geo.lists, geo.list_len, geo.buffer) == ("device", top_k, 32)
    assert geo.scratch == (128, 2 * grid_x, top_k)
    assert gk._MIN_STAGES <= geo.stages <= gk._MAX_STAGES
    assert geo.smem_bytes == _want_smem(geo, kind) <= cuda_build.SMEM_LIMIT_BYTES
    warps = min(32, cuda_build.SMEM_LIMIT_BYTES // (16 * top_k))
    assert geo.merge == (128, 32 * warps, warps * 16 * top_k)
    assert geo.merge[2] <= cuda_build.SMEM_LIMIT_BYTES and geo.merge[1] <= 1024
    # the scratch at the limit: Q x 2 grid_x x k x 8 bytes
    top = gallery_launch_geometry(128, 1 << 20, 512, kind, _SMS, gk.MAX_TOP_K, "device")
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
    """top_k 1025 to MAX_TOP_K on the device lists (the pool route's
    unresolved queries take them): the stream kernel's shared memory as at
    any device-list top_k (it does not depend on k), the merge with 1-32
    warps whose pairs of lists fit shared memory; at the labeler's query
    counts every offset of the scratch fits the kernels' 64-bit indices and
    every gallery index their int32 ones."""
    base = gallery_launch_geometry(128, 1 << 20, 512, kind, _SMS, 65)
    for q in (1, 128, 4096, 100_000):
        geo = gallery_launch_geometry(q, 1 << 20, 512, kind, _SMS, top_k, "device")
        assert (geo.lists, geo.list_len) == ("device", top_k)
        if q == 128:
            assert (geo.smem_bytes, geo.stages) == (base.smem_bytes, base.stages)
        blocks, threads, smem = geo.merge
        assert blocks == q and 1 <= threads // 32 <= 32 and threads % 32 == 0
        assert smem == (threads // 32) * 16 * top_k <= cuda_build.SMEM_LIMIT_BYTES
        assert int(np.prod(geo.scratch)) < 2**63 and (1 << 20) < 2**31 - 64
    assert gallery_launch_geometry(4, 4096, 512, kind, _SMS, gk.MAX_TOP_K,
                                   "device").merge[1] == 32


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
        # the pool route launches blocks of its queries: the grid is a block's
        q_tiles = -(-(geo.block if geo.lists == "pool" else q) // 64)
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
    out = [_device_lists_row(row, valid, top_k, parts, buf) for row in scores]
    mv = torch.from_numpy(np.stack([v for v, _ in out]))
    return gk._fold_query_scale(mv, q_scale), torch.from_numpy(np.stack([i for _, i in out]))


def _device_lists_row(row, valid, k, parts, buf=32, seed=_NEG):
    """One query's device lists in numpy (scores `row` [G]): the thresholds
    of the `parts` blocks start at `seed` (-1e9, or the pool route's
    starting threshold for an unresolved query); returns its k best."""
    g = len(row)
    n_tiles = -(-g // 64)
    lv = np.full((2 * parts, k), _NEG, np.float32)
    li = np.zeros((2 * parts, k), np.int64)
    fill = np.zeros(2 * parts, np.int64)
    bufs = [([], []) for _ in range(2 * parts)]
    thr = np.full(parts, seed, np.float32)

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
    return lv[0], li[0]


def _pool_route_model(scores, valid, geo, rng, force=False):
    """The pool route's four stages (`csrc/gallery_topk.cuh`) in numpy, on a
    score matrix [Q, G] (the kernels' scores before the query scale), with
    the sample, rank, capacity and unresolved route of `geo`. 1: the sample
    walks tiles lt * n_tiles // walk, -inf for invalid rows and rows past
    G; T_q its rank-th best (-inf if it holds fewer). 2: the gather appends
    every valid row at or above T_q, in an order `rng` shuffles (the order
    blocks append in), keeping the first `pool_cap`; the cursor counts them
    all. 3: resolved (n <= cap, and n >= k or T_q = -inf): the k best of the
    pool by (value descending, index ascending), sentinels behind. 4: else
    the device lists from the starting threshold the select leaves (T_q
    where n >= k, else -1e9) on `unresolved_grid` blocks. Returns (values,
    indices, unresolved query rows)."""
    q, g = scores.shape
    k, cap = geo.list_len, geo.pool_cap
    n_tiles = -(-g // 64)
    walk = geo.sample_tiles
    rows = np.concatenate([np.arange(64 * (lt * n_tiles // walk), 64 * (lt * n_tiles // walk) + 64)
                           for lt in range(walk)])
    inside = rows < g
    rows = np.minimum(rows, g - 1)
    sample = np.where(inside & valid[rows], scores[:, rows], -np.inf)
    ranked = -np.sort(-sample, axis=1)
    thr = (ranked[:, geo.sample_rank - 1] if geo.sample_rank <= sample.shape[1]
           else np.full(q, -np.inf)).astype(np.float32)
    out_v = np.full((q, k), _NEG, np.float32)
    out_i = np.zeros((q, k), np.int64)
    unresolved = []
    for r in range(q):
        cand = np.nonzero(valid & (scores[r] >= thr[r]))[0]
        n = len(cand)
        pool = cand[rng.permutation(n)][:cap]
        if force or n > cap or (n < k and thr[r] != -np.inf):
            unresolved.append(r)
            seed = thr[r] if n >= k else _NEG
            out_v[r], out_i[r] = _device_lists_row(scores[r], valid, k, geo.unresolved_grid,
                                                   seed=seed)
            continue
        order = np.lexsort((pool, -scores[r, pool]))[:k]
        out_v[r, :len(order)], out_i[r, :len(order)] = scores[r, pool[order]], pool[order]
    return out_v, out_i, unresolved


def _exact_topk(scores, valid, k):
    """The k best of each row of `scores` among valid rows by (value
    descending, index ascending), sentinels (-1e9, 0) behind."""
    q, g = scores.shape
    out_v = np.full((q, k), _NEG, np.float32)
    out_i = np.zeros((q, k), np.int64)
    idx = np.nonzero(valid)[0]
    for r in range(q):
        order = np.lexsort((idx, -scores[r, idx]))[:k]
        out_v[r, :len(order)], out_i[r, :len(order)] = scores[r, idx[order]], idx[order]
    return out_v, out_i


def pool_case(case, g=4096 + 32, d=64, nq=5, seed=3):
    """Queries [nq, d], unit rows [g, d] and valid [g] for one adversarial
    or ordinary case of the pool route; query 0 is a multiple of row 5.
    "random": a ragged last tile and 40 invalid rows; "invalid": only every
    third row valid; "few_valid": 30 valid rows (fewer than top_k);
    "ties": 300 copies of row 5 (ties at the k-th value and past the pool);
    "sorted_desc" / "sorted_asc": rows sorted by their score against query
    0; "all_equal": every row the same."""
    rng = np.random.default_rng(seed)
    t = rng.normal(size=(g, d)).astype(np.float32)
    t /= np.linalg.norm(t, axis=1, keepdims=True)
    valid = np.ones(g, bool)
    queries = rng.normal(size=(nq, d)).astype(np.float32)
    if case == "random":
        valid[-40:] = False
    elif case == "invalid":
        valid[:] = False
        valid[::3] = True
    elif case == "few_valid":
        valid[:] = False
        valid[rng.choice(g, 30, replace=False)] = True
    elif case == "ties":
        t[100:400] = t[5]
    elif case in ("sorted_desc", "sorted_asc"):
        order = np.argsort(-(t @ queries[0]), kind="stable")
        t = t[order if case == "sorted_desc" else order[::-1]].copy()
    elif case == "all_equal":
        t[:] = t[5]
    if case not in ("sorted_desc", "sorted_asc"):
        queries[0] = 3.0 * t[5]
    return queries, t, valid


#: the cases whose answer the sample's threshold cannot give for query 0,
#: which must take the unresolved route
POOL_UNRESOLVED_CASES = ("ties", "sorted_desc", "sorted_asc", "all_equal")
POOL_CASES = ("random", "invalid", "few_valid") + POOL_UNRESOLVED_CASES


def pool_scores(kind, queries, t, chunk=64):
    """The scores the kernels of `kind` compute (before K4's query scale),
    as the plain versions compute them, and K4's query scales."""
    qt, tt = torch.from_numpy(queries), torch.from_numpy(t)
    if kind == "int8":
        codes, scales = gk.quantize_templates(tt)
        qq, q_scale = gk._quantize_rows(gk.normalize_queries(qt))
        return ((qq.float() @ codes.float().T) * scales[None]).numpy(), q_scale
    qn = gk.normalize_queries(qt)
    if kind == "bf16":
        hi, lo = gk._split_bf16(qn)
        rows = tt.to(torch.bfloat16).float()
        parts = [hi @ rows[c:c + chunk].T + lo @ rows[c:c + chunk].T
                 for c in range(0, len(t), chunk)]
    else:
        parts = [qn @ tt[c:c + chunk].T for c in range(0, len(t), chunk)]
    return torch.cat(parts, dim=1).numpy(), None


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
    flushes, threshold rises, the merge tree), which past POOL_MIN_K the
    pool route's unresolved queries take."""
    qq, codes, scales, vv = _long_list_case()
    want_v, want_i = gk.streaming_cosine_topk_int8_plain(qq, codes, scales, vv, top_k, chunk=32)
    if top_k > 16:
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


# ------------------------------------------------------------ the pool route


@pytest.mark.parametrize("kind", ["bf16", "int8", "f32"])
@pytest.mark.parametrize("case", POOL_CASES)
def test_pool_route_model(kind, case):
    """The pool route's four stages with the crossover forced down (top_k
    40 on 4128 rows: a sample of 16 tiles, T_q the 19th best of it, pools of
    160): the exact top-k of the kernels' scores bit for bit, whatever order
    the pool fills in and with every query sent on to the device lists; the
    plain version's answer (K4 to the bit, K3 within K3's tolerances). The
    adversarial cases drive query 0 through the unresolved route; the
    others resolve every query from its pool."""
    queries, t, valid = pool_case(case)
    k = 40
    geo = gallery_launch_geometry(len(queries), len(t), t.shape[1], kind, _SMS, k, "pool")
    assert (geo.lists, geo.sample_tiles, geo.sample_rank, geo.pool_cap) == ("pool", 16, 19, 160)
    scores, q_scale = pool_scores(kind, queries, t)
    got_v, got_i, unresolved = _pool_route_model(scores, valid, geo, np.random.default_rng(1))
    want_v, want_i = _exact_topk(scores, valid, k)
    assert np.array_equal(got_v, want_v) and np.array_equal(got_i, want_i)
    for rng, force in ((np.random.default_rng(2), False), (np.random.default_rng(3), True)):
        v, i, sent = _pool_route_model(scores, valid, geo, rng, force)
        assert np.array_equal(v, want_v) and np.array_equal(i, want_i)
        assert sent == (list(range(len(queries))) if force else unresolved)
    if case in POOL_UNRESOLVED_CASES:
        assert 0 in unresolved
    else:
        assert unresolved == []
    tq, tt, tv = torch.from_numpy(queries), torch.from_numpy(t), torch.from_numpy(valid)
    if kind == "int8":
        codes, scales = gk.quantize_templates(tt)
        pv, pi = gk.streaming_cosine_topk_int8_plain(tq, codes, scales, tv, k, chunk=32)
        got = gk._fold_query_scale(torch.from_numpy(got_v), q_scale)
        assert torch.equal(got, pv) and torch.equal(torch.from_numpy(got_i), pi)
    else:
        rows = tt.to(torch.bfloat16) if kind == "bf16" else tt
        pv, pi = gk.streaming_cosine_topk_plain(tq, rows, tv, k + 1, chunk=32)
        tol = 2e-5 if kind == "bf16" else 1e-5
        assert float(np.abs(got_v - pv[:, :k].numpy()).max()) <= tol
        gap = np.abs(np.diff(pv.numpy(), axis=1)) > 2 * tol
        clear = np.ones((len(queries), k), bool)
        clear[:, :-1] &= gap[:, :k - 1]
        clear[:, 1:] &= gap[:, :k - 1]
        clear[:, -1] &= gap[:, k - 1]
        assert np.array_equal(got_i[clear], pi[:, :k].numpy()[clear])
    n_valid = int(valid.sum())
    if n_valid < k:
        assert (got_v[:, n_valid:] == _NEG).all() and (got_i[:, n_valid:] == 0).all()


@pytest.mark.parametrize("kind", ["bf16", "int8", "f32"])
@pytest.mark.parametrize("top_k", [256, 1024, gk.MAX_TOP_K])
def test_pool_route_geometry(kind, top_k):
    """128 x 1 048 576 x 512 from POOL_MIN_K: the pool route with the device
    lists' stream launch (grid, ring, shared memory) on one block of all 128
    queries; a sample of whole tiles that expects 64 rows above the k-th
    score, T_q at rank 128; pools of 4 top_k; the select a block of 1024
    threads per query sorting a power of two >= top_k; the unresolved
    queries' lists on a quarter of the blocks; and what it all allocates,
    which at MAX_TOP_K is under 30% of the device-list route's."""
    geo = gallery_launch_geometry(128, 1 << 20, 512, kind, _SMS, top_k)
    dev = gallery_launch_geometry(128, 1 << 20, 512, kind, _SMS, top_k, "device")
    assert geo.lists == "pool" and dev.lists == "device" and geo.block == 128
    assert (geo.grid, geo.stages, geo.smem_bytes) == (dev.grid, dev.stages, dev.smem_bytes)
    grid_x = geo.grid[0]
    assert grid_x == {"bf16": 66, "f32": 66, "int8": 132}[kind]
    tiles = {256: 4096, 1024: 1024, gk.MAX_TOP_K: 73}[top_k]
    assert (geo.sample_tiles, geo.sample_rank, geo.pool_cap) == (tiles, 128, 4 * top_k)
    sort_n = {256: 256, 1024: 1024, gk.MAX_TOP_K: 16384}[top_k]
    assert geo.select == (128, 1024, 8 * sort_n) and 8 * sort_n <= cuda_build.SMEM_LIMIT_BYTES
    assert geo.unresolved_grid == grid_x // 4
    assert geo.scratch == (128, 2 * (grid_x // 4), top_k)  # 2 warpgroups a block
    assert geo.merge == gk.merge_launch(128, grid_x // 4, top_k, "device")
    want = (4 * 128 * 64 * tiles + 12 * 128 + 8 * 128 * 4 * top_k
            + 8 * 128 * 2 * (grid_x // 4) * top_k)
    assert geo.scratch_bytes == want
    assert dev.scratch_bytes == 8 * 128 * 2 * grid_x * top_k
    if top_k == gk.MAX_TOP_K:
        assert geo.scratch_bytes < 0.3 * dev.scratch_bytes
        assert dev.scratch_bytes == {"bf16": 1_963_720_704, "f32": 1_963_720_704,
                                     "int8": 3_927_441_408}[kind]


@pytest.mark.parametrize("kind", ["bf16", "int8", "f32"])
@pytest.mark.parametrize("top_k", [1024, gk.MAX_TOP_K])
@pytest.mark.parametrize("q", [128, 4096, 50_000])
def test_pool_route_scratch_within_the_device_lists(kind, top_k, q):
    """At the labeler's query counts against 1 048 576 rows, from top_k
    1024: the pool route takes every query count, in blocks whose scratch
    is no more than the device-list route's for the whole call (the sample
    not over its 256 MiB), and those blocks cover every query."""
    g = 1 << 20
    geo = gallery_launch_geometry(q, g, 512, kind, _SMS, top_k)
    dev = gallery_launch_geometry(q, g, 512, kind, _SMS, top_k, "device")
    assert geo.lists == "pool"
    assert geo.scratch_bytes <= dev.scratch_bytes
    assert 4 * geo.block * 64 * geo.sample_tiles <= gk._SAMPLE_BUDGET
    assert min(q, gk._POOL_FLOOR) <= geo.block <= q
    assert geo.block == q or geo.block % geo.q_tile == 0
    blocks = -(-q // geo.block)
    assert (blocks - 1) * geo.block < q <= blocks * geo.block
    # the scratch is one block's: the sample, T_q, thresholds and cursors,
    # the pools, the unresolved queries' lists
    assert geo.scratch_bytes == (4 * geo.block * 64 * geo.sample_tiles + 12 * geo.block
                                 + 8 * geo.block * geo.pool_cap + 8 * math.prod(geo.scratch))
    assert geo.scratch[0] == geo.select[0] == geo.merge[0] == geo.block


@pytest.mark.parametrize("kind", ["bf16", "int8", "f32"])
@pytest.mark.parametrize("top_k", [64, 256])
def test_pool_blocks_at_short_lists(kind, top_k):
    """At top_k 64 and 256 the sample takes a quarter of a 1 048 576-row
    gallery (1 MiB of scores a query), so the device lists' few bytes
    cannot bound a block: blocks of min(Q, 256) queries, whose sampled
    scores fill the 256 MiB budget and no more; the last block's gather
    takes the grid of its own count."""
    g = 1 << 20
    for q in (1, 128, 256, 1000, 4096):
        geo = gallery_launch_geometry(q, g, 512, kind, _SMS, top_k, "pool")
        assert geo.lists == "pool" and geo.sample_tiles == 4096
        assert geo.block == min(q, 256)
        assert 4 * geo.block * 64 * geo.sample_tiles <= gk._SAMPLE_BUDGET
    q_tile = {"bf16": 64, "f32": 64, "int8": 128}[kind]
    assert gk.grid_x(1000 - 3 * 256, q_tile, g // 64, _SMS) == _SMS // -(-232 // q_tile)
    # a gallery 16 times larger: blocks cut to what the budget holds
    big = gallery_launch_geometry(4096, 16 << 20, 512, kind, _SMS, top_k, "pool")
    assert big.block == gk._SAMPLE_BUDGET // (4 * 64 * big.sample_tiles) < 256


def test_pool_blocks_fill_the_card():
    """Where the scratch bound cuts a call into blocks, a block's gather
    launch fills at least 90% of its last wave of SMs: 4224 queries (66
    query tiles of 2 blocks), not 5312 (83 tiles of one block, 63%)."""
    geo = gallery_launch_geometry(16384, 1 << 20, 512, "bf16", _SMS, gk.MAX_TOP_K)
    assert geo.block == 4224 and geo.grid == (2, 66)
    assert geo.scratch_bytes <= gallery_launch_geometry(
        16384, 1 << 20, 512, "bf16", _SMS, gk.MAX_TOP_K, "device").scratch_bytes


def test_pool_route_crossover_and_its_sample():
    """The pool route from POOL_MIN_K (the device lists below it) where it
    pays; the sample sized by the gallery and top_k alone, capped at a
    quarter of the tiles."""
    assert gk.list_placement(gk.POOL_MIN_K - 1) == ("device", gk.POOL_MIN_K - 1)
    assert gk.list_placement(gk.POOL_MIN_K) == ("pool", gk.POOL_MIN_K)
    g = 1 << 20
    assert gk.pool_sample(g, 128) == (4096, 64, 32.0)  # a quarter of the tiles
    assert gk.pool_sample(g, 256) == (4096, 128, 64.0)
    assert gk.pool_sample(g, 4096) == (256, 128, 64.0)
    for q in (1, 128, 8192, 100_000):
        for k in (1024, 4096, gk.MAX_TOP_K):  # the pool route at any query count
            for kind in ("bf16", "int8", "f32"):
                assert gallery_launch_geometry(q, g, 512, kind, _SMS, k).lists == "pool"
        assert gallery_launch_geometry(q, g, 512, "int8", _SMS, gk.POOL_MIN_K - 1).lists == "device"
    # a gallery smaller than top_k: one tile, a rank past it (T_q = -inf)
    assert gk.pool_sample(100, 256) == (1, 128, 163.84)


# (kind, Q, top_k) -> the route that was the faster on an H100 against
# 1 048 576 rows, both forced in one run (chip_smoke.py phase 2, PERF.md):
# the device lists where a query has few lists (large Q) and top_k is small
_MEASURED_FASTER = {
    ("bf16", 128, 64): "pool", ("bf16", 128, 256): "pool", ("bf16", 1024, 64): "device",
    ("bf16", 4096, 64): "device", ("bf16", 16384, 64): "device",
    ("bf16", 1024, 256): "pool", ("bf16", 4096, 256): "pool", ("bf16", 16384, 256): "device",
    ("f32", 128, 64): "pool", ("f32", 128, 256): "pool", ("f32", 1024, 64): "device",
    ("f32", 4096, 64): "device", ("f32", 16384, 64): "device",
    ("f32", 1024, 256): "pool", ("f32", 4096, 256): "device", ("f32", 16384, 256): "device",
    ("int8", 128, 64): "pool", ("int8", 128, 256): "pool", ("int8", 1024, 64): "pool",
    ("int8", 4096, 64): "pool", ("int8", 16384, 64): "device",
    ("int8", 1024, 256): "pool", ("int8", 4096, 256): "pool", ("int8", 16384, 256): "pool",
}


@pytest.mark.parametrize("point", sorted(_MEASURED_FASTER))
def test_pool_pays_where_it_was_measured_faster(point):
    """`pool_pays` takes the route that was measured the faster at each
    point of the labeler sweep (and the pool route at top_k 1024 at every
    query count); the pool route needs a query's lists x top_k^2 to reach
    the kind's threshold, scaled by the gallery's rows."""
    kind, q, k = point
    g = 1 << 20
    geo = gallery_launch_geometry(q, g, 512, kind, _SMS, k)
    assert geo.lists == _MEASURED_FASTER[point]
    assert gk.pool_pays(q, g, k, kind, _SMS) == (geo.lists == "pool")
    assert gallery_launch_geometry(q, g, 512, kind, _SMS, 1024).lists == "pool"
    lists = 2 * geo.grid[0] if geo.lists == "device" else 2 * gk.grid_x(
        q, geo.q_tile, geo.n_tiles, _SMS)
    assert (lists * k * k >= gk._POOL_MIN_WORK[kind]) == (geo.lists == "pool")
    # a gallery 16 times smaller: the sample a sixteenth, the pool route
    assert gk.pool_pays(q, g // 16, k, kind, _SMS) or lists * k * k * 16 < gk._POOL_MIN_WORK[kind]


@pytest.mark.parametrize("route", ["device", "pool", "pool_unresolved"])
def test_routes_are_asked_for_past_16_only(route):
    """A forced route (`_card_search`'s, for scripts and tests) names how
    the card answers top_k past 16; the public wrappers take none."""
    gk._check_route(route, 17)
    gk._check_route(route, gk.MAX_TOP_K)
    with pytest.raises(ValueError, match="past 16"):
        gk._check_route(route, 16)
    if route != "pool_unresolved":
        with pytest.raises(ValueError, match="on chip"):
            gallery_launch_geometry(4, 4096, 512, "bf16", _SMS, 16, route)
    with pytest.raises(ValueError, match="route must be one of"):
        gk._check_route("lists", 20)
    t = torch.nn.functional.normalize(torch.randn(256, 32), dim=1)
    q, v = torch.randn(3, 32), torch.ones(256, dtype=torch.bool)
    with pytest.raises(TypeError):
        gk.streaming_cosine_topk(q, t, v, 20, chunk=64, route=route)
    codes, scales = gk.quantize_templates(t)
    with pytest.raises(TypeError):
        gk.streaming_cosine_topk_int8(q, codes, scales, v, 20, chunk=64, route=route)


def test_unresolved_count_is_made_outside_a_capture(monkeypatch):
    """A card's unresolved count is made by its first pool-route call; in a
    CUDA graph capture its zero-fill would be recorded and every replay
    would reset the count, so making it there raises. Once made, a capture
    takes it as it is."""
    dev = torch.device("cpu")  # a key no card uses: the slot logic alone
    try:
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
        with pytest.raises(RuntimeError, match="outside a CUDA graph capture"):
            gk._unresolved_slot(dev)
        assert dev not in gk.UNRESOLVED
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
        slot = gk._unresolved_slot(dev)
        assert slot.dtype == torch.int64 and slot.tolist() == [0]
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
        assert gk._unresolved_slot(dev) is slot
    finally:
        gk.UNRESOLVED.pop(dev, None)


def _order_keys(x):
    """`frp::order_key` in numpy: uint32 keys in the floats' order (-0 as +0)."""
    u = np.where(x == 0, np.float32(0), x).astype(np.float32).view(np.uint32)
    return np.where(u >> 31 == 1, ~u, u | np.uint32(0x80000000)).astype(np.uint32)


def _threshold_model(row, rank, threads=1024, cands=4096):
    """`frp::sample_threshold_kernel` in numpy: thread i's largest key over
    the 4-key chunks i, i + threads, ... (0 for a thread with none), L the
    rank-th largest of
    those, the keys at or above L sorted if no more than `cands` of them,
    else the radix select over the whole row. Returns (the rank-th largest
    key, which path answered)."""
    keys = _order_keys(row)
    if rank > len(keys):
        return _order_keys(np.float32([-np.inf]))[0], "none"
    best = np.zeros(threads, np.uint32)
    chunks = keys.reshape(-1, 4)
    for i in range(min(threads, len(chunks))):
        best[i] = chunks[i::threads].max()
    low = np.sort(best)[::-1][rank - 1]
    cand = keys[keys >= low]
    assert len(cand) >= rank
    if len(cand) <= cands:
        return np.sort(cand)[::-1][rank - 1], "sorted"
    return np.sort(keys)[::-1][rank - 1], "radix"


@pytest.mark.parametrize("case,path", [("random", "sorted"), ("sorted", "sorted"),
                                       ("ties", "radix"), ("few_valid", "radix"),
                                       ("short", "sorted"), ("past_the_row", "none")])
def test_sample_threshold_prefilter(case, path):
    """T_q's select: the largest key of each of 1024 threads bounds the
    rank-th best from below, and on a random sample only about rank keys
    reach it, so they are sorted in shared memory; ties and a sample of
    mostly invalid rows take the radix select. Either way the rank-th
    largest of the row, -inf where fewer than rank rows are valid."""
    rng = np.random.default_rng(5)
    rank = 128
    row = rng.normal(size=65536).astype(np.float32)
    if case == "sorted":
        row = np.sort(row)[::-1].copy()
    elif case == "ties":
        row[:5000] = row.max()
    elif case == "few_valid":
        row[50:] = -np.inf
    elif case == "short":  # fewer 4-key chunks than threads
        row = row[:300]
    elif case == "past_the_row":
        row = row[:100]
    key, took = _threshold_model(row, rank)
    assert took == path
    want = np.sort(row)[::-1][rank - 1] if rank <= len(row) else -np.inf
    assert key == _order_keys(np.float32([want]))[0]
    if case == "random":
        best = [row.reshape(-1, 4)[i::1024].max() for i in range(1024)]
        assert (row >= np.sort(best)[::-1][rank - 1]).sum() < 2 * rank
