"""Streaming gallery search: kernels K3 (bf16) and K4 (int8) and their plain
versions.

Counterpart of `facerecognitionpipeline_tpu/ops/pallas_gallery.py`, with the
same public names. Replaces its two `pl.pallas_call`s:
`_streaming_cosine_topk` (K3: `csrc/gallery_topk.cu` on bf16 rows,
`csrc/gallery_topk_f32.cu` on float32 rows) and `_streaming_cosine_topk_int8`
(K4, `csrc/gallery_topk_int8.cu`). All three
compute the cosine top-k of a few queries against a gallery of 10^5-10^6
rows without ever storing the [Q, G] similarity matrix. The bf16 and int8
kernels are bound by device-memory bytes (one read of the gallery; the int8
pair halves those bytes), the float32 one by float32 operations. What the
design does about it on an H100 (`csrc/gallery_topk.cuh` has the whole of
it, the three kinds share one body): one persistent block per SM keeps
its queries in shared memory, one producer warp streams the gallery
through two rings of 8 KB stages with TMA copies that complete on
`mbarrier`s, two consumer warpgroups multiply (bf16 and int8 with `wgmma`,
query block as A and 64 gallery rows as B; float32 rows with float32 FMAs
on the CUDA cores, a tensor-core product would round them) and fold the
scores in registers into per-query top-k lists, and a second kernel merges
the lists. A list of 1 to 8 entries lives in registers, of 16 in shared
memory, and of 17 to POOL_MIN_K - 1 in device memory, fed through a buffer
of 32 candidates per query and merged into by a whole warp at once. From
POOL_MIN_K to MAX_TOP_K the call takes the pool route, at any query count
(in blocks of queries whose scratch stays within the device lists'): a
sample pass and a select give each query a threshold T_q valid across the
whole gallery,
the gather pass appends what reaches it to a per-query pool in device
memory, one select per query takes the k best of the pool, and a query
whose pool could not hold the answer (rare on real galleries, certain on
adversarial ones) takes the device lists, all decided on the device
(`csrc/gallery_topk.cuh` says how; `UNRESOLVED` counts those queries). The
launch arithmetic (grid, ring depth, shared-memory bytes, list placement,
the pool route's sample, rank, pool and query blocks, scratch shapes, the
merge's and the select's launches) is `gallery_launch_geometry`, where the CPU tests
reach it. The tensor map of
the gallery is encoded in the C function at each launch, through the
entry point of `cuTensorMapEncodeTiled` that the CUDA runtime hands out (no
link against libcuda).

Semantics, shared by kernels, plain versions and the JAX functions:

* queries are L2-normalised here (`q / (|q| + 1e-8)`), outside the kernel;
* rows with `valid == False` score exactly -1e9 and never displace a valid
  row; the running list starts as `top_k` sentinels (-1e9, index 0), so
  with fewer valid rows than `top_k` the surplus slots hold (-1e9, 0) -- not
  the masked rows' own indices that the dense `cosine_topk` returns there;
* ties go to the lower gallery index;
* indices come back int64, as from the port's dense `cosine_topk` (the
  merge kernel writes them so).

Rounding points. K3 and `streaming_cosine_topk_plain` on bf16 rows: the
float32 unit query is split into hi = bf16(q) and lo = bf16(q - hi), and
score = sum_d (hi_d + lo_d) * t_d in float32 with exact products. That is
the float32 query's score to ~1e-6, so crossing into the streaming path
does not shift scores by a bf16 rounding of the query (~2e-3). On float32
rows the kernel and the plain version multiply in float32 without a split,
as the JAX function does (sums in another order: ~1e-7 apart). K4 and
`streaming_cosine_topk_int8_plain`: the query is quantised per row here (as
the JAX wrapper does), the integer dot is exact, score = float32(dot) * row_scale rounds once, and the query scale
multiplies the finished scores (the -1e9 sentinel kept exact; on the card
the merge kernel does it); kernel and plain version agree to the bit.

Each wrapper launches its kernel for CUDA tensors (and counts the launch;
the small merge kernel that follows in the same call is not counted
separately; a call on the pool route counts once more in its kind's
`POOL_LAUNCHES` counter), takes the plain version for CPU tensors only, and
raises on anything else. Nothing falls back: the pool route's unresolved
queries are a second route on the card, of the same function.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from facerecognitionpipeline_tpu_torch.ops import cuda_build
from facerecognitionpipeline_tpu_torch.ops.nms import top_k as stable_top_k
from facerecognitionpipeline_tpu_torch.ops.numerics import div

#: launches of K3 on bf16 rows, of K4 (int8) and of K3 on float32 rows
LAUNCHES = cuda_build.LaunchCounter()
LAUNCHES_INT8 = cuda_build.LaunchCounter()
LAUNCHES_F32 = cuda_build.LaunchCounter()
#: calls of the three kinds that took the pool route (their six launches)
POOL_LAUNCHES = {kind: cuda_build.LaunchCounter() for kind in ("bf16", "int8", "f32")}

#: longest top-k the CUDA kernels answer (`frp::KMAX` in csrc/gallery_topk.cuh):
#: the merge of lists in device memory holds a pair of lists of top_k
#: (16 top_k bytes) in one warp's shared memory, rounded down to whole
#: 32-entry lane chunks (14 528 on an H100)
MAX_TOP_K = cuda_build.SMEM_LIMIT_BYTES // 16 // 32 * 32

#: the first top_k that takes the pool route: the crossover with the device
#: lists, measured on an H100 (PERF.md); this module alone holds the pool
#: route's rule and passes it to the kernels as launch arguments
POOL_MIN_K = 64
_POOL_CAP = 4  # pool entries per query: _POOL_CAP * top_k
#: the sample is sized so that this many sampled rows are expected above
#: the k-th score, and T_q is the sample's (2 x this)-th best
_SAMPLE_ABOVE = 64
_SAMPLE_SHARE = 4  # the sample walks at most 1 / _SAMPLE_SHARE of the tiles
#: the queries of one call go through the pool route in blocks: a block's
#: sampled scores take at most _SAMPLE_BUDGET bytes, and its scratch at
#: most the device lists' for the whole call unless that would cut blocks
#: below _POOL_FLOOR queries (a gather pass of fewer re-reads the gallery
#: for too few queries to hide it)
_SAMPLE_BUDGET = 256 * 2**20
_POOL_FLOOR = 256
#: where the pool route pays (`pool_pays`): the device lists' merges cost
#: about (lists a query: 2 grid_x, fewer as Q grows) x top_k^2 a query,
#: the pool route's sample a share of the gallery a query (a quarter at
#: top_k <= 256); at 1 048 576 rows the pool route was the faster where
#: lists x top_k^2 reaches this, per kind (an H100 at Q = 128-16 384 and
#: top_k 64-1024, PERF.md); other gallery sizes scale it by G / 2^20 (the
#: sample's share, a model)
_POOL_MIN_WORK = {"int8": 1 << 15, "bf16": 3 << 16, "f32": 3 << 17}
_SELECT_THREADS = 1024  # a select block (`frp::SELECT_THREADS`)

_EPS = 1e-8
_NEG = -1e9
_CHUNK_MSG = "pad the gallery to a multiple of the chunk size"
_ROUTES = (None, "device", "pool", "pool_unresolved")


def normalize_queries(queries: torch.Tensor) -> torch.Tensor:
    """[Q, D] -> float32 rows q / (|q| + 1e-8), as every search normalises."""
    q = queries.float()
    return q / (torch.linalg.vector_norm(q, dim=1, keepdim=True) + _EPS)


def _quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[N, D] float32 -> (int8 codes [N, D], scales [N, 1]): scale =
    max|row| / 127 (1 for a zero row), codes = round-half-even(x / scale)
    clipped to +-127. Both divisions are correctly rounded."""
    amax = x.abs().amax(dim=1, keepdim=True)
    scale = torch.where(amax > 0, div(amax, 127.0), torch.ones_like(amax))
    codes = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return codes, scale


def quantize_templates(templates) -> tuple[torch.Tensor, torch.Tensor]:
    """[G, D] float templates -> (int8 codes [G, D], float32 scales [G]).

    Symmetric per-row quantisation: row j stores round(t_j / s_j) with
    s_j = max|t_j| / 127, so its dequantised similarity is (q . codes_j) *
    s_j. Zero rows (gallery padding) get scale 1 and all-zero codes. Gives
    the JAX function's codes and scales bit for bit."""
    t = torch.as_tensor(templates).float()
    codes, scale = _quantize_rows(t)
    return codes, scale[:, 0]


def _check_common(queries, rows, valid, top_k, chunk):
    if queries.dim() != 2 or rows.dim() != 2 or queries.shape[1] != rows.shape[1]:
        raise ValueError(
            f"expected queries [Q,D] and templates [G,D], got "
            f"{tuple(queries.shape)} and {tuple(rows.shape)}"
        )
    g = rows.shape[0]
    if valid.shape != (g,):
        raise ValueError(f"expected valid [{g}], got {tuple(valid.shape)}")
    if top_k < 1:
        raise ValueError(f"top_k must be >= 1, got {top_k}")
    if chunk < 1 or g % chunk:
        raise ValueError(f"{_CHUNK_MSG} (got {g} rows, chunk {chunk})")


def _running_topk(score_chunk, q, g, valid, top_k, chunk, device):
    """The chunk loop both plain versions share: `score_chunk(c0, c1)` ->
    [Q, c1-c0] float32 scores of rows c0..c1; masked, concatenated behind
    the running [Q, k] list and cut back by a stable top-k, so list entries
    (earlier rows, and the sentinels) win ties."""
    acc_v = torch.full((q, top_k), _NEG, dtype=torch.float32, device=device)
    acc_i = torch.zeros((q, top_k), dtype=torch.int64, device=device)
    for c0 in range(0, g, chunk):
        c1 = c0 + chunk
        sims = score_chunk(c0, c1)
        sims = torch.where(valid[None, c0:c1], sims, torch.full_like(sims, _NEG))
        cand_i = torch.arange(c0, c1, device=device).expand(q, -1)
        v = torch.cat([acc_v, sims], dim=1)
        i = torch.cat([acc_i, cand_i], dim=1)
        acc_v, pos = stable_top_k(v, top_k)
        acc_i = torch.gather(i, 1, pos)
    return acc_v, acc_i


def _split_bf16(qn: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = qn.to(torch.bfloat16).float()
    lo = (qn - hi).to(torch.bfloat16).float()
    return hi, lo


def streaming_cosine_topk_plain(
    queries: torch.Tensor,
    templates: torch.Tensor,
    valid: torch.Tensor,
    top_k: int = 8,
    chunk: int = 2048,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K3 (any device, any `top_k`): a loop over
    `chunk` rows that never holds [Q, G]. Rounding points as in the module
    docstring."""
    _check_common(queries, templates, valid, top_k, chunk)
    qn = normalize_queries(queries)
    valid = valid.to(torch.bool)
    if templates.dtype == torch.bfloat16:
        hi, lo = _split_bf16(qn)

        def score(c0, c1):
            t = templates[c0:c1].float().T
            return hi @ t + lo @ t
    else:

        def score(c0, c1):
            return qn @ templates[c0:c1].float().T

    return _running_topk(
        score, qn.shape[0], templates.shape[0], valid, top_k, chunk, qn.device
    )


def _fold_query_scale(out_v: torch.Tensor, q_scale: torch.Tensor) -> torch.Tensor:
    return torch.where(out_v <= _NEG, out_v, out_v * q_scale)


def streaming_cosine_topk_int8_plain(
    queries: torch.Tensor,
    templates_q: torch.Tensor,
    scales: torch.Tensor,
    valid: torch.Tensor,
    top_k: int = 8,
    chunk: int = 2048,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K4 (any device, any `top_k`). The dot is a
    float32 matmul of the codes: every partial sum is an integer below
    2^24, exact in any order (TF32 is pinned off, utils/device.py)."""
    _check_common(queries, templates_q, valid, top_k, chunk)
    qq, q_scale = _quantize_rows(normalize_queries(queries))
    qf = qq.float()
    valid = valid.to(torch.bool)
    sc = scales.float()

    def score(c0, c1):
        return (qf @ templates_q[c0:c1].float().T) * sc[None, c0:c1]

    out_v, out_i = _running_topk(
        score, qf.shape[0], templates_q.shape[0], valid, top_k, chunk, qf.device
    )
    return _fold_query_scale(out_v, q_scale), out_i


class GalleryGeometry(NamedTuple):
    """How one streaming launch is cut (see `csrc/gallery_topk.cuh`)."""

    grid: tuple[int, int]  # (blocks sharing the gallery tiles, query tiles)
    threads: int  # two consumer warpgroups and the producer's
    q_tile: int  # query rows per block
    n_tiles: int  # gallery tiles of 64 rows; block x takes x, x + grid[0], ...
    panels: int  # ring stages per tile: 128 bytes of depth each
    stages: int  # 8 KB ring stages in all: half per consumer warpgroup
    smem_bytes: int  # dynamic shared memory of a block
    list_len: int  # entries per list the kernel keeps (>= top_k)
    lists: str  # where: "registers" (<= 8), "shared" (16), "device", or the
    # "pool" route
    buffer: int  # device lists and pool: candidates buffered per query and warpgroup
    scratch: tuple[int, int, int]  # the lists: [Q, grid[0], list_len], or
    # [Q, 2 grid[0], top_k] in device memory (one per block and warpgroup);
    # the pool route: a block's unresolved queries' lists,
    # [block, 2 unresolved_grid, top_k]
    merge: tuple[int, int, int]  # the merge kernel: (blocks, threads, smem bytes)
    # the pool route (0 elsewhere), whose launches take `block` queries at a
    # time (grid, merge and select are a whole block's; the last block's
    # grid[0] is `grid_x` of its own count): tiles the sample walks, spread
    # over the gallery (its scores [block, 64 sample_tiles]); T_q's rank
    # among them; the pool's entries per query ([block, pool_cap]); the
    # select kernel's launch (blocks, threads, smem bytes: its sort of a
    # power of two >= top_k entries); blocks per query tile of the
    # unresolved queries' device lists
    sample_tiles: int = 0
    sample_rank: int = 0
    pool_cap: int = 0
    select: tuple[int, int, int] = (0, 0, 0)
    unresolved_grid: int = 0
    block: int = 0
    scratch_bytes: int = 0  # device memory the call allocates besides its outputs


#: per kind: (query rows per block, bytes per gallery value, bytes of one
#: staged query panel: bf16 the hi and lo blocks, int8 two blocks of 64
#: rows, float32 64 rows)
_KINDS = {"bf16": (64, 2, 128 * 128), "int8": (128, 1, 128 * 128), "f32": (64, 4, 64 * 128)}
_TILE_ROWS = 64
_PANEL_BYTES = 128
_STAGE_BYTES = _TILE_ROWS * _PANEL_BYTES
_SIDE_BYTES = _TILE_ROWS * 5  # a tile's valid bytes and scales, per stage
_CONSUMER_WGS = 2  # consumer warpgroups: a ring and a set of lists each
_THREADS = 384
_MIN_STAGES, _MAX_STAGES = 4, 16
#: list lengths the stream kernels keep in registers or shared memory
#: (`frp::list_length`): a call's top_k takes the shortest that holds it;
#: past the last (`frp::KSHARED`) the lists live in device memory, which on
#: an H100 beat lists of 32 and 64 in shared memory at top_k 33 and 64 and
#: lose to the list of 16 at top_k 16 (PERF.md)
_LIST_LENS = (1, 2, 3, 4, 8, 16)
_BUF = 32  # candidates buffered per query and warpgroup (`frp::BUF`)


def list_placement(top_k: int) -> tuple[str, int]:
    """Where the stream kernels keep a list for `top_k` and how many entries
    it has: ("registers", 1..8), ("shared", 16), ("device", top_k) or, from
    POOL_MIN_K, ("pool", top_k) (`gallery_launch_geometry` takes the
    device lists instead where `pool_pays` says they are the faster)."""
    if top_k >= POOL_MIN_K:
        return "pool", top_k
    if top_k > _LIST_LENS[-1]:
        return "device", top_k
    n = min(n for n in _LIST_LENS if n >= top_k)
    return ("registers" if n <= 8 else "shared"), n


def merge_launch(q: int, grid_x: int, top_k: int, lists: str) -> tuple[int, int, int]:
    """(blocks, threads, shared-memory bytes) of the merge kernel. Short
    lists: one block per query, a thread per block's list. Lists in device
    memory: one block per query, as many warps as shared memory holds (a
    pair of lists of top_k, 16 top_k bytes, each), at most 32."""
    if lists == "device":
        warps = min(32, cuda_build.SMEM_LIMIT_BYTES // (16 * top_k))
        return q, 32 * warps, warps * 16 * top_k
    return q, 32 * -(-grid_x // 32), 0


def pool_sample(g: int, top_k: int) -> tuple[int, int, float]:
    """The pool route's sample for g rows and top_k: (tiles it walks, T_q's
    rank among its rows, sampled rows expected above the k-th score).
    Enough tiles that _SAMPLE_ABOVE sampled rows are expected above the
    k-th score, at most 1 / _SAMPLE_SHARE of the tiles (at least one); the
    rank twice what is expected above, at most 2 _SAMPLE_ABOVE, so that
    about 2 top_k rows reach T_q. The query count does not enter: queries
    are blocked instead (`pool_block`)."""
    n_tiles = -(-g // _TILE_ROWS)
    want = -(-_SAMPLE_ABOVE * g // (top_k * _TILE_ROWS))
    tiles = max(1, min(want, n_tiles // _SAMPLE_SHARE))
    above = tiles * _TILE_ROWS * top_k / g
    return tiles, max(1, min(2 * _SAMPLE_ABOVE, int(2 * above))), above


def grid_x(q: int, q_tile: int, n_tiles: int, sms: int) -> int:
    """Blocks that share out the gallery tiles for each tile of q_tile of q
    queries: one block per SM (its shared memory fills it), at least one."""
    return max(1, min(n_tiles, sms // -(-q // q_tile)))


def _pool_unresolved_grid(gx: int) -> int:
    """Blocks per query tile of the pool route's unresolved queries' device
    lists: a quarter of the gather's, so that their lists (allocated on
    every call, read only by the rare unresolved query) take a quarter of
    the device-list route's scratch."""
    return max(1, gx // 4)


def _pool_bytes(qb: int, top_k: int, q_tile: int, n_tiles: int, sms: int,
                sample_tiles: int) -> int:
    """Scratch of one pool-route block of qb queries: the sampled scores;
    T_q, the unresolved route's thresholds and the cursors; the pools; the
    unresolved route's lists."""
    u = _pool_unresolved_grid(grid_x(qb, q_tile, n_tiles, sms))
    return (4 * qb * sample_tiles * _TILE_ROWS + 12 * qb
            + 8 * qb * _POOL_CAP * top_k + 8 * qb * _CONSUMER_WGS * u * top_k)


def pool_pays(q: int, g: int, top_k: int, kind: str, sms: int) -> bool:
    """Whether a call of q queries against g rows at top_k (at least
    POOL_MIN_K) takes the pool route rather than the device lists: where
    lists a query x top_k^2 reaches _POOL_MIN_WORK[kind] x g / 2^20."""
    q_tile = _KINDS[kind][0]
    lists = _CONSUMER_WGS * grid_x(q, q_tile, -(-g // _TILE_ROWS), sms)
    return lists * top_k * top_k * 2**20 >= _POOL_MIN_WORK[kind] * g


def pool_block(q: int, top_k: int, q_tile: int, n_tiles: int, sms: int,
               sample_tiles: int) -> int:
    """Queries per pool-route launch for a call of q: the most (q itself, or
    a multiple of q_tile whose gather launch fills at least 90% of its last
    wave of SMs) whose scratch fits in the device lists' scratch for the
    whole call, not below min(q, _POOL_FLOOR), and never so many that their
    sampled scores pass _SAMPLE_BUDGET bytes."""

    def fills(qb):
        blocks = -(-qb // q_tile) * grid_x(qb, q_tile, n_tiles, sms)
        return blocks >= 0.9 * sms * -(-blocks // sms)

    qb = min(q, max(1, _SAMPLE_BUDGET // (4 * sample_tiles * _TILE_ROWS)))
    if qb < q:  # the budget's block, in whole query tiles where it holds one
        qb = qb // q_tile * q_tile or qb
    floor = min(qb, _POOL_FLOOR)
    limit = 8 * q * _CONSUMER_WGS * grid_x(q, q_tile, n_tiles, sms) * top_k
    while qb > floor and (
        _pool_bytes(qb, top_k, q_tile, n_tiles, sms, sample_tiles) > limit
        or (qb < q and not fills(qb))
    ):
        qb = (qb - 1) // q_tile * q_tile
    return max(floor, qb)


@functools.lru_cache(maxsize=256)
def gallery_launch_geometry(
    q: int, g: int, d: int, kind: str, sms: int, top_k: int = 8,
    route: str | None = None,
) -> GalleryGeometry:
    """The launch geometry of K3 (`kind="bf16"`, or `"f32"` for float32
    rows) or K4 (`"int8"`) for q queries against g rows of depth d on a card
    with `sms` multiprocessors. `route` "device" or "pool" takes that route
    for any top_k past 16 (the default, None, is `list_placement`'s where
    `pool_pays`, else the device lists). Raises ValueError for what
    the kernels do not take: a depth that is not a multiple of 32 or whose
    queries and lists leave no room in a block's shared memory for a ring of
    `_MIN_STAGES` stages, `top_k` outside 1..MAX_TOP_K, 2**31 rows or more,
    an empty dimension, a route for a list that lives on chip."""
    if kind not in _KINDS:
        raise ValueError(f"kind must be one of {sorted(_KINDS)}, got {kind!r}")
    if min(q, g, d, sms) < 1:
        raise ValueError("the streaming kernel needs q, g, d and sms of at least 1")
    if not 1 <= top_k <= MAX_TOP_K:
        raise ValueError(
            f"the CUDA streaming kernels answer top_k 1..{MAX_TOP_K}, got {top_k}: "
            f"their merge keeps a pair of lists of top_k (16 top_k bytes) in the "
            f"{cuda_build.SMEM_LIMIT_BYTES} bytes of shared memory a block may use"
        )
    if d % 32:
        raise ValueError(f"the CUDA kernel needs D % 32 == 0, got D={d}")
    if g + _TILE_ROWS >= 2**31:
        raise ValueError(f"the CUDA kernel indexes rows in 32 bits, got G={g}")
    if route not in (None, "device", "pool"):
        raise ValueError(f"route must be None, 'device' or 'pool', got {route!r}")
    q_tile, elem, qpanel = _KINDS[kind]
    lists, list_len = list_placement(top_k)
    if route is not None:
        if lists in ("registers", "shared"):
            raise ValueError(
                f"top_k={top_k} keeps its lists on chip: no {route!r} route below 17"
            )
        lists = route
    elif lists == "pool" and not pool_pays(q, g, top_k, kind, sms):
        lists = "device"
    buffered = lists in ("device", "pool")
    panels = -(-d * elem // _PANEL_BYTES)
    per_query = _BUF * 8 + 8 if buffered else list_len * 8
    # alignment slack, the queries, the warpgroups' lists (device lists:
    # their buffers, counts and fills), the thresholds
    fixed = 1024 + panels * qpanel + _CONSUMER_WGS * q_tile * per_query + q_tile * 4
    per_stage = _STAGE_BYTES + _SIDE_BYTES + 16  # and two barriers
    stages = min(_MAX_STAGES, (cuda_build.SMEM_LIMIT_BYTES - fixed) // per_stage)
    stages -= stages % _CONSUMER_WGS
    if stages < _MIN_STAGES:
        raise ValueError(
            f"the {kind} streaming kernel keeps {fixed} bytes of queries and "
            f"lists for D={d}, top_k={top_k} in shared memory, which leaves "
            f"fewer than {_MIN_STAGES} ring stages of the "
            f"{cuda_build.SMEM_LIMIT_BYTES} bytes a block may use"
        )
    q_tiles = -(-q // q_tile)
    if q_tiles > 65535:
        raise ValueError(f"{q_tiles} query tiles exceed CUDA's grid limit")
    n_tiles = -(-g // _TILE_ROWS)
    smem_bytes = fixed + stages * per_stage
    if lists != "pool":
        gx = grid_x(q, q_tile, n_tiles, sms)
        scratch = ((q, _CONSUMER_WGS * gx, top_k) if lists == "device"
                   else (q, gx, list_len))
        return GalleryGeometry(
            (gx, q_tiles), _THREADS, q_tile, n_tiles, panels, stages, smem_bytes,
            list_len, lists, _BUF if buffered else 0, scratch,
            merge_launch(q, gx, top_k, lists), scratch_bytes=8 * math.prod(scratch),
        )
    sample_tiles, rank, _ = pool_sample(g, top_k)
    qb = pool_block(q, top_k, q_tile, n_tiles, sms, sample_tiles)
    gx = grid_x(qb, q_tile, n_tiles, sms)
    unresolved = _pool_unresolved_grid(gx)
    sort_n = 1 << (top_k - 1).bit_length()
    return GalleryGeometry(
        (gx, -(-qb // q_tile)), _THREADS, q_tile, n_tiles, panels, stages, smem_bytes,
        list_len, lists, _BUF, (qb, _CONSUMER_WGS * unresolved, top_k),
        merge_launch(qb, unresolved, top_k, "device"),
        sample_tiles=sample_tiles, sample_rank=rank, pool_cap=_POOL_CAP * top_k,
        select=(qb, _SELECT_THREADS, 8 * sort_n), unresolved_grid=unresolved, block=qb,
        scratch_bytes=_pool_bytes(qb, top_k, q_tile, n_tiles, sms, sample_tiles),
    )


@functools.lru_cache(maxsize=8)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=2)
def _checked_library(name: str) -> str:
    """Builds and loads kernel `name` and checks, once, that the library
    agrees with this module's constants."""
    q_tile = cuda_build.function(name, f"frp_{name}_qtile", [])()
    kmax = cuda_build.function(name, f"frp_{name}_kmax", [])()
    kind = _LIBRARY_KINDS[name]
    if q_tile != _KINDS[kind][0] or kmax != MAX_TOP_K:
        raise RuntimeError(
            f"the {name} library (query tile {q_tile}, KMAX {kmax}) differs from "
            f"ops/gallery_kernel.py"
        )
    return name


#: unresolved queries of the pool route, counted by its select kernel in a
#: 64-bit integer on each card (read with `unresolved_queries`); made by the
#: card's first pool-route call, which may not be inside a CUDA graph
#: capture (the step graphs' eager warm-up steps make it)
UNRESOLVED: dict[torch.device, torch.Tensor] = {}


def _unresolved_slot(dev: torch.device) -> torch.Tensor:
    slot = UNRESOLVED.get(dev)
    if slot is None:
        if torch.cuda.is_current_stream_capturing():
            # a capture would record the zero-fill, and every replay would
            # reset the count
            raise RuntimeError(
                "the first pool-route search on a card (top_k >= POOL_MIN_K) must "
                "run outside a CUDA graph capture: it makes the card's unresolved "
                "count; run one search eagerly first"
            )
        slot = UNRESOLVED[dev] = torch.zeros(1, dtype=torch.int64, device=dev)
    return slot


def unresolved_queries() -> int:
    """Queries the pool route sent to its device lists since the last
    `reset_unresolved`, over every card (a host read: for scripts and
    tests, never on the search path)."""
    return sum(int(t.item()) for t in UNRESOLVED.values())


def reset_unresolved() -> None:
    for t in UNRESOLVED.values():
        t.zero_()


_LIBRARY_KINDS = {"gallery_topk": "bf16", "gallery_topk_int8": "int8",
                  "gallery_topk_f32": "f32"}
_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    # queries, templates, [scales,] valid, part_v, part_i, out_v, out_i,
    # [q_scale]; Q, G, D, k, grid_x, stages, smem_bytes; stream
    "gallery_topk": [_PTR] * 7 + [_INT] * 7 + [_PTR],
    "gallery_topk_int8": [_PTR] * 9 + [_INT] * 7 + [_PTR],
    "gallery_topk_f32": [_PTR] * 7 + [_INT] * 7 + [_PTR],
    # the pool route: queries, templates, [scales,] valid, sample, thr,
    # thr_unres, cursor, pool_v, pool_i, part_v, part_i, out_v, out_i,
    # [q_scale,] unresolved; Q, G, D, k, grid_x, grid_x_u, stages,
    # smem_bytes, sample_tiles, rank, cap, sort_n, force; stream
    "gallery_topk_pool": [_PTR] * 14 + [_INT] * 13 + [_PTR],
    "gallery_topk_int8_pool": [_PTR] * 16 + [_INT] * 13 + [_PTR],
    "gallery_topk_f32_pool": [_PTR] * 14 + [_INT] * 13 + [_PTR],
}
_ENCODE_FAILED = 100000  # `frp::ENCODE_FAILED`


def _check_rc(name: str, rc: int) -> None:
    if rc >= _ENCODE_FAILED:
        raise RuntimeError(
            f"{name}: cuTensorMapEncodeTiled refused the gallery "
            f"(CUresult {rc - _ENCODE_FAILED})"
        )
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed (cudaError {rc})")


def _launch(name, counter, queries, rows, scales, valid, top_k, q_scale=None,
            route=None):
    """Allocate scratch and outputs, launch kernel `name` (and the merge
    kernel behind it, or the pool route's six launches for each block of
    queries) on the current stream, check the return codes, count the call.
    `route` as in `_card_search`. A gallery view that is not contiguous or
    starts off a 16-byte address is refused (a copy of 10^6 rows per call is
    never what the caller wants); the small per-row operands are copied
    instead."""
    dev = queries.device
    q, d = queries.shape
    g = rows.shape[0]
    for t in (rows, scales, valid):
        if t is not None and t.device != dev:
            raise ValueError("queries, templates, scales and valid must share one device")
    if not rows.is_contiguous() or rows.data_ptr() % 16:
        raise ValueError("templates must be contiguous and 16-byte aligned")
    kind = _LIBRARY_KINDS[name]
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    sms = _sm_count(index)
    # the geometry first: it refuses what the kernel does not take
    geo = gallery_launch_geometry(q, g, d, kind, sms, top_k,
                                  "pool" if route == "pool_unresolved" else route)
    # the small per-row operands are copied when a view starts off 16 bytes
    if valid.data_ptr() % 16:
        valid = valid.clone()
    if scales is not None and scales.data_ptr() % 16:
        scales = scales.clone()

    def empty(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    part_v, part_i = empty(geo.scratch), empty(geo.scratch, torch.int32)
    out_v, out_i = empty((q, top_k)), empty((q, top_k), torch.int64)
    stream = torch.cuda.current_stream(dev).cuda_stream
    fn = cuda_build.function(_checked_library(name),
                             f"frp_{name}_pool" if geo.lists == "pool" else f"frp_{name}",
                             _ARGTYPES[f"{name}_pool" if geo.lists == "pool" else name])

    def operands(q0, q1, between):
        """Pointers of queries q0..q1: the inputs, `between`, the outputs'
        rows, the query scales."""
        ptrs = [queries[q0:q1].data_ptr(), rows.data_ptr()]
        if scales is not None:
            ptrs.append(scales.data_ptr())
        ptrs += [valid.data_ptr()] + [t.data_ptr() for t in between]
        ptrs += [out_v[q0:q1].data_ptr(), out_i[q0:q1].data_ptr()]
        return ptrs + ([] if q_scale is None else [q_scale[q0:q1].data_ptr()])

    if geo.lists != "pool":
        with torch.cuda.device(dev):  # the launch goes to the tensors' card
            rc = fn(*operands(0, q, (part_v, part_i)), q, g, d, top_k, geo.grid[0],
                    geo.stages, geo.smem_bytes, stream)
        _check_rc(name, rc)
        counter.bump()
        return out_v, out_i
    qb = geo.block
    state = (empty((qb, geo.sample_tiles * _TILE_ROWS)), empty(qb), empty(qb),
             empty(qb, torch.int32), empty((qb, geo.pool_cap)),
             empty((qb, geo.pool_cap), torch.int32), part_v, part_i)
    slot = _unresolved_slot(dev).data_ptr()
    for q0 in range(0, q, qb):  # in order on one stream: the blocks share the scratch
        q1 = min(q, q0 + qb)
        gx = grid_x(q1 - q0, geo.q_tile, geo.n_tiles, sms)
        with torch.cuda.device(dev):  # the launches go to the tensors' card
            rc = fn(
                *operands(q0, q1, state), slot, q1 - q0, g, d, top_k, gx,
                geo.unresolved_grid, geo.stages, geo.smem_bytes, geo.sample_tiles,
                geo.sample_rank, geo.pool_cap, geo.select[2] // 8,
                int(route == "pool_unresolved"), stream,
            )
        _check_rc(name, rc)
    counter.bump()
    POOL_LAUNCHES[kind].bump()
    return out_v, out_i


def _empty(q, top_k, device):
    return (
        torch.empty((q, top_k), dtype=torch.float32, device=device),
        torch.empty((q, top_k), dtype=torch.int64, device=device),
    )


def _check_route(route, top_k):
    if route not in _ROUTES:
        raise ValueError(f"route must be one of {_ROUTES}, got {route!r}")
    if route is not None and top_k <= _LIST_LENS[-1]:
        raise ValueError(f"route {route!r} takes top_k past 16, got {top_k}")


def _card_search(queries, rows, valid, top_k, scales=None, route=None):
    """The card's half of both wrappers, their arguments checked: K4 where
    `scales` is given (int8 codes), else K3 on bf16 or float32 rows.
    `route` (top_k past 16 only; for scripts and tests that time or check a
    route): "device" the device lists, "pool" the pool route,
    "pool_unresolved" the pool route with every query sent on to its device
    lists; None takes `gallery_launch_geometry`'s."""
    _check_route(route, top_k)
    if scales is None and rows.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(
            f"the CUDA streaming kernels take bf16 or float32 templates, got {rows.dtype}"
        )
    if queries.shape[0] == 0:
        return _empty(0, top_k, queries.device)
    valid = valid.to(torch.bool).contiguous()
    if scales is not None:
        qq, q_scale = _quantize_rows(normalize_queries(queries))
        # the merge and select kernels fold the query scale in
        # (`_fold_query_scale`'s rule)
        return _launch("gallery_topk_int8", LAUNCHES_INT8, qq.contiguous(), rows,
                       scales.contiguous(), valid, top_k, q_scale.contiguous(), route)
    name, counter = (("gallery_topk", LAUNCHES) if rows.dtype == torch.bfloat16
                     else ("gallery_topk_f32", LAUNCHES_F32))
    qn = normalize_queries(queries).contiguous()
    return _launch(name, counter, qn, rows, None, valid, top_k, route=route)


def streaming_cosine_topk(
    queries: torch.Tensor,
    templates: torch.Tensor,
    valid: torch.Tensor,
    top_k: int = 8,
    chunk: int = 2048,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K3: queries [Q,D] (normalised here), templates [G,D] (G a multiple of
    `chunk`; rows unit-norm, zero for padding), valid [G] bool -> (scores
    [Q,top_k] float32, indices [Q,top_k] int64).

    CUDA tensors launch a kernel: bf16 templates (the copy `DeviceGallery`
    serves at streaming scale) the tensor-core one, float32 templates the
    float32 one (`LAUNCHES_F32`); D % 32 == 0 and 1 <= top_k <= MAX_TOP_K
    (14 528; top_k 17 to POOL_MIN_K - 1 keep lists in device memory, scratch
    of Q x 2 grid_x x top_k x 8 bytes; from POOL_MIN_K the pool route), else
    it raises. CPU tensors take `streaming_cosine_topk_plain` (bf16 or
    float32 rows, any top_k). Q = 0 returns empty results. `chunk` only
    states the padding contract (G % chunk == 0); the kernel's own tile is
    its own."""
    _check_common(queries, templates, valid, top_k, chunk)
    if queries.device.type == "cpu":
        return streaming_cosine_topk_plain(queries, templates, valid, top_k, chunk)
    if queries.device.type != "cuda":
        raise ValueError(f"streaming_cosine_topk: unsupported device {queries.device}")
    return _card_search(queries, templates, valid, top_k)


def streaming_cosine_topk_int8(
    queries: torch.Tensor,
    templates_q: torch.Tensor,
    scales: torch.Tensor,
    valid: torch.Tensor,
    top_k: int = 8,
    chunk: int = 2048,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K4: queries [Q,D] (normalised and quantised per row here),
    templates_q int8 [G,D] and scales float32 [G] from
    `quantize_templates`, valid [G] bool -> (scores [Q,top_k] float32,
    indices [Q,top_k] int64). Half the gallery bytes of K3.

    CUDA tensors launch the kernel (int8 codes, float32 scales, D % 32 ==
    0, 1 <= top_k <= MAX_TOP_K as for K3, else it raises); CPU tensors take
    `streaming_cosine_topk_int8_plain` (any top_k). Q = 0 returns empty
    results."""
    _check_common(queries, templates_q, valid, top_k, chunk)
    if templates_q.dtype != torch.int8:
        raise TypeError(f"templates_q must be int8 codes, got {templates_q.dtype}")
    if scales.shape != (templates_q.shape[0],):
        raise ValueError(
            f"expected scales [{templates_q.shape[0]}], got {tuple(scales.shape)}"
        )
    if queries.device.type == "cpu":
        return streaming_cosine_topk_int8_plain(
            queries, templates_q, scales, valid, top_k, chunk
        )
    if queries.device.type != "cuda":
        raise ValueError(
            f"streaming_cosine_topk_int8: unsupported device {queries.device}"
        )
    if scales.dtype != torch.float32:
        raise TypeError(f"scales must be float32, got {scales.dtype}")
    return _card_search(queries, templates_q, valid, top_k, scales)
