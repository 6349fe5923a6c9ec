"""Streaming gallery search: kernels K3 (bf16) and K4 (int8) and their plain
versions.

Counterpart of `facerecognitionpipeline_tpu/ops/pallas_gallery.py`, with the
same public names. Replaces its two `pl.pallas_call`s:
`_streaming_cosine_topk` (K3, `csrc/gallery_topk.cu`) and
`_streaming_cosine_topk_int8` (K4, `csrc/gallery_topk_int8.cu`). Both
compute the cosine top-k of a few queries against a gallery of 10^5-10^6
rows without ever storing the [Q, G] similarity matrix; both are bound by
device-memory bytes (one read of the gallery), and the int8 pair halves
those bytes. `csrc/gallery_topk.cuh` describes the design.

Semantics, shared by kernels, plain versions and the JAX functions:

* queries are L2-normalised here (`q / (|q| + 1e-8)`), outside the kernel;
* rows with `valid == False` score exactly -1e9 and never displace a valid
  row; the running list starts as `top_k` sentinels (-1e9, index 0), so
  with fewer valid rows than `top_k` the surplus slots hold (-1e9, 0) -- not
  the masked rows' own indices that the dense `cosine_topk` returns there;
* ties go to the lower gallery index;
* indices come back int64, as from the port's dense `cosine_topk` (the
  kernels write int32; the wrappers widen).

Rounding points. K3 and `streaming_cosine_topk_plain` on bf16 rows: the
float32 unit query is split into hi = bf16(q) and lo = bf16(q - hi), and
score = sum_d (hi_d + lo_d) * t_d in float32 with exact products. That is
the float32 query's score to ~1e-6, so crossing into the streaming path
does not shift scores by a bf16 rounding of the query (~2e-3). On float32
rows (CPU only) the plain version multiplies in float32 without a split,
as the JAX function does. K4 and `streaming_cosine_topk_int8_plain`: the
query is quantised per row here (as the JAX wrapper does), the integer dot
is exact, score = float32(dot) * row_scale rounds once, and the query scale
multiplies the finished scores (the -1e9 sentinel kept exact); kernel and
plain version agree to the bit.

Each wrapper launches its kernel for CUDA tensors (and counts the launch;
the small merge kernel that follows in the same call is not counted
separately), takes the plain version for CPU tensors only, and raises on
anything else. Nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch

from facerecognitionpipeline_tpu_torch.ops import cuda_build
from facerecognitionpipeline_tpu_torch.ops.nms import top_k as stable_top_k
from facerecognitionpipeline_tpu_torch.ops.numerics import div

#: launches of K3 (bf16) and of K4 (int8)
LAUNCHES = cuda_build.LaunchCounter()
LAUNCHES_INT8 = cuda_build.LaunchCounter()

#: longest top-k the CUDA kernels keep (`frp::KMAX` in csrc/gallery_topk.cuh)
MAX_TOP_K = 8

_EPS = 1e-8
_NEG = -1e9
_CHUNK_MSG = "pad the gallery to a multiple of the chunk size"


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


def _launch(name, counter, queries, rows, scales, valid, top_k):
    """Allocate scratch and outputs, launch kernel `name` on the current
    stream, check its return code, count the launch."""
    dev = queries.device
    q, d = queries.shape
    g = rows.shape[0]
    if top_k > MAX_TOP_K:
        raise ValueError(
            f"the CUDA kernel keeps at most top_k={MAX_TOP_K}, got {top_k}"
        )
    if d % 32:
        raise ValueError(f"the CUDA kernel needs D % 32 == 0, got D={d}")
    for t in (rows, scales, valid):
        if t is not None and t.device != dev:
            raise ValueError("queries, templates, scales and valid must share one device")
    if not rows.is_contiguous() or rows.data_ptr() % 16:
        raise ValueError("templates must be contiguous and 16-byte aligned")
    # the small per-row operands are copied when a view starts off 16 bytes
    if valid.data_ptr() % 16:
        valid = valid.clone()
    if scales is not None and scales.data_ptr() % 16:
        scales = scales.clone()
    lib = cuda_build.load(name)
    q_tile = getattr(lib, f"frp_{name}_qtile")()
    if getattr(lib, f"frp_{name}_kmax")() != MAX_TOP_K:
        raise RuntimeError(f"MAX_TOP_K differs from the {name} kernel's KMAX")
    q_tiles = -(-q // q_tile)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # one block per SM (the block's shared memory fills it); the blocks of
    # one query tile share out the gallery tiles
    grid_x = max(1, min(-(-g // 32), sms // q_tiles))
    part_v = torch.empty(
        (grid_x, q_tiles * q_tile, MAX_TOP_K), dtype=torch.float32, device=dev
    )
    part_i = torch.empty_like(part_v, dtype=torch.int32)
    out_v = torch.empty((q, top_k), dtype=torch.float32, device=dev)
    out_i = torch.empty((q, top_k), dtype=torch.int32, device=dev)
    fn = getattr(lib, f"frp_{name}")
    n_ptr = 7 if scales is None else 8
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ptrs = [queries.data_ptr(), rows.data_ptr()]
    if scales is not None:
        ptrs.append(scales.data_ptr())
    ptrs += [t.data_ptr() for t in (valid, part_v, part_i, out_v, out_i)]
    rc = fn(*ptrs, q, g, d, top_k, grid_x, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed (cudaError {rc})")
    counter.bump()
    return out_v, out_i.to(torch.int64)


def _empty(q, top_k, device):
    return (
        torch.empty((q, top_k), dtype=torch.float32, device=device),
        torch.empty((q, top_k), dtype=torch.int64, device=device),
    )


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

    CUDA tensors launch the kernel: templates must be bf16 (the copy
    `DeviceGallery` serves at streaming scale), D % 32 == 0 and
    top_k <= MAX_TOP_K, else it raises. CPU tensors take
    `streaming_cosine_topk_plain` (bf16 or float32 rows, any top_k). Q = 0
    returns empty results. `chunk` only states the padding contract
    (G % chunk == 0); the kernel's own tile is its own."""
    _check_common(queries, templates, valid, top_k, chunk)
    if queries.device.type == "cpu":
        return streaming_cosine_topk_plain(queries, templates, valid, top_k, chunk)
    if queries.device.type != "cuda":
        raise ValueError(f"streaming_cosine_topk: unsupported device {queries.device}")
    if templates.dtype != torch.bfloat16:
        raise TypeError(
            f"the CUDA streaming kernel takes bf16 templates, got {templates.dtype}"
        )
    if queries.shape[0] == 0:
        return _empty(0, top_k, queries.device)
    qn = normalize_queries(queries).contiguous()
    valid = valid.to(torch.bool).contiguous()
    return _launch("gallery_topk", LAUNCHES, qn, templates, None, valid, top_k)


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
    0, top_k <= MAX_TOP_K, else it raises); CPU tensors take
    `streaming_cosine_topk_int8_plain`. Q = 0 returns empty results."""
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
    if queries.shape[0] == 0:
        return _empty(0, top_k, queries.device)
    qq, q_scale = _quantize_rows(normalize_queries(queries))
    valid = valid.to(torch.bool).contiguous()
    out_v, out_i = _launch(
        "gallery_topk_int8", LAUNCHES_INT8, qq.contiguous(), templates_q,
        scales.contiguous(), valid, top_k,
    )
    return _fold_query_scale(out_v, q_scale), out_i
