// Greedy NMS from score-sorted boxes, on a thread-block cluster (kernel K5).
//
// Replaces the jax.lax.while_loop of facerecognitionpipeline_tpu/ops/nms.py
// (nms_mask, the loop at its line 96) together with what feeds it there:
// pairwise_iou (:19-36) and the conflict mask (:57-60), which XLA fuses into
// the loop's program on the TPU. In eager PyTorch the mask was about fifteen
// unfused elementwise kernels over [B, N, N] float32 (42.5 MB per tensor at
// stage 1's [8, 1152]), and the loop's condition a host read that kept the
// step out of a CUDA graph. No library call computes it.
//
// What it computes, per frame: the conflict bit of every pair j < i of the
// sorted boxes,
//   inter = max(min(x2i, x2j) - max(x1i, x1j), 0) * max(min(y2i, y2j) -
//           max(y1i, y1j), 0)
//   area  = max(x2 - x1, 0) * max(y2 - y1, 0)
//   denom = (area_i + area_j) - inter     (mode union)
//           min(area_i, area_j)           (mode min)
//   bit   = inter / max(denom, 1e-9f) > thr
// each step rounded to float32 in that order, as torch's separate CUDA
// kernels round them (ops/nms_kernel.py::nms_sorted_plain): no contraction
// (the build passes -fmad=false, and the _rn intrinsics say it again), a
// correctly rounded division, and max / min that propagate NaN as
// torch.maximum, torch.minimum and clamp_min do (max.NaN / min.NaN; CUDA's
// fmaxf would drop it). torch compares a float32 tensor with the Python
// threshold in float32 (checked on the CPU: f32(0.3) > 0.3 is false), so
// `thr` arrives as a float. Then the fixpoint, on the schedule of the plain
// loop (ops/nms_kernel.py::nms_fixpoint_plain):
//   keep_1 = sweep(v),  keep_{t+1} = sweep(keep_t)  for t < 7   (prologue)
//   it = 7;  while (it < N && keep != prev) { keep, prev = sweep(sweep(keep)),
//                                             keep;  it += 2 }
//   sweep(k)[i] = v[i] & !any_{j<i}(bit(i, j) & k[j])
// so the result is bit-equal to it, also where it stops at the it < N cap.
// A frame stops at its own convergence; the plain loop sweeps the whole batch
// until its slowest frame converges, and two keep masks one sweep apart are
// a fixpoint, so the answers are the same.
//
// What bounds it on an H100: the IoUs' float32 operations, one per pair j < i
// of valid boxes (no other pair can suppress), about 14 each (at most 74
// MFLOP at stage 1's [8, 1152]: 1.1 us at 67 TFLOP/s, some 70 us on one SM),
// then the chain of sweeps, each ending in a barrier across the blocks that
// share the frame (0.75 us at C = 16). Its bytes are the boxes, v and keep:
// 18 bytes per box. Its design:
//   * one thread-block cluster of C blocks of 512 threads per frame
//     (ops/nms_kernel.py::nms_launch_geometry picks C from 1 to 16 by N: 16
//     at N = 1152, 4 at 256, 1 at 96), so the IoUs of a batch of 8 frames
//     spread over the card; with 512 threads two blocks share an SM, so all
//     eight clusters of 16 fit at once (of 1024-thread blocks only seven do);
//   * block c of a cluster owns a band of 32-row groups (rows 32 g .. 32 g +
//     31 make keep word g), cut so that the bands hold about equal numbers of
//     packed words; every block stages the frame's boxes and their areas in
//     its shared memory. The conflict bits go straight into a bit packing of
//     the triangle: group g keeps words 0 .. g of its 32 rows as [word][row]
//     (32 (g + 1) words, group_offset(g) = 16 g (g + 1) before it), in the
//     band owner's shared memory. Only valid rows and words holding a valid
//     box are computed (keep is a subset of v, so a sweep never looks at the
//     others), their rows strided over every warp of the cluster: a warp
//     takes a row, lane l the bit of box 32 w + l of word w, one ballot makes
//     the word, and a store through distributed shared memory puts it with
//     its band's owner. Where no lane of a warp overlaps its box the IoU
//     stops; a filter on thr * d decides all but the quotients near thr, and
//     only those run the correctly rounded division. No [B, N, N] tensor and
//     no byte mask exists anywhere;
//   * every block keeps the cluster's whole keep masks (v, keep, prev,
//     spare: ceil(N / 32) words each). A sweep computes the new words of the
//     block's own groups from its rows (a warp per group, lane r row 32 g +
//     r, one ballot per group), writes each word into every block's copy
//     through distributed shared memory (lane k into block k's), and raises
//     the "changed" flag of every block the same way; one cluster barrier per
//     sweep (a block barrier where C = 1) then makes the new mask whole
//     everywhere. The flag has two slots, so the one a check reads is never
//     the one the next check clears;
//   * where the packed rows of a band, the boxes and the masks do not fit a
//     block's shared memory (N above about 5 000 at C = 16), the rows go to a
//     device scratch buffer of the wrapper's and the boxes are read from
//     device memory (the second instantiation, SMEM = false).
// Layouts: boxes [B, N, 4] float32 (x1, y1, x2, y2), valid [B, N] bool, keep
// [B, N] bool; all contiguous, boxes 16-byte aligned.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int PROLOGUE_SWEEPS = 7;
constexpr int MAX_CLUSTER = 16;
constexpr int SWEEP_WORDS = 8;  // words of a group a sweep's warp has in flight

// Words of the conflict rows of groups 0 .. g - 1 in the group-major packing:
// group h (rows 32 h .. 32 h + 31) keeps words 0 .. h of its rows as
// [word][row], 32 (h + 1) words (bits j < i; the row's other bits zero).
__host__ __device__ __forceinline__ long long group_offset(long long g) {
  return 16 * g * (g + 1);
}

// First group of band k of C over W groups: the smallest g whose groups
// before it hold at least k / C of the packed words (band C ends at W).
// ops/nms_kernel.py::band_bounds is the same rule.
__host__ __device__ inline int band_start(int W, int C, int k) {
  if (k >= C) return W;
  const long long target = static_cast<long long>(k) * W * (W + 1);
  int lo = 0, hi = W;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (static_cast<long long>(mid) * (mid + 1) * C >= target) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo;
}

// torch.maximum / torch.minimum / clamp_min on float32: NaN in, NaN out.
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(max_nan(__fsub_rn(b.z, b.x), 0.0f),
                   max_nan(__fsub_rn(b.w, b.y), 0.0f));
}

// The conflict bit of box i (row) against box j (column), as the plain
// version's torch ops compute it; `live` false gives 0 (j >= i, or a box
// that is not valid). inter is never negative, so with thr >= 0 only inter >
// 0 can pass. Where thr is a normal float (1e-20 .. 1e20) and the divisor at
// most 1e30, comparing inter with thr * d (1 +- 2^-20) decides every quotient
// at least 2^-21 of thr away from it (q = RN(inter / d) is then at least four
// ulps of thr on the same side; thr * d stays a normal float); only a warp
// with a lane nearer than that runs the correctly rounded division.
__device__ __forceinline__ bool conflict(bool live, float4 bi, float ai,
                                         float4 bj, float aj, float thr,
                                         bool min_mode, bool filter) {
  const float ix1 = max_nan(bi.x, bj.x);
  const float iy1 = max_nan(bi.y, bj.y);
  const float ix2 = min_nan(bi.z, bj.z);
  const float iy2 = min_nan(bi.w, bj.w);
  const float inter = __fmul_rn(max_nan(__fsub_rn(ix2, ix1), 0.0f),
                                max_nan(__fsub_rn(iy2, iy1), 0.0f));
  const bool maybe = live && (inter > 0.0f || (thr < 0.0f && inter == 0.0f));
  if (!__any_sync(0xffffffffu, maybe)) return false;
  const float denom =
      min_mode ? min_nan(ai, aj) : __fsub_rn(__fadd_rn(ai, aj), inter);
  const float d = max_nan(denom, 1e-9f);
  bool sure = false, near = maybe;
  if (filter && d <= 1e30f) {
    const float a = __fmul_rn(thr, d);
    sure = inter > __fmul_rn(a, 1.0f + 0x1p-20f);
    near = maybe && !sure && !(inter < __fmul_rn(a, 1.0f - 0x1p-20f));
  }
  bool bit = maybe && sure;
  if (__any_sync(0xffffffffu, near) && near) bit = __fdiv_rn(inter, d) > thr;
  return bit;
}

// Bytes of dynamic shared memory of one block (ops/nms_kernel.py::
// nms_launch_geometry computes the same): with SMEM the boxes (16 N), the
// four keep masks (16 W), the areas (4 N, rounded up to 16 bytes) and the
// band's packed rows (4 R); without, the masks alone.
__host__ __device__ inline long long smem_bytes_for(bool smem, int N, int W,
                                                    long long R) {
  const long long masks = 16LL * W;
  if (!smem) return masks;
  return 16LL * N + masks + 4LL * ((N + 3) / 4 * 4) + 4 * R;
}

// The block barrier of one block, the cluster barrier of several.
__device__ __forceinline__ void frame_sync(cg::cluster_group& cluster, int C) {
  if (C > 1) {
    cluster.sync();
  } else {
    __syncthreads();
  }
}

// dst[g] = v[g] & ~suppressed(src) for the block's groups g0 .. g1, written
// into every block's copy of dst; with `cmp`, raise every block's flag slot
// `slot` where a new word differs from cmp. `rows` holds the band's groups
// from g0 on. A warp takes a group, lane r row 32 g + r: one conflict-free
// load per word, SWEEP_WORDS of them in flight, and one ballot makes the
// group's suppressed bits; lane k then writes block k's copy. Groups past gv
// hold no valid row: their words are v's, 0.
__device__ __forceinline__ void sweep(cg::cluster_group& cluster,
                                      const uint32_t* rows,
                                      const uint32_t* vbits,
                                      const uint32_t* src, uint32_t* dst,
                                      const uint32_t* cmp, int* flags,
                                      int slot, int g0, int g1, int gv,
                                      int C) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  for (int g = g0 + warp; g < g1; g += warps) {
    uint32_t bits = 0;
    if (g < gv) {
      const uint32_t* grp = rows + (group_offset(g) - group_offset(g0));
      uint32_t acc = 0;
      for (int w0 = 0; w0 <= g; w0 += SWEEP_WORDS) {
#pragma unroll
        for (int u = 0; u < SWEEP_WORDS; ++u) {
          const int w = w0 + u;
          if (w <= g) acc |= grp[32 * w + lane] & src[w];
        }
      }
      bits = __ballot_sync(0xffffffffu, acc != 0);
    }
    const uint32_t word = vbits[g] & ~bits;
    const bool changed = cmp != nullptr && word != cmp[g];
    if (C == 1) {
      if (lane == 0) {
        dst[g] = word;
        if (changed) flags[slot] = 1;
      }
    } else {
      for (int k = lane; k < C; k += 32) {
        cluster.map_shared_rank(dst, k)[g] = word;
        if (changed) cluster.map_shared_rank(flags, k)[slot] = 1;
      }
    }
  }
  frame_sync(cluster, C);
}

template <bool SMEM>
__global__ void __launch_bounds__(1024)
    nms_fixpoint_kernel(const float4* __restrict__ boxes,
                        const uint8_t* __restrict__ valid,
                        uint8_t* __restrict__ keep_out,
                        uint32_t* __restrict__ rows_global, int N, float thr,
                        int min_mode) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int flags[2];
  __shared__ int last_valid;
  __shared__ int bands[MAX_CLUSTER + 1];
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  if (C > 1) {  // this block has started; waited on before the first remote store
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  }
  const int frame = blockIdx.x / C;
  const int W = (N + 31) >> 5;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const bool by_min = min_mode != 0;
  const bool filter = thr >= 1e-20f && thr <= 1e20f;

  const float4* fb = boxes + static_cast<long long>(frame) * N;
  const uint8_t* fv = valid + static_cast<long long>(frame) * N;
  const int g0 = band_start(W, C, rank), g1 = band_start(W, C, rank + 1);

  unsigned char* p = smem;
  const float4* bx = fb;
  const float* ar = nullptr;
  if constexpr (SMEM) {
    float4* sb = reinterpret_cast<float4*>(p);
    p += 16LL * N;
    for (int j = threadIdx.x; j < N; j += blockDim.x) sb[j] = fb[j];
    bx = sb;
  }
  uint32_t* vbits = reinterpret_cast<uint32_t*>(p);
  uint32_t* keep = vbits + W;
  uint32_t* prev = keep + W;
  uint32_t* spare = prev + W;
  p = reinterpret_cast<unsigned char*>(spare + W);
  uint32_t* rows;
  uint32_t* rows_frame = nullptr;  // SMEM = false: the frame's scratch
  if constexpr (SMEM) {
    float* sa = reinterpret_cast<float*>(p);
    p += 4LL * ((N + 3) / 4 * 4);
    rows = reinterpret_cast<uint32_t*>(p);
    __syncthreads();  // the staged boxes
    for (int j = threadIdx.x; j < N; j += blockDim.x) sa[j] = box_area(bx[j]);
    ar = sa;
  } else {
    rows_frame = rows_global + static_cast<long long>(frame) * group_offset(W);
    rows = rows_frame + group_offset(g0);
  }
  if (threadIdx.x < 2) flags[threadIdx.x] = 0;
  if (threadIdx.x == 0) last_valid = -1;
  if (static_cast<int>(threadIdx.x) <= C)
    bands[threadIdx.x] = band_start(W, C, threadIdx.x);
  __syncthreads();  // the areas, last_valid
  for (int w = warp; w < W; w += warps) {
    const int j = 32 * w + lane;
    const uint32_t word = __ballot_sync(0xffffffffu, j < N && fv[j] != 0);
    if (lane == 0) {
      vbits[w] = word;
      if (word != 0) atomicMax(&last_valid, 32 * w + 31 - __clz(word));
    }
  }
  __syncthreads();  // vbits, last_valid, bands
  const int nv = last_valid + 1;  // rows and columns past it are not valid
  const int gv = (nv + 31) >> 5;

  // the conflict rows of the valid boxes, over every warp of the cluster: a
  // warp per row (rows strided over the cluster's warps, so long and short
  // rows mix), lane l the bit of box 32 w + l of word w, the word written
  // into the band owner's rows. A row or a word of no valid box is never
  // written: a sweep reads it only under a keep word that is 0 there (keep is
  // a subset of v), so what it holds does not matter
  if (C > 1) {  // every block has started: its shared memory takes stores
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  }
  for (int i = rank * warps + warp; i < nv; i += C * warps) {
    if (((vbits[i >> 5] >> (i & 31)) & 1u) == 0) continue;
    const float4 bi = bx[i];
    const float ai = SMEM ? ar[i] : box_area(bi);
    const int g = i >> 5;
    uint32_t* out;
    if constexpr (SMEM) {
      int owner = 0;
      while (bands[owner + 1] <= g) ++owner;
      out = cluster.map_shared_rank(rows, owner) +
            (group_offset(g) - group_offset(bands[owner]));
    } else {
      out = rows_frame + group_offset(g);
    }
    out += i & 31;
    for (int w = 0; w <= g; ++w) {
      const uint32_t vw = vbits[w];
      if (vw == 0) continue;
      const int j = 32 * w + lane;
      const bool live = j < i && ((vw >> lane) & 1u) != 0;
      float4 bj = bi;
      float aj = ai;
      if (live) {
        bj = bx[j];
        aj = SMEM ? ar[j] : box_area(bj);
      }
      const uint32_t word = __ballot_sync(
          0xffffffffu, conflict(live, bi, ai, bj, aj, thr, by_min, filter));
      if (lane == 0) out[32 * w] = word;
    }
  }
  // the rows are whole in their owners' shared memory (or in the scratch)
  frame_sync(cluster, C);

  // the prologue: seven sweeps; the last one says whether keep_7 != keep_6
  sweep(cluster, rows, vbits, vbits, keep, nullptr, flags, 0, g0, g1, gv, C);
  for (int t = 1; t < PROLOGUE_SWEEPS; ++t) {
    const bool last = t == PROLOGUE_SWEEPS - 1;
    sweep(cluster, rows, vbits, keep, spare, last ? keep : nullptr, flags, 0, g0,
          g1, gv, C);
    uint32_t* old_prev = prev;
    prev = keep;
    keep = spare;
    spare = old_prev;
  }
  // pairs of sweeps while it < N and the last check saw a change; check c
  // reads flag slot c & 1 (every block's copy holds the same after the
  // barrier) and clears the other slot, which the next check sets
  int check = 0;
  for (int it = PROLOGUE_SWEEPS; it < N; it += 2) {
    if (reinterpret_cast<volatile int*>(flags)[check & 1] == 0) break;
    const int next = (check + 1) & 1;
    if (threadIdx.x == 0) flags[next] = 0;
    sweep(cluster, rows, vbits, keep, spare, nullptr, flags, next, g0, g1, gv,
          C);  // mid
    sweep(cluster, rows, vbits, spare, prev, keep, flags, next, g0, g1, gv,
          C);  // new, against keep
    uint32_t* old_keep = keep;
    keep = prev;
    prev = old_keep;
    ++check;
  }
  uint8_t* out = keep_out + static_cast<long long>(frame) * N;
  for (int j = 32 * g0 + threadIdx.x; j < min(32 * g1, N); j += blockDim.x)
    out[j] = static_cast<uint8_t>((keep[j >> 5] >> (j & 31)) & 1u);
}

// Lets kernel instance SMEM take `smem_bytes` of dynamic shared memory and,
// for C > 8, a non-portable cluster size: asked for once per device, and
// only ever raised (a launch and the occupancy query share it).
template <bool SMEM>
cudaError_t allow(int smem_bytes, int C) {
  auto* kernel = nms_fixpoint_kernel<SMEM>;
  constexpr int MAX_DEVICES = 64;
  static int granted[MAX_DEVICES] = {};
  static bool wide[MAX_DEVICES] = {};
  int dev = -1;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  const bool cached = dev < MAX_DEVICES;
  if (smem_bytes > 48 * 1024 && (!cached || granted[dev] < smem_bytes)) {
    rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (rc != cudaSuccess) return rc;
    if (cached) granted[dev] = smem_bytes;
  }
  if (C > 8 && (!cached || !wide[dev])) {  // 16 blocks: a non-portable size
    rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (rc != cudaSuccess) return rc;
    if (cached) wide[dev] = true;
  }
  return cudaSuccess;
}

template <bool SMEM>
int launch(const float4* boxes, const uint8_t* valid, uint8_t* keep,
           uint32_t* rows_global, int B, int N, float thr, int min_mode, int C,
           int threads, int smem_bytes, cudaStream_t stream) {
  cudaError_t rc = allow<SMEM>(smem_bytes, C);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B) * C, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  rc = cudaLaunchKernelEx(&cfg, nms_fixpoint_kernel<SMEM>, boxes, valid, keep,
                          rows_global, N, thr, min_mode);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

// Checks a geometry against this file's own rules: the bands' most packed
// words R, and the shared-memory bytes.
bool geometry_ok(int N, int C, long long R, bool rows_in_smem, int smem_bytes) {
  const int W = (N + 31) >> 5;
  long long r_most = 0;
  for (int k = 0; k < C; ++k) {
    const int a = band_start(W, C, k), b = band_start(W, C, k + 1);
    if (group_offset(b) - group_offset(a) > r_most)
      r_most = group_offset(b) - group_offset(a);
  }
  return R == r_most && smem_bytes == smem_bytes_for(rows_in_smem, N, W, R);
}

// The cost of the sweeps' barrier alone: `iters` cluster barriers and nothing
// else (chip_smoke.py times 1 and 1001 of them).
__global__ void barrier_probe_kernel(int iters) {
  cg::cluster_group cluster = cg::this_cluster();
  for (int t = 0; t < iters; ++t) cluster.sync();
}

}  // namespace

// Launches B clusters of C blocks of `threads` threads on `stream`, with the
// geometry ops/nms_kernel.py::nms_launch_geometry chose: `smem_bytes` of
// dynamic shared memory (checked against this file's own count), `R` the
// most packed words of one band, the rows in
// shared memory when `rows_in_smem`, else in `rows_global`, a [B,
// group_offset(W)] uint32 scratch buffer. `min_mode` 1 divides by the smaller area.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int frp_nms_fixpoint(const float* boxes, const uint8_t* valid,
                                uint8_t* keep, uint32_t* rows_global, int B,
                                int N, float thr, int min_mode, int C,
                                int threads, long long R, int rows_in_smem,
                                int smem_bytes, void* stream) {
  if (B < 1 || N < 1 || N >= (1 << 20) || C < 1 || C > MAX_CLUSTER ||
      (C & (C - 1)) != 0 || threads < 32 || threads > 1024 || threads % 32 ||
      static_cast<long long>(B) * C > 0x7fffffffLL ||
      reinterpret_cast<uintptr_t>(boxes) % 16 != 0 ||
      (!rows_in_smem && rows_global == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!geometry_ok(N, C, R, rows_in_smem != 0, smem_bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  const float4* bx = reinterpret_cast<const float4*>(boxes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows_in_smem)
    return launch<true>(bx, valid, keep, rows_global, B, N, thr, min_mode, C,
                        threads, smem_bytes, st);
  return launch<false>(bx, valid, keep, rows_global, B, N, thr, min_mode, C,
                       threads, smem_bytes, st);
}

// B clusters of C blocks of `threads` threads, each crossing `iters` cluster
// barriers: a measurement of the barrier K5's sweeps wait on, no part of it.
extern "C" int frp_nms_barrier_probe(int B, int C, int threads, int iters,
                                     void* stream) {
  if (B < 1 || C < 1 || C > MAX_CLUSTER || threads < 32 || threads > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  if (C > 8) {
    const cudaError_t rc = cudaFuncSetAttribute(
        barrier_probe_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B) * C, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t rc = cudaLaunchKernelEx(&cfg, barrier_probe_kernel, iters);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of C blocks of `threads` threads with `smem_bytes` of
// dynamic shared memory the card holds at once (cudaOccupancyMaxActive-
// Clusters), or minus a cudaError_t: what chip_smoke.py prints beside K5's
// geometry.
extern "C" int frp_nms_max_clusters(int C, int threads, int smem_bytes,
                                    int rows_in_smem) {
  const cudaError_t rc = rows_in_smem ? allow<true>(smem_bytes, C)
                                      : allow<false>(smem_bytes, C);
  if (rc != cudaSuccess) return -static_cast<int>(rc);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  const cudaError_t occ =
      rows_in_smem ? cudaOccupancyMaxActiveClusters(&n, nms_fixpoint_kernel<true>, &cfg)
                   : cudaOccupancyMaxActiveClusters(&n, nms_fixpoint_kernel<false>, &cfg);
  return occ == cudaSuccess ? n : -static_cast<int>(occ);
}
