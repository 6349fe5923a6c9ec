// Streaming cosine top-k against a large gallery: the body shared by kernel
// K3 (bf16 templates, gallery_topk.cu) and kernel K4 (int8 codes,
// gallery_topk_int8.cu), and the kernel that merges their partial results.
//
// What is computed: for each of Q query rows, the `k` best of G gallery rows
// by (score descending, row index ascending), where a row's score is its dot
// product with the query and rows whose `valid` byte is 0 never compete.
// Slots that no valid row fills hold the sentinel (-1e9, index 0). The [Q, G]
// score matrix is never written to device memory, and the gallery is read
// from device memory once per query tile (once in all for K4 at Q <= 128).
//
// How, on this card: blocks run in no order and share nothing, so there is
// no running top-k carried along a sequential grid as on the TPU. Instead
//   * block (x, y) owns query tile y (QT rows, staged once in shared
//     memory) and every gridDim.x-th gallery tile of TN = 32 rows starting
//     at tile x. The gallery tiles stream through a two-deep shared-memory
//     ring filled with cp.async, so the next tile loads while this one is
//     multiplied;
//   * the 8 warps of the block multiply the tile on the tensor cores
//     (nvcuda::wmma 16x16x16) into a [QT, TN] score tile in shared memory;
//   * each warp then folds the tile into the running top-KMAX lists of the
//     query rows it owns (lists in shared memory for the whole kernel): lane
//     = gallery row of the tile, one ballot finds the few scores that beat
//     the row's current KMAX-th, and lane 0 inserts them. The tile's valid
//     bytes (and row scales) ride in the same cp.async ring as its rows;
//   * at the end each block writes its lists to a [gridDim.x, Qpad, KMAX]
//     scratch tensor, and `merge_topk_kernel` folds the gridDim.x lists of a
//     query into the final [Q, k].
// Every comparison uses the same strict total order (value descending, then
// index ascending; gallery indices are unique), so the result does not
// depend on the order the blocks ran in, and ties go to the lower index. No
// atomics anywhere.
#pragma once

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace frp {

constexpr int KMAX = 8;        // longest top-k list the kernels keep
constexpr int TN = 32;         // gallery rows per tile
constexpr int THREADS = 256;   // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int SLD = TN + 4;    // score-tile row stride (wmma wants 16 bytes)
constexpr float NEG = -1e9f;   // score of a masked row, and the sentinel

// A running top-KMAX list, best first: values v[KMAX] and indices i[KMAX],
// in shared memory (the stream kernel) or in a thread's own arrays (the
// merge kernel, where the unrolled loops keep them in registers).
__device__ __forceinline__ bool before(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

__device__ __forceinline__ void topk_init(float* v, int* i) {
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    v[j] = NEG;
    i[j] = 0;
  }
}

// Insert (cv, ci): it takes the first slot it precedes, and the entry it
// displaces moves on down the list the same way. A candidate that precedes
// nothing leaves the list as it was.
__device__ __forceinline__ void topk_insert(float* v, int* i, float cv,
                                            int ci) {
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    if (before(cv, ci, v[j], i[j])) {
      const float tv = v[j];
      const int ti = i[j];
      v[j] = cv;
      i[j] = ci;
      cv = tv;
      ci = ti;
    }
  }
}

// Traits of kernel K3: float32 unit queries against bf16 rows. The query is
// split as q = hi + lo + r with hi = bf16(q), lo = bf16(q - hi), |r| <=
// 2^-17 |q|, and both products accumulate into one float32 accumulator, so
// the score is that of the float32 query to ~1e-6 (a bf16 x bf16 product is
// exact in float32).
struct Bf16Traits {
  using T = __nv_bfloat16;   // shared-memory operand type
  using Acc = float;
  using QIn = float;         // query type in device memory
  static constexpr int QT = 64;
  static constexpr int NSPLIT = 2;

  static __device__ __forceinline__ void stage_query(const QIn* src, T* dst,
                                                     int split_stride) {
    const float q = src ? *src : 0.0f;
    const T hi = __float2bfloat16_rn(q);
    dst[0] = hi;
    dst[split_stride] = __float2bfloat16_rn(q - __bfloat162float(hi));
  }

  static __device__ __forceinline__ float score(Acc s, float) { return s; }
};

// Traits of kernel K4: int8 query codes against int8 row codes. The dot is
// an exact s8 x s8 -> s32 tensor-core product (|dot| <= 512 * 127^2 < 2^24,
// so its float32 conversion is exact too) and is multiplied by the row's
// dequantisation scale: one rounding in all.
struct Int8Traits {
  using T = signed char;
  using Acc = int;
  using QIn = signed char;
  static constexpr int QT = 128;
  static constexpr int NSPLIT = 1;

  static __device__ __forceinline__ void stage_query(const QIn* src, T* dst,
                                                     int) {
    dst[0] = src ? *src : static_cast<signed char>(0);
  }

  static __device__ __forceinline__ float score(Acc s, float scale) {
    return __fmul_rn(__int2float_rn(s), scale);
  }
};

template <typename Tr>
struct Layout {
  using T = typename Tr::T;
  using Acc = typename Tr::Acc;
  static constexpr int PAD = 16 / sizeof(T);  // 16 bytes: no bank conflicts
  static constexpr int NQB = Tr::QT / 16;     // 16-row query blocks
  static constexpr int KH = WARPS / NQB;      // warps splitting the depth
  static_assert(NQB * KH == WARPS && KH >= 1, "8 warps must tile QT x depth");

  static __host__ __device__ size_t q_elems(int D) {
    return static_cast<size_t>(Tr::NSPLIT) * Tr::QT * (D + PAD);
  }
  static __host__ __device__ size_t g_elems(int D) {
    return static_cast<size_t>(2) * TN * (D + PAD);
  }
  static __host__ __device__ size_t s_elems() {
    return static_cast<size_t>(KH) * Tr::QT * SLD;
  }
  // operands, score tile, the lists, and per ring slot TN scales + TN valid
  static __host__ __device__ size_t smem_bytes(int D) {
    return (q_elems(D) + g_elems(D)) * sizeof(T) + s_elems() * sizeof(Acc) +
           static_cast<size_t>(Tr::QT) * KMAX * (sizeof(float) + sizeof(int)) +
           2 * TN * (sizeof(float) + 1);
  }
};

// Start the asynchronous copy of gallery tile `tile` into ring slot `dst`
// ([TN, D + PAD]) with its scales and valid bytes; rows past G are zeroed
// and invalid.
template <typename T>
__device__ __forceinline__ void load_tile(
    const T* __restrict__ gallery, const float* __restrict__ scales,
    const unsigned char* __restrict__ valid, T* dst, float* sdst,
    unsigned char* vdst, long long tile, int G, int D, int ld) {
  const int per_row = D * static_cast<int>(sizeof(T)) / 16;  // 16-byte pieces
  const long long row0 = tile * TN;
  for (int p = threadIdx.x; p < TN * per_row; p += THREADS) {
    const int r = p / per_row;
    const int c = (p % per_row) * (16 / static_cast<int>(sizeof(T)));
    T* d = dst + r * ld + c;
    if (row0 + r < G) {
      __pipeline_memcpy_async(d, gallery + (row0 + r) * D + c, 16);
    } else {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  const int t = threadIdx.x;
  if (row0 + TN <= G) {
    if (t < TN / 16) {
      __pipeline_memcpy_async(vdst + t * 16, valid + row0 + t * 16, 16);
    } else if (scales != nullptr && t < TN / 16 + TN / 4) {
      const int c = (t - TN / 16) * 4;
      __pipeline_memcpy_async(sdst + c, scales + row0 + c, 16);
    }
  } else if (t < TN) {  // the ragged last tile
    const bool in = row0 + t < G;
    vdst[t] = in ? valid[row0 + t] : static_cast<unsigned char>(0);
    if (scales != nullptr) sdst[t] = in ? scales[row0 + t] : 0.0f;
  }
}

// queries [Q, D] (Tr::QIn), gallery [G, D] (Tr::T), scales [G] or null,
// valid [G] bytes -> part_v / part_i [gridDim.x, gridDim.y * QT, KMAX].
// D % 32 == 0; gallery, scales and valid 16-byte aligned.
template <typename Tr>
__global__ void __launch_bounds__(THREADS, 1)
    stream_topk_kernel(const typename Tr::QIn* __restrict__ queries,
                       const typename Tr::T* __restrict__ gallery,
                       const float* __restrict__ scales,
                       const unsigned char* __restrict__ valid,
                       float* __restrict__ part_v, int* __restrict__ part_i,
                       int Q, int G, int D) {
  using namespace nvcuda;
  using L = Layout<Tr>;
  using T = typename Tr::T;
  using Acc = typename Tr::Acc;
  constexpr int QT = Tr::QT;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int ld = D + L::PAD;
  T* qs = reinterpret_cast<T*>(smem_raw);             // [NSPLIT, QT, ld]
  T* gs = qs + L::q_elems(D);                         // [2, TN, ld]
  Acc* ss = reinterpret_cast<Acc*>(gs + L::g_elems(D));  // [KH, QT, SLD]
  float* tv = reinterpret_cast<float*>(ss + L::s_elems());  // [QT, KMAX]
  int* ti = reinterpret_cast<int*>(tv + QT * KMAX);         // [QT, KMAX]
  float* scs = reinterpret_cast<float*>(ti + QT * KMAX);    // [2, TN]
  unsigned char* vs = reinterpret_cast<unsigned char*>(scs + 2 * TN);  // [2, TN]

  const int q0 = blockIdx.y * QT;
  const long long n_tiles = (static_cast<long long>(G) + TN - 1) / TN;

  // first tile on its way, then the queries
  long long tile = blockIdx.x;
  if (tile < n_tiles)
    load_tile<T>(gallery, scales, valid, gs, scs, vs, tile, G, D, ld);
  __pipeline_commit();
  for (int p = threadIdx.x; p < QT * D; p += THREADS) {
    const int r = p / D, c = p % D;
    const typename Tr::QIn* src =
        (q0 + r < Q) ? queries + static_cast<long long>(q0 + r) * D + c
                     : nullptr;
    Tr::stage_query(src, qs + r * ld + c, QT * ld);
  }

  if (threadIdx.x < QT)
    topk_init(tv + threadIdx.x * KMAX, ti + threadIdx.x * KMAX);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int qb = warp % L::NQB;   // this warp's 16 query rows
  const int kh = warp / L::NQB;   // and its share of the depth
  const int ksteps = D / 16 / L::KH;

  int buf = 0;
  for (; tile < n_tiles; tile += gridDim.x, buf ^= 1) {
    const long long next = tile + gridDim.x;
    if (next < n_tiles)
      load_tile<T>(gallery, scales, valid, gs + (buf ^ 1) * TN * ld,
                   scs + (buf ^ 1) * TN, vs + (buf ^ 1) * TN, next, G, D, ld);
    __pipeline_commit();
    __pipeline_wait_prior(1);  // all but the copy just started: this tile
    __syncthreads();

    const T* gt = gs + buf * TN * ld;
    wmma::fragment<wmma::accumulator, 16, 16, 16, Acc> acc[TN / 16];
#pragma unroll
    for (int j = 0; j < TN / 16; ++j) wmma::fill_fragment(acc[j], static_cast<Acc>(0));
    for (int ks = kh * ksteps; ks < (kh + 1) * ksteps; ++ks) {
      const int k0 = ks * 16;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major>
          b[TN / 16];
#pragma unroll
      for (int j = 0; j < TN / 16; ++j)
        wmma::load_matrix_sync(b[j], gt + j * 16 * ld + k0, ld);
#pragma unroll
      for (int s = 0; s < Tr::NSPLIT; ++s) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
        wmma::load_matrix_sync(a, qs + (s * QT + qb * 16) * ld + k0, ld);
#pragma unroll
        for (int j = 0; j < TN / 16; ++j)
          wmma::mma_sync(acc[j], a, b[j], acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < TN / 16; ++j)
      wmma::store_matrix_sync(ss + (kh * QT + qb * 16) * SLD + j * 16, acc[j],
                              SLD, wmma::mem_row_major);
    __syncthreads();

    // warp w folds the tile into the lists of rows w, w + 8, ...: lane =
    // gallery row of the tile. A new row has a higher index than every
    // listed one, so only a strictly greater score can enter.
    static_assert(TN == 32, "one lane per gallery row of the tile");
    {
      const bool row_ok = vs[buf * TN + lane] != 0;
      const float scale = scales != nullptr ? scs[buf * TN + lane] : 1.0f;
      const int base = static_cast<int>(tile * TN);
      for (int r = warp; r < QT && q0 + r < Q; r += WARPS) {
        Acc s = ss[r * SLD + lane];
#pragma unroll
        for (int h = 1; h < L::KH; ++h) s += ss[(h * QT + r) * SLD + lane];
        const float v = Tr::score(s, scale);
        unsigned m = __ballot_sync(0xffffffffu,
                                   row_ok && v > tv[r * KMAX + KMAX - 1]);
        while (m != 0) {
          const int src = __ffs(m) - 1;
          m &= m - 1;
          const float cv = __shfl_sync(0xffffffffu, v, src);
          if (lane == 0)
            topk_insert(tv + r * KMAX, ti + r * KMAX, cv, base + src);
        }
      }
    }
    __syncthreads();  // the score tile and this ring slot are free again
  }
  __pipeline_wait_prior(0);
  __syncthreads();  // a block without tiles reaches here with fresh lists

  for (int p = threadIdx.x; p < QT * KMAX; p += THREADS) {
    const long long at =
        (static_cast<long long>(blockIdx.x) * gridDim.y * QT + q0) * KMAX + p;
    part_v[at] = tv[p];
    part_i[at] = ti[p];
  }
}

// part_v / part_i [n_parts, q_pad, KMAX], each list best first ->
// out_v / out_i [Q, k]; one thread per query.
__global__ void merge_topk_kernel(const float* __restrict__ part_v,
                                  const int* __restrict__ part_i,
                                  float* __restrict__ out_v,
                                  int* __restrict__ out_i, int n_parts,
                                  int q_pad, int Q, int k) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= Q) return;
  float tv[KMAX];
  int ti[KMAX];
  topk_init(tv, ti);
  for (int p = 0; p < n_parts; ++p) {
    const long long row = static_cast<long long>(p) * q_pad + q;
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      const float v = part_v[row * KMAX + j];
      const int i = part_i[row * KMAX + j];
      if (!before(v, i, tv[KMAX - 1], ti[KMAX - 1])) break;  // sorted list
      topk_insert(tv, ti, v, i);
    }
  }
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    if (j < k) {
      out_v[static_cast<long long>(q) * k + j] = tv[j];
      out_i[static_cast<long long>(q) * k + j] = ti[j];
    }
  }
}

// Launch both kernels on `stream`. grid_x blocks share the gallery tiles of
// each query tile; part_v / part_i hold grid_x * q_tiles * QT * KMAX
// entries. Returns the cudaError_t of the first failure (0 = success).
template <typename Tr>
int launch_stream_topk(const typename Tr::QIn* queries,
                       const typename Tr::T* gallery, const float* scales,
                       const unsigned char* valid, float* part_v, int* part_i,
                       float* out_v, int* out_i, int Q, int G, int D, int k,
                       int grid_x, void* stream) {
  if (Q <= 0 || G <= 0 || D <= 0 || D % 32 != 0 || k < 1 || k > KMAX ||
      grid_x < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = Layout<Tr>::smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      stream_topk_kernel<Tr>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int q_tiles = (Q + Tr::QT - 1) / Tr::QT;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  stream_topk_kernel<Tr><<<dim3(grid_x, q_tiles), THREADS, smem, st>>>(
      queries, gallery, scales, valid, part_v, part_i, Q, G, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_topk_kernel<<<(Q + 127) / 128, 128, 0, st>>>(
      part_v, part_i, out_v, out_i, grid_x, q_tiles * Tr::QT, Q, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace frp
