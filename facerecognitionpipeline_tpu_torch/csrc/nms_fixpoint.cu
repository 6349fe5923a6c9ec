// The fixpoint of greedy NMS over a score-sorted conflict mask (kernel K5).
//
// Replaces the jax.lax.while_loop of facerecognitionpipeline_tpu/ops/nms.py
// (nms_mask, the loop at its lines 71-96). On the TPU that loop stays on the
// device inside one jitted program. In eager PyTorch its condition was a host
// read per NMS call (three per serving step), which also kept the step out of
// a CUDA graph, since a graph cannot hold a host-side loop condition. No
// library call computes it.
//
// What it computes, per batch element (one block each):
//   keep_1 = sweep(v),  keep_{t+1} = sweep(keep_t)  for t < 7   (prologue)
//   it = 7;  while (it < N && keep != prev) { keep, prev = sweep(sweep(keep)),
//                                             keep;  it += 2 }
//   sweep(k)[i] = v[i] & !any_j(conflict[i, j] & k[j])
// the schedule of the plain loop (ops/nms_kernel.py::nms_fixpoint_plain),
// so the result is bit-equal to it, also where it stops at the it < N cap. A
// batch element stops at its own convergence; the plain loop sweeps the
// whole batch until its slowest element converges, and a converged element
// is a fixpoint, so the answers are the same.
//
// What bounds it on an H100: bytes. The conflict mask is N*N bytes per
// element (1.3 MB at stage 1's N = 1152) and each is read once; a sweep is
// N*N/64 AND-ORs of 32-bit words, a few thousand instructions per warp.
// Its design:
//   * the mask is strictly lower triangular (j < i: only a higher-ranked
//     box suppresses), so the prologue packs row i into ceil(i/32) words,
//     N*N/64 words in all: 124 KB at N = 1408 (stage 1 at min face 20),
//     which fits a block's shared memory where the square packing (248 KB)
//     does not. Larger N keep the packed rows in a device scratch buffer of
//     the wrapper's (a second instantiation of the kernel);
//   * the prologue reads the bytes with 16-byte loads where rows are
//     16-byte aligned (N % 16 == 0, as every cascade shape is), a lane per
//     32-byte word of a row, eight rows of a warp in flight at once;
//   * a sweep gives each warp whole 32-row words of the new keep mask: for
//     each of its 32 rows (unrolled, their loads in flight together) a lane
//     ANDs at most two words of the row with the keep mask it holds in
//     registers, keeps a per-row bit, and one OR reduction across the warp
//     makes the word. The keep masks (v, keep, prev, mid) are N/32 words
//     each in shared memory, a block-wide flag says whether the last sweep
//     changed anything;
//   * entries on or above the diagonal are never read (nms_mask builds them
//     false).
// Layouts: conflict [B,N,N] bool (bytes 0/1), valid [B,N] bool, keep [B,N]
// bool; all contiguous.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int PROLOGUE_SWEEPS = 7;
constexpr int PACK_ROWS = 8;  // rows a warp packs per pass

// Words of row i in the triangular packing (the bits j < i).
__device__ __forceinline__ int row_words(int i) { return (i + 31) >> 5; }

// First word of row i: the sum of row_words(t) over t < i.
__device__ __forceinline__ long long row_offset(long long i) {
  const long long m = i + 30, a = m >> 5;
  return 16 * a * (a - 1) + a * (m - 32 * a + 1);
}

// Four bytes, each 0 or not, -> four bits (byte t -> bit t).
__device__ __forceinline__ uint32_t nibble(uint32_t c) {
  return ((__vcmpne4(c, 0u) & 0x01010101u) * 0x01020408u) >> 24;
}

// Word w of row `row` (bytes of conflict row i): bit t = row[32w + t] != 0
// for 32w + t < i. `vec`: the row is 16-byte aligned and N % 16 == 0.
__device__ __forceinline__ uint32_t pack_word(const uint8_t* row, int w, int i,
                                              int N, bool vec) {
  const int j0 = w * 32;
  const int count = min(32, i - j0);
  uint32_t word = 0;
  if (vec && j0 + 32 <= N) {
    const uint4* p = reinterpret_cast<const uint4*>(row + j0);
    const uint4 a = __ldg(p), b = __ldg(p + 1);
    word = nibble(a.x) | nibble(a.y) << 4 | nibble(a.z) << 8 |
           nibble(a.w) << 12 | nibble(b.x) << 16 | nibble(b.y) << 20 |
           nibble(b.z) << 24 | nibble(b.w) << 28;
  } else {
    for (int t = 0; t < count; ++t) word |= (row[j0 + t] != 0 ? 1u : 0u) << t;
  }
  return count < 32 ? word & ((1u << count) - 1u) : word;
}

// dst = v & ~suppressed(src) for every row; where `cmp` is given, raise
// `changed` if dst differs from it anywhere. A warp takes word g of dst,
// rows 32g .. 32g+31 (row 32g has g words, the others g + 1), a lane two
// words of each row per 64-word chunk of the rows (one chunk while N <=
// 2048). The 32 rows are unrolled, so a lane's loads of all of them are in
// flight together: a sweep is bound by how many loads the warps keep in
// flight, not by one row's load-and-test chain.
__device__ __forceinline__ void sweep(const uint32_t* rows,
                                      const uint32_t* vbits,
                                      const uint32_t* src, uint32_t* dst,
                                      const uint32_t* cmp, int N, int W,
                                      int* changed) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int g = warp; g < W; g += WARPS) {
    const long long base = row_offset(32LL * g);
    uint32_t sup = 0;  // this lane's share: bit r if row 32g+r is suppressed
    for (int c = 0; c <= g; c += 64) {
      const int w0 = c + lane, w1 = c + 32 + lane;
      const uint32_t s0 = w0 < W ? src[w0] : 0u;
      const uint32_t s1 = w1 < W ? src[w1] : 0u;
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const int nw = 32 * g + r < N ? (r == 0 ? g : g + 1) : 0;
        const uint32_t* row = rows + base + (r == 0 ? 0 : g + (r - 1) * (g + 1));
        uint32_t acc = 0;
        if (w0 < nw) acc = row[w0] & s0;
        if (w1 < nw) acc |= row[w1] & s1;
        sup |= (acc != 0 ? 1u : 0u) << r;
      }
    }
    sup = __reduce_or_sync(0xffffffffu, sup);
    if (lane == 0) {
      const uint32_t word = vbits[g] & ~sup;
      dst[g] = word;
      if (cmp != nullptr && word != cmp[g]) *changed = 1;
    }
  }
}

// SMEM_ROWS: the packed rows in shared memory (addressed as such, so their
// loads are shared-memory loads), else in `rows_global`.
template <bool SMEM_ROWS>
__global__ void __launch_bounds__(THREADS)
    nms_fixpoint_kernel(const uint8_t* __restrict__ conflict,
                        const uint8_t* __restrict__ valid,
                        uint8_t* __restrict__ keep_out,
                        uint32_t* __restrict__ rows_global, int N, int vec) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ int changed;
  const int W = (N + 31) >> 5;
  const int b = blockIdx.x;
  uint32_t* vbits = smem;
  uint32_t* keep = vbits + W;
  uint32_t* prev = keep + W;
  uint32_t* spare = prev + W;
  uint32_t* rows;
  if constexpr (SMEM_ROWS) {
    rows = spare + W;
  } else {
    rows = rows_global + static_cast<long long>(b) * row_offset(N);
  }
  const uint8_t* cf = conflict + static_cast<size_t>(b) * N * N;
  const uint8_t* vv = valid + static_cast<size_t>(b) * N;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  if (threadIdx.x == 0) changed = 0;
  for (int w = warp; w < W; w += WARPS) {
    const int j = 32 * w + lane;
    const uint32_t word = __ballot_sync(0xffffffffu, j < N && vv[j] != 0);
    if (lane == 0) vbits[w] = word;
  }
  // pack the rows: a warp takes PACK_ROWS consecutive rows, a lane a word
  for (int i0 = PACK_ROWS * warp; i0 < N; i0 += PACK_ROWS * WARPS) {
    const int nw_max = row_words(min(i0 + PACK_ROWS - 1, N - 1));
    for (int w = lane; w < nw_max; w += 32) {
      uint32_t word[PACK_ROWS];
#pragma unroll
      for (int r = 0; r < PACK_ROWS; ++r) {
        const int i = i0 + r;
        word[r] = (i < N && w < row_words(i))
                      ? pack_word(cf + static_cast<size_t>(i) * N, w, i, N, vec != 0)
                      : 0u;
      }
#pragma unroll
      for (int r = 0; r < PACK_ROWS; ++r) {
        const int i = i0 + r;
        if (i < N && w < row_words(i)) rows[row_offset(i) + w] = word[r];
      }
    }
  }
  __syncthreads();

  // the prologue: seven sweeps; the last one says whether keep_7 != keep_6
  sweep(rows, vbits, vbits, keep, nullptr, N, W, &changed);
  __syncthreads();
  for (int t = 1; t < PROLOGUE_SWEEPS; ++t) {
    const bool last = t == PROLOGUE_SWEEPS - 1;
    sweep(rows, vbits, keep, spare, last ? keep : nullptr, N, W, &changed);
    __syncthreads();
    uint32_t* old_prev = prev;
    prev = keep;
    keep = spare;
    spare = old_prev;
  }
  // pairs of sweeps while it < N and the last check saw a change
  for (int it = PROLOGUE_SWEEPS; it < N; it += 2) {
    const bool go = changed != 0;
    __syncthreads();  // every thread has read the flag
    if (!go) break;
    if (threadIdx.x == 0) changed = 0;
    sweep(rows, vbits, keep, spare, nullptr, N, W, &changed);  // mid
    __syncthreads();
    sweep(rows, vbits, spare, prev, keep, N, W, &changed);  // new, vs keep
    __syncthreads();
    uint32_t* old_keep = keep;
    keep = prev;
    prev = old_keep;
  }
  for (int j = threadIdx.x; j < N; j += THREADS)
    keep_out[static_cast<size_t>(b) * N + j] =
        static_cast<uint8_t>((keep[j >> 5] >> (j & 31)) & 1u);
}

template <bool SMEM_ROWS>
int launch(const uint8_t* conflict, const uint8_t* valid, uint8_t* keep,
           uint32_t* rows_global, int B, int N, int vec, int smem_bytes,
           cudaStream_t stream) {
  auto* kernel = nms_fixpoint_kernel<SMEM_ROWS>;
  // asked for once per device and size, not on every launch
  constexpr int MAX_DEVICES = 64;
  static int granted[MAX_DEVICES] = {};
  if (smem_bytes > 48 * 1024) {
    int dev = -1;
    cudaError_t rc = cudaGetDevice(&dev);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    if (dev >= MAX_DEVICES || granted[dev] < smem_bytes) {
      rc = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
      if (rc != cudaSuccess) return static_cast<int>(rc);
      if (dev < MAX_DEVICES) granted[dev] = smem_bytes;
    }
  }
  kernel<<<B, THREADS, smem_bytes, stream>>>(conflict, valid, keep,
                                             rows_global, N, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches one block of 1024 threads per batch element on `stream`, with
// the geometry ops/nms_kernel.py::nms_launch_geometry chose: `smem_bytes`
// of dynamic shared memory (four keep masks of ceil(N/32) words, and the
// packed rows when `rows_in_smem`), `rows_global` a [B, rows] uint32 scratch
// buffer when they do not fit (else unused), `vec` = 1 when the rows are
// 16-byte aligned. Returns the cudaError_t of the launch (0 = success).
extern "C" int frp_nms_fixpoint(const uint8_t* conflict, const uint8_t* valid,
                                uint8_t* keep, uint32_t* rows_global, int B,
                                int N, int rows_in_smem, int vec,
                                int smem_bytes, void* stream) {
  if (B < 1 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (rows_in_smem)
    return launch<true>(conflict, valid, keep, rows_global, B, N, vec,
                        smem_bytes, static_cast<cudaStream_t>(stream));
  return launch<false>(conflict, valid, keep, rows_global, B, N, vec,
                       smem_bytes, static_cast<cudaStream_t>(stream));
}
