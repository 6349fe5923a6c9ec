// Stage-B affine warp of per-face patches to aligned faces (kernel K2).
//
// Replaces facerecognitionpipeline_tpu/ops/pallas_warp.py::_warp_patches_affine
// (the pl.pallas_call behind warp_patches_affine). The TPU kernel builds
// dense hat matrices per output tile and contracts them on the MXU with the
// patch resident in VMEM.
//
// What bounds it on an H100: bytes. A hat weight has at most two non-zero
// taps per axis, so an output float is a 4-tap gather of about 12 arithmetic
// operations, while a serving call moves 44 MB (128 float32 patches read, 128
// float32 faces written). Dense hat-matrix products on the tensor cores
// would spend hundreds of operations per output float to save none of those
// bytes. So the design is about instructions per byte and about how the
// bytes are asked for:
//   * one face per block, and the whole patch in shared memory: a
//     128x128x3 float32 patch is 196 608 contiguous bytes, under the 227 KB
//     a block may use. One thread asks for it with Hopper's bulk
//     asynchronous copy (cp.async.bulk, global -> shared), in 16 KB chunks
//     that each complete on an mbarrier of their own; the other threads
//     spend no instruction on the copy. 128 faces are one wave on 132 SMs:
//     every patch byte leaves device memory once, and every tap is a
//     shared-memory read;
//   * output pixels whose source chunks have arrived are computed while the
//     later chunks are still in flight: a thread waits only on the barriers
//     of the chunks its taps fall in, and remembers in a register mask
//     which chunks it has already seen complete;
//   * the six coefficients are read once per block, all indices are 32 bit;
//   * one thread per output pixel, all channels, lanes on neighbouring
//     pixels: the coordinates and the four weights are computed once per
//     pixel, and a warp's shared-memory reads fall C words apart (no bank
//     conflicts at C = 3). A thread that owned four consecutive output
//     floats instead would read 4-5 words apart (4-way conflicts) and
//     compute most pixels' coordinates twice;
//   * stores are 16 bytes wide all the same: a warp puts its 32 pixels (32*C
//     consecutive output floats) into a small staging buffer of its own in
//     shared memory and writes them out as float4, 384 contiguous bytes per
//     instruction at C = 3 (`vec` = 4). Where a face's float count is not a
//     multiple of 4 the threads store their floats directly (`vec` = 1).
// The bulk copy needs a patch whose address and byte count are multiples of
// 16; the wrapper refuses any other.
// The rotation makes the coordinates non-separable, so they stay per pixel
// (4 multiplies, 4 adds).
//
// Per output pixel (x, y) of face n, with six coefficients a0..a2, b0..b2:
//   px = a0*x + a1*y + a2,  py = b0*x + b1*y + b2   (no FMA contraction)
//   wu = bf16(max(0, 1-|px-u|)),  wy = max(0, 1-|py-v|) kept float32
//   row(v) = f32 sum over u of bf16(P[v,u,c]) * wu   (exact products; kept f32)
//   out    = f32 sum over v of round(row(v) * wy)
// which are the TPU kernel's rounding points (its rows matmul has bf16
// operands and f32 accumulation, and its column pass multiplies then sums).
// A tap outside the patch carries weight 0 (its index is clamped to 0): it
// adds +-0, as the zero entries of a dense hat matrix do.
//
// Layouts: patches [N,K,K,C] f32, coeffs [N,6] f32, out [N,OH,OW,C] f32, or
// [N,C,OH,OW] f32 channel-planar (the TPU kernel's native layout).
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int MAX_CHUNKS = 32;       // one bit each in a thread's mask
constexpr int CHUNK_LOG2 = 12;       // 4096 floats = 16 KB per bulk copy
constexpr int CHUNK_FLOATS = 1 << CHUNK_LOG2;
constexpr int BARRIER_BYTES = MAX_CHUNKS * 8;  // patch follows, 16-aligned

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// Bulk asynchronous copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from global to shared memory; completion is counted on `bar`.
__device__ __forceinline__ void bulk_copy_g2s(uint32_t dst, const void* src,
                                              uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Wait until phase 0 of `bar` has completed (each barrier is used once).
__device__ __forceinline__ void mbar_wait_phase0(uint32_t bar) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(0u)
        : "memory");
  } while (!done);
}

// The taps of one output pixel: clamped patch offsets (in floats, channel
// 0) of the four corners and the weights. Outside taps have weight 0.
struct PixelTaps {
  int o00, o01, o10, o11;  // (v0,u0) (v0,u1) (v1,u0) (v1,u1)
  float wu0, wu1, wy0, wy1;
};

__device__ __forceinline__ PixelTaps pixel_taps(const float* cf, int x, int y,
                                                int K, int C) {
  const float fx = static_cast<float>(x), fy = static_cast<float>(y);
  const float px =
      __fadd_rn(__fadd_rn(__fmul_rn(cf[0], fx), __fmul_rn(cf[1], fy)), cf[2]);
  const float py =
      __fadd_rn(__fadd_rn(__fmul_rn(cf[3], fx), __fmul_rn(cf[4], fy)), cf[5]);
  const int u0 = static_cast<int>(floorf(px)), u1 = u0 + 1;
  const int v0 = static_cast<int>(floorf(py)), v1 = v0 + 1;
  const bool iu0 = u0 >= 0 && u0 < K, iu1 = u1 >= 0 && u1 < K;
  const bool iv0 = v0 >= 0 && v0 < K, iv1 = v1 >= 0 && v1 < K;
  PixelTaps t;
  t.wu0 = iu0 ? frp::bf16_round(frp::hat(px, u0)) : 0.0f;
  t.wu1 = iu1 ? frp::bf16_round(frp::hat(px, u1)) : 0.0f;
  t.wy0 = iv0 ? frp::hat(py, v0) : 0.0f;
  t.wy1 = iv1 ? frp::hat(py, v1) : 0.0f;
  const int cu0 = iu0 ? u0 : 0, cu1 = iu1 ? u1 : 0;
  const int rv0 = (iv0 ? v0 : 0) * K, rv1 = (iv1 ? v1 : 0) * K;
  t.o00 = (rv0 + cu0) * C;
  t.o01 = (rv0 + cu1) * C;
  t.o10 = (rv1 + cu0) * C;
  t.o11 = (rv1 + cu1) * C;
  return t;
}

// How the faces are stored: STORE_DIRECT and STORE_STAGED write
// [N,OH,OW,C] (each thread its own floats, or a warp's 32 pixels through
// its staging buffer as float4 stores); STORE_PLANAR writes the
// channel-planar [N,C,OH,OW] of warp_patches_affine(planar=True), where
// each channel of a warp's 32 pixels is already 128 contiguous bytes.
constexpr int STORE_DIRECT = 0;
constexpr int STORE_STAGED = 1;
constexpr int STORE_PLANAR = 2;

template <int STORE>
__global__ void __launch_bounds__(1024)
    warp_patches_kernel(const float* __restrict__ patches,
                        const float* __restrict__ coeffs,
                        float* __restrict__ out, int K, int C, int OH,
                        int OW) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* patch = reinterpret_cast<float*>(smem + BARRIER_BYTES);
  __shared__ float cf[6];

  const int n = blockIdx.x;
  const int patch_floats = K * K * C;
  const int n_chunks = (patch_floats + CHUNK_FLOATS - 1) >> CHUNK_LOG2;
  const float* src = patches + static_cast<size_t>(n) * patch_floats;
  const int lane = threadIdx.x & 31;
  // staging: 32*C floats per warp, after the patch
  float* stage = patch + patch_floats + (threadIdx.x >> 5) * 32 * C;

  if (threadIdx.x < 6) cf[threadIdx.x] = coeffs[n * 6 + threadIdx.x];
  if (threadIdx.x == 0) {
    for (int i = 0; i < n_chunks; ++i) mbar_init(smem_addr(bars + i), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 0; i < n_chunks; ++i) {
      const int floats = min(CHUNK_FLOATS, patch_floats - (i << CHUNK_LOG2));
      const uint32_t bar = smem_addr(bars + i);
      mbar_expect_tx(bar, floats * 4);
      bulk_copy_g2s(smem_addr(patch + (i << CHUNK_LOG2)),
                    src + (i << CHUNK_LOG2), floats * 4, bar);
    }
  }
  uint32_t ready = 0;  // bit i: chunk i is known to have arrived

  const int total = OH * OW;  // pixels of the face, row-major
  float* dst = out + static_cast<size_t>(n) * total * C;
  // A warp takes 32 consecutive pixels, the block blockDim.x, then the
  // next blockDim.x; (x, y) is carried along without dividing.
  const int sy = blockDim.x / OW;
  const int sx = blockDim.x - sy * OW;
  int y = threadIdx.x / OW;
  int x = threadIdx.x - y * OW;
  for (int base = threadIdx.x - lane; base < total; base += blockDim.x) {
    const int p = base + lane;
    if (p < total) {
      const PixelTaps t = pixel_taps(cf, x, y, K, C);
      // wait for the chunks that hold this pixel's taps, all channels
      const int lo = min(min(t.o00, t.o01), min(t.o10, t.o11)) >> CHUNK_LOG2;
      const int hi =
          (max(max(t.o00, t.o01), max(t.o10, t.o11)) + C - 1) >> CHUNK_LOG2;
      for (int i = lo; i <= hi; ++i) {
        if (!((ready >> i) & 1u)) {
          mbar_wait_phase0(smem_addr(bars + i));
          ready |= 1u << i;
        }
      }
      for (int ch = 0; ch < C; ++ch) {
        const float r0 = __fadd_rn(
            __fmul_rn(frp::bf16_round(patch[t.o00 + ch]), t.wu0),
            __fmul_rn(frp::bf16_round(patch[t.o01 + ch]), t.wu1));
        const float r1 = __fadd_rn(
            __fmul_rn(frp::bf16_round(patch[t.o10 + ch]), t.wu0),
            __fmul_rn(frp::bf16_round(patch[t.o11 + ch]), t.wu1));
        const float res =
            __fadd_rn(__fmul_rn(r0, t.wy0), __fmul_rn(r1, t.wy1));
        if constexpr (STORE == STORE_STAGED) {
          stage[lane * C + ch] = res;
        } else if constexpr (STORE == STORE_PLANAR) {
          dst[ch * total + p] = res;
        } else {
          dst[p * C + ch] = res;
        }
      }
    }
    if constexpr (STORE == STORE_STAGED) {
      __syncwarp();
      // the warp's pixels [base, base + 32) are 32*C contiguous floats
      const int n4 = (min(32, total - base) * C) >> 2;
      const float4* s4 = reinterpret_cast<const float4*>(stage);
      float4* d4 = reinterpret_cast<float4*>(dst + base * C);
      for (int q = lane; q < n4; q += 32) d4[q] = s4[q];
      __syncwarp();
    }
    x += sx;
    y += sy;
    if (x >= OW) {
      x -= OW;
      ++y;
    }
  }
  // no block may exit with a copy into its shared memory in flight
  if (threadIdx.x == 0) {
    for (int i = 0; i < n_chunks; ++i)
      if (!((ready >> i) & 1u)) mbar_wait_phase0(smem_addr(bars + i));
  }
}

template <int STORE>
int launch(const float* patches, const float* coeffs, float* out, int N, int K,
           int C, int OH, int OW, int threads, int smem_bytes,
           cudaStream_t stream) {
  auto* kernel = warp_patches_kernel<STORE>;
  // The serving patch is over the 48 KB a kernel gets unasked. The larger
  // limit is asked for once per device and size, not on every launch.
  constexpr int MAX_DEVICES = 64;
  static int granted[MAX_DEVICES] = {};  // bytes this instance may use
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
  kernel<<<N, threads, smem_bytes, stream>>>(patches, coeffs, out, K, C, OH,
                                             OW);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` with the geometry the wrapper chose (see
// ops/warp_kernel.py::warp_launch_geometry): one block of `threads` (a
// multiple of 32) per face; `vec` = 4 for float4 stores through the warps'
// staging buffers (needs OH*OW*C % 4 == 0 and a 16-byte aligned `out`), 1
// for direct stores; `planar` = 1 for channel-planar out [N,C,OH,OW] (direct
// stores, `vec` ignored); `patches` 16-byte aligned with K*K*C % 4 == 0 (the
// bulk copy's rule); `smem_bytes` = 256 barrier bytes + the patch +
// threads*C*4 staging bytes when `vec` = 4. The wrapper refuses a patch of
// more than 32 chunks or more shared memory than a block may use. Returns
// the cudaError_t of the launch (0 = success).
extern "C" int frp_warp_patches(const float* patches, const float* coeffs,
                                float* out, int N, int K, int C, int OH,
                                int OW, int threads, int vec, int planar,
                                int smem_bytes, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (planar)
    return launch<STORE_PLANAR>(patches, coeffs, out, N, K, C, OH, OW,
                                threads, smem_bytes, s);
  if (vec == 4)
    return launch<STORE_STAGED>(patches, coeffs, out, N, K, C, OH, OW,
                                threads, smem_bytes, s);
  return launch<STORE_DIRECT>(patches, coeffs, out, N, K, C, OH, OW, threads,
                              smem_bytes, s);
}
