// Streaming cosine top-k over float32 gallery rows (kernel K3 on float32
// rows).
//
// Replaces the float32-template case of facerecognitionpipeline_tpu/ops/
// pallas_gallery.py::_streaming_cosine_topk (its pl.pallas_call, which
// multiplies float32 rows in float32). The bf16 kernel (gallery_topk.cu)
// cannot take these rows: a tensor-core product would round them to bf16 or
// TF32, three decimal digits, where the reference keeps float32.
//
// Bound: at Q = 128, G = 1 048 576, D = 512 the rows are 2.15 GB (0.64 ms at
// 3.35 TB/s) against 2 * 128 * 2^20 * 512 FLOP (2.05 ms at the 67 TFLOP/s of
// float32 FMA on CUDA cores), so it is bound by operations. This first design
// is simple and right, not fast: it shares K3's tile order (block x of a
// query tile takes gallery tiles x, x + gridDim.x, ...; its two warpgroups
// take them in turn), its per-warpgroup top-k lists, threshold filter and
// fold (gallery_topk.cuh::fold_tile, so ties resolve the same way: value
// descending, index ascending) and its merge kernel. What takes the place of
// wgmma: the 64 queries of a block are staged once in shared memory; per
// K-panel of 32 floats a warpgroup copies the tile's 64 rows into its own
// buffer with plain 16-byte loads and every thread accumulates, with float32
// FMAs, the 32 scores the wgmma accumulator layout would give it (2 queries x
// 16 rows), while the warpgroup's next panel is already on its way into
// registers. No TMA ring, one panel in flight per warpgroup.
//
// Layouts: queries [Q, D] f32 (already unit rows), templates [G, D] f32, valid
// [G] bytes, part_v / part_i [Q, grid_x, list length] scratch, out_v [Q, k]
// f32, out_i [Q, k] int64.
#include "gallery_topk.cuh"

namespace frp {

constexpr int F32_QT = 64;       // queries per block
constexpr int F32_PANEL = 32;    // floats of depth per staged panel
constexpr int F32_ROW = 36;      // floats per staged gallery row (4 of padding)
constexpr int F32_THREADS = 256; // two warpgroups

// What fold_tile needs of the float32 kernel: one accumulator of float32
// scores, no row scale.
struct F32Traits {
  using Acc = float;
  static constexpr int ACCS = 1;
  static __device__ __forceinline__ float score(Acc s, float) { return s; }
};

// Shared memory: the queries [F32_QT][D + 4], the two warpgroups' panel
// buffers [2][TM][F32_ROW], their lists [2][F32_QT][k] (values, then
// indices), the thresholds [F32_QT], the tiles' valid bytes [2][TM].
// ops/gallery_kernel.py::gallery_launch_geometry computes the same sum.
inline size_t f32_smem_bytes(int D, int k) {
  return static_cast<size_t>(F32_QT) * (D + 4) * 4 +
         static_cast<size_t>(CONSUMER_WGS) * TM * F32_ROW * 4 +
         static_cast<size_t>(CONSUMER_WGS) * F32_QT * k * 8 + F32_QT * 4 +
         CONSUMER_WGS * TM;
}

__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
}

template <int KL>
__global__ void __launch_bounds__(F32_THREADS, 1)
    stream_topk_f32_kernel(const float* __restrict__ queries,
                           const float* __restrict__ gallery,
                           const unsigned char* __restrict__ valid,
                           float* __restrict__ part_v, int* __restrict__ part_i,
                           int Q, int G, int D) {
  constexpr int k = KL;
  extern __shared__ float4 smem_f4[];
  const int qstride = D + 4;
  float* qs = reinterpret_cast<float*>(smem_f4);
  float* bufs = qs + F32_QT * qstride;
  float* lv = bufs + CONSUMER_WGS * TM * F32_ROW;
  int* li = reinterpret_cast<int*>(lv + CONSUMER_WGS * F32_QT * k);
  float* thr = reinterpret_cast<float*>(li + CONSUMER_WGS * F32_QT * k);
  unsigned char* vbytes = reinterpret_cast<unsigned char*>(thr + F32_QT);

  const int q0 = blockIdx.y * F32_QT;
  const long long n_tiles = (static_cast<long long>(G) + TM - 1) / TM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wg = warp / 4;
  const int t = threadIdx.x % 128;

  // the queries; rows past Q are zeros
  const int q4 = D / 4;
  for (int p = threadIdx.x; p < F32_QT * q4; p += F32_THREADS) {
    const int r = p / q4, c = p % q4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < Q)
      v = reinterpret_cast<const float4*>(
          queries + static_cast<long long>(q0 + r) * D)[c];
    *reinterpret_cast<float4*>(qs + r * qstride + 4 * c) = v;
  }
  for (int p = threadIdx.x; p < CONSUMER_WGS * F32_QT * k; p += F32_THREADS) {
    lv[p] = NEG;
    li[p] = 0;
  }
  // a query row past Q is never offered anything
  if (threadIdx.x < F32_QT)
    thr[threadIdx.x] =
        (q0 + threadIdx.x < Q) ? NEG : __int_as_float(0x7f800000);
  __syncthreads();

  float* buf = bufs + wg * TM * F32_ROW;
  unsigned char* vb = vbytes + wg * TM;
  float* my_v = lv + wg * F32_QT * k;
  int* my_i = li + wg * F32_QT * k;
  const int qrow = 16 * (warp & 3) + (lane >> 2);  // its query rows: + 8 h
  const int cq = 2 * (lane & 3);  // its gallery rows of a tile: 8 j + cq + e
  float sc[16];
#pragma unroll
  for (int u = 0; u < 16; ++u) sc[u] = 1.0f;

  // A panel is 64 rows x 32 floats: four 16-byte loads per thread, rows
  // past G zeros (and invalid). The next panel of the warpgroup's sequence
  // (the next depth of this tile, else depth 0 of its next tile) is loaded
  // into registers while the current one is multiplied.
  float4 next[4];
  auto fetch = [&](long long tile, int p) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = t + 128 * u;
      const int r = e / 8, c = e % 8;
      const long long row = tile * TM + r;
      next[u] = row < G ? reinterpret_cast<const float4*>(
                              gallery + row * D + p * F32_PANEL)[c]
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  const int panels = D / F32_PANEL;
  long long tile = blockIdx.x + static_cast<long long>(wg) * gridDim.x;
  if (tile < n_tiles) fetch(tile, 0);
  for (; tile < n_tiles; tile += 2 * gridDim.x) {
    const long long row0 = tile * TM;
    float d[1][32];
#pragma unroll
    for (int u = 0; u < 32; ++u) d[0][u] = 0.0f;
    unsigned vmask = 0;  // bit 2 j + e: gallery row 8 j + cq + e is valid
    for (int p = 0; p < panels; ++p) {
      wg_sync(wg);  // the warpgroup is done with the buffer
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = t + 128 * u;
        *reinterpret_cast<float4*>(buf + (e / 8) * F32_ROW + 4 * (e % 8)) = next[u];
      }
      if (p == 0 && t < TM)
        vb[t] = row0 + t < G ? valid[row0 + t] : static_cast<unsigned char>(0);
      wg_sync(wg);  // the panel (and the valid bytes) have landed
      if (p + 1 < panels) {
        fetch(tile, p + 1);
      } else if (tile + 2 * gridDim.x < n_tiles) {
        fetch(tile + 2 * gridDim.x, 0);
      }
      if (p == 0) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            vmask |= (vb[8 * j + cq + e] != 0 ? 1u : 0u) << (2 * j + e);
      }
      const float* qa_row = qs + qrow * qstride + p * F32_PANEL;
      const float* qb_row = qa_row + 8 * qstride;
#pragma unroll
      for (int kk = 0; kk < F32_PANEL; kk += 4) {
        const float4 qa = *reinterpret_cast<const float4*>(qa_row + kk);
        const float4 qb = *reinterpret_cast<const float4*>(qb_row + kk);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float4 g = *reinterpret_cast<const float4*>(
                buf + (8 * j + cq + e) * F32_ROW + kk);
            float& sa = d[0][4 * j + e];
            float& sb = d[0][4 * j + e + 2];
            sa = __fmaf_rn(qa.x, g.x, sa);
            sa = __fmaf_rn(qa.y, g.y, sa);
            sa = __fmaf_rn(qa.z, g.z, sa);
            sa = __fmaf_rn(qa.w, g.w, sa);
            sb = __fmaf_rn(qb.x, g.x, sb);
            sb = __fmaf_rn(qb.y, g.y, sb);
            sb = __fmaf_rn(qb.z, g.z, sb);
            sb = __fmaf_rn(qb.w, g.w, sb);
          }
        }
      }
    }
    fold_tile<F32Traits, KL>(d, sc, vmask, thr, my_v, my_i, qrow,
                             static_cast<int>(row0) + cq, lane);
  }

  // the two warpgroups' lists of a query -> the block's list, in scratch
  __syncthreads();
  const int r = threadIdx.x;
  if (r < F32_QT && q0 + r < Q)
    write_block_list<KL>(
        lv, li, F32_QT, r, part_v, part_i,
        (static_cast<long long>(q0 + r) * gridDim.x + blockIdx.x) * k);
}

template <int KL>
cudaError_t launch_f32(const float* queries, const float* gallery,
                       const unsigned char* valid, float* part_v, int* part_i,
                       int Q, int G, int D, int grid_x, int smem_bytes,
                       cudaStream_t st) {
  const cudaError_t err = cudaFuncSetAttribute(
      stream_topk_f32_kernel<KL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return err;
  const int q_tiles = (Q + F32_QT - 1) / F32_QT;
  stream_topk_f32_kernel<KL><<<dim3(grid_x, q_tiles), F32_THREADS, smem_bytes,
                               st>>>(queries, gallery, valid, part_v, part_i,
                                     Q, G, D);
  return cudaGetLastError();
}

}  // namespace frp

// Query rows one block handles; the wrapper sizes the launch by it.
extern "C" int frp_gallery_topk_f32_qtile() { return frp::F32_QT; }

// Longest top-k the kernel supports.
extern "C" int frp_gallery_topk_f32_kmax() { return frp::KMAX; }

// Launches the stream kernel and the merge kernel on `stream`; returns 0 or
// the cudaError_t of the first failure. grid_x blocks share the gallery
// tiles of each query tile; part_v / part_i hold Q * grid_x *
// list_length(k) entries; smem_bytes comes from gallery_launch_geometry.
extern "C" int frp_gallery_topk_f32(const float* queries, const float* templates,
                                    const unsigned char* valid, float* part_v,
                                    int* part_i, float* out_v, long long* out_i,
                                    int Q, int G, int D, int k, int grid_x,
                                    int smem_bytes, void* stream) {
  if (Q <= 0 || G <= 0 || D <= 0 || D % frp::F32_PANEL != 0 || k < 1 ||
      k > frp::KMAX || grid_x < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int kl = frp::list_length(k);
  if (static_cast<size_t>(smem_bytes) != frp::f32_smem_bytes(D, kl))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define FRP_LAUNCH_F32(KL)                                                  \
  case KL:                                                                  \
    err = frp::launch_f32<KL>(queries, templates, valid, part_v, part_i, Q, \
                              G, D, grid_x, smem_bytes, st);                \
    break
  switch (kl) {
    FRP_LAUNCH_F32(1);
    FRP_LAUNCH_F32(2);
    FRP_LAUNCH_F32(3);
    FRP_LAUNCH_F32(4);
    FRP_LAUNCH_F32(8);
    FRP_LAUNCH_F32(16);
    FRP_LAUNCH_F32(32);
    FRP_LAUNCH_F32(64);
  }
#undef FRP_LAUNCH_F32
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(frp::launch_merge(part_v, part_i, out_v, out_i,
                                            nullptr, grid_x, kl, Q, k, st));
}
