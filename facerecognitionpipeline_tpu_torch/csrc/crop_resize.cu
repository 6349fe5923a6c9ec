// Batched bilinear crop+resize of boxes from shared frames (kernel K1).
//
// Replaces facerecognitionpipeline_tpu/ops/pallas_crop.py::_crop_resize_pallas
// (the pl.pallas_call behind crop_resize_pallas). The TPU kernel multiplies
// dense hat-weight matrices on the MXU with the frame resident in VMEM.
//
// What bounds it on an H100: bytes. A hat weight max(0, 1-|p-i|) has at most
// TWO non-zero taps per axis, so an output sample is a 4-tap gather of 12
// arithmetic operations, and a call moves 24-64 MB (float32 frames read,
// float32 crops written). The tensor cores are not the tool: the dense
// rows product alone would be ~9e10 operations for the O-net crops (768
// boxes x 2*48*640*1920), 0.09 ms at the card's bf16 peak, five times that
// call's byte bound of 0.018 ms. So the design is about instructions per
// byte and about how the bytes are asked for:
//   * grid = (box, band of output rows): 32-bit indices, the frame index
//     and the box are found once per block, not per pixel;
//   * the bilinear taps are separable, so a block computes them once: a
//     prologue fills two tables in shared memory, one entry per output
//     float of a row (source float offset of both column taps and their
//     bf16 weights) and one per output row of the band (source row offsets
//     and bf16 weights). That is K*C + rows coordinate chains (each with a
//     correctly rounded division) per block instead of one pair per pixel;
//   * one thread per output float, lanes on consecutive floats of an output
//     row (pixel-channel pairs): a warp's four tap loads then cover about a
//     third of the frame span that 32 whole pixels would, so each costs
//     about a third of the L1 lookups, and where the box is as large as the
//     crop (alignment stage A is an exact 128-pixel copy) a load is 128
//     contiguous bytes. A warp's store is 128 contiguous bytes. (Four
//     consecutive floats and one float4 store per thread was tried: fewer
//     instructions, but its loads fall four floats apart, and on an H100 it
//     was 1.3-1.7 times slower on the detector's downsampling crops and 9%
//     faster only on the stage-A copy, so it was dropped);
//   * a tap outside the frame, or one whose weight is exactly 0 (every
//     second tap of an integer-snapped window), is not loaded at all.
// The frame is not staged in shared memory: a block's source rows are read
// through L1/L2 directly (the frames of one call fit the 50 MB L2).
//
// Rounding points are the TPU kernel's, so results match it bit for bit
// (products of two bf16 values are exact in float32; each sum of two such
// products rounds once whatever its order):
//   frame and both hat weights rounded to bf16 (RNE);
//   row value = f32 sum of <=2 bf16 x bf16 products, then rounded to bf16;
//   output    = f32 sum of <=2 products with the column weights.
// Taps outside the frame carry weight 0: they add +-0 to a sum that starts
// at +0, exactly as the zero entries of a dense hat matrix do.
//
// Layouts: images [B,H,W,C] f32, boxes [B,N,4] f32 (x1,y1,x2,y2 in frame
// pixels), out [B,N,K,K,C] f32.
#include "common.cuh"

namespace {

// Both taps of one output coordinate: source offsets in floats (already
// multiplied by the stride of the axis, plus the channel for a column
// entry) and bf16-rounded weights. A tap outside the frame has weight 0
// and offset 0.
struct __align__(16) Taps {
  int o0, o1;
  float w0, w1;
};

// p = start + size * (o + 0.5) / K - 0.5, evaluated left to right, then
// the two hat taps around it.
__device__ __forceinline__ Taps make_taps(float start, float size, int o,
                                          float kf, int dim, int stride,
                                          int add) {
  const float f = __fdiv_rn(__fadd_rn(static_cast<float>(o), 0.5f), kf);
  const float p = __fsub_rn(__fadd_rn(start, __fmul_rn(size, f)), 0.5f);
  const int i0 = static_cast<int>(floorf(p));
  const int i1 = i0 + 1;
  const bool in0 = i0 >= 0 && i0 < dim;
  const bool in1 = i1 >= 0 && i1 < dim;
  Taps t;
  t.w0 = in0 ? frp::bf16_round(frp::hat(p, i0)) : 0.0f;
  t.w1 = in1 ? frp::bf16_round(frp::hat(p, i1)) : 0.0f;
  t.o0 = (in0 ? i0 : 0) * stride + add;
  t.o1 = (in1 ? i1 : 0) * stride + add;
  return t;
}

// One column tap of one output float: the two source rows combined with
// the row weights in float32, rounded to bf16.
__device__ __forceinline__ float rows_pass(const float* __restrict__ frame,
                                           const Taps& row, int col) {
  const float v0 =
      row.w0 != 0.0f ? frp::bf16_round(__ldg(frame + row.o0 + col)) : 0.0f;
  const float v1 =
      row.w1 != 0.0f ? frp::bf16_round(__ldg(frame + row.o1 + col)) : 0.0f;
  return frp::bf16_round(
      __fadd_rn(__fmul_rn(row.w0, v0), __fmul_rn(row.w1, v1)));
}

__global__ void __launch_bounds__(256)
    crop_resize_kernel(const float* __restrict__ images,
                       const float* __restrict__ boxes,
                       float* __restrict__ out, int H, int W, int C, int N,
                       int K, int band_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int kc = K * C;
  Taps* cols = reinterpret_cast<Taps*>(smem);  // [K*C], one per output float
  Taps* rows = cols + kc;                      // [band_rows]

  const int box = blockIdx.x;  // b * N + n
  const int oy0 = blockIdx.y * band_rows;
  const int nrows = min(band_rows, K - oy0);

  {
    const float* bp = boxes + static_cast<size_t>(box) * 4;
    const float x1 = bp[0], y1 = bp[1], x2 = bp[2], y2 = bp[3];
    const float bw = fmaxf(__fsub_rn(x2, x1), 1e-6f);
    const float bh = fmaxf(__fsub_rn(y2, y1), 1e-6f);
    const float kf = static_cast<float>(K);
    for (int e = threadIdx.x; e < kc + nrows; e += blockDim.x) {
      if (e < kc) {
        const int ox = e / C;
        cols[e] = make_taps(x1, bw, ox, kf, W, C, e - ox * C);
      } else {
        rows[e - kc] = make_taps(y1, bh, oy0 + e - kc, kf, H, W * C, 0);
      }
    }
  }
  __syncthreads();

  const float* frame =
      images + static_cast<size_t>(box / N) * H * W * C;
  float* dst = out + (static_cast<size_t>(box) * K + oy0) * kc;
  // The band as a row-major array of floats; a thread walks it with stride
  // blockDim.x, carrying (row, float in row) without dividing.
  const int dr = blockDim.x / kc;
  const int dv = blockDim.x - dr * kc;
  int r = threadIdx.x / kc;
  int v = threadIdx.x - r * kc;
  while (r < nrows) {
    const Taps row = rows[r];
    const Taps col = cols[v];
    const float a =
        col.w0 != 0.0f ? __fmul_rn(col.w0, rows_pass(frame, row, col.o0))
                       : 0.0f;
    const float b =
        col.w1 != 0.0f ? __fmul_rn(col.w1, rows_pass(frame, row, col.o1))
                       : 0.0f;
    dst[r * kc + v] = __fadd_rn(a, b);
    v += dv;
    r += dr;
    if (v >= kc) {
      v -= kc;
      ++r;
    }
  }
}

}  // namespace

// Launches on `stream` with the geometry the wrapper chose (see
// ops/crop_kernel.py::crop_launch_geometry): grid (B*N, bands), `threads`
// per block, `smem_bytes` of dynamic shared memory for the tap tables.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int frp_crop_resize(const float* images, const float* boxes,
                               float* out, int B, int H, int W, int C, int N,
                               int K, int band_rows, int threads,
                               int smem_bytes, void* stream) {
  auto* kernel = crop_resize_kernel;
  if (smem_bytes > 48 * 1024) {  // only crops far wider than any served
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const dim3 grid(static_cast<unsigned int>(B) * N,
                  (K + band_rows - 1) / band_rows);
  kernel<<<grid, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      images, boxes, out, H, W, C, N, K, band_rows);
  return static_cast<int>(cudaGetLastError());
}
