// Batched bilinear crop+resize of boxes from shared frames (kernel K1).
//
// Replaces facerecognitionpipeline_tpu/ops/pallas_crop.py::_crop_resize_pallas
// (the pl.pallas_call behind crop_resize_pallas). The TPU kernel multiplies
// dense hat-weight matrices on the MXU with the frame resident in VMEM. A
// hat weight max(0, 1-|p-i|) has at most TWO non-zero taps per axis, so here
// each output sample is a 4-tap gather: one thread per output pixel of one
// box, all channels, nothing staged in shared memory (a 640x640 frame does
// not fit in 227 KB anyway). The kernel is bound by device-memory bytes:
// one read of the float32 frames and one write of the float32 crops.
//
// Rounding points are the TPU kernel's, so results match it bit for bit
// (products of two bf16 values are exact in float32; each sum of two such
// products rounds once whatever its order):
//   frame and both hat weights rounded to bf16 (RNE);
//   row value = f32 sum of <=2 bf16 x bf16 products, then rounded to bf16;
//   output    = f32 sum of <=2 products with the column weights.
// Taps outside the frame contribute nothing (zero outside the frame).
//
// Layouts: images [B,H,W,C] f32, boxes [B,N,4] f32 (x1,y1,x2,y2 in frame
// pixels), out [B,N,K,K,C] f32.
#include "common.cuh"

namespace {

__global__ void crop_resize_kernel(const float* __restrict__ images,
                                   const float* __restrict__ boxes,
                                   float* __restrict__ out, int B, int H,
                                   int W, int C, int N, int K) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long total = static_cast<long long>(B) * N * K * K;
  if (idx >= total) return;
  const int ox = static_cast<int>(idx % K);
  long long t = idx / K;
  const int oy = static_cast<int>(t % K);
  t /= K;  // = b * N + n
  const int b = static_cast<int>(t / N);

  const float* box = boxes + t * 4;
  const float x1 = box[0], y1 = box[1], x2 = box[2], y2 = box[3];
  const float bw = fmaxf(__fsub_rn(x2, x1), 1e-6f);
  const float bh = fmaxf(__fsub_rn(y2, y1), 1e-6f);
  const float kf = static_cast<float>(K);
  // p = start + size * (o + 0.5) / K - 0.5, evaluated left to right.
  const float fy = __fdiv_rn(__fadd_rn(static_cast<float>(oy), 0.5f), kf);
  const float fx = __fdiv_rn(__fadd_rn(static_cast<float>(ox), 0.5f), kf);
  const float py = __fsub_rn(__fadd_rn(y1, __fmul_rn(bh, fy)), 0.5f);
  const float px = __fsub_rn(__fadd_rn(x1, __fmul_rn(bw, fx)), 0.5f);

  const int r0 = static_cast<int>(floorf(py));
  const int c0 = static_cast<int>(floorf(px));
  int rows[2], cols[2];
  float wy[2], wx[2];
  int nr = 0, nc = 0;
  for (int d = 0; d < 2; ++d) {
    const int r = r0 + d;
    if (r >= 0 && r < H) {
      rows[nr] = r;
      wy[nr] = frp::bf16_round(frp::hat(py, r));
      ++nr;
    }
    const int c = c0 + d;
    if (c >= 0 && c < W) {
      cols[nc] = c;
      wx[nc] = frp::bf16_round(frp::hat(px, c));
      ++nc;
    }
  }

  const float* frame = images + static_cast<long long>(b) * H * W * C;
  float* dst = out + idx * C;
  for (int ch = 0; ch < C; ++ch) {
    float acc = 0.0f;
    for (int j = 0; j < nc; ++j) {
      float row = 0.0f;
      for (int i = 0; i < nr; ++i) {
        const float v = frp::bf16_round(
            frame[(static_cast<long long>(rows[i]) * W + cols[j]) * C + ch]);
        row = __fadd_rn(row, __fmul_rn(wy[i], v));
      }
      acc = __fadd_rn(acc, __fmul_rn(wx[j], frp::bf16_round(row)));
    }
    dst[ch] = acc;
  }
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int frp_crop_resize(const float* images, const float* boxes,
                               float* out, int B, int H, int W, int C, int N,
                               int K, void* stream) {
  const long long total = static_cast<long long>(B) * N * K * K;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  crop_resize_kernel<<<static_cast<unsigned int>(blocks), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      images, boxes, out, B, H, W, C, N, K);
  return static_cast<int>(cudaGetLastError());
}
