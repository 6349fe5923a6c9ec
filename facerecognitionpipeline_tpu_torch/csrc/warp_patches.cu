// Stage-B affine warp of per-face patches to aligned faces (kernel K2).
//
// Replaces facerecognitionpipeline_tpu/ops/pallas_warp.py::_warp_patches_affine
// (the pl.pallas_call behind warp_patches_affine). The TPU kernel builds
// dense hat matrices per output tile and contracts them on the MXU with the
// patch resident in VMEM. A hat weight has at most two non-zero taps per
// axis, so here each output pixel is a 4-tap gather: one thread per output
// pixel, all channels. Bound by device-memory bytes: one read of the
// float32 patches, one write of the float32 faces.
//
// Per output pixel (x, y) of face n, with six coefficients a0..a2, b0..b2:
//   px = a0*x + a1*y + a2,  py = b0*x + b1*y + b2   (no FMA contraction)
//   wu = bf16(max(0, 1-|px-u|)),  wy = max(0, 1-|py-v|) kept float32
//   row(v) = f32 sum over u of bf16(P[v,u,c]) * wu   (exact products; kept f32)
//   out    = f32 sum over v of round(row(v) * wy)
// which are the TPU kernel's rounding points (its rows matmul has bf16
// operands and f32 accumulation, and its column pass multiplies then sums).
// Taps outside the patch contribute nothing.
//
// Layouts: patches [N,K,K,C] f32, coeffs [N,6] f32, out [N,OH,OW,C] f32.
#include "common.cuh"

namespace {

__global__ void warp_patches_kernel(const float* __restrict__ patches,
                                    const float* __restrict__ coeffs,
                                    float* __restrict__ out, int N, int K,
                                    int C, int OH, int OW) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long total = static_cast<long long>(N) * OH * OW;
  if (idx >= total) return;
  const int x = static_cast<int>(idx % OW);
  const long long t = idx / OW;
  const int y = static_cast<int>(t % OH);
  const int n = static_cast<int>(t / OH);

  const float* cf = coeffs + static_cast<long long>(n) * 6;
  const float fx = static_cast<float>(x), fy = static_cast<float>(y);
  const float px =
      __fadd_rn(__fadd_rn(__fmul_rn(cf[0], fx), __fmul_rn(cf[1], fy)), cf[2]);
  const float py =
      __fadd_rn(__fadd_rn(__fmul_rn(cf[3], fx), __fmul_rn(cf[4], fy)), cf[5]);

  const int u0 = static_cast<int>(floorf(px));
  const int v0 = static_cast<int>(floorf(py));
  int us[2], vs[2];
  float wu[2], wy[2];
  int nu = 0, nv = 0;
  for (int d = 0; d < 2; ++d) {
    const int u = u0 + d;
    if (u >= 0 && u < K) {
      us[nu] = u;
      wu[nu] = frp::bf16_round(frp::hat(px, u));
      ++nu;
    }
    const int v = v0 + d;
    if (v >= 0 && v < K) {
      vs[nv] = v;
      wy[nv] = frp::hat(py, v);
      ++nv;
    }
  }

  const float* patch = patches + static_cast<long long>(n) * K * K * C;
  float* dst = out + idx * C;
  for (int ch = 0; ch < C; ++ch) {
    float acc = 0.0f;
    for (int i = 0; i < nv; ++i) {
      float row = 0.0f;
      for (int j = 0; j < nu; ++j) {
        const float p = frp::bf16_round(
            patch[(static_cast<long long>(vs[i]) * K + us[j]) * C + ch]);
        row = __fadd_rn(row, __fmul_rn(p, wu[j]));
      }
      acc = __fadd_rn(acc, __fmul_rn(row, wy[i]));
    }
    dst[ch] = acc;
  }
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int frp_warp_patches(const float* patches, const float* coeffs,
                                float* out, int N, int K, int C, int OH,
                                int OW, void* stream) {
  const long long total = static_cast<long long>(N) * OH * OW;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  warp_patches_kernel<<<static_cast<unsigned int>(blocks), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      patches, coeffs, out, N, K, C, OH, OW);
  return static_cast<int>(cudaGetLastError());
}
