// Streaming cosine top-k over int8 gallery codes (kernel K4).
//
// Replaces facerecognitionpipeline_tpu/ops/pallas_gallery.py::
// _streaming_cosine_topk_int8 (its pl.pallas_call; kernel body
// `_kernel_int8`). Same structure as K3 (gallery_topk.cuh) with integer
// operands: the dot is s8 x s8 -> s32 on the tensor cores and is never
// widened to a float type before the product; the row scale multiplies the
// converted dot once. The per-query scale is folded in by the wrapper
// after the kernel, as in the TPU version.
//
// Bound by device-memory bytes: at Q = 128, G = 1 048 576, D = 512 the codes
// are 0.54 GB (plus 4 MB of scales) against 137 GOP. A block stages 128
// query rows, so at Q <= 128 the gallery is read exactly once.
//
// Exactness, shared with `streaming_cosine_topk_int8_plain`: |dot| <=
// 512 * 127^2 < 2^24, so the dot and its float32 conversion are exact and
// score = float32(dot) * scale rounds once; kernel and plain version agree
// to the bit.
//
// Layouts: queries [Q, D] int8 codes, codes [G, D] int8, scales [G] f32,
// valid [G] bytes, out_v [Q, k] f32 (without the query scale), out_i [Q, k]
// int32.
#include "gallery_topk.cuh"

// Query rows one block handles; the wrapper sizes the scratch tensors by it.
extern "C" int frp_gallery_topk_int8_qtile() { return frp::Int8Traits::QT; }

// Longest top-k the kernel supports.
extern "C" int frp_gallery_topk_int8_kmax() { return frp::KMAX; }

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int frp_gallery_topk_int8(const signed char* queries,
                                     const signed char* codes,
                                     const float* scales,
                                     const unsigned char* valid, float* part_v,
                                     int* part_i, float* out_v, int* out_i,
                                     int Q, int G, int D, int k, int grid_x,
                                     void* stream) {
  return frp::launch_stream_topk<frp::Int8Traits>(
      queries, codes, scales, valid, part_v, part_i, out_v, out_i, Q, G, D, k,
      grid_x, stream);
}
