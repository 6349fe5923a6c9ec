// Streaming cosine top-k over int8 gallery codes (kernel K4).
//
// Replaces facerecognitionpipeline_tpu/ops/pallas_gallery.py::
// _streaming_cosine_topk_int8 (its pl.pallas_call; kernel body
// `_kernel_int8`). Same structure as K3 (gallery_topk.cuh) with integer
// operands: the dot is s8 x s8 -> s32 on the tensor cores (wgmma m64n64k32,
// two blocks of 64 query rows as A, 64 gallery rows as B) and is never
// widened to a float type before the product; the row scale multiplies the
// converted dot once. The per-query scale multiplies the finished scores
// after the stream kernel (in the merge kernel that ends the call), as the
// TPU version folds it in after its kernel.
//
// Bound by device-memory bytes: at Q = 128, G = 1 048 576, D = 512 the codes
// are 0.54 GB (plus 4 MB of scales) against 137 GOP. A block stages 128
// query rows (64 KB), so at Q <= 128 the gallery is read exactly once, and
// what is left of its shared memory holds two TMA rings of 8 stages (128 KB
// in flight per SM).
//
// Exactness, shared with `streaming_cosine_topk_int8_plain`: |dot| <=
// 512 * 127^2 < 2^24, so the dot and its float32 conversion are exact and
// score = float32(dot) * scale rounds once; kernel and plain version agree
// to the bit.
//
// Layouts: queries [Q, D] int8 codes, codes [G, D] int8, scales [G] f32,
// q_scale [Q] f32, valid [G] bytes, part_v / part_i [Q, grid_x, list length]
// or [Q, 2 grid_x, k] scratch (on the pool route, its state,
// `frp::PoolScratch`), out_v [Q, k] f32 (times the query scale),
// out_i [Q, k] int64.
#include "gallery_topk.cuh"

// Query rows one block handles; the wrapper sizes the launch by it.
extern "C" int frp_gallery_topk_int8_qtile() { return frp::Int8Traits::QT; }

// Longest top-k the kernel answers.
extern "C" int frp_gallery_topk_int8_kmax() { return frp::KMAX; }

// Launches on `stream`; returns 0, the cudaError_t of the launch, or
// 100000 + the CUresult of the tensor-map encoding.
extern "C" int frp_gallery_topk_int8(const signed char* queries,
                                     const void* codes, const float* scales,
                                     const unsigned char* valid, float* part_v,
                                     int* part_i, float* out_v,
                                     long long* out_i, const float* q_scale,
                                     int Q, int G, int D, int k, int grid_x,
                                     int stages, int smem_bytes, void* stream) {
  return frp::launch_stream_topk<frp::Int8Traits>(
      queries, codes, scales, valid, part_v, part_i, out_v, out_i, q_scale, Q,
      G, D, k, grid_x, stages, smem_bytes, stream);
}

// The pool route (gallery_topk.cuh, `launch_pool_topk`): six launches on
// `stream`, no host synchronisation; returns as frp_gallery_topk_int8.
extern "C" int frp_gallery_topk_int8_pool(
    const signed char* queries, const void* templates, const float* scales,
    const unsigned char* valid, float* sample, float* thr, float* thr_unres,
    int* cursor, float* pool_v, int* pool_i, float* part_v, int* part_i,
    float* out_v, long long* out_i, const float* q_scale, unsigned long long* unresolved,
    int Q, int G, int D, int k, int grid_x, int grid_x_u, int stages,
    int smem_bytes, int sample_tiles, int rank, int cap, int sort_n, int force,
    void* stream) {
  const frp::PoolScratch w{sample, thr, thr_unres, cursor, pool_v, pool_i,
                           part_v, part_i, unresolved};
  return frp::launch_pool_topk<frp::Int8Traits>(
      queries, templates, scales, valid, w, out_v, out_i, q_scale, Q, G, D,
      k, grid_x, grid_x_u, stages, smem_bytes, sample_tiles, rank, cap, sort_n,
      force, stream);
}
