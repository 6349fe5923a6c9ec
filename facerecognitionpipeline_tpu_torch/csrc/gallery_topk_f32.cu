// Streaming cosine top-k over float32 gallery rows (kernel K3 on float32
// rows).
//
// Replaces the float32-template case of facerecognitionpipeline_tpu/ops/
// pallas_gallery.py::_streaming_cosine_topk (its pl.pallas_call, which
// multiplies float32 rows in float32). A tensor-core product would round
// these rows to bf16 or TF32, three decimal digits, where the reference
// keeps float32, so the products run as float32 FMAs on the CUDA cores.
//
// Bound by float32 operations: at Q = 128, G = 1 048 576, D = 512 the rows
// are 2.15 GB (0.64 ms at 3.35 TB/s) against 2 * 128 * 2^20 * 512 FLOP
// (2.05 ms at 67 TFLOP/s). What the design does about it: the body K3 and K4
// share (gallery_topk.cuh, F32Traits) - one producer warp streams 8 KB
// float32 panels (64 rows x 32 floats) through the two TMA rings on
// mbarriers, so the consumers never wait on a load of their own or on a
// block-wide barrier; each consumer thread multiplies 4 queries by 8 rows
// read from the swizzled stages with 16-byte loads (12 floats loaded per 32
// FMAs, the shared-memory wavefronts 1.5x the FMA time; F32Traits says
// why), then trades half its scores with one other lane into the places of
// the wgmma accumulator, so the fold, the lists and the merges are K3's.
//
// Rounding points, shared with `streaming_cosine_topk_plain`: float32 unit
// queries, score = float32 sum over d of q_d * t_d (fused multiply-adds in
// depth order here; the plain version's matmul sums in another order, ~1e-7
// apart).
//
// Layouts: queries [Q, D] f32 (already unit rows), templates [G, D] f32,
// valid [G] bytes, part_v / part_i [Q, grid_x, list length] or [Q, 2 grid_x,
// k] scratch (on the pool route, its state,
// `frp::PoolScratch`), out_v [Q, k] f32, out_i [Q, k] int64.
#include "gallery_topk.cuh"

// Query rows one block handles; the wrapper sizes the launch by it.
extern "C" int frp_gallery_topk_f32_qtile() { return frp::F32Traits::QT; }

// Longest top-k the kernel answers.
extern "C" int frp_gallery_topk_f32_kmax() { return frp::KMAX; }

// Launches on `stream`; returns 0, the cudaError_t of the launch, or
// 100000 + the CUresult of the tensor-map encoding.
extern "C" int frp_gallery_topk_f32(const float* queries, const void* templates,
                                    const unsigned char* valid, float* part_v,
                                    int* part_i, float* out_v, long long* out_i,
                                    int Q, int G, int D, int k, int grid_x,
                                    int stages, int smem_bytes, void* stream) {
  return frp::launch_stream_topk<frp::F32Traits>(
      queries, templates, nullptr, valid, part_v, part_i, out_v, out_i, nullptr,
      Q, G, D, k, grid_x, stages, smem_bytes, stream);
}

// The pool route (gallery_topk.cuh, `launch_pool_topk`): six launches on
// `stream`, no host synchronisation; returns as frp_gallery_topk_f32.
extern "C" int frp_gallery_topk_f32_pool(
    const float* queries, const void* templates,     const unsigned char* valid, float* sample, float* thr, float* thr_unres,
    int* cursor, float* pool_v, int* pool_i, float* part_v, int* part_i,
    float* out_v, long long* out_i, unsigned long long* unresolved,
    int Q, int G, int D, int k, int grid_x, int grid_x_u, int stages,
    int smem_bytes, int sample_tiles, int rank, int cap, int sort_n, int force,
    void* stream) {
  const frp::PoolScratch w{sample, thr, thr_unres, cursor, pool_v, pool_i,
                           part_v, part_i, unresolved};
  return frp::launch_pool_topk<frp::F32Traits>(
      queries, templates, nullptr, valid, w, out_v, out_i, nullptr, Q, G, D,
      k, grid_x, grid_x_u, stages, smem_bytes, sample_tiles, rank, cap, sort_n,
      force, stream);
}
