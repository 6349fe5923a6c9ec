// Streaming cosine top-k over bf16 gallery rows (kernel K3).
//
// Replaces facerecognitionpipeline_tpu/ops/pallas_gallery.py::
// _streaming_cosine_topk (its pl.pallas_call; kernel body `_kernel`, merge
// `_merge_topk`). The TPU kernel walks the gallery chunks in order on one
// core and carries the running top-k in VMEM scratch; gallery_topk.cuh says
// what takes that place here.
//
// Bound by device-memory bytes: at Q = 128, G = 1 048 576, D = 512 the bf16
// rows are 1.07 GB against 137 GFLOP (twice that with the query split). What
// the design does about it: TMA rings of 8 KB K-panels filled by one
// producer warp, wgmma m64n64k16 with the hi, then the lo part of 64 queries
// as A and 64 gallery rows as B into one accumulator, a fold that reads the
// accumulators in registers. A block holds 64 queries (both parts fill its
// shared memory), so at Q > 64 each gallery tile is read by two blocks; the
// second read comes from L2 when the two run side by side.
//
// Rounding points, shared with `streaming_cosine_topk_plain`: the float32
// unit query is split into hi = bf16(q) and lo = bf16(q - hi); score =
// float32 sum over d of (hi_d + lo_d) * t_d, the products exact.
//
// Layouts: queries [Q, D] f32 (already unit rows), templates [G, D] bf16,
// valid [G] bytes, part_v / part_i [Q, grid_x, list length] or [Q, 2 grid_x,
// k] scratch (on the pool route, its state,
// `frp::PoolScratch`), out_v [Q, k] f32, out_i [Q, k] int64.
#include "gallery_topk.cuh"

// Query rows one block handles; the wrapper sizes the launch by it.
extern "C" int frp_gallery_topk_qtile() { return frp::Bf16Traits::QT; }

// Longest top-k the kernel answers.
extern "C" int frp_gallery_topk_kmax() { return frp::KMAX; }

// Launches on `stream`; returns 0, the cudaError_t of the launch, or
// 100000 + the CUresult of the tensor-map encoding.
extern "C" int frp_gallery_topk(const float* queries, const void* templates,
                                const unsigned char* valid, float* part_v,
                                int* part_i, float* out_v, long long* out_i,
                                int Q, int G, int D, int k, int grid_x,
                                int stages, int smem_bytes, void* stream) {
  return frp::launch_stream_topk<frp::Bf16Traits>(
      queries, templates, nullptr, valid, part_v, part_i, out_v, out_i, nullptr,
      Q, G, D, k, grid_x, stages, smem_bytes, stream);
}

// The pool route (gallery_topk.cuh, `launch_pool_topk`): six launches on
// `stream`, no host synchronisation; returns as frp_gallery_topk.
extern "C" int frp_gallery_topk_pool(
    const float* queries, const void* templates,     const unsigned char* valid, float* sample, float* thr, float* thr_unres,
    int* cursor, float* pool_v, int* pool_i, float* part_v, int* part_i,
    float* out_v, long long* out_i, unsigned long long* unresolved,
    int Q, int G, int D, int k, int grid_x, int grid_x_u, int stages,
    int smem_bytes, int sample_tiles, int rank, int cap, int sort_n, int force,
    void* stream) {
  const frp::PoolScratch w{sample, thr, thr_unres, cursor, pool_v, pool_i,
                           part_v, part_i, unresolved};
  return frp::launch_pool_topk<frp::Bf16Traits>(
      queries, templates, nullptr, valid, w, out_v, out_i, nullptr, Q, G, D,
      k, grid_x, grid_x_u, stages, smem_bytes, sample_tiles, rank, cap, sort_n,
      force, stream);
}
