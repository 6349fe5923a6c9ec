// Streaming cosine top-k over bf16 gallery rows (kernel K3).
//
// Replaces facerecognitionpipeline_tpu/ops/pallas_gallery.py::
// _streaming_cosine_topk (its pl.pallas_call; kernel body `_kernel`, merge
// `_merge_topk`). The TPU kernel walks the gallery chunks in order on one
// core and carries the running top-k in VMEM scratch; gallery_topk.cuh says
// what takes that place here.
//
// Bound by device-memory bytes: at Q = 128, G = 1 048 576, D = 512 the bf16
// rows are 1.07 GB against 137 GFLOP (twice that with the query split). The
// design reads each row from device memory once per query tile of 64 rows
// (the second tile's read of the same rows is served by L2 when the two
// blocks run side by side) and keeps the scores in shared memory.
//
// Rounding points, shared with `streaming_cosine_topk_plain`: the float32
// unit query is split into hi = bf16(q) and lo = bf16(q - hi); score =
// float32 sum over d of (hi_d + lo_d) * t_d, the products exact.
//
// Layouts: queries [Q, D] f32 (already unit rows), templates [G, D] bf16,
// valid [G] bytes, out_v [Q, k] f32, out_i [Q, k] int32.
#include "gallery_topk.cuh"

// Query rows one block handles; the wrapper sizes the scratch tensors by it.
extern "C" int frp_gallery_topk_qtile() { return frp::Bf16Traits::QT; }

// Longest top-k the kernel supports.
extern "C" int frp_gallery_topk_kmax() { return frp::KMAX; }

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int frp_gallery_topk(const float* queries, const void* templates,
                                const unsigned char* valid, float* part_v,
                                int* part_i, float* out_v, int* out_i, int Q,
                                int G, int D, int k, int grid_x,
                                void* stream) {
  return frp::launch_stream_topk<frp::Bf16Traits>(
      queries, static_cast<const __nv_bfloat16*>(templates), nullptr, valid,
      part_v, part_i, out_v, out_i, Q, G, D, k, grid_x, stream);
}
