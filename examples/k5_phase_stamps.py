"""Where kernel K5's time goes on the card, phase by phase.

    python3 examples/k5_phase_stamps.py          # needs one CUDA card and nvcc

Builds a copy of csrc/nms_fixpoint.cu into build/stamps/ with a %globaltimer
stamp (block 0, thread 0) before each phase of the kernel: staging the boxes
and areas, the valid bits, the cluster's arrival, the conflict rows, the
seven prologue sweeps, the pairs of sweeps. Launches it at the three stage
shapes of the server build at B=8 and at stage 3's B=1, checks each answer
against nms_sorted_plain and prints the microseconds between stamps (the
last launch of four). The shipped kernel carries no stamps.
"""
import ctypes
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from facerecognitionpipeline_tpu_torch.ops import cuda_build, nms_kernel as nk  # noqa: E402

src = open(os.path.join(cuda_build.CSRC_DIR, "nms_fixpoint.cu")).read()
stamp = ('if (threadIdx.x == 0 && blockIdx.x == 0) { unsigned long long t_; '
         'asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); g_stamps[g_n++] = t_; }')
marks = [
    ("  cg::cluster_group cluster = cg::this_cluster();\n  extern __shared__", "start"),
    ("  uint32_t* vbits = reinterpret_cast<uint32_t*>(p);", "staged"),
    ("  const int nv = last_valid + 1;", "vbits"),
    ("  for (int i = rank * warps + warp; i < nv; i += C * warps) {", "arrived"),
    ("  // the prologue: seven sweeps;", "rows"),
    ("  int check = 0;", "prologue"),
    ("  uint8_t* out = keep_out +", "loop"),
]
src = src.replace("namespace {\n", "namespace {\n__device__ unsigned long long g_stamps[16];\n__device__ int g_n;\n", 1)
for anchor, _ in marks:
    assert anchor in src, anchor
    if anchor.startswith("  cg::cluster_group"):
        src = src.replace(anchor, "  cg::cluster_group cluster = cg::this_cluster();\n  " + stamp + "\n  extern __shared__", 1)
    else:
        src = src.replace(anchor, "  " + stamp + "\n" + anchor, 1)
src += '''
extern "C" int frp_stamps(unsigned long long* out) {
  int n = 0;
  cudaMemcpyFromSymbol(out, g_stamps, sizeof(unsigned long long) * 16);
  cudaMemcpyFromSymbol(&n, g_n, sizeof(int));
  const int zero = 0;
  cudaMemcpyToSymbol(g_n, &zero, sizeof(int));
  return n;
}
'''
out_dir = os.path.join(os.path.dirname(cuda_build.BUILD_DIR), "stamps")
os.makedirs(out_dir, exist_ok=True)
open(os.path.join(out_dir, "k5.cu"), "w").write(src)
subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I", cuda_build.CSRC_DIR, "-o",
                os.path.join(out_dir, "libk5.so"), os.path.join(out_dir, "k5.cu")], check=True)
lib = ctypes.CDLL(os.path.join(out_dir, "libk5.so"))
fn = lib.frp_nms_fixpoint
fn.argtypes = nk._ARGTYPES
fn.restype = ctypes.c_int
lib.frp_stamps.argtypes = [ctypes.c_void_p]
buf = (ctypes.c_ulonglong * 16)()
names = [m[1] for m in marks]
for b, n, mode in ((8, 1152, "union"), (8, 256, "union"), (8, 96, "min"), (1, 96, "min")):
    boxes, v = cs.nms_sorted_inputs(b, n, seed=7 * n + b, mode=mode)
    geo = nk.nms_launch_geometry(b, n)
    keep = torch.empty(v.shape, dtype=torch.bool, device="cuda")
    for rep in range(4):
        lib.frp_stamps(buf)
        rc = fn(boxes.data_ptr(), v.data_ptr(), keep.data_ptr(), None, b, n, cs.NMS_THR,
                int(mode == "min"), geo.cluster, geo.threads, geo.band_words,
                1, geo.smem_bytes, torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        k = lib.frp_stamps(buf)
        t = list(buf[:k])
    want = nk.nms_sorted_plain(boxes, v, cs.NMS_THR, mode)
    print(f"[stamps] [{b}, {n}] {mode} rc {rc} equal {torch.equal(keep, want)}: " + ", ".join(
        f"{names[i]}->{names[i + 1] if i + 1 < len(names) else 'end'} {(t[i + 1] - t[i]) / 1e3:.2f} us"
        for i in range(len(t) - 1)) + f"; total {(t[-1] - t[0]) / 1e3:.2f} us")
