"""Build and load the port's CUDA kernels (plain C interface over ctypes).

Each `csrc/<name>.cu` compiles with `nvcc` for `sm_90a` into its own shared
library under `build/kernels/` at the repo root, at first use, and loads
with ctypes. The library name carries a hash of the sources and flags, so a
changed source never loads a stale build. Nothing here runs at import
time: CPU-only processes import the wrappers freely and never reach nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
#: shared memory one block may use on an H100 (static + dynamic)
SMEM_LIMIT_BYTES = 232_448
KERNEL_NAMES = (
    "crop_resize", "warp_patches", "gallery_topk", "gallery_topk_int8", "gallery_topk_f32",
    "nms_fixpoint",
)

# No --use_fast_math: division stays correctly rounded. -fmad=false keeps
# the resamplers' coordinate arithmetic uncontracted (the sources also use
# the explicit _rn intrinsics); the gallery kernels' products run on the
# tensor cores, which the flag does not touch, or as explicit __fmaf_rn. -Xptxas -v makes the
# assembler report each kernel's registers, shared memory and spills; the
# report of a build is kept in BUILD_LOGS.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], object] = {}
#: compiler output of the libraries this process built, by kernel name
BUILD_LOGS: dict[str, str] = {}
#: every LaunchCounter of the process, in the order they were made
COUNTERS: list = []


class LaunchCounter:
    """Plain count of kernel launches, bumped by a wrapper exactly where it
    launches its kernel (never for the CPU plain version). Every counter
    is listed in COUNTERS, so that a CUDA graph can read what its capture
    recorded and `add` it again on every replay (`pipeline/step_graph.py`):
    the count stays one of kernels executed."""

    def __init__(self) -> None:
        self._n = 0
        self._lock = threading.Lock()
        COUNTERS.append(self)

    def bump(self) -> None:
        self.add(1)

    def add(self, n: int) -> None:
        with self._lock:
            self._n += n

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def count(self) -> int:
        return self._n


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (needed to build the CUDA kernels)")
    return path


def _lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fn in sorted(os.listdir(CSRC_DIR)):
        if fn == f"{name}.cu" or fn.endswith(".cuh"):
            with open(os.path.join(CSRC_DIR, fn), "rb") as f:
                h.update(fn.encode() + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _compile_cmd(name: str, out: str) -> list[str]:
    return [_nvcc(), *NVCC_FLAGS, "-o", out, os.path.join(CSRC_DIR, f"{name}.cu")]


def build_all(names=KERNEL_NAMES) -> dict[str, float]:
    """Compile every missing library, all nvcc processes at once. Returns
    {name: seconds} for the ones built (empty when all were cached)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _lib_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        procs[name] = (
            subprocess.Popen(
                _compile_cmd(name, tmp),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ),
            tmp, out,
        )
    took = {}
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        BUILD_LOGS[name] = log
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return took


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, building it first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _lib_path(name)
            if not os.path.exists(path):
                build_all((name,))
            lib = ctypes.CDLL(path)
            _libs[name] = lib
        return lib


def function(name: str, symbol: str, argtypes: list) -> object:
    """The C function `symbol` of kernel `name`'s library, returning int,
    with its argument types set once: a launch then costs the host one
    dictionary lookup, not a lock and a new `argtypes` list."""
    fn = _fns.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[(name, symbol)] = fn
    return fn
