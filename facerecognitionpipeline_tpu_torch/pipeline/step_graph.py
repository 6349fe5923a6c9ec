"""The serving step as one replayed CUDA graph per key.

Counterpart of the JAX engine's `jax.jit(self._step_impl)` and its
`_compiled_shapes` (`facerecognitionpipeline_tpu/pipeline/engine.py`): XLA
compiles one program per (frame shape, gallery shape and dtype, k) and
warms it once per key; here `RecognitionEngine.process_frames` on a CUDA
device captures one `torch.cuda.CUDAGraph` per key and replays it, so a
step costs the host one graph launch instead of some two thousand kernel
launches. The eager `RecognitionEngine.step` stays the yardstick, and the
only route on the CPU.

Per key, per data shard of the engine (one graph on that shard's device
covering what lies there: frames slice, detect, align, gate, embed, and the
match against a replicated gallery; under `shard_gallery` the state before
matching):

* the key: the frame shape and dtype, the identity and (pointer, shape,
  dtype) of each gallery operand (a tensor, an int8 (codes, scales) pair or
  a `Sharded` one), and `gallery_k`. K3/K4 encode their tensor map from the
  gallery's pointer at launch, so a captured launch is right only while the
  operand's pointer is the key's;
* static inputs: a frame buffer and the int32 `rotation` scalar; each call
  copies its frames into the buffer and fills the scalar on the current
  stream, then replays;
* outputs are cloned into fresh tensors on the same stream: the batcher
  copies answers to the host on a stream of its own, and the next replay
  must not overwrite an answer still being copied;
* capture: two eager steps on a side stream first (kernel builds, shared
  memory attributes, cuDNN's algorithm choice, the engine's gallery
  copies), then one captured step on that stream, drawing from one memory
  pool per engine and device (its replays serialize on one stream and its
  outputs are cloned). One stderr line per capture, as the JAX engine
  prints per compile. A capture that fails raises with its key; nothing
  falls back to the eager step;
* generations: a new gallery operand (`DeviceGallery.rebuild` makes new
  tensors) drops every graph of the older ones, which frees their pool
  memory and the old gallery; writes into the same tensors need nothing,
  since a replay reads memory when it runs;
* launch counts: the kernel wrappers run only during capture, so what each
  `LaunchCounter` recorded there is taken back and added again on every
  replay; a count stays one of kernels executed.

What stays eager under a mesh: the cross-device moves, `dp_sharded_parts`'s
merge and the gather of the shards' results (`RecognitionEngine._combine`).
A CUDA graph lives in one process; the port's persistent cache across
processes is its kernel build (`build/kernels/`).
"""

from __future__ import annotations

import contextlib
import sys
import threading
import time
from typing import Any, Callable, NamedTuple, Optional

import torch

from facerecognitionpipeline_tpu_torch.ops import cuda_build

#: eager steps run on the capture stream before each capture
WARMUP_STEPS = 2


class Captured(NamedTuple):
    """One captured step: what a replay needs and what the capture cost."""

    replay: Callable[[], None]  # launches the graph on the current stream
    outputs: Any  # the static output tree the replay writes
    launches: tuple  # ((LaunchCounter, launches recorded in the capture), ...)
    pool_bytes: int  # device memory the capture reserved for its pool
    seconds: float  # warm-up and capture


def operand_signature(x):
    """Identity and (pointer, shape, dtype) of a gallery operand: a tensor,
    a tuple (the int8 codes and scales) or a `Sharded` one (its blocks)."""
    if isinstance(x, tuple):
        return tuple(operand_signature(v) for v in x)
    if isinstance(x, torch.Tensor):
        return (id(x), x.data_ptr(), tuple(x.shape), x.dtype, str(x.device))
    return (id(x), *(operand_signature(b) for b in x.blocks))


def _describe(x) -> str:
    if isinstance(x, tuple):
        return " + ".join(_describe(v) for v in x)
    return f"{tuple(x.shape)} {str(x.dtype).replace('torch.', '')}"


def clone_tree(tree):
    """A copy of every tensor of a nested dict / tuple / list of tensors."""
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(clone_tree(v) for v in tree)
    return tree.clone()


class CudaCapture:
    """Captures a step function into a CUDA graph: `WARMUP_STEPS` eager
    calls on a side stream, then one captured call on it, from one memory
    pool per device."""

    def __init__(self):
        self._pools: dict = {}

    def __call__(self, fn: Callable[[], Any], device: torch.device) -> Captured:
        t0 = time.perf_counter()
        with torch.cuda.device(device):
            stream = torch.cuda.Stream(device)
            stream.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(stream):
                for _ in range(WARMUP_STEPS):
                    fn()
            torch.cuda.current_stream(device).wait_stream(stream)
            torch.cuda.synchronize(device)
            pool = self._pools.get(device)
            if pool is None:
                pool = self._pools[device] = torch.cuda.graph_pool_handle()
            # the capture empties the allocator's cache first; emptied here,
            # what is reserved after it is what the capture added
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(device)
            counters = list(cuda_build.COUNTERS)
            before = [c.count for c in counters]
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=pool, stream=stream,
                                  capture_error_mode="thread_local"):
                outputs = fn()
            recorded = tuple(
                (c, c.count - n) for c, n in zip(counters, before) if c.count != n
            )
            for c, n in recorded:  # nothing ran yet: the replays count
                c.add(-n)
            pool_bytes = torch.cuda.memory_reserved(device) - reserved

        return Captured(graph.replay, outputs, recorded, pool_bytes, time.perf_counter() - t0)


class _Entry(NamedTuple):
    captured: Captured
    frames: torch.Tensor  # the static frame buffer of the shard
    rotation: torch.Tensor  # the static int32 rotation scalar


class StepGraphs:
    """The graphs of one engine's step, by key and shard (see the module
    docstring). `capture(fn, device) -> Captured` is `CudaCapture()`
    unless a caller injects another."""

    def __init__(self, engine, capture: Optional[Callable] = None):
        self._engine = engine
        self._capture = capture if capture is not None else CudaCapture()
        self._lock = threading.Lock()
        self._graphs: dict = {}
        self._generation: Optional[tuple] = None  # (signature, operands) kept
        self._streams: dict = {}  # device -> the stream of the last replay
        #: one record per capture: key, pool bytes, seconds
        self.captures: list[dict] = []

    def __len__(self) -> int:
        return len(self._graphs)

    def run(self, frames: torch.Tensor, templates, valid, gallery_k: int, rotation,
            start_event=None) -> dict:
        """The step's result dict for frames already on the engine's
        device, through the graph of their key (captured first if new).
        `start_event` is recorded on the first shard's stream right before
        the step's first device operation."""
        eng = self._engine
        shards = eng._shards
        n = len(shards)
        if frames.shape[0] % n:
            raise ValueError(
                f"batch of {frames.shape[0]} frames is not a multiple of the "
                f"mesh 'data' axis ({n})"
            )
        per = frames.shape[0] // n
        gallery = (operand_signature(templates), operand_signature(valid))
        rot = wrap_int32(rotation) if not isinstance(rotation, torch.Tensor) else rotation
        with self._lock, torch.inference_mode():
            if self._generation is None or self._generation[0] != gallery:
                # graphs of older operands go, and with them the references
                # that kept the old gallery and their pool memory alive
                if self._graphs:
                    for sh in shards:  # no replay of them is still running
                        _synchronize(sh.device)
                self._graphs.clear()
                self._generation = (gallery, (templates, valid))
            parts = []
            for i, sh in enumerate(shards):
                src = frames[i * per:(i + 1) * per]
                key = (i, tuple(src.shape), src.dtype, gallery, gallery_k)
                with _on(sh.device):  # the shard's card: its current stream
                    self._follow(sh.device)
                    entry = self._graphs.get(key)
                    if start_event is not None and i == 0:
                        start_event.record()
                    if entry is None:
                        entry = self._new(i, sh.device, src, templates, valid, gallery_k, rot)
                        self._graphs[key] = entry
                    else:
                        entry.frames.copy_(src, non_blocking=True)
                        _fill_rotation(entry.rotation, rot)
                    entry.captured.replay()
                    for counter, k in entry.captured.launches:
                        counter.add(k)
                    parts.append(clone_tree(entry.captured.outputs))
            return eng._combine(parts, templates, valid, gallery_k)

    def _follow(self, device) -> None:
        """Order this call's work after the previous call's on `device`:
        the graphs share static buffers and one memory pool, so their
        replays must not overlap, whichever stream a caller is on."""
        if device.type != "cuda":
            return
        cur = torch.cuda.current_stream(device)
        last = self._streams.get(device)
        if last is not None and last != cur:
            cur.wait_stream(last)
        self._streams[device] = cur

    def _new(self, i, device, src, templates, valid, gallery_k, rot) -> _Entry:
        eng = self._engine
        static = torch.empty(src.shape, dtype=src.dtype, device=device)
        static.copy_(src, non_blocking=True)
        static_rot = torch.zeros((), dtype=torch.int32, device=device)
        _fill_rotation(static_rot, rot)

        def fn():
            return eng._shard_part(i, static, static_rot, templates, valid, gallery_k)

        desc = (f"frames {tuple(src.shape)} {str(src.dtype).replace('torch.', '')} "
                f"(shard {i} on {device}), gallery {_describe(templates)}, k={gallery_k}")
        try:
            captured = self._capture(fn, device)
        except Exception as e:
            raise RuntimeError(f"capturing the step's CUDA graph failed for {desc}: {e}") from e
        self.captures.append({"key": desc, "pool_bytes": captured.pool_bytes,
                              "seconds": captured.seconds})
        print(f"[RecognitionEngine] captured the step as a CUDA graph for {desc} "
              f"in {captured.seconds:.2f} s, {captured.pool_bytes / 2**20:.1f} MiB "
              f"added to its pool (first use of this key and gallery in this process)",
              file=sys.stderr)
        return _Entry(captured, static, static_rot)


def wrap_int32(v: int) -> int:
    """An int wrapped to int32's range, as an int32 counter wraps."""
    return (int(v) + 2**31) % 2**32 - 2**31


def _fill_rotation(dst: torch.Tensor, rot) -> None:
    if isinstance(rot, torch.Tensor):
        dst.copy_(rot, non_blocking=True)
    else:
        dst.fill_(rot)


def _synchronize(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _on(device):
    """`device` made the current card, where it is one."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()
