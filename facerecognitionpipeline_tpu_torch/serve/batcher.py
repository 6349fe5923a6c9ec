"""Device batcher: coalesce concurrent client frames into one fused step.

Counterpart of `facerecognitionpipeline_tpu/serve/batcher.py`, the server's
request path. Three stages, one thread each, so host<->device copies overlap
device compute:

  submit()  -> ingress queue
  transfer  -> stack whatever frames are queued into a pinned host buffer
               and upload the group on a side CUDA stream (one copy per
               group, not per frame); an event marks its completion
  dispatch  -> drain uploaded groups, make the compute stream wait on their
               events, concatenate and pad to a bucket size, run the step
  complete  -> copy the small result fields to the host on a third stream,
               fan futures out; bulky fields (aligned crops, embeddings)
               stay on the device behind lazy per-item views

On a CPU device the same stages run without streams. Under an engine's
mesh, bucket sizes are multiples of its 'data' axis, groups upload to the
mesh's first device (the engine splits them), and the completion stage
waits on an event of every device of the mesh.

The stages record spans into the batcher's `Tracer` when it is on
(`telemetry/trace.py`; each site tests `tracer.on` and does nothing more
when it is off):

  batcher.ingress   per frame: submit() until the transfer thread takes it
  batcher.upload    per group: the stack into pinned memory and the H2D enqueue
  batcher.ready     per group: the upload's enqueue until the dispatch takes it
  batcher.await     per dispatch: waiting for a first group, no frame in hand
  batcher.window    per dispatch: waiting for more groups, up to max_wait_ms
  batcher.assemble  per dispatch: the stream's waits on the uploads, padding
                    and concatenation into the step's batch
  batcher.provider  per dispatch: the gallery_provider() call
  batcher.enqueue   per dispatch: process_frames on the host
  batcher.handoff   per dispatch: the completion events recorded and the step
                    handed to the completion thread
  step.device       per step: the compute stream, from a timing event that
                    process_frames records right before the step's first
                    device operation to the completion event (on the CPU,
                    the host times around process_frames)
  batcher.d2h       per step: waiting on the step and copying the small fields
  batcher.fanout    per frame: from the copy's end until its set_result

and counts, on or off, `steps` (dispatches), `frames` (frames dispatched)
and `carried` (dispatches that left an upload group for the next step).
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Optional, Sequence

import numpy as np
import torch

from facerecognitionpipeline_tpu_torch.telemetry.trace import DEVICE, Counter, Tracer

_STOPPED = "DeviceBatcher stopped before this frame ran"
_LAZY_KEYS = ("aligned", "embeddings", "landmarks", "embedding_norms")


def _fail_futures(futs, err: BaseException) -> None:
    """Set `err` on every unresolved future, tolerating races with other
    setters (stop() and a stage thread may fail the same future)."""
    for fut in futs:
        if not fut.done():
            try:
                fut.set_exception(err)
            except InvalidStateError:
                pass


class _LazySlice:
    """View of one item of a device-resident batch tensor; `np.asarray`
    fetches exactly that slice. Holds the batch tensor until dropped."""

    def __init__(self, dev: torch.Tensor, idx=()):
        self._dev = dev
        self._idx = tuple(idx)

    def __getitem__(self, i):
        return _LazySlice(self._dev, self._idx + (i,))

    @property
    def shape(self):
        probe = np.broadcast_to(np.empty((), np.uint8), tuple(self._dev.shape))
        return probe[self._idx].shape

    def __array__(self, dtype=None, copy=None):
        if copy is False:
            raise ValueError("_LazySlice materializes a device fetch; copy=False cannot be honored")
        t = self._dev[self._idx] if self._idx else self._dev
        arr = t.cpu().numpy()
        return arr.astype(dtype) if dtype is not None else arr


def _to_host(tree):
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    return tree.cpu().numpy()


def _item(tree, i):
    if isinstance(tree, dict):
        return {k: _item(v, i) for k, v in tree.items()}
    return tree[i]


class _Frame(Future):
    """The future of one submitted frame; traced, its id and submit() time."""

    id = -1
    submit_ns = 0


def _ids(futs) -> tuple:
    return tuple(f.id for f in futs)


class DeviceBatcher:
    """Pipelined batching front of the recognition step."""

    def __init__(
        self,
        engine,
        gallery_provider,
        max_batch: int = 8,
        max_wait_ms: float = 5.0,
        top_k: int = 3,
        bucket_sizes: Optional[Sequence[int]] = None,
        tracer: Optional[Tracer] = None,
    ):
        """gallery_provider() -> (templates, valid) device tensors, or
        (templates, valid, ids); with ids, each result carries the id list
        captured at dispatch as result["gallery_ids"]. `tracer`: the
        recorder the stages write spans into (an off one of its own if
        None)."""
        self.engine = engine
        self.gallery_provider = gallery_provider
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1000.0
        self.top_k = top_k
        self.device = engine.device
        buckets = sorted(set(bucket_sizes or (1, max_batch)))
        mesh = getattr(engine, "mesh", None)
        if mesh is not None and "data" in mesh.shape:
            d = mesh.shape["data"]
            if max_batch % d:
                raise ValueError(
                    f"max_batch={max_batch} must be a multiple of the mesh "
                    f"'data' axis size ({d})"
                )
            buckets = [b for b in buckets if b % d == 0 and b <= max_batch]
            self.bucket_sizes = buckets or [max_batch]
            self._devices = mesh.distinct_devices()
        else:
            self.bucket_sizes = sorted({min(b, max_batch) for b in buckets})
            self._devices = [self.device]
        if max_batch not in self.bucket_sizes:
            self.bucket_sizes.append(max_batch)

        self._ingress: queue.Queue = queue.Queue()
        self._ready: queue.Queue = queue.Queue()
        self._done: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._frame_shape = None  # set by warmup
        self._carry = None  # overflow group held for the next dispatch
        self._dispatch_count = 0  # the step's rotation, wrapped
        self._drained_ns = 0  # traced: when the dispatch thread's last drain ended
        # the dispatch thread's counts
        self.steps, self.frames, self.carried = Counter(), Counter(), Counter()
        self.tracer = tracer if tracer is not None else Tracer()
        self.tracer.watch(self.counts, self._devices[0])
        cuda = self.device.type == "cuda"
        self._h2d_stream = torch.cuda.Stream(self.device) if cuda else None
        self._d2h_stream = torch.cuda.Stream(self.device) if cuda else None

    def counts(self) -> dict:
        """The dispatch thread's counters and the engine's graph captures."""
        graphs = getattr(self.engine, "_graphs", None)
        return {"batcher.steps": self.steps.count, "batcher.frames": self.frames.count,
                "batcher.carried": self.carried.count,
                "graphs.captures": len(graphs.captures) if graphs is not None else 0}

    # ----------------------------------------------------------- lifecycle

    def start(self) -> None:
        if self._threads:
            return
        if self._stop.is_set():
            raise RuntimeError(
                "DeviceBatcher cannot restart after stop(); create a new DeviceBatcher"
            )
        for target, name in (
            (self._transfer_run, "batcher-transfer"),
            (self._dispatch_run, "batcher-dispatch"),
            (self._complete_run, "batcher-complete"),
        ):
            t = threading.Thread(target=target, name=name, daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        """Stop the stage threads and fail every future still in flight."""
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5.0)
        self._threads = []
        err = RuntimeError(_STOPPED)
        if self._carry is not None:
            _fail_futures(self._carry[2], err)
            self._carry = None
        for q, pick in (
            (self._ready, lambda e: e[2]),
            (self._ingress, lambda e: [e[1]]),
            (self._done, lambda e: e[2]),
        ):
            while True:
                try:
                    entry = q.get_nowait()
                except queue.Empty:
                    break
                _fail_futures(pick(entry), err)

    def submit(self, frame: np.ndarray) -> Future:
        """frame at the engine's det size (host uint8) -> Future of this
        frame's slice of the step output (host arrays and lazy views)."""
        fut = _Frame()
        if self.tracer.on:
            fut.submit_ns = time.perf_counter_ns()
            fut.id = self.tracer.next_id()
        err = RuntimeError(_STOPPED)
        if self._stop.is_set():
            fut.set_exception(err)
            return fut
        self._ingress.put((frame, fut))
        if self._stop.is_set():
            _fail_futures([fut], err)  # raced with stop()'s drain
        return fut

    def warmup(self, det_size: tuple[int, int]) -> None:
        """Run every bucket size once before taking traffic (first-use
        costs: kernel builds, cuDNN algorithm selection, allocator growth;
        on a card, the capture of each bucket's CUDA graph for the
        provider's current gallery, `pipeline/step_graph.py`)."""
        h, w = det_size
        snapshot = self.gallery_provider()
        self._frame_shape = tuple(self.engine.host_frame_shape(h, w))
        for b in self.bucket_sizes:
            out = self.engine.process_frames(
                np.zeros((b, *self._frame_shape), np.uint8),
                snapshot[0], snapshot[1], gallery_k=self.top_k,
            )
            out["match_scores"].cpu()

    # ------------------------------------------------------------- stage 1

    def _upload(self, frames: list) -> tuple[torch.Tensor, Optional[torch.cuda.Event]]:
        """Stack on the host and upload as ONE copy; returns the device
        tensor and the event that marks the copy done (None on CPU)."""
        if self._h2d_stream is None:
            return torch.from_numpy(np.stack(frames)), None
        host = torch.empty(
            (len(frames), *frames[0].shape), dtype=torch.uint8, pin_memory=True
        )
        np.stack(frames, out=host.numpy())
        with torch.cuda.stream(self._h2d_stream):
            dev = host.to(self.device, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self._h2d_stream)
        return dev, ev

    def _transfer_run(self) -> None:
        while not self._stop.is_set():
            try:
                frame, fut = self._ingress.get(timeout=0.1)
            except queue.Empty:
                continue
            frames, futs = [frame], [fut]
            while len(frames) < self.max_batch:
                try:
                    f2, u2 = self._ingress.get_nowait()
                except queue.Empty:
                    break
                frames.append(f2)
                futs.append(u2)
            tr = self.tracer
            on = tr.on  # one reading a group: start() and stop() run on other threads
            if on:
                taken_ns = time.perf_counter_ns()
                for u in futs:
                    if u.id >= 0:
                        tr.span("batcher.ingress", u.submit_ns, taken_ns, u.id)
            # a malformed frame fails only its own future
            ref = self._frame_shape or frames[0].shape
            bad = [
                k for k, f in enumerate(frames)
                if f.shape != ref or f.dtype != np.uint8
            ]
            if bad:
                err = ValueError(
                    f"frame shape/dtype mismatch in transfer group: expected {ref} uint8"
                )
                _fail_futures([futs[k] for k in bad], err)
                frames = [f for k, f in enumerate(frames) if k not in bad]
                futs = [u for k, u in enumerate(futs) if k not in bad]
                if not frames:
                    continue
            try:
                dev, ev = self._upload(frames)
                ready_ns = 0
                if on:
                    ready_ns = time.perf_counter_ns()
                    tr.span("batcher.upload", taken_ns, ready_ns, _ids(futs))
                self._ready.put((dev, ev, futs, ready_ns))
                if self._stop.is_set():  # put-then-recheck against stop()
                    while True:
                        try:
                            _, _, futs2, _ = self._ready.get_nowait()
                        except queue.Empty:
                            break
                        _fail_futures(futs2, RuntimeError(_STOPPED))
            except Exception as e:  # noqa: BLE001 - scoped to these futures
                _fail_futures(futs, e)

    # ------------------------------------------------------------- stage 2

    def _drain(self) -> list:
        """Uploaded groups until max_batch frames are in hand or the
        batching window closes; a group that would overflow is carried.
        Traced, the `batcher.await` and `batcher.window` spans tile the
        dispatch thread's time up to `_drained_ns`."""
        groups = []
        tr = self.tracer
        on = tr.on  # one reading a drain: start() and stop() run on other threads
        step = self.steps.count + 1  # the dispatch these groups go to
        if on:
            t_top = time.perf_counter_ns()
        if self._carry is not None:
            groups.append(self._carry)
            self._carry = None
        else:
            try:
                groups.append(self._ready.get(timeout=0.1))
            except queue.Empty:
                if on:
                    tr.span("batcher.await", t_top, time.perf_counter_ns(), step)
                return groups
            if on:
                t = time.perf_counter_ns()
                tr.span("batcher.await", t_top, t, step)
                t_top = t
        if on:
            self._taken(groups[0], step)
        n = int(groups[0][0].shape[0])
        t0 = time.perf_counter()
        while n < self.max_batch:
            remaining = self.max_wait_s - (time.perf_counter() - t0)
            if remaining <= 0:
                break
            try:
                g = self._ready.get(timeout=remaining)
            except queue.Empty:
                break
            gn = int(g[0].shape[0])
            if n + gn > self.max_batch:
                self._carry = g  # its ready span ends when the next drain takes it
                self.carried.bump()
                break
            if on:
                self._taken(g, step)
            groups.append(g)
            n += gn
        if tr.on:
            self._drained_ns = time.perf_counter_ns()
            if on:
                tr.span("batcher.window", t_top, self._drained_ns, step)
        return groups

    def _taken(self, group, step: int) -> None:
        """The `batcher.ready` span of a group the dispatch took (traced
        since its upload)."""
        if group[3]:
            self.tracer.span("batcher.ready", group[3], time.perf_counter_ns(),
                             _ids(group[2]), step)

    def _bucket(self, n: int) -> int:
        for b in self.bucket_sizes:
            if b >= n:
                return b
        return self.max_batch

    def _dispatch_run(self) -> None:
        while not self._stop.is_set():
            groups = self._drain()
            if not groups:
                continue
            tr = self.tracer
            on = tr.on  # one reading a dispatch
            items = [fut for _, _, futs, _ in groups for fut in futs]
            try:
                parts = []
                for dev, ev, _, _ in groups:
                    if ev is not None:
                        torch.cuda.current_stream(self.device).wait_event(ev)
                        dev.record_stream(torch.cuda.current_stream(self.device))
                    parts.append(dev)
                n = sum(int(p.shape[0]) for p in parts)
                b = self._bucket(n)
                if b > n:
                    parts.append(parts[0].new_zeros((b - n, *parts[0].shape[1:])))
                batch = parts[0] if len(parts) == 1 else torch.cat(parts)
                self.steps.bump()
                self.frames.bump(n)
                step = self.steps.count
                traced, kw = None, {}
                if on:
                    t_provider = time.perf_counter_ns()
                    t_drained = self._drained_ns if self._drained_ns >= tr.start_ns else t_provider
                    tr.span("batcher.assemble", t_drained, t_provider, step)
                snapshot = self.gallery_provider()
                gallery_ids = snapshot[2] if len(snapshot) > 2 else None
                self._dispatch_count = (self._dispatch_count + 1) % (1 << 30)
                if on:
                    t_enqueue = time.perf_counter_ns()
                    tr.span("batcher.provider", t_provider, t_enqueue, step)
                    if self.device.type == "cuda":
                        traced = (step, torch.cuda.Event(enable_timing=True))
                        kw = {"start_event": traced[1]}
                out = self.engine.process_frames(
                    batch, snapshot[0], snapshot[1], gallery_k=self.top_k,
                    rotation=self._dispatch_count, **kw,
                )
                if on:
                    t_end = time.perf_counter_ns()
                    tr.span("batcher.enqueue", t_enqueue, t_end, step)
                    if traced is None:  # the CPU's step ran inside the call
                        tr.span(DEVICE, t_enqueue, t_end, step)
                        traced = (step, None)
                ev = None
                if self.device.type == "cuda":
                    ev = []
                    for d in self._devices:
                        e = torch.cuda.Event(enable_timing=traced is not None)
                        e.record(torch.cuda.current_stream(d))
                        ev.append(e)
                self._done.put((out, ev, items, gallery_ids, traced))
                if on:
                    tr.span("batcher.handoff", t_end, time.perf_counter_ns(), step)
                if self._stop.is_set():  # put-then-recheck against stop()
                    while True:
                        try:
                            entry = self._done.get_nowait()
                        except queue.Empty:
                            break
                        _fail_futures(entry[2], RuntimeError(_STOPPED))
            except Exception as e:  # noqa: BLE001 - scoped to this batch
                _fail_futures(items, e)
        if self._carry is not None:
            _fail_futures(self._carry[2], RuntimeError(_STOPPED))
            self._carry = None

    # ------------------------------------------------------------- stage 3

    def _complete_run(self) -> None:
        while not self._stop.is_set():
            try:
                out, ev, items, gallery_ids, traced = self._done.get(timeout=0.1)
            except queue.Empty:
                continue
            tr = self.tracer
            on = tr.on and traced is not None
            if on:
                t_take = time.perf_counter_ns()
            try:
                out = dict(out)
                lazy = {k: out.pop(k) for k in _LAZY_KEYS if k in out}
                if ev is not None:
                    with torch.cuda.stream(self._d2h_stream):
                        for e in ev:
                            self._d2h_stream.wait_event(e)
                        host = _to_host(out)
                else:
                    host = _to_host(out)
                step = -1
                if on:
                    step, start = traced
                    copied_ns = time.perf_counter_ns()
                    tr.span("batcher.d2h", t_take, copied_ns, step)
                    if start is not None:
                        tr.device_span(start, ev[0], step)
                for i, fut in enumerate(items):
                    result = _item(host, i)
                    for k, v in lazy.items():
                        result[k] = _LazySlice(v, (i,))
                    if gallery_ids is not None:
                        result["gallery_ids"] = gallery_ids
                    if step >= 0 and fut.id >= 0:
                        tr.span("batcher.fanout", copied_ns, time.perf_counter_ns(), fut.id, step)
                    try:
                        fut.set_result(result)
                    except InvalidStateError:
                        pass  # cancelled by its client; others still fan out
            except Exception as e:  # noqa: BLE001 - scoped to this batch
                _fail_futures(items, e)
