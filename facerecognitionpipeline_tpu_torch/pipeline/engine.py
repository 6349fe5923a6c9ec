"""RecognitionEngine: the fused detect -> align -> gate -> embed -> match step.

Counterpart of `facerecognitionpipeline_tpu/pipeline/engine.py`. The whole
step is one function (`step`) over a batch of frames on the device:

    frames [B,H,W,3] u8 (or planar I420) -> cascade (K1 x2, NMS's loop
    K5 x3) -> alignment (K1 stage A, K2 stage B) -> round/clip -> quality
    gate -> IR backbone -> gallery cosine top-k

and returns the same dict of [B, F, ...] tensors as the JAX step. Host code
only uploads frames and reads small results: on a CUDA device the step
holds no host synchronisation, and `process_frames` replays it as one CUDA
graph per (frame shape, gallery operands, k), the counterpart of the JAX
engine's one jitted program per shape (`pipeline/step_graph.py`).

Under a mesh (`mesh=`, from `parallel.make_mesh`) the frames split over
its 'data' axis: each shard runs detect, align, gate and embed on its own
device with a replica of the weights, matching runs per shard against a
replicated gallery or, with `shard_gallery=True`, as one
`dp_sharded_cosine_topk` over the gallery's row shards, and the results
are gathered onto the mesh's first device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from facerecognitionpipeline_tpu_torch.gallery.search import (
    _local_topk,
    dp_sharded_parts,
    template_rows,
)
from facerecognitionpipeline_tpu_torch.ops.image import i420_to_rgb, normalize_face_batch
from facerecognitionpipeline_tpu_torch.ops.nms import top_k
from facerecognitionpipeline_tpu_torch.ops.quality import QualityConfig, quality_check
from facerecognitionpipeline_tpu_torch.ops.warp import (
    align_faces,
    align_faces_batch,
    align_faces_matmul,
    reference_template,
)
from facerecognitionpipeline_tpu_torch.parallel.mesh import (
    Sharded,
    canonical_device,
    replicate,
)
from facerecognitionpipeline_tpu_torch.pipeline.step_graph import StepGraphs, wrap_int32


class _Shard:
    """What one data shard of the step runs with: the detector, the
    embedder and the alignment template on one device."""

    def __init__(self, detector, embedder, template, device):
        self.detector = detector
        self.embedder = embedder
        self.template = template
        self.device = device


class RecognitionEngine:
    """Owns the fused step; weights and gallery stay on the device."""

    def __init__(
        self,
        detector,
        embedder,
        quality_config: Optional[QualityConfig] = None,
        top_k: int = 3,
        align_size: int = 112,
        mesh=None,
        align_impl: str = "auto",
        align_patch: int = 128,
        align_chunk: int = 8,
        input_format: str = "rgb",
        embed_budget: Optional[int] = None,
        shard_gallery: bool = False,
        gallery_impl: str = "auto",
        gallery_chunk: int = 4096,
        gallery_streaming_threshold: int = 32768,
    ):
        """Arguments as in the JAX engine:

        mesh: a `parallel.Mesh` with a 'data' axis; the frame batch splits
        over it (B must be a multiple of the axis), one replica of the
        detector and embedder per shard device, results gathered onto the
        mesh's first device.

        align_impl: 'kernel' (K1 stage A + K2 stage B), 'pallas' (the JAX
        name of the same route), 'matmul' (stage A by the plain crop, stage
        B as a dense bilinear contraction, `ops/warp.align_faces_matmul`,
        `align_chunk` faces at a time) or 'gather' (the exact-bilinear
        gather path, `ops/warp.align_faces`); 'auto' = 'kernel'.
        embed_budget: None embeds every slot; K <= max_faces embeds the K
        best eligible slots per frame, with the `rotation` window of the
        JAX engine.

        shard_gallery: the gallery rows split over the mesh's 'data' axis
        (needs `mesh`); matching is `dp_sharded_cosine_topk`. Pass the
        templates already sharded (`DeviceGallery(mesh=...)` /
        `GalleryManager(mesh=...)`) to avoid a split per dispatch.

        gallery_impl: 'dense' (one matmul + top-k, which stores the [Q, G]
        similarity matrix), 'streaming' (kernel K3 of ops/gallery_kernel:
        one read of the gallery, no [Q, G] matrix; padded rows must divide
        `gallery_chunk`) or 'auto' (default): streaming on a CUDA device for
        bf16 templates of at least `gallery_streaming_threshold` padded rows
        that divide `gallery_chunk`, dense otherwise. An (int8 codes [G,D],
        per-row scales [G]) pair (DeviceGallery quantize='int8') overrides
        gallery_impl: it streams through kernel K4 whenever its rows (per
        shard under `shard_gallery`) divide `gallery_chunk` and takes the
        dense dequantising matmul otherwise. `DeviceGallery.device_snapshot`
        serves the bf16 copy (or the pair) at streaming scale. On a CPU
        device the streaming arms run the kernels' plain versions."""
        if gallery_impl not in ("auto", "dense", "streaming"):
            raise ValueError(f"unknown gallery_impl {gallery_impl!r}")
        if align_impl == "auto":
            align_impl = "kernel"
        if align_impl == "pallas":
            align_impl = "kernel"
        if align_impl not in ("kernel", "matmul", "gather"):
            raise ValueError(f"unknown align_impl {align_impl!r}")
        if shard_gallery and (mesh is None or "data" not in mesh.shape):
            raise ValueError(
                "shard_gallery=True needs a mesh with a 'data' axis "
                "(the gallery shards over the same axis the frames do)"
            )
        self.detector = detector
        self.embedder = embedder
        self.mesh = mesh
        self.shard_gallery = shard_gallery
        if canonical_device(embedder.device) != canonical_device(detector.device):
            raise ValueError("detector and embedder must share one device")
        self.quality_config = quality_config or QualityConfig(
            min_det_score=0.5, min_face_size=40, check_blur=True, blur_threshold=50.0
        )
        self.top_k = top_k
        self.align_size = align_size
        self.align_impl = align_impl
        self.align_patch = align_patch
        self.align_chunk = align_chunk
        self.gallery_impl = gallery_impl
        self.gallery_chunk = gallery_chunk
        self.gallery_streaming_threshold = gallery_streaming_threshold
        max_faces = detector.max_faces
        if embed_budget is not None:
            if not 1 <= embed_budget <= max_faces:
                raise ValueError(
                    f"embed_budget={embed_budget} must be in [1, "
                    f"max_faces={max_faces}]"
                )
            if embed_budget == max_faces:
                embed_budget = None  # full budget == the dense path
        self.embed_budget = embed_budget
        if input_format not in ("rgb", "i420"):
            raise ValueError(f"unknown input_format {input_format!r}")
        if input_format == "i420":
            dh, dw = detector.det_size
            if dh % 4 or dw % 2:
                raise ValueError(
                    f"i420 input needs det height % 4 == 0 and width % 2 "
                    f"== 0, got det_size {(dh, dw)}"
                )
        self.input_format = input_format
        template = torch.from_numpy(reference_template(align_size))
        if mesh is None:
            self.device = detector.device
            self._shards = [_Shard(detector, embedder, template.to(self.device), self.device)]
        else:
            self.device = mesh.first
            self._shards = [
                _Shard(replicate(detector, d), replicate(embedder, d), template.to(d), d)
                for d in mesh.axis_devices("data")
            ]
        # 'auto' streams only where the kernel runs: the plain version's
        # chunk loop (what 'streaming' means on the CPU) is slower there
        # than the dense matmul
        self._stream_on_auto = self.device.type == "cuda"
        self._gallery_copies: tuple = (None, {})
        self._graphs: Optional[StepGraphs] = None  # made at the first CUDA step

    def host_frame_shape(self, h: int, w: int) -> tuple[int, ...]:
        """Per-frame host array shape the engine expects at det size (h, w)."""
        return (h * 3 // 2, w) if self.input_format == "i420" else (h, w, 3)

    # ------------------------------------------------------------ device step

    def _streams(self, templates) -> bool:
        """Whether matching takes the streaming arm (see `__init__`)."""
        g = template_rows(templates)
        if isinstance(templates, tuple):  # (int8 codes, row scales)
            rows = g // len(self._shards) if self.shard_gallery else g
            return rows >= self.gallery_chunk and rows % self.gallery_chunk == 0
        if self.gallery_impl == "streaming":
            streaming = True
        elif self.gallery_impl == "dense":
            streaming = False
        else:
            streaming = (
                self._stream_on_auto
                and templates.dtype == torch.bfloat16
                and g >= self.gallery_streaming_threshold
                and g % self.gallery_chunk == 0
            )
        if streaming and not self.shard_gallery and g % self.gallery_chunk:
            raise ValueError(
                f"gallery_impl='streaming' needs padded rows % gallery_chunk "
                f"== 0, got {g} rows with chunk {self.gallery_chunk}"
            )
        return streaming

    def _match(self, feats, templates, valid, k):
        """[B, X, D] features -> (scores [B, X, k] float32, idx [B, X, k]
        int64), dense or through the streaming kernels, on one device."""
        b, x, d = feats.shape
        scores, idx = _local_topk(
            feats.reshape(b * x, d), templates, valid, k,
            streaming=self._streams(templates), chunk=self.gallery_chunk,
        )
        return scores.reshape(b, x, k), idx.reshape(b, x, k)

    def _gallery_on(self, device, templates, valid):
        """The gallery operands on `device`, for a data shard matching
        against a replicated gallery: as they are when they lie there, else
        copies kept while the same operands come back (one generation)."""
        if _lies_on(templates, device) and _lies_on(valid, device):
            return templates, valid
        owner, copies = self._gallery_copies
        if owner is None or owner[0] is not templates or owner[1] is not valid:
            copies = {}
            self._gallery_copies = ((templates, valid), copies)
        if device not in copies:
            copies[device] = (_moved(templates, device), _moved(valid, device))
        return copies[device]

    def step(self, templates, templates_valid, frames, gallery_k: int, rotation=0):
        """frames on the device (RGB [B,H,W,3] or I420 [B,H*3//2,W] uint8)
        -> the result dict, eagerly (the counterpart of the JAX engine's
        un-jitted `_step_impl`): no host round trip on a CUDA device.
        `rotation`: an int or a 0-d int32 tensor."""
        with torch.inference_mode():
            return self._step_impl(templates, templates_valid, frames, gallery_k, rotation)

    def _step_impl(self, templates, templates_valid, frames, gallery_k, rotation):
        n = len(self._shards)
        if frames.shape[0] % n:
            raise ValueError(
                f"batch of {frames.shape[0]} frames is not a multiple of the "
                f"mesh 'data' axis ({n})"
            )
        per = frames.shape[0] // n
        parts = [
            self._shard_part(i, frames[i * per:(i + 1) * per], rotation, templates,
                             templates_valid, gallery_k)
            for i in range(n)
        ]
        return self._combine(parts, templates, templates_valid, gallery_k)

    def _shard_part(self, i, frames, rotation, templates, templates_valid, gallery_k):
        """What data shard `i` computes on its own device from its slice of
        the frames: the result dict against a replicated gallery, or, under
        `shard_gallery`, the state before matching. One CUDA graph each in
        `process_frames` (`pipeline/step_graph.py`)."""
        sh = self._shards[i]
        fr = frames.to(sh.device)
        if self.input_format == "i420":
            h, w = fr.shape[1] * 2 // 3, fr.shape[2]
            fr = i420_to_rgb(fr, h, w)
        else:
            fr = fr.float()
        det = sh.detector.detect_device(fr)
        st = self._embed(sh, fr, det, rotation)
        if self.shard_gallery:
            return st
        sc, ix = self._match(
            st["q"], *self._gallery_on(sh.device, templates, templates_valid), gallery_k
        )
        return self._finish(st, sc, ix, gallery_k)

    def _combine(self, parts, templates, templates_valid, gallery_k):
        """The shards' parts -> one result dict: under `shard_gallery` the
        match over the gallery's row shards and each shard's results first;
        then the gather onto the mesh's first device. Eager in every route."""
        if self.shard_gallery:
            matches = dp_sharded_parts(
                self.mesh, [st["q"] for st in parts], templates, templates_valid,
                gallery_k, axis="data", streaming=self._streams(templates),
                chunk=self.gallery_chunk,
            )
            parts = [self._finish(st, sc, ix, gallery_k) for st, (sc, ix) in zip(parts, matches)]
        if len(parts) == 1:
            return parts[0]
        return _gather(parts, self.device)

    def _align(self, sh: _Shard, frames_f32, landmarks):
        """[B,H,W,3] x [B,F,5,2] -> aligned [B,F,out,out,3] float32."""
        if self.align_impl == "kernel":
            return align_faces_batch(
                frames_f32, landmarks, sh.template, self.align_size,
                patch_size=self.align_patch,
            )
        if self.align_impl == "matmul":
            per_frame = [
                align_faces_matmul(
                    img, lmk, sh.template, self.align_size,
                    patch_size=self.align_patch, face_chunk=self.align_chunk,
                )
                for img, lmk in zip(frames_f32, landmarks)
            ]
        else:
            per_frame = [
                align_faces(img, lmk, sh.template, self.align_size)
                for img, lmk in zip(frames_f32, landmarks)
            ]
        return torch.stack(per_frame)

    def _embed(self, sh: _Shard, frames_f32, det, rotation) -> dict:
        """Align -> gate -> embed on one shard's device. Returns the step's
        state before matching; "q" holds the queries to match ([B, F, D],
        or [B, kb, D] under an embed budget)."""
        aligned = self._align(sh, frames_f32, det["landmarks"])
        aligned = aligned.round().clamp(0.0, 255.0)
        ok, metrics = quality_check(
            det["scores"], det["bboxes"], det["landmarks"], self.quality_config,
            aligned_faces=aligned if self.quality_config.check_blur else None,
            valid_mask=det["valid"],
        )
        b, f = aligned.shape[:2]
        s = self.align_size
        dtype = sh.embedder._dtype
        st = {"det": det, "aligned": aligned, "ok": ok, "metrics": metrics}
        if self.embed_budget is None:
            x = normalize_face_batch(aligned, dtype=dtype)
            feats, norms = sh.embedder.forward(x.reshape(b * f, s, s, 3))
            st["q"] = feats.reshape(b, f, -1)
            st["norms"] = norms.reshape(b, f)
            return st
        # Per frame, embed the K best eligible slots (valid and quality-ok,
        # by det score, lower index first on ties), with the window slid by
        # `rotation` so a static scene cycles its faces through the budget.
        kb = self.embed_budget
        dev = aligned.device
        elig = det["valid"] & ok
        det_f = det["scores"].float()
        ii = torch.arange(f, device=dev)
        before = (det_f[:, None, :] > det_f[:, :, None]) | (
            (det_f[:, None, :] == det_f[:, :, None])
            & (ii[None, None, :] < ii[None, :, None])
        )  # [B, i, j]: eligible j precedes i
        before &= elig[:, None, :]
        r = before.sum(dim=2)
        n_elig = elig.sum(dim=1, keepdim=True)
        # r - rotation * kb in int32 with wrap-around, as the JAX engine
        # computes it: in int64 here, wrapped to int32 explicitly
        rot = rotation_tensor(rotation, dev).long()
        lag = torch.remainder(r - rot * kb + 2**31, 2**32) - 2**31
        shift = torch.remainder(lag, n_elig.clamp_min(1))
        key = torch.where(elig, -shift.float(), torch.full_like(det_f, -1e9))
        top_s, sel = top_k(key, kb)  # [B, kb]
        sel_ok = top_s > -1e8
        xs = normalize_face_batch(
            torch.gather(aligned, 1, sel[:, :, None, None, None].expand(b, kb, s, s, 3)),
            dtype=dtype,
        )
        feats_k, norms_k = sh.embedder.forward(xs.reshape(b * kb, s, s, 3))
        d = feats_k.shape[-1]
        st["q"] = feats_k.reshape(b, kb, d) * sel_ok[:, :, None]
        st["norms"] = norms_k.reshape(b, kb) * sel_ok
        st["sel"], st["sel_ok"] = sel, sel_ok
        return st

    def _finish(self, st: dict, scores, idx, gallery_k) -> dict:
        """The result dict of one shard from its state and its matches;
        under a budget the compacted results scatter back to [B, F]."""
        det, aligned = st["det"], st["aligned"]
        b, f = aligned.shape[:2]
        dev = aligned.device
        if self.embed_budget is None:
            feats, norms = st["q"], st["norms"]
            embedded = torch.ones((b, f), dtype=torch.bool, device=dev)
        else:
            sel, sel_ok = st["sel"], st["sel_ok"]
            feats_k, norms_k = st["q"], st["norms"]
            sc_k = torch.where(sel_ok[:, :, None], scores, torch.full_like(scores, -1.0))
            ix_k = torch.where(sel_ok[:, :, None], idx, torch.zeros_like(idx))
            rows = torch.arange(b, device=dev)[:, None]
            feats = feats_k.new_zeros((b, f, feats_k.shape[-1]))
            feats[rows, sel] = feats_k
            norms = norms_k.new_zeros((b, f))
            norms[rows, sel] = norms_k
            embedded = torch.zeros((b, f), dtype=torch.bool, device=dev)
            embedded[rows, sel] = sel_ok
            scores = sc_k.new_full((b, f, gallery_k), -1.0)
            scores[rows, sel] = sc_k
            idx = ix_k.new_zeros((b, f, gallery_k))
            idx[rows, sel] = ix_k
        return {
            "bboxes": det["bboxes"],
            "det_scores": det["scores"],
            "landmarks": det["landmarks"],
            "face_valid": det["valid"],
            "quality_ok": st["ok"],
            "quality_metrics": st["metrics"],
            "aligned": aligned.to(torch.uint8),
            "embedded": embedded,
            "embeddings": feats,
            "embedding_norms": norms,
            "match_scores": scores,
            "match_idx": idx,
        }

    # ---------------------------------------------------------------- host API

    def process_frames(
        self,
        frames,
        gallery_templates,
        gallery_valid,
        gallery_k: Optional[int] = None,
        rotation: int = 0,
        start_event=None,
    ) -> dict:
        """Frames (numpy or tensor; [B,H,W,3] uint8 for 'rgb', [B,H*3//2,W]
        for 'i420') -> the device result dict. `gallery_templates` is a
        [G, D] tensor or an int8 (codes, scales) pair (under a mesh also
        `Sharded`, as `DeviceGallery(mesh=...)` hands them out). `rotation`
        is the embed-budget fairness counter (ignored without a budget), an
        int that the step takes as an int32, wrapping as the JAX engine's.

        On a CUDA device the step runs as one CUDA graph per key and data
        shard (`pipeline/step_graph.py`), captured on first use of the key
        and printed to stderr, as the JAX engine compiles one program per
        key; on the CPU it runs eagerly (`step`). `start_event`, a CUDA
        timing event, is recorded on the step's stream right before its
        first device operation (the batcher's tracer times the step from
        it); the CPU route takes none."""
        if isinstance(frames, np.ndarray):
            frames = torch.from_numpy(frames)
        frames = frames.to(self.device, non_blocking=True)
        k = gallery_k or self.top_k
        if self.device.type == "cuda":
            if self._graphs is None:
                self._graphs = StepGraphs(self)
            return self._graphs.run(frames, gallery_templates, gallery_valid, k, rotation,
                                    start_event)
        return self.step(gallery_templates, gallery_valid, frames, gallery_k=k, rotation=rotation)


def rotation_tensor(rotation, device) -> torch.Tensor:
    """The embed-budget rotation as a 0-d int32 tensor on `device`: a
    tensor moved there (nothing is done to one that lies there already), an
    int wrapped to int32 and filled there (no host copy)."""
    if isinstance(rotation, torch.Tensor):
        return rotation.to(device=device, dtype=torch.int32)
    return torch.full((), wrap_int32(rotation), dtype=torch.int32, device=device)


def _gather(outs: list, device):
    """Per-shard result dicts -> one dict, concatenated along the batch on
    `device`."""
    first = outs[0]
    if isinstance(first, dict):
        return {k: _gather([o[k] for o in outs], device) for k in first}
    return torch.cat([o.to(device) for o in outs])


def _lies_on(x, device) -> bool:
    """Whether a gallery operand (tensor or int8 pair; a `Sharded` one never)
    lies whole on `device`."""
    if isinstance(x, tuple):
        return all(_lies_on(v, device) for v in x)
    return isinstance(x, torch.Tensor) and canonical_device(x.device) == device


def _moved(x, device):
    """A gallery operand whole on `device`."""
    if isinstance(x, tuple):
        return tuple(_moved(v, device) for v in x)
    return x.gather(device) if isinstance(x, Sharded) else x.to(device)
