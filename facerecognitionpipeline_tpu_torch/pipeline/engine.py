"""RecognitionEngine: the fused detect -> align -> gate -> embed -> match step.

Counterpart of `facerecognitionpipeline_tpu/pipeline/engine.py`. The whole
step is one function (`step`) over a batch of frames on the device:

    frames [B,H,W,3] u8 (or planar I420) -> cascade (K1 x2) -> alignment
    (K1 stage A, K2 stage B) -> round/clip -> quality gate -> IR backbone
    -> gallery cosine top-k

and returns the same dict of [B, F, ...] tensors as the JAX step. Host code
only uploads frames and reads small results.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from facerecognitionpipeline_tpu_torch.gallery.search import _local_topk, template_rows
from facerecognitionpipeline_tpu_torch.ops.image import i420_to_rgb, normalize_face_batch
from facerecognitionpipeline_tpu_torch.ops.nms import top_k
from facerecognitionpipeline_tpu_torch.ops.quality import QualityConfig, quality_check
from facerecognitionpipeline_tpu_torch.ops.warp import align_faces_batch, reference_template


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
        input_format: str = "rgb",
        embed_budget: Optional[int] = None,
        shard_gallery: bool = False,
        gallery_impl: str = "auto",
        gallery_chunk: int = 4096,
        gallery_streaming_threshold: int = 32768,
    ):
        """Arguments as in the JAX engine, where ported:

        align_impl: 'kernel' (K1 stage A + K2 stage B; the counterpart of
        the JAX 'pallas') or 'auto' (= 'kernel'). embed_budget: None embeds
        every slot; K <= max_faces embeds the K best eligible slots per
        frame, with the `rotation` window of the JAX engine.

        gallery_impl: 'dense' (one matmul + top-k, which stores the [Q, G]
        similarity matrix), 'streaming' (kernel K3 of ops/gallery_kernel:
        one read of the gallery, no [Q, G] matrix; padded rows must divide
        `gallery_chunk`) or 'auto' (default): streaming on a CUDA device for
        bf16 templates of at least `gallery_streaming_threshold` padded rows
        that divide `gallery_chunk`, dense otherwise. An (int8 codes [G,D],
        per-row scales [G]) pair (DeviceGallery quantize='int8') overrides
        gallery_impl: it streams through kernel K4 whenever its rows divide
        `gallery_chunk` and takes the dense dequantising matmul otherwise.
        `DeviceGallery.device_snapshot` serves the bf16 copy (or the pair)
        at streaming scale. On a CPU device the streaming arms run the
        kernels' plain versions.

        Not ported yet (NotImplementedError, see ROADMAP.md): `mesh` and
        `shard_gallery` (multi-GPU, queue 1)."""
        if mesh is not None or shard_gallery:
            raise NotImplementedError(
                "mesh / shard_gallery: multi-GPU serving is queued in "
                "ROADMAP.md (queue 1, multi-GPU)"
            )
        if gallery_impl not in ("auto", "dense", "streaming"):
            raise ValueError(f"unknown gallery_impl {gallery_impl!r}")
        if align_impl == "auto":
            align_impl = "kernel"
        if align_impl != "kernel":
            raise ValueError(f"unknown align_impl {align_impl!r} (use 'kernel')")
        self.detector = detector
        self.embedder = embedder
        self.device = detector.device
        if embedder.device != self.device:
            raise ValueError("detector and embedder must share one device")
        self.quality_config = quality_config or QualityConfig(
            min_det_score=0.5, min_face_size=40, check_blur=True, blur_threshold=50.0
        )
        self.top_k = top_k
        self.align_size = align_size
        self.align_impl = align_impl
        self.align_patch = align_patch
        self.gallery_impl = gallery_impl
        self.gallery_chunk = gallery_chunk
        self.gallery_streaming_threshold = gallery_streaming_threshold
        # 'auto' streams only where the kernel runs: the plain version's
        # chunk loop (what 'streaming' means on the CPU) is slower there
        # than the dense matmul
        self._stream_on_auto = self.device.type == "cuda"
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
        self._template = torch.from_numpy(reference_template(align_size)).to(self.device)

    def host_frame_shape(self, h: int, w: int) -> tuple[int, ...]:
        """Per-frame host array shape the engine expects at det size (h, w)."""
        return (h * 3 // 2, w) if self.input_format == "i420" else (h, w, 3)

    # ------------------------------------------------------------ device step

    def _match(self, feats, templates, valid, k):
        """[B, X, D] features -> (scores [B, X, k] float32, idx [B, X, k]
        int64), dense or through the streaming kernels (see `__init__`)."""
        g = template_rows(templates)
        if isinstance(templates, tuple):  # (int8 codes, row scales)
            streaming = g >= self.gallery_chunk and g % self.gallery_chunk == 0
        elif self.gallery_impl == "streaming":
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
        if streaming and g % self.gallery_chunk:
            raise ValueError(
                f"gallery_impl='streaming' needs padded rows % gallery_chunk "
                f"== 0, got {g} rows with chunk {self.gallery_chunk}"
            )
        b, x, d = feats.shape
        scores, idx = _local_topk(
            feats.reshape(b * x, d), templates, valid, k,
            streaming=streaming, chunk=self.gallery_chunk,
        )
        return scores.reshape(b, x, k), idx.reshape(b, x, k)

    def step(self, templates, templates_valid, frames, gallery_k: int, rotation: int = 0):
        """frames on the device (RGB [B,H,W,3] or I420 [B,H*3//2,W] uint8)
        -> the result dict; no host round trips except NMS convergence
        checks."""
        with torch.inference_mode():
            return self._step_impl(templates, templates_valid, frames, gallery_k, rotation)

    def _step_impl(self, templates, templates_valid, frames, gallery_k, rotation):
        if self.input_format == "i420":
            h, w = frames.shape[1] * 2 // 3, frames.shape[2]
            frames_f32 = i420_to_rgb(frames, h, w)
        else:
            frames_f32 = frames.float()
        det = self.detector.detect_device(frames_f32)
        return self._recognize(
            frames_f32, det, templates, templates_valid, gallery_k, rotation
        )

    def _recognize(self, frames_f32, det, templates, templates_valid, gallery_k, rotation):
        """Everything after detection: align -> gate -> embed -> match."""
        aligned = align_faces_batch(
            frames_f32, det["landmarks"], self._template, self.align_size,
            patch_size=self.align_patch,
        )
        aligned = aligned.round().clamp(0.0, 255.0)
        ok, metrics = quality_check(
            det["scores"], det["bboxes"], det["landmarks"], self.quality_config,
            aligned_faces=aligned if self.quality_config.check_blur else None,
            valid_mask=det["valid"],
        )
        b, f = aligned.shape[:2]
        s = self.align_size
        dtype = self.embedder._dtype

        if self.embed_budget is None:
            x = normalize_face_batch(aligned, dtype=dtype)
            feats, norms = self.embedder.forward(x.reshape(b * f, s, s, 3))
            feats = feats.reshape(b, f, -1)
            norms = norms.reshape(b, f)
            embedded = torch.ones((b, f), dtype=torch.bool, device=self.device)
            scores, idx = self._match(feats, templates, templates_valid, gallery_k)
        else:
            # Per frame, embed the K best eligible slots (valid and
            # quality-ok, by det score, lower index first on ties), with
            # the window slid by `rotation` so a static scene cycles its
            # faces through the budget; scatter results back to [B, F].
            kb = self.embed_budget
            elig = det["valid"] & ok
            det_f = det["scores"].float()
            ii = torch.arange(f, device=self.device)
            before = (det_f[:, None, :] > det_f[:, :, None]) | (
                (det_f[:, None, :] == det_f[:, :, None])
                & (ii[None, None, :] < ii[None, :, None])
            )  # [B, i, j]: eligible j precedes i
            before &= elig[:, None, :]
            r = before.sum(dim=2)
            n_elig = elig.sum(dim=1, keepdim=True)
            shift = torch.remainder(r - int(rotation) * kb, n_elig.clamp_min(1))
            key = torch.where(
                elig, -shift.float(), torch.full_like(det_f, -1e9)
            )
            top_s, sel = top_k(key, kb)  # [B, kb]
            sel_ok = top_s > -1e8
            xs = normalize_face_batch(
                torch.gather(
                    aligned, 1, sel[:, :, None, None, None].expand(b, kb, s, s, 3)
                ),
                dtype=dtype,
            )
            feats_k, norms_k = self.embedder.forward(xs.reshape(b * kb, s, s, 3))
            d = feats_k.shape[-1]
            feats_k = feats_k.reshape(b, kb, d) * sel_ok[:, :, None]
            norms_k = norms_k.reshape(b, kb) * sel_ok
            sc_k, ix_k = self._match(feats_k, templates, templates_valid, gallery_k)
            sc_k = torch.where(sel_ok[:, :, None], sc_k, torch.full_like(sc_k, -1.0))
            ix_k = torch.where(sel_ok[:, :, None], ix_k, torch.zeros_like(ix_k))

            rows = torch.arange(b, device=self.device)[:, None]
            feats = feats_k.new_zeros((b, f, d))
            feats[rows, sel] = feats_k
            norms = norms_k.new_zeros((b, f))
            norms[rows, sel] = norms_k
            embedded = torch.zeros((b, f), dtype=torch.bool, device=self.device)
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
            "quality_ok": ok,
            "quality_metrics": metrics,
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
        gallery_valid: torch.Tensor,
        gallery_k: Optional[int] = None,
        rotation: int = 0,
    ) -> dict:
        """Frames (numpy or tensor; [B,H,W,3] uint8 for 'rgb', [B,H*3//2,W]
        for 'i420') -> the device result dict. `gallery_templates` is a
        [G, D] tensor or an int8 (codes, scales) pair. `rotation` is the
        embed-budget fairness counter (ignored without a budget)."""
        if isinstance(frames, np.ndarray):
            frames = torch.from_numpy(frames)
        frames = frames.to(self.device, non_blocking=True)
        return self.step(
            gallery_templates, gallery_valid, frames,
            gallery_k=gallery_k or self.top_k, rotation=rotation,
        )
