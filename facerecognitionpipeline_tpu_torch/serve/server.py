"""Streaming recognition server: HTTP edge + batched recognition core on a GPU.

Counterpart of `facerecognitionpipeline_tpu/serve/server.py`, API-compatible
with the reference Flask server: same routes (GET /health /stats, POST
/init_session /process_frame /process_frame_raw /process_faces /save_snapshot
/finalize /reload_gallery), same request/response payloads (base64 PNG frames
in; tracks / recognized_tracks / recognition_attempts / failed_tracks /
newly_recognized / newly_failed / performance out), same session artifacts
(`session.json`, `attendance.json`, recognized/unrecognized face crops,
snapshots, performance reports).

The core:
* every frame runs the ONE fused detect->align->gate->embed->match step via
  `DeviceBatcher`, so concurrent clients share device batches — recognition
  reuses the per-face top-k already computed on the device instead of
  re-embedding the buffered crop;
* stdlib ThreadingHTTPServer, no web framework;
* aligned crops stay on the device until something persists them;
* server-side tracking with a real centroid tracker, and stale-track
  clean-up on the right object;
* POST /process_frame_raw accepts raw letterboxed planes as octet-stream
  (rawproto.py): the per-frame base64 + image decode on the host drops to a
  frombuffer + reshape;
* POST /reload_gallery hot-swaps enrollment from the configured pickle
  without a restart.

One deliberate difference in behaviour from the JAX package's server: a
request body that stalls is waited for a bounded time only (`_read_body`), so
a stalled client releases its handler thread. Responses carry the same bytes;
they leave with TCP_NODELAY so that the body does not wait for the client's
delayed ACK of the headers.

`quantize='int8'` serves the post-training-quantized embedder and detector
(int8 res convs, int8 R/O-nets; `models/quantize.py`), calibrated on
synthetic renders or on the aligned crops under `quantize_calib`.

`mesh_data=n` serves the fused step data-parallel over n devices (the
first n CUDA devices; with device='cpu', n CPU entries), and
`shard_gallery` row-shards the gallery over that axis
(`pipeline/engine.py`, `parallel/mesh.py`).
"""

from __future__ import annotations

import argparse
import base64
import math
import json
import os
import re
import signal
import sys
import threading
import traceback
from datetime import datetime
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

import numpy as np
import torch

from facerecognitionpipeline_tpu_torch.gallery.manager import GalleryManager
from facerecognitionpipeline_tpu_torch.models.irse import BACKBONE_CONFIGS
from facerecognitionpipeline_tpu_torch.ops import (
    crop_kernel,
    gallery_kernel,
    nms_kernel,
    warp_kernel,
)
from facerecognitionpipeline_tpu_torch.ops.quality import QualityConfig
from facerecognitionpipeline_tpu_torch.serve import rawproto
from facerecognitionpipeline_tpu_torch.serve.batcher import DeviceBatcher
from facerecognitionpipeline_tpu_torch.serve.tracker import (
    LiveRecognitionTracker,
    SimpleTracker,
)
from facerecognitionpipeline_tpu_torch.telemetry.monitor import PerformanceMonitorServer
from facerecognitionpipeline_tpu_torch.utils.device import resolve_device
from facerecognitionpipeline_tpu_torch.utils.io import (
    decode_image_rgb,
    encode_image_rgb,
    imwrite_rgb,
)


_SAFE_COMPONENT = re.compile(r"[A-Za-z0-9][A-Za-z0-9_.\-]*")

# the line a CLI process prints on its way out: the kernels it launched
# since its server was ready (`FaceRecognitionServer.launch_report`)
LAUNCH_LINE = "[kernels] "


def launch_counts() -> Dict[str, int]:
    """The launch counters of the port's kernels (`ops/*_kernel.py`), by
    kernel."""
    return {
        "crop_resize": crop_kernel.LAUNCHES.count,
        "warp_patches": warp_kernel.LAUNCHES.count,
        "gallery_topk": gallery_kernel.LAUNCHES.count,
        "gallery_topk_int8": gallery_kernel.LAUNCHES_INT8.count,
        "gallery_topk_f32": gallery_kernel.LAUNCHES_F32.count,
        "nms_fixpoint": nms_kernel.LAUNCHES.count,
    }


def _safe_path_component(value, what: str) -> str:
    """Reject client-supplied strings that could escape output_dir when
    joined into filesystem paths."""
    s = str(value)
    if not _SAFE_COMPONENT.fullmatch(s) or ".." in s:
        raise ValueError(
            f"invalid {what}: {s!r} (allowed: [A-Za-z0-9_.-], no leading "
            f"separator, no '..')"
        )
    return s


def _decode_image_b64(data: str) -> Optional[np.ndarray]:
    """base64 (PNG/JPEG bytes) -> RGB uint8 array; None when the payload is
    not a decodable image."""
    try:
        raw = base64.b64decode(data)
    except (ValueError, TypeError):
        return None
    return decode_image_rgb(raw)


def _encode_png_bytes(image_rgb: np.ndarray) -> bytes:
    return encode_image_rgb(image_rgb, "png")


class FaceRecognitionServer:
    """Session + recognition core; the HTTP layer delegates here."""

    def __init__(
        self,
        gallery_path: str = "gallery/students.pkl",
        similarity_threshold: float = 0.5,
        output_dir: str = "sessions",
        session_name: Optional[str] = None,
        model_type: str = "adaface",
        architecture: str = "ir_101",
        model_path: Optional[str] = None,
        detector_weights: Optional[str] = None,
        det_size: tuple[int, int] = (640, 640),
        max_faces: int = 16,
        recognition_interval: int = 30,
        max_recognition_attempts: int = 3,
        frame_buffer_size: int = 10,
        max_tracking_distance: float = 100.0,
        high_quality_crop_size: int = 600,
        enable_performance_monitoring: bool = True,
        batch_max: int = 8,
        batch_wait_ms: float = 5.0,
        engine=None,
        gallery: Optional[GalleryManager] = None,
        warmup: bool = True,
        mesh_data: Optional[int] = None,
        batch_buckets: Optional[tuple[int, ...]] = None,
        transport: str = "rgb",
        tracker_mode: str = "server",
        embed_budget: Optional[int] = None,
        quantize: Optional[str] = None,
        quantize_calib: Optional[str] = None,
        shard_gallery: bool = False,
        max_requests: Optional[int] = None,
        legacy_faces_route: bool = False,
        gallery_quantize: Optional[str] = None,
        device="cuda",
    ):
        """device: where the detector, the embedder, the gallery templates
        and the batcher's streams live. 'cuda' (the default) raises without a
        card; a CPU server exists only because a caller passed 'cpu'. With a
        pre-built `engine` the engine's own device is used.
        mesh_data: split the fused step data-parallel over this many
        devices (`parallel.make_mesh(data=mesh_data)`: the first CUDA
        devices, or mesh_data CPU entries with device='cpu'); batch_max must
        be a multiple. A pre-built `engine` brings its own mesh.
        shard_gallery: row-shard the gallery templates over the mesh's
        'data' axis (needs a mesh).
        batch_buckets: batch shapes the step runs at (default (1, batch_max)
        — a lone client pays a B=1 step instead of batch_max x padded
        compute).
        tracker_mode: 'server' = retry-cooldown gating (reference server
        semantics); 'live' = every-Nth-frame gating with permanent
        attempts (reference live-app semantics; used by serve/live.py).
        transport: 'rgb' uploads [H,W,3] frames to the device; 'i420'
        converts to planar YUV 4:2:0 on the host and back to RGB on the
        device — half the host->device bytes per frame.
        embed_budget: embed/match only the K best quality-passing faces
        per frame instead of every one of the max_faces slots (see the
        RecognitionEngine docstring). Faces beyond the budget are still
        detected/tracked; recognition for them retries on later frames.
        quantize: None or 'int8' — post-training-quantized embedder (int8
        res convs, static calibrated activation scales) AND detector (int8
        R/O-net convs/fc); see models/quantize.py for the scheme and its
        calibration caveat.
        quantize_calib: directory of aligned face crops to calibrate the
        int8 embedder on (load_calibration_faces; ValueError when it holds
        none) instead of the synthetic default.
        gallery_quantize: None or 'int8' — at streaming scale (>= 32k ids)
        the device templates become int8 codes + per-row scales, searched
        by the int8 streaming top-k kernel.
        max_requests: after this many frame-processing requests the server
        requests a recycle — the HTTP loop drains and the process exits
        with code 75 so the supervisor (`--max_requests` CLI mode) can
        respawn a fresh worker. Operational bound on per-request memory
        retained outside this package (native libraries, allocator
        fragmentation). Session state is continuously flushed to disk and
        the respawned worker resumes it, so a recycle loses only in-flight
        tracker state (tracks re-form; attendance dedupes by student)."""
        self.device = (
            resolve_device(device) if engine is None
            else torch.device(engine.device)
        )
        self.similarity_threshold = similarity_threshold
        self.output_dir = output_dir
        self.model_type = model_type
        self.architecture = architecture
        self.det_size = det_size
        self.recognition_interval = recognition_interval
        self.max_recognition_attempts = max_recognition_attempts
        self.frame_buffer_size = frame_buffer_size
        self.max_tracking_distance = max_tracking_distance
        self.high_quality_crop_size = high_quality_crop_size
        self.enable_performance_monitoring = enable_performance_monitoring
        if tracker_mode not in ("server", "live"):
            raise ValueError(f"unknown tracker_mode {tracker_mode!r}")
        self.tracker_mode = tracker_mode

        # mesh before gallery: a shard_gallery deployment places the
        # template shards at build time, not per dispatch
        mesh = getattr(engine, "mesh", None)
        if engine is None and mesh_data and mesh_data > 1:
            from facerecognitionpipeline_tpu_torch.parallel.mesh import make_mesh

            mesh = make_mesh(
                data=mesh_data,
                devices=[self.device] * mesh_data if self.device.type == "cpu" else None,
            )
            if batch_max % mesh_data:
                raise ValueError(
                    f"batch_max={batch_max} must be a multiple of "
                    f"mesh_data={mesh_data}"
                )
            self.device = mesh.first
        wants_shard = (
            shard_gallery if engine is None
            else getattr(engine, "shard_gallery", False)
        )
        if wants_shard and (mesh is None or "data" not in mesh.shape):
            raise ValueError(
                "shard_gallery requires a data-parallel mesh "
                "(--mesh_data >= 2)"
            )
        self.gallery = gallery or GalleryManager(
            gallery_path=gallery_path, mesh=mesh if wants_shard else None,
            quantize=gallery_quantize, device=self.device,
        )
        # (mtime_ns, size) of the last pickle loaded via /reload_gallery —
        # None means "never reloaded", so the first reload always loads
        self._gallery_file_sig = None

        if engine is None:
            from facerecognitionpipeline_tpu_torch.models.detector import MTCNNDetector
            from facerecognitionpipeline_tpu_torch.pipeline.embedder import FaceEmbedder
            from facerecognitionpipeline_tpu_torch.pipeline.engine import RecognitionEngine

            # quantize='int8' covers the detector too: its R/O-net convs/fc
            # calibrate on synthetic full-frame scenes at det_size
            detector = MTCNNDetector(
                det_size=det_size, det_thresh=0.5, max_faces=max_faces,
                min_face_size=40, dtype=torch.bfloat16,
                weights_path=detector_weights, quantize=quantize,
                device=self.device,
            )
            calib_faces = None
            if quantize_calib is not None:
                from facerecognitionpipeline_tpu_torch.models.quantize import (
                    load_calibration_faces,
                )

                calib_faces = load_calibration_faces(quantize_calib)
            embedder = FaceEmbedder(
                architecture=architecture, model_type=model_type,
                model_path=model_path, dtype=torch.bfloat16,
                quantize=quantize, calib_faces=calib_faces,
                device=self.device,
            )
            engine = RecognitionEngine(
                detector,
                embedder,
                quality_config=QualityConfig(
                    min_det_score=0.5, min_face_size=40,
                    check_blur=True, blur_threshold=50.0,
                ),
                top_k=3,
                mesh=mesh,
                input_format=transport,
                embed_budget=embed_budget,
                shard_gallery=shard_gallery,
            )
        self.engine = engine
        engine_format = getattr(engine, "input_format", "rgb")
        if transport != "rgb" and engine_format != transport:
            raise ValueError(
                f"transport={transport!r} but the provided engine expects "
                f"input_format={engine_format!r} — build the engine with "
                f"input_format={transport!r} or drop the transport flag"
            )
        self.transport = engine_format
        self.batcher = DeviceBatcher(
            engine, self.gallery.device_snapshot,
            max_batch=batch_max, max_wait_ms=batch_wait_ms, top_k=3,
            bucket_sizes=batch_buckets,
        )
        self.batcher.start()
        if warmup:
            # Run every batch bucket before accepting traffic: the first
            # request must not pay (and time out on) first-use costs
            # (kernel builds, cuDNN algorithm selection, allocator growth).
            print(
                f"Warming the recognition engine "
                f"(buckets {self.batcher.bucket_sizes})...", file=sys.stderr
            )
            self.batcher.warmup(det_size)
            print("Engine ready.", file=sys.stderr)
        self._ready_launches = launch_counts()

        # session state
        self.session_name: Optional[str] = None
        self.session_dir: Optional[str] = None
        self.perf_monitor: Optional[PerformanceMonitorServer] = None
        self.tracker: Optional[LiveRecognitionTracker] = None
        self.motion_tracker: Optional[SimpleTracker] = None
        self.session_start: Optional[datetime] = None
        self.frame_count = 0
        self.total_faces_detected = 0
        self.total_recognition_attempts = 0
        self._lock = threading.Lock()
        self._io_lock = threading.Lock()

        # POST /process_faces (legacy client-side detection) is opt-in:
        # accepting client-chosen crops widens the input surface for no
        # benefit on the modern path (see process_faces docstring)
        self.legacy_faces_route = legacy_faces_route

        # worker-recycle accounting (see max_requests in the docstring);
        # own lock: the counter increments on every handler thread, and
        # _lock/_io_lock can be held for a whole frame / disk write
        self.max_requests = max_requests
        self._requests_served = 0
        self._recycle_requested = False
        self._recycle_lock = threading.Lock()
        self._httpd = None  # set by serve(); shutdown target for recycling

        if session_name:
            self._create_session(session_name)

    # --------------------------------------------------------------- session

    def _create_session(self, session_name: str, resume: bool = False) -> None:
        session_name = _safe_path_component(session_name, "session_name")
        # Session swaps must serialize with in-flight frames: a concurrent
        # /process_frame reads tracker/session state under self._lock.
        with self._lock:
            self._create_session_locked(session_name, resume=resume)

    def _create_session_locked(
        self, session_name: str, resume: bool = False
    ) -> None:
        session_dir = os.path.join(self.output_dir, session_name)
        prior = self._load_resumable_session(session_dir) if resume else None
        if resume and prior is None and os.path.exists(
            os.path.join(session_dir, "session.json")
        ):
            # Resume miss on a session that EXISTS but is no longer active
            # (e.g. /finalize landed during the recycle drain window):
            # re-initializing here would overwrite the completed session's
            # session.json/attendance.json with fresh empty files.
            # Leave the artifacts untouched and start with no active
            # session — clients open a new one via /init_session.
            print(
                f"[recycle] session {session_name!r} was finalized during "
                f"the drain; leaving its artifacts untouched (no active "
                f"session)",
                file=sys.stderr,
            )
            return
        self.session_name = session_name
        self.session_dir = session_dir
        os.makedirs(self.session_dir, exist_ok=True)

        if self.enable_performance_monitoring:
            model_id = f"{self.model_type.upper()}_{self.architecture.upper()}_CUDA"
            self.perf_monitor = PerformanceMonitorServer(
                model_identifier=model_id,
                session_name=session_name,
                output_dir=self.session_dir,
                latency_window_size=100,
                device=self.device,
            )

        live = self.tracker_mode == "live"
        self.tracker = LiveRecognitionTracker(
            recognition_interval=self.recognition_interval,
            max_attempts=self.max_recognition_attempts,
            buffer_size=self.frame_buffer_size,
            retry_cooldown=math.inf if live else 10.0,
            frame_interval_gating=live,
        )
        self.motion_tracker = SimpleTracker(
            max_disappeared=30, max_distance=self.max_tracking_distance
        )

        self.recognized_faces_dir = os.path.join(self.session_dir, "recognized_faces")
        self.unrecognized_faces_dir = os.path.join(
            self.session_dir, "unrecognized_faces"
        )
        self.snapshots_dir = os.path.join(self.session_dir, "snapshots")
        for d in (self.recognized_faces_dir, self.unrecognized_faces_dir,
                  self.snapshots_dir):
            os.makedirs(d, exist_ok=True)

        self.session_start = datetime.now()
        self.frame_count = 0
        self.total_faces_detected = 0
        self.total_recognition_attempts = 0
        if prior is not None:
            # Recycled worker re-opening the session it inherited: keep the
            # on-disk attendance and fold the previous worker's counters in
            # (session.json/attendance.json are continuously flushed, so
            # this is the reference's crash-resume story — here it is
            # also the recycle handoff).
            stats = prior.get("statistics", {})
            self.frame_count = int(stats.get("total_frames_processed", 0))
            self.total_faces_detected = int(stats.get("total_faces_detected", 0))
            self.total_recognition_attempts = int(
                stats.get("total_recognition_attempts", 0)
            )
            start = prior.get("start_time")
            if start:
                try:
                    self.session_start = datetime.fromisoformat(start)
                except ValueError:
                    pass
            print(
                f"Session resumed: {session_name} -> {self.session_dir} "
                f"(frames so far: {self.frame_count})"
            )
        else:
            self._init_session_files()
            print(f"Session created: {session_name} -> {self.session_dir}")

    def _load_resumable_session(self, session_dir: str) -> Optional[Dict]:
        """The existing session.json if this session can be resumed
        (exists, parses, still active), else None (fresh init)."""
        path = os.path.join(session_dir, "session.json")
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            return None
        return data if data.get("status") == "active" else None

    def _init_session_files(self) -> None:
        self._write_session(
            {
                "session_id": self.session_name,
                "start_time": self.session_start.isoformat(),
                "end_time": None,
                "status": "active",
                "settings": {
                    "similarity_threshold": self.similarity_threshold,
                    "recognition_interval": self.recognition_interval,
                    "max_recognition_attempts": self.max_recognition_attempts,
                },
                "statistics": {
                    "total_frames_processed": 0,
                    "total_faces_detected": 0,
                    "total_recognition_attempts": 0,
                    "unique_students_recognized": 0,
                    "unrecognized_tracks": 0,
                },
            }
        )
        # under _io_lock: re-initializing the SAME session name must not
        # interleave with an in-flight frame's attendance write (same
        # _lock -> _io_lock order as finalize; never the reverse)
        with self._io_lock:
            self._write_attendance(
                {
                    "session_id": self.session_name,
                    "last_updated": datetime.now().isoformat(),
                    "recognized": [],
                    "unrecognized": [],
                }
            )

    def _write_session(self, data: Dict) -> None:
        with open(os.path.join(self.session_dir, "session.json"), "w") as f:
            json.dump(data, f, indent=2)

    def _write_attendance(self, data: Dict, session_dir: Optional[str] = None) -> None:
        """session_dir: pass the CAPTURED dir when writing on behalf of an
        in-flight frame — a session swap between that frame's dispatch and
        its io block must not route one session's attendance into the
        other's file (read-from-captured + write-to-live corrupted BOTH)."""
        target = session_dir or self.session_dir
        with open(os.path.join(target, "attendance.json"), "w") as f:
            json.dump(data, f, indent=2)

    # ------------------------------------------------------------ frame path

    def _letterbox(self, frame_rgb: np.ndarray) -> tuple[np.ndarray, float]:
        return rawproto.letterbox_rgb(frame_rgb, self.det_size)

    def process_full_frame(
        self, frame_rgb: np.ndarray, frame_count: int, timestamp: str
    ) -> Dict:
        """Full pipeline for one client frame (server:586-739 equivalent)."""
        # Stamp the request BEFORE letterbox/colorspace prep: that host work
        # is host time the client waits for and belongs in the reported
        # per-request timings.
        timings = self.perf_monitor.start_request() if self.perf_monitor else None
        canvas, scale = self._letterbox(frame_rgb)
        if self.transport == "i420":
            canvas = rawproto.rgb_to_i420(canvas)
        return self._process_canvas(
            canvas,
            scale,
            crop_frame=lambda: frame_rgb,
            crop_scale=scale,
            frame_count=frame_count,
            timestamp=timestamp,
            timings=timings,
        )

    def process_raw_frame(
        self,
        buf: bytes,
        fmt: str,
        width: int,
        height: int,
        scale: float,
        frame_count: int,
        timestamp: str,
    ) -> Dict:
        """Zero-decode path for `/process_frame_raw` (raw letterboxed planes
        straight off the wire — see rawproto.py). Face crops are taken from
        the detection canvas (the client keeps its own full-res original)."""
        # Stamp before validation/frombuffer/colorspace prep — same timing
        # basis as process_full_frame.
        timings = self.perf_monitor.start_request() if self.perf_monitor else None

        dh, dw = self.det_size
        if (height, width) != (dh, dw):
            raise ValueError(
                f"raw frame is {width}x{height} but the server detection "
                f"canvas is {dw}x{dh}; letterbox client-side to det_size"
            )
        expected = rawproto.payload_nbytes(fmt, height, width)
        if len(buf) != expected:
            raise ValueError(
                f"raw {fmt} payload must be exactly {expected} bytes "
                f"for {width}x{height}, got {len(buf)}"
            )
        if not (0.0 < scale < float("inf")):
            # the negated form also rejects NaN (every NaN comparison is
            # False), which `scale <= 0.0` would wave through into bbox math
            raise ValueError(f"invalid {rawproto.HEADER_SCALE}: {scale}")

        arr = np.frombuffer(buf, np.uint8)
        memo: Dict = {}
        if fmt == "rgb24":
            rgb = arr.reshape(height, width, 3)
            canvas = rawproto.rgb_to_i420(rgb) if self.transport == "i420" else rgb
            crop_frame = lambda: rgb  # noqa: E731
        else:  # i420
            yuv = arr.reshape(height * 3 // 2, width)
            canvas = yuv if self.transport == "i420" else rawproto.i420_to_rgb(yuv)

            def crop_frame():
                # convert at most once per frame, and only when a valid face
                # actually needs a crop — the hot path stays zero-decode
                if "rgb" not in memo:
                    memo["rgb"] = (
                        canvas
                        if self.transport != "i420"
                        else rawproto.i420_to_rgb(yuv)
                    )
                return memo["rgb"]

        return self._process_canvas(
            canvas,
            scale,
            crop_frame=crop_frame,
            crop_scale=1.0,
            frame_count=frame_count,
            timestamp=timestamp,
            timings=timings,
        )

    def _process_canvas(
        self,
        canvas: np.ndarray,
        scale: float,
        crop_frame,
        crop_scale: float,
        frame_count: int,
        timestamp: str,
        timings=None,
    ) -> Dict:
        """Device dispatch + tracking for one prepared detection canvas.

        `crop_frame()` lazily yields the RGB image crops are cut from;
        `crop_scale` maps canvas-space bboxes into that image's coordinates
        (the letterbox scale for full-resolution client frames, 1.0 when
        cropping from the canvas itself). `timings` is the request timing
        handle stamped by the caller BEFORE frame prep (letterbox/colorspace
        conversion count toward the reported per-request time)."""
        if timings is None and self.perf_monitor:
            timings = self.perf_monitor.start_request()
        self.frame_count = frame_count

        # device work is batched across threads; everything after the result
        # returns is host-side and fast
        result = self.batcher.submit(canvas).result(timeout=600)

        # Collect valid, quality-passing faces in ORIGINAL frame coordinates.
        faces: List[Dict] = []
        # Resolve match indices against the id-list snapshot captured by the
        # batcher AT DISPATCH — calling gallery.id_at() here would re-sync
        # the device gallery, and a concurrent mutation between dispatch and
        # now would shift indices and mislabel matches.
        gallery_ids = result.get("gallery_ids", [])
        for i in range(len(result["face_valid"])):
            if not (result["face_valid"][i] and result["quality_ok"][i]):
                continue
            canvas_bbox = np.asarray(result["bboxes"][i])
            bbox = canvas_bbox / scale  # client/original coordinates
            matches = []
            # Under an engine embed_budget, a face past the per-frame budget
            # is detected/tracked but carries no embedding this step — leave
            # its matches empty so the track simply retries next frame.
            embedded_mask = result.get("embedded")
            if embedded_mask is None or embedded_mask[i]:
                for k in range(result["match_scores"].shape[-1]):
                    idx = int(result["match_idx"][i, k])
                    sid = (
                        gallery_ids[idx]
                        if 0 <= idx < len(gallery_ids) else None
                    )
                    if sid is None:
                        continue
                    rec = self.gallery.get_student(sid)
                    name = rec.name if rec is not None else sid
                    matches.append(
                        (sid, name, float(result["match_scores"][i, k]))
                    )
            faces.append(
                {
                    "bbox": bbox,
                    "det_score": float(result["det_scores"][i]),
                    "quality_metrics": {
                        k: float(v[i]) for k, v in result["quality_metrics"].items()
                    },
                    # device slice, NOT fetched: the crop crosses the host
                    # link only when something persists it (imwrite_rgb
                    # np.asarray's) — most frames never do, and the link is
                    # the multi-client serving ceiling
                    "aligned_face": result["aligned"][i],
                    # lazy, like aligned_face: the margin crop (slice + copy
                    # + possible LANCZOS resize) is only ever read when a
                    # recognition event persists it (_save_face_image) — a
                    # handful of times per track, not 16 faces x every frame
                    # on the single decode-bound host core. Bind loop values
                    # via defaults; all faces share the one frame closure.
                    "original_crop": (
                        lambda _cf=crop_frame, _bb=canvas_bbox / crop_scale:
                        self._margin_crop(_cf(), _bb)
                    ),
                    "match": matches,
                    "timestamp": timestamp,
                }
            )
        # Host tracking/attendance state is shared across the HTTP thread
        # pool — serialize it (the reference left this unsynchronized).
        # The expensive device step above
        # already ran; this section is cheap dict work.
        with self._lock:
            tracked = self.motion_tracker.update(faces)
            response, io_events, session_dir = self._track_and_recognize(
                faces, tracked, frame_count, timestamp, timings
            )
        if io_events:
            # Serialized against other writers only — not against the
            # compute path.
            with self._io_lock:
                for event_type, rec_result, best in io_events:
                    rec_result["saved_face_path"] = self._save_face_image(
                        best,
                        rec_result["track_id"],
                        rec_result["student_id"],
                        rec_result["name"],
                        rec_result["confidence"],
                        recognized=event_type == "recognized",
                    )
                self._update_attendance(io_events, session_dir)
        return response

    def process_faces(
        self, faces_data: List[Dict], frame_count: int, timestamp: str
    ) -> Dict:
        """Legacy client-side-detection contract: the client detects/aligns
        on its own hardware and uploads base64 crops keyed by ITS track ids;
        the server only buffers, embeds and matches.

        Reference: `face_recognition_server.py:349-444` — whose route the
        reference itself disabled (commented out at :846-866, and it calls
        `cleanup_stale_tracks` on the wrong object, :355 vs :825 — a latent
        crash we fix rather than replicate). Exposed behind
        --legacy_faces_route (off by default: the modern /process_frame*
        path is strictly better here, where the fused step amortizes
        detection across clients — docs/migrating.md).

        Payload items: {track_id, aligned_face_base64, det_score?,
        blur_score?, original_crop_base64?}. Response schema matches the
        reference's (:433-444) plus the modern tracks_in_cooldown key.
        """
        timings = self.perf_monitor.start_request() if self.perf_monitor else None
        to_embed: List[tuple] = []
        with self._lock:
            self.frame_count = frame_count
            self.total_faces_detected += len(faces_data)
            if self.perf_monitor:
                self.perf_monitor.mark_recognition_start(timings)
            seen_tracks = []
            for fd in faces_data:
                if "track_id" not in fd:
                    continue
                track_id = int(fd["track_id"])
                aligned = _decode_image_b64(fd.get("aligned_face_base64", ""))
                if aligned is None:
                    continue
                face = {
                    "track_id": track_id,
                    "aligned_face": aligned,
                    # clients that don't score default to "good enough to
                    # recognize" (det gate is 0.6, blur saturates at 100)
                    "det_score": float(fd.get("det_score", 1.0)),
                    "quality_metrics": {
                        "blur_score": float(fd.get("blur_score", 100.0))
                    },
                }
                oc = fd.get("original_crop_base64")
                if oc:
                    face["original_crop"] = _decode_image_b64(oc)
                self.tracker.add_frame(track_id, face, timestamp)
                seen_tracks.append(track_id)
            for track_id in dict.fromkeys(seen_tracks):
                if not self.tracker.should_recognize(track_id, frame_count):
                    continue
                best = self.tracker.get_best_frame(track_id)
                if best is not None:
                    to_embed.append((track_id, best))

        # Device work OUTSIDE the tracker lock: one batched backbone forward
        # for every due track, then one batched gallery search (the
        # reference loops per face through torch, :375-377).
        matches: List[List[tuple]] = []
        if to_embed:
            embs = self.engine.embedder.extract_embeddings_batch(
                [best["aligned_face"] for _, best in to_embed]
            )
            matches = self.gallery.search_batch(embs, top_k=3)

        recognition_events = []
        num_recognized = num_unknown = 0
        with self._lock:
            for (track_id, best), match in zip(to_embed, matches):
                if not match:
                    continue
                self.total_recognition_attempts += 1
                self.tracker.increment_attempts(track_id)
                sid, name, score = match[0]
                recognized = score >= self.similarity_threshold
                rec_result = {
                    "student_id": sid,
                    "name": name,
                    "confidence": float(score),
                    "track_id": track_id,
                    "recognized": recognized,
                    "top_matches": [
                        {"student_id": s, "name": n, "score": float(sc)}
                        for s, n, sc in match
                    ],
                    "timestamp": datetime.now().isoformat(),
                    "detection_quality": {
                        "det_score": best["det_score"],
                        "blur_score": best["quality_metrics"].get(
                            "blur_score", 0
                        ),
                    },
                }
                if recognized:
                    num_recognized += 1
                    self.tracker.mark_recognized(track_id, rec_result)
                    recognition_events.append(("recognized", rec_result, best))
                elif (
                    self.tracker.recognition_attempts.get(track_id, 0)
                    >= self.max_recognition_attempts
                ):
                    num_unknown += 1
                    recognition_events.append(("unrecognized", rec_result, best))
            for _, rec_result, _ in recognition_events:
                tid = rec_result["track_id"]
                rec_result["_first_seen"] = self.tracker.track_first_seen.get(
                    tid, rec_result["timestamp"]
                )
                rec_result["_duration"] = self.tracker.get_track_duration(tid)
            self.tracker.cleanup_stale_tracks(
                seen_tracks, max_age_seconds=30.0
            )
            if self.perf_monitor:
                self.perf_monitor.mark_recognition_end(timings)
            perf_metrics = (
                self.perf_monitor.end_request(
                    timings,
                    num_faces_processed=len(faces_data),
                    num_faces_recognized=num_recognized,
                    num_faces_unknown=num_unknown,
                )
                if self.perf_monitor
                else {}
            )
            response = {
                "frame_count": frame_count,
                "faces_processed": len(faces_data),
                "recognition_events": len(recognition_events),
                "recognized_tracks": {
                    # same filter as /process_frame: no file path, no
                    # _-prefixed attendance bookkeeping in the response
                    str(k): {
                        kk: vv
                        for kk, vv in v.items()
                        if kk != "saved_face_path" and not kk.startswith("_")
                    }
                    for k, v in self.tracker.recognized_tracks.items()
                },
                "recognition_attempts": {
                    str(k): v
                    for k, v in self.tracker.recognition_attempts.items()
                },
                "failed_tracks": {
                    str(k): True
                    for k, v in self.tracker.recognition_attempts.items()
                    if v >= self.max_recognition_attempts
                    and k not in self.tracker.recognized_tracks
                },
                "tracks_in_cooldown": {
                    str(k): True for k in self.tracker.track_cooldowns
                },
                "performance": perf_metrics,
            }
            session_dir = self.session_dir
        if recognition_events:
            with self._io_lock:
                for event_type, rec_result, best in recognition_events:
                    rec_result["saved_face_path"] = self._save_face_image(
                        best,
                        rec_result["track_id"],
                        rec_result["student_id"],
                        rec_result["name"],
                        rec_result["confidence"],
                        recognized=event_type == "recognized",
                    )
                self._update_attendance(recognition_events, session_dir)
        return response

    def _track_and_recognize(
        self, faces, tracked, frame_count, timestamp, timings
    ) -> Dict:
        """Runs under self._lock (shared tracker/attendance state)."""
        self.total_faces_detected += len(faces)
        if self.perf_monitor:
            self.perf_monitor.mark_recognition_start(timings)

        recognition_events = []
        num_recognized = num_unknown = 0
        for track_id, face in tracked:
            face["track_id"] = track_id
            self.tracker.add_frame(track_id, face, timestamp)
            if not self.tracker.should_recognize(track_id, frame_count):
                continue
            best = self.tracker.get_best_frame(track_id)
            if best is None or not best["match"]:
                continue
            self.total_recognition_attempts += 1
            self.tracker.increment_attempts(track_id)
            sid, name, score = best["match"][0]
            recognized = score >= self.similarity_threshold
            rec_result = {
                "student_id": sid,
                "name": name,
                "confidence": float(score),
                "track_id": track_id,
                "recognized": recognized,
                "top_matches": [
                    {"student_id": s, "name": n, "score": float(sc)}
                    for s, n, sc in best["match"]
                ],
                "timestamp": datetime.now().isoformat(),
                "detection_quality": {
                    "det_score": best["det_score"],
                    "blur_score": best["quality_metrics"].get("blur_score", 0),
                },
            }
            if recognized:
                num_recognized += 1
                self.tracker.mark_recognized(track_id, rec_result)
                recognition_events.append(("recognized", rec_result, best))
                print(
                    f"[Frame {frame_count}] Recognized: {name} "
                    f"(track_{track_id:04d}, confidence: {score:.3f})"
                )
            elif (
                self.tracker.recognition_attempts.get(track_id, 0)
                >= self.max_recognition_attempts
            ):
                num_unknown += 1
                recognition_events.append(("unrecognized", rec_result, best))

        if self.perf_monitor:
            self.perf_monitor.mark_recognition_end(timings)
        # Disk I/O (face PNGs + attendance read-modify-write) happens OUTSIDE
        # self._lock (in process_full_frame) so other clients' frames don't
        # queue behind file writes; capture the tracker-derived fields the
        # writer needs while we still hold the lock.
        for _, rec_result, _ in recognition_events:
            tid = rec_result["track_id"]
            rec_result["_first_seen"] = self.tracker.track_first_seen.get(
                tid, rec_result["timestamp"]
            )
            rec_result["_duration"] = self.tracker.get_track_duration(tid)

        self.tracker.cleanup_stale_tracks(
            [tid for tid, _ in tracked], max_age_seconds=30.0
        )

        perf_metrics = (
            self.perf_monitor.end_request(
                timings,
                num_faces_processed=len(faces),
                num_faces_recognized=num_recognized,
                num_faces_unknown=num_unknown,
            )
            if self.perf_monitor
            else {}
        )

        newly_recognized = {
            str(r["track_id"]): {
                "student_id": r["student_id"],
                "name": r["name"],
                "confidence": r["confidence"],
                "timestamp": r["timestamp"],
            }
            for t, r, _ in recognition_events
            if t == "recognized"
        }
        newly_failed = [
            str(r["track_id"])
            for t, r, _ in recognition_events
            if t == "unrecognized"
        ]
        return {
            "frame_count": frame_count,
            "faces_detected": len(faces),
            "active_tracks": len(tracked),
            "tracks": [
                {
                    "track_id": tid,
                    "bbox": [float(x) for x in face["bbox"]],
                    "det_score": face["det_score"],
                }
                for tid, face in tracked
            ],
            "recognized_tracks": {
                # exclude the host-side file path AND the _-prefixed
                # bookkeeping fields stamped for _update_attendance (they
                # are popped there, but a response built on the SAME frame
                # as the recognition would otherwise leak them — the
                # reference schema has neither)
                str(k): {
                    kk: vv for kk, vv in v.items()
                    if kk != "saved_face_path" and not kk.startswith("_")
                }
                for k, v in self.tracker.recognized_tracks.items()
            },
            "recognition_attempts": {
                str(k): v for k, v in self.tracker.recognition_attempts.items()
            },
            "failed_tracks": {
                str(k): True
                for k, v in self.tracker.recognition_attempts.items()
                if v >= self.max_recognition_attempts
                and k not in self.tracker.recognized_tracks
            },
            "newly_recognized": newly_recognized,
            "newly_failed": newly_failed,
            "performance": perf_metrics,
        }, recognition_events, self.session_dir

    def _margin_crop(self, frame_rgb: np.ndarray, bbox: np.ndarray) -> np.ndarray:
        """0.3x margin hi-res crop capped at high_quality_crop_size
        (face_recognition_server.py:598-618)."""
        x1, y1, x2, y2 = [int(v) for v in bbox]
        margin = int(max(x2 - x1, y2 - y1) * 0.3)
        cx1, cy1 = max(0, x1 - margin), max(0, y1 - margin)
        cx2 = min(frame_rgb.shape[1], x2 + margin)
        cy2 = min(frame_rgb.shape[0], y2 + margin)
        crop = frame_rgb[cy1:cy2, cx1:cx2].copy()
        cap = self.high_quality_crop_size
        if crop.size and max(crop.shape[:2]) > cap:
            s = cap / max(crop.shape[:2])
            nw, nh = int(crop.shape[1] * s), int(crop.shape[0] * s)
            import cv2

            crop = cv2.resize(crop, (nw, nh), interpolation=cv2.INTER_LANCZOS4)
        return crop

    def _save_face_image(
        self, face: Dict, track_id: int, student_id: str, name: str,
        confidence: float, recognized: bool,
    ) -> str:
        out_dir = self.recognized_faces_dir if recognized else self.unrecognized_faces_dir
        if recognized:
            # Gallery-sourced strings get the same hardening as client input:
            # a '/'-bearing id/name (tampered pickle, careless enrollment)
            # must not escape the session directory.
            leaf = re.sub(
                r"[^A-Za-z0-9_.\-]", "_", f"{student_id}_{name.replace(' ', '_')}"
            ).lstrip(".") or "unknown"
            out_dir = os.path.join(out_dir, leaf)
            os.makedirs(out_dir, exist_ok=True)
        stamp = datetime.now().strftime("%Y%m%d_%H%M%S_%f")
        aligned_path = os.path.join(
            out_dir, f"track_{track_id:04d}_{stamp}_conf{confidence:.3f}_aligned.png"
        )
        imwrite_rgb(aligned_path, face["aligned_face"])
        crop = face.get("original_crop")
        if callable(crop):
            crop = crop()
        if crop is not None and crop.size:
            imwrite_rgb(
                os.path.join(
                    out_dir,
                    f"track_{track_id:04d}_{stamp}_conf{confidence:.3f}_original.png",
                ),
                crop,
            )
        return aligned_path

    def _update_attendance(self, events: List[tuple], session_dir: str) -> None:
        """Runs under self._io_lock with tracker fields pre-captured
        (_first_seen/_duration) — never touches live tracker state."""
        path = os.path.join(session_dir, "attendance.json")
        with open(path) as f:
            attendance = json.load(f)
        for event_type, result, _best in events:
            track_id = result["track_id"]
            first_seen = result.pop("_first_seen", result["timestamp"])
            duration = result.pop("_duration", 0.0)
            if event_type == "recognized":
                existing = next(
                    (s for s in attendance["recognized"]
                     if s["student_id"] == result["student_id"]),
                    None,
                )
                if existing is None:
                    attendance["recognized"].append(
                        {
                            "student_id": result["student_id"],
                            "name": result["name"],
                            "first_seen": first_seen,
                            "confidence": result["confidence"],
                            "track_id": f"track_{track_id:04d}",
                            "duration_seconds": duration,
                            "detection_quality": result["detection_quality"],
                            "saved_face_path": result.get("saved_face_path", ""),
                        }
                    )
                elif result["confidence"] > existing["confidence"]:
                    # the evidence fields must follow the confidence they
                    # belong to — keeping the old saved crop/track under the
                    # new score would misattribute the record (first_seen
                    # stays: it is the earliest sighting by definition)
                    existing["confidence"] = result["confidence"]
                    existing["detection_quality"] = result["detection_quality"]
                    existing["track_id"] = f"track_{track_id:04d}"
                    existing["duration_seconds"] = duration
                    existing["saved_face_path"] = result.get(
                        "saved_face_path", ""
                    )
            else:
                attendance["unrecognized"].append(
                    {
                        "track_id": f"track_{track_id:04d}",
                        "first_seen": first_seen,
                        "duration_seconds": duration,
                        "best_match": {
                            "name": result["name"],
                            "student_id": result["student_id"],
                            "confidence": result["confidence"],
                        },
                        "reason": "below_threshold",
                        "threshold": self.similarity_threshold,
                        "attempts": self.tracker.recognition_attempts.get(track_id, 0),
                        "top_matches": result["top_matches"],
                        "saved_face_path": result.get("saved_face_path", ""),
                    }
                )
        attendance["last_updated"] = datetime.now().isoformat()
        self._write_attendance(attendance, session_dir=session_dir)

    # --------------------------------------------------------------- actions

    def save_snapshot(self, snapshot_base64: str, frame_count: int, timestamp: str) -> str:
        timestamp = _safe_path_component(timestamp, "timestamp")
        raw = base64.b64decode(snapshot_base64)
        path = os.path.join(
            self.snapshots_dir, f"snapshot_frame_{int(frame_count):06d}_{timestamp}.png"
        )
        with open(path, "wb") as f:
            f.write(raw)
        return path

    def finalize_session(self, client_report: Optional[Dict] = None) -> None:
        # Serialize with in-flight frames (same reasoning as _create_session).
        with self._lock:
            self._finalize_session_locked(client_report)

    def _finalize_session_locked(self, client_report: Optional[Dict] = None) -> None:
        session_end = datetime.now()
        duration = (session_end - self.session_start).total_seconds()
        if self.perf_monitor:
            self.perf_monitor.finalize_session(client_report=client_report)

        with open(os.path.join(self.session_dir, "session.json")) as f:
            session_data = json.load(f)
        # _io_lock: the frame io path writes attendance.json under _io_lock
        # only (not _lock) — reading without it can catch open('w')'s
        # truncation mid-write. Order is always _lock -> _io_lock (the io
        # block never takes _lock), so this cannot deadlock.
        with self._io_lock:
            with open(os.path.join(self.session_dir, "attendance.json")) as f:
                attendance = json.load(f)
        session_data.update(
            end_time=session_end.isoformat(),
            status="completed",
            duration_seconds=duration,
            statistics={
                "total_frames_processed": self.frame_count,
                "total_faces_detected": self.total_faces_detected,
                "total_recognition_attempts": self.total_recognition_attempts,
                "unique_students_recognized": len(attendance["recognized"]),
                "unrecognized_tracks": len(attendance["unrecognized"]),
            },
        )
        self._write_session(session_data)
        print(
            f"Session {self.session_name} finalized: "
            f"{len(attendance['recognized'])} recognized, "
            f"{len(attendance['unrecognized'])} unrecognized tracks"
        )

    def reload_gallery(self) -> Dict:
        """Re-read the configured gallery pickle from disk and expose the new
        identities to serving without a restart (`POST /reload_gallery`).

        The reference requires a server restart after enrollment
        (`face_recognition_server.py:126-228` loads the gallery once at
        startup). Here `GalleryManager.load` swaps the records under its
        sync lock and marks the device snapshot dirty; the batcher's next
        dispatch rebuilds the device templates, and in-flight requests keep
        matching against the snapshot they dispatched with (indices resolve
        against the per-dispatch `gallery_ids` — see `_process_canvas`)."""
        path = self.gallery.gallery_path
        # Amplification guard: an (auth-free) reload request otherwise costs
        # a full unpickle + a full device-gallery rebuild at the next
        # dispatch — at production gallery sizes that is a near-free request
        # triggering gigabyte-scale work. Skip when the file is unchanged.
        try:
            st = os.stat(path)
        except OSError:
            raise ValueError(f"gallery file not found: {path}")
        sig = (st.st_mtime_ns, st.st_size)
        if sig == self._gallery_file_sig:
            return {
                "status": "unchanged",
                "gallery_path": path,
                "num_students": len(self.gallery.students),
            }
        # strict: a non-atomic rewrite racing the stat above must surface as
        # an error, never as status=reloaded with stale records
        self.gallery.load(strict=True)
        self._gallery_file_sig = sig
        return {
            "status": "reloaded",
            "gallery_path": path,
            "num_students": len(self.gallery.students),
        }

    def note_request_served(self) -> None:
        """Count one frame-processing request toward `max_requests`.

        On reaching the limit (once), persist the active session name for
        the supervisor and ask the HTTP loop to drain: serve_forever
        returns, main() exits with the recycle code, and the supervisor
        respawns a fresh worker that resumes the session. Called AFTER the
        response is written, so the triggering request completes normally.
        """
        if not self.max_requests:
            return
        with self._recycle_lock:
            self._requests_served += 1
            if (
                self._requests_served < self.max_requests
                or self._recycle_requested
            ):
                return
            self._recycle_requested = True
        self._persist_recycle_state()
        print(
            f"[recycle] served {self._requests_served} requests "
            f">= max_requests={self.max_requests}; draining for respawn",
            file=sys.stderr,
        )
        if self._httpd is not None:
            # shutdown() blocks until the accept loop exits; run it off
            # this handler thread so the final response flushes first
            threading.Thread(target=self._httpd.shutdown, daemon=True).start()

    def _flush_session_stats(self, session_dir: str, stats: Dict) -> None:
        """Update session.json's statistics block in place (status and the
        rest of the document untouched). session_dir and stats are CAPTURED
        by the caller under self._lock (a concurrent session swap must not
        route one session's counters into another's file); reads+writes
        under _io_lock to serialize with attendance writers."""
        path = os.path.join(session_dir, "session.json")
        with self._io_lock:
            try:
                with open(path) as f:
                    data = json.load(f)
            except (OSError, ValueError):
                return
            data.setdefault("statistics", {}).update(stats)
            with open(path, "w") as f:
                json.dump(data, f, indent=2)

    def _persist_recycle_state(self) -> None:
        """Write the supervisor's handoff state (the active session's name)
        and flush the session counters into session.json."""
        # ONE locked read of (name, dir, counters): a concurrent
        # /init_session swap mid-recycle must not pair one session's name
        # with another's directory or counters (same captured-session
        # discipline as the frame io path, _write_attendance docstring)
        with self._lock:
            session_name = self.session_name
            session_dir = self.session_dir
            stats = {
                "total_frames_processed": self.frame_count,
                "total_faces_detected": self.total_faces_detected,
                "total_recognition_attempts": self.total_recognition_attempts,
            }
        try:
            with self._io_lock:
                # temp + rename: a crash mid-write must not leave truncated
                # JSON for the supervisor to trip on
                state_path = os.path.join(
                    self.output_dir, ".recycle_state.json"
                )
                tmp_path = state_path + ".tmp"
                with open(tmp_path, "w") as f:
                    json.dump({"session_name": session_name}, f)
                os.replace(tmp_path, state_path)
            # Attendance is event-flushed, but the session counters normally
            # only land in session.json at finalize — flush them now (status
            # stays "active") so the respawned worker resumes with the true
            # totals instead of zeros.
            if session_name is not None:
                self._flush_session_stats(session_dir, stats)
        except OSError as e:  # pragma: no cover - disk full etc.
            print(f"[recycle] could not persist state: {e}", file=sys.stderr)

    def launch_report(self) -> Dict:
        """This process's kernel launches since the server was ready (the
        warm-up's captures excluded) beside the steps the batcher dispatched
        since then."""
        now = launch_counts()
        return {
            "pid": os.getpid(),
            "steps": self.batcher._dispatch_count,
            "launches": {k: n - self._ready_launches[k] for k, n in now.items()},
        }

    def shutdown(self) -> None:
        self.batcher.stop()
        if self._recycle_requested:
            # Requests already accepted when the limit was reached are still
            # answered during the drain, after note_request_served's flush:
            # flush again once they are all done (main() calls this after server_close
            # has joined the handler threads), or the respawned worker
            # resumes without them.
            self._persist_recycle_state()


# ------------------------------------------------------------------- HTTP


def make_handler(server: FaceRecognitionServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # A response leaves as two writes (headers, then body). With Nagle's
        # algorithm on, the second waits for the client's delayed ACK of the
        # first: about 40 ms added to every request on Linux.
        disable_nagle_algorithm = True

        # Recycle mode bounds keep-alive: a draining worker joins its
        # handler threads (block_on_close), and an idle persistent
        # connection would otherwise block in readline() forever. The
        # socket timeout makes idle keep-alive connections close within
        # KEEPALIVE_IDLE_S (handle_one_request treats the timeout as
        # close_connection). Idle reaping between requests is harmless: no
        # request is in flight there, and reconnecting clients lose nothing.
        KEEPALIVE_IDLE_S = 30.0
        if server.max_requests:
            timeout = KEEPALIVE_IDLE_S
        # MID-BODY reads go through _read_body below, in every
        # configuration: each recv waits BODY_RECV_TIMEOUT_S, and after
        # BODY_STALL_TIMEOUTS consecutive timeouts without one byte of
        # progress the connection is dropped, so a client that stalls
        # mid-POST releases its handler thread instead of pinning it
        # forever. Once a drain is pending the first timeout drops it.
        BODY_RECV_TIMEOUT_S = 30.0
        BODY_STALL_TIMEOUTS = 4

        def _read_body(self, length: int) -> bytes:
            """Read exactly `length` body bytes, or raise TimeoutError for a
            stalled client / ConnectionError for one that went away. read1
            chunks map to single raw recvs, so a timeout never discards
            partial progress (a multi-recv rfile.read(length) can lose
            earlier chunks when a later recv times out)."""
            if not length:
                return b""
            chunks: list = []
            remaining = length
            stalls = 0
            idle_timeout = self.connection.gettimeout()
            self.connection.settimeout(self.BODY_RECV_TIMEOUT_S)
            try:
                while remaining:
                    try:
                        chunk = self.rfile.read1(min(remaining, 1 << 16))
                    except TimeoutError:
                        stalls += 1
                        if (
                            server._recycle_requested
                            or stalls >= self.BODY_STALL_TIMEOUTS
                        ):
                            raise
                        # a socket file that timed out refuses further
                        # reads; its buffer is empty (the recv that timed
                        # out was filling it), so a fresh one loses nothing
                        self.rfile = self.connection.makefile("rb", self.rbufsize)
                        continue
                    if not chunk:
                        raise ConnectionError(
                            f"client closed mid-body ({remaining} of {length} "
                            f"bytes unread)"
                        )
                    stalls = 0
                    chunks.append(chunk)
                    remaining -= len(chunk)
            finally:
                self.connection.settimeout(idle_timeout)
            return b"".join(chunks)

        def log_message(self, fmt, *args):  # quiet
            pass

        def _note_served(self) -> None:
            """Count a frame request; once a recycle is pending, stop
            honouring keep-alive so the drain completes promptly."""
            server.note_request_served()
            if server._recycle_requested:
                self.close_connection = True

        def _json(self, payload: Dict, status: int = 200) -> None:
            body = json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _body(self) -> Dict:
            length = int(self.headers.get("Content-Length", 0))
            if not length:
                return {}
            data = json.loads(self._read_body(length) or b"{}")
            if not isinstance(data, dict):
                # ValueError -> the 400 handler (client fault, not a 500)
                raise ValueError(
                    f"request body must be a JSON object, got {type(data).__name__}"
                )
            return data

        def do_GET(self):
            if self.path == "/health":
                # pid lets operators (and the recycle soak test) observe
                # worker respawns without reading supervisor logs
                self._json({
                    "status": "ok",
                    "session": server.session_name,
                    "pid": os.getpid(),
                })
            elif self.path == "/stats":
                if server.perf_monitor:
                    self._json(server.perf_monitor.get_current_stats())
                else:
                    self._json({})
            else:
                self._json({"error": "not found"}, 404)

        def do_POST(self):
            try:
                if self.path == "/process_frame_raw":
                    # raw octet-stream frames: no JSON, no base64, no
                    # imdecode — metadata rides in headers (rawproto.py)
                    # ALWAYS consume the (megabyte) body, even on early 400s:
                    # responding with unread bytes on the socket desyncs
                    # HTTP/1.1 keep-alive — the next request line would be
                    # parsed out of this frame's pixels.
                    length = int(self.headers.get("Content-Length", 0))
                    payload = self._read_body(length)
                    if server.session_name is None:
                        self._json(
                            {"error": "No active session. Call /init_session first"},
                            400,
                        )
                        return
                    fmt = self.headers.get(rawproto.HEADER_FORMAT, "")
                    if fmt not in rawproto.RAW_FORMATS:
                        self._json(
                            {
                                "error": f"{rawproto.HEADER_FORMAT} must be one "
                                f"of {rawproto.RAW_FORMATS}, got {fmt!r}"
                            },
                            400,
                        )
                        return
                    result = server.process_raw_frame(
                        payload,
                        fmt,
                        int(self.headers.get(rawproto.HEADER_WIDTH, 0)),
                        int(self.headers.get(rawproto.HEADER_HEIGHT, 0)),
                        float(self.headers.get(rawproto.HEADER_SCALE, 1.0)),
                        int(self.headers.get(rawproto.HEADER_COUNT, 0)),
                        self.headers.get(
                            rawproto.HEADER_TIMESTAMP, datetime.now().isoformat()
                        ),
                    )
                    self._json(result)
                    self._note_served()
                    return
                data = self._body()
                if self.path == "/init_session":
                    name = data.get("session_name")
                    if not name:
                        self._json({"error": "session_name is required"}, 400)
                        return
                    server._create_session(name)
                    self._json(
                        {
                            "status": "session_initialized",
                            "session_name": name,
                            "session_dir": server.session_dir,
                        }
                    )
                elif self.path == "/process_frame":
                    if server.session_name is None:
                        self._json(
                            {"error": "No active session. Call /init_session first"},
                            400,
                        )
                        return
                    frame = _decode_image_b64(data.get("frame", ""))
                    if frame is None:
                        self._json({"error": "could not decode frame"}, 400)
                        return
                    result = server.process_full_frame(
                        frame,
                        data.get("frame_count", 0),
                        data.get("timestamp", datetime.now().isoformat()),
                    )
                    self._json(result)
                    self._note_served()
                elif self.path == "/save_snapshot":
                    if server.session_name is None:
                        self._json(
                            {"error": "No active session. Call /init_session first"},
                            400,
                        )
                        return
                    path = server.save_snapshot(
                        data.get("snapshot", ""),
                        data.get("frame_count", 0),
                        data.get(
                            "timestamp", datetime.now().strftime("%Y%m%d_%H%M%S")
                        ),
                    )
                    self._json({"saved": True, "path": path})
                elif self.path == "/finalize":
                    if server.session_name is None:
                        self._json({"error": "No active session"}, 400)
                        return
                    server.finalize_session(
                        client_report=data.get("client_performance_report")
                    )
                    self._json({"status": "finalized"})
                elif self.path == "/process_faces":
                    # legacy client-side-detection contract; opt-in (see
                    # FaceRecognitionServer.process_faces)
                    if not server.legacy_faces_route:
                        self._json(
                            {
                                "error": "legacy /process_faces is disabled; "
                                "start the server with --legacy_faces_route "
                                "(or use /process_frame)"
                            },
                            404,
                        )
                        return
                    if server.session_name is None:
                        self._json(
                            {"error": "No active session. Call /init_session first"},
                            400,
                        )
                        return
                    result = server.process_faces(
                        data.get("faces", []),
                        data.get("frame_count", 0),
                        data.get("timestamp", datetime.now().isoformat()),
                    )
                    self._json(result)
                    self._note_served()
                elif self.path == "/reload_gallery":
                    # Hot-swap enrollment without a restart: re-read the
                    # CONFIGURED gallery pickle (no client-supplied path —
                    # an HTTP-chosen pickle path would be a remote
                    # file-read/deserialize vector). The offline workflow is
                    # `enroll_students` writing students.pkl, then this
                    # route; the batcher picks the new device snapshot up at
                    # its next dispatch (gallery._sync_lock + dirty flag).
                    self._json(server.reload_gallery())
                else:
                    self._json({"error": "not found"}, 404)
            except (TimeoutError, ConnectionError):
                # the body never arrived whole (_read_body): nothing can be
                # answered on this connection and its stream position is
                # unknown — drop it
                self.close_connection = True
            except ValueError as e:
                # client-input validation failures (e.g. unsafe path
                # components) are the client's fault, not a server error
                self._json({"error": str(e), "error_type": "ValueError"}, 400)
            except Exception as e:
                self._json(
                    {
                        "error": str(e),
                        "error_type": type(e).__name__,
                        "traceback": traceback.format_exc(),
                    },
                    500,
                )

    return Handler


class _DrainingHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer that waits for in-flight handler threads on
    close — a recycling worker must finish (and flush) every accepted
    request before the process exits."""

    daemon_threads = False
    block_on_close = True


def serve(server: FaceRecognitionServer, host: str = "0.0.0.0", port: int = 5000):
    cls = _DrainingHTTPServer if server.max_requests else ThreadingHTTPServer
    httpd = cls((host, port), make_handler(server))
    server._httpd = httpd
    print(f"Face recognition server listening on {host}:{port}")
    return httpd


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Face Recognition Server for classroom attendance"
    )
    p.add_argument("--gallery_path", type=str,
                   default=os.path.join("gallery", "students.pkl"))
    p.add_argument("--threshold", type=float, default=0.4)
    p.add_argument("--output_dir", type=str, default="sessions")
    p.add_argument("--session_name", type=str, default=None)
    p.add_argument("--recognition_interval", type=int, default=30)
    p.add_argument("--max_attempts", type=int, default=3)
    p.add_argument("--host", type=str, default="0.0.0.0")
    p.add_argument("--port", type=int, default=5000)
    p.add_argument("--model_type", type=str, default="adaface",
                   choices=["adaface", "arcface"])
    p.add_argument("--architecture", type=str, default="ir_101",
                   choices=sorted(BACKBONE_CONFIGS))
    p.add_argument("--model_path", type=str, default=None)
    p.add_argument("--detector_weights", type=str, default=None,
                   help="Detector cascade weights (.npz)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the recognition step and the "
                        "gallery (default cuda; fails without a card)")
    p.add_argument("--batch_max", type=int, default=8,
                   help="Max frames coalesced into one device step")
    p.add_argument("--batch_wait_ms", type=float, default=5.0)
    p.add_argument("--max_faces", type=int, default=16)
    p.add_argument("--embed_budget", type=int, default=None,
                   help="embed/match only the K best quality-passing faces "
                        "per frame (default: every max_faces slot); the "
                        "backbone dominates the fused step, so a budget "
                        "sized to realistic per-frame face counts cuts "
                        "device time several-fold")
    p.add_argument("--mesh_data", type=int, default=None,
                   help="Shard the fused step data-parallel over this many "
                        "devices (batch_max must be a multiple)")
    p.add_argument("--shard_gallery", action="store_true",
                   help="Row-shard the gallery template matrix over the "
                        "--mesh_data axis: gallery capacity and read "
                        "bandwidth scale with the mesh instead of "
                        "replicating per device")
    p.add_argument("--transport", type=str, default="rgb",
                   choices=["rgb", "i420"],
                   help="Host->device frame encoding: i420 halves upload "
                        "bytes (YUV 4:2:0, device-side RGB conversion)")
    p.add_argument("--quantize", type=str, default=None,
                   choices=["int8"],
                   help="post-training-quantized embedder and detector "
                        "(int8 res convs and R/O-nets, exact s8 x s8 -> s32 "
                        "sums; calibrate on real faces for imported weights, "
                        "see models/quantize.py)")
    p.add_argument("--quantize_calib", type=str, default=None,
                   help="directory of aligned face crops for int8 "
                        "activation-scale calibration (required in practice "
                        "with --quantize int8 on imported weights)")
    p.add_argument("--max_requests", type=int, default=None,
                   help="recycle the serving worker after this many frame "
                        "requests: the process drains in-flight requests, "
                        "exits, and a supervisor respawns it resuming the "
                        "active session from disk. Bounds RSS growth from "
                        "per-request memory retained outside this package")
    p.add_argument("--gallery_quantize", type=str, default=None,
                   choices=["int8"],
                   help="store device gallery templates as int8 codes + "
                        "per-row scales at streaming scale (>= 32k ids): "
                        "half the gallery bytes in device memory and per "
                        "search; top-1 parity pinned in "
                        "tests/test_torch_port_gallery.py")
    p.add_argument("--legacy_faces_route", action="store_true",
                   help="enable the legacy POST /process_faces contract "
                        "(client-side detection: clients upload aligned "
                        "crops; the reference disabled this route — see "
                        "docs/migrating.md)")
    # accepted for reference-CLI compatibility
    p.add_argument("--use_gpu", action="store_true",
                   help="same as --device cuda (the default)")
    p.add_argument("--use_cpu", action="store_true",
                   help="same as --device cpu")
    # internal (supervisor <-> worker); not part of the public surface
    p.add_argument("--_worker", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--_resume_session", type=str, default=None,
                   help=argparse.SUPPRESS)
    return p


#: Worker exit code that asks the supervisor for a respawn (EX_TEMPFAIL).
RECYCLE_EXIT_CODE = 75


def _supervise(argv, args) -> int:
    """Parent loop for --max_requests: run the server as a child process,
    respawn it whenever it exits with RECYCLE_EXIT_CODE. The recycle is a
    full process replacement — required because the retained memory being
    bounded lives outside this package's control (native library state), so
    no in-process reset can free it.

    SIGTERM/SIGINT forward to the live worker: without this, killing the
    supervisor orphans the worker (observed: a terminated soak left its
    worker serving — and holding device memory — indefinitely)."""
    import subprocess

    base = [
        sys.executable, "-m",
        "facerecognitionpipeline_tpu_torch.cli.face_recognition_server",
        *argv, "--_worker",
    ]
    state_path = os.path.join(args.output_dir, ".recycle_state.json")
    # a state file left behind by an EARLIER supervisor run must not leak
    # its session into this run's first recycle
    try:
        os.unlink(state_path)
    except OSError:
        pass
    resume_session = None
    generation = 0
    child: list = [None]

    def forward(signum, frame):  # pragma: no cover - signal timing
        if child[0] is not None and child[0].poll() is None:
            child[0].terminate()

    prev_term = signal.signal(signal.SIGTERM, forward)
    prev_int = signal.signal(signal.SIGINT, forward)
    try:
        while True:
            cmd = list(base)
            if resume_session:
                cmd += ["--_resume_session", resume_session]
            generation += 1
            print(f"[recycle] starting worker generation {generation}",
                  file=sys.stderr)
            child[0] = subprocess.Popen(cmd)
            rc = child[0].wait()
            if rc != RECYCLE_EXIT_CODE:
                return rc
            resume_session = None
            try:
                with open(state_path) as f:
                    resume_session = json.load(f).get("session_name")
            except (OSError, ValueError):
                pass
            # consume the state file: if the NEXT recycle fails to write its
            # own (disk full), resuming this stale session name would be
            # wrong — a missed write should mean "no resume"
            try:
                os.unlink(state_path)
            except OSError:
                pass
            print(
                f"[recycle] worker recycled after --max_requests; respawning"
                + (f" (resuming session {resume_session!r})"
                   if resume_session else ""),
                file=sys.stderr,
            )
    finally:
        signal.signal(signal.SIGTERM, prev_term)
        signal.signal(signal.SIGINT, prev_int)


def build_server(args) -> FaceRecognitionServer:
    """The server a worker of the CLI builds from its parsed arguments."""
    return FaceRecognitionServer(
        gallery_path=args.gallery_path,
        similarity_threshold=args.threshold,
        output_dir=args.output_dir,
        # A recycled worker must NOT re-init --session_name before the
        # resume in main(): constructor-time _create_session runs a fresh
        # _init_session_files, which would wipe the very attendance/stats
        # the resume is about to read (the --session_name + --max_requests
        # combination; pinned by tests/test_server_recycle.py).
        session_name=None if args._resume_session else args.session_name,
        model_type=args.model_type,
        architecture=args.architecture,
        model_path=args.model_path,
        detector_weights=args.detector_weights,
        recognition_interval=args.recognition_interval,
        max_recognition_attempts=args.max_attempts,
        batch_max=args.batch_max,
        batch_wait_ms=args.batch_wait_ms,
        max_faces=args.max_faces,
        mesh_data=args.mesh_data,
        transport=args.transport,
        embed_budget=args.embed_budget,
        quantize=args.quantize,
        quantize_calib=args.quantize_calib,
        shard_gallery=args.shard_gallery,
        max_requests=args.max_requests,
        legacy_faces_route=args.legacy_faces_route,
        gallery_quantize=args.gallery_quantize,
        device="cpu" if args.use_cpu else args.device,
    )


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.use_cpu and args.use_gpu:
        raise SystemExit("--use_cpu and --use_gpu exclude each other")
    if args.max_requests is not None and args.max_requests < 1:
        raise SystemExit("--max_requests must be >= 1")
    if args.max_requests and not args._worker:
        return _supervise(
            list(argv) if argv is not None else sys.argv[1:], args
        )
    server = build_server(args)

    def report_launches() -> None:
        os.write(2, (LAUNCH_LINE + json.dumps(server.launch_report()) + "\n").encode())

    def on_sigterm(signum, frame):  # pragma: no cover - signal timing
        # report, then die of SIGTERM as before (the supervisor's exit code)
        report_launches()
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        os.kill(os.getpid(), signal.SIGTERM)

    signal.signal(signal.SIGTERM, on_sigterm)
    if args._resume_session:
        # recycled worker: re-open the session the previous worker was
        # serving (attendance/session state comes from disk)
        server._create_session(args._resume_session, resume=True)
    httpd = serve(server, args.host, args.port)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        server.shutdown()
        report_launches()
    return RECYCLE_EXIT_CODE if server._recycle_requested else 0


if __name__ == "__main__":
    raise SystemExit(main())
