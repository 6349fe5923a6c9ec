"""Serving memory-boundedness of the port: frames through the in-process
server must not retain per-frame state.

The port's counterpart of `tests/test_serving_leak.py`. The object-level
bounds (tracker stores bounded by live tracks and buffer depth, batcher
queues empty) run at a size that takes seconds; the process-level check
(RSS growth per request far below one frame's payload, the minimum over
chunks) is marked slow, as the JAX test is. The recycle soak holds a
worker process on the card to the same RSS bound (`serve/soak.py`).
"""

import gc
import os

import numpy as np
import pytest

from facerecognitionpipeline_tpu_torch.gallery.manager import GalleryManager
from facerecognitionpipeline_tpu_torch.models.detector import MTCNNDetector
from facerecognitionpipeline_tpu_torch.ops.quality import QualityConfig
from facerecognitionpipeline_tpu_torch.pipeline.embedder import FaceEmbedder
from facerecognitionpipeline_tpu_torch.pipeline.engine import RecognitionEngine
from facerecognitionpipeline_tpu_torch.serve import rawproto
from facerecognitionpipeline_tpu_torch.serve.server import FaceRecognitionServer
from facerecognitionpipeline_tpu_torch.train.detector_train import (
    make_identity,
    render_identity_scene,
)

WEIGHTS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "pretrained", "mtcnn_synthetic.npz",
)
DET = (160, 160)


def _payloads(n=4):
    """Distinct rendered scenes as raw letterboxed i420 payloads."""
    out = []
    for seed in range(n):
        rng = np.random.default_rng(seed)
        scene, _, _, _ = render_identity_scene([make_identity(seed)], rng, size=DET[0])
        canvas, scale = rawproto.letterbox_rgb(np.asarray(scene, np.uint8), DET)
        out.append((rawproto.rgb_to_i420(canvas).tobytes(), scale))
    return out


@pytest.fixture
def leak_server(tmp_path):
    detector = MTCNNDetector(
        det_size=DET, max_faces=4, min_face_size=20, weights_path=WEIGHTS,
        stage_thresholds=(0.6, 0.6, 0.5), device="cpu",
    )
    embedder = FaceEmbedder(architecture="ir_micro", random_ok=True, device="cpu")
    engine = RecognitionEngine(
        detector, embedder,
        quality_config=QualityConfig(
            min_det_score=0.5, min_face_size=15, max_yaw=90, max_pitch=90,
            max_roll=90, check_blur=False,
        ),
        top_k=3,
        input_format="i420",
    )
    gallery = GalleryManager(gallery_path=str(tmp_path / "g.pkl"), verbose=False,
                             device="cpu")
    srv = FaceRecognitionServer(
        gallery=gallery, output_dir=str(tmp_path / "sessions"), engine=engine,
        det_size=DET, transport="i420", batch_max=4, batch_wait_ms=2.0,
    )
    srv._create_session("leak")
    try:
        yield srv
    finally:
        srv.shutdown()


def _serve(srv, payloads, start, n):
    faces = 0
    for frame in range(start, start + n):
        body, scale = payloads[frame % len(payloads)]
        out = srv.process_raw_frame(body, "i420", DET[1], DET[0], scale, frame, f"t{frame}")
        faces += out["faces_detected"]
    return faces


def _assert_stores_bounded(srv):
    """Every tracker store is bounded by live tracks x buffer depth, and the
    batcher holds no stranded futures."""
    t = srv.tracker
    n_tracks = len(t.track_frame_buffers)
    assert n_tracks <= 16, f"track buffers grew unbounded: {n_tracks}"
    buffered = sum(len(d) for d in t.track_frame_buffers.values())
    assert buffered <= n_tracks * t.buffer_size
    for store in (t.recognition_attempts, t.track_first_seen,
                  t.track_last_seen, t.track_cooldowns):
        assert len(store) <= 64
    for q in (srv.batcher._ingress, srv.batcher._ready, srv.batcher._done):
        assert q.qsize() == 0


def test_serving_state_stays_bounded(leak_server):
    payloads = _payloads()
    faces = _serve(leak_server, payloads, 0, 16)
    # the scenes hold faces the cascade finds: the tracker's stores are used
    assert faces >= 8
    assert leak_server.tracker.track_frame_buffers
    _assert_stores_bounded(leak_server)
    assert leak_server.total_faces_detected == faces


@pytest.mark.slow
def test_serving_memory_bounded(leak_server):
    psutil = pytest.importorskip("psutil")
    payloads = _payloads()
    # A genuine per-frame retention recurs in EVERY chunk, while allocator
    # noise and one-time cache fills concentrate in the early ones: assert
    # on the minimum (as tests/test_serving_leak.py does).
    _serve(leak_server, payloads, 0, 30)
    chunk_growth_kb = []
    frame = 30
    for _ in range(2):
        gc.collect()
        r0 = psutil.Process().memory_info().rss
        _serve(leak_server, payloads, frame, 120)
        frame += 120
        gc.collect()
        chunk_growth_kb.append((psutil.Process().memory_info().rss - r0) / 120 / 1e3)
    _assert_stores_bounded(leak_server)
    payload_kb = len(payloads[0][0]) / 1e3
    assert min(chunk_growth_kb) < payload_kb / 2, (
        f"RSS grew {chunk_growth_kb} KB/frame per chunk (payload {payload_kb:.1f} KB)"
    )
