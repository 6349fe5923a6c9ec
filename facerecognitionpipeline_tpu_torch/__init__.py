"""PyTorch/CUDA port of the face-recognition pipeline for NVIDIA Hopper.

The counterpart of `facerecognitionpipeline_tpu` (the JAX package, which
stays the reference): the fused detect -> align -> gate -> embed -> match
serving step (`pipeline.engine.RecognitionEngine`), its request batcher
(`serve.batcher.DeviceBatcher`) and the gallery store
(`gallery.manager.GalleryManager` on `gallery.search.DeviceGallery`). The
four Pallas kernels of the JAX package are hand-written CUDA kernels here
(`csrc/`, bound in `ops/crop_kernel.py`, `ops/warp_kernel.py` and
`ops/gallery_kernel.py`).

Layouts at public functions match the JAX package (NHWC frames and faces,
[B,N,4] boxes, [B,F,5,2] landmarks). Entry points default to
`device="cuda"` and raise without a card unless given `device="cpu"`.
"""

_LAZY = {
    "FaceEmbedder": "facerecognitionpipeline_tpu_torch.pipeline.embedder",
    "FaceProcessor": "facerecognitionpipeline_tpu_torch.pipeline.processor",
    "GalleryManager": "facerecognitionpipeline_tpu_torch.gallery.manager",
    "StudentRecord": "facerecognitionpipeline_tpu_torch.gallery.manager",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
