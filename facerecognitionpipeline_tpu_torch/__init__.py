"""PyTorch/CUDA port of the face-recognition pipeline for NVIDIA Hopper.

The counterpart of `facerecognitionpipeline_tpu` (the JAX package, which
stays the reference): the fused detect -> align -> gate -> embed -> match
serving step (`pipeline.engine.RecognitionEngine`) and its request batcher
(`serve.batcher.DeviceBatcher`). The two Pallas kernels on that path are
hand-written CUDA kernels here (`csrc/`, bound in `ops/crop_kernel.py` and
`ops/warp_kernel.py`).

Layouts at public functions match the JAX package (NHWC frames and faces,
[B,N,4] boxes, [B,F,5,2] landmarks). Entry points default to
`device="cuda"` and raise without a card unless given `device="cpu"`.
"""
