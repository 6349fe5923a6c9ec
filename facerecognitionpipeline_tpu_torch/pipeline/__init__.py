"""High-level pipeline: embedder, detect -> align -> filter processor,
matcher, the fused serving engine."""

from facerecognitionpipeline_tpu_torch.pipeline.embedder import FaceEmbedder  # noqa: F401
