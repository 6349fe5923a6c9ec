"""Training: margin-softmax heads (AdaFace/ArcFace/CosFace) and the train
step on one card, as the JAX package's `train` exports them."""

from facerecognitionpipeline_tpu_torch.train.losses import (  # noqa: F401
    adaface_margin_cosine,
    arcface_margin_cosine,
    cosface_margin_cosine,
)
from facerecognitionpipeline_tpu_torch.train.trainer import (  # noqa: F401
    TrainConfig,
    Trainer,
)
