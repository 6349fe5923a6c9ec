"""Model zoo: IR/IR-SE embedding backbones, the detector cascade, weight
import and export."""

from facerecognitionpipeline_tpu_torch.models.irse import (  # noqa: F401
    IRBackbone,
    build_backbone,
    BACKBONE_CONFIGS,
)
