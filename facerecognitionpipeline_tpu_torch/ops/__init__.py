"""Image and geometry ops of the port (fixed-shape, batched tensors) and
the bindings of its CUDA kernels (`crop_kernel`, `warp_kernel`,
`gallery_kernel`)."""

from facerecognitionpipeline_tpu_torch.ops.image import (  # noqa: F401
    rgb_to_gray,
    rgb_to_bgr,
    resize_bilinear,
    normalize_face_batch,
    preprocess_faces,
)
from facerecognitionpipeline_tpu_torch.ops.quality import (  # noqa: F401
    laplacian_blur_score,
    pose_angles,
    quality_check,
    QualityConfig,
)
from facerecognitionpipeline_tpu_torch.ops.warp import (  # noqa: F401
    similarity_transform,
    invert_affine,
    warp_affine,
    warp_affine_single,
    warp_affine_single_matmul,
    align_faces,
    align_faces_matmul,
    crop_resize,
    ARCFACE_TEMPLATE,
    reference_template,
)
