"""Identity store and on-device cosine search."""

from facerecognitionpipeline_tpu_torch.gallery.manager import (  # noqa: F401
    GalleryManager,
    StudentRecord,
)
from facerecognitionpipeline_tpu_torch.gallery.search import (  # noqa: F401
    cosine_topk,
    DeviceGallery,
)
