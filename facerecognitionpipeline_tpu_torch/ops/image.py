"""Batched image ops: colour conversion, resize and model-input normalization.

Counterpart of `facerecognitionpipeline_tpu/ops/image.py` (NHWC tensors,
any leading batch dims).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from facerecognitionpipeline_tpu_torch.ops.numerics import device_constant, div

# ITU-R BT.601 luma weights, identical to cv2.COLOR_RGB2GRAY.
_GRAY_WEIGHTS = (0.299, 0.587, 0.114)

MODEL_INPUT_SIZE = 112


def rgb_to_gray(images: torch.Tensor) -> torch.Tensor:
    """[..., H, W, 3] RGB (any real dtype) -> [..., H, W] float32."""
    w = device_constant(_GRAY_WEIGHTS, images.device)
    return torch.matmul(images.float(), w)


def rgb_to_bgr(images: torch.Tensor) -> torch.Tensor:
    """Flip the channel axis ([..., 3])."""
    return images.flip(-1)


def normalize_face_batch(
    faces_rgb: torch.Tensor, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """uint8/float RGB faces [..., H, W, 3] -> BGR, (x - 127.5) / 127.5, in
    `dtype`. BGR order because the imported IR weights were trained on it."""
    x = faces_rgb.flip(-1).float()
    x = div(x - 127.5, 127.5)
    return x.to(dtype)


def resize_bilinear(images: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """[..., H, W, C] -> [..., out_h, out_w, C] float32, bilinear with
    half-pixel centres (src = (dst + 0.5) * scale - 0.5, cv2.INTER_LINEAR's
    mapping) and no antialiasing, as the JAX package's
    `jax.image.resize(..., "linear", antialias=False)`. At equal size the
    images come back as float32, unresampled."""
    *lead, h, w, c = images.shape
    x = images.float()
    if (h, w) == (out_h, out_w):
        return x
    x = x.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    y = F.interpolate(
        x, size=(out_h, out_w), mode="bilinear", align_corners=False,
        antialias=False,
    )
    return y.permute(0, 2, 3, 1).reshape(*lead, out_h, out_w, c)


def preprocess_faces(
    faces_rgb: torch.Tensor,
    input_size: int = MODEL_INPUT_SIZE,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """RGB face crops [B, H, W, 3] (any real dtype) -> the embedder's input
    [B, input_size, input_size, 3] in `dtype`, BGR, in [-1, 1]: resized if
    needed, then normalized."""
    faces_rgb = resize_bilinear(faces_rgb, input_size, input_size)
    return normalize_face_batch(faces_rgb, dtype=dtype)


def i420_to_rgb(yuv: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Planar I420 [..., H*3//2, W] uint8 (cv2 layout: Y plane, then the
    quarter-res U and V planes each packed into H//4 rows of width W) ->
    RGB float32 [..., H, W, 3] in [0, 255]. Studio-swing BT.601 with
    nearest chroma upsampling, as cv2.COLOR_YUV2RGB_I420."""
    h, w = height, width
    if h % 4 or w % 2:
        raise ValueError(
            f"i420_to_rgb requires height % 4 == 0 and width % 2 == 0, "
            f"got {h}x{w}"
        )
    *lead, rows, cols = yuv.shape
    if rows != h * 3 // 2 or cols != w:
        raise ValueError(f"expected [..., {h * 3 // 2}, {w}], got {tuple(yuv.shape)}")
    x = yuv.float()
    y = x[..., :h, :]
    u = x[..., h:h + h // 4, :].reshape(*lead, h // 2, w // 2)
    v = x[..., h + h // 4:, :].reshape(*lead, h // 2, w // 2)

    def up2(p):  # nearest 2x: each sample to a 2x2 block
        *pl, ph, pw = p.shape
        return p[..., :, None, :, None].expand(*pl, ph, 2, pw, 2).reshape(*pl, 2 * ph, 2 * pw)

    yf = 1.164 * (y - 16.0)
    u = up2(u) - 128.0
    v = up2(v) - 128.0
    r = yf + 1.596 * v
    g = yf - 0.392 * u - 0.813 * v
    b = yf + 2.017 * u
    return torch.stack([r, g, b], dim=-1).clamp(0.0, 255.0)


def rgb_to_i420_host(frame_rgb):
    """Host-side RGB uint8 [H,W,3] -> I420 [H*3//2, W] uint8: the camera
    transport's conversion, `serve/rawproto.rgb_to_i420` (one
    implementation; the client imports that module without torch)."""
    from facerecognitionpipeline_tpu_torch.serve.rawproto import rgb_to_i420

    return rgb_to_i420(frame_rgb)
