"""Batched enrolment augmentation: every variant of every face at once.

Counterpart of `facerecognitionpipeline_tpu/ops/augment.py`, the reference's
per-face cv2 recipe (`augment_face_for_enrollment`, enroll_students.py:20-48)
over a whole face batch: original, h-flip, rotations -10/-5/+5/+10 degrees
(replicate border), brightness -20/-10/+10/+20, contrast 0.85/0.92/1.08/1.15,
3x3 Gaussian blur sigma 0.5, Gaussian noise sigma 3 -- [N,H,W,3] ->
[N,A,H,W,3], in the reference's order, so `num_augmentations=8` takes the
same subset (original, flip, four rotations, brightness -20/-10). Plain
PyTorch on the faces' device (the JAX package's is XLA, no Pallas kernel).

The noise variant draws from a `torch.Generator` seeded with `seed`; it
cannot replay `jax.random`'s stream, so it matches the JAX package in
distribution (mean 0, standard deviation 3 before clipping), not value for
value. Every other variant is the same arithmetic.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from facerecognitionpipeline_tpu_torch.ops.warp import bilinear_sample

ROTATION_ANGLES = (-10.0, -5.0, 5.0, 10.0)
BRIGHTNESS_DELTAS = (-20.0, -10.0, 10.0, 20.0)
CONTRAST_FACTORS = (0.85, 0.92, 1.08, 1.15)
NUM_VARIANTS = 2 + len(ROTATION_ANGLES) + len(BRIGHTNESS_DELTAS) + len(CONTRAST_FACTORS) + 2

# cv2.getGaussianKernel(3, 0.5)
_GAUSS3 = (0.10650698, 0.78698604, 0.10650698)


def _rotation_coords(h: int, w: int, angle_deg: float, device):
    """Source coordinates of a rotation about the centre (the
    cv2.getRotationMatrix2D convention: positive = counter-clockwise,
    integer-division centre): [H, W] each."""
    cx, cy = w // 2, h // 2
    a = math.radians(angle_deg)
    cos_a, sin_a = math.cos(a), math.sin(a)
    ys = torch.arange(h, dtype=torch.float32, device=device)
    xs = torch.arange(w, dtype=torch.float32, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    dx, dy = gx - cx, gy - cy
    return cos_a * dx - sin_a * dy + cx, sin_a * dx + cos_a * dy + cy


def _gaussian_blur3(images: torch.Tensor) -> torch.Tensor:
    """Separable 3x3 Gaussian (sigma 0.5), reflect-101 border, [N,H,W,C]:
    rows first, then columns, as the JAX package sums them."""
    k0, k1, k2 = _GAUSS3
    x = F.pad(images.permute(0, 3, 1, 2), (0, 0, 1, 1), mode="reflect").permute(0, 2, 3, 1)
    x = k0 * x[:, :-2] + k1 * x[:, 1:-1] + k2 * x[:, 2:]
    x = F.pad(x.permute(0, 3, 1, 2), (1, 1, 0, 0), mode="reflect").permute(0, 2, 3, 1)
    return k0 * x[:, :, :-2] + k1 * x[:, :, 1:-1] + k2 * x[:, :, 2:]


def augment_batch(faces, seed: int = 0, num_augmentations: int = 8) -> torch.Tensor:
    """[N,H,W,3] uint8/float RGB (a tensor, or anything `torch.as_tensor`
    takes) -> [N, num_augmentations, H, W, 3] float32, rounded and clipped
    to 0..255, on the faces' device. Deterministic given `seed`."""
    if not 1 <= num_augmentations <= NUM_VARIANTS:
        raise ValueError(
            f"num_augmentations={num_augmentations} must be in "
            f"[1, {NUM_VARIANTS}] — a silent truncation (or an empty stack) "
            "would enroll fewer augmentations than the caller sized for"
        )
    faces = torch.as_tensor(faces).float()
    n, h, w, _ = faces.shape

    def rotate(angle):
        sx, sy = _rotation_coords(h, w, angle, faces.device)
        if n == 0:
            return faces.clone()
        return torch.stack([bilinear_sample(f, sx, sy, border="replicate") for f in faces])

    def noise():
        g = torch.Generator(device=faces.device).manual_seed(int(seed))
        z = torch.randn(faces.shape, generator=g, device=faces.device)
        return (faces + 3.0 * z).clamp(0, 255)

    makers = (
        [lambda: faces, lambda: faces.flip(2)]
        + [lambda a=a: rotate(a) for a in ROTATION_ANGLES]
        + [lambda b=b: (faces + b).clamp(0, 255) for b in BRIGHTNESS_DELTAS]
        + [lambda a=a: (faces * a).clamp(0, 255) for a in CONTRAST_FACTORS]
        + [lambda: _gaussian_blur3(faces), noise]
    )
    stack = torch.stack([make() for make in makers[:num_augmentations]], dim=1)
    return torch.round(stack).clamp(0, 255)
