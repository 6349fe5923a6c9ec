"""Batched face-quality math: blur, pose angles and the quality gate.

Counterpart of `facerecognitionpipeline_tpu/ops/quality.py`. Functions take
any leading batch dims ([B, F, ...] in the engine), where the JAX package
vmaps over frames.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from facerecognitionpipeline_tpu_torch.ops.image import rgb_to_gray


@dataclasses.dataclass(frozen=True)
class QualityConfig:
    """Defaults mirror the JAX package's QualityConfig."""

    min_det_score: float = 0.6
    min_face_size: float = 60.0
    max_yaw: float = 45.0
    max_pitch: float = 30.0
    max_roll: float = 30.0
    check_blur: bool = True
    blur_threshold: float = 100.0


def laplacian_blur_score(faces: torch.Tensor) -> torch.Tensor:
    """Variance of the 3x3 Laplacian: faces [..., H, W, 3] RGB (luma
    rounded to integers, as cv2's uint8 RGB2GRAY does) or [..., H, W]
    grayscale -> [...] float32. Reflect-101 border, population variance."""
    if faces.shape[-1] == 3 and faces.dim() >= 3:
        gray = torch.round(rgb_to_gray(faces))
    else:
        gray = faces.float()
    lead = gray.shape[:-2]
    h, w = gray.shape[-2:]
    g = F.pad(gray.reshape(-1, 1, h, w), (1, 1, 1, 1), mode="reflect")[:, 0]
    lap = (
        g[:, :-2, 1:-1] + g[:, 2:, 1:-1] + g[:, 1:-1, :-2] + g[:, 1:-1, 2:]
        - 4.0 * g[:, 1:-1, 1:-1]
    )
    return lap.var(dim=(1, 2), unbiased=False).reshape(lead)


def pose_angles(landmarks: torch.Tensor) -> dict[str, torch.Tensor]:
    """5-point landmarks [..., 5, 2] (left eye, right eye, nose, left mouth,
    right mouth) -> {'yaw','pitch','roll'} each [...] float32 degrees."""
    lm = landmarks.float()
    left_eye, right_eye, nose = lm[..., 0, :], lm[..., 1, :], lm[..., 2, :]
    left_mouth, right_mouth = lm[..., 3, :], lm[..., 4, :]
    deg = 180.0 / math.pi

    eye_center = (left_eye + right_eye) * 0.5
    eye_delta = right_eye - left_eye
    roll = torch.atan2(eye_delta[..., 1], eye_delta[..., 0]) * deg

    eye_distance = torch.linalg.vector_norm(eye_delta, dim=-1)
    nose_offset_x = nose[..., 0] - eye_center[..., 0]
    safe_eye_dist = torch.where(
        eye_distance > 0, eye_distance, torch.ones_like(eye_distance)
    )
    yaw = torch.asin((nose_offset_x / safe_eye_dist).clamp(-1.0, 1.0)) * deg * 2.0

    mouth_center = (left_mouth + right_mouth) * 0.5
    face_height = mouth_center[..., 1] - eye_center[..., 1]
    safe_face_h = torch.where(
        face_height != 0, face_height, torch.ones_like(face_height)
    )
    nose_offset_y = nose[..., 1] - eye_center[..., 1]
    pitch = (nose_offset_y / safe_face_h - 0.5) * 60.0
    return {"yaw": yaw, "pitch": pitch, "roll": roll}


def quality_check(
    det_scores: torch.Tensor,
    bboxes: torch.Tensor,
    landmarks: torch.Tensor,
    config: QualityConfig = QualityConfig(),
    aligned_faces: torch.Tensor | None = None,
    valid_mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """det_scores [...], bboxes [..., 4], landmarks [..., 5, 2], optional
    aligned_faces [..., H, W, 3] and valid_mask [...] -> (ok [...] bool,
    metrics of [...] float32: det_score, face_size, yaw, pitch, roll
    [, blur_score])."""
    det_scores = det_scores.float()
    bboxes = bboxes.float()
    face_size = torch.minimum(
        bboxes[..., 2] - bboxes[..., 0], bboxes[..., 3] - bboxes[..., 1]
    )
    pose = pose_angles(landmarks)
    metrics = {"det_score": det_scores, "face_size": face_size, **pose}

    ok = det_scores >= config.min_det_score
    ok &= face_size >= config.min_face_size
    ok &= pose["yaw"].abs() <= config.max_yaw
    ok &= pose["pitch"].abs() <= config.max_pitch
    ok &= pose["roll"].abs() <= config.max_roll
    if config.check_blur and aligned_faces is not None:
        blur = laplacian_blur_score(aligned_faces)
        metrics["blur_score"] = blur
        ok &= blur >= config.blur_threshold
    if valid_mask is not None:
        ok &= valid_mask
    return ok, metrics
