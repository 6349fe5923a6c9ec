"""Margin-softmax heads for face-recognition training, on tensors.

Counterpart of `facerecognitionpipeline_tpu/train/losses.py`:

* ArcFace: additive angular margin, cos(theta + m)            [s=64, m=0.5]
* CosFace: additive cosine margin, cos(theta) - m             [s=64, m=0.4]
* AdaFace: norm-adaptive margin (Kim et al., CVPR 2022): the feature norm
  proxies image quality, and the margin moves between angular and additive.

Each maps the cosine of the TARGET class (plus scalars) to the adjusted
target cosine; `trainer.py` puts it in the label's logit only. The clip
epsilon, the arccos route and ArcFace's fallback past pi are the JAX
package's, as written there.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-7


def arcface_margin_cosine(cos_t: torch.Tensor, m: float = 0.5) -> torch.Tensor:
    """cos(theta + m), with the linear surrogate where theta + m passes pi."""
    cos_t = cos_t.clamp(-1 + _EPS, 1 - _EPS)
    sin_t = torch.sqrt(1.0 - cos_t * cos_t)
    phi = cos_t * math.cos(m) - sin_t * math.sin(m)
    threshold = math.cos(math.pi - m)
    return torch.where(cos_t > threshold, phi, cos_t - m * math.sin(m))


def cosface_margin_cosine(cos_t: torch.Tensor, m: float = 0.4) -> torch.Tensor:
    return cos_t - m


def adaface_margin_cosine(
    cos_t: torch.Tensor,
    norms: torch.Tensor,
    norm_mean: torch.Tensor,
    norm_std: torch.Tensor,
    m: float = 0.4,
    h: float = 0.333,
) -> torch.Tensor:
    """cos_t [B] target cosines; norms [B] feature norms before the
    normalisation; norm_mean/std the (EMA) statistics of the norms. The
    quality term g in [-1, 1] carries no gradient: a large norm gets more
    angular margin, a small one an additive penalty."""
    g = (norms - norm_mean) / (norm_std / h + _EPS)
    g = g.clamp(-1.0, 1.0).detach()
    g_angle = -m * g
    theta = torch.arccos(cos_t.clamp(-1 + _EPS, 1 - _EPS))
    phi = torch.cos((theta + g_angle).clamp(_EPS, math.pi - _EPS))
    return phi - (m * g + m)
