"""Small layers shared by the detector nets and the IR backbone.

Parameter names follow the JAX package's flax modules (`alpha`, `scale`,
`shift`) so `models/convert.py` maps them one to one.
"""

from __future__ import annotations

import math

import torch
from torch import nn


class PReLU(nn.Module):
    """Per-channel PReLU over dim 1 (NCHW or [B, C])."""

    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((channels,), 0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return torch.where(x >= 0, x, self.alpha.view(shape) * x)


class Affine(nn.Module):
    """Per-channel y = x * scale + shift over dim 1: an inference-mode
    BatchNorm that precedes a zero-padded conv and so cannot fold into it."""

    def __init__(self, channels: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(channels))
        self.shift = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1, 1, 1)
        return x * self.scale.view(shape) + self.shift.view(shape)


def lecun_normal_(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded init: every conv/linear weight ~ N(0, 1/fan_in) (flax's
    lecun_normal, untruncated), biases zero. Norm, PReLU and affine
    parameters keep their constructors' values."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                w = torch.randn(m.weight.shape, generator=generator)
                m.weight.copy_(w * fan_in ** -0.5)
                if m.bias is not None:
                    m.bias.zero_()


def lecun_truncated_normal_(module: nn.Module, generator: torch.Generator) -> None:
    """flax's initialisers, in distribution: every conv/linear weight from
    a normal truncated at +-2 standard deviations, scaled to variance
    1/fan_in (flax's lecun_normal, variance_scaling(1, 'fan_in',
    'truncated_normal')); biases zero. Norm, PReLU and affine parameters
    keep their constructors' values (flax's ones, zeros and 0.25). Draws
    by the inverse CDF in float64, from `generator` (a CPU generator)."""
    lo, hi = (1 + math.erf(-2 / math.sqrt(2))) / 2, (1 + math.erf(2 / math.sqrt(2))) / 2
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                u = torch.rand(m.weight.shape, generator=generator, dtype=torch.float64)
                z = math.sqrt(2) * torch.erfinv(2 * (lo + u * (hi - lo)) - 1)
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                m.weight.copy_((z * std).to(m.weight.dtype))
                if getattr(m, "bias", None) is not None:
                    m.bias.zero_()
