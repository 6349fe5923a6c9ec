"""Small layers shared by the detector nets and the IR backbone.

Parameter names follow the JAX package's flax modules (`alpha`, `scale`,
`shift`) so `models/convert.py` maps them one to one.
"""

from __future__ import annotations

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
