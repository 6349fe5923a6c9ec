"""P-Net / R-Net / O-Net, the cascaded detector's networks (float only).

Counterpart of `facerecognitionpipeline_tpu/models/detector_nets.py`.
Inputs and outputs keep the JAX package's NHWC layout; inside, the nets run
NCHW. VALID convolutions, ceil-mode max pooling, and the channel-major
(NCHW) flatten before `fc1` that the published MTCNN weights expect.

Each net computes in the dtype of its parameters (the detector casts the
module once, where flax casts per call). Bias adds run as their own op
after the conv/matmul, so a bf16 forward rounds where flax does (the
product, then the sum).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from facerecognitionpipeline_tpu_torch.models.layers import PReLU


def _conv(layer: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    y = F.conv2d(x, layer.weight)
    return y + layer.bias.view(1, -1, 1, 1)


def _dense(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, layer.weight) + layer.bias


def _pool(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """Ceil-mode max pool; equals the JAX package's explicit -inf padding
    rule `pad = -(h - window) % stride` for every size the nets see."""
    return F.max_pool2d(x, window, stride, ceil_mode=True)


class PNet(nn.Module):
    """Proposal net: x [B,H,W,3] -> (prob [B,H',W'] f32, reg [B,H',W',4] f32)."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 10, 3)
        self.prelu1 = PReLU(10)
        self.conv2 = nn.Conv2d(10, 16, 3)
        self.prelu2 = PReLU(16)
        self.conv3 = nn.Conv2d(16, 32, 3)
        self.prelu3 = PReLU(32)
        self.cls = nn.Conv2d(32, 2, 1)
        self.reg = nn.Conv2d(32, 4, 1)

    def forward(self, x: torch.Tensor):
        x = x.to(self.conv1.weight.dtype).permute(0, 3, 1, 2)
        x = _pool(self.prelu1(_conv(self.conv1, x)), 2, 2)
        x = self.prelu2(_conv(self.conv2, x))
        x = self.prelu3(_conv(self.conv3, x))
        logits = _conv(self.cls, x).float()
        reg = _conv(self.reg, x).float()
        prob = torch.softmax(logits, dim=1)[:, 1]
        return prob, reg.permute(0, 2, 3, 1)


class RNet(nn.Module):
    """Refine net: 24x24 crops [B,24,24,3] -> (prob [B], reg [B,4])."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 28, 3)
        self.prelu1 = PReLU(28)
        self.conv2 = nn.Conv2d(28, 48, 3)
        self.prelu2 = PReLU(48)
        self.conv3 = nn.Conv2d(48, 64, 2)
        self.prelu3 = PReLU(64)
        self.fc1 = nn.Linear(64 * 3 * 3, 128)
        self.prelu4 = PReLU(128)
        self.cls = nn.Linear(128, 2)
        self.reg = nn.Linear(128, 4)

    def forward(self, x: torch.Tensor):
        x = x.to(self.conv1.weight.dtype).permute(0, 3, 1, 2)
        x = _pool(self.prelu1(_conv(self.conv1, x)), 3, 2)
        x = _pool(self.prelu2(_conv(self.conv2, x)), 3, 2)
        x = self.prelu3(_conv(self.conv3, x))
        x = self.prelu4(_dense(self.fc1, x.flatten(1)))
        prob = torch.softmax(_dense(self.cls, x).float(), dim=1)[:, 1]
        return prob, _dense(self.reg, x).float()


class ONet(nn.Module):
    """Output net: 48x48 crops [B,48,48,3] -> (prob [B], reg [B,4],
    landmarks [B,5,2] as box-relative fractions)."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 32, 3)
        self.prelu1 = PReLU(32)
        self.conv2 = nn.Conv2d(32, 64, 3)
        self.prelu2 = PReLU(64)
        self.conv3 = nn.Conv2d(64, 64, 3)
        self.prelu3 = PReLU(64)
        self.conv4 = nn.Conv2d(64, 128, 2)
        self.prelu4 = PReLU(128)
        self.fc1 = nn.Linear(128 * 3 * 3, 256)
        self.prelu5 = PReLU(256)
        self.cls = nn.Linear(256, 2)
        self.reg = nn.Linear(256, 4)
        self.landmarks = nn.Linear(256, 10)

    def forward(self, x: torch.Tensor):
        x = x.to(self.conv1.weight.dtype).permute(0, 3, 1, 2)
        x = _pool(self.prelu1(_conv(self.conv1, x)), 3, 2)
        x = _pool(self.prelu2(_conv(self.conv2, x)), 3, 2)
        x = _pool(self.prelu3(_conv(self.conv3, x)), 2, 2)
        x = self.prelu4(_conv(self.conv4, x))
        x = self.prelu5(_dense(self.fc1, x.flatten(1)))
        prob = torch.softmax(_dense(self.cls, x).float(), dim=1)[:, 1]
        reg = _dense(self.reg, x).float()
        lmk = _dense(self.landmarks, x).float()
        # canonical layout [x1..x5, y1..y5] -> [5, 2]
        return prob, reg, torch.stack([lmk[:, :5], lmk[:, 5:]], dim=-1)


class DetectorNets(nn.Module):
    """The three nets under one module (state-dict prefixes pnet/rnet/onet)."""

    def __init__(self):
        super().__init__()
        self.pnet = PNet()
        self.rnet = RNet()
        self.onet = ONet()
