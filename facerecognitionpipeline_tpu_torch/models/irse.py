"""IR / IR-SE ResNet embedding backbones (float path).

Counterpart of `facerecognitionpipeline_tpu/models/irse.py` (the AdaFace
model-zoo architecture):

  input  : Conv3x3(3->64) -> BN -> PReLU
  body   : BasicBlockIR[SE] units; shortcut = subsampling or Conv1x1(s)+BN,
           residual = BN -> Conv3x3 -> BN -> PReLU -> Conv3x3(s) -> BN [-> SE]
  output : BN -> Flatten (NCHW, channel-major) -> Linear(512*7*7 -> 512)
           -> BatchNorm1d(no affine)
  head   : (x / ||x||, ||x||)

`folded=True` is the inference structure whose weights come from
`models/fold.py` (BNs baked into convs and the fc; the pre-conv BN of each
unit survives as an `Affine`). Input is NHWC [B,112,112,3] normalized BGR;
the backbone runs NCHW in the dtype of its parameters. The int8 variants of
the JAX package are not ported yet.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
from torch import nn

from facerecognitionpipeline_tpu_torch.models.layers import Affine, PReLU

BACKBONE_CONFIGS: dict[str, dict[str, Any]] = {
    "ir_micro": {"units": (1, 1, 1, 1), "use_se": False},  # smoke tests only
    "ir_18": {"units": (2, 2, 2, 2), "use_se": False},
    "ir_34": {"units": (3, 4, 6, 3), "use_se": False},
    "ir_50": {"units": (3, 4, 14, 3), "use_se": False},
    "ir_101": {"units": (3, 13, 30, 3), "use_se": False},
    "ir_152": {"units": (3, 8, 36, 3), "use_se": False},
    "ir_se_50": {"units": (3, 4, 14, 3), "use_se": True},
    "ir_se_101": {"units": (3, 13, 30, 3), "use_se": True},
    "iresnet_18": {"units": (2, 2, 2, 2), "use_se": False, "conv_shortcut": True},
    "iresnet_34": {"units": (3, 4, 6, 3), "use_se": False, "conv_shortcut": True},
    "iresnet_50": {"units": (3, 4, 14, 3), "use_se": False, "conv_shortcut": True},
    "iresnet_100": {"units": (3, 13, 30, 3), "use_se": False, "conv_shortcut": True},
}
_STAGE_CHANNELS = (64, 128, 256, 512)
_EPS = 1e-5


class SEModule(nn.Module):
    """Squeeze-and-excitation: GAP -> 1x1 (C -> C/r) -> ReLU -> 1x1 -> sigmoid."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.fc1 = nn.Conv2d(channels, channels // reduction, 1, bias=False)
        self.fc2 = nn.Conv2d(channels // reduction, channels, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3), keepdim=True)
        s = self.fc2(torch.relu(self.fc1(s)))
        return x * torch.sigmoid(s)


class BasicBlockIR(nn.Module):
    """One IR residual unit; `use_se` makes it IR-SE. `conv_shortcut`
    (iresnet) uses Conv1x1+BN whenever the unit strides."""

    def __init__(
        self, in_ch: int, depth: int, stride: int, use_se: bool,
        conv_shortcut: bool = False, folded: bool = False,
    ):
        super().__init__()
        self.stride = stride
        self.folded = folded
        self.identity = in_ch == depth and not (conv_shortcut and stride != 1)
        if not self.identity:
            self.shortcut_conv = nn.Conv2d(
                in_ch, depth, 1, stride=stride, bias=folded
            )
            if not folded:
                self.shortcut_bn = nn.BatchNorm2d(depth, eps=_EPS)
        if folded:
            self.res_affine = Affine(in_ch)
        else:
            self.res_bn1 = nn.BatchNorm2d(in_ch, eps=_EPS)
        self.res_conv1 = nn.Conv2d(in_ch, depth, 3, padding=1, bias=folded)
        if not folded:
            self.res_bn2 = nn.BatchNorm2d(depth, eps=_EPS)
        self.res_prelu = PReLU(depth)
        self.res_conv2 = nn.Conv2d(
            depth, depth, 3, stride=stride, padding=1, bias=folded
        )
        if not folded:
            self.res_bn3 = nn.BatchNorm2d(depth, eps=_EPS)
        self.se = SEModule(depth) if use_se else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.identity:
            shortcut = x[:, :, :: self.stride, :: self.stride]
        else:
            shortcut = self.shortcut_conv(x)
            if not self.folded:
                shortcut = self.shortcut_bn(shortcut)
        if self.folded:
            r = self.res_prelu(self.res_conv1(self.res_affine(x)))
            r = self.res_conv2(r)
        else:
            r = self.res_bn2(self.res_conv1(self.res_bn1(x)))
            r = self.res_bn3(self.res_conv2(self.res_prelu(r)))
        if self.se is not None:
            r = self.se(r)
        return r + shortcut


class IRBackbone(nn.Module):
    """forward(x [B,112,112,3]) -> (feature [B,D] float32 unit-norm,
    norm [B,1] float32)."""

    def __init__(
        self,
        units: Sequence[int],
        use_se: bool = False,
        conv_shortcut: bool = False,
        folded: bool = False,
        embedding_dim: int = 512,
        input_size: int = 112,
    ):
        super().__init__()
        self.folded = folded
        self.input_conv = nn.Conv2d(3, 64, 3, padding=1, bias=folded)
        if not folded:
            self.input_bn = nn.BatchNorm2d(64, eps=_EPS)
        self.input_prelu = PReLU(64)
        in_ch = 64
        self.unit_names: list[str] = []
        for stage, (n_units, depth) in enumerate(zip(units, _STAGE_CHANNELS)):
            for unit in range(n_units):
                name = f"stage{stage}_unit{unit}"
                self.add_module(
                    name,
                    BasicBlockIR(
                        in_ch, depth, 2 if unit == 0 else 1, use_se,
                        conv_shortcut=conv_shortcut, folded=folded,
                    ),
                )
                self.unit_names.append(name)
                in_ch = depth
        if not folded:
            self.output_bn = nn.BatchNorm2d(in_ch, eps=_EPS)
        hw = (input_size // 16) ** 2
        self.output_fc = nn.Linear(in_ch * hw, embedding_dim)
        if not folded:
            self.output_feature_bn = nn.BatchNorm1d(
                embedding_dim, eps=_EPS, affine=False
            )

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        x = x.to(self.input_conv.weight.dtype).permute(0, 3, 1, 2)
        x = self.input_conv(x)
        if not self.folded:
            x = self.input_bn(x)
        x = self.input_prelu(x)
        for name in self.unit_names:
            x = getattr(self, name)(x)
        if not self.folded:
            x = self.output_bn(x)
        x = self.output_fc(x.flatten(1))
        if not self.folded:
            x = self.output_feature_bn(x)
        x = x.float()
        norm = torch.linalg.vector_norm(x, dim=1, keepdim=True)
        return x / norm.clamp_min(1e-12), norm


def build_backbone(architecture: str, folded: bool = False) -> IRBackbone:
    """Factory mirroring the zoo's `build_model(arch)` naming."""
    if architecture not in BACKBONE_CONFIGS:
        raise ValueError(
            f"Unknown architecture: {architecture}. "
            f"Available: {sorted(BACKBONE_CONFIGS)}"
        )
    cfg = BACKBONE_CONFIGS[architecture]
    return IRBackbone(
        units=cfg["units"],
        use_se=cfg["use_se"],
        conv_shortcut=cfg.get("conv_shortcut", False),
        folded=folded,
    )
