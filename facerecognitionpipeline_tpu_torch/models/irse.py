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
unit survives as an `Affine`). `quantized=True` (with `folded`) swaps the
two 3x3 res convs of every unit for `QuantConv`, the JAX package's static-
scale int8 conv, with weights from `models/quantize.py`. Input is NHWC
[B,112,112,3] normalized BGR; the backbone runs NCHW in the dtype of its
float parameters. The fused int8 body (`FusedQuantBody`) and the training
conv `Int8FwdConv` are queued in ROADMAP.md.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
from torch import nn

from facerecognitionpipeline_tpu_torch.models.layers import Affine, PReLU
from facerecognitionpipeline_tpu_torch.ops.int8_gemm import (
    int8_conv2d,
    int8_linear,
    pack_weight,
)
from facerecognitionpipeline_tpu_torch.ops.numerics import rdiv

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


def quantize_activation(x: torch.Tensor, inv_scale: torch.Tensor) -> torch.Tensor:
    """clip(round(x * (1 / act_scale)), -127, 127) as int8, in float32
    whatever the compute dtype (round half to even, as jnp.round). The
    float32 scale as a 1-element tensor takes part in type promotion (a
    0-dim one would not), so a bf16 x is multiplied in float32 without a
    float32 copy of it first."""
    q = x * inv_scale.float().reshape(1)
    return q.round_().clamp_(-127, 127).to(torch.int8)


class _QuantLayer(nn.Module):
    """Buffers of a static-scale int8 layer, named as the JAX package's
    params: `kernel_q` int8 (HWIO, or [in, out]), `scale` float32 [out]
    (per output channel), `bias` float32 [out], `act_scale` float32 [] (the
    calibrated input scale). At load it derives the product's packed weight
    and, in float32, 1 / act_scale and act_scale * scale. A cast of the
    module to another float dtype leaves those float32 buffers float32 (the
    JAX package keeps them float32 whatever the compute dtype); a move to
    another device moves them.

    `plain=True` makes the layer take the int8 product's plain version on
    the card too: a check that both give the same sums, not a fallback."""

    _F32 = ("scale", "bias", "act_scale", "inv_act_scale", "out_scale")

    def __init__(self, kernel_shape: tuple[int, ...], features: int):
        super().__init__()
        self.features = features
        self.plain = False
        self.register_buffer("kernel_q", torch.zeros(kernel_shape, dtype=torch.int8))
        self.register_buffer("scale", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("act_scale", torch.ones(()))
        self.register_buffer("gemm_w", torch.empty(0, dtype=torch.int8), persistent=False)
        self.register_buffer("inv_act_scale", torch.ones(()), persistent=False)
        self.register_buffer("out_scale", torch.ones(features), persistent=False)
        self._derive()

    def _derive(self) -> None:
        with torch.no_grad():
            k = self.kernel_q
            self.gemm_w = pack_weight(k.reshape(-1, k.shape[-1]))
            self.inv_act_scale = rdiv(1.0, self.act_scale.float())
            self.out_scale = self.act_scale.float() * self.scale.float()

    def _load_from_state_dict(self, *args, **kwargs):
        super()._load_from_state_dict(*args, **kwargs)
        self._derive()

    def _apply(self, fn, recurse=True):
        keep = {name: self._buffers[name] for name in self._F32}
        super()._apply(fn, recurse)
        for name, t in keep.items():
            self._buffers[name] = t.to(self.kernel_q.device)
        return self

    def _epilogue(self, y: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        # three ops in the compute dtype, as the JAX package rounds them
        return y.to(dtype) * self.out_scale.to(dtype) + self.bias.to(dtype)


class QuantConv(_QuantLayer):
    """Static-scale int8 conv (the JAX package's `irse.QuantConv`): the
    input is quantized with the calibrated `act_scale`, convolved s8 x s8 ->
    s32 (`ops/int8_gemm.py`) and dequantized into the input's dtype with
    the bias. NCHW in and out (the product runs NHWC; a channels-last
    input costs no copy)."""

    def __init__(self, in_ch: int, features: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1):
        super().__init__((kernel_size, kernel_size, in_ch, features), features)
        self.ksize = (kernel_size, kernel_size)
        self.stride = stride
        self.padding = padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xq = quantize_activation(x.permute(0, 2, 3, 1), self.inv_act_scale)
        y = int8_conv2d(xq, self.gemm_w, self.ksize, self.stride, self.padding,
                        self.features, plain=self.plain)
        return self._epilogue(y, x.dtype).permute(0, 3, 1, 2)


class QuantDense(_QuantLayer):
    """Static-scale int8 dense layer (the JAX package's `irse.QuantDense`):
    x [B, in] -> [B, features] in x's dtype."""

    def __init__(self, in_features: int, features: int):
        super().__init__((in_features, features), features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xq = quantize_activation(x, self.inv_act_scale)
        y = int8_linear(xq, self.gemm_w, self.features, plain=self.plain)
        return self._epilogue(y, x.dtype)


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
        quantized: bool = False,
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
        if quantized:
            # the two 3x3 res convs carry ~99% of the backbone's operations;
            # everything around them stays in the float compute dtype
            self.res_conv1 = QuantConv(in_ch, depth, 3, 1, 1)
        else:
            self.res_conv1 = nn.Conv2d(in_ch, depth, 3, padding=1, bias=folded)
        if not folded:
            self.res_bn2 = nn.BatchNorm2d(depth, eps=_EPS)
        self.res_prelu = PReLU(depth)
        if quantized:
            self.res_conv2 = QuantConv(depth, depth, 3, stride, 1)
        else:
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
        quantized: bool = False,
        embedding_dim: int = 512,
        input_size: int = 112,
    ):
        super().__init__()
        if quantized and not folded:
            raise ValueError(
                "quantized=True requires folded=True (int8 kernels are "
                "produced from BN-folded weights; see models/quantize.py)."
            )
        self.folded = folded
        self.quantized = quantized
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
                        quantized=quantized,
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


def build_backbone(
    architecture: str, folded: bool = False, quantized: bool = False
) -> IRBackbone:
    """Factory mirroring the zoo's `build_model(arch)` naming. `folded`
    takes weights from `models/fold.py`; `quantized` (which needs `folded`)
    takes them from `models/quantize.py::quantize_folded_variables`."""
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
        quantized=quantized,
    )
