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
scale int8 conv, with weights from `models/quantize.py`; `fused_int8=True`
(with `quantized`) makes each unit's residual body one `FusedQuantBody`
(weights from `quantize.fuse_quantized_params`). Input is NHWC
[B,112,112,3] normalized BGR; in eval mode the backbone runs NCHW in the
dtype of its float parameters.

Train mode (`forward(x, train=True, dtype=...)`, the JAX package's
`train=True`) keeps the parameters float32 and casts inputs and kernels to
the compute dtype per layer, as flax does; BatchNorm normalises with the
biased batch statistics E[x^2] - E[x]^2 computed in at least float32
(flax's formula) and reports them, without touching the running buffers:
`train/trainer.py` updates `batch_stats` from them with flax's momentum.
Dropout (rate 0.4) follows `output_bn`, with a mask drawn from the given
`torch.Generator` or handed in. `int8_fwd_train=True` makes the two res
convs `Int8FwdConv`: int8 forward with dynamic scales, float backward.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from facerecognitionpipeline_tpu_torch.models.layers import Affine, PReLU
from facerecognitionpipeline_tpu_torch.ops.int8_gemm import (
    int8_conv2d,
    int8_linear,
    pack_weight,
)
from facerecognitionpipeline_tpu_torch.ops.numerics import div, rdiv

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
DROPOUT_RATE = 0.4
#: flax's BatchNorm momentum: running = m * running + (1 - m) * batch
BN_MOMENTUM = 0.9


def quantize_activation(x: torch.Tensor, inv_scale: torch.Tensor) -> torch.Tensor:
    """clip(round(x * (1 / act_scale)), -127, 127) as int8, in float32
    whatever the compute dtype (round half to even, as jnp.round). The
    float32 scale as a 1-element tensor takes part in type promotion (a
    0-dim one would not), so a bf16 x is multiplied in float32 without a
    float32 copy of it first."""
    q = x * inv_scale.float().reshape(1)
    return q.round_().clamp_(-127, 127).to(torch.int8)


class _KeepFloat32(nn.Module):
    """Keeps the float32 buffers named in `_F32` float32 when the module is
    cast to another float dtype (the JAX package keeps its scales float32
    whatever the compute dtype); a move to another device moves them."""

    _F32: tuple = ()
    _ANCHOR = ""  # a buffer that is not kept: the device to follow

    def _apply(self, fn, recurse=True):
        keep = {name: self._buffers[name] for name in self._F32}
        super()._apply(fn, recurse)
        for name, t in keep.items():
            self._buffers[name] = t.to(self._buffers[self._ANCHOR].device)
        return self

    def _put(self, name: str, value: torch.Tensor) -> None:
        """Set a derived buffer. One of the same shape, dtype and device is
        written in place, so a CUDA graph captured over the module reads
        the values derived from a later `load_state_dict`."""
        old = self._buffers[name]
        if (old.shape == value.shape and old.dtype == value.dtype
                and old.device == value.device):
            old.copy_(value)
        else:
            self._buffers[name] = value


class _QuantLayer(_KeepFloat32):
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
    _ANCHOR = "kernel_q"

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
            self._put("gemm_w", pack_weight(k.reshape(-1, k.shape[-1])))
            self._put("inv_act_scale", rdiv(1.0, self.act_scale.float()))
            self._put("out_scale", self.act_scale.float() * self.scale.float())

    def _load_from_state_dict(self, *args, **kwargs):
        super()._load_from_state_dict(*args, **kwargs)
        self._derive()

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


def int8_forward_codes(x: torch.Tensor, w: torch.Tensor):
    """The int8 forward's dynamic quantization (the JAX package's
    `int8_fwd_conv`, in float32 whatever the compute dtype): x NCHW, w OIHW
    -> (xq int8 NHWC, wq int8 OIHW, ax float32 [] = max|x| / 127, aw float32
    [O] = max|w[o]| / 127, both at least 1e-12 / 127, correctly rounded
    quotients on every device)."""
    xf = x.float()
    ax = div(xf.abs().amax().clamp_min(1e-12), 127.0)
    wf = w.float()
    aw = div(wf.abs().amax(dim=(1, 2, 3)).clamp_min(1e-12), 127.0)
    xq = (xf.permute(0, 2, 3, 1) / ax).round_().clamp_(-127, 127).to(torch.int8)
    wq = (wf / aw.view(-1, 1, 1, 1)).round_().clamp_(-127, 127).to(torch.int8)
    return xq, wq, ax, aw


def int8_forward_sums(xq: torch.Tensor, wq: torch.Tensor, stride: int, padding: int,
                      plain: bool = False) -> torch.Tensor:
    """s8 x s8 -> s32 sums of the int8 forward: xq NHWC, wq OIHW ->
    [B, Ho, Wo, O] int32, through `ops/int8_gemm.py`."""
    o, _, kh, kw = wq.shape
    w_kn = wq.permute(2, 3, 1, 0).reshape(-1, o)  # HWIO rows
    return int8_conv2d(xq, pack_weight(w_kn), (kh, kw), stride, padding, o, plain=plain)


class _Int8FwdConvFn(torch.autograd.Function):
    """Forward: dynamic-scale int8 conv with exact s32 sums; backward: the
    float conv's VJP on the saved unquantized operands (a straight-through
    estimator: dgrad and wgrad only)."""

    @staticmethod
    def forward(ctx, x, w, stride, padding):
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.padding = stride, padding
        xq, wq, ax, aw = int8_forward_codes(x, w)
        y = int8_forward_sums(xq, wq, stride, padding)
        return (y.float() * (ax * aw)).to(x.dtype).permute(0, 3, 1, 2)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = torch.nn.grad.conv2d_input(x.shape, w, g, ctx.stride, ctx.padding)
        if ctx.needs_input_grad[1]:
            gw = torch.nn.grad.conv2d_weight(x, w.shape, g, ctx.stride, ctx.padding)
        return gx, gw, None, None


class Int8FwdConv(nn.Module):
    """Training-mode conv with int8 forward / float backward (the JAX
    package's `irse.Int8FwdConv`). It declares the `weight` [O, I, kh, kw] of
    the `nn.Conv2d` it replaces, so state dicts, checkpoints and exports
    are interchangeable. Input and kernel are cast to the input's dtype
    first, as the float conv's are."""

    def __init__(self, in_ch: int, features: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_ch, kernel_size, kernel_size))
        self.stride = stride
        self.padding = padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _Int8FwdConvFn.apply(x, self.weight.to(x.dtype), self.stride, self.padding)


class FusedQuantBody(_KeepFloat32):
    """The residual body of a quantized unit as one int8 chain (the JAX
    package's `irse.FusedQuantBody`; constants from
    `quantize.fuse_quantized_params`):

      xq = sat(round(x * qscale + qshift))                  int8
      y1 = conv3x3(xq, kernel1_q)                           s32
      mq = sat(round(prelu(y1 * mid_scale + mid_bias)))     int8
      y2 = conv3x3(mq, kernel2_q, stride)                   s32
      out = y2 * out_scale + out_bias                       compute dtype

    in float32 between the products, with int8 the only intermediate that
    is stored. NCHW in and out; the products run NHWC through
    `ops/int8_gemm.py`."""

    _F32 = ("qscale", "qshift", "mid_scale", "mid_bias", "alpha", "out_scale", "out_bias")
    _ANCHOR = "kernel1_q"

    def __init__(self, in_ch: int, depth: int, stride: int = 1):
        super().__init__()
        self.depth = depth
        self.stride = stride
        self.plain = False
        for name, n, v in (("qscale", in_ch, 1.0), ("qshift", in_ch, 0.0),
                           ("mid_scale", depth, 1.0), ("mid_bias", depth, 0.0),
                           ("alpha", depth, 0.25), ("out_scale", depth, 1.0),
                           ("out_bias", depth, 0.0)):
            self.register_buffer(name, torch.full((n,), v))
        self.register_buffer("kernel1_q", torch.zeros((3, 3, in_ch, depth), dtype=torch.int8))
        self.register_buffer("kernel2_q", torch.zeros((3, 3, depth, depth), dtype=torch.int8))
        self.register_buffer("gemm_w1", torch.empty(0, dtype=torch.int8), persistent=False)
        self.register_buffer("gemm_w2", torch.empty(0, dtype=torch.int8), persistent=False)
        self._derive()

    def _derive(self) -> None:
        with torch.no_grad():
            self._put("gemm_w1", pack_weight(self.kernel1_q.reshape(-1, self.depth)))
            self._put("gemm_w2", pack_weight(self.kernel2_q.reshape(-1, self.depth)))

    def _load_from_state_dict(self, *args, **kwargs):
        super()._load_from_state_dict(*args, **kwargs)
        self._derive()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xq = (x.permute(0, 2, 3, 1).float() * self.qscale + self.qshift)
        xq = xq.round_().clamp_(-127, 127).to(torch.int8)
        y1 = int8_conv2d(xq, self.gemm_w1, (3, 3), 1, 1, self.depth, plain=self.plain)
        m = y1.float() * self.mid_scale + self.mid_bias
        m = torch.where(m >= 0, m, self.alpha * m)
        mq = m.round_().clamp_(-127, 127).to(torch.int8)
        y2 = int8_conv2d(mq, self.gemm_w2, (3, 3), self.stride, 1, self.depth,
                         plain=self.plain)
        out = y2.float() * self.out_scale + self.out_bias
        return out.to(x.dtype).permute(0, 3, 1, 2)


# ------------------------------------------------------------- train mode


def _conv_train(layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A conv of the unfolded backbone in train mode: float32 kernel cast
    to the compute dtype of x (flax's promote_dtype), or the int8 forward."""
    if isinstance(layer, Int8FwdConv):
        return layer(x)
    return F.conv2d(x, layer.weight.to(x.dtype), None, layer.stride, layer.padding)


def _bn_train(bn: nn.Module, x: torch.Tensor, stats: dict) -> torch.Tensor:
    """flax BatchNorm in train mode: mean and the biased variance E[x^2] -
    E[x]^2 (clipped at 0) in at least float32 over every axis but the
    channels, then (x - mean) * (rsqrt(var + eps) * scale) + bias in that
    precision, cast to the compute dtype. The batch statistics go to `stats[bn.stat_name]`."""
    dims = (0,) if x.dim() == 2 else (0, 2, 3)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = xf.mean(dims)
    var = ((xf * xf).mean(dims) - mean * mean).clamp_min(0.0)
    stats[bn.stat_name] = (mean.detach(), var.detach())
    mul = torch.rsqrt(var + bn.eps)
    if bn.weight is not None:
        mul = mul * bn.weight
    y = (x - mean.view(shape)) * mul.view(shape)
    if bn.bias is not None:
        y = y + bn.bias.view(shape)
    return y.to(x.dtype)


def _prelu_train(layer: PReLU, x: torch.Tensor) -> torch.Tensor:
    """flax PReLU: alpha cast to the dtype of x first."""
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return torch.where(x >= 0, x, layer.alpha.to(x.dtype).view(shape) * x)


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

    def forward_train(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3), keepdim=True)
        s = torch.relu(_conv_train(self.fc1, s))
        return x * torch.sigmoid(_conv_train(self.fc2, s))


class BasicBlockIR(nn.Module):
    """One IR residual unit; `use_se` makes it IR-SE. `conv_shortcut`
    (iresnet) uses Conv1x1+BN whenever the unit strides."""

    def __init__(
        self, in_ch: int, depth: int, stride: int, use_se: bool,
        conv_shortcut: bool = False, folded: bool = False,
        quantized: bool = False, fused_int8: bool = False,
        int8_fwd_train: bool = False,
    ):
        super().__init__()
        self.stride = stride
        self.folded = folded
        self.fused = quantized and fused_int8
        self.identity = in_ch == depth and not (conv_shortcut and stride != 1)
        if not self.identity:
            self.shortcut_conv = nn.Conv2d(
                in_ch, depth, 1, stride=stride, bias=folded
            )
            if not folded:
                self.shortcut_bn = nn.BatchNorm2d(depth, eps=_EPS)
        if self.fused:
            self.body = FusedQuantBody(in_ch, depth, stride)
            self.se = SEModule(depth) if use_se else None
            return
        int8_fwd = int8_fwd_train and not folded
        if folded:
            self.res_affine = Affine(in_ch)
        else:
            self.res_bn1 = nn.BatchNorm2d(in_ch, eps=_EPS)
        if quantized:
            # the two 3x3 res convs carry ~99% of the backbone's operations;
            # everything around them stays in the float compute dtype
            self.res_conv1 = QuantConv(in_ch, depth, 3, 1, 1)
        elif int8_fwd:
            self.res_conv1 = Int8FwdConv(in_ch, depth, 3, 1, 1)
        else:
            self.res_conv1 = nn.Conv2d(in_ch, depth, 3, padding=1, bias=folded)
        if not folded:
            self.res_bn2 = nn.BatchNorm2d(depth, eps=_EPS)
        self.res_prelu = PReLU(depth)
        if quantized:
            self.res_conv2 = QuantConv(depth, depth, 3, stride, 1)
        elif int8_fwd:
            self.res_conv2 = Int8FwdConv(depth, depth, 3, stride, 1)
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
        if self.fused:
            r = self.body(x)
        elif self.folded:
            r = self.res_prelu(self.res_conv1(self.res_affine(x)))
            r = self.res_conv2(r)
        else:
            r = self.res_bn2(self.res_conv1(self.res_bn1(x)))
            r = self.res_bn3(self.res_conv2(self.res_prelu(r)))
        if self.se is not None:
            r = self.se(r)
        return r + shortcut

    def forward_train(self, x: torch.Tensor, stats: dict) -> torch.Tensor:
        """Train mode of the unfolded unit (see `_bn_train`)."""
        if self.identity:
            shortcut = x[:, :, :: self.stride, :: self.stride]
        else:
            shortcut = _bn_train(self.shortcut_bn, _conv_train(self.shortcut_conv, x), stats)
        r = _bn_train(self.res_bn1, x, stats)
        r = _bn_train(self.res_bn2, _conv_train(self.res_conv1, r), stats)
        r = _prelu_train(self.res_prelu, r)
        r = _bn_train(self.res_bn3, _conv_train(self.res_conv2, r), stats)
        if self.se is not None:
            r = self.se.forward_train(r)
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
        fused_int8: bool = False,
        int8_fwd_train: bool = False,
        embedding_dim: int = 512,
        input_size: int = 112,
    ):
        super().__init__()
        if quantized and not folded:
            raise ValueError(
                "quantized=True requires folded=True (int8 kernels are "
                "produced from BN-folded weights; see models/quantize.py)."
            )
        if fused_int8 and not quantized:
            raise ValueError("fused_int8=True requires quantized=True")
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
                        quantized=quantized, fused_int8=fused_int8,
                        int8_fwd_train=int8_fwd_train,
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
        for name, m in self.named_modules():
            if isinstance(m, nn.modules.batchnorm._BatchNorm):
                m.stat_name = name  # the key of its batch statistics in train mode

    def forward(
        self, x: torch.Tensor, train: bool = False, dtype: torch.dtype | None = None,
        generator: torch.Generator | None = None, dropout_mask: torch.Tensor | None = None,
        stats: dict | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """x [B,112,112,3] -> (feature [B,D] float32 unit-norm, norm [B,1]
        float32). train=True: the train mode described above, computing in
        `dtype` (default float32) with the float32 parameters; the dropout
        mask is drawn from `generator` (on the device of x), unless
        `dropout_mask` (bool [B, C, h, w], NCHW) is given; each BatchNorm's
        (mean, biased var) lands in `stats` under its module name."""
        if train:
            return self._forward_train(x, dtype or torch.float32, generator,
                                       dropout_mask, {} if stats is None else stats)
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

    def _forward_train(self, x, dtype, generator, dropout_mask, stats):
        if self.folded:
            raise ValueError(
                "folded=True is an inference-only structure (BN statistics are "
                "baked into conv weights); train with folded=False."
            )
        x = x.to(dtype).permute(0, 3, 1, 2)
        x = _bn_train(self.input_bn, _conv_train(self.input_conv, x), stats)
        x = _prelu_train(self.input_prelu, x)
        for name in self.unit_names:
            x = getattr(self, name).forward_train(x, stats)
        x = _bn_train(self.output_bn, x, stats)
        keep = 1.0 - DROPOUT_RATE
        if dropout_mask is None:
            dropout_mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
        elif tuple(dropout_mask.shape) != tuple(x.shape):
            raise ValueError(f"dropout_mask {tuple(dropout_mask.shape)} != {tuple(x.shape)}")
        x = torch.where(dropout_mask, div(x, keep), torch.zeros((), dtype=x.dtype, device=x.device))
        w = self.output_fc.weight.to(dtype)
        x = F.linear(x.flatten(1), w) + self.output_fc.bias.to(dtype)
        x = _bn_train(self.output_feature_bn, x, stats).float()
        norm = torch.linalg.vector_norm(x, dim=1, keepdim=True)
        return x / norm.clamp_min(1e-12), norm


def build_backbone(
    architecture: str, folded: bool = False, quantized: bool = False,
    fused_int8: bool = False, int8_fwd_train: bool = False,
) -> IRBackbone:
    """Factory mirroring the zoo's `build_model(arch)` naming. `folded`
    takes weights from `models/fold.py`; `quantized` (which needs `folded`)
    takes them from `models/quantize.py::quantize_folded_variables`, and
    `fused_int8` (which needs `quantized`) from
    `quantize.fuse_quantized_params`. `int8_fwd_train` makes the two res
    convs of every unfolded unit `Int8FwdConv` (same parameters)."""
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
        fused_int8=fused_int8,
        int8_fwd_train=int8_fwd_train,
    )
