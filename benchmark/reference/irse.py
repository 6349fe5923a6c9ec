"""Plain IR ResNet embedder in float32: the yardstick of the embed layer.

AdaFace's IR backbone (Kim et al., CVPR 2022; github.com/mk-minchul/AdaFace
`net.py`) in its inference form, with every BatchNorm folded: a 3x3 conv
(3 -> 64) and PReLU, then units of [affine -> 3x3 conv -> PReLU -> 3x3 conv
(stride s)] plus a shortcut (the input subsampled, or a 1x1 conv of stride
s where the width changes), stages of 64, 128, 256 and 512 channels whose
first unit strides 2, then a flatten in channel-major order, a dense layer
to 512 and the L2 norm. Input: [N, 112, 112, 3] BGR in [-1, 1].

`table(units)` is the architecture as the benchmark counts and draws it:
(name, shape, kind) of every parameter, in the served model's state-dict
names. `quantize` makes the two 3x3 convs of every unit static-scale int8
(or `bits`-bit) from the float32 weights and calibrated input maxima.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

STAGE_CHANNELS = (64, 128, 256, 512)
EMBED_DIM = 512


def units_of(units) -> list:
    """[(name, in_ch, depth, stride)] of every unit."""
    out, in_ch = [], 64
    for s, (n, depth) in enumerate(zip(units, STAGE_CHANNELS)):
        for u in range(n):
            out.append((f"stage{s}_unit{u}", in_ch, depth, 2 if u == 0 else 1))
            in_ch = depth
    return out


def table(units, input_size: int = 112) -> list:
    """(name, shape, kind) of every parameter: kind 'conv' or 'dense'
    (a weight, drawn N(0, 1/fan_in)), 'bias', 'alpha' (PReLU), 'scale' and
    'shift' (the folded affine before each unit's first conv)."""
    t = [("input_conv.weight", (64, 3, 3, 3), "conv"), ("input_conv.bias", (64,), "bias"),
         ("input_prelu.alpha", (64,), "alpha")]
    for name, cin, d, _ in units_of(units):
        if cin != d:
            t += [(f"{name}.shortcut_conv.weight", (d, cin, 1, 1), "conv"),
                  (f"{name}.shortcut_conv.bias", (d,), "bias")]
        t += [(f"{name}.res_affine.scale", (cin,), "scale"),
              (f"{name}.res_affine.shift", (cin,), "shift"),
              (f"{name}.res_conv1.weight", (d, cin, 3, 3), "conv"),
              (f"{name}.res_conv1.bias", (d,), "bias"),
              (f"{name}.res_prelu.alpha", (d,), "alpha"),
              (f"{name}.res_conv2.weight", (d, d, 3, 3), "conv"),
              (f"{name}.res_conv2.bias", (d,), "bias")]
    hw = (input_size // 16) ** 2
    t += [("output_fc.weight", (EMBED_DIM, STAGE_CHANNELS[-1] * hw), "dense"),
          ("output_fc.bias", (EMBED_DIM,), "bias")]
    return t


def _prelu(x, a):
    return torch.where(x >= 0, x, a.view(1, -1, *([1] * (x.dim() - 2))) * x)


class Embedder:
    """The reference forward over a state dict of float32 tensors."""

    def __init__(self, state: dict, units):
        self.p = state
        self.units = units_of(units)
        self.quant: dict = {}  # conv name -> (codes OIHW, w_scale [O], act, qmax)
        self.amax: dict | None = None

    def quantize(self, amax: dict, bits: int = 8) -> None:
        qmax = float(2 ** (bits - 1) - 1)
        for name, _, _, _ in self.units:
            for conv in ("res_conv1", "res_conv2"):
                w = self.p[f"{name}.{conv}.weight"]
                scale = (w.abs().amax(dim=(1, 2, 3)) / qmax).clamp_min(1e-12)
                codes = torch.round(w / scale.view(-1, 1, 1, 1)).clamp(-qmax, qmax)
                act = max(amax[(name, conv)], 1e-12) / qmax
                self.quant[f"{name}.{conv}"] = (codes, scale, act, qmax)

    def _conv(self, key, x, stride, pad):
        b = self.p[f"{key}.bias"].view(1, -1, 1, 1)
        q = self.quant.get(key)
        if q is None:
            return F.conv2d(x, self.p[f"{key}.weight"], None, stride, pad) + b
        codes, scale, act, qmax = q
        xq = torch.round(x / act).clamp(-qmax, qmax)
        y = F.conv2d(xq.double(), codes.double(), None, stride, pad).float()
        return y * (act * scale).view(1, -1, 1, 1) + b

    def _note(self, key, x):
        if self.amax is not None:
            v = float(x.abs().amax())
            self.amax[key] = max(self.amax.get(key, 0.0), v)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """[N, 112, 112, 3] -> unit-norm features [N, 512] float32."""
        p = self.p
        x = x.float().permute(0, 3, 1, 2)
        x = _prelu(self._conv("input_conv", x, 1, 1), p["input_prelu.alpha"])
        for name, cin, d, s in self.units:
            if cin == d:
                short = x[:, :, ::s, ::s]
            else:
                short = self._conv(f"{name}.shortcut_conv", x, s, 0)
            r = (x * p[f"{name}.res_affine.scale"].view(1, -1, 1, 1)
                 + p[f"{name}.res_affine.shift"].view(1, -1, 1, 1))
            self._note((name, "res_conv1"), r)
            r = _prelu(self._conv(f"{name}.res_conv1", r, 1, 1), p[f"{name}.res_prelu.alpha"])
            self._note((name, "res_conv2"), r)
            r = self._conv(f"{name}.res_conv2", r, s, 1)
            x = r + short
        x = x.flatten(1) @ p["output_fc.weight"].T + p["output_fc.bias"]
        return x / torch.linalg.vector_norm(x, dim=1, keepdim=True).clamp_min(1e-12)

    def calibrate(self, x: torch.Tensor) -> dict:
        """max |input| of every unit's two 3x3 convs over the batch x."""
        self.amax = {}
        try:
            self(x)
            return dict(self.amax)
        finally:
            self.amax = None


def preprocess(faces_rgb: torch.Tensor) -> torch.Tensor:
    """uint8 RGB faces [..., 112, 112, 3] -> BGR float32 in [-1, 1]."""
    return (faces_rgb.flip(-1).float() - 127.5) / 127.5
