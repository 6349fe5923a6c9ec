"""P-Net / R-Net / O-Net, the cascaded detector's networks.

Counterpart of `facerecognitionpipeline_tpu/models/detector_nets.py`.
Inputs and outputs keep the JAX package's NHWC layout; inside, the nets run
NCHW. VALID convolutions, ceil-mode max pooling, and the channel-major
(NCHW) flatten before `fc1` that the published MTCNN weights expect.

`quantized=True` makes R-net's conv1-3 and fc1 and O-net's conv1-4 and fc1
static-scale int8 layers (`irse.QuantConv`/`QuantDense`, weights from
`models/quantize.py::quantize_detector_variables`), as the JAX package's
`_conv`/`_dense` factories do; P-net, the PReLUs and the cls/reg/landmark
heads stay float.

Each net computes in the dtype of its float parameters, read from its first
PReLU (the detector casts the module once, where flax casts per call; a
quantized layer has no float weight). Bias adds run as their own op after
the conv/matmul, so a bf16 forward rounds where flax does (the product,
then the sum).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from facerecognitionpipeline_tpu_torch.models.irse import QuantConv, QuantDense
from facerecognitionpipeline_tpu_torch.models.layers import PReLU


def _conv(layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
    if isinstance(layer, QuantConv):
        return layer(x)
    y = F.conv2d(x, layer.weight)
    return y + layer.bias.view(1, -1, 1, 1)


def _dense(layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
    if isinstance(layer, QuantDense):
        return layer(x)
    return F.linear(x, layer.weight) + layer.bias


def _make_conv(quantized: bool, in_ch: int, features: int, ksize: int) -> nn.Module:
    """VALID conv layer: float, or static-scale int8."""
    if quantized:
        return QuantConv(in_ch, features, ksize, stride=1, padding=0)
    return nn.Conv2d(in_ch, features, ksize)


def _make_dense(quantized: bool, in_features: int, features: int) -> nn.Module:
    if quantized:
        return QuantDense(in_features, features)
    return nn.Linear(in_features, features)


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
        x = x.to(self.prelu1.alpha.dtype).permute(0, 3, 1, 2)
        x = _pool(self.prelu1(_conv(self.conv1, x)), 2, 2)
        x = self.prelu2(_conv(self.conv2, x))
        x = self.prelu3(_conv(self.conv3, x))
        logits = _conv(self.cls, x).float()
        reg = _conv(self.reg, x).float()
        prob = torch.softmax(logits, dim=1)[:, 1]
        return prob, reg.permute(0, 2, 3, 1)


class RNet(nn.Module):
    """Refine net: 24x24 crops [B,24,24,3] -> (prob [B], reg [B,4]).
    quantized: int8 conv1-3 and fc1."""

    def __init__(self, quantized: bool = False):
        super().__init__()
        self.conv1 = _make_conv(quantized, 3, 28, 3)
        self.prelu1 = PReLU(28)
        self.conv2 = _make_conv(quantized, 28, 48, 3)
        self.prelu2 = PReLU(48)
        self.conv3 = _make_conv(quantized, 48, 64, 2)
        self.prelu3 = PReLU(64)
        self.fc1 = _make_dense(quantized, 64 * 3 * 3, 128)
        self.prelu4 = PReLU(128)
        self.cls = nn.Linear(128, 2)
        self.reg = nn.Linear(128, 4)

    def forward(self, x: torch.Tensor):
        x = x.to(self.prelu1.alpha.dtype).permute(0, 3, 1, 2)
        x = _pool(self.prelu1(_conv(self.conv1, x)), 3, 2)
        x = _pool(self.prelu2(_conv(self.conv2, x)), 3, 2)
        x = self.prelu3(_conv(self.conv3, x))
        x = self.prelu4(_dense(self.fc1, x.flatten(1)))
        prob = torch.softmax(_dense(self.cls, x).float(), dim=1)[:, 1]
        return prob, _dense(self.reg, x).float()


class ONet(nn.Module):
    """Output net: 48x48 crops [B,48,48,3] -> (prob [B], reg [B,4],
    landmarks [B,5,2] as box-relative fractions). quantized: int8 conv1-4
    and fc1."""

    def __init__(self, quantized: bool = False):
        super().__init__()
        self.conv1 = _make_conv(quantized, 3, 32, 3)
        self.prelu1 = PReLU(32)
        self.conv2 = _make_conv(quantized, 32, 64, 3)
        self.prelu2 = PReLU(64)
        self.conv3 = _make_conv(quantized, 64, 64, 3)
        self.prelu3 = PReLU(64)
        self.conv4 = _make_conv(quantized, 64, 128, 2)
        self.prelu4 = PReLU(128)
        self.fc1 = _make_dense(quantized, 128 * 3 * 3, 256)
        self.prelu5 = PReLU(256)
        self.cls = nn.Linear(256, 2)
        self.reg = nn.Linear(256, 4)
        self.landmarks = nn.Linear(256, 10)

    def forward(self, x: torch.Tensor):
        x = x.to(self.prelu1.alpha.dtype).permute(0, 3, 1, 2)
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
    """The three nets under one module (state-dict prefixes pnet/rnet/onet);
    `quantized` makes R-net and O-net int8."""

    def __init__(self, quantized: bool = False):
        super().__init__()
        self.pnet = PNet()
        self.rnet = RNet(quantized)
        self.onet = ONet(quantized)


def init_detector_variables(seed: int = 0) -> dict:
    """Random-init JAX-format variables for all three nets ({'pnet' |
    'rnet' | 'onet': {'params': ...}}; testing and benchmarking): the
    seeded lecun-normal init `MTCNNDetector(weights_path="random",
    init_seed=seed)` uses."""
    from facerecognitionpipeline_tpu_torch.models.convert import detector_variables_from_state
    from facerecognitionpipeline_tpu_torch.models.layers import lecun_normal_

    nets = DetectorNets()
    lecun_normal_(nets, torch.Generator().manual_seed(seed))
    return detector_variables_from_state(nets.state_dict())


def _np(v):
    if hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
    return np.asarray(v, dtype=np.float32)


def load_mtcnn_torch_statedict(statedicts: dict) -> dict:
    """Convert public MTCNN torch statedicts into JAX-format detector
    variables (numpy), as the JAX package's function of the same name;
    `models/convert.py::detector_state_from_jax` carries them into
    `DetectorNets`.

    `statedicts` maps 'pnet'/'rnet'/'onet' to torch statedicts using the
    widely-published naming (conv1..4, prelu1..5, dense4/5/6 or conv4_1-style
    heads). Conv kernels OIHW->HWIO; dense [out,in]->[in,out].
    """
    def conv(sd, k):
        return {"kernel": _np(sd[f"{k}.weight"]).transpose(2, 3, 1, 0),
                "bias": _np(sd[f"{k}.bias"])}

    def dense(sd, k):
        return {"kernel": _np(sd[f"{k}.weight"]).T, "bias": _np(sd[f"{k}.bias"])}

    def prelu(sd, k):
        return {"alpha": _np(sd[f"{k}.weight"])}

    def pick(sd, *names):
        for n in names:
            if f"{n}.weight" in sd:
                return n
        raise KeyError(f"none of {names} in statedict")

    p = statedicts["pnet"]
    pnet = {
        "conv1": conv(p, "conv1"), "prelu1": prelu(p, "prelu1"),
        "conv2": conv(p, "conv2"), "prelu2": prelu(p, "prelu2"),
        "conv3": conv(p, "conv3"), "prelu3": prelu(p, "prelu3"),
        "cls": conv(p, pick(p, "conv4_1", "cls")),
        "reg": conv(p, pick(p, "conv4_2", "reg")),
    }
    r = statedicts["rnet"]
    rnet = {
        "conv1": conv(r, "conv1"), "prelu1": prelu(r, "prelu1"),
        "conv2": conv(r, "conv2"), "prelu2": prelu(r, "prelu2"),
        "conv3": conv(r, "conv3"), "prelu3": prelu(r, "prelu3"),
        "fc1": dense(r, pick(r, "dense4", "fc1")), "prelu4": prelu(r, "prelu4"),
        "cls": dense(r, pick(r, "dense5_1", "cls")),
        "reg": dense(r, pick(r, "dense5_2", "reg")),
    }
    o = statedicts["onet"]
    onet = {
        "conv1": conv(o, "conv1"), "prelu1": prelu(o, "prelu1"),
        "conv2": conv(o, "conv2"), "prelu2": prelu(o, "prelu2"),
        "conv3": conv(o, "conv3"), "prelu3": prelu(o, "prelu3"),
        "conv4": conv(o, "conv4"), "prelu4": prelu(o, "prelu4"),
        "fc1": dense(o, pick(o, "dense5", "fc1")), "prelu5": prelu(o, "prelu5"),
        "cls": dense(o, pick(o, "dense6_1", "cls")),
        "reg": dense(o, pick(o, "dense6_2", "reg")),
        "landmarks": dense(o, pick(o, "dense6_3", "landmarks")),
    }
    return {
        "pnet": {"params": pnet},
        "rnet": {"params": rnet},
        "onet": {"params": onet},
    }
