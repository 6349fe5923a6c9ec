"""Plain MTCNN cascade in float32: the yardstick of the detect layer.

Written from the published cascade (Zhang et al., arXiv:1604.02878) with
the fixed candidate budgets of the served detector, so that the two can be
compared face by face:

  pyramid (progressive antialiased-linear resizes, scale 12/min_face then
  x0.709 while the short side stays >= 12 px) -> P-net -> 128 proposals a
  scale -> greedy NMS (IoU > 0.7) -> 256 -> squared, R-net on 24 px crops
  of the frame downsampled 2x -> NMS (0.7) -> 96 -> O-net on 48 px crops ->
  NMS by the smaller area (0.7) -> max_faces.

Plain torch in float32 with TF32 off (`run_reference` turns it off), greedy
NMS on the host. Weights are the `.npz` the benchmark hands to both sides
(HWIO conv kernels, [in, out] dense kernels). `quant` makes the R-net and
O-net layers static-scale int8 (per-output-channel weight codes from the
float32 weights, per-tensor activation scales from `calibrate`), computed
with exact integer sums.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

P_PER_SCALE = 128
P_KEEP = 256
R_KEEP = 96
NEG = -1e9

# the layers of each net in order; conv kernels (kh, kw), pools after a layer
_RNET_Q = ("conv1", "conv2", "conv3", "fc1")
_ONET_Q = ("conv1", "conv2", "conv3", "conv4", "fc1")


def load_weights(path: str, device) -> dict:
    """'/'-keyed `.npz` -> {net: {layer: {name: float32 tensor}}}."""
    out: dict = {}
    with np.load(path, allow_pickle=False) as blob:
        for key in blob.files:
            net, _, layer, name = key.split("/")
            out.setdefault(net, {}).setdefault(layer, {})[name] = torch.from_numpy(
                blob[key].astype(np.float32)).to(device)
    return out


def resize_matrix(src: int, dst: int) -> np.ndarray:
    """[dst, src] antialiased linear resize weights, rows normalised:
    output o reads (o + 0.5) * src / dst - 0.5 with a hat stretched by
    src / dst on downscale."""
    scale = dst / src
    pos = (np.arange(dst, dtype=np.float64) + 0.5) / scale - 0.5
    d = np.abs(pos[:, None] - np.arange(src, dtype=np.float64)[None, :])
    w = np.maximum(0.0, 1.0 - (d * scale if scale < 1.0 else d))
    return (w / w.sum(axis=1, keepdims=True)).astype(np.float32)


def pyramid_scales(h: int, w: int, min_face: float, factor: float = 0.709) -> list:
    scales, s = [], 12.0 / min_face
    while min(h, w) * s >= 12.0:
        scales.append(s)
        s *= factor
    return scales


def crop_resize(image: torch.Tensor, boxes: torch.Tensor, k: int) -> torch.Tensor:
    """One frame [H, W, C] float32, boxes [N, 4] -> [N, k, k, C]: bilinear
    with half-pixel centres, hat weights max(0, 1 - |p - i|), zero outside."""
    h, w, c = image.shape
    x1, y1, x2, y2 = boxes.float().unbind(-1)
    t = (torch.arange(k, dtype=torch.float32, device=image.device) + 0.5) / k

    def hat(start, size, dim):
        p = start[:, None] + size[:, None].clamp_min(1e-6) * t - 0.5  # [N, k]
        pix = torch.arange(dim, dtype=torch.float32, device=image.device)
        return (1.0 - (p[..., None] - pix).abs()).clamp_min(0.0)  # [N, k, dim]

    my, mx = hat(y1, y2 - y1, h), hat(x1, x2 - x1, w)
    rows = torch.matmul(my, image.reshape(h, w * c)).reshape(-1, k, w, c)
    return torch.einsum("nxw,nywc->nyxc", mx, rows)


def iou_matrix(b: torch.Tensor, mode: str) -> torch.Tensor:
    x1, y1, x2, y2 = b.unbind(-1)
    area = (x2 - x1).clamp_min(0) * (y2 - y1).clamp_min(0)
    iw = (torch.minimum(x2[:, None], x2[None]) - torch.maximum(x1[:, None], x1[None])).clamp_min(0)
    ih = (torch.minimum(y2[:, None], y2[None]) - torch.maximum(y1[:, None], y1[None])).clamp_min(0)
    inter = iw * ih
    if mode == "min":
        den = torch.minimum(area[:, None], area[None])
    else:
        den = area[:, None] + area[None] - inter
    return inter / den.clamp_min(1e-9)


def greedy_nms(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
               thr: float, mode: str = "union") -> torch.Tensor:
    """Greedy NMS of one frame: visit boxes by score (ties to the lower
    index), keep a valid box unless a kept one overlaps it by more than
    `thr`. -> keep [N] bool in the input order."""
    masked = torch.where(valid, scores, torch.full_like(scores, NEG))
    order = torch.sort(masked, descending=True, stable=True).indices
    iou = iou_matrix(boxes[order], mode).cpu().numpy()
    v = valid[order].cpu().numpy()
    keep = np.zeros(len(v), bool)
    blocked = np.zeros(len(v), bool)
    for i in range(len(v)):
        if v[i] and not blocked[i]:
            keep[i] = True
            blocked |= iou[i] > thr
    out = torch.zeros_like(valid)
    out[order] = torch.from_numpy(keep).to(valid.device)
    return out


def top_k(x: torch.Tensor, k: int):
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def square(b: torch.Tensor) -> torch.Tensor:
    x1, y1, x2, y2 = b.unbind(-1)
    side = torch.maximum(x2 - x1, y2 - y1)
    cx, cy = (x1 + x2) * 0.5, (y1 + y2) * 0.5
    return torch.stack([cx - side * 0.5, cy - side * 0.5, cx + side * 0.5, cy + side * 0.5], -1)


def apply_reg(b: torch.Tensor, reg: torch.Tensor) -> torch.Tensor:
    w = b[..., 2] - b[..., 0]
    h = b[..., 3] - b[..., 1]
    return b + reg * torch.stack([w, h, w, h], -1)


def quantize_weight(kernel: torch.Tensor, bits: int = 8):
    """Symmetric per-output-channel codes of an HWIO or [in, out] kernel:
    (codes as float32, scale [out])."""
    qmax = float(2 ** (bits - 1) - 1)
    axes = tuple(range(kernel.dim() - 1))
    scale = (kernel.abs().amax(dim=axes) / qmax).clamp_min(1e-12)
    return torch.round(kernel / scale).clamp(-qmax, qmax), scale


class Cascade:
    """The reference cascade over frames of one size."""

    def __init__(self, weights: dict, det_size, max_faces: int, min_face: float = 40.0,
                 thresholds=(0.6, 0.7, 0.5), device="cpu"):
        self.w = weights
        self.h, self.w_ = det_size
        self.max_faces = max_faces
        self.thr = thresholds
        self.device = torch.device(device)
        self.scales = pyramid_scales(self.h, self.w_, min_face)
        self.mats = []
        ph, pw = self.h, self.w_
        for s in self.scales:
            sh, sw = int(math.ceil(self.h * s)), int(math.ceil(self.w_ * s))
            self.mats.append((torch.from_numpy(resize_matrix(ph, sh)).to(self.device),
                              torch.from_numpy(resize_matrix(pw, sw)).to(self.device)))
            ph, pw = sh, sw
        self.quant: dict = {}  # (net, layer) -> (codes, w_scale, act_scale, qmax)
        self.amax: dict | None = None  # filled while calibrating

    # ------------------------------------------------------------ layers

    def quantize(self, amax: dict, bits: int = 8) -> None:
        """Make the R-net and O-net layers int8 (or `bits`-bit) from the
        float32 weights and the calibrated input maxima `amax`."""
        qmax = float(2 ** (bits - 1) - 1)
        for net, layers in (("rnet", _RNET_Q), ("onet", _ONET_Q)):
            for layer in layers:
                codes, scale = quantize_weight(self.w[net][layer]["kernel"], bits)
                act = max(amax[(net, layer)], 1e-12) / qmax
                self.quant[(net, layer)] = (codes, scale, act, qmax)

    def _note(self, net, layer, x):
        if self.amax is not None:
            v = float(x.abs().amax())
            self.amax[(net, layer)] = max(self.amax.get((net, layer), 0.0), v)

    def _conv(self, net, layer, x):
        """NCHW VALID conv (+ bias)."""
        p = self.w[net][layer]
        q = self.quant.get((net, layer))
        if q is None:
            return F.conv2d(x, p["kernel"].permute(3, 2, 0, 1)) + p["bias"].view(1, -1, 1, 1)
        codes, scale, act, qmax = q
        xq = torch.round(x / act).clamp(-qmax, qmax)
        y = F.conv2d(xq.double(), codes.permute(3, 2, 0, 1).double()).float()
        return y * (act * scale).view(1, -1, 1, 1) + p["bias"].view(1, -1, 1, 1)

    def _dense(self, net, layer, x):
        p = self.w[net][layer]
        q = self.quant.get((net, layer))
        if q is None:
            return x @ p["kernel"] + p["bias"]
        codes, scale, act, qmax = q
        xq = torch.round(x / act).clamp(-qmax, qmax)
        return (xq.double() @ codes.double()).float() * (act * scale) + p["bias"]

    def _prelu(self, net, layer, x):
        a = self.w[net][layer]["alpha"]
        a = a.view(1, -1, 1, 1) if x.dim() == 4 else a.view(1, -1)
        return torch.where(x >= 0, x, a * x)

    @staticmethod
    def _pool(x, k, s):
        return F.max_pool2d(x, k, s, ceil_mode=True)

    def pnet(self, x):
        x = x.permute(0, 3, 1, 2)
        x = self._pool(self._prelu("pnet", "prelu1", self._conv("pnet", "conv1", x)), 2, 2)
        x = self._prelu("pnet", "prelu2", self._conv("pnet", "conv2", x))
        x = self._prelu("pnet", "prelu3", self._conv("pnet", "conv3", x))
        prob = torch.softmax(self._conv("pnet", "cls", x), dim=1)[:, 1]
        return prob, self._conv("pnet", "reg", x).permute(0, 2, 3, 1)

    def rnet(self, x):
        x = x.permute(0, 3, 1, 2)
        self._note("rnet", "conv1", x)
        x = self._prelu("rnet", "prelu1", self._conv("rnet", "conv1", x))
        self._note("rnet", "conv2", x)
        x = self._pool(x, 3, 2)
        x = self._prelu("rnet", "prelu2", self._conv("rnet", "conv2", x))
        self._note("rnet", "conv3", x)
        x = self._pool(x, 3, 2)
        x = self._prelu("rnet", "prelu3", self._conv("rnet", "conv3", x))
        self._note("rnet", "fc1", x)
        x = self._prelu("rnet", "prelu4", self._dense("rnet", "fc1", x.flatten(1)))
        prob = torch.softmax(self._dense("rnet", "cls", x), dim=1)[:, 1]
        return prob, self._dense("rnet", "reg", x)

    def onet(self, x):
        x = x.permute(0, 3, 1, 2)
        self._note("onet", "conv1", x)
        x = self._prelu("onet", "prelu1", self._conv("onet", "conv1", x))
        self._note("onet", "conv2", x)
        x = self._pool(x, 3, 2)
        x = self._prelu("onet", "prelu2", self._conv("onet", "conv2", x))
        self._note("onet", "conv3", x)
        x = self._pool(x, 3, 2)
        x = self._prelu("onet", "prelu3", self._conv("onet", "conv3", x))
        self._note("onet", "conv4", x)
        x = self._pool(x, 2, 2)
        x = self._prelu("onet", "prelu4", self._conv("onet", "conv4", x))
        self._note("onet", "fc1", x)
        x = self._prelu("onet", "prelu5", self._dense("onet", "fc1", x.flatten(1)))
        prob = torch.softmax(self._dense("onet", "cls", x), dim=1)[:, 1]
        lmk = self._dense("onet", "landmarks", x)
        return prob, self._dense("onet", "reg", x), torch.stack([lmk[:, :5], lmk[:, 5:]], -1)

    # ----------------------------------------------------------- cascade

    def detect(self, frame: np.ndarray) -> dict:
        """One frame [H, W, 3] uint8 -> {'bboxes' [F,4], 'scores' [F],
        'landmarks' [F,5,2], 'valid' [F]} as numpy, padded to max_faces."""
        img = (torch.from_numpy(np.asarray(frame)).to(self.device).float() - 127.5) / 128.0
        h, w = self.h, self.w_
        # stage 1
        boxes, scores = [], []
        src = img
        for s, (wy, wx) in zip(self.scales, self.mats):
            src = torch.einsum("xw,owc->oxc", wx, torch.einsum("oh,hwc->owc", wy, src))
            prob, reg = self.pnet(src[None])
            prob, reg = prob[0], reg[0]
            fh, fw = prob.shape
            k = min(P_PER_SCALE, fh * fw)
            p, i = top_k(prob.reshape(-1), k)
            r, c = torch.div(i, fw, rounding_mode="floor").float(), (i % fw).float()
            b = torch.stack([c * 2.0 / s, r * 2.0 / s, (c * 2.0 + 12.0) / s, (r * 2.0 + 12.0) / s], -1)
            b = apply_reg(b, reg.reshape(-1, 4)[i])
            pad = P_PER_SCALE - k
            boxes.append(torch.cat([b, b.new_zeros((pad, 4))]))
            scores.append(torch.cat([p, p.new_full((pad,), NEG)]))
        boxes, scores = torch.cat(boxes), torch.cat(scores)
        keep = greedy_nms(boxes, scores, scores > self.thr[0], 0.7)
        sc, idx = top_k(torch.where(keep, scores, torch.full_like(scores, NEG)), P_KEEP)
        boxes, valid = boxes[idx], sc > NEG / 2
        # stage 2: crops of the frame downsampled 2x
        sq = square(boxes).clamp(0, max(h, w))
        side = max(h, w) // 2
        small = crop_resize(img, torch.tensor([[0.0, 0.0, float(w), float(h)]], device=self.device), side)[0]
        f = torch.tensor([side / w, side / h, side / w, side / h], device=self.device)
        prob, reg = self.rnet(crop_resize(small, sq * f, 24))
        valid = valid & (prob > self.thr[1])
        boxes = apply_reg(sq, reg)
        keep = greedy_nms(boxes, prob, valid, 0.7)
        sc, idx = top_k(torch.where(keep, prob, torch.full_like(prob, NEG)), R_KEEP)
        boxes, valid = boxes[idx], sc > NEG / 2
        # stage 3
        sq = square(boxes).clamp(0, max(h, w))
        prob, reg, lmk = self.onet(crop_resize(img, sq, 48))
        valid = valid & (prob > self.thr[2])
        bw, bh = (sq[:, 2] - sq[:, 0])[:, None], (sq[:, 3] - sq[:, 1])[:, None]
        lm = torch.stack([sq[:, 0, None] + lmk[..., 0] * bw, sq[:, 1, None] + lmk[..., 1] * bh], -1)
        boxes = apply_reg(sq, reg)
        keep = greedy_nms(boxes, prob, valid, 0.7, mode="min")
        sc, idx = top_k(torch.where(keep, prob, torch.full_like(prob, NEG)), self.max_faces)
        ok = sc > NEG / 2
        lim = torch.tensor([w - 1, h - 1, w - 1, h - 1], dtype=torch.float32, device=self.device)
        bx = torch.minimum(boxes[idx].clamp_min(0), lim)
        return {
            "bboxes": bx.cpu().numpy(),
            "scores": torch.where(ok, sc, torch.zeros_like(sc)).cpu().numpy(),
            "landmarks": lm[idx].cpu().numpy(),
            "valid": ok.cpu().numpy(),
        }

    def calibrate(self, frames) -> dict:
        """max |input| of every R-net and O-net layer that `quantize`
        makes int8, over the float cascade on `frames`: conv1 sees every
        candidate crop, later layers the PReLU outputs before pooling."""
        self.amax = {}
        try:
            for fr in frames:
                self.detect(fr)
            return dict(self.amax)
        finally:
            self.amax = None
