"""Fixed-shape MTCNN cascade detector (P/R/O-net + masked NMS).

Counterpart of `facerecognitionpipeline_tpu/models/detector.py` (float
nets). Every stage works on padded candidate sets with validity masks, and
the whole batch of frames runs each stage together (where the JAX package
vmaps one frame's cascade):

  pyramid (static scales, static-weight matmul resizes) -> P-net ->
  128 proposals/scale -> NMS -> 256 -> R-net on 24 px crops (from the
  frame pre-downsampled 2x) -> NMS -> 96 -> O-net on 48 px crops ->
  NMS(min) -> max_faces.

The R-net and O-net crops are kernel K1 (`ops/crop_kernel.py`) when
`crop_impl='kernel'`. `pack_pyramid=True` runs P-net once over every
pyramid level shelf-packed into one canvas (`_pack_pyramid`), as the JAX
package's option of that name does. `quantize='int8'` makes R-net and O-net static-scale
int8 nets (`models/quantize.py`), calibrated on `calib_frames`.
"""

from __future__ import annotations

import math
import os
import sys
from typing import List, Optional

import numpy as np
import torch

from facerecognitionpipeline_tpu_torch.models.convert import (
    detector_state_from_jax,
    detector_variables_from_state,
)
from facerecognitionpipeline_tpu_torch.models.detector_nets import (
    DetectorNets,
    load_mtcnn_torch_statedict,
)
from facerecognitionpipeline_tpu_torch.models.layers import lecun_normal_
from facerecognitionpipeline_tpu_torch.ops.crop_kernel import (
    crop_resize_kernel,
    crop_resize_plain,
)
from facerecognitionpipeline_tpu_torch.ops.nms import nms_mask, top_k, topk_boxes
from facerecognitionpipeline_tpu_torch.ops.numerics import device_constant, div, round_to
from facerecognitionpipeline_tpu_torch.utils.device import resolve_device
from facerecognitionpipeline_tpu_torch.utils.io import (
    load_npz_variables,
    save_npz_variables,
)

_NEG = -1e9

P_PER_SCALE = 128
P_KEEP = 256
R_KEEP = 96

_PRETRAINED_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "pretrained",
)
DEFAULT_DETECTOR_WEIGHTS = (
    os.path.join(_PRETRAINED_DIR, "mtcnn_dr.npz"),
    os.path.join(_PRETRAINED_DIR, "mtcnn_stress.npz"),
    os.path.join(_PRETRAINED_DIR, "mtcnn_synthetic.npz"),
)


def discover_default_weights() -> Optional[str]:
    """First existing default detector weights file, or None."""
    for path in DEFAULT_DETECTOR_WEIGHTS:
        if os.path.isfile(path):
            return path
    return None


def _resize_matrix(src: int, dst: int) -> np.ndarray:
    """[dst, src] antialiased-linear resize weights (jax.image.resize
    'linear' with antialias): output o reads (o+0.5)*src/dst - 0.5; on
    downscale the hat stretches by src/dst and rows renormalize."""
    scale = dst / src
    pos = (np.arange(dst, dtype=np.float64) + 0.5) / scale - 0.5
    d = np.abs(pos[:, None] - np.arange(src, dtype=np.float64)[None, :])
    w = np.maximum(0.0, 1.0 - (d * scale if scale < 1.0 else d))
    return (w / w.sum(axis=1, keepdims=True)).astype(np.float32)


def _pnet_out_dim(s: int) -> int:
    """P-net output extent for an even input extent s (VALID 3x3 conv ->
    2x2/2 pool, exact for even s -> two VALID 3x3 convs)."""
    assert s % 2 == 0
    return (s - 4) // 2 - 3


def _pack_pyramid(h: int, w: int, scales: list[float], gap: int = 4):
    """Static shelf-packing of the image pyramid into ONE canvas.

    Every region gets EVEN dims at an EVEN origin, so P-net over the canvas
    gives the per-scale P-net outputs inside each region's submap: its
    convs are VALID (a submap cell never sees past its region) and the
    2x2/2 pool needs no ceil padding for even extents at even origins.

    Returns (canvas_h, canvas_w, regions), regions a list of (sh, sw, oy,
    ox) in scale order."""

    def even(x: float) -> int:
        n = int(math.ceil(x))
        return n + (n % 2)

    dims = [(even(h * s), even(w * s)) for s in scales]
    shelf_w = dims[0][1] + gap + (dims[1][1] if len(dims) > 1 else 0) + gap + (
        dims[2][1] if len(dims) > 2 else 0
    )
    regions: list[tuple[int, int, int, int]] = []
    oy = ox = shelf_h = 0
    canvas_w = 0
    for sh, sw in dims:
        if ox + sw > shelf_w and ox > 0:
            oy += shelf_h + gap
            oy += oy % 2
            ox = 0
            shelf_h = 0
        regions.append((sh, sw, oy, ox))
        canvas_w = max(canvas_w, ox + sw)
        ox += sw + gap
        ox += ox % 2
        shelf_h = max(shelf_h, sh)
    canvas_h = oy + shelf_h
    return canvas_h + canvas_h % 2, canvas_w + canvas_w % 2, regions


def _square(boxes: torch.Tensor) -> torch.Tensor:
    """Expand boxes [..., 4] to squares around their centres ('rerec')."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    side = torch.maximum(x2 - x1, y2 - y1)
    cx = (x1 + x2) * 0.5
    cy = (y1 + y2) * 0.5
    half = side * 0.5
    return torch.stack([cx - half, cy - half, cx + half, cy + half], dim=-1)


def _apply_reg(boxes: torch.Tensor, reg: torch.Tensor) -> torch.Tensor:
    """Bounding-box regression: offsets scaled by box size."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    return boxes + reg * torch.stack([w, h, w, h], dim=-1)


class MTCNNDetector:
    """Three-stage cascaded detector with fixed shapes end to end."""

    def __init__(
        self,
        det_size: tuple[int, int] = (640, 640),
        det_thresh: float = 0.5,
        stage_thresholds: tuple[float, float, float] | None = None,
        min_face_size: int = 20,
        scale_factor: float = 0.709,
        max_faces: int = 32,
        variables: Optional[dict] = None,
        weights_path: Optional[str] = None,
        dtype: torch.dtype = torch.float32,
        rnet_crop_downscale: int = 2,
        stage1_keep: int = P_KEEP,
        stage2_keep: int = R_KEEP,
        pack_pyramid: bool = False,
        crop_impl: str = "auto",
        quantize: Optional[str] = None,
        calib_frames: Optional[np.ndarray] = None,
        device="cuda",
        init_seed: int = 0,
    ):
        """variables: JAX-format detector variables (nested dicts of arrays);
        weights_path: a JAX-format `.npz`, a torch file of MTCNN state dicts
        ({'pnet'|'rnet'|'onet': state dict}, loaded with weights_only=True),
        or "random" for a seeded random init (`init_seed`); neither = the
        first of DEFAULT_DETECTOR_WEIGHTS.

        pack_pyramid: P-net once over the shelf-packed pyramid canvas
        instead of once per scale. Each region's map equals that scale's
        own, but the scaled sizes round up to even and boxes map back by
        the true per-axis factors, so proposals can move sub-pixel against
        the per-scale path. Off by default, as in the JAX package.

        crop_impl: 'kernel' (K1, the counterpart of the JAX 'pallas';
        bf16 by design), 'matmul' (plain dense resample in `dtype`) or
        'auto': 'kernel' on CUDA for a bf16 cascade, else 'matmul'.
        On CPU tensors 'kernel' runs K1's plain version.

        quantize: None or 'int8'. 'int8' quantizes R-net's conv1-3 and fc1
        and O-net's conv1-4 and fc1 (per-output-channel int8 weights from
        the float32 variables, static activation scales calibrated on
        `calib_frames`, raw RGB uint8 [N, H, W, 3] at det_size; default
        `models/quantize.default_calibration_frames`). Variables that are
        already quantized load as they are, without calibration; a float
        detector refuses them. P-net stays float."""
        if quantize not in (None, "int8"):
            raise ValueError(f"Unknown quantize mode: {quantize!r} (use 'int8')")
        self.device = resolve_device(device)
        self.det_size = tuple(det_size)
        self.max_faces = max_faces
        self.thresholds = stage_thresholds or (0.6, 0.7, det_thresh)
        self.rnet_crop_downscale = int(rnet_crop_downscale)
        self.stage1_keep = int(stage1_keep)
        self.stage2_keep = int(stage2_keep)
        if not (self.max_faces <= self.stage2_keep <= self.stage1_keep):
            raise ValueError(
                f"candidate budgets must narrow through the cascade: "
                f"max_faces={self.max_faces} <= stage2_keep="
                f"{self.stage2_keep} <= stage1_keep={self.stage1_keep}"
            )
        self.dtype = dtype
        if crop_impl == "auto":
            crop_impl = (
                "kernel"
                if self.device.type == "cuda" and dtype == torch.bfloat16
                else "matmul"
            )
        if crop_impl not in ("kernel", "matmul"):
            raise ValueError(f"unknown crop_impl {crop_impl!r}")
        if crop_impl == "kernel" and dtype != torch.bfloat16:
            raise ValueError(
                "crop_impl='kernel' computes crops in bfloat16; use "
                "dtype=torch.bfloat16 or crop_impl='matmul'"
            )
        self.crop_impl = crop_impl

        if variables is None and weights_path is None:
            weights_path = discover_default_weights()
        if variables is None and weights_path not in (None, "random"):
            variables = self._load_weights(weights_path)
        loaded_int8 = self._variables_quantized(variables)
        if loaded_int8 and quantize != "int8":
            raise ValueError(
                "loaded detector variables are int8-quantized; construct "
                "with quantize='int8' (the float R/O-nets cannot consume "
                "kernel_q params)"
            )
        nets = DetectorNets(quantized=loaded_int8)
        if variables is not None:
            nets.load_state_dict(detector_state_from_jax(variables))
            self.pretrained = True
        else:
            if weights_path != "random":
                print(
                    "[MTCNNDetector] No weights found; using random init "
                    "(detections will be meaningless).",
                    file=sys.stderr,
                )
            lecun_normal_(nets, torch.Generator().manual_seed(init_seed))
            self.pretrained = False
        # the JAX-format variables of the nets, float32 (the module is cast
        # to the cascade dtype below); quantize and save_npz read these
        self._variables = (
            variables if variables is not None
            else detector_variables_from_state(nets.state_dict())
        )
        self.nets = nets.to(device=self.device, dtype=dtype).eval()
        self.quantized = loaded_int8

        h, w = self.det_size
        m = 12.0 / min_face_size
        self.scales: list[float] = []
        s = m
        while min(h, w) * s >= 12.0:
            self.scales.append(s)
            s *= scale_factor
        if not self.scales:
            raise ValueError(
                f"min_face_size={min_face_size} leaves no pyramid scale "
                f"for det_size={det_size} (need min_face_size <= "
                f"{min(h, w)}); lower min_face_size or raise det_size"
            )
        # static resize weights of the progressive pyramid, rounded to the
        # cascade dtype once
        self.pack_pyramid = bool(pack_pyramid)
        if self.pack_pyramid:
            self._canvas_hw = _pack_pyramid(h, w, self.scales)
            dims = [(sh, sw) for sh, sw, _, _ in self._canvas_hw[2]]
        else:
            dims = [(int(math.ceil(h * sc)), int(math.ceil(w * sc))) for sc in self.scales]
        self._pyramid_mats = []
        ph, pw = h, w
        for sh, sw in dims:
            wy = torch.from_numpy(_resize_matrix(ph, sh)).to(self.device)
            wx = torch.from_numpy(_resize_matrix(pw, sw)).to(self.device)
            self._pyramid_mats.append((round_to(wy, dtype), round_to(wx, dtype)))
            ph, pw = sh, sw

        if quantize == "int8" and not loaded_int8:
            from facerecognitionpipeline_tpu_torch.models.quantize import (
                default_calibration_frames,
                quantize_detector_variables,
            )

            if calib_frames is None:
                calib_frames = default_calibration_frames(det_size=self.det_size)
            amax = self.calibrate_amax(calib_frames)
            self._variables = quantize_detector_variables(self._variables, amax)
            qnets = DetectorNets(quantized=True)
            qnets.load_state_dict(detector_state_from_jax(self._variables))
            self.nets = qnets.to(device=self.device, dtype=dtype).eval()
            self.quantized = True

    @property
    def variables(self) -> dict:
        """The JAX-format variables the nets hold (float32, or int8 with
        their scales when quantized); `save_npz` writes them."""
        return self._variables

    @variables.setter
    def variables(self, variables: dict) -> None:
        """Load a new JAX-format tree into the nets, as assigning
        `variables` in the JAX package changes what its detect computes.
        The tensors are copied into the nets' own (`load_state_dict`), so a
        CUDA graph captured over the cascade replays with the new weights.
        A float detector takes float trees and an int8 one int8 trees: the
        JAX package's nets cannot apply the other kind either."""
        if self._variables_quantized(variables) != self.quantized:
            kinds = ("float", "int8-quantized")
            raise ValueError(
                f"this detector's R/O-nets are {kinds[self.quantized]} and the "
                f"variables are {kinds[not self.quantized]}; construct "
                f"MTCNNDetector(variables=..., quantize="
                f"{'None' if self.quantized else repr('int8')}) for them"
            )
        self.nets.load_state_dict(detector_state_from_jax(variables))
        self._variables = variables

    # ------------------------------------------------------------- cascade

    def _pyramid(self, img: torch.Tensor) -> list[torch.Tensor]:
        """img [B,H,W,3] float32 -> levels [B,h_s,w_s,3] (float32 tensors
        holding `dtype` values). Each level resamples the previous one with
        two static-weight matmuls, rounded to the cascade dtype after each,
        as the JAX package's bf16 einsums do."""
        dt = self.dtype
        src = round_to(img, dt)
        levels = []
        for wy, wx in self._pyramid_mats:
            rows = round_to(torch.einsum("oh,bhwc->bowc", wy, src), dt)
            src = round_to(torch.einsum("xw,bowc->boxc", wx, rows), dt)
            levels.append(src)
        return levels

    def _pnet_proposals(self, prob, reg, sx, sy):
        """One scale's P-net maps prob [B,fh,fw], reg [B,fh,fw,4] ->
        P_PER_SCALE padded proposals (boxes [B,P,4], scores [B,P]); sx, sy
        map map cells back to the frame (the scale, or a packed region's
        true per-axis factors)."""
        b, fh, fw = prob.shape
        k = min(P_PER_SCALE, fh * fw)
        top_p, top_i = top_k(prob.reshape(b, -1), k)
        rows = torch.div(top_i, fw, rounding_mode="floor").float()
        cols = (top_i % fw).float()
        x1 = div(cols * 2.0, sx)
        y1 = div(rows * 2.0, sy)
        x2 = div(cols * 2.0 + 12.0, sx)
        y2 = div(rows * 2.0 + 12.0, sy)
        boxes = torch.stack([x1, y1, x2, y2], dim=-1)
        r = torch.gather(reg.reshape(b, -1, 4), 1, top_i[..., None].expand(b, k, 4))
        boxes = _apply_reg(boxes, r)
        pad = P_PER_SCALE - k
        if pad:
            boxes = torch.cat([boxes, boxes.new_zeros((b, pad, 4))], dim=1)
            top_p = torch.cat([top_p, top_p.new_full((b, pad), _NEG)], dim=1)
        return boxes, top_p

    def _stage1(self, img):
        if self.pack_pyramid:
            return self._stage1_packed(img)
        all_boxes, all_scores = [], []
        for scale, level in zip(self.scales, self._pyramid(img)):
            prob, reg = self.nets.pnet(level)
            boxes, scores = self._pnet_proposals(prob, reg, scale, scale)
            all_boxes.append(boxes)
            all_scores.append(scores)
        return self._stage1_finish(all_boxes, all_scores)

    def _stage1_packed(self, img):
        """P-net ONCE over the shelf-packed pyramid canvas: each scale's
        maps are a static slice of the canvas maps."""
        b, h, w, _ = img.shape
        ch, cw, regions = self._canvas_hw
        canvas = img.new_zeros((b, ch, cw, img.shape[-1]))
        for (sh, sw, oy, ox), level in zip(regions, self._pyramid(img)):
            canvas[:, oy:oy + sh, ox:ox + sw] = level
        prob, reg = self.nets.pnet(canvas)
        all_boxes, all_scores = [], []
        for sh, sw, oy, ox in regions:
            fh, fw = _pnet_out_dim(sh), _pnet_out_dim(sw)
            a, c = oy // 2, ox // 2
            boxes, scores = self._pnet_proposals(
                prob[:, a:a + fh, c:c + fw].contiguous(),
                reg[:, a:a + fh, c:c + fw].contiguous(),
                sw / float(w), sh / float(h),
            )
            all_boxes.append(boxes)
            all_scores.append(scores)
        return self._stage1_finish(all_boxes, all_scores)

    def _stage1_finish(self, all_boxes, all_scores):
        """Concatenated per-scale proposals -> cross-scale NMS -> the
        stage-1 top-k."""
        boxes = torch.cat(all_boxes, dim=1)
        scores = torch.cat(all_scores, dim=1)
        valid = scores > self.thresholds[0]
        keep = nms_mask(boxes, scores, valid, iou_threshold=0.7)
        masked = torch.where(keep, scores, torch.full_like(scores, _NEG))
        return topk_boxes(boxes, masked, keep, self.stage1_keep)

    def _crop(self, img, boxes, out_size):
        if self.crop_impl == "kernel":
            return crop_resize_kernel(img, boxes, out_size)
        return crop_resize_plain(img, boxes, out_size, self.dtype)

    def _stage2_crops(self, img, boxes):
        """Squared candidate boxes -> (sq [B,N,4], 24 px R-net crops
        [B,N,24,24,C])."""
        b, h, w, _ = img.shape
        sq = _square(boxes).clamp(0, max(h, w))
        d = self.rnet_crop_downscale
        if d > 1:
            # One shared downsample of each frame, then every candidate
            # crops from the small frame. Boxes scale by the true per-axis
            # factors, so sample positions are those of full resolution.
            s = max(h, w) // d
            full = device_constant((0.0, 0.0, float(w), float(h)), img.device).expand(b, 1, 4)
            small = crop_resize_plain(img, full, s, self.dtype)[:, 0]
            sx, sy = s / float(w), s / float(h)
            return sq, self._crop(small, sq * device_constant((sx, sy, sx, sy), img.device), 24)
        return sq, self._crop(img, sq, 24)

    def _stage2(self, img, boxes, valid):
        b = img.shape[0]
        sq, crops = self._stage2_crops(img, boxes)
        n = sq.shape[1]
        prob, reg = self.nets.rnet(crops.reshape(b * n, 24, 24, -1))
        prob, reg = prob.reshape(b, n), reg.reshape(b, n, 4)
        valid = valid & (prob > self.thresholds[1])
        boxes = _apply_reg(sq, reg)
        keep = nms_mask(boxes, prob, valid, iou_threshold=0.7)
        masked = torch.where(keep, prob, torch.full_like(prob, _NEG))
        return topk_boxes(boxes, masked, keep, self.stage2_keep)

    def _stage3_crops(self, img, boxes):
        """Squared candidate boxes -> (sq [B,N,4], 48 px O-net crops
        [B,N,48,48,C])."""
        h, w = img.shape[1:3]
        sq = _square(boxes).clamp(0, max(h, w))
        return sq, self._crop(img, sq, 48)

    def _stage3(self, img, boxes, valid):
        b = img.shape[0]
        sq, crops = self._stage3_crops(img, boxes)
        n = sq.shape[1]
        prob, reg, lmk = self.nets.onet(crops.reshape(b * n, 48, 48, -1))
        prob = prob.reshape(b, n)
        reg = reg.reshape(b, n, 4)
        lmk = lmk.reshape(b, n, 5, 2)
        valid = valid & (prob > self.thresholds[2])
        bw = (sq[..., 2] - sq[..., 0])[..., None]
        bh = (sq[..., 3] - sq[..., 1])[..., None]
        landmarks = torch.stack(
            [sq[..., 0, None] + lmk[..., 0] * bw, sq[..., 1, None] + lmk[..., 1] * bh],
            dim=-1,
        )  # [B,N,5,2]
        boxes = _apply_reg(sq, reg)
        keep = nms_mask(boxes, prob, valid, iou_threshold=0.7, mode="min")
        masked = torch.where(keep, prob, torch.full_like(prob, _NEG))
        top_scores, top_i = top_k(masked, self.max_faces)
        f = self.max_faces
        return (
            torch.gather(boxes, 1, top_i[..., None].expand(b, f, 4)),
            top_scores,
            torch.gather(landmarks, 1, top_i[..., None, None].expand(b, f, 5, 2)),
            top_scores > _NEG / 2,
        )

    @staticmethod
    def _load_weights(path: str) -> dict:
        if path.endswith(".npz"):
            return load_npz_variables(path)
        blob = torch.load(path, map_location="cpu", weights_only=True)
        return load_mtcnn_torch_statedict(blob)

    def save_npz(self, path: str) -> None:
        """Write the detector's JAX-format variables (float32, or int8 with
        their scales when quantized) as an `.npz` that either package loads
        without recalibration."""
        save_npz_variables(path, self.variables)

    # --------------------------------------------------------- calibration

    @staticmethod
    def _variables_quantized(variables: Optional[dict]) -> bool:
        """Whether JAX-format detector variables carry int8 R-net kernels."""
        try:
            return "kernel_q" in variables["rnet"]["params"]["conv1"]
        except (KeyError, TypeError):
            return False

    def calibrate_amax(self, frames) -> dict:
        """max |input| of every R-net and O-net conv/fc over calibration
        frames (raw RGB uint8 [N, H, W, 3] at det_size), for the int8
        activation scales. Runs the float cascade: conv1 sees the crops of
        every candidate slot, valid or not; conv2.. and fc1 see the PReLU
        outputs before pooling (the pools have stride <= window, so this
        over-estimates only through damped negatives). The max over all
        frames, as the JAX package's."""
        if self.quantized:
            raise RuntimeError(
                "calibrate_amax needs the float cascade; this detector is "
                "already quantized"
            )
        # layer -> the module whose output it reads (the net itself: its
        # input, the crops, which already hold values of the cascade dtype)
        feeds = {
            "rnet": {"conv1": None, "conv2": "prelu1", "conv3": "prelu2",
                     "fc1": "prelu3"},
            "onet": {"conv1": None, "conv2": "prelu1", "conv3": "prelu2",
                     "conv4": "prelu3", "fc1": "prelu4"},
        }
        keys, found, hooks = [], [], []

        def capture(key, of_input):
            def hook(_module, inputs, out=None):
                keys.append(key)
                found.append((inputs[0] if of_input else out).float().abs().amax())
            return hook

        try:
            for net, layers in feeds.items():
                for layer, prelu in layers.items():
                    if prelu is None:
                        module = getattr(self.nets, net)
                        hooks.append(module.register_forward_pre_hook(
                            capture((net, layer), True)))
                    else:
                        module = getattr(getattr(self.nets, net), prelu)
                        hooks.append(module.register_forward_hook(
                            capture((net, layer), False)))
            self.detect_device(torch.as_tensor(np.asarray(frames)).to(self.device))
        finally:
            for h in hooks:
                h.remove()
        out: dict = {"rnet": {}, "onet": {}}
        for (net, layer), v in zip(keys, torch.stack(found).cpu().tolist()):
            out[net][layer] = float(v)
        return out

    def detect_device(self, frames: torch.Tensor) -> dict:
        """frames [B,H,W,3] raw RGB (uint8 or float, at det_size, on the
        detector's device) -> padded detections: bboxes [B,F,4], scores
        [B,F], landmarks [B,F,5,2], valid [B,F]."""
        with torch.inference_mode():
            img = (frames.float() - 127.5) / 128.0
            boxes, _, valid = self._stage1(img)
            boxes, _, valid = self._stage2(img, boxes, valid)
            boxes, scores, landmarks, valid = self._stage3(img, boxes, valid)
            h, w = frames.shape[1:3]
            lim = device_constant((w - 1, h - 1, w - 1, h - 1), img.device, img.dtype)
            boxes = torch.minimum(boxes.clamp_min(0), lim)
            return {
                "bboxes": boxes,
                "scores": torch.where(valid, scores, torch.zeros_like(scores)),
                "landmarks": landmarks,
                "valid": valid,
            }

    def detect(self, image: np.ndarray) -> List[dict]:
        """One RGB image (any size, numpy) -> list of face dicts, the
        reference `FaceDetector.detect` schema, best score first.

        The image is letterboxed to det_size on the host with cv2 (as the
        JAX package does), one frame runs through `detect_device`, and the
        boxes and landmarks are mapped back to the original image, the
        boxes clipped to it (a box regressed into the letterbox padding
        would otherwise map past the image) and cast to int32."""
        import cv2

        ih, iw = image.shape[:2]
        dh, dw = self.det_size
        scale = min(dw / iw, dh / ih)
        nw, nh = int(round(iw * scale)), int(round(ih * scale))
        resized = cv2.resize(image.astype(np.float32), (nw, nh))
        canvas = np.zeros((dh, dw, 3), dtype=np.float32)
        canvas[:nh, :nw] = resized.reshape(nh, nw, -1)
        det = self.detect_device(torch.from_numpy(canvas)[None].to(self.device))
        out = {k: v[0].float().cpu().numpy() if k != "valid" else v[0].cpu().numpy()
               for k, v in det.items()}
        results = []
        for i in range(self.max_faces):
            if not out["valid"][i]:
                continue
            bbox = np.clip(
                out["bboxes"][i] / scale, 0, [iw - 1, ih - 1, iw - 1, ih - 1]
            )
            results.append({
                "bbox": bbox.astype(np.int32),
                "landmarks": (out["landmarks"][i] / scale).astype(np.float32),
                "det_score": float(out["scores"][i]),
                "pose": None,
                "age": None,
                "gender": None,
            })
        results.sort(key=lambda r: -r["det_score"])
        return results
