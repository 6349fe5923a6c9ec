"""Post-training int8 quantization of the folded IR backbones and of the
detector's R-net and O-net.

Counterpart of `facerecognitionpipeline_tpu/models/quantize.py`, same scheme:

* weights: symmetric per-output-channel int8, scale[oc] = max|w[..., oc]| /
  127 (at least 1e-12), taken from the BN-folded float32 weights;
* activations: symmetric per-tensor int8 with a static calibrated scale,
  act_scale = max(amax * headroom, 1e-12) / 127, one float32 scalar per
  quantized layer's input, where amax is the max |x| seen on a calibration
  batch.

`quantize_folded_variables` and `quantize_detector_variables` are numpy
copies of the JAX package's functions and work on the same JAX-format
variable trees (nested dicts: HWIO conv kernels, [in, out] dense kernels),
so they give the same codes and scales byte for byte;
`models/convert.py` turns their output into the port's state dicts.
`calibrate_activation_amax` runs the port's folded float backbone; the
detector's calibration is `MTCNNDetector.calibrate_amax`.

`fuse_quantized_params` rewrites the quantized variables for the fused
int8 body (`irse.FusedQuantBody`, the embedder's `int8_fused`): numpy
float32 in the JAX package's order of operations, so its constants equal
the JAX package's bit for bit.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

_QMAX = 127.0


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _quantize_leaf(sub: dict, amax: float, headroom: float, axes) -> dict:
    w = np.asarray(sub["kernel"], np.float32)
    w_scale = np.maximum(np.max(np.abs(w), axis=axes) / _QMAX, 1e-12)
    kq = np.clip(np.round(w / w_scale), -_QMAX, _QMAX).astype(np.int8)
    a = amax * headroom
    return {
        "kernel_q": kq,
        "scale": w_scale.astype(np.float32),
        "bias": np.asarray(sub["bias"], np.float32),
        "act_scale": np.float32(max(a, 1e-12) / _QMAX),
    }


def calibrate_activation_amax(model: torch.nn.Module, faces_pm1: torch.Tensor
                              ) -> Dict[str, Dict[str, float]]:
    """Max |activation| at the input of every unit's two res convs, over a
    calibration batch.

    model: a FOLDED (not quantized) `irse.IRBackbone`, on its device and in
    its compute dtype; faces_pm1: [N, 112, 112, 3] preprocessed faces (BGR,
    [-1, 1]; `ops/image.preprocess_faces`). Returns {unit: {'res_conv1':
    amax of the res_affine output, 'res_conv2': amax of the res_prelu
    output}}. The maxima stay on the device until one transfer at the end.
    """
    if getattr(model, "quantized", False) or not getattr(model, "folded", False):
        raise ValueError("calibrate_activation_amax needs the folded float backbone")
    keys, found, hooks = [], [], []

    def capture(unit, conv):
        def hook(_module, _inputs, out):
            keys.append((unit, conv))
            found.append(out.float().abs().amax())
        return hook

    try:
        for unit in model.unit_names:
            blk = getattr(model, unit)
            hooks.append(blk.res_affine.register_forward_hook(capture(unit, "res_conv1")))
            hooks.append(blk.res_prelu.register_forward_hook(capture(unit, "res_conv2")))
        with torch.inference_mode():
            model(faces_pm1)
    finally:
        for h in hooks:
            h.remove()
    out: Dict[str, Dict[str, float]] = {}
    for (unit, conv), v in zip(keys, torch.stack(found).cpu().tolist()):
        out.setdefault(unit, {})[conv] = float(v)
    return out


def quantize_folded_variables(
    folded_variables: dict,
    activation_amax: Dict[str, Dict[str, float]],
    headroom: float = 1.0,
) -> dict:
    """Folded backbone variables {'params': ...} -> the quantized form for
    `build_backbone(arch, folded=True, quantized=True)`: each unit's
    res_conv1/res_conv2 become {kernel_q int8, scale f32[oc], bias f32,
    act_scale f32 scalar}; everything else copies through. headroom
    multiplies the calibrated amax."""
    params = folded_variables["params"]
    out: dict = {}
    for name, p in params.items():
        if not name.startswith("stage"):
            out[name] = _np_tree(p)
            continue
        if name not in activation_amax:
            raise ValueError(
                f"no calibrated activation amax for block {name!r} — "
                f"calibrate_activation_amax must run on the same architecture"
            )
        blk = {}
        for key, sub in p.items():
            if key in ("res_conv1", "res_conv2"):
                blk[key] = _quantize_leaf(sub, activation_amax[name][key], headroom,
                                          axes=(0, 1, 2))
            else:
                blk[key] = _np_tree(sub)
        out[name] = blk
    return {"params": out}


def fuse_quantized_params(quantized_variables: dict) -> dict:
    """`quantize_folded_variables` output -> the variables of the fused
    int8 body (`build_backbone(arch, folded=True, quantized=True,
    fused_int8=True)`). Per unit, {res_affine, res_conv1, res_prelu,
    res_conv2} collapse into one 'body':

      qscale    = affine.scale / s1          qshift   = affine.shift / s1
      mid_scale = (s1 * w1_scale) / s2       mid_bias = b1 / s2
      out_scale = s2 * w2_scale              out_bias = b2
      (s_i = res_conv_i.act_scale; alpha passes through: PReLU commutes
      with the positive 1/s2.)

    Shortcut convs, SE and the layers outside the units copy through."""
    params = quantized_variables["params"]
    out: dict = {}
    for name, p in params.items():
        if not name.startswith("stage"):
            out[name] = _np_tree(p)
            continue
        c1, c2 = p["res_conv1"], p["res_conv2"]
        s1 = np.float32(c1["act_scale"])
        s2 = np.float32(c2["act_scale"])
        blk = {
            "body": {
                "qscale": np.asarray(p["res_affine"]["scale"], np.float32) / s1,
                "qshift": np.asarray(p["res_affine"]["shift"], np.float32) / s1,
                "kernel1_q": np.asarray(c1["kernel_q"], np.int8),
                "mid_scale": (s1 * np.asarray(c1["scale"], np.float32)) / s2,
                "mid_bias": np.asarray(c1["bias"], np.float32) / s2,
                "alpha": np.asarray(p["res_prelu"]["alpha"], np.float32),
                "kernel2_q": np.asarray(c2["kernel_q"], np.int8),
                "out_scale": s2 * np.asarray(c2["scale"], np.float32),
                "out_bias": np.asarray(c2["bias"], np.float32),
            }
        }
        for key, sub in p.items():
            if key not in ("res_affine", "res_conv1", "res_prelu", "res_conv2"):
                blk[key] = _np_tree(sub)
        out[name] = blk
    return {"params": out}


def quantize_detector_variables(
    variables: dict,
    activation_amax: Dict[str, Dict[str, float]],
    headroom: float = 1.0,
) -> dict:
    """Float detector variables {'pnet'|'rnet'|'onet': {'params': ...}} ->
    quantized R-net and O-net: every layer named in activation_amax
    ({'rnet': {'conv1': a, ..., 'fc1': a}, 'onet': {...}}, from
    `MTCNNDetector.calibrate_amax`) becomes {kernel_q, scale, bias,
    act_scale}; P-net, the PReLUs and the heads copy through. Weight scales
    reduce over every axis but the last (HWIO and [in, out] alike)."""
    out = {"pnet": _np_tree(variables["pnet"])}
    for net in ("rnet", "onet"):
        amax = activation_amax[net]
        q: dict = {}
        for key, sub in variables[net]["params"].items():
            if key not in amax:
                q[key] = _np_tree(sub)
                continue
            w = np.asarray(sub["kernel"])
            q[key] = _quantize_leaf(sub, amax[key], headroom, axes=tuple(range(w.ndim - 1)))
        out[net] = {"params": q}
    return out


def default_calibration_frames(
    det_size: tuple[int, int] = (640, 640), n: int = 6, seed: int = 0
) -> np.ndarray:
    """Synthetic full-frame calibration scenes for the detector: a spread of
    stress categories (multi-face, crowded, tiny, noisy, low-contrast,
    face-like hard negatives) rendered square and resized to det_size. Raw
    RGB uint8 [n, H, W, 3]. For imported real-world detector weights,
    calibrate on real frames instead (MTCNNDetector(calib_frames=...))."""
    import cv2

    from facerecognitionpipeline_tpu_torch.evalharness.detection import (
        render_stress_scene,
    )

    cats = ["baseline", "crowded", "tiny", "noisy", "low_contrast",
            "hard_negatives"]
    rng = np.random.default_rng(seed)
    h, w = det_size
    frames = []
    for i in range(n):
        img, _ = render_stress_scene(rng, cats[i % len(cats)], size=min(h, w))
        if img.shape[:2] != (h, w):
            img = cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)
        frames.append(img.astype(np.uint8))
    return np.stack(frames)


def load_calibration_faces(
    directory: str, size: int = 112, limit: int = 256
) -> np.ndarray:
    """Aligned face crops from a directory (recursively; jpg/png/bmp),
    resized to size x size RGB uint8, at most `limit`: how a deployment
    serving imported real-world weights calibrates on real faces (the
    server's `--quantize_calib DIR`). ValueError if none is readable."""
    import cv2

    from facerecognitionpipeline_tpu_torch.utils.io import VALID_EXTENSIONS, imread_rgb

    crops = []
    for root, _, files in sorted(os.walk(directory)):
        for fname in sorted(files):
            if os.path.splitext(fname)[1].lower() not in VALID_EXTENSIONS:
                continue
            img = imread_rgb(os.path.join(root, fname))
            if img is None:
                continue
            if img.shape[:2] != (size, size):
                img = cv2.resize(img, (size, size), interpolation=cv2.INTER_LINEAR)
            crops.append(img.astype(np.uint8))
            if len(crops) >= limit:
                break
        if len(crops) >= limit:
            break
    if not crops:
        raise ValueError(
            f"no readable calibration images under {directory!r} "
            f"(extensions {sorted(VALID_EXTENSIONS)})"
        )
    return np.stack(crops)


def default_calibration_faces(
    n: int = 64, seed: int = 0, size: int = 112
) -> np.ndarray:
    """Deterministic synthetic calibration crops: rendered identity faces
    with pose and lighting jitter, plus a few uniform-noise crops so the
    scales cover textureless extremes. Raw RGB uint8 [n, size, size, 3];
    callers preprocess with `ops/image.preprocess_faces`. For imported
    real-world weights, calibrate on real aligned faces instead
    (FaceEmbedder(quantize='int8', calib_faces=...))."""
    from facerecognitionpipeline_tpu_torch.train.detector_train import (
        make_identity,
        render_identity_crop,
    )

    rng = np.random.default_rng(seed)
    n_noise = max(2, n // 16)
    crops = []
    for i in range(n - n_noise):
        ident = make_identity(seed * 1000 + i % 16)
        crops.append(render_identity_crop(ident, rng, size=size))
    for _ in range(n_noise):
        crops.append(
            rng.integers(0, 256, size=(size, size, 3), dtype=np.uint8)
        )
    return np.stack(crops)
