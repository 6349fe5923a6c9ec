"""Fold inference-mode BatchNorm into the IR backbone's conv/fc weights.

A numpy copy of `facerecognitionpipeline_tpu/models/fold.py`, operating on
the same JAX-format variable trees (nested dicts of arrays), so the port
folds exactly what the JAX package folds:

* post-conv BNs (`input_bn`, `res_bn2`, `res_bn3`, `shortcut_bn`):
  kernel' = kernel * g over the output channels, bias' = b;
* the pre-conv `res_bn1` stays a bare `Affine` (the conv zero-pads its
  input, so its shift cannot become a bias);
* `output_bn -> flatten -> fc -> output_feature_bn` collapses into the fc.

Use `models/convert.backbone_state_from_jax(..., folded=True)` on the result.
"""

from __future__ import annotations

import numpy as np

_EPS = 1e-5


def _f64(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float64)


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    return np.array(tree)


def _bn_affine(bn_params: dict, bn_stats: dict) -> tuple[np.ndarray, np.ndarray]:
    g = _f64(bn_params["scale"]) / np.sqrt(_f64(bn_stats["var"]) + _EPS)
    b = _f64(bn_params["bias"]) - _f64(bn_stats["mean"]) * g
    return g, b


def _fold_conv(conv_params: dict, bn_params: dict, bn_stats: dict) -> dict:
    g, b = _bn_affine(bn_params, bn_stats)
    kernel = _f64(conv_params["kernel"]) * g  # HWIO * [out]
    return {"kernel": kernel.astype(np.float32), "bias": b.astype(np.float32)}


def fold_inference_variables(variables: dict, input_size: int = 112) -> dict:
    """{'params', 'batch_stats'} of the standard backbone -> {'params'} of
    the folded one."""
    params = variables["params"]
    stats = variables["batch_stats"]
    out: dict = {
        "input_conv": _fold_conv(
            params["input_conv"], params["input_bn"], stats["input_bn"]
        ),
        "input_prelu": _copy(params["input_prelu"]),
    }
    for name, p in params.items():
        if not name.startswith("stage"):
            continue
        s = stats[name]
        g1, b1 = _bn_affine(p["res_bn1"], s["res_bn1"])
        blk = {
            "res_affine": {
                "scale": g1.astype(np.float32),
                "shift": b1.astype(np.float32),
            },
            "res_conv1": _fold_conv(p["res_conv1"], p["res_bn2"], s["res_bn2"]),
            "res_prelu": _copy(p["res_prelu"]),
            "res_conv2": _fold_conv(p["res_conv2"], p["res_bn3"], s["res_bn3"]),
        }
        if "shortcut_conv" in p:
            blk["shortcut_conv"] = _fold_conv(
                p["shortcut_conv"], p["shortcut_bn"], s["shortcut_bn"]
            )
        if "se" in p:
            blk["se"] = _copy(p["se"])
        out[name] = blk

    kernel = _f64(params["output_fc"]["kernel"])  # [C*H*W, D]
    bias = _f64(params["output_fc"]["bias"])
    g, b = _bn_affine(params["output_bn"], stats["output_bn"])
    hw = (input_size // 16) ** 2
    if kernel.shape[0] != g.shape[0] * hw:
        raise ValueError(
            f"output_fc kernel rows {kernel.shape[0]} != "
            f"{g.shape[0]} channels x {hw} spatial: wrong input_size?"
        )
    # the flatten is channel-major, so each channel's affine repeats over
    # its hw contiguous rows
    g_rep = np.repeat(g, hw)
    b_rep = np.repeat(b, hw)
    bias = bias + b_rep @ kernel
    kernel = kernel * g_rep[:, None]
    fstats = stats["output_feature_bn"]
    inv_std = 1.0 / np.sqrt(_f64(fstats["var"]) + _EPS)
    kernel = kernel * inv_std[None, :]
    bias = (bias - _f64(fstats["mean"])) * inv_std
    out["output_fc"] = {
        "kernel": kernel.astype(np.float32),
        "bias": bias.astype(np.float32),
    }
    return {"params": out}
