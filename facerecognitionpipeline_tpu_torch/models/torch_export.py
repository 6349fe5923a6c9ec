"""Export IR/IR-SE variables to the AdaFace-zoo and iresnet PyTorch layouts.

Counterpart of `facerecognitionpipeline_tpu/models/torch_export.py`, with
the same names: the exact inverse of `models.torch_import.convert_statedict`
(and of `onnx_import.convert_iresnet_weights`). A backbone of the port
round-trips into the torch Sequential naming the reference consumes
(`net.build_model(arch)` + `model.`-prefixed Lightning statedict, reference
`face_embedder.py:49-53`). The JAX-format tree comes from the port's modules
through `models/convert.py::backbone_variables_from_state`.

Conversions (mirroring torch_import): conv kernels HWIO -> OIHW, linear
weights [in, out] -> [out, in], BN {scale, bias} + {mean, var} ->
{weight, bias, running_mean, running_var, num_batches_tracked}.

Export operates on the CANONICAL (unfolded) variable tree — the one
`torch_import` produces and an unfolded `irse.IRBackbone` gives through
`backbone_variables_from_state`, with a separate `batch_stats` collection. A
BN-folded inference tree (`models.fold`) has lost the running statistics
and cannot round-trip.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from facerecognitionpipeline_tpu_torch.models.irse import BACKBONE_CONFIGS


def _np(v) -> np.ndarray:
    return np.asarray(v, dtype=np.float32)


def _put_conv(out: dict, key: str, kernel) -> None:
    # flax HWIO -> torch OIHW
    out[f"{key}.weight"] = _np(kernel).transpose(3, 2, 0, 1)


def _put_bn(out: dict, prefix: str, params: Mapping | None, stats: Mapping) -> None:
    if params is not None:
        out[f"{prefix}.weight"] = _np(params["scale"])
        out[f"{prefix}.bias"] = _np(params["bias"])
    out[f"{prefix}.running_mean"] = _np(stats["mean"])
    out[f"{prefix}.running_var"] = _np(stats["var"])
    # torch BatchNorm statedicts carry the tracking counter; zero is what a
    # freshly-constructed torch module expects type-wise (int64 scalar)
    out[f"{prefix}.num_batches_tracked"] = np.zeros((), np.int64)


def export_statedict(
    variables: Mapping[str, Any], architecture: str
) -> dict[str, np.ndarray]:
    """{'params', 'batch_stats'} -> AdaFace-zoo torch statedict
    (numpy values; see `save_adaface_checkpoint` for a .ckpt file)."""
    cfg = BACKBONE_CONFIGS[architecture]
    units, use_se = cfg["units"], cfg["use_se"]
    params = variables["params"]
    try:
        stats = variables["batch_stats"]
    except KeyError:
        raise ValueError(
            "variables have no 'batch_stats' collection — this looks like a "
            "BN-folded inference tree (models.fold), which has lost the "
            "running statistics; export the canonical tree instead"
        ) from None

    sd: dict[str, np.ndarray] = {}
    _put_conv(sd, "input_layer.0", params["input_conv"]["kernel"])
    _put_bn(sd, "input_layer.1", params["input_bn"], stats["input_bn"])
    sd["input_layer.2.weight"] = _np(params["input_prelu"]["alpha"])

    k = 0
    in_ch = 64
    for stage, (n_units, depth) in enumerate(zip(units, (64, 128, 256, 512))):
        for unit in range(n_units):
            name = f"stage{stage}_unit{unit}"
            bp, bs = params[name], stats[name]
            base = f"body.{k}"
            if in_ch != depth:
                _put_conv(
                    sd, f"{base}.shortcut_layer.0",
                    bp["shortcut_conv"]["kernel"],
                )
                _put_bn(
                    sd, f"{base}.shortcut_layer.1",
                    bp["shortcut_bn"], bs["shortcut_bn"],
                )
            _put_bn(sd, f"{base}.res_layer.0", bp["res_bn1"], bs["res_bn1"])
            _put_conv(sd, f"{base}.res_layer.1", bp["res_conv1"]["kernel"])
            _put_bn(sd, f"{base}.res_layer.2", bp["res_bn2"], bs["res_bn2"])
            sd[f"{base}.res_layer.3.weight"] = _np(bp["res_prelu"]["alpha"])
            _put_conv(sd, f"{base}.res_layer.4", bp["res_conv2"]["kernel"])
            _put_bn(sd, f"{base}.res_layer.5", bp["res_bn3"], bs["res_bn3"])
            if use_se:
                _put_conv(sd, f"{base}.res_layer.6.fc1", bp["se"]["fc1"]["kernel"])
                _put_conv(sd, f"{base}.res_layer.6.fc2", bp["se"]["fc2"]["kernel"])
            in_ch = depth
            k += 1

    _put_bn(sd, "output_layer.0", params["output_bn"], stats["output_bn"])
    sd["output_layer.3.weight"] = _np(params["output_fc"]["kernel"]).T
    sd["output_layer.3.bias"] = _np(params["output_fc"]["bias"])
    _put_bn(sd, "output_layer.4", None, stats["output_feature_bn"])
    return sd


def export_iresnet_statedict(
    variables: Mapping[str, Any], architecture: str, features_eps: float = 2e-5
) -> dict[str, np.ndarray]:
    """IR variables -> insightface/arcface_torch **iresnet** statedict.

    The inverse of `onnx_import.convert_iresnet_weights`: weights trained or
    imported here deploy back into the arcface_torch stack (and from there to
    the reference's ArcFace `.onnx` via that repo's stock `torch2onnx`
    exporter; no onnx package is used here, so the statedict is the verified
    hand-off point). Reference consumer: `face_embedder.py:64-88`
    serves exactly such exports.

    The affine-less `output_feature_bn` unfolds into iresnet's affine
    `features` BatchNorm1d (eps 2e-5) with gamma=1, beta=0 — the fold is
    underdetermined, and the identity-affine representative reproduces the
    same normalization exactly:
        (z - mean)/sqrt(var + 2e-5) == (z - mean')/sqrt(var' + 1e-5)
        with mean = mean', var = var' + 1e-5 - 2e-5.
    """
    cfg = BACKBONE_CONFIGS[architecture]
    units = cfg["units"]
    if cfg.get("use_se"):
        raise ValueError(
            f"{architecture} uses SE blocks; the iresnet layout has none — "
            "export with export_statedict (AdaFace zoo layout) instead"
        )
    if not cfg.get("conv_shortcut"):
        raise ValueError(
            f"{architecture} uses subsampling shortcuts on stride-2 "
            "equal-channel units; iresnet requires conv1x1+BN downsamples "
            "there (the iresnet_* configs) — export this tree with "
            "export_statedict (AdaFace zoo layout) instead"
        )
    params = variables["params"]
    try:
        stats = variables["batch_stats"]
    except KeyError:
        raise ValueError(
            "variables have no 'batch_stats' collection — this looks like a "
            "BN-folded inference tree (models.fold), which has lost the "
            "running statistics; export the canonical tree instead"
        ) from None

    sd: dict[str, np.ndarray] = {}
    _put_conv(sd, "conv1", params["input_conv"]["kernel"])
    _put_bn(sd, "bn1", params["input_bn"], stats["input_bn"])
    sd["prelu.weight"] = _np(params["input_prelu"]["alpha"])

    for stage, n_units in enumerate(units):
        for unit in range(n_units):
            name = f"stage{stage}_unit{unit}"
            bp, bs = params[name], stats[name]
            base = f"layer{stage + 1}.{unit}"
            if "shortcut_conv" in bp:
                _put_conv(sd, f"{base}.downsample.0",
                          bp["shortcut_conv"]["kernel"])
                _put_bn(sd, f"{base}.downsample.1",
                        bp["shortcut_bn"], bs["shortcut_bn"])
            _put_bn(sd, f"{base}.bn1", bp["res_bn1"], bs["res_bn1"])
            _put_conv(sd, f"{base}.conv1", bp["res_conv1"]["kernel"])
            _put_bn(sd, f"{base}.bn2", bp["res_bn2"], bs["res_bn2"])
            sd[f"{base}.prelu.weight"] = _np(bp["res_prelu"]["alpha"])
            _put_conv(sd, f"{base}.conv2", bp["res_conv2"]["kernel"])
            _put_bn(sd, f"{base}.bn3", bp["res_bn3"], bs["res_bn3"])

    _put_bn(sd, "bn2", params["output_bn"], stats["output_bn"])
    sd["fc.weight"] = _np(params["output_fc"]["kernel"]).T
    sd["fc.bias"] = _np(params["output_fc"]["bias"])

    our_eps = 1e-5
    mean = _np(stats["output_feature_bn"]["mean"])
    var = _np(stats["output_feature_bn"]["var"]) + our_eps - features_eps
    if np.any(var + features_eps <= 0):
        raise ValueError(
            "output_feature_bn variance too small to represent under the "
            f"iresnet features eps {features_eps}"
        )
    d = mean.shape[0]
    sd["features.weight"] = np.ones(d, np.float32)
    sd["features.bias"] = np.zeros(d, np.float32)
    sd["features.running_mean"] = mean
    sd["features.running_var"] = var
    sd["features.num_batches_tracked"] = np.zeros((), np.int64)
    return sd


def save_iresnet_statedict(
    variables: Mapping[str, Any], architecture: str, path: str
) -> None:
    """Write a plain torch statedict `.pt` in arcface_torch iresnet naming —
    the file `iresnet{N}().load_state_dict(torch.load(p))` and that repo's
    `torch2onnx` consume directly."""
    sd = export_iresnet_statedict(variables, architecture)
    torch.save(
        {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
        path,
    )


def save_adaface_checkpoint(
    variables: Mapping[str, Any],
    architecture: str,
    path: str,
    prefix: str = "model.",
) -> None:
    """Write a reference-loadable `.ckpt`: `{'state_dict': {'model.<k>': t}}`
    (the Lightning wrapping `face_embedder.py:49-53` strips)."""
    sd = export_statedict(variables, architecture)
    blob = {
        "state_dict": {
            prefix + k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in sd.items()
        }
    }
    torch.save(blob, path)
