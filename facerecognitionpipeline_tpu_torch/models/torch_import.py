"""Import AdaFace-zoo PyTorch checkpoints as JAX-format IR/IR-SE variables.

Counterpart of `facerecognitionpipeline_tpu/models/torch_import.py`, with
the same names and the same output: the JAX-format numpy tree
`{'params': ..., 'batch_stats': ...}` that the JAX importer returns, byte
for byte. `models/convert.py::backbone_state_from_jax` then carries it into
the port's `models.irse.IRBackbone` (after `models/fold.py` when the
embedder folds BN). The reference loads `.ckpt` Lightning checkpoints,
strips the `model.` statedict prefix, and feeds them to
`net.build_model(arch)` (`face_embedder.py:49-53`).

Canonical torch module layout assumed (the AdaFace zoo's Sequential order):

  input_layer.0 Conv | .1 BN | .2 PReLU
  body.<k>.shortcut_layer.0 Conv | .1 BN          (only on channel change)
  body.<k>.res_layer.0 BN | .1 Conv | .2 BN | .3 PReLU | .4 Conv | .5 BN
  body.<k>.res_layer.6 SEModule(fc1, fc2)          (IR-SE variants)
  output_layer.0 BN | .3 Linear | .4 BN1d(affine=False)

Conversions: conv kernels OIHW -> HWIO, linear weights [out,in] -> [in,out]
(the JAX backbone flattens channel-major to match torch), BN running stats
-> `batch_stats`.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from facerecognitionpipeline_tpu_torch.models.irse import BACKBONE_CONFIGS


def _to_np(v) -> np.ndarray:
    if hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
    return np.asarray(v, dtype=np.float32)


#: Wrapper scopes the zoo's checkpoints bury weights under, in any stacking
#: order: Lightning ('model.'), DataParallel/DDP ('module.'),
#: torch.compile ('_orig_mod.').
_WRAPPER_PREFIXES = ("model.", "module.", "_orig_mod.")


def strip_prefix(
    statedict: Mapping[str, Any], prefix: str | None = None
) -> dict:
    """Unwrap checkpoint scoping prefixes (reference face_embedder.py:52
    strips only 'model.'; real zoo files also show 'module.model.' DDP
    stacks and torch.compile '_orig_mod.' scopes — strip ALL of them,
    per key, in any order). An explicit `prefix` keeps the legacy
    filter-by-one-prefix behavior."""
    if prefix is not None:
        out = {
            k[len(prefix):]: v for k, v in statedict.items() if k.startswith(prefix)
        }
        return out if out else dict(statedict)
    out = {}
    for k, v in statedict.items():
        while k.startswith(_WRAPPER_PREFIXES):
            for p in _WRAPPER_PREFIXES:
                if k.startswith(p):
                    k = k[len(p):]
                    break
        out[k] = v
    return out


def _fetch(sd: dict, key: str):
    try:
        return sd[key]
    except KeyError:
        sample = ", ".join(sorted(sd)[:8])
        raise KeyError(
            f"statedict is missing {key!r} — wrong architecture for this "
            f"checkpoint, or an unrecognized layout (keys start: {sample}...)"
        ) from None


def _conv(sd: dict, key: str) -> np.ndarray:
    # torch OIHW -> flax HWIO
    w = _to_np(_fetch(sd, key))
    if w.ndim != 4:
        raise ValueError(f"{key}: expected a 4-d conv kernel, got shape {w.shape}")
    return w.transpose(2, 3, 1, 0)


def _bn(sd: dict, prefix: str, affine: bool = True) -> tuple[dict, dict]:
    params = {}
    if affine:
        params = {"scale": _to_np(_fetch(sd, f"{prefix}.weight")),
                  "bias": _to_np(_fetch(sd, f"{prefix}.bias"))}
    stats = {"mean": _to_np(_fetch(sd, f"{prefix}.running_mean")),
             "var": _to_np(_fetch(sd, f"{prefix}.running_var"))}
    return params, stats


def convert_statedict(statedict: Mapping[str, Any], architecture: str) -> dict:
    """torch statedict (already prefix-stripped) -> JAX-format variables
    {'params': ..., 'batch_stats': ...} of `architecture`."""
    cfg = BACKBONE_CONFIGS[architecture]
    units, use_se = cfg["units"], cfg["use_se"]
    sd = dict(statedict)
    params: dict[str, Any] = {}
    stats: dict[str, Any] = {}

    params["input_conv"] = {"kernel": _conv(sd, "input_layer.0.weight")}
    p, s = _bn(sd, "input_layer.1")
    params["input_bn"], stats["input_bn"] = p, s
    params["input_prelu"] = {"alpha": _to_np(_fetch(sd, "input_layer.2.weight"))}

    k = 0  # flat torch body index
    in_ch = 64
    stage_channels = (64, 128, 256, 512)
    for stage, (n_units, depth) in enumerate(zip(units, stage_channels)):
        for unit in range(n_units):
            name = f"stage{stage}_unit{unit}"
            bp: dict[str, Any] = {}
            bs: dict[str, Any] = {}
            base = f"body.{k}"
            if in_ch != depth:
                bp["shortcut_conv"] = {"kernel": _conv(sd, f"{base}.shortcut_layer.0.weight")}
                p, s = _bn(sd, f"{base}.shortcut_layer.1")
                bp["shortcut_bn"], bs["shortcut_bn"] = p, s
            p, s = _bn(sd, f"{base}.res_layer.0")
            bp["res_bn1"], bs["res_bn1"] = p, s
            bp["res_conv1"] = {"kernel": _conv(sd, f"{base}.res_layer.1.weight")}
            p, s = _bn(sd, f"{base}.res_layer.2")
            bp["res_bn2"], bs["res_bn2"] = p, s
            bp["res_prelu"] = {"alpha": _to_np(_fetch(sd, f"{base}.res_layer.3.weight"))}
            bp["res_conv2"] = {"kernel": _conv(sd, f"{base}.res_layer.4.weight")}
            p, s = _bn(sd, f"{base}.res_layer.5")
            bp["res_bn3"], bs["res_bn3"] = p, s
            if use_se:
                bp["se"] = {
                    "fc1": {"kernel": _conv(sd, f"{base}.res_layer.6.fc1.weight")},
                    "fc2": {"kernel": _conv(sd, f"{base}.res_layer.6.fc2.weight")},
                }
            params[name], stats[name] = bp, bs
            in_ch = depth
            k += 1

    p, s = _bn(sd, "output_layer.0")
    params["output_bn"], stats["output_bn"] = p, s
    params["output_fc"] = {
        "kernel": _to_np(_fetch(sd, "output_layer.3.weight")).T,
        "bias": _to_np(_fetch(sd, "output_layer.3.bias")),
    }
    _, s = _bn(sd, "output_layer.4", affine=False)
    stats["output_feature_bn"] = s

    return {"params": params, "batch_stats": stats}


def load_adaface_checkpoint(
    path: str, architecture: str, trusted: bool = False
) -> dict:
    """Load an AdaFace `.ckpt` (Lightning) or raw statedict file from disk.

    Accepts the zoo's checkpoint format: `{'state_dict': {'model.<k>': ...}}`
    or a bare statedict.

    Loads with ``weights_only=True`` by default so an untrusted checkpoint
    path cannot execute arbitrary pickled code. Some Lightning checkpoints
    embed non-tensor objects that the safe loader rejects; pass
    ``trusted=True`` only for checkpoints from a source you control.
    """
    try:
        blob = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        if not trusted:
            raise ValueError(
                f"{path}: not loadable with weights_only=True (it pickles "
                "non-tensor objects). If this checkpoint comes from a source "
                "you trust, re-load with trusted=True."
            )
        blob = torch.load(path, map_location="cpu", weights_only=False)
    sd = blob.get("state_dict", blob) if isinstance(blob, dict) else blob
    return convert_statedict(strip_prefix(sd), architecture)


def detect_architecture(statedict: Mapping[str, Any]) -> str:
    """Best-effort architecture inference from a (stripped) statedict:
    counts body units and checks for SE keys."""
    body_ids = set()
    has_se = False
    for key in statedict:
        if key.startswith("body."):
            body_ids.add(int(key.split(".")[1]))
            if ".fc1." in key or ".fc2." in key:
                has_se = True
    n = len(body_ids)
    for arch, cfg in BACKBONE_CONFIGS.items():
        if sum(cfg["units"]) == n and cfg["use_se"] == has_se:
            return arch
    raise ValueError(f"Cannot infer architecture: {n} body units, se={has_se}")
