"""JAX-package variables -> the port's state dicts.

The JAX package keeps weights as flax variable trees (nested dicts of
arrays, `{'params': ..., 'batch_stats': ...}`); its `.npz` files store them
flattened (`utils/io.py`). The port's modules use the same layer names, so
the mapping is per leaf:

  conv kernel HWIO        -> weight OIHW         (+ bias)
  dense kernel [in, out]  -> weight [out, in]    (+ bias)
  BatchNorm scale/bias    -> weight/bias, batch_stats mean/var -> running_*
  PReLU alpha, Affine scale/shift -> the same names
"""

from __future__ import annotations

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _params_to_state(params: dict, prefix: str, sd: dict) -> None:
    for name, node in params.items():
        key = f"{prefix}{name}"
        if "kernel" in node:
            k = np.asarray(node["kernel"], np.float32)
            if k.ndim == 4:
                sd[f"{key}.weight"] = _t(k.transpose(3, 2, 0, 1))
            elif k.ndim == 2:
                sd[f"{key}.weight"] = _t(k.T)
            else:
                raise ValueError(f"{key}: kernel of rank {k.ndim}")
            if "bias" in node:
                sd[f"{key}.bias"] = _t(node["bias"])
        elif "alpha" in node:
            sd[f"{key}.alpha"] = _t(node["alpha"])
        elif "shift" in node:
            sd[f"{key}.scale"] = _t(node["scale"])
            sd[f"{key}.shift"] = _t(node["shift"])
        elif set(node) == {"scale", "bias"}:
            sd[f"{key}.weight"] = _t(node["scale"])
            sd[f"{key}.bias"] = _t(node["bias"])
        else:
            _params_to_state(node, f"{key}.", sd)


def _stats_to_state(stats: dict, prefix: str, sd: dict) -> None:
    for name, node in stats.items():
        key = f"{prefix}{name}"
        if "mean" in node and "var" in node:
            sd[f"{key}.running_mean"] = _t(node["mean"])
            sd[f"{key}.running_var"] = _t(node["var"])
            sd[f"{key}.num_batches_tracked"] = torch.tensor(0)
        else:
            _stats_to_state(node, f"{key}.", sd)


def detector_state_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """{'pnet'|'rnet'|'onet': {'params': ...}} (float detector variables)
    -> state dict of `models.detector_nets.DetectorNets`."""
    sd: dict = {}
    for net in ("pnet", "rnet", "onet"):
        params = tree[net]["params"]
        if "kernel_q" in params.get("conv1", {}):
            raise NotImplementedError(
                "int8 detector variables: the quantized R/O-nets are queued "
                "in ROADMAP.md (int8 tier)"
            )
        _params_to_state(params, f"{net}.", sd)
    return sd


def backbone_state_from_jax(tree: dict, folded: bool) -> dict[str, torch.Tensor]:
    """IR backbone variables -> state dict of `models.irse.IRBackbone`.

    folded=False takes {'params', 'batch_stats'} of the standard structure;
    folded=True takes {'params'} from `fold_inference_variables`."""
    has_stats = "batch_stats" in tree
    if folded == has_stats:
        raise ValueError(
            f"folded={folded} but the variables "
            f"{'carry' if has_stats else 'lack'} batch_stats"
        )
    sd: dict = {}
    _params_to_state(tree["params"], "", sd)
    if has_stats:
        _stats_to_state(tree["batch_stats"], "", sd)
    return sd
