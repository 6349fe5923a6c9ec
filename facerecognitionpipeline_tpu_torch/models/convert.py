"""JAX-package variables -> the port's state dicts.

The JAX package keeps weights as flax variable trees (nested dicts of
arrays, `{'params': ..., 'batch_stats': ...}`); its `.npz` files store them
flattened (`utils/io.py`). The port's modules use the same layer names, so
the mapping is per leaf:

  conv kernel HWIO        -> weight OIHW         (+ bias)
  dense kernel [in, out]  -> weight [out, in]    (+ bias)
  BatchNorm scale/bias    -> weight/bias, batch_stats mean/var -> running_*
  PReLU alpha, Affine scale/shift -> the same names
  int8 layer {kernel_q, scale, bias, act_scale} -> the same names, the codes
                          int8 and in the JAX layout (HWIO or [in, out]),
                          the rest float32 (`irse.QuantConv`/`QuantDense`)

`params_from_state` goes the other way for the float layers the port
initialises itself, so `models/quantize.py` quantizes the same float32
tree whichever way the weights came; `backbone_variables_from_state` does
the same for an unfolded backbone with its BatchNorms, the tree
`models/torch_export.py` writes out.

`train_state_from_jax` / `train_state_to_jax` carry a whole train state
(`train/trainer.py`) across, leaf by leaf; `fused_body_state_from_jax`
takes the fused int8 body's variables (`quantize.fuse_quantized_params`).
"""

from __future__ import annotations

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


_QUANT_KEYS = {"kernel_q", "scale", "bias", "act_scale"}


def _params_to_state(params: dict, prefix: str, sd: dict) -> None:
    for name, node in params.items():
        key = f"{prefix}{name}"
        if "kernel_q" in node:
            if set(node) != _QUANT_KEYS:
                raise ValueError(f"{key}: an int8 layer needs {sorted(_QUANT_KEYS)}, "
                                 f"got {sorted(node)}")
            sd[f"{key}.kernel_q"] = torch.from_numpy(np.array(node["kernel_q"], dtype=np.int8))
            for leaf in ("scale", "bias", "act_scale"):
                sd[f"{key}.{leaf}"] = _t(node[leaf])
        elif "kernel1_q" in node:  # FusedQuantBody: int8 codes HWIO, float32 constants
            for leaf, a in node.items():
                sd[f"{key}.{leaf}"] = (torch.from_numpy(np.array(a, dtype=np.int8))
                                       if leaf.endswith("_q") else _t(a))
        elif "kernel" in node:
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
    """{'pnet'|'rnet'|'onet': {'params': ...}} (float or int8-quantized
    detector variables) -> state dict of `models.detector_nets.DetectorNets`
    (built with `quantized=True` for the latter)."""
    sd: dict = {}
    for net in ("pnet", "rnet", "onet"):
        _params_to_state(tree[net]["params"], f"{net}.", sd)
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


def params_from_state(sd: dict) -> dict:
    """State dict of float layers without BatchNorm (convs, dense layers,
    PReLU, Affine) -> JAX-format params, exactly: weight OIHW -> kernel HWIO,
    [out, in] -> kernel [in, out]; bias, alpha, scale, shift as they are.
    The inverse of `_params_to_state` on such layers, as float32 numpy."""
    tree: dict = {}
    for key, t in sd.items():
        *path, leaf = key.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        a = t.detach().cpu().numpy().astype(np.float32)
        if leaf == "weight":
            if a.ndim == 4:
                node["kernel"] = a.transpose(2, 3, 1, 0)
            elif a.ndim == 2:
                node["kernel"] = a.T
            else:
                raise ValueError(f"{key}: a weight of rank {a.ndim} (BatchNorm?) has no "
                                 f"JAX-format inverse here")
        elif leaf in ("bias", "alpha", "scale", "shift"):
            node[leaf] = a
        else:
            raise ValueError(f"{key}: no JAX-format inverse for {leaf!r}")
    return tree


def backbone_variables_from_state(sd: dict) -> dict:
    """State dict of an unfolded `IRBackbone` -> JAX-format variables
    {'params', 'batch_stats'}: a BatchNorm's weight/bias -> params
    scale/bias (none for the affine-less feature BN), running_mean/var ->
    batch_stats mean/var; every other layer as `params_from_state`. The
    inverse of `backbone_state_from_jax(..., folded=False)`."""
    bn_prefixes = {k[: -len(".running_mean")] for k in sd if k.endswith(".running_mean")}
    rest, params, stats = {}, {}, {}
    for key, t in sd.items():
        prefix, _, leaf = key.rpartition(".")
        if prefix not in bn_prefixes:
            rest[key] = t
            continue
        if leaf == "num_batches_tracked":
            continue
        path = prefix.split(".")
        tree, name = (
            (stats, {"running_mean": "mean", "running_var": "var"}[leaf])
            if leaf.startswith("running_")
            else (params, {"weight": "scale", "bias": "bias"}[leaf])
        )
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[name] = t.detach().cpu().numpy().astype(np.float32)
    _merge(params, params_from_state(rest))
    return {"params": params, "batch_stats": stats}


def _merge(into: dict, tree: dict) -> None:
    for k, v in tree.items():
        if isinstance(v, dict):
            _merge(into.setdefault(k, {}), v)
        else:
            into[k] = v


def detector_variables_from_state(sd: dict) -> dict:
    """State dict of the float `DetectorNets` -> JAX-format detector
    variables {'pnet'|'rnet'|'onet': {'params': ...}}."""
    tree = params_from_state(sd)
    return {net: {"params": tree[net]} for net in ("pnet", "rnet", "onet")}


def fused_body_state_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """{'params': ...} of `quantize.fuse_quantized_params` -> state dict of
    `build_backbone(arch, folded=True, quantized=True, fused_int8=True)`:
    each unit's `body` leaves under `<unit>.body.`, the rest as
    `backbone_state_from_jax(..., folded=True)` maps them."""
    return backbone_state_from_jax(tree, folded=True)


def _field(node, name: str):
    return node[name] if isinstance(node, dict) else getattr(node, name)


def _params_tree_to_state(params: dict) -> tuple[dict, torch.Tensor]:
    """{'backbone': JAX params, 'classifier': [D, C]} -> ({name: tensor}, classifier)."""
    sd: dict = {}
    _params_to_state(params["backbone"], "", sd)
    return sd, _t(params["classifier"])


def train_state_from_jax(tree: dict) -> dict:
    """A JAX package train state (`Trainer.init_state` and after; numpy or
    device arrays) -> the port's train state on the CPU: backbone params
    and their momentum traces in module layout, batch_stats as running
    buffers, the classifier, the optimizer's count (fused form, or the
    optax chain's tuple), norm_ema and step. Parameters require grad."""
    bb, clf = _params_tree_to_state(tree["params"])
    stats: dict = {}
    _stats_to_state(tree["batch_stats"], "", stats)
    stats = {k: v for k, v in stats.items() if not k.endswith("num_batches_tracked")}

    def trace(t):
        tb, tc = _params_tree_to_state(t)
        return {"backbone": tb, "classifier": tc}

    def count(c):
        return torch.tensor(int(np.asarray(c)), dtype=torch.int32)

    opt = tree["opt_state"]
    if isinstance(opt, dict):
        opt_state = {"trace": trace(opt["trace"]), "count": count(opt["count"])}
    else:
        sched = opt[1][1]
        has_count = "count" in sched if isinstance(sched, dict) else hasattr(sched, "count")
        opt_state = ({}, ({"trace": trace(_field(opt[1][0], "trace"))},
                          {"count": count(_field(sched, "count"))} if has_count else {}))
    for p in [*bb.values(), clf]:
        p.requires_grad_(True)
    return {
        "params": {"backbone": bb, "classifier": clf},
        "batch_stats": stats,
        "opt_state": opt_state,
        "norm_ema": {k: _t(tree["norm_ema"][k]) for k in ("mean", "std")},
        "step": count(tree["step"]),
    }


def train_state_to_jax(state: dict) -> dict:
    """The port's train state -> the JAX package's layout as numpy, every
    leaf: {'params': {'backbone', 'classifier'}, 'batch_stats',
    'opt_state', 'norm_ema', 'step'}. The unfused optimizer's state is the
    tuple ({}, ({'trace': ...}, {'count': ...} or {})), which flattens to
    the leaves of optax's chain state in their order. The inverse of
    `train_state_from_jax`. A mesh's classifier blocks are joined along the
    class axis."""
    stats = state["batch_stats"]

    def params(tree):
        c = tree["classifier"]
        if isinstance(c, list):  # class blocks of a mesh, in class order
            c = torch.cat([b.detach().cpu() for b in c], dim=1)
        return {"backbone": backbone_variables_from_state({**tree["backbone"], **stats})["params"],
                "classifier": c.detach().cpu().numpy().astype(np.float32)}

    def count(c):
        return np.int32(int(c))

    opt = state["opt_state"]
    if isinstance(opt, dict):
        opt_state = {"trace": params(opt["trace"]), "count": count(opt["count"])}
    else:
        sched = opt[1][1]
        opt_state = ({}, ({"trace": params(opt[1][0]["trace"])},
                          {"count": count(sched["count"])} if sched else {}))
    return {
        "params": params(state["params"]),
        "batch_stats": backbone_variables_from_state(dict(stats))["batch_stats"],
        "opt_state": opt_state,
        "norm_ema": {k: np.float32(float(v)) for k, v in state["norm_ema"].items()},
        "step": count(state["step"]),
    }
