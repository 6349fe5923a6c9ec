"""Training checkpoints with resume, and the deployable backbone export.

Counterpart of `facerecognitionpipeline_tpu/train/checkpoint.py`. The JAX
package saves through orbax; the port keeps its own format, one file per
step under the directory (`<dir>/step_<N>.pt`, the 3 newest kept), written
with `torch.save` of tensors and plain Python values (the whole train state
of `train/trainer.py`, moved to the CPU) and read back with
`weights_only=True`. A restore goes into the structure of a given state
(e.g. a fresh `Trainer.init_state()`), on its device; a checkpoint of
another structure (the fused optimizer's state against the unfused one,
another architecture or class count) raises ValueError naming the first
difference.

`export_backbone` writes the inference variables in the `.npz` format of
`utils/io.save_npz_variables` (the JAX package's keys and arrays), which
both packages' `FaceEmbedder(model_path=...)` load.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch

from facerecognitionpipeline_tpu_torch.models.convert import backbone_variables_from_state
from facerecognitionpipeline_tpu_torch.utils.io import save_npz_variables

MAX_TO_KEEP = 3
_NAME = re.compile(r"^step_(\d+)\.pt$")


def _path(checkpoint_dir: str, step: int) -> str:
    return os.path.join(checkpoint_dir, f"step_{step}.pt")


def _steps(checkpoint_dir: str) -> list[int]:
    if not os.path.isdir(checkpoint_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(checkpoint_dir)) if m)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def save_checkpoint(checkpoint_dir: str, state: dict, step: int,
                    max_to_keep: int = MAX_TO_KEEP) -> None:
    """Write the state as step `step` (replacing one of that step), then
    delete all but the `max_to_keep` newest steps. The file appears whole
    or not at all (written beside, then renamed)."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    cpu = _map(state, lambda t: t.detach().cpu() if isinstance(t, torch.Tensor) else t)
    path = _path(checkpoint_dir, step)
    tmp = f"{path}.tmp"
    torch.save(cpu, tmp)
    os.replace(tmp, path)
    for old in _steps(checkpoint_dir)[:-max_to_keep]:
        os.remove(_path(checkpoint_dir, old))


def latest_step(checkpoint_dir: str) -> Optional[int]:
    steps = _steps(checkpoint_dir)
    return steps[-1] if steps else None


def _check_structure(want, got, where: str = "state") -> None:
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(want) != set(got):
            have = sorted(got) if isinstance(got, dict) else type(got).__name__
            raise ValueError(
                f"checkpoint structure differs at {where}: expected keys {sorted(want)}, "
                f"found {have}. A checkpoint of the fused optimizer restores only into "
                f"a state of the fused optimizer, and the unfused one (--optax_optimizer) "
                f"only into its own; the architecture and class count must match too")
        for k in want:
            _check_structure(want[k], got[k], f"{where}[{k!r}]")
    elif isinstance(want, (tuple, list)):
        if not isinstance(got, (tuple, list)) or len(want) != len(got):
            raise ValueError(
                f"checkpoint structure differs at {where}: expected a sequence of "
                f"{len(want)}, found {type(got).__name__}. The fused and the unfused "
                f"(--optax_optimizer) optimizer states do not restore into each other")
        for i, (w, g) in enumerate(zip(want, got)):
            _check_structure(w, g, f"{where}[{i}]")
    elif isinstance(want, torch.Tensor):
        if not isinstance(got, torch.Tensor) or got.shape != want.shape or got.dtype != want.dtype:
            desc = (f"{tuple(got.shape)} {got.dtype}" if isinstance(got, torch.Tensor)
                    else type(got).__name__)
            raise ValueError(f"checkpoint leaf {where}: expected {tuple(want.shape)} "
                             f"{want.dtype}, found {desc}")


def restore_checkpoint(checkpoint_dir: str, abstract_state: dict,
                       step: Optional[int] = None) -> dict:
    """The state saved at `step` (default the latest), in the structure,
    devices and grad flags of `abstract_state`."""
    step = step if step is not None else latest_step(checkpoint_dir)
    if step is None:
        raise FileNotFoundError(f"No checkpoints under {checkpoint_dir}")
    saved = torch.load(_path(checkpoint_dir, step), map_location="cpu", weights_only=True)
    _check_structure(abstract_state, saved)

    def place(want, got):
        if isinstance(want, dict):
            return {k: place(want[k], got[k]) for k in want}
        if isinstance(want, (tuple, list)):
            return type(want)(place(w, g) for w, g in zip(want, got))
        if isinstance(want, torch.Tensor):
            return got.to(want.device).requires_grad_(want.requires_grad)
        return got

    return place(abstract_state, saved)


def export_backbone(state: dict, path: str) -> None:
    """Write the backbone's inference variables ({'params', 'batch_stats'},
    JAX layout) as the `.npz` that `FaceEmbedder(model_path=...)` and the
    JAX package's loaders read."""
    sd = {**state["params"]["backbone"], **state["batch_stats"]}
    save_npz_variables(path, backbone_variables_from_state(sd))
