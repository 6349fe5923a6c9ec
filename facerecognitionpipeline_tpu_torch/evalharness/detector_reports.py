"""The detector's stress and out-of-distribution reports, with the
retrained cascades behind them.

Counterpart of the `main`s of `examples/detector_stress_eval.py` and
`examples/detector_ood_eval.py`: the same detector configuration
(`make_detector`), the same suites at 12 scenes from seed 0, and the same
report keys ('base' and 'stress_retrained'; 'base' held out,
'dr_retrained_ood' and 'dr_retrained_stress'), each row {'weights',
['held_out',] 'summary', 'detail'}. A retrain runs the recipe through
`train/detector_recipes.py::train_recipe` (three processes), assigns the
variables to a detector built on the base weights, as the examples do,
and saves them with `save_npz` in the format both packages load. What the
run was (recipe, seconds per net, the first and last 20 losses of each
net, the card, `os.cpu_count()`) goes into a `.meta.json` beside the
weights, so that the reports keep the JAX reports' keys.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Optional, Tuple

import torch

from facerecognitionpipeline_tpu_torch.evalharness.detection import run_stress_suite
from facerecognitionpipeline_tpu_torch.evalharness.detection_ood import run_ood_suite
from facerecognitionpipeline_tpu_torch.models.detector import (
    MTCNNDetector,
    discover_default_weights,
)
from facerecognitionpipeline_tpu_torch.train.detector_recipes import (
    Recipe,
    dr_recipe,
    stress_recipe,
    train_recipe,
)
from facerecognitionpipeline_tpu_torch.utils.device import card_line

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
STRESS_BASE_WEIGHTS = os.path.join(REPO, "pretrained", "mtcnn_synthetic.npz")
STRESS_WEIGHTS = os.path.join(REPO, "pretrained", "mtcnn_stress_torch.npz")
DR_WEIGHTS = os.path.join(REPO, "pretrained", "mtcnn_dr_torch.npz")
STRESS_REPORT_DIR = os.path.join(REPO, "reports", "detector_stress_torch")
OOD_REPORT_DIR = os.path.join(REPO, "reports", "detector_ood_torch")


def make_detector(weights_path: Optional[str] = None, device="cuda",
                  dtype: torch.dtype = torch.float32, **kw) -> MTCNNDetector:
    """The examples' detector: 320 x 320, 32 faces, min face 18, stage
    thresholds (0.6, 0.6, 0.5), float32 unless `dtype` says otherwise."""
    return MTCNNDetector(det_size=(320, 320), max_faces=32, min_face_size=18,
                         weights_path=weights_path, stage_thresholds=(0.6, 0.6, 0.5),
                         dtype=dtype, device=device, **kw)


def _rel(path: str) -> str:
    return os.path.relpath(path, REPO)


def retrain_detector(recipe: Recipe, base_weights: str, out: str,
                     device="cuda") -> MTCNNDetector:
    """Train `recipe`, assign its variables to the examples' detector built
    on `base_weights` (its configuration reused, as the examples do), save
    them as `out` and the run's metadata as `out`'s `.meta.json`. Returns
    the retrained detector."""
    history: dict = {}
    seconds: dict = {}
    t0 = time.perf_counter()
    variables = train_recipe(recipe, device=device, history=history, seconds=seconds)
    total = time.perf_counter() - t0
    det = make_detector(base_weights, device=device)
    det.variables = variables
    det.save_npz(out)
    meta = {
        "recipe": {"name": recipe.name, "steps": recipe.steps, "batch": recipe.batch,
                   "seed": recipe.seed, "ohem_fraction": recipe.ohem_fraction,
                   "class_balance": recipe.class_balance,
                   "scene_fn": getattr(recipe.scene_fn, "func", recipe.scene_fn).__name__,
                   "scene_kwargs": getattr(recipe.scene_fn, "keywords", {})},
        "device": str(det.device),
        "card": card_line(det.device),
        "cpu_count": os.cpu_count(),
        "train_seconds": total,
        "seconds_per_net": seconds,
        "losses_first20": {k: v[:20] for k, v in history.items()},
        "losses_last20": {k: v[-20:] for k, v in history.items()},
    }
    with open(out.replace(".npz", ".meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    print(f"Saved {_rel(out)}", file=sys.stderr)
    return det


def _balance(class_balance: Optional[str]) -> Optional[Tuple[float, float]]:
    """The examples' '--class_balance POS,PART' as a pair (None: none)."""
    return tuple(float(x) for x in class_balance.split(",")) if class_balance else None


def run_stress_report(base_weights: Optional[str] = None, retrain: bool = False,
                      steps: int = 1500, n_scenes: int = 12, pure_negative_p: float = 0.3,
                      class_balance: Optional[str] = None, device="cuda") -> dict:
    """examples/detector_stress_eval.py's report: 'base' (the stress suite
    on `base_weights`, default pretrained/mtcnn_synthetic.npz) and, with
    `retrain`, 'stress_retrained' (the stress recipe trained and saved as
    STRESS_WEIGHTS, pretrained/mtcnn_stress_torch.npz)."""
    base_weights = base_weights or STRESS_BASE_WEIGHTS
    out_weights = STRESS_WEIGHTS
    print(f"Evaluating {base_weights}...", file=sys.stderr)
    report = {"base": {"weights": _rel(base_weights),
                       **run_stress_suite(make_detector(base_weights, device=device),
                                          n_scenes=n_scenes, seed=0)}}
    if retrain:
        print("Retraining cascade on stress-augmented scenes...", file=sys.stderr)
        recipe = stress_recipe(steps, pure_negative_p, _balance(class_balance))
        det = retrain_detector(recipe, base_weights, out_weights, device)
        report["stress_retrained"] = {"weights": _rel(out_weights),
                                      **run_stress_suite(det, n_scenes=n_scenes, seed=0)}
    return report


def run_ood_report(base_weights: Optional[str] = None, retrain: bool = False,
                   steps: int = 2500, n_scenes: int = 12,
                   class_balance: Optional[str] = "0.24,0.23", device="cuda") -> dict:
    """examples/detector_ood_eval.py's report: 'base' (the OOD suite on
    `base_weights`, default `discover_default_weights()`; held out) and,
    with `retrain`, the domain-randomized recipe trained and saved as
    DR_WEIGHTS (pretrained/mtcnn_dr_torch.npz), then 'dr_retrained_ood'
    (not held out) and 'dr_retrained_stress' (the in-distribution
    regression check)."""
    base_weights = base_weights or discover_default_weights()
    out_weights = DR_WEIGHTS
    print(f"OOD-evaluating {base_weights}...", file=sys.stderr)
    report = {"base": {"weights": _rel(base_weights), "held_out": True,
                       **run_ood_suite(make_detector(base_weights, device=device),
                                       n_scenes=n_scenes, seed=0)}}
    if retrain:
        print("Retraining cascade with domain randomization...", file=sys.stderr)
        recipe = dr_recipe(steps, _balance(class_balance))
        det = retrain_detector(recipe, base_weights, out_weights, device)
        report["dr_retrained_ood"] = {"weights": _rel(out_weights), "held_out": False,
                                      **run_ood_suite(det, n_scenes=n_scenes, seed=0)}
        print("In-distribution stress suite on the retrained weights "
              "(regression check)...", file=sys.stderr)
        report["dr_retrained_stress"] = {"weights": _rel(out_weights),
                                         **run_stress_suite(det, n_scenes=n_scenes, seed=0)}
    return report


def write_report(report: dict, out_dir: str) -> str:
    """`report` as out_dir/report.json (the examples' layout); returns the
    path."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "report.json")
    with open(path, "w") as f:
        json.dump(report, f, indent=1)
    return path
