"""The detector's training recipes: the cascades that ship as
pretrained/mtcnn_stress.npz and pretrained/mtcnn_dr.npz.

Counterpart of the training halves of `examples/detector_stress_eval.py
--retrain` (the stress mix: half plain `render_scene`, half
`render_stress_training_scene` with occluders, face-like distractors and
faceless scenes) and `examples/detector_ood_eval.py --retrain` (domain
randomization: plain, stress and facegen scenes, corrupted half the time).
The scene functions are module functions, draw for draw the examples'
closures, so they pickle into worker processes.

`train_recipe` trains a recipe's three nets in parallel processes.
`train_detector` trains them one after another, each from its own seed
and its own numpy generator, so the processes see exactly the patch
streams that `train_detector` would, and return what it returns.
"""

from __future__ import annotations

import functools
import multiprocessing
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from facerecognitionpipeline_tpu_torch.evalharness.detection import (
    render_stress_training_scene,
)
from facerecognitionpipeline_tpu_torch.evalharness.detection_ood import (
    _CORRUPTIONS,
    _identities,
)
from facerecognitionpipeline_tpu_torch.train.detector_train import (
    CASCADE_NETS,
    render_scene,
    train_net,
)
from facerecognitionpipeline_tpu_torch.train.facegen import compose_scene
from facerecognitionpipeline_tpu_torch.utils.device import resolve_device


def stress_mixed_scene(rng: np.random.Generator, pure_negative_p: float = 0.3):
    """The stress recipe's scene: `render_scene` half the time, else a
    stress training scene (faceless with probability pure_negative_p)."""
    if rng.random() < 0.5:
        return render_scene(rng)
    return render_stress_training_scene(rng, pure_negative_p=pure_negative_p)


def facegen_training_scene(rng: np.random.Generator):
    """A facegen scene at the patch sampler's scale, (image, boxes,
    landmarks), with the OOD corruption battery applied half the time. A
    3-tuple on purpose: compose_scene's 4th element holds identity indices,
    which sample_patches would read as hard-negative boxes."""
    idents = _identities(rng, int(rng.integers(1, 4)))
    img, boxes, lms, _ = compose_scene(idents, rng, size=160, min_face=24, max_face=64)
    if rng.random() < 0.5:
        name = list(_CORRUPTIONS)[int(rng.integers(0, len(_CORRUPTIONS)))]
        img = _CORRUPTIONS[name](img, rng)
    return img, boxes, lms


def dr_mixed_scene(rng: np.random.Generator):
    """The domain-randomized recipe's scene: plain 30%, stress 40% (its
    occluders, distractors and faceless scenes keep hard-negative false
    positives and occlusion recall), facegen 30%."""
    r = rng.random()
    if r < 0.3:
        return render_scene(rng)
    if r < 0.7:
        return render_stress_training_scene(rng, pure_negative_p=0.3)
    return facegen_training_scene(rng)


@dataclass(frozen=True)
class Recipe:
    """`train_detector`'s arguments for one shipped cascade."""

    name: str
    scene_fn: Callable
    steps: int
    batch: int = 256
    seed: int = 0
    ohem_fraction: float = 0.7
    class_balance: Optional[Tuple[float, float]] = None


def stress_recipe(steps: int = 1500, pure_negative_p: float = 0.3,
                  class_balance: Optional[Tuple[float, float]] = None) -> Recipe:
    """examples/detector_stress_eval.py --retrain with its defaults."""
    return Recipe("stress", functools.partial(stress_mixed_scene,
                                              pure_negative_p=pure_negative_p),
                  steps, class_balance=class_balance)


def dr_recipe(steps: int = 2500,
              class_balance: Optional[Tuple[float, float]] = (0.24, 0.23)) -> Recipe:
    """examples/detector_ood_eval.py --retrain with its defaults."""
    return Recipe("dr", dr_mixed_scene, steps, class_balance=class_balance)


STRESS_RECIPE = stress_recipe()
DR_RECIPE = dr_recipe()


def _train_one(job):
    """One net of a recipe (a worker process's task): (name, its
    JAX-format variables, its losses, seconds)."""
    (name, net, size, landmarks, offset), recipe, device, threads, log_every = job
    if threads:
        torch.set_num_threads(threads)
    losses: list = []
    t0 = time.perf_counter()
    variables = train_net(net(), size, recipe.steps, recipe.batch, seed=recipe.seed + offset,
                          with_landmarks=landmarks, scene_fn=recipe.scene_fn,
                          log_every=log_every, ohem_fraction=recipe.ohem_fraction,
                          class_balance=recipe.class_balance, device=device, history=losses)
    return name, variables, losses, time.perf_counter() - t0


def train_recipe(recipe: Recipe, device="cuda", processes: int = 3, log_every: int = 100,
                 history: Optional[dict] = None, seconds: Optional[dict] = None) -> dict:
    """`train_detector(recipe.steps, recipe.batch, recipe.seed,
    recipe.scene_fn, ohem_fraction=..., class_balance=...)`'s result, with
    the three nets trained in `processes` spawned worker processes (CUDA
    cannot be forked). `history`
    and `seconds`, if given, receive each net's losses and training
    seconds. On the CPU every worker uses this process's torch thread
    count, so the result is train_detector's bit for bit."""
    dev = resolve_device(device)
    threads = torch.get_num_threads() if dev.type == "cpu" else 0
    jobs = [(net, recipe, str(dev), threads, log_every) for net in CASCADE_NETS]
    print(f"[train_recipe] {recipe.name}: {recipe.steps} steps a net at batch {recipe.batch}, "
          f"{processes} process(es), os.cpu_count() {os.cpu_count()}", file=sys.stderr)
    with ProcessPoolExecutor(min(processes, len(jobs)),
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        results = list(pool.map(_train_one, jobs))
    out = {}
    for name, variables, losses, secs in results:
        out[name] = variables
        if history is not None:
            history[name] = losses
        if seconds is not None:
            seconds[name] = secs
        print(f"[train_recipe] {recipe.name} {name}: {secs:.1f} s", file=sys.stderr)
    return out
