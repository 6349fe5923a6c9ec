"""Train a headline-family backbone on a multi-hundred-identity procedural
corpus, for the open-set evaluation in `evalharness/open_set.py`.

Counterpart of `examples/train_ir18_open_set.py:46-196` (the JAX package's
example): `build_corpus` renders n_ids identities x per_id crops once on the
host; `corpus_batches` samples augmented uint8 batches, which
`prefetch_to_device` stages on the device two ahead and `to_model_input`
turns into model input there; the port's `Trainer` takes AdaFace steps with
a cosine schedule after a linear warm-up. A held-out verification probe
(identities disjoint from training and from the final evaluation) is logged
during training, so generalization is tracked, not memorization.

The loss stays on the device: the host reads it once per log window (every
250 steps), which is also when the window's time per step is taken. Every
1000 steps the probe runs; every 2000 (before the last step) the backbone is
exported to `out + ".step<N>"`; at the end to `out`, with the recipe and
the probe's history in `out` with `.meta.json` for `.npz`.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from facerecognitionpipeline_tpu_torch.train.checkpoint import export_backbone
from facerecognitionpipeline_tpu_torch.train.data import prefetch_to_device
from facerecognitionpipeline_tpu_torch.train.facegen import (
    build_corpus,
    corpus_batches,
    render_crop,
    sample_identity,
    to_model_input,
)
from facerecognitionpipeline_tpu_torch.train.trainer import TrainConfig, Trainer
from facerecognitionpipeline_tpu_torch.utils.device import resolve_device

HELD_OUT_OFFSET = 10_000  # identity-seed offset of the evaluation set
LOG_EVERY = 250
PROBE_EVERY = 1000
EXPORT_EVERY = 2000


def holdout_probe_sets(n_ids: int = 24, per_id: int = 4, seed: int = 99):
    """Small held-out verification probe: n_ids unseen identities x per_id
    crops. Returns (images [N,112,112,3] uint8, labels [N])."""
    rng = np.random.default_rng(seed)
    imgs, labels = [], []
    for i in range(n_ids):
        # disjoint from the training ids and from the final evaluation's, so
        # the in-run probe leaks no evaluation identity
        ident = sample_identity(HELD_OUT_OFFSET + 50_000 + i)
        for _ in range(per_id):
            imgs.append(render_crop(ident, rng))
            labels.append(i)
    return np.stack(imgs), np.asarray(labels, np.int32)


def embed_for_probe(trainer, state, images: np.ndarray) -> np.ndarray:
    """Inference-mode features from the in-training state: the unfolded
    backbone with BatchNorm on its running statistics, in float32 from the
    float32 parameters, on the trainer's device. [N,112,112,3] uint8 RGB ->
    [N, D] unit float32."""
    x = (images[..., ::-1].astype(np.float32) - 127.5) / 127.5
    variables = {**state["params"]["backbone"], **state["batch_stats"]}
    model, was_training = trainer.model, trainer.model.training
    model.eval()  # the BatchNorm modules on their running statistics
    try:
        with torch.no_grad():
            feats, _ = torch.func.functional_call(
                model, variables, (torch.from_numpy(x).to(trainer.device),), {"train": False})
    finally:
        model.train(was_training)
    f = feats.float().cpu().numpy()
    return f / (np.linalg.norm(f, axis=1, keepdims=True) + 1e-9)


def holdout_separation(feats: np.ndarray, labels: np.ndarray) -> dict:
    """Genuine/impostor cosine stats + a sweep-free EER estimate."""
    sims = feats @ feats.T
    iu, ju = np.triu_indices(len(feats), k=1)
    same = labels[iu] == labels[ju]
    g, imp = sims[iu, ju][same], sims[iu, ju][~same]
    thr = np.unique(np.concatenate([g, imp]))[:, None]
    far = (imp[None, :] >= thr).mean(axis=1)
    frr = (g[None, :] < thr).mean(axis=1)
    i = int(np.argmin(np.abs(far - frr)))
    return {
        "genuine_mean": float(g.mean()),
        "impostor_mean": float(imp.mean()),
        "eer": float((far[i] + frr[i]) / 2),
    }


def train_open_set(architecture: str = "ir_18", n_ids: int = 360, per_id: int = 72,
                   steps: int = 6000, batch: int = 256, lr: float = 0.1, warmup: int = 300,
                   out: str | None = None, probe: bool = False, seed: int = 0,
                   device="cuda"):
    """The example's training run on `device`. `probe`: 30 steps, a log line
    every 10, no probe, no export. `out`: the weights path (default
    pretrained/<arch>_synthetic_torch.npz). Returns (trainer, state, meta,
    losses): the final state, the `.meta.json` written (None under
    `probe`) and every step's loss as floats."""
    device = resolve_device(device)  # before the render: no card, no work
    out = out or f"pretrained/{architecture}_synthetic_torch.npz"
    print(f"Rendering corpus: {n_ids} ids x {per_id} crops ...", flush=True)
    t0 = time.time()
    images, labels = build_corpus(n_ids, per_id, seed=seed)
    print(f"  {len(images)} crops in {time.time() - t0:.0f}s "
          f"({images.nbytes / 1e6:.0f} MB)", flush=True)

    trainer = Trainer(TrainConfig(
        architecture=architecture,
        num_classes=n_ids,
        loss="adaface",
        learning_rate=lr,
        lr_schedule="cosine",
        warmup_steps=warmup,
        total_steps=steps,
        dtype=torch.bfloat16,
    ), device=device)
    state = trainer.init_state(seed)
    probe_imgs, probe_labels = holdout_probe_sets()

    # batches cross to the device as uint8, a quarter of the float32 bytes,
    # and become model input there
    stream = prefetch_to_device(corpus_batches(images, labels, batch, seed=seed + 1),
                                depth=2, device=trainer.device)
    n_steps = 30 if probe else steps
    log_every = 10 if probe else LOG_EVERY
    t0 = time.time()
    t_window = t0
    history, losses, pending = [], [], []
    try:
        for step in range(n_steps):
            u8, y = next(stream)
            state, metrics = trainer.train_step(state, to_model_input(u8), y,
                                                trainer.dropout_generators(seed, step))
            pending.append(metrics["loss"].float())
            if (step + 1) % log_every == 0:
                # the window's one host read: every loss since the last read and
                # this step's accuracy
                read = torch.stack(pending + [metrics["accuracy"].float()]).cpu().tolist()
                losses.extend(read[:-1])
                pending = []
                loss, acc = losses[-1], read[-1]
                dt = (time.time() - t_window) / log_every * 1000
                t_window = time.time()
                line = (f"step {step + 1}/{n_steps}: loss {loss:.4f} "
                        f"top1 {acc:.3f} ({dt:.1f} ms/step)")
                if not probe and (step + 1) % PROBE_EVERY == 0:
                    sep = holdout_separation(embed_for_probe(trainer, state, probe_imgs),
                                             probe_labels)
                    line += (f"  holdout: g {sep['genuine_mean']:.3f} "
                             f"i {sep['impostor_mean']:.3f} EER {sep['eer']:.3f}")
                    history.append({"step": step + 1, "loss": loss, "train_top1": acc, **sep})
                    if (step + 1) % EXPORT_EVERY == 0 and (step + 1) < n_steps:
                        # a safety export: a half-hour run is not lost to a late fault
                        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
                        export_backbone(state, out + f".step{step + 1}")
                print(line, flush=True)
    finally:
        stream.close()  # stops the staging thread
    if pending:
        losses.extend(torch.stack(pending).cpu().tolist())

    if probe:
        print(f"probe done in {time.time() - t0:.0f}s")
        return trainer, state, None, losses

    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    export_backbone(state, out)
    meta = {
        "architecture": architecture,
        "n_identities": n_ids,
        "per_identity": per_id,
        "steps": steps,
        "batch": batch,
        "lr": lr,
        "loss": "adaface",
        "train_seconds": round(time.time() - t0, 1),
        "holdout_probe_history": history,
        "retrain": ("python examples/torch_train_open_set.py "
                    f"--architecture {architecture} --n_ids {n_ids} --per_id {per_id} "
                    f"--steps {steps} --batch {batch} --lr {lr} --warmup {warmup} "
                    f"--seed {seed}"),
    }
    with open(out.replace(".npz", ".meta.json"), "w") as f:
        json.dump(meta, f, indent=2)
    print(f"Exported {out} ({time.time() - t0:.0f}s total)")
    return trainer, state, meta, losses
