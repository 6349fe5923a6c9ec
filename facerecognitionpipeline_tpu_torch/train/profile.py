"""Marginal attribution of the train step, and the int8-forward probe.

Counterpart of `examples/train_profile.py:58-243` and
`examples/train_int8_probe.py:43-150`. The full step is the shipped
`Trainer.train_step`; each other variant is recomposed from the trainer's
own pieces (`Trainer.model` through `torch.func.functional_call`, the
normalised classifier, `Trainer._margin`, the log-sum-exp) and removes or
isolates one stage:

* full        the forward, backward, optimizer and running-stat update;
* no_opt      the gradients of the recomposed loss alone (the update and
              the state's rebuild removed): their margin;
* fwd_train   that loss under `torch.no_grad()` in train mode (the
              backward removed). The port's train forward never writes the
              running buffers: the batch statistics it normalises with go
              to a dict that is dropped, so nothing of the state changes and
              the variant costs what the loss costs;
* fwd_infer   the backbone alone in eval mode (running statistics, no
              dropout, no head), its parameters cast once to the compute
              dtype as the eval-mode backbone computes in its parameters'
              dtype;
* dummy_head  the backbone gradients of mean(feats**2) (the head's
              forward and backward removed);
* conv_microbench  8 bf16 3x3 128->128 convs with bias on [B, 128, 28, 28]
              in the backbone's layout (NCHW over channels-last memory, what
              its permute of an NHWC batch gives), forward and forward +
              backward, with the JAX script's operation count.

The recomposed loss is the trainer's loss: `loss_check` holds the two on
the same state, batch and dropout generator, so a drift between them shows
as a number and not as margins that stop adding up.

Timing: CUDA events around CHAIN chained calls on the same
device-resident batch, after WARM calls, `samples` windows, the median
per call (the host clock on the CPU). The full step replays the same state.
The JAX script corrects its walls for a host-to-chip round trip; a card has
none to correct, so the reports say "sync": "cuda-events".

The int8 probe (`int8_probe`): the bf16 step against the step with the
int8 forward (`TrainConfig(int8_forward=True)`), timed on a chain of real
steps, then `converge` from a fresh state over 4 batches, the loss every 25
steps, with the script's draws in its order.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from facerecognitionpipeline_tpu_torch.train.trainer import (
    _EPS,
    TrainConfig,
    Trainer,
    _promoted,
    dropout_generator,
)
from facerecognitionpipeline_tpu_torch.utils.device import card_line, chained_ms, resolve_device

CHAIN, SAMPLES, WARM = 5, 6, 2
PROFILE_CLASSES = 1024  # the JAX script's
CONV_LAYERS, CONV_CH, CONV_HW = 8, 128, 28


def measure(fn: Callable, samples: int = SAMPLES, device="cuda") -> float:
    """Median ms of one call of `fn` over `samples` windows of CHAIN
    chained calls, after WARM calls: CUDA events on the current stream, or
    the host clock on the CPU."""
    return float(np.percentile(chained_ms(fn, samples, CHAIN, WARM, device), 50))


# ------------------------------------------------------------- the pieces


def _features(trainer: Trainer, params: dict, images, generator, dropout_mask):
    """The train-mode backbone; its batch statistics go to a dict that is
    dropped (the trainer, not the forward, updates the running ones)."""
    return torch.func.functional_call(
        trainer.model, params["backbone"], (images,),
        {"train": True, "dtype": trainer.config.dtype, "generator": generator,
         "dropout_mask": dropout_mask, "stats": {}})


def recomposed_loss(trainer: Trainer, state: dict, images, labels, generator=None,
                    dropout_mask=None) -> torch.Tensor:
    """The trainer's margin-softmax loss on one device, recomposed: the
    train-mode backbone, the classifier normalised per column (the
    trainer's eps), the margin on the target cosine, `scale` times the
    logits into a log-sum-exp cross-entropy."""
    cfg = trainer.config
    params = state["params"]
    feats, norms = _features(trainer, params, images, generator, dropout_mask)
    norms = norms[:, 0]
    labels = labels.long()
    w = params["classifier"]
    w = w / (torch.linalg.vector_norm(w, dim=0, keepdim=True) + _EPS)
    cosine = _promoted(feats, w) @ w
    cos_t = cosine.gather(1, labels[:, None])[:, 0]
    ema = state["norm_ema"]
    phi = trainer._margin(cos_t, norms, ema["mean"], ema["std"])
    onehot = F.one_hot(labels, cfg.num_classes).to(cosine.dtype)
    logits = cfg.scale * torch.where(onehot > 0, phi[:, None], cosine)
    return (torch.logsumexp(logits, dim=1) - (logits * onehot).sum(dim=1)).mean()


def dummy_head_loss(trainer: Trainer, state: dict, images, generator=None,
                    dropout_mask=None) -> torch.Tensor:
    """mean(feats**2) of the train-mode backbone: the head removed."""
    feats, _ = _features(trainer, state["params"], images, generator, dropout_mask)
    return (feats * feats).mean()


def _leaves(tree: dict) -> list:
    return [*tree["backbone"].values(), tree["classifier"]]


def loss_grads(trainer, state, images, labels, generator=None, dropout_mask=None) -> tuple:
    """Gradients of the recomposed loss for every parameter leaf
    (backbone in module order, then the classifier)."""
    loss = recomposed_loss(trainer, state, images, labels, generator, dropout_mask)
    return torch.autograd.grad(loss, _leaves(state["params"]))


def dummy_head_grads(trainer, state, images, generator=None, dropout_mask=None) -> tuple:
    """The backbone's gradients of `dummy_head_loss`, in module order."""
    loss = dummy_head_loss(trainer, state, images, generator, dropout_mask)
    return torch.autograd.grad(loss, list(state["params"]["backbone"].values()))


def infer_features(trainer: Trainer, variables: dict, images) -> torch.Tensor:
    """The backbone in eval mode on `variables` (parameters and running
    statistics, in the dtype to compute in)."""
    model, was_training = trainer.model, trainer.model.training
    model.eval()  # the BatchNorm modules on their running statistics
    try:
        with torch.no_grad():
            return torch.func.functional_call(model, variables, (images,), {"train": False})[0]
    finally:
        model.train(was_training)


def loss_check(trainer: Trainer, state: dict, images, labels) -> dict:
    """The recomposed loss against `Trainer.loss_and_grads`'s on the same
    state, batch and dropout generator."""
    with torch.no_grad():
        got = recomposed_loss(trainer, state, images, labels,
                              dropout_generator(0, 0, trainer.device))
    want, _, _ = trainer.loss_and_grads(state, images, labels,
                                        dropout_generator(0, 0, trainer.device))
    got, want = float(got), float(want)
    return {"trainer": want, "recomposed": got, "abs_diff": abs(got - want)}


# ------------------------------------------------------------ the variants


def conv_microbench(batch: int, device, samples: int = SAMPLES) -> dict:
    """The JAX script's conv stack (8 3x3 convs 128->128 with bias on
    [B, 28, 28, 128]) in the backbone's layout, forward (sum of squares)
    and forward + backward (the convs' parameter gradients)."""
    g = torch.Generator().manual_seed(0)
    convs = torch.nn.Sequential(*[torch.nn.Conv2d(CONV_CH, CONV_CH, 3, padding=1)
                                  for _ in range(CONV_LAYERS)]).to(device, torch.bfloat16)
    x = torch.randn((batch, CONV_HW, CONV_HW, CONV_CH), generator=g).to(device, torch.bfloat16)
    x = x.permute(0, 3, 1, 2)  # NCHW over NHWC memory, as the backbone's input

    def fwd():
        with torch.no_grad():
            return (convs(x).float() ** 2).sum()

    params = list(convs.parameters())

    def fwd_bwd():
        return torch.autograd.grad((convs(x).float() ** 2).sum(), params)

    t_fwd = measure(fwd, samples=samples, device=device)
    t_bwd = measure(fwd_bwd, samples=samples, device=device)
    flops = CONV_LAYERS * 2 * batch * CONV_HW * CONV_HW * 9 * CONV_CH * CONV_CH
    return {
        "fwd_ms": round(t_fwd, 2),
        "fwd_bwd_ms": round(t_bwd, 2),
        "fwd_tfs": round(flops / t_fwd / 1e9, 1),
        "fwd_bwd_tfs": round(3 * flops / t_bwd / 1e9, 1),
        "bwd_over_fwd": round((t_bwd - t_fwd) / (2 * t_fwd), 2),
    }


def margins(p50: dict) -> dict:
    """The JAX script's margins: differences of the variants' p50."""
    return {
        "optimizer+state": round(p50["full"] - p50["no_opt"], 2),
        "backward": round(p50["no_opt"] - p50["fwd_train"], 2),
        "head_fwd_bwd": round(p50["no_opt"] - p50["dummy_head"], 2),
        "train_vs_infer_fwd": round(p50["fwd_train"] - p50["fwd_infer"], 2),
    }


def train_profile(batch: int = 128, arch: str = "ir_101", device="cuda",
                  samples: int = SAMPLES) -> dict:
    """`examples/train_profile.py`'s report on the port (1024 classes,
    AdaFace, bf16): every variant's p50 ms under the JAX keys, the margins,
    the loss check and the card."""
    device = resolve_device(device)
    cfg = TrainConfig(architecture=arch, num_classes=PROFILE_CLASSES, loss="adaface",
                      dtype=torch.bfloat16)
    trainer = Trainer(cfg, device=device)
    state = trainer.init_state(0)
    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(rng.normal(0, 0.5, size=(batch, 112, 112, 3))
                            .astype(np.float32).clip(-1, 1)).to(device)
    labels = torch.from_numpy(rng.integers(0, cfg.num_classes, size=batch)
                              .astype(np.int32)).to(device)
    gen = dropout_generator(0, 0, device)
    results = {}

    def timed(fn):
        return measure(fn, samples=samples, device=device)

    # the full step replays the same state: timing is value-independent
    results["full"] = timed(lambda: trainer.train_step(state, imgs, labels, gen))
    results["no_opt"] = timed(lambda: loss_grads(trainer, state, imgs, labels, gen))

    def fwd_train():
        with torch.no_grad():
            return recomposed_loss(trainer, state, imgs, labels, gen)

    results["fwd_train"] = timed(fwd_train)
    variables = {k: v.detach().to(cfg.dtype) for k, v in
                 {**state["params"]["backbone"], **state["batch_stats"]}.items()}
    results["fwd_infer"] = timed(lambda: infer_features(trainer, variables, imgs))
    del variables
    results["dummy_head"] = timed(lambda: dummy_head_grads(trainer, state, imgs, gen))
    check = loss_check(trainer, state, imgs, labels)
    results["conv_microbench"] = conv_microbench(batch, device, samples)
    p50 = {k: (round(v, 2) if isinstance(v, float) else v) for k, v in results.items()}
    return {
        "batch": batch,
        "arch": arch,
        "p50_ms": p50,
        "margins_ms": margins(results),
        "sync": "cuda-events" if device.type == "cuda" else "host-clock",
        "dtype": str(cfg.dtype).replace("torch.", ""),
        "chain": CHAIN,
        "warm": WARM,
        "samples": samples,
        "loss_check": check,
        "card": card_line(device),
    }


# -------------------------------------------------------- the int8 probe


def converge(trainer: Trainer, state: dict, batches: list, steps: int, every: int = 25,
             masks: Optional[list] = None) -> list:
    """`steps` train steps cycling over `batches` from `state`; the loss
    after every `every`-th step, rounded to 4 places as the script rounds
    it. Dropout from `dropout_generator(0, step)`, or the masks given (one
    per step, for parity checks)."""
    losses = []
    for i in range(steps):
        x, y = batches[i % len(batches)]
        if masks is None:
            state, m = trainer.train_step(state, x, y, dropout_generator(0, i, trainer.device))
        else:
            state, m = trainer.train_step(state, x, y, dropout_mask=masks[i])
        if (i + 1) % every == 0:
            losses.append(round(float(m["loss"]), 4))
    return losses


def int8_probe(arch: str = "ir_18", batch: int = 128, classes: int = 256,
               converge_steps: int = 200, device="cuda") -> dict:
    """`examples/train_int8_probe.py`'s report on the port: bf16 and the
    int8 forward, each p50 over a chain of steps and its losses, and the
    speed-up of the int8 forward."""
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.uniform(-1, 1, size=(batch, 112, 112, 3))
                              .astype(np.float32)).to(device)
    labels = torch.from_numpy(rng.integers(0, classes, size=(batch,))
                              .astype(np.int32)).to(device)
    report = {"arch": arch, "batch": batch}
    for name, int8 in (("bf16", False), ("int8_fwd", True)):
        trainer = Trainer(TrainConfig(architecture=arch, num_classes=classes, loss="adaface",
                                      learning_rate=0.05, dtype=torch.bfloat16,
                                      int8_forward=int8), device=device)
        box = [trainer.init_state(0)]
        step = [0]

        def one():
            box[0], _ = trainer.train_step(box[0], images, labels,
                                           dropout_generator(0, step[0], device))
            step[0] += 1

        p50 = measure(one, device=device)
        # the script draws 4 batches per configuration from the one rng
        batches = []
        for _ in range(4):
            batches.append((
                torch.from_numpy(rng.uniform(-1, 1, size=(batch, 112, 112, 3))
                                 .astype(np.float32)).to(device),
                torch.from_numpy(rng.integers(0, classes, size=(batch,))
                                 .astype(np.int32)).to(device),
            ))
        losses = converge(trainer, trainer.init_state(1), batches, converge_steps)
        report[name] = {"p50_step_ms": round(p50, 2),
                        "imgs_per_sec": round(batch / (p50 / 1000), 1),
                        "loss_every_25": losses}
        print(f"{name}: p50 {p50:.2f} ms/step ({batch / (p50 / 1000):.0f} imgs/s) "
              f"loss {losses[:3]} ... {losses[-2:]}", flush=True)
        del trainer, box, batches
        if device.type == "cuda":
            torch.cuda.empty_cache()
    a, b = report["bf16"]["p50_step_ms"], report["int8_fwd"]["p50_step_ms"]
    report["speedup_int8_fwd"] = round(a / b, 3)
    report["sync"] = "cuda-events" if device.type == "cuda" else "host-clock"
    report["converge_steps"] = converge_steps
    report["card"] = card_line(device)
    return report
