"""The margin-softmax train step on one card.

Counterpart of `facerecognitionpipeline_tpu/train/trainer.py` with its
model axis at 1 and its data axis at 1: a train-mode forward of the IR
backbone (`models/irse.py`), the classifier [D, C] normalised per column,
the margin (AdaFace, ArcFace or CosFace, `train/losses.py`) on the target
cosine only, `scale * logits` into a max-shifted log-sum-exp cross-entropy,
SGD with momentum and weight decay on every leaf (BatchNorm scale and bias,
PReLU alpha and the classifier too), then flax's BatchNorm running-stat
update and AdaFace's norm EMA.

The state is a dict of tensors on the trainer's device, in the port's
layout (`models/convert.py::train_state_from_jax` / `train_state_to_jax`
carry it to and from the JAX package's):

  params       {'backbone': {module parameter name: tensor}, 'classifier': [D, C]}
  batch_stats  {'<bn>.running_mean' | '<bn>.running_var': tensor}
  opt_state    fused: {'trace': like params, 'count': int32 []}
               unfused (optax.chain(add_decayed_weights, sgd)):
               ({}, ({'trace': like params}, {'count': int32 []} or {}))
  norm_ema     {'mean': [], 'std': []}
  step         int32 []

`train_step` returns a new state and leaves the one it was given as it was,
as the JAX step does: a state kept from before a step can be compared with
the one after or restored. The dropout mask of a step comes from the `torch.Generator` given
(`dropout_generator(seed, step)` seeds one from the run's seed and the
step, so a resumed run draws what an uninterrupted one would), or is handed
in (`dropout_mask`, for parity checks).

Not on one card: a mesh, a model axis above 1 and the class-sharded head
raise NotImplementedError (ROADMAP.md item 17, queue 1, multi-GPU).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from facerecognitionpipeline_tpu_torch.models.irse import BN_MOMENTUM, build_backbone
from facerecognitionpipeline_tpu_torch.models.layers import lecun_truncated_normal_
from facerecognitionpipeline_tpu_torch.ops.numerics import div
from facerecognitionpipeline_tpu_torch.train.losses import (
    adaface_margin_cosine,
    arcface_margin_cosine,
    cosface_margin_cosine,
)
from facerecognitionpipeline_tpu_torch.utils.device import resolve_device

_EPS = 1e-7
MULTI_GPU = "ROADMAP.md item 17 (queue 1, multi-GPU)"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    architecture: str = "ir_50"
    num_classes: int = 1024
    embedding_dim: int = 512
    loss: str = "adaface"          # adaface | arcface | cosface
    margin: float = 0.4
    scale: float = 64.0
    h: float = 0.333               # adaface norm-sensitivity
    learning_rate: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 5e-4
    ema_decay: float = 0.99        # adaface norm-stat EMA
    dtype: Any = torch.float32     # compute dtype; parameters stay float32
    # 'constant', 'cosine' (to 0 over total_steps after a linear warmup) or
    # 'step' (x0.1 at 0.6, 0.8 and 0.9 of total_steps)
    lr_schedule: str = "constant"
    total_steps: int = 10_000
    warmup_steps: int = 0
    # res convs with an int8 forward (dynamic scales) and a float backward
    # (models/irse.py::Int8FwdConv); the parameters are the same
    int8_forward: bool = False
    # one foreach chain over every leaf; False runs the add-decay -> trace ->
    # scale -> apply chain of optax with its own state structure
    fused_optimizer: bool = True


# --------------------------------------------------------------- schedules
# optax's formulas, in float32 on the count's device.


def _linear(init: float, end: float, steps: int):
    """optax.linear_schedule (polynomial_schedule, power 1, begin 0)."""
    if steps <= 0:
        return lambda count: init

    def schedule(count):
        c = count.clamp(0, steps).to(torch.float32)
        frac = 1 - div(c, float(steps))
        return (init - end) * frac + end
    return schedule


def _cosine(init: float, decay_steps: int, alpha: float = 0.0):
    """optax.cosine_decay_schedule (exponent 1)."""
    if not decay_steps > 0:
        raise ValueError(
            "The cosine_decay_schedule requires positive decay_steps, got "
            f"decay_steps={decay_steps}."
        )

    def schedule(count):
        c = count.to(torch.float32).clamp_max(float(decay_steps))
        cosine = 0.5 * (1 + torch.cos(div(math.pi * c, float(decay_steps))))
        return init * ((1 - alpha) * cosine + alpha)
    return schedule


def _piecewise_constant(init: float, boundaries_and_scales: dict):
    """optax.piecewise_constant_schedule."""
    def schedule(count):
        v = torch.full((), init, dtype=torch.float32, device=count.device)
        for threshold, scale in sorted(boundaries_and_scales.items()):
            indicator = torch.sign(threshold - count).to(torch.float32).clamp_min(0.0)
            v = v * indicator + (1 - indicator) * scale * v
        return v
    return schedule


def _join(schedules, boundaries):
    """optax.join_schedules."""
    def schedule(count):
        out = schedules[0](count)
        for boundary, nxt in zip(boundaries, schedules[1:]):
            out = torch.where(count < boundary, out, nxt(count - boundary))
        return out
    return schedule


def make_schedule(cfg: TrainConfig):
    """The learning rate as a function of the optimizer's int32 count
    tensor (a float for 'constant'), as the JAX package's
    `Trainer._make_schedule` builds it with optax."""
    if cfg.lr_schedule == "cosine":
        if cfg.warmup_steps > 0:
            return _join(
                [_linear(0.0, cfg.learning_rate, cfg.warmup_steps),
                 _cosine(cfg.learning_rate, cfg.total_steps - cfg.warmup_steps)],
                [cfg.warmup_steps],
            )
        return _cosine(cfg.learning_rate, cfg.total_steps)
    if cfg.lr_schedule == "step":
        # x0.1 at 12/20, 16/20, 18/20 of the run (the AdaFace recipe); the
        # joined schedule sees step - warmup, so the milestones shift left
        milestones = {
            max(1, int(cfg.total_steps * f) - cfg.warmup_steps): 0.1
            for f in (0.6, 0.8, 0.9)
        }
        base = _piecewise_constant(cfg.learning_rate, milestones)
        if cfg.warmup_steps > 0:
            return _join([_linear(0.0, cfg.learning_rate, cfg.warmup_steps), base],
                         [cfg.warmup_steps])
        return base
    if cfg.lr_schedule != "constant":
        raise ValueError(f"unknown lr_schedule: {cfg.lr_schedule}")
    return cfg.learning_rate


# --------------------------------------------------------------- optimizer


def _leaves(tree) -> list:
    return [*tree["backbone"].values(), tree["classifier"]]


def _tree(leaves: list, like: dict) -> dict:
    """`leaves` (in `_leaves` order) in the structure of `like`."""
    n = len(like["backbone"])
    return {"backbone": dict(zip(like["backbone"], leaves[:n])), "classifier": leaves[n]}


def fused_sgd_apply(params: list, grads: list, trace: list, lr, momentum: float,
                    wd: float) -> tuple[list, list]:
    """mu' = momentum * mu + (g + wd * p);  p' = p - lr * mu' over every
    leaf, as one foreach chain (the JAX package's `_fused_sgd_apply`).
    Returns (p', mu'); the lists given are left as they were."""
    d = torch._foreach_mul(params, wd)
    torch._foreach_add_(d, grads)
    new_trace = torch._foreach_mul(trace, momentum)
    torch._foreach_add_(new_trace, d)
    return torch._foreach_sub(params, torch._foreach_mul(new_trace, lr)), new_trace


def chain_sgd_apply(params: list, grads: list, trace: list, lr, momentum: float,
                    wd: float) -> tuple[list, list]:
    """optax.chain(add_decayed_weights(wd), sgd(lr, momentum)) and
    apply_updates, pass by pass: u = g + wd * p; mu' = u + momentum * mu;
    u = (-lr) * mu'; p' = p + u. Returns (p', mu'), equal to
    `fused_sgd_apply`'s bit for bit; the lists given are left as they were."""
    u = torch._foreach_mul(params, wd)
    torch._foreach_add_(u, grads)
    new_trace = torch._foreach_add(u, torch._foreach_mul(trace, momentum))
    return torch._foreach_add(params, torch._foreach_mul(new_trace, -lr)), new_trace


def dropout_generator(seed: int, step: int, device="cpu") -> torch.Generator:
    """A generator seeded from (seed, step): the dropout masks of step
    `step` of a run started with `seed`, whether or not it was resumed."""
    mixed = np.random.SeedSequence([seed & 0xFFFFFFFF, step]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(mixed) >> 1)


class Trainer:
    """Builds the state and runs the train step on one device."""

    def __init__(self, config: TrainConfig, mesh=None, device="cuda"):
        if mesh is not None:
            raise NotImplementedError(
                f"Trainer(mesh=...): the data/model mesh and the class-sharded "
                f"head are not ported; {MULTI_GPU}"
            )
        if config.loss not in ("adaface", "arcface", "cosface"):
            raise ValueError(f"unknown loss: {config.loss}")
        self.config = config
        self.device = resolve_device(device)
        self._schedule = make_schedule(config)
        self.model = build_backbone(config.architecture,
                                    int8_fwd_train=config.int8_forward).to(self.device)

    # -------------------------------------------------------------- state

    def init_state(self, seed: int = 0) -> dict:
        """Parameters drawn as flax initialises them, in distribution:
        truncated lecun-normal kernels, zero biases, BatchNorm scale 1 and
        bias 0, PReLU alpha 0.25, running mean 0 and var 1; the classifier
        N(0, 1) * 0.01."""
        cfg = self.config
        g = torch.Generator().manual_seed(seed)
        model = build_backbone(cfg.architecture)
        lecun_truncated_normal_(model, g)
        classifier = torch.randn((cfg.embedding_dim, cfg.num_classes), generator=g) * 0.01
        dev = self.device
        params = {
            "backbone": {k: v.detach().to(dev) for k, v in model.named_parameters()},
            "classifier": classifier.to(dev),
        }
        batch_stats = {k: v.detach().to(dev) for k, v in model.named_buffers()
                       if k.endswith((".running_mean", ".running_var"))}
        zero = lambda: torch.zeros((), dtype=torch.int32, device=dev)  # noqa: E731
        trace = {"backbone": {k: torch.zeros_like(v) for k, v in params["backbone"].items()},
                 "classifier": torch.zeros_like(params["classifier"])}
        if cfg.fused_optimizer:
            opt_state = {"trace": trace, "count": zero()}
        else:
            sched = {} if cfg.lr_schedule == "constant" else {"count": zero()}
            opt_state = ({}, ({"trace": trace}, sched))
        for p in _leaves(params):
            p.requires_grad_(True)
        return {
            "params": params,
            "batch_stats": batch_stats,
            "opt_state": opt_state,
            "norm_ema": {"mean": torch.tensor(20.0, device=dev),
                         "std": torch.tensor(100.0, device=dev)},
            "step": zero(),
        }

    # ---------------------------------------------------------------- step

    def _margin(self, cos_t, norms, norm_mean, norm_std):
        cfg = self.config
        if cfg.loss == "arcface":
            return arcface_margin_cosine(cos_t, cfg.margin)
        if cfg.loss == "cosface":
            return cosface_margin_cosine(cos_t, cfg.margin)
        return adaface_margin_cosine(cos_t, norms, norm_mean, norm_std, cfg.margin, cfg.h)

    def _inputs(self, images, labels):
        images = torch.as_tensor(images).to(self.device, non_blocking=True)
        labels = torch.as_tensor(labels).to(self.device, non_blocking=True).long()
        return images, labels

    def loss_and_grads(self, state: dict, images, labels,
                       generator: Optional[torch.Generator] = None,
                       dropout_mask: Optional[torch.Tensor] = None):
        """The forward and backward of one step: (loss, aux, grads), grads
        shaped like state['params']; aux holds the accuracy, the norm
        statistics of the batch and each BatchNorm's (mean, var)."""
        if generator is None and dropout_mask is None:
            raise ValueError("train step: give a dropout generator or a dropout_mask")
        cfg = self.config
        images, labels = self._inputs(images, labels)
        params = state["params"]
        stats: dict = {}
        feats, norms = torch.func.functional_call(
            self.model, params["backbone"], (images,),
            {"train": True, "dtype": cfg.dtype, "generator": generator,
             "dropout_mask": dropout_mask, "stats": stats},
        )
        norms = norms[:, 0]
        w = params["classifier"]
        w = w / (torch.linalg.vector_norm(w, dim=0, keepdim=True) + _EPS)
        cosine = feats @ w
        cos_t = cosine.gather(1, labels[:, None])[:, 0]
        ema = state["norm_ema"]
        phi = self._margin(cos_t, norms, ema["mean"], ema["std"])
        onehot = F.one_hot(labels, cosine.shape[1]).to(cosine.dtype)
        logits = cfg.scale * torch.where(onehot > 0, phi[:, None], cosine)
        gmax = logits.max(dim=1).values.detach()
        denom = torch.exp(logits - gmax[:, None]).sum(dim=1)
        target_logit = (logits * onehot).sum(dim=1)
        loss = (torch.log(denom) + gmax - target_logit).mean()
        leaves = _leaves(params)
        grads = torch.autograd.grad(loss, leaves)
        n = len(params["backbone"])
        with torch.no_grad():
            aux = {
                "norm_mean": norms.mean(),
                "norm_std": norms.std(correction=0) + _EPS,
                "accuracy": (cos_t >= cosine.max(dim=1).values - 1e-6).float().mean(),
                "stats": stats,
            }
        grads = {"backbone": dict(zip(params["backbone"], grads[:n])), "classifier": grads[n]}
        return loss.detach(), aux, grads

    def apply_update(self, state: dict, grads: dict) -> tuple[dict, Any]:
        """The optimizer's update: (params, opt_state), new tensors; the state
        given is left as it was."""
        cfg = self.config
        opt = state["opt_state"]
        params = state["params"]
        with torch.no_grad():
            if cfg.fused_optimizer:
                count = opt["count"]
                lr = self._schedule(count) if callable(self._schedule) else self._schedule
                new_p, new_t = fused_sgd_apply(_leaves(params), _leaves(grads),
                                               _leaves(opt["trace"]), lr, cfg.momentum,
                                               cfg.weight_decay)
                new_opt = {"trace": _tree(new_t, params), "count": count + 1}
            else:
                sched = opt[1][1]
                lr = self._schedule(sched["count"]) if sched else self._schedule
                new_p, new_t = chain_sgd_apply(_leaves(params), _leaves(grads),
                                               _leaves(opt[1][0]["trace"]), lr, cfg.momentum,
                                               cfg.weight_decay)
                new_sched = {"count": sched["count"] + 1} if sched else {}
                new_opt = (opt[0], ({"trace": _tree(new_t, params)}, new_sched))
        for p in new_p:
            p.requires_grad_(True)
        return _tree(new_p, params), new_opt

    def train_step(self, state: dict, images, labels,
                   generator: Optional[torch.Generator] = None,
                   dropout_mask: Optional[torch.Tensor] = None):
        """One optimizer step. images [B,112,112,3] float32 in [-1, 1]
        (BGR), labels [B]; tensors or arrays. Returns (new state, {'loss',
        'accuracy'}) with the metrics left on the device; `state` itself is
        left as it was."""
        loss, aux, grads = self.loss_and_grads(state, images, labels, generator, dropout_mask)
        params, opt_state = self.apply_update(state, grads)
        m, d = BN_MOMENTUM, self.config.ema_decay
        with torch.no_grad():
            bs = dict(state["batch_stats"])
            for name, (mean, var) in aux["stats"].items():
                for key, v in ((f"{name}.running_mean", mean), (f"{name}.running_var", var)):
                    bs[key] = m * bs[key] + (1 - m) * v
            ema = state["norm_ema"]
            new_state = {
                "params": params,
                "batch_stats": bs,
                "opt_state": opt_state,
                "norm_ema": {"mean": d * ema["mean"] + (1 - d) * aux["norm_mean"],
                             "std": d * ema["std"] + (1 - d) * aux["norm_std"]},
                "step": state["step"] + 1,
            }
        return new_state, {"loss": loss, "accuracy": aux["accuracy"]}
