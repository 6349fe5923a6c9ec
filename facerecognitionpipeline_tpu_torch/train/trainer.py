"""The margin-softmax train step, on one device or over a mesh.

Counterpart of `facerecognitionpipeline_tpu/train/trainer.py`: a train-mode forward of the IR
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

Under a mesh (`Trainer(config, mesh)`, axes ('data', 'model'), one process
driving every device) the batch splits over 'data' and the classifier over
'model': `params['classifier']` (and its momentum trace) is a list of
n_model blocks [D, C/n_model], block j on the device of model index j.
Data shard i runs the backbone on its device (a replica of the parameters,
BatchNorm statistics of its own batch) and the logits of block j on the
device of mesh entry (i, j). The margin softmax is taken across the blocks:
the target cosine from the block that holds it, the global max, the sum of
the exponentials and the target logit summed over blocks. The loss is the
mean of the data shards' losses, differentiated as it is by autograd
(gradients land on each leaf's device), so no gradient factor for the model
axis is needed; the update runs per device over that device's leaves. The
running statistics are the mean of the shards' updates, `norm_mean` and
`norm_std` the means of the shards' `mean` and `std + eps`, and the loss and
accuracy the means over shards, as the JAX step's pmeans give them. Each
data shard draws its own dropout mask (`dropout_generators`). One device
runs the same step as one data shard and one class block.
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
from facerecognitionpipeline_tpu_torch.parallel.mesh import Mesh, replicate
from facerecognitionpipeline_tpu_torch.utils.device import resolve_device
from facerecognitionpipeline_tpu_torch.train.losses import (
    adaface_margin_cosine,
    arcface_margin_cosine,
    cosface_margin_cosine,
)

_EPS = 1e-7


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
    c = tree["classifier"]
    return [*tree["backbone"].values(), *(c if isinstance(c, list) else [c])]


def _tree(leaves: list, like: dict) -> dict:
    """`leaves` (in `_leaves` order) in the structure of `like`."""
    n = len(like["backbone"])
    c = leaves[n:] if isinstance(like["classifier"], list) else leaves[n]
    return {"backbone": dict(zip(like["backbone"], leaves[:n])), "classifier": c}


def _per_device(fn, params: list, grads: list, trace: list, lr, momentum: float,
                wd: float) -> tuple[list, list]:
    """`fn` (one of the SGD applies) on each device's leaves, the learning
    rate moved there; leaf order kept."""
    groups: dict = {}
    for i, p in enumerate(params):
        groups.setdefault(p.device, []).append(i)
    new_p, new_t = [None] * len(params), [None] * len(params)
    for dev, idx in groups.items():
        r = lr.to(dev) if isinstance(lr, torch.Tensor) else lr
        gp, gt = fn([params[i] for i in idx], [grads[i] for i in idx],
                    [trace[i] for i in idx], r, momentum, wd)
        for i, a, b in zip(idx, gp, gt):
            new_p[i], new_t[i] = a, b
    return new_p, new_t


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


def _promoted(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x in the type of x @ w under JAX's promotion: the float32 embeddings
    (the backbone casts before its norm) meet float64 weights as float64."""
    return x.to(torch.promote_types(x.dtype, w.dtype))


def dropout_generator(seed: int, step: int, device="cpu", shard: int = 0) -> torch.Generator:
    """A generator seeded from (seed, step): the dropout masks of step
    `step` of a run started with `seed`, whether or not it was resumed.
    `shard` > 0 seeds data shard `shard` of a mesh apart from the others
    (shard 0 draws what one device draws)."""
    entropy = [seed & 0xFFFFFFFF, step] + ([shard] if shard else [])
    mixed = np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(mixed) >> 1)


class Trainer:
    """Builds the state and runs the train step on one device or a mesh."""

    def __init__(self, config: TrainConfig, mesh=None, device="cuda"):
        if config.loss not in ("adaface", "arcface", "cosface"):
            raise ValueError(f"unknown loss: {config.loss}")
        self.config = config
        self.mesh = mesh
        self._schedule = make_schedule(config)
        if mesh is None:
            self.device = resolve_device(device)
        else:
            if config.num_classes % mesh.shape["model"]:
                raise ValueError(
                    f"num_classes={config.num_classes} must divide the mesh "
                    f"'model' axis ({mesh.shape['model']})"
                )
            self.device = mesh.first
        self.model = build_backbone(config.architecture,
                                    int8_fwd_train=config.int8_forward).to(self.device)
        # the shards the step runs: the mesh's, or one data shard and one
        # class block on this device
        self._grid = (mesh or Mesh([[self.device]], ("data", "model"))).devices
        self._data_devices = list(self._grid[:, 0])
        self._class_devices = list(self._grid[0, :])
        self._models = [replicate(self.model, d) for d in self._data_devices]

    # -------------------------------------------------------------- state

    def init_state(self, seed: int = 0) -> dict:
        """Parameters drawn as flax initialises them, in distribution:
        truncated lecun-normal kernels, zero biases, BatchNorm scale 1 and
        bias 0, PReLU alpha 0.25, running mean 0 and var 1; the classifier
        N(0, 1) * 0.01. The same numbers under a mesh, placed by
        `place_state`."""
        cfg = self.config
        g = torch.Generator().manual_seed(seed)
        model = build_backbone(cfg.architecture)
        lecun_truncated_normal_(model, g)
        classifier = torch.randn((cfg.embedding_dim, cfg.num_classes), generator=g) * 0.01
        params = {
            "backbone": {k: v.detach() for k, v in model.named_parameters()},
            "classifier": classifier,
        }
        batch_stats = {k: v.detach() for k, v in model.named_buffers()
                       if k.endswith((".running_mean", ".running_var"))}
        zero = lambda: torch.zeros((), dtype=torch.int32)  # noqa: E731
        trace = {"backbone": {k: torch.zeros_like(v) for k, v in params["backbone"].items()},
                 "classifier": torch.zeros_like(params["classifier"])}
        if cfg.fused_optimizer:
            opt_state = {"trace": trace, "count": zero()}
        else:
            sched = {} if cfg.lr_schedule == "constant" else {"count": zero()}
            opt_state = ({}, ({"trace": trace}, sched))
        return self.place_state({
            "params": params,
            "batch_stats": batch_stats,
            "opt_state": opt_state,
            "norm_ema": {"mean": torch.tensor(20.0), "std": torch.tensor(100.0)},
            "step": zero(),
        })

    def place_state(self, state: dict) -> dict:
        """A state in the one-device layout (e.g. from
        `models/convert.train_state_from_jax`) on this trainer's devices:
        everything on the first device, and under a mesh the classifier and
        its trace split into n_model blocks, block j on model index j's
        device. Parameters require grad."""
        def tree(t, classifier):
            return {"backbone": {k: v.to(self.device) for k, v in t["backbone"].items()},
                    "classifier": classifier(t["classifier"])}

        def blocks(c):
            if self.mesh is None:
                return c.to(self.device)
            if isinstance(c, list):
                return [b.to(d) for b, d in zip(c, self._class_devices)]
            n = len(self._class_devices)
            return [b.contiguous().to(d) for b, d in zip(c.chunk(n, dim=1), self._class_devices)]

        def on_device(x):
            if isinstance(x, dict):
                return {k: on_device(v) for k, v in x.items()}
            if isinstance(x, tuple):
                return tuple(on_device(v) for v in x)
            return x.to(self.device)

        opt = state["opt_state"]
        if isinstance(opt, dict):
            opt_state = {"trace": tree(opt["trace"], blocks), "count": on_device(opt["count"])}
        else:
            opt_state = ({}, ({"trace": tree(opt[1][0]["trace"], blocks)}, on_device(opt[1][1])))
        params = tree(state["params"], blocks)
        for p in _leaves(params):
            p.requires_grad_(True)
        return {
            "params": params,
            "batch_stats": on_device(state["batch_stats"]),
            "opt_state": opt_state,
            "norm_ema": on_device(state["norm_ema"]),
            "step": on_device(state["step"]),
        }

    def dropout_generators(self, seed: int, step: int):
        """The dropout generator(s) of step `step`: one on the trainer's
        device, or under a mesh one per data shard on its device."""
        if self.mesh is None:
            return dropout_generator(seed, step, self.device)
        return [dropout_generator(seed, step, d, shard=i)
                for i, d in enumerate(self._data_devices)]

    # ---------------------------------------------------------------- step

    def _margin(self, cos_t, norms, norm_mean, norm_std):
        cfg = self.config
        if cfg.loss == "arcface":
            return arcface_margin_cosine(cos_t, cfg.margin)
        if cfg.loss == "cosface":
            return cosface_margin_cosine(cos_t, cfg.margin)
        return adaface_margin_cosine(cos_t, norms, norm_mean, norm_std, cfg.margin, cfg.h)

    def _shards(self, x, name: str) -> list:
        """A batch-major input (array, tensor, or per-shard list from
        `prefetch_to_device(sharding=mesh)`) as one tensor per data shard
        on its device."""
        n = len(self._data_devices)
        if isinstance(x, (list, tuple)) and len(x) == n and all(
                isinstance(v, torch.Tensor) for v in x):
            return [v.to(d, non_blocking=True) for v, d in zip(x, self._data_devices)]
        x = torch.as_tensor(x)
        if x.shape[0] % n:
            raise ValueError(
                f"{name}: batch of {x.shape[0]} is not a multiple of the mesh "
                f"'data' axis ({n})"
            )
        per = x.shape[0] // n
        return [x[i * per:(i + 1) * per].to(d, non_blocking=True)
                for i, d in enumerate(self._data_devices)]

    def loss_and_grads(self, state: dict, images, labels, generator=None,
                       dropout_mask: Optional[torch.Tensor] = None):
        """The forward and backward of one step: (loss, aux, grads), grads
        shaped like state['params']; aux holds the accuracy, the norm
        statistics of the batch and, per data shard, each BatchNorm's
        (mean, var). Each data shard runs the backbone on its device against
        every class block: the margin softmax takes the target cosine from
        the block that owns it and the max, the sum of exponentials and the
        target logit across blocks, and is differentiated as the true
        global loss (no `/ n_model` as under shard_map); one device is one
        shard and one block."""
        if generator is None and dropout_mask is None:
            raise ValueError("train step: give a dropout generator or a dropout_mask")
        cfg = self.config
        home = self.device
        n_data = len(self._data_devices)
        images = self._shards(images, "images")
        labels = [y.long() for y in self._shards(labels, "labels")]
        masks = (self._shards(dropout_mask, "dropout_mask") if dropout_mask is not None
                 else [None] * n_data)
        gens = generator if isinstance(generator, (list, tuple)) else [generator]
        if generator is not None and len(gens) != n_data:
            raise ValueError(
                f"give one dropout generator per data shard ({n_data}; "
                f"Trainer.dropout_generators)"
            )
        if generator is None:
            gens = [None] * n_data
        params = state["params"]
        classifier = params["classifier"]
        blocks = classifier if isinstance(classifier, list) else [classifier]
        c_local = blocks[0].shape[1]
        ema = state["norm_ema"]
        losses, accs, means, stds, stats = [], [], [], [], []
        for i, dev in enumerate(self._data_devices):
            st: dict = {}
            bb = {k: v.to(dev) for k, v in params["backbone"].items()}
            feats, norms = torch.func.functional_call(
                self._models[i], bb, (images[i],),
                {"train": True, "dtype": cfg.dtype, "generator": gens[i],
                 "dropout_mask": masks[i], "stats": st},
            )
            norms = norms[:, 0]
            y = labels[i]
            cosines, onehots = [], []
            cos_t = torch.zeros_like(norms)
            for j, block in enumerate(blocks):
                d = self._grid[i, j]
                w = block.to(d)
                w = w / (torch.linalg.vector_norm(w, dim=0, keepdim=True) + _EPS)
                cosine = _promoted(feats.to(d), w) @ w
                local = y.to(d) - j * c_local
                in_shard = (local >= 0) & (local < c_local)
                safe = local.clamp(0, c_local - 1)
                t = torch.where(in_shard, cosine.gather(1, safe[:, None])[:, 0],
                                torch.zeros((), dtype=cosine.dtype, device=d))
                cos_t = cos_t + t.to(dev)
                cosines.append(cosine)
                onehots.append(F.one_hot(safe, c_local).to(cosine.dtype) * in_shard[:, None])
            phi = self._margin(cos_t, norms, ema["mean"].to(dev), ema["std"].to(dev))
            logits = [cfg.scale * torch.where(oh > 0, phi.to(c.device)[:, None], c)
                      for c, oh in zip(cosines, onehots)]
            gmax = torch.stack([lg.max(dim=1).values.detach().to(dev) for lg in logits]).amax(0)
            denom = sum(torch.exp(lg - gmax.to(lg.device)[:, None]).sum(dim=1).to(dev)
                        for lg in logits)
            target = sum((lg * oh).sum(dim=1).to(dev) for lg, oh in zip(logits, onehots))
            losses.append((torch.log(denom) + gmax - target).mean().to(home))
            with torch.no_grad():
                cmax = torch.stack([c.max(dim=1).values.to(dev) for c in cosines]).amax(0)
                accs.append((cos_t >= cmax - 1e-6).float().mean().to(home))
                means.append(norms.mean().to(home))
                stds.append((norms.std(correction=0) + _EPS).to(home))
            stats.append(st)
        loss = torch.stack(losses).mean()
        grads = torch.autograd.grad(loss, _leaves(params))
        aux = {
            "norm_mean": torch.stack(means).mean(),
            "norm_std": torch.stack(stds).mean(),
            "accuracy": torch.stack(accs).mean(),
            "stats": stats,
        }
        return loss.detach(), aux, _tree(list(grads), params)

    def apply_update(self, state: dict, grads: dict) -> tuple[dict, Any]:
        """The optimizer's update: (params, opt_state), new tensors, each
        device's leaves updated on that device; the state given is left as
        it was."""
        cfg = self.config
        opt = state["opt_state"]
        params = state["params"]
        with torch.no_grad():
            if cfg.fused_optimizer:
                count = opt["count"]
                lr = self._schedule(count) if callable(self._schedule) else self._schedule
                new_p, new_t = _per_device(fused_sgd_apply, _leaves(params), _leaves(grads),
                                           _leaves(opt["trace"]), lr, cfg.momentum,
                                           cfg.weight_decay)
                new_opt = {"trace": _tree(new_t, params), "count": count + 1}
            else:
                sched = opt[1][1]
                lr = self._schedule(sched["count"]) if sched else self._schedule
                new_p, new_t = _per_device(chain_sgd_apply, _leaves(params), _leaves(grads),
                                           _leaves(opt[1][0]["trace"]), lr, cfg.momentum,
                                           cfg.weight_decay)
                new_sched = {"count": sched["count"] + 1} if sched else {}
                new_opt = (opt[0], ({"trace": _tree(new_t, params)}, new_sched))
        for p in new_p:
            p.requires_grad_(True)
        return _tree(new_p, params), new_opt

    def train_step(self, state: dict, images, labels,
                   generator=None,
                   dropout_mask: Optional[torch.Tensor] = None):
        """One optimizer step. images [B,112,112,3] float32 in [-1, 1]
        (BGR), labels [B]; tensors or arrays (under a mesh also per-shard
        lists). `generator`: a torch.Generator, or under a mesh one per data
        shard (`dropout_generators`). Returns (new state, {'loss',
        'accuracy'}) with the metrics left on the device; `state` itself is
        left as it was."""
        loss, aux, grads = self.loss_and_grads(state, images, labels, generator, dropout_mask)
        params, opt_state = self.apply_update(state, grads)
        m, d = BN_MOMENTUM, self.config.ema_decay
        with torch.no_grad():
            bs = dict(state["batch_stats"])
            for name in aux["stats"][0]:
                for pos, suffix in ((0, "running_mean"), (1, "running_var")):
                    key = f"{name}.{suffix}"
                    old = state["batch_stats"][key]
                    new = [m * old + (1 - m) * st[name][pos].to(old.device)
                           for st in aux["stats"]]
                    bs[key] = torch.stack(new).mean(0)
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
