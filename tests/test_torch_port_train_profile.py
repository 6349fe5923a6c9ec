"""The training attribution and the int8-forward probe of the port
(`train/profile.py`, `examples/torch_train_{profile,int8_probe}.py`)
against the JAX package's examples (`examples/train_profile.py`,
`examples/train_int8_probe.py`), on the CPU at ir_micro.

The JAX package's train state (its `Trainer.init_state` on a (1, 1) mesh)
is carried into the port by `models/convert.py::train_state_from_jax`.

* the recomposed loss equals `Trainer.loss_and_grads`'s on the same state,
  batch and dropout generator (float32, 1e-6 relative; measured equal), and
  so do its gradients (1e-5 over every leaf together);
* it equals the JAX script's `loss_full` recomposition (`:126-151`) from
  the same state and dropout mask, both in float64 (1e-5 relative: the
  backbone's float32 cast before its norm bounds it above float64's
  rounding, as in `test_torch_port_train_numerics.py`);
* the `dummy_head` backbone gradients equal `jax.grad` of the script's
  `loss_dummy_head`, float64, every leaf within 1e-5 (the loss is the
  constant 1/512 of unit-norm features, so both are rounding);
* `converge` for 4 steps with the loss every 2, bf16 and with the int8
  forward, against the JAX trainer on the same state, batches and masks:
  each loss within CONVERGE_TOL relative (bf16 rounding and the int8
  forward's codes on rounding boundaries differ between the packages);
* `margins` are the differences of the p50s, a small `train_profile` has
  every key of the JAX report, and the committed reports
  (`reports/train_profile_torch/`) have the JAX reports' keys, falling
  losses and a loss check of 0;
* the scripts take the JAX scripts' flags plus `--device`.
"""

import argparse
import importlib.util
import json
import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from facerecognitionpipeline_tpu.models import irse as jirse
from facerecognitionpipeline_tpu.train.losses import adaface_margin_cosine
from facerecognitionpipeline_tpu.train.trainer import TrainConfig as JaxConfig
from facerecognitionpipeline_tpu.train.trainer import Trainer as JaxTrainer
from facerecognitionpipeline_tpu_torch.models.convert import (
    backbone_variables_from_state,
    train_state_from_jax,
)
from facerecognitionpipeline_tpu_torch.train import profile as P
from facerecognitionpipeline_tpu_torch.train.trainer import (
    TrainConfig,
    Trainer,
    dropout_generator,
)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = dict(architecture="ir_micro", num_classes=16, loss="adaface", learning_rate=0.05)
KEY = jax.random.PRNGKey(0)
_rng = np.random.default_rng(0)
X = _rng.uniform(-1, 1, (4, 112, 112, 3)).astype(np.float32)
Y = _rng.integers(0, 16, 4).astype(np.int32)
# `converge`'s losses against the JAX trainer's, relative, at lr 0.001:
# bf16 rounding differs between the packages from the first forward (loss
# 29.96 against 29.91), and the int8 forward's codes on rounding
# boundaries differ too (measured up to 1.5e-3 and 8.2e-3). At the script's
# lr 0.05 a batch of 4 diverges (the loss doubles in 3 steps) and amplifies
# them.
CONVERGE_LR = 1e-3
CONVERGE_TOL = {"bf16": 5e-3, "int8_fwd": 2e-2}


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _capture(masks):
    def interceptor(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if context.module.name == "output_dropout" and context.method_name == "__call__":
            jax.debug.callback(lambda v: masks.append(np.asarray(v) != 0), out)
        return out
    return interceptor


def _nchw(mask) -> torch.Tensor:
    return torch.from_numpy(mask).permute(0, 3, 1, 2).contiguous()


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


@pytest.fixture(scope="module")
def jax_state(mesh):
    """The JAX package's initial train state, with running statistics and a
    norm EMA of its own (one JAX step), as numpy."""
    jt = JaxTrainer(JaxConfig(**BASE), mesh)
    state, _ = jt.train_step(jt.init_state(0), X, Y, KEY)
    return jax.device_get(state)


def _port(state, **kw):
    trainer = Trainer(TrainConfig(**BASE, **kw), device="cpu")
    return trainer, trainer.place_state(train_state_from_jax(state))


def test_recomposed_loss_is_the_trainers(jax_state):
    trainer, state = _port(jax_state)
    got = P.recomposed_loss(trainer, state, torch.from_numpy(X), torch.from_numpy(Y),
                            dropout_generator(0, 0))
    want, _, grads = trainer.loss_and_grads(state, X, Y, dropout_generator(0, 0))
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-6)
    mine = P.loss_grads(trainer, state, torch.from_numpy(X), torch.from_numpy(Y),
                        dropout_generator(0, 0))
    theirs = [*grads["backbone"].values(), grads["classifier"]]
    diff = sum(float(((a - b) ** 2).sum()) for a, b in zip(mine, theirs)) ** 0.5
    assert diff <= 1e-5 * sum(float((b ** 2).sum()) for b in theirs) ** 0.5
    check = P.loss_check(trainer, state, torch.from_numpy(X), torch.from_numpy(Y))
    assert check["abs_diff"] <= 1e-6 * abs(check["trainer"])


def _f64(state: dict) -> dict:
    """The port state's parameters and norm EMA in float64."""
    params = {"backbone": {k: v.detach().double().requires_grad_(True)
                           for k, v in state["params"]["backbone"].items()},
              "classifier": state["params"]["classifier"].detach().double()
              .requires_grad_(True)}
    return {**state, "params": params,
            "norm_ema": {k: v.double() for k, v in state["norm_ema"].items()}}


@pytest.fixture(scope="module")
def jax_f64(jax_state):
    """The script's `loss_full` and `jax.grad(loss_dummy_head)`
    (`train_profile.py:126-162`) at float64 from the JAX state, with the
    dropout masks each drew."""
    cfg = JaxConfig(**BASE)
    with jax.enable_x64(True):
        f64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), jax_state)
        model = jirse.build_backbone("ir_micro", dtype=jnp.float64)
        params, batch_stats, norm_ema = f64["params"], f64["batch_stats"], f64["norm_ema"]
        images, labels = jnp.asarray(X, jnp.float64), jnp.asarray(Y)

        def loss_full(params, images):
            (feats, norms), mut = model.apply(
                {"params": params["backbone"], "batch_stats": batch_stats},
                images, train=True, rngs={"dropout": KEY}, mutable=["batch_stats"])
            norms = norms[:, 0]
            w = params["classifier"]
            w = w / (jnp.linalg.norm(w, axis=0, keepdims=True) + 1e-8)
            cosine = jnp.dot(feats, w, preferred_element_type=jnp.float32)
            cos_t = jnp.take_along_axis(cosine, labels[:, None], axis=1)[:, 0]
            phi = adaface_margin_cosine(cos_t, norms, norm_ema["mean"], norm_ema["std"],
                                        cfg.margin, cfg.h)
            onehot = jax.nn.one_hot(labels, cfg.num_classes, dtype=cosine.dtype)
            logits = cfg.scale * jnp.where(onehot > 0, phi[:, None], cosine)
            return jnp.mean(jax.nn.logsumexp(logits, axis=1)
                            - jnp.sum(logits * onehot, axis=1))

        def loss_dummy_head(params, images):
            (feats, norms), mut = model.apply(
                {"params": params["backbone"], "batch_stats": batch_stats},
                images, train=True, rngs={"dropout": KEY}, mutable=["batch_stats"])
            return jnp.mean(feats * feats)

        masks = []
        with nn.intercept_methods(_capture(masks)):
            loss = float(jax.jit(loss_full)(params, images))
            grads = jax.device_get(jax.jit(jax.grad(loss_dummy_head))(params, images))
            jax.effects_barrier()
    assert len(masks) == 2 and (masks[0] == masks[1]).all()
    return {"loss": loss, "grads": grads["backbone"], "mask": _nchw(masks[0])}


def test_recomposed_loss_matches_jax_in_float64(jax_state, jax_f64):
    trainer, state = _port(jax_state, dtype=torch.float64)
    got = P.recomposed_loss(trainer, _f64(state), torch.from_numpy(X).double(),
                            torch.from_numpy(Y), dropout_mask=jax_f64["mask"])
    assert got.dtype == torch.float64
    assert float(got.detach()) == pytest.approx(jax_f64["loss"], rel=1e-5)


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v, np.float64)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def test_dummy_head_gradients_match_jax_in_float64(jax_state, jax_f64):
    """mean(feats**2) of unit-norm features is the constant 1/512, in both
    packages: its gradients are rounding (measured below 2e-10 per leaf),
    so they are held equal absolutely, every leaf within 1e-5 of the other
    package's as of a unit loss's gradient. The backward still runs through
    the whole backbone, which is what the variant times."""
    trainer, state = _port(jax_state, dtype=torch.float64)
    state = _f64(state)
    grads = P.dummy_head_grads(trainer, state, torch.from_numpy(X).double(),
                               dropout_mask=jax_f64["mask"])
    named = dict(zip(state["params"]["backbone"], grads))
    got = _flat(backbone_variables_from_state({**named, **state["batch_stats"]})["params"])
    want = _flat(jax_f64["grads"])
    assert got.keys() == want.keys()
    for k in want:
        assert np.linalg.norm(got[k] - want[k]) <= 1e-5, k
        assert max(np.linalg.norm(got[k]), np.linalg.norm(want[k])) <= 1e-8, k


@pytest.mark.parametrize("name,int8", [("bf16", False), ("int8_fwd", True)])
def test_converge_matches_jax(mesh, name, int8):
    """The probe's loop for 4 steps (the loss every 2) on the JAX state and
    batches, with the masks the JAX steps drew."""
    kw = dict(BASE, int8_forward=int8, learning_rate=CONVERGE_LR)
    jt = JaxTrainer(JaxConfig(**kw, dtype=jnp.bfloat16), mesh)
    state = jax.device_get(jt.init_state(1))
    rng = np.random.default_rng(5)
    batches = [(rng.uniform(-1, 1, (4, 112, 112, 3)).astype(np.float32),
                rng.integers(0, 16, 4).astype(np.int32)) for _ in range(4)]
    masks, want, s = [], [], state
    with nn.intercept_methods(_capture(masks)):
        for i in range(4):
            x, y = batches[i % len(batches)]
            s, m = jt.train_step(s, x, y, KEY)
            if (i + 1) % 2 == 0:
                want.append(round(float(m["loss"]), 4))
        jax.effects_barrier()
    trainer = Trainer(TrainConfig(**kw, dtype=torch.bfloat16), device="cpu")
    port_state = trainer.place_state(train_state_from_jax(state))
    got = P.converge(trainer, port_state,
                     [(torch.from_numpy(x), torch.from_numpy(y)) for x, y in batches], 4,
                     every=2, masks=[_nchw(m) for m in masks])
    assert len(got) == len(want) == 2 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=CONVERGE_TOL[name], atol=0)
    # with the run's own dropout, the same loop from the same state
    own = P.converge(trainer, port_state, batches[:1], 2, every=1)
    assert len(own) == 2 and np.isfinite(own).all()


def test_margins_are_differences_of_the_p50s():
    p50 = {"full": 10.0, "no_opt": 8.5, "fwd_train": 3.25, "fwd_infer": 2.0,
           "dummy_head": 8.0}
    assert P.margins(p50) == {"optimizer+state": 1.5, "backward": 5.25, "head_fwd_bwd": 0.5,
                              "train_vs_infer_fwd": 1.25}


def _keys(tree, prefix="") -> set:
    out = set()
    for k, v in tree.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _keys(v, prefix + k + ".")
    return out


def _jax_report(name):
    with open(os.path.join(REPO, "reports", "train_profile", name)) as f:
        return json.load(f)


def test_train_profile_has_the_jax_reports_keys(monkeypatch):
    monkeypatch.setattr(P, "WARM", 0)
    monkeypatch.setattr(P, "CHAIN", 1)
    rep = P.train_profile(batch=2, arch="ir_micro", device="cpu", samples=1)
    assert _keys(_jax_report("ir_101_b128.json")) - {"sync"} <= _keys(rep)
    # margins from the unrounded p50s, as the script takes them
    for key, value in P.margins(rep["p50_ms"]).items():
        assert abs(rep["margins_ms"][key] - value) <= 0.011, key
    assert rep["sync"] == "host-clock" and rep["card"] is None
    assert rep["loss_check"]["abs_diff"] <= 1e-6 * abs(rep["loss_check"]["trainer"])


def test_measure_times_its_windows_after_the_warm_calls():
    calls = []
    assert P.measure(lambda: calls.append(1), samples=4, device="cpu") >= 0
    assert len(calls) == P.WARM + P.CHAIN * 4


def test_committed_profile_report():
    with open(os.path.join(REPO, "reports", "train_profile_torch", "ir_101_b128.json")) as f:
        rep = json.load(f)
    assert _keys(_jax_report("ir_101_b128.json")) <= _keys(rep)
    assert rep["arch"] == "ir_101" and rep["batch"] == 128 and rep["sync"] == "cuda-events"
    assert "H100" in rep["card"] and rep["loss_check"]["abs_diff"] == 0.0
    p50 = rep["p50_ms"]
    for key, value in P.margins(p50).items():
        assert abs(rep["margins_ms"][key] - value) <= 0.011, key


@pytest.mark.parametrize("name,steps", [("int8_probe.json", 200), ("int8_probe_ir101.json", 100)])
def test_committed_probe_reports(name, steps):
    with open(os.path.join(REPO, "reports", "train_profile_torch", name)) as f:
        rep = json.load(f)
    want = _jax_report(name)
    assert rep["arch"] == want["arch"] and rep["converge_steps"] == steps
    assert "H100" in rep["card"] and rep["sync"] == "cuda-events"
    for tier in ("bf16", "int8_fwd"):
        assert set(want[tier]) - {"sync_ok"} <= set(rep[tier])
        losses = rep[tier]["loss_every_25"]
        assert len(losses) == steps // 25 and np.isfinite(losses).all()
        assert losses[-1] < losses[0]
    assert rep["speedup_int8_fwd"] == round(
        rep["bf16"]["p50_step_ms"] / rep["int8_fwd"]["p50_step_ms"], 3)


def _dests(parser) -> dict:
    return {a.dest: a.default for a in parser._actions if a.dest != "help"}


def test_probe_script_takes_the_jax_scripts_flags_and_device(monkeypatch):
    class Parsed(Exception):
        pass

    def capture(self, *args, **kw):
        raise Parsed(self)

    jax_script, port = _load("train_int8_probe"), _load("torch_train_int8_probe")
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(Parsed) as caught:
        jax_script.main()
    monkeypatch.undo()
    want, got = _dests(caught.value.args[0]), _dests(port.build_parser())
    assert got.pop("device") == "cuda"
    assert got.pop("out") == "reports/train_profile_torch/int8_probe.json"
    want.pop("out")
    assert got == want


def test_profile_script_takes_batch_and_arch_and_device():
    port = _load("torch_train_profile")
    args = port.build_parser().parse_args([])
    assert (args.batch, args.arch, args.device) == (128, "ir_101", "cuda")
    args = port.build_parser().parse_args(["64", "ir_18", "--device", "cpu"])
    assert (args.batch, args.arch, args.device) == (64, "ir_18", "cpu")
