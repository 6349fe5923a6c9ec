"""The port's trainer against the JAX package's, on the CPU, at ir_micro.

The same initial state (the port's, carried over by
`models/convert.py::train_state_to_jax` / `train_state_from_jax`), the
same batch and the same dropout mask (captured from the JAX step with
`flax.linen.intercept_methods` and a debug callback: the mask is where the
dropout's output is not 0) go through the JAX `Trainer.train_step` on a
(1, 1) mesh and the port's `Trainer.train_step`, one step and three, for
the AdaFace (step schedule with warmup), ArcFace (constant) and CosFace
(cosine) heads, in float32.

Tolerances, and why they are not tighter:
* loss: 1e-5 relative after one step (measured up to 2e-7), 5e-4 after
  three (measured up to 8e-5);
* gradients of the first step: over every leaf together, ||port - jax||
  <= 1e-3 ||jax|| (measured 4e-4); per leaf 1e-2 relative (measured up to
  3.3e-3) for leaves whose gradient is not ~0. The float32 gradients of the
  layers below stage 2 are themselves only that accurate: the port's
  float32 gradient differs from its own float64 one by the same amount.
  `test_torch_port_train_numerics.py` holds the two packages' train-mode
  gradients in float64, which pins the semantics;
* momentum traces: as gradients after one step; after three, 1e-2 over
  every leaf and 5e-2 per leaf (measured 2.7e-3 and 1.8e-2: the third
  step's gradient is taken at parameters that already differ);
* parameters: 1e-3 absolute after one step, 3e-3 after three (measured
  up to 3.6e-4 and 9.8e-4): the learning rate, 0.05, times those gradient
  differences; momentum traces as gradients;
* batch_stats and norm_ema: ||port - jax|| <= r ||jax|| + 1e-5 sqrt(n) per
  leaf, r = 1e-3 after one step and 5e-3 after three (measured up to 8.5e-5
  and 1.4e-3); the floor covers running means that are ~0 by construction
  (the mean of a sum of two zero-bias BatchNorm outputs).

Also: the margins (values and gradients), every schedule at every step
against optax, the fused update against the unfused chain bit for bit, the
int8-forward conv (codes with counted off-by-one flips, s32 sums exact,
the float conv's VJP), the bf16 step held loosely to the float32 one, the
fused int8 body against the JAX `FusedQuantBody` (its constants bit for
bit), and the train-state conversions both ways.
"""

import jax
import jax.numpy as jnp
import flax.linen as nn
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from facerecognitionpipeline_tpu.models import irse as jirse
from facerecognitionpipeline_tpu.models import quantize as jq
from facerecognitionpipeline_tpu.models.fold import fold_inference_variables as jax_fold
from facerecognitionpipeline_tpu.ops.image import preprocess_faces as jax_preprocess
from facerecognitionpipeline_tpu.train import losses as jlosses
from facerecognitionpipeline_tpu.train.trainer import TrainConfig as JaxConfig
from facerecognitionpipeline_tpu.train.trainer import Trainer as JaxTrainer
from facerecognitionpipeline_tpu_torch.models import irse as tirse
from facerecognitionpipeline_tpu_torch.models import quantize as tq
from facerecognitionpipeline_tpu_torch.models.convert import (
    backbone_state_from_jax,
    backbone_variables_from_state,
    fused_body_state_from_jax,
    train_state_from_jax,
    train_state_to_jax,
)
from facerecognitionpipeline_tpu_torch.parallel.mesh import make_mesh
from facerecognitionpipeline_tpu_torch.train import losses as tlosses
from facerecognitionpipeline_tpu_torch.train.trainer import (
    TrainConfig,
    Trainer,
    _leaves,
    dropout_generator,
    make_schedule,
)

torch.set_num_threads(2)

BASE = dict(architecture="ir_micro", num_classes=64, learning_rate=0.05)
HEADS = {
    "adaface": dict(lr_schedule="step", total_steps=10, warmup_steps=2),
    "arcface": dict(),
    "cosface": dict(lr_schedule="cosine", total_steps=10),
}
WD = 5e-4
_rng = np.random.default_rng(0)
X = _rng.uniform(-1, 1, (8, 112, 112, 3)).astype(np.float32)
Y = _rng.integers(0, 64, 8).astype(np.int32)
KEY = jax.random.PRNGKey(0)


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v, np.float64)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


@pytest.fixture(scope="module")
def jax_init():
    """The initial state in the JAX layout: the port's flax-like init,
    carried over by `train_state_to_jax` (its structure is held to the JAX
    `init_state`'s in `test_train_state_round_trips`)."""
    return train_state_to_jax(Trainer(TrainConfig(**BASE), device="cpu").init_state(0))


def _capture(masks):
    def interceptor(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if context.module.name == "output_dropout" and context.method_name == "__call__":
            jax.debug.callback(lambda v: masks.append(np.asarray(v) != 0), out)
        return out
    return interceptor


@pytest.fixture(scope="module", params=list(HEADS))
def jax_run(request, mesh, jax_init):
    """Three JAX steps from the shared initial state: (head, states 0..3,
    metrics, NCHW dropout masks). Each step takes the state as numpy, so
    the step compiles once."""
    head = request.param
    jt = JaxTrainer(JaxConfig(**BASE, loss=head, **HEADS[head]), mesh)
    masks, states, metrics = [], [jax_init], []
    with nn.intercept_methods(_capture(masks)):
        for _ in range(3):
            s, m = jt.train_step(states[-1], X, Y, KEY)
            states.append(jax.device_get(s))
            metrics.append({k: float(v) for k, v in m.items()})
            jax.effects_barrier()
    assert len(masks) == 3
    masks = [torch.from_numpy(m).permute(0, 3, 1, 2).contiguous() for m in masks]
    return head, states, metrics, masks


def _port(head, **kw):
    return Trainer(TrainConfig(**BASE, loss=head, **HEADS[head], **kw), device="cpu")


# ---------------------------------------------------------------- margins


@pytest.mark.parametrize("head", ["arcface", "cosface", "adaface"])
def test_margin_matches_jax(head):
    """Values and gradients (d/dcos, d/dnorm: 0 for AdaFace, whose quality
    term carries no gradient) on cosines across (-1, 1), including
    ArcFace's fallback region below cos(pi - m)."""
    rng = np.random.default_rng(1)
    cos = rng.uniform(-0.98, 0.98, 256).astype(np.float32)
    norms = rng.uniform(2, 45, 256).astype(np.float32)
    r = rng.standard_normal(256).astype(np.float32)
    mean, std = np.float32(20.0), np.float32(10.0)

    def jphi(c, n):
        if head == "arcface":
            return jlosses.arcface_margin_cosine(c, 0.5)
        if head == "cosface":
            return jlosses.cosface_margin_cosine(c, 0.4)
        return jlosses.adaface_margin_cosine(c, n, mean, std, 0.4, 0.333)

    def tphi(c, n):
        if head == "arcface":
            return tlosses.arcface_margin_cosine(c, 0.5)
        if head == "cosface":
            return tlosses.cosface_margin_cosine(c, 0.4)
        return tlosses.adaface_margin_cosine(c, n, torch.tensor(mean), torch.tensor(std),
                                             0.4, 0.333)

    want = np.asarray(jphi(cos, norms))
    jgc, jgn = jax.grad(lambda c, n: jnp.sum(jphi(c, n) * r), argnums=(0, 1))(cos, norms)
    c = torch.from_numpy(cos).requires_grad_()
    n = torch.from_numpy(norms).requires_grad_()
    got = tphi(c, n)
    (got * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(c.grad.numpy(), np.asarray(jgc), rtol=1e-5, atol=1e-5)
    gn = np.zeros_like(norms) if n.grad is None else n.grad.numpy()
    np.testing.assert_array_equal(gn, np.asarray(jgn))
    if head == "arcface":
        assert (cos < np.cos(np.pi - 0.5)).any()


# -------------------------------------------------------------- schedules


@pytest.mark.parametrize("kw", [
    dict(lr_schedule="constant"),
    dict(lr_schedule="cosine", total_steps=20),
    dict(lr_schedule="cosine", total_steps=20, warmup_steps=4),
    dict(lr_schedule="step", total_steps=20),
    dict(lr_schedule="step", total_steps=20, warmup_steps=3),
    dict(lr_schedule="step", total_steps=7, warmup_steps=6),
], ids=lambda kw: "-".join(f"{v}" for v in kw.values()))
def test_schedule_matches_optax_at_every_step(mesh, kw):
    """The port writes optax's formulas out; float32 on both sides, a cosine
    may differ in its last bit."""
    jsched = JaxTrainer(JaxConfig(architecture="ir_micro", num_classes=8, learning_rate=0.1,
                                  **kw), mesh)._make_schedule()
    tsched = make_schedule(TrainConfig(architecture="ir_micro", num_classes=8,
                                       learning_rate=0.1, **kw))
    assert callable(jsched) == callable(tsched)
    for step in range(kw.get("total_steps", 10) + 3):
        want = float(jsched(jnp.asarray(step, jnp.int32))) if callable(jsched) else jsched
        got = float(tsched(torch.tensor(step, dtype=torch.int32))) if callable(tsched) \
            else tsched
        assert got == pytest.approx(want, rel=1e-6, abs=1e-9), step


def test_unknown_schedule_loss_and_mesh_raise():
    with pytest.raises(ValueError, match="lr_schedule"):
        make_schedule(TrainConfig(lr_schedule="nope"))
    with pytest.raises(ValueError, match="loss"):
        Trainer(TrainConfig(architecture="ir_micro", loss="softmax"), device="cpu")
    # a mesh works (tests/test_torch_port_train_mesh.py); its model axis
    # must divide the class count
    with pytest.raises(ValueError, match="model"):
        Trainer(TrainConfig(architecture="ir_micro"),
                mesh=make_mesh(data=1, model=3, devices=["cpu"] * 3))
    tr = Trainer(TrainConfig(architecture="ir_micro", num_classes=8),
                 mesh=make_mesh(data=2, model=2, devices=["cpu"] * 4))
    assert [b.shape for b in tr.init_state(0)["params"]["classifier"]] == [(512, 4)] * 2


# -------------------------------------------------------------- the step


def _port_flat(tree, stats) -> dict:
    """A port params-shaped tree -> flat JAX-keyed leaves."""
    bb = backbone_variables_from_state({**tree["backbone"], **stats})["params"]
    return _flat({"backbone": bb, "classifier": tree["classifier"].detach().numpy()})


def _assert_gradients_close(got: dict, want: dict, whole: float, leaf: float) -> None:
    """Gradient-like trees (gradients, momentum traces): over all leaves
    together within `whole` of the JAX tree's norm; each leaf whose norm is
    not ~0 (above 1e-4 of the whole tree's) within `leaf` of its own."""
    assert got.keys() == want.keys()
    w_all = np.concatenate([want[k].ravel() for k in sorted(want)])
    d_all = np.concatenate([(got[k] - want[k]).ravel() for k in sorted(want)])
    assert np.linalg.norm(d_all) <= whole * np.linalg.norm(w_all)
    floor = 1e-4 * np.linalg.norm(w_all)
    for k in want:
        if np.linalg.norm(want[k]) > floor:
            assert _rel(got[k], want[k]) <= leaf, k


def test_train_step_matches_jax(jax_run):
    head, states, metrics, masks = jax_run
    trainer = _port(head)
    state = train_state_from_jax(states[0])
    # gradients of the first step: the JAX trace after one step from a zero
    # trace is g + wd * p0
    _, _, grads = trainer.loss_and_grads(state, X, Y, dropout_mask=masks[0])
    p0 = _flat(states[0]["params"])
    _assert_gradients_close(
        _port_flat(grads, state["batch_stats"]),
        {k: v - WD * p0[k] for k, v in _flat(states[1]["opt_state"]["trace"]).items()},
        whole=1e-3, leaf=1e-2)

    for i in range(3):
        state, m = trainer.train_step(state, X, Y, dropout_mask=masks[i])
        ref = metrics[i]
        tol = 1e-5 if i == 0 else 5e-4
        assert float(m["loss"]) == pytest.approx(ref["loss"], rel=tol), i
        assert float(m["accuracy"]) == ref["accuracy"], i
        if i in (0, 2):
            ours, theirs = _flat(train_state_to_jax(state)), _flat(states[i + 1])
            assert set(ours) == set(theirs)
            traces = [k for k in theirs if "['trace']" in k]
            _assert_gradients_close({k: ours[k] for k in traces},
                                    {k: theirs[k] for k in traces},
                                    whole=1e-3 if i == 0 else 1e-2,
                                    leaf=1e-2 if i == 0 else 5e-2)
            for k, v in theirs.items():
                if k.startswith("['params']"):
                    np.testing.assert_allclose(ours[k], v, rtol=0,
                                               atol=1e-3 if i == 0 else 3e-3, err_msg=k)
                elif k.startswith(("['batch_stats']", "['norm_ema']")):
                    d = np.linalg.norm(ours[k] - v)
                    rel = 1e-3 if i == 0 else 5e-3
                    assert d <= rel * np.linalg.norm(v) + 1e-5 * np.sqrt(v.size), k
                elif k not in traces:  # step, count
                    np.testing.assert_array_equal(ours[k], v, err_msg=k)


def test_constant_schedule_unfused_state_has_no_count():
    t = Trainer(TrainConfig(**BASE, fused_optimizer=False), device="cpu")
    state = t.init_state(0)
    assert state["opt_state"][0] == {} and state["opt_state"][1][1] == {}
    state, m = t.train_step(state, X, Y, dropout_generator(0, 0))
    assert np.isfinite(float(m["loss"])) and int(state["step"]) == 1


@pytest.mark.parametrize("fused", [True, False])
def test_train_step_leaves_the_state_it_was_given(fused):
    """As the JAX step: the state held before a step is unchanged by it, so
    it can be compared with the new one or stepped again."""
    t = Trainer(TrainConfig(**BASE, lr_schedule="cosine", total_steps=4,
                            fused_optimizer=fused), device="cpu")
    before = t.init_state(0)
    kept = jax.tree_util.tree_map(lambda v: v.detach().clone(), before)
    after, _ = t.train_step(before, X, Y, dropout_generator(0, 0))
    leaves = jax.tree_util.tree_leaves
    assert jax.tree_util.tree_structure(after) == jax.tree_util.tree_structure(before)
    assert all(torch.equal(a, b) for a, b in zip(leaves(before), leaves(kept)))
    assert not torch.equal(after["params"]["classifier"], before["params"]["classifier"])
    assert int(after["step"]) == 1 and int(before["step"]) == 0
    assert all(p.requires_grad for p in _leaves(after["params"]))
    again, _ = t.train_step(before, X, Y, dropout_generator(0, 0))
    assert all(torch.equal(a, b) for a, b in zip(leaves(again), leaves(after)))


def test_dropout_masks_follow_seed_and_step():
    """A resumed run draws the masks an uninterrupted one would; the steps
    draw different masks."""
    t = _port("arcface")
    a = t.init_state(0)
    b = t.init_state(0)
    ma, mb, mc = (t.loss_and_grads(s, X, Y, dropout_generator(0, step))[0]
                  for s, step in ((a, 5), (b, 5), (a, 6)))
    assert float(ma) == float(mb) != float(mc)
    with pytest.raises(ValueError, match="dropout"):
        t.loss_and_grads(a, X, Y)


def test_init_state_follows_flax_in_distribution():
    """Truncated lecun-normal kernels (|z| <= 2 sigma, variance 1/fan_in),
    zero biases, BatchNorm 1/0 with running 0/1, PReLU 0.25, classifier
    N(0, 0.01^2), norm_ema (20, 100), step 0; the same seed, the same state."""
    t = Trainer(TrainConfig(**BASE), device="cpu")
    s, s2 = t.init_state(0), t.init_state(0)
    bb = s["params"]["backbone"]
    w = bb["stage2_unit0.res_conv1.weight"].detach()
    fan_in = w[0].numel()
    std = w.std().item() * np.sqrt(fan_in)
    assert std == pytest.approx(1.0, rel=0.02)
    assert w.abs().max().item() <= 2 / 0.87962566103423978 / np.sqrt(fan_in) + 1e-7
    assert torch.equal(bb["output_fc.bias"], torch.zeros(512))
    assert torch.equal(bb["input_bn.weight"], torch.ones(64))
    assert torch.equal(bb["stage0_unit0.res_prelu.alpha"], torch.full((64,), 0.25))
    assert torch.equal(s["batch_stats"]["output_feature_bn.running_var"], torch.ones(512))
    clf = s["params"]["classifier"]
    assert clf.shape == (512, 64) and clf.std().item() == pytest.approx(0.01, rel=0.05)
    assert float(s["norm_ema"]["mean"]) == 20.0 and float(s["norm_ema"]["std"]) == 100.0
    assert int(s["step"]) == 0 and s["step"].dtype == torch.int32
    assert all(torch.equal(a, b) for a, b in zip(bb.values(), s2["params"]["backbone"].values()))
    assert all(p.requires_grad for p in bb.values())


# ------------------------------------------------------------ conversions


def test_train_state_round_trips(mesh, jax_init):
    """The port's state in the JAX layout has the JAX `init_state`'s
    structure, shapes and dtypes; JAX -> port -> JAX gives the JAX leaves
    back bit for bit and they unflatten into the JAX structure, for the
    fused state and for the optax chain's (whose count exists with a
    schedule only); port -> JAX -> port gives the port's tensors back."""
    jt = JaxTrainer(JaxConfig(**BASE), mesh)
    shapes, treedef = jax.tree_util.tree_flatten(jax.eval_shape(jt.init_state, 0))
    leaves = jax.tree_util.tree_leaves(jax_init)
    assert jax.tree_util.tree_structure(jax_init) == treedef
    assert [(a.shape, a.dtype) for a in shapes] == [(np.shape(b), np.asarray(b).dtype)
                                                    for b in leaves]
    chain_t = JaxTrainer(JaxConfig(**BASE, lr_schedule="cosine", total_steps=10,
                                   fused_optimizer=False), mesh)
    chain = dict(jax_init, opt_state=jax.device_get(chain_t.tx.init(jax_init["params"])))
    for tree in (jax_init, chain):
        port = train_state_from_jax(tree)
        back = train_state_to_jax(port)
        a, tdef = jax.tree_util.tree_flatten(tree)
        b = jax.tree_util.tree_leaves(back)
        assert len(a) == len(b)
        for u, v in zip(a, b):
            assert np.asarray(u).dtype == np.asarray(v).dtype
            assert np.asarray(u).tobytes() == np.asarray(v).tobytes()
        jax.tree_util.tree_unflatten(tdef, b)
        again = train_state_from_jax(back)
        assert all(torch.equal(x, y) for x, y in zip(jax.tree_util.tree_leaves(again),
                                                     jax.tree_util.tree_leaves(port)))
    assert isinstance(train_state_from_jax(chain)["opt_state"], tuple)
