"""The port's trainer under a mesh against the JAX package's, on the CPU.

The JAX `Trainer` runs on `Mesh(jax.devices()[:8] as (4, 2))` and
`(jax.devices()[:4] as (4, 1))` (data, model), the port's on meshes of 8
and 4 CPU entries, from the same initial state (the port's init, carried
over by `models/convert.py`), the same batch and the same dropout masks:
JAX draws one per data shard and step from fold_in(fold_in(key, shard),
step); each is read (with `flax.linen.intercept_methods`) from an eager
forward of that shard with that key, under x64 when the step ran so (the
keep probability's type sets the draw), and handed to the port in shard
order. The losses agreeing shows they are the masks JAX used.

Semantics are pinned in float64 (both packages computing in float64 from
the same float32 numbers) with the AdaFace head on both meshes, one step of
8 images (XLA's float64 convolutions on the CPU take ~35 s a step of the
(4, 2) mesh): the loss within 1e-6 relative [6e-8 measured], the accuracy
equal, and every leaf of the state (params, momentum traces, batch_stats,
norm_ema) within 1e-5 of its own norm, ||port - jax|| <= 1e-5 (||jax|| +
1e-6 sqrt(n)) [1.5e-6]; steps and counts equal. Only the float32 cast
before the embedding norm, which both packages make, keeps the two apart
by more than float64's rounding. The (4, 2) mesh splits the classifier
into two blocks and the softmax across them, and lands on the JAX state
all the same: a gradient scaled by the model axis (the JAX step's factor
for shard_map's replicated loss) would not.

Every head on both meshes then runs float32 steps of 16 images (4 per
data shard: with 2, the output BatchNorm over two samples makes float32
trajectories part after one step, the port's float32 from its own float64
as much as from JAX's), held as tests/test_torch_port_train.py holds the
one-device step: AdaFace, whose norm EMA also crosses the shards, three
steps; ArcFace and CosFace, whose heads that file holds to JAX one by one,
one step (what the mesh adds does not depend on the head). After one step
and after three [largest measured over the six runs]: the loss within 1e-5 [1.1e-7] and 5e-4 [1.2e-4] relative; the
momentum traces over all leaves within 1e-3 [1.2e-4] and 1e-2 [1.6e-3] of
their norm, the classifier's alone within 1e-4 [4.5e-6] and 2e-3
[3.0e-4]; parameters within 1e-3 [7.7e-5] and 3e-3 [3.9e-4] absolute;
batch_stats and norm_ema within 1e-3 and 5e-3 [6.9e-4] of their norm plus
1e-5 sqrt(n).

Also: `prefetch_to_device(sharding=mesh)` stages per-shard tensors that
the mesh step takes as they are; the CLI with --data_parallel 2
--model_parallel 2 --device cpu trains, resumes its checkpoint under the
same mesh (and refuses it under another) and exports a backbone both
packages load.
"""

import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from facerecognitionpipeline_tpu.models import irse as jirse
from facerecognitionpipeline_tpu.pipeline.embedder import FaceEmbedder as JaxEmbedder
from facerecognitionpipeline_tpu.train.trainer import TrainConfig as JaxConfig
from facerecognitionpipeline_tpu.train.trainer import Trainer as JaxTrainer
from facerecognitionpipeline_tpu_torch.cli import train_embedder
from facerecognitionpipeline_tpu_torch.models.convert import (
    train_state_from_jax,
    train_state_to_jax,
)
from facerecognitionpipeline_tpu_torch.parallel.mesh import make_mesh
from facerecognitionpipeline_tpu_torch.pipeline.embedder import FaceEmbedder
from facerecognitionpipeline_tpu_torch.train import checkpoint as tckpt
from facerecognitionpipeline_tpu_torch.train.data import prefetch_to_device
from facerecognitionpipeline_tpu_torch.train.trainer import TrainConfig, Trainer

torch.set_num_threads(2)

BASE = dict(architecture="ir_micro", num_classes=64, learning_rate=0.05)
HEADS = {
    "adaface": dict(lr_schedule="step", total_steps=10, warmup_steps=2),
    "arcface": dict(),
    "cosface": dict(lr_schedule="cosine", total_steps=10),
}
SHAPES = {"4x2": (4, 2), "4x1": (4, 1)}
_rng = np.random.default_rng(0)
X = _rng.uniform(-1, 1, (8, 112, 112, 3)).astype(np.float32)
Y = _rng.integers(0, 64, 8).astype(np.int32)
# float32 runs: 4 images per data shard
X16 = _rng.uniform(-1, 1, (16, 112, 112, 3)).astype(np.float32)
Y16 = _rng.integers(0, 64, 16).astype(np.int32)
KEY = jax.random.PRNGKey(0)


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v, np.float64)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _f64(tree):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64) if np.asarray(a).dtype == np.float32 else a, tree)


@pytest.fixture(scope="module")
def init():
    """The initial state in the JAX layout, float32 numbers."""
    return train_state_to_jax(Trainer(TrainConfig(**BASE), device="cpu").init_state(0))


def _masks(init, x, d: int, step: int, x64: bool) -> torch.Tensor:
    """The dropout mask the JAX step draws at `step` on a data axis of d, as
    NCHW bool in shard order: shard i's key is fold_in(fold_in(KEY, i),
    step) (JAX `trainer.py`), and the mask is where the dropout's output is
    not 0, read by an interceptor on an eager forward of that shard (under
    x64 as the step ran: the keep probability's type sets the draw)."""
    model = jirse.build_backbone("ir_micro")
    variables = {"params": init["params"]["backbone"], "batch_stats": init["batch_stats"]}
    per = x.shape[0] // d
    out = []

    def interceptor(next_fun, args, kwargs, context):
        y = next_fun(*args, **kwargs)
        if context.module.name == "output_dropout" and context.method_name == "__call__":
            out.append(np.asarray(y) != 0)
        return y

    for i in range(d):
        rng = jax.random.fold_in(jax.random.fold_in(KEY, i), step)
        with jax.enable_x64(x64), nn.intercept_methods(interceptor):
            model.apply(variables, x[i * per:(i + 1) * per], train=True,
                        rngs={"dropout": rng}, mutable=["batch_stats"])
    assert len(out) == d
    return torch.from_numpy(np.concatenate(out)).permute(0, 3, 1, 2).contiguous()


def _jax_run(head, shape, init, x, y, steps, x64=False):
    """JAX steps on the (data, model) mesh: (states 0..steps, metrics, the
    dropout masks of the steps)."""
    d, m = shape
    mesh = JaxMesh(np.array(jax.devices()[:d * m]).reshape(d, m), ("data", "model"))
    with jax.enable_x64(x64):
        dtype = jnp.float64 if x64 else jnp.float32
        jt = JaxTrainer(JaxConfig(**BASE, loss=head, dtype=dtype, **HEADS[head]), mesh)
        states, metrics = [_f64(init) if x64 else init], []
        for _ in range(steps):
            s, met = jt.train_step(states[-1], x, y, KEY)
            states.append(jax.device_get(s))
            metrics.append({k: float(v) for k, v in met.items()})
    masks = [_masks(init, x, d, step, x64) for step in range(steps)]
    # distinct masks per data shard and per step
    per = x.shape[0] // d
    assert not torch.equal(masks[0][:per], masks[0][per:2 * per])
    assert steps == 1 or not torch.equal(masks[0], masks[1])
    return states, metrics, masks


def _port(head, shape, dtype=torch.float32):
    d, m = shape
    return Trainer(TrainConfig(**BASE, loss=head, dtype=dtype, **HEADS[head]),
                   make_mesh(data=d, model=m, devices=["cpu"] * (d * m)))


def _port_state(trainer, jax_state, dtype=torch.float32):
    state = train_state_from_jax(jax_state)
    state = jax.tree_util.tree_map(
        lambda t: t.detach().to(dtype) if t.is_floating_point() else t, state)
    return trainer.place_state(state)


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("shape", list(SHAPES))
def test_mesh_train_step_matches_jax_in_float64(shape, init):
    """AdaFace, one step of 8 images, both packages in float64: the
    semantics of the data split and of the class-sharded head."""
    states, metrics, masks = _jax_run("adaface", SHAPES[shape], init, X, Y, 1, x64=True)
    trainer = _port("adaface", SHAPES[shape], torch.float64)
    state = _port_state(trainer, states[0], torch.float64)
    m = SHAPES[shape][1]
    assert [b.shape for b in state["params"]["classifier"]] == [(512, 64 // m)] * m
    state, met = trainer.train_step(state, X, Y, dropout_mask=masks[0])
    assert float(met["loss"]) == pytest.approx(metrics[0]["loss"], rel=1e-6)
    assert float(met["accuracy"]) == metrics[0]["accuracy"]
    got, want = _flat(train_state_to_jax(state)), _flat(states[1])
    assert set(got) == set(want)
    for k, v in want.items():
        if "['step']" in k or "['count']" in k:
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            d = np.linalg.norm(got[k] - v)
            assert d <= 1e-5 * (np.linalg.norm(v) + 1e-6 * np.sqrt(v.size)), (k, d)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("head", list(HEADS))
def test_mesh_train_step_matches_jax(head, shape, init):
    """float32 steps of 16 images (4 per data shard): three for AdaFace, one
    for the other heads."""
    steps = 3 if head == "adaface" else 1
    states, metrics, masks = _jax_run(head, SHAPES[shape], init, X16, Y16, steps)
    trainer = _port(head, SHAPES[shape])
    state = _port_state(trainer, states[0])
    for i in range(steps):
        state, met = trainer.train_step(state, X16, Y16, dropout_mask=masks[i])
        assert float(met["loss"]) == pytest.approx(metrics[i]["loss"], rel=1e-5 if i == 0
                                                   else 5e-4), i
        assert float(met["accuracy"]) == metrics[i]["accuracy"], i
        if i not in (0, 2):
            continue
        ours, theirs = _flat(train_state_to_jax(state)), _flat(states[i + 1])
        assert set(ours) == set(theirs)
        traces = sorted(k for k in theirs if "['trace']" in k)
        w_all = np.concatenate([theirs[k].ravel() for k in traces])
        d_all = np.concatenate([(ours[k] - theirs[k]).ravel() for k in traces])
        assert np.linalg.norm(d_all) <= (1e-3 if i == 0 else 1e-2) * np.linalg.norm(w_all)
        # the classifier's gradient alone: a factor of the model axis shows here
        clf = "['opt_state']['trace']['classifier']"
        assert _rel(ours[clf], theirs[clf]) <= (1e-4 if i == 0 else 2e-3)
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


def test_prefetched_shards_feed_the_mesh_step():
    """sharding=mesh stages each batch as one tensor per data shard; the step
    takes them as they lie and gives what the whole arrays give."""
    mesh = make_mesh(data=2, model=2, devices=["cpu"] * 4)
    trainer = Trainer(TrainConfig(**BASE), mesh)
    state = trainer.init_state(0)
    staged = list(prefetch_to_device(iter([(X, Y)]), depth=1, device="cpu", sharding=mesh))
    assert len(staged) == 1
    images, labels = staged[0]
    assert [tuple(t.shape) for t in images] == [(4, 112, 112, 3)] * 2
    np.testing.assert_array_equal(torch.cat(labels).numpy(), Y)
    gens = trainer.dropout_generators(0, 0)
    a, ma = trainer.train_step(state, images, labels, gens)
    b, mb = trainer.train_step(state, X, Y, trainer.dropout_generators(0, 0))
    assert float(ma["loss"]) == float(mb["loss"])
    assert all(torch.equal(u, v) for u, v in zip(a["params"]["classifier"],
                                                  b["params"]["classifier"]))
    with pytest.raises(ValueError, match="multiple"):
        list(prefetch_to_device(iter([(X[:3], Y[:3])]), device="cpu", sharding=mesh))
    with pytest.raises(ValueError, match="one dropout generator per data shard"):
        trainer.train_step(state, X, Y, gens[:1])


def test_cli_trains_resumes_and_exports_under_a_mesh(tmp_path, capsys):
    ck, out = str(tmp_path / "ck"), str(tmp_path / "bb.npz")
    base = ["--device", "cpu", "--synthetic_classes", "6", "--architecture", "ir_micro",
            "--batch_size", "4", "--log_every", "1", "--checkpoint_dir", ck,
            "--data_parallel", "2", "--model_parallel", "2"]
    assert train_embedder.main(base + ["--steps", "2"]) == 0
    assert train_embedder.main(base + ["--steps", "3", "--resume", "--export_path", out]) == 0
    text = capsys.readouterr().out
    assert "Mesh: data=2 x model=2" in text and "Resumed from step 2" in text
    assert "Training done at step 3" in text and tckpt.latest_step(ck) == 3
    saved = torch.load(os.path.join(ck, "step_3.pt"), weights_only=True)
    assert [b.shape for b in saved["params"]["classifier"]] == [(512, 3)] * 2
    a = FaceEmbedder("ir_micro", model_path=out, device="cpu")
    b = JaxEmbedder("ir_micro", model_path=out)
    faces = np.random.default_rng(1).integers(0, 256, (2, 112, 112, 3), dtype=np.uint8)
    np.testing.assert_allclose(a.extract_embeddings_batch(faces),
                               b.extract_embeddings_batch(faces), atol=1e-4)
    # another mesh: the classifier has another number of blocks
    with pytest.raises(ValueError, match="checkpoint"):
        train_embedder.main(base[:-2] + ["--model_parallel", "3", "--steps", "4",
                                         "--resume"])
