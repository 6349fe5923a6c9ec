"""The port's training data, checkpoints, export and CLI against the JAX
package's, on the CPU.

* `synthetic_batches` and `folder_batches`: bit for bit the JAX package's
  batches for a seed (the same numpy calls in the same order; the same
  permutation, flips and round-robin top-up), the eager too-small error,
  and the producer thread stopping when the consumer leaves;
* `prefetch_to_device`: the same stream, errors on the consumer's thread,
  the producer stopping when the consumer leaves;
* checkpoints: save, retention of the 3 newest, restore into a fresh
  state's structure, and the error for another structure (the fused
  optimizer's state against the unfused one);
* `export_backbone`: the `.npz` holds the keys and arrays (bit for bit) of
  the JAX package's `export_backbone` of the same state, and both
  packages' `FaceEmbedder(model_path=...)` load it (embeddings within
  cosine 0.9999 of each other, float32);
* the CLI, 3 steps on the CPU then `--resume` to 5, with its export.
"""

import itertools
import os
import threading

import cv2
import jax
import numpy as np
import pytest
import torch

from facerecognitionpipeline_tpu.pipeline.embedder import FaceEmbedder as JaxEmbedder
from facerecognitionpipeline_tpu.train import checkpoint as jckpt
from facerecognitionpipeline_tpu.train import data as jdata
from facerecognitionpipeline_tpu_torch.cli import train_embedder
from facerecognitionpipeline_tpu_torch.models.convert import train_state_to_jax
from facerecognitionpipeline_tpu_torch.pipeline.embedder import FaceEmbedder
from facerecognitionpipeline_tpu_torch.train import checkpoint as tckpt
from facerecognitionpipeline_tpu_torch.train import data as tdata
from facerecognitionpipeline_tpu_torch.train.trainer import (
    TrainConfig,
    Trainer,
    dropout_generator,
)
from facerecognitionpipeline_tpu_torch.utils.io import load_npz_variables

torch.set_num_threads(2)


@pytest.fixture
def tree(tmp_path):
    """3 identities x 5 PNG crops, one of them 96 px (the resize path) and
    one file that does not decode (the top-up path)."""
    rng = np.random.default_rng(0)
    for c, cls in enumerate(("anna", "ben", "cara")):
        d = tmp_path / cls
        d.mkdir()
        for i in range(5):
            size = 96 if (c, i) == (1, 2) else 112
            cv2.imwrite(str(d / f"{i}.png"), rng.integers(0, 256, (size, size, 3), np.uint8))
    (tmp_path / "ben" / "5.png").write_bytes(b"not a png")
    return str(tmp_path)


@pytest.mark.parametrize("classes,batch,seed", [(4, 8, 0), (16, 3, 11)])
def test_synthetic_batches_equal_jax(classes, batch, seed):
    a = itertools.islice(tdata.synthetic_batches(classes, batch, seed), 3)
    b = itertools.islice(jdata.synthetic_batches(classes, batch, seed), 3)
    for (ti, tl), (ji, jl) in zip(a, b):
        assert ti.dtype == ji.dtype and tl.dtype == jl.dtype
        assert ti.tobytes() == ji.tobytes() and tl.tobytes() == jl.tobytes()


@pytest.mark.parametrize("batch,flip", [(4, True), (5, False)])
def test_folder_batches_equal_jax(tree, batch, flip):
    """Two epochs from one seed: the same permutations, flips, decodes and
    top-ups; and the same dataset index."""
    td, jd = tdata.FolderDataset(tree), jdata.FolderDataset(tree)
    assert td.class_names == jd.class_names and td.paths == jd.paths
    assert td.labels_np.tobytes() == jd.labels_np.tobytes()
    ours = list(tdata.folder_batches(td, batch, seed=3, epochs=2, augment_flip=flip,
                                     num_workers=2))
    theirs = list(jdata.folder_batches(jd, batch, seed=3, epochs=2, augment_flip=flip,
                                       num_workers=2))
    assert len(ours) == len(theirs) == 2 * (len(td) // batch)
    for (ti, tl), (ji, jl) in zip(ours, theirs):
        assert ti.shape == (batch, 112, 112, 3) and ti.dtype == np.float32
        assert ti.tobytes() == ji.tobytes() and tl.tobytes() == jl.tobytes()


def test_folder_batches_refuses_a_dataset_smaller_than_a_batch(tree):
    with pytest.raises(ValueError, match="batch_size"):
        tdata.folder_batches(tdata.FolderDataset(tree), batch_size=64)
    with pytest.raises(ValueError, match="No training images"):
        tdata.FolderDataset(os.path.join(tree, "anna"))


@pytest.mark.parametrize("source", ["folder", "prefetch"])
def test_abandoned_consumer_stops_the_producer(tree, source):
    """Leaving the generator lets its producer thread exit even while it is
    blocked on a full queue."""
    name = {"folder": "folder_batches_producer", "prefetch": "prefetch_to_device"}[source]
    before = set(threading.enumerate())
    if source == "folder":
        it = tdata.folder_batches(tdata.FolderDataset(tree), 4, epochs=None, prefetch=1)
    else:
        it = tdata.prefetch_to_device(tdata.synthetic_batches(4, 2, seed=4), depth=1,
                                      device="cpu")
    next(it)
    spawned = [t for t in threading.enumerate() if t not in before and t.name == name]
    assert spawned
    it.close()
    for t in spawned:
        t.join(timeout=5.0)
    assert not any(t.is_alive() for t in spawned)


def test_prefetch_to_device_preserves_the_stream_and_raises_on_the_consumer():
    src = list(itertools.islice(tdata.synthetic_batches(4, 8, seed=3), 4))
    out = list(tdata.prefetch_to_device(iter(src), depth=2, device="cpu"))
    assert len(out) == 4
    for (si, sl), (di, dl) in zip(src, out):
        assert isinstance(di, torch.Tensor) and np.array_equal(di.numpy(), si)
        assert np.array_equal(dl.numpy(), sl)

    def bad():
        yield (np.zeros((2, 4), np.float32), np.zeros((2,), np.int32))
        raise RuntimeError("decode exploded")

    gen = tdata.prefetch_to_device(bad(), depth=2, device="cpu")
    next(gen)
    with pytest.raises(RuntimeError, match="decode exploded"):
        list(gen)


def test_prefetch_to_device_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(tdata.prefetch_to_device(iter([(np.zeros(2),)])))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(TrainConfig(architecture="ir_micro"))


# ------------------------------------------------------ checkpoint, export


def _trained(fused=True, steps=1):
    t = Trainer(TrainConfig(architecture="ir_micro", num_classes=8, learning_rate=0.05,
                            fused_optimizer=fused), device="cpu")
    s = t.init_state(1)
    x, y = next(tdata.synthetic_batches(8, 4, seed=2))
    for i in range(steps):
        s, _ = t.train_step(s, x, y, dropout_generator(1, i))
    return t, s


def test_checkpoint_keeps_the_newest_three_and_restores(tmp_path):
    t, s = _trained()
    d = str(tmp_path / "ck")
    assert tckpt.latest_step(d) is None
    with pytest.raises(FileNotFoundError):
        tckpt.restore_checkpoint(d, s)
    for step in (1, 2, 3, 4):
        tckpt.save_checkpoint(d, s, step)
    assert sorted(os.listdir(d)) == ["step_2.pt", "step_3.pt", "step_4.pt"]
    assert tckpt.latest_step(d) == 4
    fresh = t.init_state(7)
    got = tckpt.restore_checkpoint(d, fresh)
    flat = lambda st: jax.tree_util.tree_leaves(st)  # noqa: E731
    assert all(torch.equal(a, b) for a, b in zip(flat(got), flat(s)))
    assert got["params"]["classifier"].requires_grad
    assert int(got["step"]) == 1 and got["step"].dtype == torch.int32
    again, _ = t.train_step(got, *next(tdata.synthetic_batches(8, 4, seed=2)),
                            dropout_generator(1, 1))
    assert int(again["step"]) == 2


@pytest.mark.parametrize("saved,into", [("fused", "unfused"), ("unfused", "fused"),
                                        ("fused", "other_classes")])
def test_restoring_another_structure_raises(tmp_path, saved, into):
    _, s = _trained(fused=saved == "fused")
    tckpt.save_checkpoint(str(tmp_path), s, 1)
    if into == "other_classes":
        target = Trainer(TrainConfig(architecture="ir_micro", num_classes=16),
                         device="cpu").init_state(0)
    else:
        target = _trained(fused=into == "fused", steps=0)[1]
    with pytest.raises(ValueError, match="checkpoint"):
        tckpt.restore_checkpoint(str(tmp_path), target)


def test_export_equals_the_jax_export_and_loads_in_both(tmp_path):
    _, s = _trained(steps=2)
    ours, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    tckpt.export_backbone(s, ours)
    jckpt.export_backbone(train_state_to_jax(s), theirs)
    with np.load(ours) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k
    assert set(load_npz_variables(ours)) == {"params", "batch_stats"}
    faces = np.random.default_rng(3).integers(0, 256, (3, 112, 112, 3)).astype(np.uint8)
    e_port = FaceEmbedder("ir_micro", model_path=ours, device="cpu")
    e_jax = JaxEmbedder("ir_micro", model_path=ours)
    a = e_port.extract_embeddings_batch(faces)
    b = e_jax.extract_embeddings_batch(faces)
    assert np.sum(a * b, axis=1).min() >= 0.9999


# ------------------------------------------------------------------ CLI


def test_cli_trains_resumes_and_exports(tmp_path, capsys):
    ck, out = str(tmp_path / "ck"), str(tmp_path / "e.npz")
    base = ["--device", "cpu", "--synthetic_classes", "8", "--architecture", "ir_micro",
            "--batch_size", "4", "--checkpoint_every", "2", "--log_every", "2",
            "--checkpoint_dir", ck]
    assert train_embedder.main(base + ["--steps", "3", "--prefetch", "2"]) == 0
    first = capsys.readouterr().out
    assert "step 2/3 loss" in first and "Training done at step 3" in first
    assert sorted(os.listdir(ck)) == ["step_2.pt", "step_3.pt"]
    assert train_embedder.main(base + ["--steps", "5", "--resume", "--export_path", out]) == 0
    second = capsys.readouterr().out
    assert "Resumed from step 3" in second and "Training done at step 5" in second
    assert tckpt.latest_step(ck) == 5 and len(os.listdir(ck)) == 3
    losses = [float(line.split("loss ")[1].split()[0]) for line in (first + second).splitlines()
              if line.startswith("step ")]
    assert losses and all(np.isfinite(losses))
    FaceEmbedder("ir_micro", model_path=out, device="cpu")
    with pytest.raises(ValueError, match="checkpoint"):
        train_embedder.main(base + ["--steps", "6", "--resume", "--optax_optimizer"])


@pytest.mark.parametrize("flag", ["--data_parallel", "--model_parallel"])
def test_cli_refuses_more_than_one_card(flag, tmp_path, capsys):
    """A data or model axis of 2 trains over a mesh of two CPU entries, as
    the JAX CLI does on its virtual CPU devices; a model axis pads the class
    count to a multiple of it."""
    assert train_embedder.main([
        "--device", "cpu", "--synthetic_classes", "5", flag, "2", "--architecture",
        "ir_micro", "--batch_size", "4", "--steps", "2", "--log_every", "1",
        "--checkpoint_dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    want = "data=2 x model=1" if flag == "--data_parallel" else "data=1 x model=2"
    assert f"Mesh: {want}" in out and "Training done at step 2" in out
    state = torch.load(tmp_path / "step_2.pt", weights_only=True)
    blocks = state["params"]["classifier"]
    assert [b.shape[1] for b in blocks] == ([5] if flag == "--data_parallel" else [3, 3])


def test_cli_defaults_to_cuda_and_raises_without_it(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert train_embedder.build_parser().get_default("device") == "cuda"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_embedder.main(["--synthetic_classes", "4", "--architecture", "ir_micro",
                             "--checkpoint_dir", str(tmp_path)])


def test_cli_flags_are_the_jax_cli_flags_plus_device():
    from facerecognitionpipeline_tpu.cli import train_embedder as jcli

    def flags(parser):
        return {a.dest: a.default for a in parser._actions if a.dest != "help"}

    ours, theirs = flags(train_embedder.build_parser()), flags(jcli.build_parser())
    assert set(ours) - set(theirs) == {"device"}
    assert {k: v for k, v in ours.items() if k != "device"} == theirs
