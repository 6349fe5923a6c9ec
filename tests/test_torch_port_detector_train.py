"""The port's detector trainer, training scenes and out-of-distribution
suite against the JAX package's, on the CPU.

Held byte for byte: `render_scene`, `_iou`, `sample_patches` (with and
without landmarks, a class quota, 3- and 4-tuple scene functions),
`render_stress_training_scene`, the facegen renderers and corpus batches,
`render_ood_scene` for every category.

Held within a tolerance:
* `_loss_fn` from the same parameters and patches, with and without OHEM:
  loss and accuracy within 1e-5 relative, gradients within 1e-4;
* one Adam step of P-, R- and O-net from the same parameters: every
  parameter whose gradient is not ~0 (|g| > 1e-5) moves by the same
  amount within 1e-7 (Adam's first step moves each by lr * g / (|g| +
  eps), about lr), and none moves by more than lr + 1e-7;
* `run_ood_suite` with both packages' float32 cascades on the same weights:
  the same ground truth counts, detection counts within one per category
  and APs within 0.05 (a box that the two float32 cascades score on either
  side of a stage threshold).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from facerecognitionpipeline_tpu.evalharness import detection as jdet
from facerecognitionpipeline_tpu.evalharness import detection_ood as jood
from facerecognitionpipeline_tpu.models import detector_nets as jnets
from facerecognitionpipeline_tpu.models.detector import MTCNNDetector as JaxDetector
from facerecognitionpipeline_tpu.train import detector_train as jtrain
from facerecognitionpipeline_tpu.train import facegen as jgen
from facerecognitionpipeline_tpu_torch.evalharness import detection as tdet
from facerecognitionpipeline_tpu_torch.evalharness import detection_ood as tood
from facerecognitionpipeline_tpu_torch.models import detector_nets as tnets
from facerecognitionpipeline_tpu_torch.models.convert import (
    detector_state_from_jax,
    params_from_state,
)
from facerecognitionpipeline_tpu_torch.models.detector import MTCNNDetector
from facerecognitionpipeline_tpu_torch.train import detector_train as ttrain
from facerecognitionpipeline_tpu_torch.train import facegen as tgen

torch.set_num_threads(2)

NETS = {"pnet": (12, False), "rnet": (24, False), "onet": (48, True)}


def _bytes_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("seed", [0, 5])
def test_render_scene_and_iou_equal_jax(seed):
    ours = ttrain.render_scene(np.random.default_rng(seed), size=160, max_faces=3)
    theirs = jtrain.render_scene(np.random.default_rng(seed), size=160, max_faces=3)
    assert all(_bytes_equal(a, b) for a, b in zip(ours, theirs))
    box = np.array([10, 20, 60, 90], np.float32)
    boxes = np.random.default_rng(seed).uniform(0, 100, (6, 4)).astype(np.float32)
    boxes[:, 2:] += boxes[:, :2]
    assert _bytes_equal(ttrain._iou(box, boxes), jtrain._iou(box, boxes))


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_stress_training_scene_equals_jax(seed):
    ours = tdet.render_stress_training_scene(np.random.default_rng(seed))
    theirs = jdet.render_stress_training_scene(np.random.default_rng(seed))
    assert len(ours) == 4
    assert all(_bytes_equal(a, b) for a, b in zip(ours, theirs))


@pytest.mark.parametrize("patch,lmk,balance,scene", [
    (12, False, None, None),
    (24, False, (0.3, 0.2), None),
    (48, True, None, "stress"),
    (24, False, (0.4, 0.1), "stress"),
])
def test_sample_patches_equal_jax(patch, lmk, balance, scene):
    """The same patches, labels, targets and masks, and the same generator
    state after (the same number of draws)."""
    fns = {None: (None, None),
           "stress": (tdet.render_stress_training_scene, jdet.render_stress_training_scene)}
    t_rng, j_rng = np.random.default_rng(7), np.random.default_rng(7)
    ours = ttrain.sample_patches(t_rng, patch, 32, scene_fn=fns[scene][0],
                                 with_landmarks=lmk, class_balance=balance)
    theirs = jtrain.sample_patches(j_rng, patch, 32, scene_fn=fns[scene][1],
                                   with_landmarks=lmk, class_balance=balance)
    assert ours.keys() == theirs.keys()
    for k in ours:
        assert _bytes_equal(ours[k], theirs[k]), k
    assert t_rng.bit_generator.state == j_rng.bit_generator.state
    if balance is not None:
        assert (ours["cls"] == 1).sum() == round(32 * balance[0])


def _jax_net(name):
    return {"pnet": jnets.PNet, "rnet": jnets.RNet, "onet": jnets.ONet}[name]()


def _port_net(name, params):
    net = {"pnet": tnets.PNet, "rnet": tnets.RNet, "onet": tnets.ONet}[name]()
    sd = detector_state_from_jax({n: {"params": params if n == name else {}} for n in NETS})
    net.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()})
    return net


@pytest.fixture(scope="module", params=list(NETS))
def net_case(request):
    """(name, JAX params, a patch batch) for one cascade net."""
    name = request.param
    size, lmk = NETS[name]
    params = jax.device_get(_jax_net(name).init(jax.random.PRNGKey(3),
                                                jnp.zeros((1, size, size, 3)))["params"])
    batch = jtrain.sample_patches(np.random.default_rng(9), size, 64, with_landmarks=lmk)
    return name, params, batch


@pytest.mark.parametrize("ohem", [1.0, 0.7])
def test_loss_fn_matches_jax(net_case, ohem):
    name, params, batch = net_case
    lmk = NETS[name][1]
    (jl, jacc), jg = jax.jit(jax.value_and_grad(
        lambda p: jtrain._loss_fn(_jax_net(name).apply, p, batch, lmk, ohem), has_aux=True
    ))(params)
    net = _port_net(name, params)
    tl, tacc = ttrain._loss_fn(net, {k: torch.from_numpy(v) for k, v in batch.items()}, lmk,
                               ohem)
    tl.backward()
    assert tl.item() == pytest.approx(float(jl), rel=1e-5)
    assert tacc.item() == pytest.approx(float(jacc), rel=1e-6)
    got = params_from_state({k: p.grad for k, p in net.named_parameters()})
    for (path, want), have in zip(jax.tree_util.tree_leaves_with_path(jg),
                                  jax.tree_util.tree_leaves(got)):
        np.testing.assert_allclose(have, np.asarray(want), rtol=1e-4, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))


def test_ohem_keeps_the_hardest_classified_fraction(net_case):
    """k counts the classified samples only, so many part samples (label
    -1) do not push the threshold into their sentinel: the mined loss is
    at least the unmined one."""
    name, params, batch = net_case
    batch = dict(batch, cls=np.where(np.arange(64) % 2 == 0, -1, batch["cls"]).astype(np.int32))
    net = _port_net(name, params)
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    full, _ = ttrain._loss_fn(net, t, NETS[name][1], 1.0)
    mined, _ = ttrain._loss_fn(net, t, NETS[name][1], 0.3)
    assert mined.item() >= full.item()


def test_one_adam_step_matches_optax(net_case):
    name, params, batch = net_case
    lmk, lr = NETS[name][1], 1e-3
    tx = optax.adam(lr)
    grads = jax.jit(jax.grad(
        lambda p: jtrain._loss_fn(_jax_net(name).apply, p, batch, lmk, 0.7)[0]))(params)
    updates, _ = tx.update(grads, tx.init(params))
    want = jax.device_get(optax.apply_updates(params, updates))
    net = _port_net(name, params)
    opt = torch.optim.Adam(net.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    loss, _ = ttrain.net_train_step(net, opt, {k: torch.from_numpy(v) for k, v in batch.items()},
                                    lmk, 0.7)
    assert np.isfinite(loss.item())
    got = params_from_state(net.state_dict())
    for p0, g, w, h in zip(*(jax.tree_util.tree_leaves(t) for t in (params, grads, want, got))):
        move_want, move_got = np.asarray(w) - np.asarray(p0), h - np.asarray(p0)
        big = np.abs(np.asarray(g)) > 1e-5
        np.testing.assert_allclose(move_got[big], move_want[big], rtol=0, atol=1e-7)
        assert np.abs(move_got).max() <= lr + 1e-7


def test_train_detector_on_the_cpu_loads_into_the_detector():
    history = {}
    v = ttrain.train_detector(steps=2, batch=32, log_every=1, ohem_fraction=0.7,
                              device="cpu", history=history,
                              scene_fn=tdet.render_stress_training_scene)
    assert {k: len(x) for k, x in history.items()} == {"pnet": 2, "rnet": 2, "onet": 2}
    assert all(np.isfinite(x).all() for x in history.values())
    det = MTCNNDetector(det_size=(160, 160), variables=v, device="cpu")
    det.detect(ttrain.render_scene(np.random.default_rng(1))[0])
    assert set(v["onet"]["params"]) >= {"conv4", "fc1", "landmarks"}


def test_train_net_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.train_net(tnets.PNet(), 12, steps=1, batch=8)


# ---------------------------------------------------------- facegen, OOD


@pytest.mark.parametrize("seed", [0, 17])
def test_facegen_equals_jax(seed):
    assert tgen.sample_identity(seed) == jgen.sample_identity(seed)
    ident = jgen.sample_identity(seed)
    assert _bytes_equal(tgen.render_crop(ident, np.random.default_rng(seed)),
                        jgen.render_crop(ident, np.random.default_rng(seed)))
    idents = [jgen.sample_identity(seed + i) for i in range(3)]
    ours = tgen.compose_scene(idents, np.random.default_rng(seed), size=200)
    theirs = jgen.compose_scene(idents, np.random.default_rng(seed), size=200)
    assert all(_bytes_equal(a, b) for a, b in zip(ours[:3], theirs[:3]))
    ti, tl = tgen.build_corpus(2, 2, seed=seed, size=64)
    ji, jl = jgen.build_corpus(2, 2, seed=seed, size=64)
    assert _bytes_equal(ti, ji) and _bytes_equal(tl, jl)
    tb = next(tgen.corpus_batches(ti, tl, 3, seed=seed))
    jb = next(jgen.corpus_batches(ji, jl, 3, seed=seed))
    assert _bytes_equal(tb[0], jb[0]) and _bytes_equal(tb[1], jb[1])
    x = tgen.to_model_input(torch.from_numpy(tb[0]))
    assert isinstance(x, torch.Tensor)
    np.testing.assert_array_equal(x.numpy(), np.asarray(jgen.to_model_input(jnp.asarray(jb[0]))))


@pytest.mark.parametrize("category", tood.OOD_CATEGORIES)
def test_ood_scene_equals_jax(category):
    ours = tood.render_ood_scene(np.random.default_rng(4), category, size=160)
    theirs = jood.render_ood_scene(np.random.default_rng(4), category, size=160)
    assert _bytes_equal(ours[0], theirs[0]) and _bytes_equal(ours[1], theirs[1])
    with pytest.raises(ValueError):
        tood.render_ood_scene(np.random.default_rng(0), "cartoon")


def test_ood_suite_rows_match_jax():
    weights = "pretrained/mtcnn_synthetic.npz"
    kw = dict(det_size=(320, 320), max_faces=8, min_face_size=20, weights_path=weights)
    cats = ("facegen", "facegen+jpeg", "facegen+lowlight")
    ours = tood.run_ood_suite(MTCNNDetector(**kw, device="cpu"), categories=cats, n_scenes=2)
    theirs = jood.run_ood_suite(JaxDetector(**kw), categories=cats, n_scenes=2)
    assert ours["summary"].keys() == theirs["summary"].keys()
    for cat in cats:
        a, b = ours["detail"][cat], theirs["detail"][cat]
        assert a["n_gt_faces"] == b["n_gt_faces"] > 0
        assert abs(a["n_detections"] - b["n_detections"]) <= 1, cat
        assert a["ap"] == pytest.approx(b["ap"], abs=0.05), cat
