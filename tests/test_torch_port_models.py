"""The port's models (P/R/O-net, the MTCNN cascade, the IR backbone, BN
folding, weight conversion, FaceEmbedder) against the JAX package's, on the
CPU in float32, with the same weights carried over by models/convert.py.

Tolerances: net outputs (probabilities, regressions, landmarks) 1e-4 abs;
IR features cosine >= 0.9999 and norms 1e-4 relative; the f32 cascade's
boxes and landmarks 1e-2 px with identical validity.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerecognitionpipeline_tpu.models import detector_nets as jnets
from facerecognitionpipeline_tpu.models.detector import MTCNNDetector as JaxDetector
from facerecognitionpipeline_tpu.models.fold import fold_inference_variables as jax_fold
from facerecognitionpipeline_tpu.models.irse import build_backbone as jax_backbone
from facerecognitionpipeline_tpu.utils.io import save_npz_variables
from facerecognitionpipeline_tpu_torch.models.convert import (
    backbone_state_from_jax,
    detector_state_from_jax,
)
from facerecognitionpipeline_tpu_torch.models.detector import MTCNNDetector
from facerecognitionpipeline_tpu_torch.models.detector_nets import DetectorNets
from facerecognitionpipeline_tpu_torch.models.fold import fold_inference_variables
from facerecognitionpipeline_tpu_torch.models.irse import build_backbone
from facerecognitionpipeline_tpu_torch.pipeline.embedder import FaceEmbedder
from facerecognitionpipeline_tpu_torch.utils.io import load_npz_variables

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, "pretrained", "mtcnn_dr.npz")
FIXTURE = os.path.join(
    REPO, "facerecognitionpipeline_tpu_torch", "testdata", "smoke_scenes.npz"
)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree)


def _random_like(tree, rng):
    if isinstance(tree, dict):
        return {k: _random_like(v, rng) for k, v in tree.items()}
    # the trained weights, each scaled by a random factor
    return (tree * rng.uniform(0.5, 1.5, tree.shape)).astype(np.float32)


def _cos(a, b):
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


@pytest.fixture(scope="module")
def det_vars():
    return load_npz_variables(WEIGHTS)


@pytest.fixture(scope="module")
def nets(det_vars):
    n = DetectorNets()
    n.load_state_dict(detector_state_from_jax(det_vars))
    return n.eval()


# -------------------------------------------------------------- detector nets


@pytest.mark.parametrize("source", ["mtcnn_dr", "random"])
def test_rnet_onet_match_flax(rng, det_vars, source):
    variables = det_vars if source == "mtcnn_dr" else _random_like(det_vars, rng)
    n = DetectorNets()
    n.load_state_dict(detector_state_from_jax(variables))
    x24 = rng.uniform(-1, 1, (6, 24, 24, 3)).astype(np.float32)
    x48 = rng.uniform(-1, 1, (6, 48, 48, 3)).astype(np.float32)
    with torch.no_grad():
        tr = n.rnet(torch.from_numpy(x24))
        to = n.onet(torch.from_numpy(x48))
    jr = jnets.RNet().apply(variables["rnet"], jnp.asarray(x24))
    jo = jnets.ONet().apply(variables["onet"], jnp.asarray(x48))
    for a, b in zip(tr + to, tuple(jr) + tuple(jo)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-4)


@pytest.mark.parametrize("hw", [(12, 12), (13, 17), (23, 31), (48, 45)])
def test_pnet_matches_flax_on_odd_sizes(rng, nets, det_vars, hw):
    """Ceil-mode pooling: torch's ceil_mode equals the JAX package's
    explicit -inf padding rule on odd pyramid sizes."""
    x = rng.uniform(-1, 1, (2, *hw, 3)).astype(np.float32)
    with torch.no_grad():
        tp, treg = nets.pnet(torch.from_numpy(x))
    jp, jreg = jnets.PNet().apply(det_vars["pnet"], jnp.asarray(x))
    assert tp.shape == jp.shape and treg.shape == jreg.shape
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=1e-4)
    np.testing.assert_allclose(treg.numpy(), np.asarray(jreg), rtol=0, atol=1e-4)


def test_detector_state_is_complete(det_vars):
    sd = detector_state_from_jax(det_vars)
    assert set(sd) == set(DetectorNets().state_dict())


def test_cascade_f32_matches_jax():
    """The whole float32 cascade on fixture frames: same validity, boxes and
    landmarks within 1e-2 px."""
    with np.load(FIXTURE) as d:
        frames = d["tiles"][:2]
    kw = dict(det_size=(160, 160), max_faces=4, min_face_size=40)
    jd = JaxDetector(**kw, weights_path=WEIGHTS, crop_impl="matmul")
    td = MTCNNDetector(**kw, weights_path=WEIGHTS, crop_impl="matmul", device="cpu")
    assert td.scales == jd.scales
    a = jax.device_get(jd.detect_device(jnp.asarray(frames)))
    b = td.detect_device(torch.from_numpy(frames))
    np.testing.assert_array_equal(b["valid"].numpy(), a["valid"])
    v = a["valid"]
    assert v.any()
    np.testing.assert_allclose(b["bboxes"].numpy()[v], a["bboxes"][v], rtol=0, atol=1e-2)
    np.testing.assert_allclose(b["landmarks"].numpy()[v], a["landmarks"][v], rtol=0, atol=1e-2)
    np.testing.assert_allclose(b["scores"].numpy(), a["scores"], rtol=0, atol=1e-4)


def test_detector_options():
    with pytest.raises(ValueError):
        MTCNNDetector(det_size=(160, 160), crop_impl="kernel", device="cpu")  # f32
    with pytest.raises(ValueError):
        MTCNNDetector(det_size=(64, 64), min_face_size=100, device="cpu")
    d = MTCNNDetector(det_size=(160, 160), dtype=torch.bfloat16, device="cpu")
    assert d.crop_impl == "matmul"  # 'auto' picks the kernel on CUDA only
    r = MTCNNDetector(det_size=(160, 160), weights_path="random", device="cpu")
    assert not r.pretrained


# -------------------------------------------------------------- IR backbone


def _jax_backbone_vars(arch, seed=0):
    """JAX init with perturbed BN statistics and affine, so folding is
    exercised with non-trivial values."""
    model = jax_backbone(arch)
    v = _np(model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 112, 112, 3))))
    r = np.random.default_rng(seed)

    def perturb(tree):
        for k, node in tree.items():
            if isinstance(node, dict):
                perturb(node)
            elif k in ("mean", "bias"):
                tree[k] = (node + r.normal(0, 0.05, node.shape)).astype(np.float32)
            elif k in ("var", "scale"):
                tree[k] = (node * r.uniform(0.8, 1.2, node.shape)).astype(np.float32)

    perturb(v["batch_stats"])
    for name, node in v["params"].items():
        if "bn" in name and isinstance(node, dict):
            perturb({name: node})
    return model, v


@pytest.mark.parametrize("arch", ["ir_micro", "ir_18"])
def test_ir_backbone_matches_flax(rng, arch):
    model, v = _jax_backbone_vars(arch)
    x = rng.uniform(-1, 1, (2, 112, 112, 3)).astype(np.float32)
    jf, jn = model.apply(v, jnp.asarray(x))
    folded = jax_fold(v)
    jff, jfn = jax_backbone(arch, folded=True).apply(folded, jnp.asarray(x))
    for is_folded, vars_, (rf, rn) in ((False, v, (jf, jn)), (True, _np(folded), (jff, jfn))):
        m = build_backbone(arch, folded=is_folded)
        m.load_state_dict(backbone_state_from_jax(vars_, folded=is_folded))
        with torch.no_grad():
            tf, tn = m.eval()(torch.from_numpy(x))
        assert tf.shape == (2, 512) and tn.shape == (2, 1)
        assert _cos(tf.numpy(), np.asarray(rf)).min() >= 0.9999
        np.testing.assert_allclose(tn.numpy(), np.asarray(rn), rtol=1e-4)


def test_fold_matches_jax_fold():
    _, v = _jax_backbone_vars("ir_micro", seed=1)
    ours = fold_inference_variables(v)
    ref = _np(jax_fold(v))

    def walk(a, b):
        assert set(a) == set(b)
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k])
            else:
                np.testing.assert_array_equal(a[k], b[k])

    walk(ours, ref)


def test_backbone_state_checks_folding():
    _, v = _jax_backbone_vars("ir_micro")
    with pytest.raises(ValueError):
        backbone_state_from_jax(v, folded=True)
    with pytest.raises(ValueError):
        backbone_state_from_jax({"params": v["params"]}, folded=False)


# ----------------------------------------------------------------- embedder


def test_embedder_loads_jax_npz(rng, tmp_path):
    """A JAX-format .npz (unfolded) loads, folds and embeds like the JAX
    FaceEmbedder on the same file."""
    from facerecognitionpipeline_tpu.pipeline.embedder import FaceEmbedder as JaxEmbedder

    _, v = _jax_backbone_vars("ir_micro", seed=2)
    path = str(tmp_path / "ir_micro.npz")
    save_npz_variables(path, v)
    faces = rng.integers(0, 256, (3, 112, 112, 3)).astype(np.float32)
    ref = JaxEmbedder("ir_micro", model_path=path).extract_embeddings_batch(faces)
    emb = FaceEmbedder("ir_micro", model_path=path, device="cpu")
    assert emb.folded and emb.pretrained
    out = emb.extract_embeddings_batch(faces)
    assert _cos(out, ref).min() >= 0.9999
    # a .ckpt path loads through the importer now; a missing one raises as
    # in the JAX package
    for make in (lambda p: JaxEmbedder("ir_micro", model_path=p),
                 lambda p: FaceEmbedder("ir_micro", model_path=p, device="cpu")):
        with pytest.raises(FileNotFoundError, match="not found"):
            make(str(tmp_path / "w.ckpt"))


def test_embedder_random_init_is_seeded():
    a = FaceEmbedder("ir_micro", random_ok=True, init_seed=5, device="cpu")
    b = FaceEmbedder("ir_micro", random_ok=True, init_seed=5, device="cpu")
    c = FaceEmbedder("ir_micro", random_ok=True, init_seed=6, device="cpu")
    sa, sb, sc = (m.model.state_dict() for m in (a, b, c))
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["input_conv.weight"], sc["input_conv.weight"])
