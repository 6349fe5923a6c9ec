"""The port's int8 detector (quantized R-net and O-net) against the JAX
package's, on the CPU, with the trained `pretrained/mtcnn_dr.npz` weights and
tiles of the port's smoke fixture at det_size 160.

Held byte for byte: `quantize_detector_variables` (codes, scales, biases,
activation scales). Held within a tolerance:
* `calibrate_amax`: 1e-4 relative in float32; 3e-2 in bf16, where the JAX
  side's jitted cascade may keep fused bf16 intermediates in float32 (a
  bf16 step is 2**-8 relative, and one crop value that moves by a step
  moves the amax of a later layer by a few);
* the quantized nets on the SAME quantized variables: probabilities,
  regressions and landmarks within 1e-4 in float32 and 2e-2 in bf16 (the
  JAX side compiled with XLA's excess precision off);
* the quantized cascade on the same variables: the same valid slots, boxes
  and landmarks within 1 px, scores within 2e-2.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerecognitionpipeline_tpu.models import detector_nets as jnets
from facerecognitionpipeline_tpu.models import quantize as jq
from facerecognitionpipeline_tpu.models.detector import MTCNNDetector as JaxDetector
from facerecognitionpipeline_tpu_torch.models import quantize as tq
from facerecognitionpipeline_tpu_torch.models.convert import (
    detector_state_from_jax,
    detector_variables_from_state,
)
from facerecognitionpipeline_tpu_torch.models.detector import MTCNNDetector
from facerecognitionpipeline_tpu_torch.models.detector_nets import DetectorNets
from facerecognitionpipeline_tpu_torch.models.irse import QuantConv, QuantDense
from facerecognitionpipeline_tpu_torch.utils.io import load_npz_variables

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, "pretrained", "mtcnn_dr.npz")
FIXTURE = os.path.join(REPO, "facerecognitionpipeline_tpu_torch", "testdata", "smoke_scenes.npz")
DET = dict(det_size=(160, 160), max_faces=4, min_face_size=40, crop_impl="matmul")
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
NO_EXCESS = {"xla_allow_excess_precision": False}


def _np(tree):
    if hasattr(tree, "items"):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree)


def _assert_trees_bit_equal(a, b, where=""):
    assert set(a) == set(b), where
    for k in a:
        if isinstance(a[k], dict):
            _assert_trees_bit_equal(a[k], b[k], f"{where}/{k}")
        else:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.dtype == y.dtype and x.shape == y.shape, f"{where}/{k}"
            assert x.tobytes() == y.tobytes(), f"{where}/{k}"


@pytest.fixture(scope="module")
def frames():
    with np.load(FIXTURE) as d:
        return np.ascontiguousarray(d["tiles"][:3])


@pytest.fixture(scope="module")
def calib():
    return tq.default_calibration_frames(det_size=(160, 160), n=2)


@pytest.fixture(scope="module")
def float_vars():
    return load_npz_variables(WEIGHTS)


@pytest.fixture(scope="module")
def jax_amax(calib):
    return {name: JaxDetector(**DET, weights_path=WEIGHTS, dtype=jdt).calibrate_amax(calib)
            for name, (jdt, _) in DTYPES.items()}


@pytest.fixture(scope="module")
def qvars(float_vars, jax_amax):
    """The JAX package's quantized variables of mtcnn_dr (float32 amax)."""
    return _np(jq.quantize_detector_variables(float_vars, jax_amax["float32"]))


# -------------------------------------------------------------- quantization


@pytest.mark.parametrize("headroom", [1.0, 1.5])
def test_quantize_detector_variables_bit_equal_to_jax(float_vars, jax_amax, headroom):
    ours = tq.quantize_detector_variables(float_vars, jax_amax["float32"], headroom=headroom)
    ref = _np(jq.quantize_detector_variables(float_vars, jax_amax["float32"], headroom=headroom))
    _assert_trees_bit_equal(ours, ref)
    for net, layers in (("rnet", ("conv1", "conv2", "conv3", "fc1")),
                        ("onet", ("conv1", "conv2", "conv3", "conv4", "fc1"))):
        params = ours[net]["params"]
        assert {k for k in params if "kernel_q" in params[k]} == set(layers)
    assert "kernel_q" not in str(ours["pnet"])


def test_quantize_detector_variables_needs_both_nets(float_vars, jax_amax):
    partial = {"rnet": jax_amax["float32"]["rnet"]}
    for mod in (tq, jq):
        with pytest.raises(KeyError):
            mod.quantize_detector_variables(float_vars, partial)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_calibrate_amax_matches_jax(calib, jax_amax, dtype):
    _, tdt = DTYPES[dtype]
    ours = MTCNNDetector(**DET, weights_path=WEIGHTS, dtype=tdt, device="cpu").calibrate_amax(calib)
    ref = jax_amax[dtype]
    assert {n: set(v) for n, v in ours.items()} == {n: set(v) for n, v in ref.items()}
    rtol = 1e-4 if dtype == "float32" else 3e-2
    for net in ref:
        for layer in ref[net]:
            assert ours[net][layer] == pytest.approx(ref[net][layer], rel=rtol), (net, layer)


# ------------------------------------------------------------ quantized nets


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("net", ["rnet", "onet"])
def test_quantized_nets_match_jax(qvars, net, dtype):
    jdt, tdt = DTYPES[dtype]
    size = 24 if net == "rnet" else 48
    x = np.random.default_rng(3).uniform(-1, 1, (6, size, size, 3)).astype(np.float32)
    x = np.array(jnp.asarray(x).astype(jdt).astype(jnp.float32))
    jmod = (jnets.RNet if net == "rnet" else jnets.ONet)(dtype=jdt, quantized=True)
    xin = jnp.asarray(x).astype(jdt)
    ref = jax.jit(jmod.apply).lower(qvars[net], xin).compile(compiler_options=NO_EXCESS)(
        qvars[net], xin)
    nets = DetectorNets(quantized=True)
    nets.load_state_dict(detector_state_from_jax(qvars))
    nets = nets.to(tdt).eval()
    module = getattr(nets, net)
    assert isinstance(module.conv1, QuantConv) and isinstance(module.fc1, QuantDense)
    with torch.no_grad():
        out = module(torch.from_numpy(x))
    tol = 1e-4 if dtype == "float32" else 2e-2
    for a, b in zip(ref, out):
        assert b.dtype == torch.float32
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=tol)


def _jax_detect(jd, frames):
    args = (jd.variables, jnp.asarray(frames))
    return jax.device_get(
        jax.jit(jax.vmap(jd._cascade, in_axes=(None, 0))).lower(*args)
        .compile(compiler_options=NO_EXCESS)(*args)
    )


def _assert_detections_agree(a, b):
    b = {k: v.numpy() for k, v in b.items()}
    np.testing.assert_array_equal(b["valid"], a["valid"])
    v = a["valid"]
    assert v.sum() >= 3
    np.testing.assert_allclose(b["bboxes"][v], a["bboxes"][v], rtol=0, atol=1.0)
    np.testing.assert_allclose(b["landmarks"][v], a["landmarks"][v], rtol=0, atol=1.0)
    np.testing.assert_allclose(b["scores"], a["scores"], rtol=0, atol=2e-2)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_quantized_cascade_matches_jax(qvars, frames, dtype):
    """Both detectors given the same quantized variables (no calibration)."""
    jdt, tdt = DTYPES[dtype]
    jd = JaxDetector(**DET, variables=qvars, dtype=jdt, quantize="int8")
    td = MTCNNDetector(**DET, variables=qvars, dtype=tdt, quantize="int8", device="cpu")
    assert td.quantized and jd.quantized
    _assert_detections_agree(_jax_detect(jd, frames), td.detect_device(torch.from_numpy(frames)))


def test_calibrated_detectors_agree(calib, frames):
    """Each package calibrates and quantizes on its own (float32): the same
    detections."""
    jd = JaxDetector(**DET, weights_path=WEIGHTS, quantize="int8", calib_frames=calib)
    td = MTCNNDetector(**DET, weights_path=WEIGHTS, quantize="int8", calib_frames=calib,
                       device="cpu")
    _assert_detections_agree(_jax_detect(jd, frames), td.detect_device(torch.from_numpy(frames)))


def test_jax_saved_quantized_detector_loads_without_recalibration(tmp_path, calib, frames,
                                                                  monkeypatch):
    jd = JaxDetector(**DET, weights_path=WEIGHTS, quantize="int8", calib_frames=calib)
    path = str(tmp_path / "mtcnn_int8.npz")
    jd.save_npz(path)

    def refuse(*_a, **_k):
        raise AssertionError("a quantized .npz must not be calibrated again")

    monkeypatch.setattr(MTCNNDetector, "calibrate_amax", refuse)
    td = MTCNNDetector(**DET, weights_path=path, quantize="int8", device="cpu")
    assert td.quantized and td.pretrained
    _assert_detections_agree(_jax_detect(jd, frames), td.detect_device(torch.from_numpy(frames)))
    for cls, kw in ((MTCNNDetector, {"device": "cpu"}), (JaxDetector, {})):
        with pytest.raises(ValueError, match="int8-quantized"):
            cls(**DET, weights_path=path, **kw)


def test_detector_quantize_options(calib):
    for cls, kw in ((MTCNNDetector, {"device": "cpu"}), (JaxDetector, {})):
        with pytest.raises(ValueError, match="Unknown quantize mode"):
            cls(**DET, weights_path=WEIGHTS, quantize="int4", **kw)
    td = MTCNNDetector(**DET, weights_path=WEIGHTS, quantize="int8", calib_frames=calib,
                       device="cpu")
    with pytest.raises(RuntimeError, match="already quantized"):
        td.calibrate_amax(calib)


def test_default_calibration_frames_at_det_size(monkeypatch, calib):
    seen = []

    def default(det_size=(640, 640), n=6, seed=0):
        seen.append(det_size)
        return calib

    monkeypatch.setattr(tq, "default_calibration_frames", default)
    td = MTCNNDetector(**DET, weights_path=WEIGHTS, quantize="int8", device="cpu")
    assert td.quantized and seen == [(160, 160)]


def test_random_detector_quantizes_its_float32_weights(calib):
    """A bf16 detector from the seeded random init quantizes the float32
    weights (as the JAX package quantizes its float32 tree), not the
    bf16-cast module's."""
    td = MTCNNDetector(**DET, weights_path="random", dtype=torch.bfloat16, quantize="int8",
                       calib_frames=calib, device="cpu")
    plain = MTCNNDetector(**DET, weights_path="random", dtype=torch.bfloat16, device="cpu")
    amax = plain.calibrate_amax(calib)
    f32 = MTCNNDetector(**DET, weights_path="random", device="cpu")
    ref = jq.quantize_detector_variables(
        detector_variables_from_state(f32.nets.state_dict()), amax)
    sd = td.nets.state_dict()
    for net, layer in (("rnet", "conv2"), ("onet", "fc1")):
        node = ref[net]["params"][layer]
        assert sd[f"{net}.{layer}.kernel_q"].numpy().tobytes() == node["kernel_q"].tobytes()
        assert sd[f"{net}.{layer}.scale"].numpy().tobytes() == node["scale"].tobytes()
        assert sd[f"{net}.{layer}.act_scale"].item() == float(node["act_scale"])
    assert sd["pnet.conv1.weight"].dtype == torch.bfloat16
