"""The port's int8 tier, backbone side, against the JAX package's, on the CPU.

Held byte for byte: the synthetic renderers and the default calibration
sets, `load_calibration_faces`, `quantize_folded_variables` (codes, scales,
biases, activation scales, with and without headroom).

Held within a tolerance, with the reasons:
* `calibrate_activation_amax`: 1e-5 relative in float32 (sums in another
  order), 2e-2 in bf16 (a bf16 step is 2**-8 relative; XLA:CPU may keep
  fused bf16 intermediates in float32);
* `QuantConv`/`QuantDense` given the SAME quantized variables: activation
  codes equal but for a counted allowance of off-by-one flips (a float32
  product on a rounding boundary), s32 sums equal exactly given equal codes,
  outputs within 1e-6 relative in float32 and within one bf16 step in bf16
  (the JAX side compiled with XLA's excess precision off);
* the quantized backbone and `FaceEmbedder(quantize='int8')`: embeddings
  cosine >= 0.999 against the JAX package's on the same weights (a flipped
  code moves one sum by one weight step).

Backbone variants: ir_micro, and the IR-SE and iresnet (conv shortcut)
units at the same depth (one unit per stage).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerecognitionpipeline_tpu.evalharness import detection as jdetection
from facerecognitionpipeline_tpu.models import irse as jirse
from facerecognitionpipeline_tpu.models import quantize as jq
from facerecognitionpipeline_tpu.models.fold import fold_inference_variables as jax_fold
from facerecognitionpipeline_tpu.ops.image import preprocess_faces as jax_preprocess
from facerecognitionpipeline_tpu.ops.image import resize_bilinear as jax_resize
from facerecognitionpipeline_tpu.pipeline.embedder import FaceEmbedder as JaxEmbedder
from facerecognitionpipeline_tpu.train import detector_train as jtrain
from facerecognitionpipeline_tpu_torch.evalharness import detection as tdetection
from facerecognitionpipeline_tpu_torch.models import irse as tirse
from facerecognitionpipeline_tpu_torch.models import quantize as tq
from facerecognitionpipeline_tpu_torch.models.convert import (
    backbone_state_from_jax,
    params_from_state,
)
from facerecognitionpipeline_tpu_torch.ops import int8_gemm
from facerecognitionpipeline_tpu_torch.ops.image import preprocess_faces, resize_bilinear
from facerecognitionpipeline_tpu_torch.pipeline.embedder import FaceEmbedder
from facerecognitionpipeline_tpu_torch.train import detector_train as ttrain

torch.set_num_threads(2)

VARIANTS = {
    "ir_micro": {"use_se": False, "conv_shortcut": False},
    "ir_se_micro": {"use_se": True, "conv_shortcut": False},
    "iresnet_micro": {"use_se": False, "conv_shortcut": True},
}
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


def _cos(a, b):
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def _bf16_step(x):
    """Spacing of bf16 values around |x| (one unit in the last place)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 1e-30)))
    return 2.0 ** (e - 7)


# ---------------------------------------------------------------- renderers


@pytest.mark.parametrize("seed", [0, 1, 7, 1234])
def test_identity_renderer_equals_jax(seed):
    ident = ttrain.make_identity(seed)
    assert ident == jtrain.make_identity(seed)
    a = ttrain.render_identity_crop(ident, np.random.default_rng(seed), size=112)
    b = jtrain.render_identity_crop(ident, np.random.default_rng(seed), size=112)
    assert a.dtype == b.dtype == np.uint8 and a.tobytes() == b.tobytes()
    ia, ib = np.zeros((96, 96, 3), np.uint8), np.zeros((96, 96, 3), np.uint8)
    ra = ttrain.draw_identity_face(ia, ident, 48.3, 50.1, 30.0, 0.1)
    rb = jtrain.draw_identity_face(ib, ident, 48.3, 50.1, 30.0, 0.1)
    assert ia.tobytes() == ib.tobytes()
    for x, y in zip(ra, rb):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("category", tdetection.STRESS_CATEGORIES)
def test_stress_scene_equals_jax(category):
    assert tdetection.STRESS_CATEGORIES == jdetection.STRESS_CATEGORIES
    for seed in (0, 5):
        a, ba = tdetection.render_stress_scene(np.random.default_rng(seed), category, size=160)
        b, bb = jdetection.render_stress_scene(np.random.default_rng(seed), category, size=160)
        assert a.tobytes() == b.tobytes()
        np.testing.assert_array_equal(ba, bb)


def test_unknown_stress_category_raises_in_both():
    for mod in (tdetection, jdetection):
        with pytest.raises(ValueError, match="unknown stress category"):
            mod.render_stress_scene(np.random.default_rng(0), "nope", size=64)


@pytest.mark.parametrize("n,seed,size", [(8, 0, 112), (20, 3, 112), (6, 1, 96)])
def test_default_calibration_faces_equal_jax(n, seed, size):
    a = tq.default_calibration_faces(n, seed=seed, size=size)
    b = jq.default_calibration_faces(n, seed=seed, size=size)
    assert a.shape == (n, size, size, 3) and a.dtype == np.uint8
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("det_size,n,seed", [((160, 160), 6, 0), ((120, 160), 2, 4)])
def test_default_calibration_frames_equal_jax(det_size, n, seed):
    a = tq.default_calibration_frames(det_size=det_size, n=n, seed=seed)
    b = jq.default_calibration_frames(det_size=det_size, n=n, seed=seed)
    assert a.shape == (n, *det_size, 3) and a.dtype == np.uint8
    assert a.tobytes() == b.tobytes()


# ------------------------------------------------------ calibration crops


def _write_crops(root):
    import cv2

    rng = np.random.default_rng(3)
    os.makedirs(root / "sub", exist_ok=True)
    for i, (h, w) in enumerate([(112, 112), (90, 120), (112, 112), (140, 100)]):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        where = root / "sub" if i % 2 else root
        cv2.imwrite(str(where / f"f{i}.png"), img)
    (root / "notes.txt").write_text("not an image")


def test_load_calibration_faces_equals_jax(tmp_path):
    _write_crops(tmp_path)
    a = tq.load_calibration_faces(str(tmp_path))
    b = jq.load_calibration_faces(str(tmp_path))
    assert a.shape == (4, 112, 112, 3) and a.tobytes() == b.tobytes()
    a = tq.load_calibration_faces(str(tmp_path), size=64, limit=3)
    b = jq.load_calibration_faces(str(tmp_path), size=64, limit=3)
    assert a.shape == (3, 64, 64, 3) and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("which", ["empty", "missing"])
def test_load_calibration_faces_refuses_a_directory_without_images(tmp_path, which):
    d = tmp_path / "crops"
    if which == "empty":
        d.mkdir()
        (d / "readme.txt").write_text("no images")
    for mod in (tq, jq):
        with pytest.raises(ValueError, match="no readable calibration images"):
            mod.load_calibration_faces(str(d))


# ------------------------------------------------------------- backbones


def _jax_model(variant, folded=True, quantized=False, dtype=jnp.float32):
    return jirse.IRBackbone(units=(1, 1, 1, 1), folded=folded, quantized=quantized,
                            dtype=dtype, **VARIANTS[variant])


def _port_model(variant, quantized=False):
    return tirse.IRBackbone(units=(1, 1, 1, 1), folded=True, quantized=quantized,
                            **VARIANTS[variant])


@pytest.fixture(scope="module")
def calib():
    return tq.default_calibration_faces(8, seed=1)


@pytest.fixture(scope="module", params=list(VARIANTS))
def variant(request):
    """(name, folded float32 JAX-format variables, the JAX amax in float32,
    the JAX quantized variables)."""
    name = request.param
    model = jirse.IRBackbone(units=(1, 1, 1, 1), **VARIANTS[name])
    v = model.init(jax.random.PRNGKey(3), jnp.zeros((1, 112, 112, 3), jnp.float32))
    folded = _np(jax_fold(_np(v)))
    faces = tq.default_calibration_faces(8, seed=1)
    amax = jq.calibrate_activation_amax(
        _jax_model(name), folded, jax_preprocess(jnp.asarray(faces))
    )
    return name, folded, amax, _np(jq.quantize_folded_variables(folded, amax))


@pytest.mark.parametrize("headroom", [1.0, 1.25])
def test_quantize_folded_variables_bit_equal_to_jax(variant, headroom):
    _, folded, amax, _ = variant
    ours = tq.quantize_folded_variables(folded, amax, headroom=headroom)
    ref = _np(jq.quantize_folded_variables(folded, amax, headroom=headroom))
    _assert_trees_bit_equal(ours, ref)
    conv = ours["params"]["stage1_unit0"]["res_conv2"]
    assert conv["kernel_q"].dtype == np.int8 and conv["act_scale"].shape == ()


def test_quantize_folded_variables_needs_every_block(variant):
    _, folded, amax, _ = variant
    partial = {k: v for k, v in amax.items() if k != "stage2_unit0"}
    for mod in (tq, jq):
        with pytest.raises(ValueError, match="stage2_unit0"):
            mod.quantize_folded_variables(folded, partial)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_calibrate_activation_amax_matches_jax(variant, calib, dtype):
    name, folded, _, _ = variant
    jdt, tdt = DTYPES[dtype]
    model = _port_model(name)
    model.load_state_dict(backbone_state_from_jax(folded, folded=True))
    model = model.to(tdt).eval()
    ours = tq.calibrate_activation_amax(model, preprocess_faces(torch.from_numpy(calib), dtype=tdt))
    ref = jq.calibrate_activation_amax(
        _jax_model(name, dtype=jdt), folded, jax_preprocess(jnp.asarray(calib), dtype=jdt)
    )
    assert set(ours) == set(ref) and all(set(ours[k]) == set(ref[k]) for k in ref)
    rtol = 1e-5 if dtype == "float32" else 2e-2
    for blk in ref:
        for conv in ref[blk]:
            assert ours[blk][conv] == pytest.approx(ref[blk][conv], rel=rtol), (blk, conv)


def test_calibration_refuses_a_quantized_or_unfolded_backbone(calib):
    faces = preprocess_faces(torch.from_numpy(calib))
    for model in (_port_model("ir_micro", quantized=True),
                  tirse.IRBackbone(units=(1, 1, 1, 1), folded=False)):
        with pytest.raises(ValueError, match="folded float backbone"):
            tq.calibrate_activation_amax(model, faces)


def test_params_from_state_inverts_the_conversion(variant):
    name, folded, _, _ = variant
    model = _port_model(name)
    model.load_state_dict(backbone_state_from_jax(folded, folded=True))
    _assert_trees_bit_equal(params_from_state(model.state_dict()), folded["params"])


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_quantized_backbone_matches_jax(variant, dtype):
    """The same quantized variables (the JAX functions' output) in both
    backbones: embeddings cosine >= 0.999, norms within 1e-2 relative."""
    name, _, _, qvars = variant
    jdt, tdt = DTYPES[dtype]
    x = np.random.default_rng(2).uniform(-1, 1, (3, 112, 112, 3)).astype(np.float32)
    xin = jnp.asarray(x).astype(jdt)
    jf, jn = (jax.jit(_jax_model(name, quantized=True, dtype=jdt).apply)
              .lower(qvars, xin).compile(compiler_options=NO_EXCESS)(qvars, xin))
    model = _port_model(name, quantized=True)
    model.load_state_dict(backbone_state_from_jax(qvars, folded=True))
    model = model.to(tdt).eval()
    with torch.no_grad():
        tf, tn = model(torch.from_numpy(x).to(tdt))
    assert tf.dtype == torch.float32 and tf.shape == (3, 512)
    assert _cos(tf.numpy(), np.asarray(jf)).min() >= 0.999
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-2)


def test_quantized_backbone_needs_folding():
    with pytest.raises(ValueError, match="folded=True"):
        tirse.IRBackbone(units=(1, 1, 1, 1), folded=False, quantized=True)
    with pytest.raises(ValueError, match="folded=True"):
        tirse.build_backbone("ir_micro", quantized=True)


def test_quantized_layers_keep_float32_scales_under_a_cast(variant):
    name, _, _, qvars = variant
    model = _port_model(name, quantized=True)
    model.load_state_dict(backbone_state_from_jax(qvars, folded=True))
    model = model.to(torch.bfloat16)
    conv = model.stage0_unit0.res_conv1
    assert model.input_conv.weight.dtype == torch.bfloat16
    for buf in ("scale", "bias", "act_scale", "inv_act_scale", "out_scale"):
        assert getattr(conv, buf).dtype == torch.float32, buf
    assert conv.kernel_q.dtype == conv.gemm_w.dtype == torch.int8
    ref = qvars["params"]["stage0_unit0"]["res_conv1"]
    assert conv.scale.numpy().tobytes() == ref["scale"].tobytes()
    inv = np.float32(1.0) / np.float32(ref["act_scale"])
    assert conv.inv_act_scale.item() == inv
    np.testing.assert_array_equal(
        conv.out_scale.numpy(), np.float32(ref["act_scale"]) * ref["scale"]
    )


# ----------------------------------------------------- the quantized layers


CONV_CASES = {
    # (in_ch, out, ksize, stride, padding, h): the backbone's res convs,
    # the detector's VALID convs (K = 27 and N = 28, a 2x2 window)
    "res3x3": (16, 32, 3, 1, 1, 9),
    "res3x3_s2": (32, 32, 3, 2, 1, 10),
    "rnet_conv1": (3, 28, 3, 1, 0, 12),
    "onet_conv4": (64, 128, 2, 1, 0, 3),
}


def _quant_vars(rng, kshape, out):
    return {
        "kernel_q": rng.integers(-127, 128, kshape).astype(np.int8),
        "scale": rng.uniform(1e-3, 2e-2, out).astype(np.float32),
        "bias": rng.normal(0, 0.1, out).astype(np.float32),
        "act_scale": np.float32(rng.uniform(0.01, 0.03)),
    }


def _codes_jax(x, act_scale):
    xf = jnp.asarray(x).astype(jnp.float32)
    return np.asarray(jnp.clip(jnp.round(xf * (1.0 / act_scale)), -127, 127).astype(jnp.int8))


def _check_codes_and_sums(x_np, xq_t, act_scale, sums_jax, sums_t):
    """Codes: at most 0.1% off by one (and never more). Sums: equal."""
    codes_j = _codes_jax(x_np, act_scale)
    diff = np.abs(codes_j.astype(np.int16) - xq_t.astype(np.int16))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    np.testing.assert_array_equal(sums_t, sums_jax(xq_t))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CONV_CASES))
def test_quant_conv_matches_jax(case, dtype):
    cin, out, k, stride, pad, h = CONV_CASES[case]
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(11)
    v = _quant_vars(rng, (k, k, cin, out), out)
    x = (rng.normal(0, 1.0, (2, h, h, cin))).astype(np.float32)
    x = np.array(jnp.asarray(x).astype(jdt).astype(jnp.float32))  # dtype values
    jmod = jirse.QuantConv(out, (k, k), strides=stride, padding=pad, dtype=jdt)
    xin = jnp.asarray(x).astype(jdt)
    jy = (jax.jit(jmod.apply).lower({"params": v}, xin)
          .compile(compiler_options=NO_EXCESS)({"params": v}, xin))
    conv = tirse.QuantConv(cin, out, k, stride, pad)
    conv.load_state_dict({k_: torch.from_numpy(np.array(a)) for k_, a in v.items()})
    conv = conv.to(tdt)
    xt = torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2)
    with torch.no_grad():
        ty = conv(xt).permute(0, 2, 3, 1)
        xq = tirse.quantize_activation(xt.permute(0, 2, 3, 1), conv.inv_act_scale)
        sums = int8_gemm.int8_conv2d(xq, conv.gemm_w, (k, k), stride, pad, out)
    assert ty.dtype == tdt and tuple(ty.shape) == jy.shape

    def jax_sums(codes):
        dn = jax.lax.conv_dimension_numbers(codes.shape, v["kernel_q"].shape,
                                            ("NHWC", "HWIO", "NHWC"))
        return np.asarray(jax.lax.conv_general_dilated(
            jnp.asarray(codes), jnp.asarray(v["kernel_q"]), (stride, stride),
            [(pad, pad), (pad, pad)], dimension_numbers=dn,
            preferred_element_type=jnp.int32))

    _check_codes_and_sums(x, xq.numpy(), v["act_scale"], jax_sums, sums.numpy())
    a = np.asarray(jy.astype(jnp.float32))
    b = ty.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6)
    else:
        assert (np.abs(b - a) <= _bf16_step(a)).all()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("cin,out", [(576, 128), (1152, 256), (27, 28)])
def test_quant_dense_matches_jax(cin, out, dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(12)
    v = _quant_vars(rng, (cin, out), out)
    x = rng.normal(0, 1.0, (5, cin)).astype(np.float32)
    x = np.array(jnp.asarray(x).astype(jdt).astype(jnp.float32))
    xin = jnp.asarray(x).astype(jdt)
    jmod = jirse.QuantDense(out, dtype=jdt)
    jy = (jax.jit(jmod.apply).lower({"params": v}, xin)
          .compile(compiler_options=NO_EXCESS)({"params": v}, xin))
    dense = tirse.QuantDense(cin, out)
    dense.load_state_dict({k: torch.from_numpy(np.array(a)) for k, a in v.items()})
    dense = dense.to(tdt)
    xt = torch.from_numpy(x).to(tdt)
    with torch.no_grad():
        ty = dense(xt)
        xq = tirse.quantize_activation(xt, dense.inv_act_scale)
        sums = int8_gemm.int8_linear(xq, dense.gemm_w, out)

    def jax_sums(codes):
        return np.asarray(jax.lax.dot_general(
            jnp.asarray(codes), jnp.asarray(v["kernel_q"]), (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.int32))

    _check_codes_and_sums(x, xq.numpy(), v["act_scale"], jax_sums, sums.numpy())
    a = np.asarray(jy.astype(jnp.float32))
    b = ty.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6)
    else:
        assert (np.abs(b - a) <= _bf16_step(a)).all()


def test_activation_codes_round_half_to_even_and_clip():
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, 126.5, 300.0, -300.0, -127.5])
    got = tirse.quantize_activation(x, torch.ones(()))
    ref = _codes_jax(x.numpy(), np.float32(1.0))
    assert got.tolist() == [0, 2, 2, 0, -2, 126, 127, -127, -127] == ref.tolist()


def test_int32_to_bf16_casts_through_float32_in_both():
    """2**24 + 2**16 + 1 rounds to float32 2**24 + 2**16, which is a bf16 tie
    that rounds to even: 2**24. A direct int -> bf16 rounding would give
    2**24 + 2**17. Both frameworks go through float32."""
    v = 2 ** 24 + 2 ** 16 + 1
    t = torch.tensor([v, -v, 7], dtype=torch.int32).to(torch.bfloat16).float()
    j = np.asarray(jnp.asarray(np.array([v, -v, 7], np.int32)).astype(jnp.bfloat16)
                   .astype(jnp.float32))
    assert t.tolist() == j.tolist() == [16777216.0, -16777216.0, 7.0]


# ------------------------------------------------------------ the product


@pytest.mark.parametrize("m,k,n,want", [
    (1, 27, 28, (17, 32, 32)),
    (16, 32, 32, (17, 32, 32)),
    (17, 252, 48, (17, 256, 48)),
    (100, 576, 64, (100, 576, 64)),
    (5, 1, 1, (17, 8, 8)),
    (2048, 4608, 512, (2048, 4608, 512)),
])
def test_int8_gemm_geometry(m, k, n, want):
    assert int8_gemm.int8_gemm_geometry(m, k, n) == want


def test_int8_gemm_geometry_refuses_an_empty_product():
    with pytest.raises(ValueError):
        int8_gemm.int8_gemm_geometry(0, 8, 8)


@pytest.mark.parametrize("m,k,n", [(1, 27, 28), (16, 252, 28), (17, 256, 32), (33, 4608, 16),
                                   (7, 9, 5)])
def test_plain_product_equals_int64_matmul(m, k, n):
    rng = np.random.default_rng(m * 1000 + k)
    a = rng.integers(-127, 128, (m, k)).astype(np.int8)
    w = rng.integers(-127, 128, (k, n)).astype(np.int8)
    # the extremes, where a float32 sum would round: every product 127*127
    a[0] = 127
    w[:, 0] = 127
    packed = int8_gemm.pack_weight(torch.from_numpy(w))
    assert packed.shape == int8_gemm.int8_gemm_geometry(m, k, n)[:0:-1]
    assert packed.is_contiguous() and not packed[n:].any() and not packed[:, k:].any()
    got = int8_gemm.int8_linear(torch.from_numpy(a), packed, n)
    ref = a.astype(np.int64) @ w.astype(np.int64)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_float32_sums_of_a_full_window_are_not_exact():
    """Why the product is not a float32 conv over the int8 values: at
    K = 4608 the exact sum leaves float32's integer range."""
    k = 4608
    a = np.full((1, k), 127, np.int8)
    w = np.full((k, 8), 127, np.int8)
    w[0, 0] = 1  # column 0 sums to 4607 * 127**2 + 127, not a multiple of 8
    ref = a.astype(np.int64) @ w.astype(np.int64)
    f32 = torch.from_numpy(a).float() @ torch.from_numpy(w).float()
    got = int8_gemm.int8_linear(torch.from_numpy(a), int8_gemm.pack_weight(torch.from_numpy(w)), 8)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert ref[0, 0] == 4607 * 127 ** 2 + 127 > 2 ** 26
    assert f32[0, 0].item() != ref[0, 0]


def test_im2col_orders_the_window_like_an_hwio_kernel():
    x = torch.arange(2 * 4 * 5 * 3, dtype=torch.int64).reshape(2, 4, 5, 3).to(torch.int8)
    cols = int8_gemm.im2col(x, (3, 3), 1, 1, 32)
    assert cols.shape == (2 * 4 * 5, 32) and not cols[:, 27:].any()
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    # output pixel (b=1, y=2, x=3): rows of its 3x3 window, channels inner
    win = xp[1, 2:5, 3:6, :].reshape(-1)
    np.testing.assert_array_equal(cols[(1 * 4 + 2) * 5 + 3, :27].numpy(), win.numpy())
    with pytest.raises(ValueError):
        int8_gemm.im2col(x, (3, 3), 1, 0, 16)


def test_the_product_refuses_what_it_cannot_sum():
    w = int8_gemm.pack_weight(torch.ones((8, 8), dtype=torch.int8))
    with pytest.raises(TypeError):
        int8_gemm.int8_product(torch.ones((4, 8)), w, 8)
    with pytest.raises(ValueError):
        int8_gemm.int8_product(torch.ones((4, 16), dtype=torch.int8), w, 8)
    with pytest.raises(TypeError):
        int8_gemm.pack_weight(torch.ones((8, 8)))


# ---------------------------------------------------------------- images


@pytest.mark.parametrize("shape", [(112, 112), (160, 140), (64, 80), (113, 111)])
def test_preprocess_faces_matches_jax(shape):
    x = np.random.default_rng(4).integers(0, 256, (2, *shape, 3)).astype(np.uint8)
    a = np.asarray(jax_resize(jnp.asarray(x), 112, 112))
    b = resize_bilinear(torch.from_numpy(x), 112, 112)
    assert b.dtype == torch.float32
    np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=1e-4)  # 0-255 scale
    if shape == (112, 112):
        np.testing.assert_array_equal(b.numpy(), x.astype(np.float32))
    for jdt, tdt in DTYPES.values():
        a = np.asarray(jax_preprocess(jnp.asarray(x), dtype=jdt).astype(jnp.float32))
        b = preprocess_faces(torch.from_numpy(x), dtype=tdt)
        assert b.dtype == tdt and b.shape == (2, 112, 112, 3)
        tol = 1e-6 if tdt == torch.float32 else 8e-3
        np.testing.assert_allclose(b.float().numpy(), a, rtol=0, atol=tol)


# -------------------------------------------------------------- embedder


@pytest.fixture(scope="module")
def jax_micro():
    jemb = JaxEmbedder("ir_micro", random_ok=True, init_seed=4)
    return {"params": _np(jemb.variables["params"])}


@pytest.mark.parametrize("dtype,crop", [("float32", 112), ("bfloat16", 96)])
def test_embedder_int8_matches_jax(jax_micro, calib, dtype, crop):
    """Same float weights, same calibration crops (at 96 px they take the
    resize path): the same quantized tree within the amax tolerance, and
    embeddings cosine >= 0.999."""
    jdt, tdt = DTYPES[dtype]
    crops = calib if crop == 112 else tq.default_calibration_faces(8, seed=1, size=crop)
    jemb = JaxEmbedder("ir_micro", dtype=jdt, variables=jax_micro, quantize="int8",
                       calib_faces=crops)
    temb = FaceEmbedder("ir_micro", dtype=tdt, variables=jax_micro, quantize="int8",
                        calib_faces=crops, device="cpu")
    assert temb.quantized and jemb.quantized and temb.folded
    ref = _np(jemb.variables)["params"]["stage3_unit0"]["res_conv2"]
    conv = temb.model.stage3_unit0.res_conv2
    np.testing.assert_array_equal(conv.kernel_q.numpy(), ref["kernel_q"])
    rtol = 1e-5 if dtype == "float32" else 2e-2
    assert conv.act_scale.item() == pytest.approx(float(ref["act_scale"]), rel=rtol)
    faces = np.random.default_rng(6).integers(0, 256, (4, 112, 112, 3)).astype(np.float32)
    a = np.asarray(jemb.embed_batch_device(jnp.asarray(faces))[0])
    b = temb.embed_batch_device(torch.from_numpy(faces))[0].numpy()
    assert _cos(a, b).min() >= 0.999


def test_embedder_int8_defaults_to_the_synthetic_calibration_set(jax_micro, capsys,
                                                                 monkeypatch):
    """No calib_faces: `default_calibration_faces()` (64 renders), with a
    warning when the weights are pretrained and none when they are random."""
    calls = []
    render = tq.default_calibration_faces

    def default(*args, **kw):
        calls.append((args, kw))
        return render(4)

    monkeypatch.setattr(tq, "default_calibration_faces", default)
    temb = FaceEmbedder("ir_micro", variables=jax_micro, quantize="int8", device="cpu")
    assert temb.quantized and calls == [((), {})]
    assert "SYNTHETIC" in capsys.readouterr().err
    rnd = FaceEmbedder("ir_micro", random_ok=True, quantize="int8", device="cpu")
    assert rnd.quantized and not rnd.pretrained and len(calls) == 2
    assert "SYNTHETIC" not in capsys.readouterr().err


@pytest.mark.parametrize("kw,err", [
    ({"quantize": "int4"}, ValueError),
    ({"quantize": "int8", "fold_bn": False}, ValueError),
    ({"quantize": "int8", "calib_faces": np.zeros((0, 112, 112, 3), np.uint8)}, ValueError),
    ({"quantize": "int8", "calib_faces": np.zeros((4, 112, 112), np.uint8)}, ValueError),
    ({"quantize": "int8", "calib_faces": np.zeros((4, 112, 112, 4), np.uint8)}, ValueError),
])
def test_embedder_quantize_validation_as_jax(jax_micro, kw, err):
    with pytest.raises(err):
        JaxEmbedder("ir_micro", variables=jax_micro, **kw)
    with pytest.raises(err):
        FaceEmbedder("ir_micro", variables=jax_micro, device="cpu", **kw)


def test_embedder_int8_fused_is_queued(jax_micro, calib):
    """int8_fused, once queued, now builds the fused int8 body: the JAX
    package's fused embedder on the same weights and calibration crops
    within cosine 0.9999 (measured 1 - 6.0e-5: each package calibrates for
    itself, so 2304 of the 4.7 M fused constants differ in the last bit and
    codes flip by one in the later bodies; with bit-equal constants
    test_torch_port_train_numerics.py holds the fused body to 1e-6), and
    the port's unfused int8 embedder within the JAX package's
    fused-vs-unfused bound 0.9999 (measured 1 - 2.9e-5)."""
    jemb = JaxEmbedder("ir_micro", variables=jax_micro, quantize="int8", int8_fused=True,
                       calib_faces=calib)
    temb = FaceEmbedder("ir_micro", variables=jax_micro, quantize="int8", int8_fused=True,
                        calib_faces=calib, device="cpu")
    unfused = FaceEmbedder("ir_micro", variables=jax_micro, quantize="int8",
                           calib_faces=calib, device="cpu")
    assert isinstance(temb.model.stage0_unit0.body, tirse.FusedQuantBody)
    faces = np.random.default_rng(6).integers(0, 256, (4, 112, 112, 3)).astype(np.float32)
    a = np.asarray(jemb.embed_batch_device(jnp.asarray(faces))[0])
    b = temb.embed_batch_device(torch.from_numpy(faces))[0].numpy()
    c = unfused.embed_batch_device(torch.from_numpy(faces))[0].numpy()
    assert _cos(a, b).min() >= 0.9999
    assert _cos(b, c).min() > 0.9999


def test_random_embedder_quantizes_its_float32_weights(calib):
    """A bf16 embedder from the seeded random init quantizes the float32
    weights (as the JAX package quantizes its float32 folded tree), not the
    bf16-cast module's."""
    crops = calib[:4]
    q = FaceEmbedder("ir_micro", random_ok=True, init_seed=2, dtype=torch.bfloat16,
                     quantize="int8", calib_faces=crops, device="cpu")
    bf16 = FaceEmbedder("ir_micro", random_ok=True, init_seed=2, dtype=torch.bfloat16,
                        device="cpu")
    f32 = FaceEmbedder("ir_micro", random_ok=True, init_seed=2, device="cpu")
    amax = tq.calibrate_activation_amax(
        bf16.model, preprocess_faces(torch.from_numpy(crops), dtype=torch.bfloat16))
    ref = jq.quantize_folded_variables({"params": params_from_state(f32.model.state_dict())},
                                       amax)["params"]
    sd = q.model.state_dict()
    for unit in ("stage0_unit0", "stage3_unit0"):
        for conv in ("res_conv1", "res_conv2"):
            node = ref[unit][conv]
            for leaf in ("kernel_q", "scale", "act_scale"):
                got = sd[f"{unit}.{conv}.{leaf}"].numpy()
                assert got.tobytes() == np.asarray(node[leaf]).tobytes(), (unit, conv, leaf)
    assert sd["input_conv.weight"].dtype == torch.bfloat16
