"""The host pipeline's image ops against the JAX package's.

`warp_affine`, `bilinear_sample`, `warp_affine_single`, `crop_resize_gather`
and `align_faces` are XLA gathers in the JAX package and plain PyTorch in the
port (no kernel); `augment_batch` is the enrolment augmentation. Inputs come
from numpy seeds and go through both. Tolerances:

* resampling with the same coordinates: within 1e-3 on the 0..255 scale
  (the JAX functions run eagerly here, op by op; compiled, XLA:CPU may
  contract `a0*x + a1*y` into an FMA and move a value by a few 1e-3);
* `align_faces`: the similarity fit sums in another order (matrices ~1e-5
  apart), so float crops within 2e-2 and crops after round/clip within one
  grey level;
* `augment_batch`: variants 1-15 within one grey level after rounding (the
  rotations' source coordinates carry the same ulp differences); the noise
  variant (16) draws from a torch.Generator, not jax.random, and is held by
  its statistics: mean within 0.5 and standard deviation 3 +- 0.5 before
  clipping, measured on mid-grey faces where nothing clips.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from facerecognitionpipeline_tpu.ops import augment as jaug
from facerecognitionpipeline_tpu.ops import image as jimage
from facerecognitionpipeline_tpu.ops import warp as jwarp
from facerecognitionpipeline_tpu_torch.ops import augment as taug
from facerecognitionpipeline_tpu_torch.ops import image as timage
from facerecognitionpipeline_tpu_torch.ops import warp as twarp

T = torch.from_numpy


@pytest.fixture
def image():
    return np.random.default_rng(1).integers(0, 256, (90, 120, 3)).astype(np.float32)


@pytest.mark.parametrize("border", ["zero", "replicate"])
@pytest.mark.parametrize("where", ["inside", "edges", "outside", "mixed"])
def test_bilinear_sample_like_jax(image, border, where):
    rng = np.random.default_rng(2)
    h, w = image.shape[:2]
    if where == "inside":
        sx, sy = rng.uniform(0, w - 1, (9, 11)), rng.uniform(0, h - 1, (9, 11))
    elif where == "edges":  # on and half a pixel around the first/last rows
        sx = rng.choice([-0.5, 0.0, 0.25, w - 1.25, w - 1.0, w - 0.5], (9, 11))
        sy = rng.choice([-0.5, 0.0, 0.75, h - 1.5, h - 1.0, h - 0.5], (9, 11))
    elif where == "outside":
        sx, sy = rng.uniform(-40, -2, (9, 11)), rng.uniform(h + 2, h + 40, (9, 11))
    else:
        sx, sy = rng.uniform(-10, w + 10, (9, 11)), rng.uniform(-10, h + 10, (9, 11))
    sx, sy = sx.astype(np.float32), sy.astype(np.float32)
    want = np.asarray(jwarp.bilinear_sample(jnp.asarray(image), jnp.asarray(sx), jnp.asarray(sy),
                                            border=border))
    got = twarp.bilinear_sample(T(image), T(sx), T(sy), border=border).numpy()
    assert got.shape == want.shape == (9, 11, 3)
    np.testing.assert_allclose(got, want, atol=1e-3)
    if where == "outside":
        assert (got == 0).all() if border == "zero" else (got > 0).any()


def test_bilinear_sample_refuses_unknown_border(image):
    with pytest.raises(ValueError, match="border"):
        twarp.bilinear_sample(T(image), torch.zeros(2), torch.zeros(2), border="wrap")


def _matrices(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        a = rng.uniform(-0.3, 0.3)
        s = rng.uniform(0.6, 1.4)
        out.append([[s * np.cos(a), -s * np.sin(a), rng.uniform(-20, 20)],
                    [s * np.sin(a), s * np.cos(a), rng.uniform(-20, 20)]])
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("out_hw", [(112, 112), (50, 70)])
def test_warp_affine_like_jax(image, out_hw):
    images = np.stack([image, image[::-1].copy(), image[:, ::-1].copy()])
    mats = _matrices(3, 3)
    want = np.asarray(jwarp.warp_affine(jnp.asarray(images), jnp.asarray(mats), *out_hw))
    got = twarp.warp_affine(T(images), T(mats), *out_hw).numpy()
    assert got.shape == want.shape == (3, *out_hw, 3)
    np.testing.assert_allclose(got, want, atol=1e-3)
    assert twarp.warp_affine(T(images[:0]), T(mats[:0]), *out_hw).shape == (0, *out_hw, 3)


def test_warp_affine_single_like_jax(image):
    mats = _matrices(4, 4)
    want = np.asarray(jwarp.warp_affine_single(jnp.asarray(image), jnp.asarray(mats), 112, 96))
    got = twarp.warp_affine_single(T(image), T(mats), 112, 96).numpy()
    assert got.shape == (4, 112, 96, 3)
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_crop_resize_gather_like_jax(image):
    boxes = np.array([[3, 4, 50, 60], [-5, -5, 20, 30], [100, 80, 130, 100],
                      [10, 10, 10, 10]], np.float32)
    for size in (24, 48):
        want = np.asarray(jwarp.crop_resize_gather(jnp.asarray(image), jnp.asarray(boxes), size))
        got = twarp.crop_resize_gather(T(image), T(boxes), size).numpy()
        np.testing.assert_allclose(got, want, atol=1e-3)


@pytest.mark.parametrize("output_size", [112, 224])
def test_align_faces_like_jax(image, output_size):
    rng = np.random.default_rng(5)
    tmpl = jwarp.reference_template(output_size)
    base = jwarp.reference_template(112) * 0.6
    lm = (base[None] + rng.uniform(0, 50, (4, 1, 2)) + rng.normal(0, 1.5, (4, 5, 2)))
    lm = lm.astype(np.float32)
    want = np.asarray(jwarp.align_faces(jnp.asarray(image), jnp.asarray(lm), jnp.asarray(tmpl),
                                        output_size))
    got = twarp.align_faces(T(image), T(lm), T(tmpl), output_size).numpy()
    assert got.shape == (4, output_size, output_size, 3)
    np.testing.assert_allclose(got, want, atol=2e-2)
    rw, rg = (np.clip(np.round(a), 0, 255) for a in (want, got))
    assert np.abs(rw - rg).max() <= 1


def test_rgb_to_bgr_like_jax(image):
    want = np.asarray(jimage.rgb_to_bgr(jnp.asarray(image[None])))
    got = timage.rgb_to_bgr(T(image[None])).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def faces():
    return np.random.default_rng(6).integers(0, 256, (3, 112, 112, 3)).astype(np.uint8)


@pytest.fixture(scope="module")
def augmented(faces):
    want = np.asarray(jaug.augment_batch(jnp.asarray(faces), 0, num_augmentations=16))
    got = taug.augment_batch(T(faces), seed=0, num_augmentations=16).numpy()
    return want, got


@pytest.mark.parametrize("variant", range(15))
def test_augment_variants_like_jax(augmented, variant):
    want, got = augmented
    assert got.shape == want.shape == (3, 16, 112, 112, 3) and got.dtype == np.float32
    a, b = want[:, variant], got[:, variant]
    assert np.abs(a - b).max() <= 1
    assert (a != b).mean() < 1e-3  # off by one on a rounding boundary only


def test_augment_noise_variant_statistics():
    grey = np.full((4, 112, 112, 3), 128, np.uint8)
    out = taug.augment_batch(T(grey), seed=0, num_augmentations=16)[:, 15].numpy()
    # rounding adds a uniform error of variance 1/12 to the noise's 9
    noise = out - 128.0
    assert abs(noise.mean()) < 0.5
    assert abs(noise.std() - 3.0) < 0.5
    again = taug.augment_batch(T(grey), seed=0, num_augmentations=16)[:, 15].numpy()
    other = taug.augment_batch(T(grey), seed=1, num_augmentations=16)[:, 15].numpy()
    np.testing.assert_array_equal(out, again)  # deterministic given the seed
    assert (out != other).any()


def test_augment_default_subset_and_limits(faces, augmented):
    want, _ = augmented
    got = taug.augment_batch(T(faces)).numpy()  # default 8: orig, flip, rotations, -20/-10
    assert got.shape == (3, 8, 112, 112, 3)
    assert np.abs(got - want[:, :8]).max() <= 1
    np.testing.assert_array_equal(got[:, 0], faces.astype(np.float32))
    np.testing.assert_array_equal(got[:, 1], faces[:, :, ::-1].astype(np.float32))
    assert taug.NUM_VARIANTS == jaug.NUM_VARIANTS == 16
    for n in (0, 17):
        with pytest.raises(ValueError, match="num_augmentations"):
            taug.augment_batch(T(faces), num_augmentations=n)
