"""The port's plain ops (image, nms, warp geometry, quality) against the JAX
package's, on the CPU, in float32. Inputs come from numpy seeds.

Tolerance: 1e-5 (absolute and relative) unless a test says otherwise;
most of these agree bit for bit, the sums (means, variances, the
similarity fit) only up to their summation order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerecognitionpipeline_tpu.ops import image as jimage
from facerecognitionpipeline_tpu.ops import nms as jnms
from facerecognitionpipeline_tpu.ops import quality as jquality
from facerecognitionpipeline_tpu.ops import warp as jwarp
from facerecognitionpipeline_tpu_torch.ops import image, nms, quality, warp

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


def _boxes(rng, n, s=100.0, clusters=6):
    """Boxes in overlapping clusters, so NMS has suppression chains."""
    centers = rng.uniform(10, s - 10, (clusters, 2))
    c = centers[rng.integers(0, clusters, n)] + rng.normal(0, 3, (n, 2))
    wh = rng.uniform(8, 30, (n, 2))
    return np.concatenate([c - wh / 2, c + wh / 2], axis=1).astype(np.float32)


# ------------------------------------------------------------------ image


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_normalize_face_batch(rng, dtype):
    faces = rng.integers(0, 256, (3, 8, 8, 3)).astype(np.uint8)
    ref = np.asarray(
        jimage.normalize_face_batch(jnp.asarray(faces), dtype=getattr(jnp, dtype))
    ).astype(np.float32)
    out = image.normalize_face_batch(_t(faces), dtype=getattr(torch, dtype)).float()
    np.testing.assert_array_equal(out.numpy(), ref)


def test_rgb_to_gray(rng):
    x = rng.uniform(0, 255, (2, 9, 7, 3)).astype(np.float32)
    np.testing.assert_allclose(
        image.rgb_to_gray(_t(x)).numpy(), np.asarray(jimage.rgb_to_gray(jnp.asarray(x))),
        **TOL,
    )


def test_i420_to_rgb(rng):
    yuv = rng.integers(0, 256, (2, 24, 12)).astype(np.uint8)
    ref = np.asarray(jimage.i420_to_rgb(jnp.asarray(yuv), 16, 12))
    out = image.i420_to_rgb(_t(yuv), 16, 12).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-4)
    with pytest.raises(ValueError):
        image.i420_to_rgb(_t(yuv), 18, 12)


# -------------------------------------------------------------------- nms


@pytest.mark.parametrize("mode", ["union", "min"])
def test_pairwise_iou(rng, mode):
    b = _boxes(rng, 20)
    np.testing.assert_allclose(
        nms.pairwise_iou(_t(b), mode).numpy(),
        np.asarray(jnms.pairwise_iou(jnp.asarray(b), mode)), **TOL,
    )


@pytest.mark.parametrize("mode,thr", [("union", 0.5), ("union", 0.3), ("min", 0.7)])
def test_nms_mask(rng, mode, thr):
    n = 64
    boxes = _boxes(rng, n)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    scores[5] = scores[9]  # a tie: the lower index ranks first
    valid = rng.uniform(0, 1, n) > 0.2
    ref = np.asarray(jnms.nms_mask(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid),
        iou_threshold=thr, mode=mode,
    ))
    out = nms.nms_mask(_t(boxes), _t(scores), _t(valid), iou_threshold=thr, mode=mode)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_nms_mask_batched_equals_per_frame(rng):
    """One batched NMS == the per-frame NMS of every frame, also when the
    frames need different numbers of sweeps (a long chain in frame 0)."""
    n = 40
    chain = np.stack([[i * 6.0, 0, i * 6.0 + 10, 10] for i in range(n)]).astype(np.float32)
    frames = [chain, _boxes(rng, n)]
    scores = [np.linspace(1, 0.1, n).astype(np.float32), rng.uniform(0, 1, n).astype(np.float32)]
    valid = np.ones((2, n), bool)
    out = nms.nms_mask(_t(np.stack(frames)), _t(np.stack(scores)), _t(valid), 0.3)
    for i in range(2):
        ref = np.asarray(jnms.nms_mask(
            jnp.asarray(frames[i]), jnp.asarray(scores[i]), jnp.asarray(valid[i]),
            iou_threshold=0.3,
        ))
        np.testing.assert_array_equal(out[i].numpy(), ref)


def test_topk_boxes(rng):
    boxes = _boxes(rng, 30)
    scores = rng.uniform(0, 1, 30).astype(np.float32)
    valid = rng.uniform(0, 1, 30) > 0.5
    jb, js, jv = jnms.topk_boxes(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid), 20)
    tb, ts, tv = nms.topk_boxes(_t(boxes), _t(scores), _t(valid), 20)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# ----------------------------------------------------------- warp geometry


def _landmarks(rng, n):
    tpl = jwarp.reference_template(112) - 56.0
    out = []
    for _ in range(n):
        th = rng.uniform(-0.5, 0.5)
        rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
        out.append(tpl @ rot.T * rng.uniform(0.3, 2.0) + rng.uniform(0, 300, 2)
                   + rng.normal(0, 1.5, (5, 2)))
    return np.stack(out).astype(np.float32)


def test_reference_template():
    np.testing.assert_array_equal(warp.reference_template(112), jwarp.reference_template(112))


def test_similarity_and_inverse(rng):
    lm = _landmarks(rng, 12)
    lm[3] = lm[3][0]  # degenerate: all points equal
    tpl = jwarp.reference_template(112)
    jm = np.asarray(jwarp.similarity_transform(jnp.asarray(lm), jnp.asarray(tpl)))
    tm = warp.similarity_transform(_t(lm), _t(tpl)).numpy()
    np.testing.assert_allclose(tm, jm, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(
        warp.invert_affine(_t(jm)).numpy(),
        np.asarray(jwarp.invert_affine(jnp.asarray(jm))), **TOL,
    )


def test_source_windows_and_coeffs(rng):
    """Same inputs (the JAX similarity matrices), same windows and coeffs;
    faces that fit the patch snap to integer windows of exactly 128 px."""
    lm = _landmarks(rng, 16)
    jm = jwarp.similarity_transform(jnp.asarray(lm), jnp.asarray(jwarp.reference_template(112)))
    jinv, jbox = jwarp._source_windows(jm, 112, 112, 128)
    tinv, tbox = warp.source_windows(_t(np.asarray(jm)), 112, 112, 128)
    np.testing.assert_allclose(tinv.numpy(), np.asarray(jinv), **TOL)
    np.testing.assert_allclose(tbox.numpy(), np.asarray(jbox), **TOL)
    snapped = (tbox[:, 2] - tbox[:, 0]).numpy() == 128
    assert snapped.any() and (~snapped).any()
    np.testing.assert_array_equal(tbox.numpy()[snapped], np.asarray(jbox)[snapped])
    assert np.all(tbox.numpy()[snapped] == np.round(tbox.numpy()[snapped]))
    jb, jc = jwarp.warp_coeffs(jm, 112, 112, 128)
    tb, tc = warp.warp_coeffs(_t(np.asarray(jm)), 112, 112, 128)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), **TOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_crop_resize(rng, dtype):
    img = rng.uniform(-1, 1, (40, 56, 3)).astype(np.float32)
    boxes = np.array(
        [[0, 0, 56, 40], [-4, 3, 20, 30], [10.5, 7.25, 50.1, 39.9]], np.float32
    )
    ref = np.asarray(jwarp.crop_resize(
        jnp.asarray(img), jnp.asarray(boxes), 20, compute_dtype=getattr(jnp, dtype)
    ))
    out = warp.crop_resize(_t(img), _t(boxes), 20, compute_dtype=getattr(torch, dtype))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


# ---------------------------------------------------------------- quality


def test_laplacian_blur_score(rng):
    faces = rng.integers(0, 256, (2, 3, 16, 16, 3)).astype(np.float32)
    faces[0, 0] = 128.0  # flat: zero variance
    ref = np.stack([
        np.asarray(jquality.laplacian_blur_score(jnp.asarray(f))) for f in faces
    ])
    out = quality.laplacian_blur_score(_t(faces)).numpy()
    assert out.shape == (2, 3) and out[0, 0] == 0
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-3)
    gray = faces[..., 0]
    np.testing.assert_allclose(
        quality.laplacian_blur_score(_t(gray[0])).numpy(),
        np.asarray(jquality.laplacian_blur_score(jnp.asarray(gray[0]))), rtol=1e-5,
    )


def test_pose_angles(rng):
    lm = _landmarks(rng, 10)
    ref = jquality.pose_angles(jnp.asarray(lm))
    out = quality.pose_angles(_t(lm))
    for k in ("yaw", "pitch", "roll"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=1e-5, atol=1e-4)


def test_quality_check(rng):
    n = 12
    lm = _landmarks(rng, n)
    boxes = np.concatenate([lm.min(1) - 10, lm.max(1) + 10], axis=1).astype(np.float32)
    scores = rng.uniform(0.3, 1, n).astype(np.float32)
    faces = rng.integers(0, 256, (n, 16, 16, 3)).astype(np.float32)
    faces[:4] = 100.0  # blurry
    valid = rng.uniform(0, 1, n) > 0.2
    cfg = quality.QualityConfig(min_det_score=0.5, min_face_size=40, blur_threshold=50.0)
    jcfg = jquality.QualityConfig(min_det_score=0.5, min_face_size=40, blur_threshold=50.0)
    jok, jm = jquality.quality_check(
        jnp.asarray(scores), jnp.asarray(boxes), jnp.asarray(lm), jcfg,
        aligned_faces=jnp.asarray(faces), valid_mask=jnp.asarray(valid),
    )
    tok, tm = quality.quality_check(
        _t(scores), _t(boxes), _t(lm), cfg, aligned_faces=_t(faces), valid_mask=_t(valid),
    )
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert set(tm) == set(jm)
    for k in tm:
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]), rtol=1e-5, atol=1e-3)
