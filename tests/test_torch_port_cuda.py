"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA card (marker `cuda`) and skips without one:
a CUDA kernel has no interpret mode. The file imports neither JAX nor the
JAX package, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest tests/test_torch_port_cuda.py -m cuda

(`--noconftest` because tests/conftest.py sets up JAX.) Tolerances: K1 and
K2 agree with their plain versions to the bit (every sum has at most two
exact bf16 x bf16 products). The `*_to_the_bit` tests hold them to exactly
that, at the serving step's shapes and at odd ones (K2's take both of its
store paths); the older tests hold 1e-5 on unit-scale
data and 1e-3 on the 0..255 scale.
"""

import contextlib
import json
import math

import numpy as np
import pytest
import torch

from facerecognitionpipeline_tpu_torch.ops import crop_kernel, int8_gemm, nms_kernel, warp_kernel
from facerecognitionpipeline_tpu_torch.ops.crop_kernel import (
    crop_resize_kernel,
    crop_resize_plain,
)
from facerecognitionpipeline_tpu_torch.ops.warp import (
    align_faces_batch,
    reference_template,
    similarity_transform,
    warp_coeffs,
)
from facerecognitionpipeline_tpu_torch.ops.warp_kernel import (
    warp_patches_kernel,
    warp_patches_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no interpret mode)")
    return torch.device("cuda")


@pytest.fixture
def gen():
    return np.random.default_rng(0)


def _boxes(rng, b, n, s, lo):
    x1 = rng.uniform(-5, s - 10, (b, n))
    y1 = rng.uniform(-5, s - 10, (b, n))
    w = rng.uniform(lo, s, (b, n))
    h = rng.uniform(lo, s, (b, n))
    return np.stack([x1, y1, x1 + w, y1 + h], axis=-1).astype(np.float32)


def _landmarks(rng, b, f, s):
    """Plausible 5-point sets: the template scaled, rotated and placed."""
    tpl = reference_template(112) - 56.0
    out = np.zeros((b, f, 5, 2), np.float32)
    for i in range(b):
        for j in range(f):
            sc = rng.uniform(0.4, 1.3)
            th = rng.uniform(-0.3, 0.3)
            rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
            out[i, j] = (tpl @ rot.T) * sc + rng.uniform(40, s - 40, 2)
    return out


@pytest.mark.parametrize("k,n,s", [(24, 64, 320), (48, 32, 640), (128, 4, 640)])
def test_k1_matches_plain(dev, gen, k, n, s):
    img = torch.from_numpy(gen.uniform(-1, 1, (2, s, s, 3)).astype(np.float32)).to(dev)
    boxes = torch.from_numpy(_boxes(gen, 2, n, s, lo=12.0)).to(dev)
    n0 = crop_kernel.LAUNCHES.count
    out = crop_resize_kernel(img, boxes, k)
    ref = crop_resize_plain(img, boxes, k)
    torch.cuda.synchronize()
    assert crop_kernel.LAUNCHES.count == n0 + 1
    assert out.shape == (2, n, k, k, 3)
    assert float((out - ref).abs().max()) <= 1e-5


def test_k1_lossless_integer_window(dev, gen):
    """The alignment stage-A snap: an integer window of exactly k pixels is
    a pixel copy on the card too (no contracted FMA in the coordinates)."""
    img = gen.integers(0, 256, (1, 160, 160, 3)).astype(np.float32)
    boxes = np.array([[[10, 20, 42, 52], [100, 3, 132, 35]]], np.float32)
    out = crop_resize_kernel(
        torch.from_numpy(img).to(dev), torch.from_numpy(boxes).to(dev), 32
    ).cpu().numpy()
    np.testing.assert_array_equal(out[0, 0], img[0, 20:52, 10:42])
    np.testing.assert_array_equal(out[0, 1], img[0, 3:35, 100:132])


def test_k2_in_align_matches_plain(dev, gen):
    frames = torch.from_numpy(
        gen.integers(0, 256, (2, 160, 160, 3)).astype(np.float32)
    ).to(dev)
    lm = torch.from_numpy(_landmarks(gen, 2, 4, 160)).to(dev)
    tpl = torch.from_numpy(reference_template(112)).to(dev)
    n1, n2 = crop_kernel.LAUNCHES.count, warp_kernel.LAUNCHES.count
    out = align_faces_batch(frames, lm, tpl)
    torch.cuda.synchronize()
    assert (crop_kernel.LAUNCHES.count, warp_kernel.LAUNCHES.count) == (n1 + 1, n2 + 1)
    boxes, coeffs = warp_coeffs(similarity_transform(lm.reshape(-1, 5, 2), tpl), 112, 112, 128)
    patches = crop_resize_plain(frames, boxes.reshape(2, 4, 4), 128)
    ref = warp_patches_plain(patches.reshape(-1, 128, 128, 3), coeffs, 112, 112)
    assert float((out - ref.reshape(out.shape)).abs().max()) <= 1e-3


# ------------------------------- K1 / K2: equal to the plain versions, bit for bit


def _assert_bit_equal(out, ref):
    torch.cuda.synchronize()
    assert out.shape == ref.shape and bool(torch.isfinite(out).all())
    assert float((out - ref).abs().max()) == 0.0


@pytest.mark.parametrize("b,n,s,k", [
    (8, 256, 320, 24),  # R-net crops
    (8, 96, 640, 48),  # O-net crops
    (8, 16, 640, 128),  # alignment stage A
])
def test_k1_serving_shapes_to_the_bit(dev, gen, b, n, s, k):
    img = torch.from_numpy(gen.uniform(-1, 1, (b, s, s, 3)).astype(np.float32)).to(dev)
    boxes = torch.from_numpy(_boxes(gen, b, n, s, lo=12.0)).to(dev)
    ref = crop_resize_plain(img, boxes, k)
    n0 = crop_kernel.LAUNCHES.count
    _assert_bit_equal(crop_resize_kernel(img, boxes, k), ref)
    assert crop_kernel.LAUNCHES.count == n0 + 1


@pytest.mark.parametrize("b,n,h,w,c,k", [
    (2, 5, 33, 45, 3, 7),  # k*c not a multiple of 4, a non-square frame
    (2, 5, 40, 56, 1, 12),  # one channel
    (1, 3, 24, 31, 4, 8),  # four channels
    (3, 1, 64, 48, 3, 24),  # one box per frame
    (1, 2, 20, 20, 3, 130),  # upsampling, more bands than one
])
def test_k1_odd_shapes_to_the_bit(dev, gen, b, n, h, w, c, k):
    img = torch.from_numpy(gen.uniform(0, 255, (b, h, w, c)).astype(np.float32)).to(dev)
    x1 = gen.uniform(-6, w - 2, (b, n))
    y1 = gen.uniform(-6, h - 2, (b, n))
    boxes = np.stack(
        [x1, y1, x1 + gen.uniform(3, w, (b, n)), y1 + gen.uniform(3, h, (b, n))], -1
    ).astype(np.float32)
    boxes = torch.from_numpy(boxes).to(dev)
    ref = crop_resize_plain(img, boxes, k)
    _assert_bit_equal(crop_resize_kernel(img, boxes, k), ref)


def test_k1_boxes_outside_degenerate_and_snapped_to_the_bit(dev, gen):
    img = torch.from_numpy(gen.uniform(0, 255, (1, 48, 64, 3)).astype(np.float32)).to(dev)
    boxes = torch.tensor([[
        [-50.0, -50.0, -10.0, -10.0],  # wholly outside, up and left
        [70.0, 10.0, 90.0, 30.0],  # wholly outside, to the right
        [-7.5, -3.25, 20.0, 18.0],  # hangs over two edges
        [40.0, 30.0, 70.5, 55.0],  # hangs over the other two
        [30.0, 20.0, 10.0, 5.0],  # degenerate: x2 < x1 and y2 < y1
        [-1e30, -1e30, 1e30, 1e30],  # far larger than the frame
        [8.0, 4.0, 32.0, 28.0],  # the integer-snapped lossless window
    ]]).to(dev)
    ref = crop_resize_plain(img, boxes, 24)
    out = crop_resize_kernel(img, boxes, 24)
    _assert_bit_equal(out, ref)
    assert float(out[0, :2].abs().max()) == 0.0
    assert torch.equal(out[0, 6], img[0, 4:28, 8:32].to(torch.bfloat16).float())


def _rotations(rng, n, k, out, max_deg, shift=0.0):
    """[n,6] coefficients turning an out x out face about the centre of a
    k x k patch by angles spread over [-max_deg, max_deg]."""
    th = np.linspace(-max_deg, max_deg, n) * (math.pi / 180.0)
    sc = (k / out) * rng.uniform(0.8, 1.0, n)
    a0, a1, b0, b1 = sc * np.cos(th), -sc * np.sin(th), sc * np.sin(th), sc * np.cos(th)
    mid = (out - 1) / 2.0
    a2 = (k - 1) / 2.0 - (a0 + a1) * mid + shift
    b2 = (k - 1) / 2.0 - (b0 + b1) * mid + shift
    return np.stack([a0, a1, a2, b0, b1, b2], axis=1).astype(np.float32)


@pytest.mark.parametrize("f,k,c,out,max_deg,shift", [
    (128, 128, 3, 112, 20.0, 0.0),  # the serving call
    (16, 128, 3, 112, 90.0, 0.0),  # rotations up to 90 degrees
    (8, 128, 3, 112, 30.0, -40.0),  # pixels outside the patch
    (4, 64, 3, 112, 20.0, 0.0),  # K=64
    (1, 128, 3, 112, 10.0, 0.0),  # one face
    (130, 128, 3, 112, 45.0, 0.0),  # more faces than SMs
    (3, 8, 3, 5, 15.0, 0.0),  # 75 floats per face: direct stores, no float4
    (2, 32, 1, 27, 25.0, 0.0),  # one channel, 729 floats per face
    (2, 32, 4, 28, 25.0, 0.0),  # four channels
    (1, 138, 3, 112, 5.0, 0.0),  # the patch fits, its staging does not
])
def test_k2_to_the_bit(dev, gen, f, k, c, out, max_deg, shift):
    patches = torch.from_numpy(gen.uniform(0, 255, (f, k, k, c)).astype(np.float32)).to(dev)
    coeffs = torch.from_numpy(_rotations(gen, f, k, out, max_deg, shift)).to(dev)
    ref = warp_patches_plain(patches, coeffs, out, out)
    n0 = warp_kernel.LAUNCHES.count
    _assert_bit_equal(warp_patches_kernel(patches, coeffs, out, out), ref)
    assert warp_kernel.LAUNCHES.count == n0 + 1


def test_k2_refuses_patches_off_a_16_byte_address(dev, gen):
    """A view that starts 4 bytes into its storage cannot take the bulk copy:
    it is refused with the rule named; a copy of its own is taken."""
    flat = torch.from_numpy(gen.uniform(0, 255, 2 * 16 * 16 * 3 + 1).astype(np.float32)).to(dev)
    patches = flat[1:].view(2, 16, 16, 3)
    assert patches.data_ptr() % 16 == 4
    coeffs = torch.from_numpy(_rotations(gen, 2, 16, 12, 12.0)).to(dev)
    n0 = warp_kernel.LAUNCHES.count
    with pytest.raises(ValueError, match="16-byte address"):
        warp_patches_kernel(patches, coeffs, 12, 12)
    assert warp_kernel.LAUNCHES.count == n0
    ref = warp_patches_plain(patches, coeffs, 12, 12)
    _assert_bit_equal(warp_patches_kernel(patches.clone(), coeffs, 12, 12), ref)


def test_k2_refuses_a_patch_over_shared_memory(dev, gen):
    patches = torch.zeros((1, 160, 160, 3), device=dev)
    coeffs = torch.from_numpy(_rotations(gen, 1, 160, 112, 5.0)).to(dev)
    n0 = warp_kernel.LAUNCHES.count
    with pytest.raises(ValueError, match="shared memory"):
        warp_patches_kernel(patches, coeffs, 112, 112)
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        warp_patches_kernel(patches[:, :7, :7], coeffs, 5, 5)
    assert warp_kernel.LAUNCHES.count == n0


# ------------------------------------------------- K3 / K4: gallery top-k


def _gallery(rng, g, n_invalid, d=512):
    t = rng.normal(size=(g, d)).astype(np.float32)
    t /= np.linalg.norm(t, axis=1, keepdims=True)
    valid = np.ones(g, bool)
    if n_invalid:
        valid[-n_invalid:] = False
        t[-n_invalid:] = 0
    return t, valid


def _assert_topk_agrees(kv, ki, pv, pi, tol):
    """Values within `tol`; indices equal wherever the plain version's
    neighbouring scores are further apart than `tol`. The plain version may
    hold one entry more than the kernel's k, so that the last slot's
    neighbour below is known too."""
    assert ki.dtype == torch.int64 and kv.dtype == torch.float32
    k = kv.shape[1]
    gap = (pv[:, :-1] - pv[:, 1:]).abs() > 2 * tol
    clear = torch.ones_like(pi, dtype=torch.bool)
    clear[:, :-1] &= gap
    clear[:, 1:] &= gap
    pv, pi, clear = pv[:, :k], pi[:, :k], clear[:, :k]
    assert float((kv - pv).abs().max()) <= tol
    assert torch.equal(ki[clear], pi[clear])


def _planted(gen, q, g, d):
    """A gallery with its last rows invalid and one duplicated row (a tie:
    lower index first), and queries of which the first equals that row."""
    n_bad = 100 if g > 1000 else 4
    t, valid = _gallery(gen, g, n_bad, d)
    lo, hi = (100, 700) if g > 1000 else (3, 20)
    t[hi] = t[lo]
    queries = gen.normal(size=(q, d)).astype(np.float32)
    queries[0] = t[lo] * 2.0
    return t, valid, queries, lo, hi, n_bad


# (q, g, k, d): the serving shape cut short, a single query, query counts
# around K3's tile of 64 and K4's of 128, galleries that end inside a 64-row
# tile, depths that end inside a 128-byte K-panel, top_k 1 and 8
_K3_SHAPES = [
    (128, 65536, 3, 512), (1, 8192, 8, 512), (70, 4096 + 32, 5, 512),
    (64, 4096, 3, 512), (65, 4096 + 32, 1, 512), (129, 32, 8, 512),
    (200, 4096 + 32, 3, 96), (128, 8192, 2, 160),
]
_K4_SHAPES = [
    (128, 65536, 3, 512), (1, 8192, 8, 512), (130, 4096 + 32, 5, 512),
    (64, 4096, 3, 512), (65, 4096 + 32, 1, 512), (129, 32, 8, 512),
    (200, 4096 + 32, 3, 160), (128, 8192, 4, 96),
]


@pytest.mark.parametrize("q,g,k,d", _K3_SHAPES)
def test_k3_matches_plain(dev, gen, q, g, k, d):
    from facerecognitionpipeline_tpu_torch.ops import gallery_kernel as gk

    t, valid, queries, lo, hi, n_bad = _planted(gen, q, g, d)
    tt = torch.from_numpy(t).to(dev).to(torch.bfloat16)
    vv = torch.from_numpy(valid).to(dev)
    qq = torch.from_numpy(queries).to(dev)
    n0 = gk.LAUNCHES.count
    kv, ki = gk.streaming_cosine_topk(qq, tt, vv, top_k=k, chunk=32)
    torch.cuda.synchronize()
    assert gk.LAUNCHES.count == n0 + 1
    pv, pi = gk.streaming_cosine_topk_plain(
        qq, tt, vv, top_k=k, chunk=1024 if g % 1024 == 0 else 32
    )
    _assert_topk_agrees(kv, ki, pv, pi, 2e-5)
    assert int(ki[0, 0]) == lo and (k < 2 or int(ki[0, 1]) == hi)
    assert int(ki.max()) < g - n_bad


@pytest.mark.parametrize("q,g,k,d", _K4_SHAPES)
def test_k4_equals_plain_to_the_bit(dev, gen, q, g, k, d):
    from facerecognitionpipeline_tpu_torch.ops import gallery_kernel as gk

    t, valid, queries, lo, hi, n_bad = _planted(gen, q, g, d)
    codes, scales = gk.quantize_templates(torch.from_numpy(t).to(dev))
    vv = torch.from_numpy(valid).to(dev)
    qq = torch.from_numpy(queries).to(dev)
    n0 = gk.LAUNCHES_INT8.count
    kv, ki = gk.streaming_cosine_topk_int8(qq, codes, scales, vv, top_k=k, chunk=32)
    torch.cuda.synchronize()
    assert gk.LAUNCHES_INT8.count == n0 + 1
    pv, pi = gk.streaming_cosine_topk_int8_plain(
        qq, codes, scales, vv, top_k=k, chunk=1024 if g % 1024 == 0 else 32
    )
    assert torch.equal(kv, pv) and torch.equal(ki, pi)
    assert int(ki[0, 0]) == lo and (k < 2 or int(ki[0, 1]) == hi)
    assert int(ki.max()) < g - n_bad


def test_gallery_kernels_all_rows_invalid(dev, gen):
    """No valid row: every slot is the sentinel (-1e9, 0), for every query."""
    from facerecognitionpipeline_tpu_torch.ops import gallery_kernel as gk

    t, _ = _gallery(gen, 4096, 0)
    tt = torch.from_numpy(t).to(dev)
    vv = torch.zeros(4096, dtype=torch.bool, device=dev)
    qq = torch.from_numpy(t[:5]).to(dev)
    codes, scales = gk.quantize_templates(tt)
    for kv, ki in (
        gk.streaming_cosine_topk(qq, tt.to(torch.bfloat16), vv, top_k=3, chunk=64),
        gk.streaming_cosine_topk_int8(qq, codes, scales, vv, top_k=3, chunk=64),
    ):
        assert kv.eq(-1e9).all() and ki.eq(0).all()


def test_gallery_kernels_refuse_a_gallery_off_a_16_byte_address(dev, gen):
    """The TMA copy needs the gallery on a 16-byte address. A view that
    starts elsewhere is refused by ValueError (a copy of a large gallery per
    call is never what a caller wants); the small per-row operands (valid,
    scales) are copied instead, and the result is that of aligned ones."""
    from facerecognitionpipeline_tpu_torch.ops import gallery_kernel as gk

    t, valid = _gallery(gen, 256, 10)
    tt = torch.from_numpy(t).to(dev)
    vv = torch.from_numpy(valid).to(dev)
    qq = tt[:3].clone()
    codes, scales = gk.quantize_templates(tt)
    flat = torch.zeros(256 * 512 + 1, dtype=torch.int8, device=dev)
    flat[1:] = codes.reshape(-1)
    n3, n4 = gk.LAUNCHES.count, gk.LAUNCHES_INT8.count
    with pytest.raises(ValueError, match="16-byte"):
        gk.streaming_cosine_topk_int8(qq, flat[1:].view(256, 512), scales, vv, top_k=2, chunk=64)
    flat16 = torch.zeros(256 * 512 + 1, dtype=torch.bfloat16, device=dev)
    flat16[1:] = tt.to(torch.bfloat16).reshape(-1)
    with pytest.raises(ValueError, match="16-byte"):
        gk.streaming_cosine_topk(qq, flat16[1:].view(256, 512), vv, top_k=2, chunk=64)
    assert (gk.LAUNCHES.count, gk.LAUNCHES_INT8.count) == (n3, n4)
    # valid and scales off 16 bytes are taken (copied by the wrapper)
    v_off = torch.zeros(257, dtype=torch.bool, device=dev)
    v_off[1:] = vv
    s_off = torch.zeros(257, device=dev)
    s_off[1:] = scales
    want = gk.streaming_cosine_topk_int8(qq, codes, scales, vv, top_k=2, chunk=64)
    got = gk.streaming_cosine_topk_int8(qq, codes, s_off[1:], v_off[1:], top_k=2, chunk=64)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_gallery_kernels_on_two_streams(dev, gen):
    """Two calls on two streams at once give what one call gives: the
    kernels keep no state between launches and share no scratch."""
    from facerecognitionpipeline_tpu_torch.ops import gallery_kernel as gk

    t, valid = _gallery(gen, 65536, 100)
    tt = torch.from_numpy(t).to(dev)
    tb = tt.to(torch.bfloat16)
    vv = torch.from_numpy(valid).to(dev)
    qq = torch.from_numpy(gen.normal(size=(128, 512)).astype(np.float32)).to(dev)
    codes, scales = gk.quantize_templates(tt)
    want3 = gk.streaming_cosine_topk(qq, tb, vv, top_k=3, chunk=64)
    want4 = gk.streaming_cosine_topk_int8(qq, codes, scales, vv, top_k=3, chunk=64)
    torch.cuda.synchronize()
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    got = []
    for _ in range(4):
        with torch.cuda.stream(s1):
            a3 = gk.streaming_cosine_topk(qq, tb, vv, top_k=3, chunk=64)
            a4 = gk.streaming_cosine_topk_int8(qq, codes, scales, vv, top_k=3, chunk=64)
        with torch.cuda.stream(s2):
            b4 = gk.streaming_cosine_topk_int8(qq, codes, scales, vv, top_k=3, chunk=64)
            b3 = gk.streaming_cosine_topk(qq, tb, vv, top_k=3, chunk=64)
        got.append((a3, a4, b3, b4))
    torch.cuda.synchronize()
    for a3, a4, b3, b4 in got:
        for r in (a3, b3):
            assert torch.equal(r[0], want3[0]) and torch.equal(r[1], want3[1])
        for r in (a4, b4):
            assert torch.equal(r[0], want4[0]) and torch.equal(r[1], want4[1])


def test_gallery_kernels_fewer_valid_rows_than_k(dev, gen):
    """Surplus slots hold the sentinel (-1e9, index 0), as the plain
    versions and the JAX functions return them."""
    from facerecognitionpipeline_tpu_torch.ops import gallery_kernel as gk

    t, _ = _gallery(gen, 256, 0)
    valid = np.zeros(256, bool)
    valid[[7, 200]] = True
    tt = torch.from_numpy(t).to(dev)
    vv = torch.from_numpy(valid).to(dev)
    qq = torch.from_numpy(t[[200, 3]]).to(dev)
    kv, ki = gk.streaming_cosine_topk(qq, tt.to(torch.bfloat16), vv, top_k=4, chunk=64)
    assert ki[0].tolist()[:1] == [200] and sorted(ki[0].tolist()[:2]) == [7, 200]
    assert ki[:, 2:].eq(0).all() and kv[:, 2:].eq(-1e9).all()
    codes, scales = gk.quantize_templates(tt)
    kv8, ki8 = gk.streaming_cosine_topk_int8(qq, codes, scales, vv, top_k=4, chunk=64)
    pv8, pi8 = gk.streaming_cosine_topk_int8_plain(qq, codes, scales, vv, top_k=4, chunk=64)
    assert torch.equal(kv8, pv8) and torch.equal(ki8, pi8)
    assert ki8[:, 2:].eq(0).all() and kv8[:, 2:].eq(-1e9).all()


def test_gallery_kernels_refuse_what_they_do_not_take(dev, gen):
    from facerecognitionpipeline_tpu_torch.ops import gallery_kernel as gk

    t, valid = _gallery(gen, 256, 0)
    tt = torch.from_numpy(t).to(dev)
    vv = torch.from_numpy(valid).to(dev)
    qq = tt[:2].clone()
    codes, scales = gk.quantize_templates(tt)
    n3, n4 = gk.LAUNCHES.count, gk.LAUNCHES_INT8.count
    with pytest.raises(TypeError, match="bf16 or float32"):
        gk.streaming_cosine_topk(qq, tt.half(), vv, top_k=2, chunk=64)  # float16 rows
    with pytest.raises(ValueError, match="shared memory"):
        gk.streaming_cosine_topk(qq, tt.to(torch.bfloat16), vv, top_k=gk.MAX_TOP_K + 1,
                                 chunk=64)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        gk.streaming_cosine_topk(qq, tt.to(torch.bfloat16), vv, top_k=2, chunk=100)
    with pytest.raises(ValueError, match="one device"):
        gk.streaming_cosine_topk(qq, tt.to(torch.bfloat16), vv.cpu(), top_k=2, chunk=64)
    with pytest.raises(TypeError, match="int8"):
        gk.streaming_cosine_topk_int8(qq, tt, scales, vv, top_k=2, chunk=64)
    with pytest.raises(TypeError, match="float32"):
        gk.streaming_cosine_topk_int8(qq, codes, scales.double(), vv, top_k=2, chunk=64)
    assert (gk.LAUNCHES.count, gk.LAUNCHES_INT8.count) == (n3, n4)
    s, i = gk.streaming_cosine_topk(qq[:0], tt.to(torch.bfloat16), vv, top_k=2, chunk=64)
    assert s.shape == i.shape == (0, 2)


# ------------------------------------------------ the HTTP server on the card


@pytest.fixture
def card_server(dev, tmp_path, request):
    """The port's server built by its constructor on the card (ir_micro,
    seeded random weights, det 160x160, 4 face slots), served on a thread.
    The parameter is the transport, with '-int8' for quantize='int8'."""
    import os
    import threading

    from facerecognitionpipeline_tpu_torch.serve.server import FaceRecognitionServer, serve

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    transport, _, quantize = request.param.partition("-")
    srv = FaceRecognitionServer(
        gallery_path=str(tmp_path / "gallery" / "students.pkl"),
        similarity_threshold=0.9, output_dir=str(tmp_path / "sessions"),
        architecture="ir_micro",
        detector_weights=os.path.join(repo, "pretrained", "mtcnn_dr.npz"),
        det_size=(160, 160), max_faces=4, batch_max=2, batch_wait_ms=1.0,
        transport=transport, quantize=quantize or None, device="cuda",
    )
    httpd = serve(srv, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield srv, f"http://127.0.0.1:{httpd.server_address[1]}", tmp_path
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.shutdown()
        thread.join(timeout=30)


@pytest.mark.parametrize(
    "card_server,image_format",
    [("rgb", "png"), ("rgb", "raw"), ("rgb", "raw-i420"), ("i420", "raw-i420"), ("i420", "png"),
     ("rgb-int8", "raw")],
    indirect=["card_server"],
)
def test_server_on_the_card_recognizes_over_every_transport(card_server, image_format, request):
    """One client, three frames: the face count equals a direct step's, the
    enrolled faces are recognized, every step launched K1 three times, K2
    once and K5 three times, and the monitor reads device memory from
    torch.cuda. The step replays a CUDA graph per bucket and gallery: the
    reloaded gallery's graphs are captured (by the batcher's warm-up) before
    the counts start, so that they count the three steps' kernels alone."""
    import json
    import os

    from facerecognitionpipeline_tpu_torch.gallery.manager import GalleryManager
    from facerecognitionpipeline_tpu_torch.serve import rawproto
    from facerecognitionpipeline_tpu_torch.serve.client import FaceRecognitionClient

    srv, url, tmp_path = card_server
    assert srv.device.type == "cuda" and srv.engine.detector.crop_impl == "kernel"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with np.load(os.path.join(
        repo, "facerecognitionpipeline_tpu_torch", "testdata", "smoke_scenes.npz"
    )) as z:
        frame = np.ascontiguousarray(z["tiles"][0])
    assert frame.shape == (160, 160, 3)
    # what reaches the engine for this transport
    canvas = frame
    if image_format == "raw-i420":
        canvas = rawproto.i420_to_rgb(rawproto.rgb_to_i420(frame)) \
            if srv.transport == "rgb" else rawproto.rgb_to_i420(frame)
    elif srv.transport == "i420":
        canvas = rawproto.rgb_to_i420(frame)
    t, v, _ = srv.gallery.device_snapshot()
    out = srv.engine.process_frames(canvas[None], t, v, gallery_k=3)
    ok = (out["face_valid"][0] & out["quality_ok"][0]).cpu().numpy()
    det = out["det_scores"][0].cpu().numpy()
    emb = out["embeddings"][0].float().cpu().numpy()
    assert ok.any()
    writer = GalleryManager(srv.gallery.gallery_path, verbose=False, device="cuda")
    enrolled = set()
    for s in np.flatnonzero(ok & (det > 0.7)):
        writer.add_student(f"face{s}", f"Face {s}", emb[s][None])
        enrolled.add(f"face{s}")
    for i in range(20):
        writer.add_student(f"other{i}", f"Other {i}",
                           np.random.default_rng(i).normal(size=(1, 512)).astype(np.float32))
    writer.save()
    assert enrolled

    client = FaceRecognitionClient(
        server_url=url, session_name="card", synthetic=True, frame_skip=1, display=False,
        output_dir=str(tmp_path / "client"), image_format=image_format, det_size=(160, 160),
    )
    assert client.check_server() and client.init_session()
    assert client._session.post(f"{url}/reload_gallery", json={}, timeout=60).json()[
        "status"] == "reloaded"
    srv.batcher.warmup((160, 160))
    crop_kernel.LAUNCHES.reset()
    warp_kernel.LAUNCHES.reset()
    nms_kernel.LAUNCHES.reset()
    int8_gemm.PRODUCTS.reset()
    steps0 = srv.batcher._dispatch_count
    body = None
    for _ in range(3):
        body = client.process_frame(frame)
        assert body is not None
        assert body["faces_detected"] == int(ok.sum())
    steps = srv.batcher._dispatch_count - steps0
    assert steps == 3
    assert crop_kernel.LAUNCHES.count == 3 * steps and warp_kernel.LAUNCHES.count == steps
    assert nms_kernel.LAUNCHES.count == 3 * steps
    quantized = srv.engine.embedder.quantized
    assert quantized == srv.engine.detector.quantized == (
        "int8" in request.node.callspec.params["card_server"])
    # per int8 step: R-net 4 and O-net 5 int8 layers, two per backbone unit
    assert int8_gemm.PRODUCTS.count == (steps * (9 + 2 * 4) if quantized else 0)
    recognized = {r["student_id"] for r in body["recognized_tracks"].values()}
    assert enrolled <= recognized and not any(r.startswith("other") for r in recognized)
    stats = client._session.get(f"{url}/stats", timeout=10).json()
    assert stats["current_gpu_vram_mb"] > 0 and stats["total_requests"] == 3
    client.finalize_session()
    with open(tmp_path / "sessions" / "card" / "attendance.json") as f:
        listed = {r["student_id"] for r in json.load(f)["recognized"]}
    assert enrolled <= listed
    with open(tmp_path / "sessions" / "card" / "performance_report_server.json") as f:
        report = json.load(f)
    assert report["memory_usage"]["gpu_vram"]["available"] is True
    assert report["session_info"]["model_identifier"] == "ADAFACE_IR_MICRO_CUDA"
    assert os.listdir(tmp_path / "sessions" / "card" / "recognized_faces")


# ------------------------------------------------ the int8 tier's product

# (faces or crops, input side, in channels, out channels, kernel, stride,
# padding) of every distinct int8 conv of the serving step: ir_101's res
# convs at 128 faces (8 frames x 16 slots), R-net's at 2048 candidate crops
# (8 x 256) and O-net's at 768 (8 x 96); then odd shapes: fewer than 17
# rows, K = 27 and N = 28, a window that ends inside the image.
INT8_CONVS = [
    (128, 112, 64, 64, 3, 1, 1), (128, 112, 64, 64, 3, 2, 1),
    (128, 56, 64, 64, 3, 1, 1), (128, 56, 64, 128, 3, 1, 1),
    (128, 56, 128, 128, 3, 2, 1), (128, 28, 128, 128, 3, 1, 1),
    (128, 28, 128, 256, 3, 1, 1), (128, 28, 256, 256, 3, 2, 1),
    (128, 14, 256, 256, 3, 1, 1), (128, 14, 256, 512, 3, 1, 1),
    (128, 14, 512, 512, 3, 2, 1), (128, 7, 512, 512, 3, 1, 1),
    (2048, 24, 3, 28, 3, 1, 0), (2048, 11, 28, 48, 3, 1, 0), (2048, 4, 48, 64, 2, 1, 0),
    (768, 48, 3, 32, 3, 1, 0), (768, 23, 32, 64, 3, 1, 0), (768, 10, 64, 64, 3, 1, 0),
    (768, 4, 64, 128, 2, 1, 0),
    (1, 3, 5, 28, 3, 1, 0), (3, 5, 3, 28, 3, 1, 0), (2, 9, 7, 12, 3, 2, 1),
]
INT8_DENSE = [(2048, 576, 128), (768, 1152, 256), (5, 27, 28), (16, 40, 13)]


@pytest.mark.parametrize("b,h,cin,cout,k,stride,pad", INT8_CONVS)
def test_int8_conv_equals_its_plain_version(dev, b, h, cin, cout, k, stride, pad):
    g = torch.Generator(device=dev).manual_seed(b * 7 + h + cin + cout)
    x = torch.randint(-127, 128, (b, h, h, cin), generator=g, device=dev, dtype=torch.int8)
    w = torch.randint(-127, 128, (k * k * cin, cout), generator=g, device=dev,
                      dtype=torch.int8)
    packed = int8_gemm.pack_weight(w)
    int8_gemm.PRODUCTS.reset()
    got = int8_gemm.int8_conv2d(x, packed, (k, k), stride, pad, cout)
    assert int8_gemm.PRODUCTS.count == 1 and got.dtype == torch.int32
    want = int8_gemm.int8_conv2d(x, packed, (k, k), stride, pad, cout, plain=True)
    assert int8_gemm.PRODUCTS.count == 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("m,k,n", INT8_DENSE)
def test_int8_linear_equals_its_plain_version(dev, m, k, n):
    g = torch.Generator(device=dev).manual_seed(m + k + n)
    x = torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
    w = torch.randint(-127, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
    packed = int8_gemm.pack_weight(w)
    got = int8_gemm.int8_linear(x, packed, n)
    ref = x.cpu().long() @ w.cpu().long()
    assert torch.equal(got.cpu().long(), ref)
    assert torch.equal(got, int8_gemm.int8_linear(x, packed, n, plain=True))


def test_int8_product_raises_on_the_card_rather_than_fall_back(dev):
    a = torch.ones((32, 27), dtype=torch.int8, device=dev)
    w = torch.ones((28, 27), dtype=torch.int8, device=dev)  # not padded
    int8_gemm.PRODUCTS.reset()
    with pytest.raises(ValueError, match="not padded"):
        int8_gemm.int8_product(a, w, 28)
    assert int8_gemm.PRODUCTS.count == 0


# ------------------------------------- K3 on float32 rows, lists up to 64


@pytest.mark.parametrize("top_k", [1, 3, 16, 33, 64])
@pytest.mark.parametrize("shape", [(128, 65536 + 32, 512), (65, 4096, 96), (7, 256, 32)])
def test_gallery_kernels_long_lists_and_float32_rows(dev, gen, shape, top_k):
    """K3 on bf16 and on float32 rows within K3_TOL / 1e-5 of their plain
    versions with equal indices where the scores stand apart; K4 bit-equal."""
    from facerecognitionpipeline_tpu_torch.ops import gallery_kernel as gk

    nq, rows, d = shape
    t = gen.normal(size=(rows, d)).astype(np.float32)
    t /= np.linalg.norm(t, axis=1, keepdims=True)
    t[rows - 20] = t[3]
    valid = np.ones(rows, bool)
    valid[-10:] = False
    q = gen.normal(size=(nq, d)).astype(np.float32)
    q[0] = 2 * t[3]
    tt, vv, qq = (torch.from_numpy(a).to(dev) for a in (t, valid, q))
    n3, n4, nf = gk.LAUNCHES.count, gk.LAUNCHES_INT8.count, gk.LAUNCHES_F32.count
    for rows_t, tol in ((tt.to(torch.bfloat16), 2e-5), (tt, 1e-5)):
        kv, ki = gk.streaming_cosine_topk(qq, rows_t, vv, top_k=top_k, chunk=32)
        pv, pi = gk.streaming_cosine_topk_plain(qq, rows_t, vv, top_k=top_k, chunk=32)
        torch.cuda.synchronize()
        assert float((kv - pv).abs().max()) <= tol
        gap = (pv[:, :-1] - pv[:, 1:]).abs() > tol
        clear = torch.ones_like(pi, dtype=torch.bool)
        clear[:, :-1] &= gap
        clear[:, 1:] &= gap
        assert torch.equal(ki[clear], pi[clear])
        assert ki[0, 0] == 3 and (top_k == 1 or ki[0, 1] == rows - 20)
    codes, scales = gk.quantize_templates(tt)
    kv, ki = gk.streaming_cosine_topk_int8(qq, codes, scales, vv, top_k=top_k, chunk=32)
    pv, pi = gk.streaming_cosine_topk_int8_plain(qq, codes, scales, vv, top_k=top_k, chunk=32)
    torch.cuda.synchronize()
    assert torch.equal(kv, pv) and torch.equal(ki, pi)
    assert (gk.LAUNCHES.count - n3, gk.LAUNCHES_INT8.count - n4,
            gk.LAUNCHES_F32.count - nf) == (1, 1, 1)


def test_float32_rows_fewer_valid_than_k(dev, gen):
    from facerecognitionpipeline_tpu_torch.ops import gallery_kernel as gk

    t, _ = _gallery(gen, 256, 0)
    valid = np.zeros(256, bool)
    valid[[7, 200]] = True
    tt, vv = torch.from_numpy(t).to(dev), torch.from_numpy(valid).to(dev)
    qq = torch.from_numpy(t[[200, 3]]).to(dev)
    for k in (4, 40):
        kv, ki = gk.streaming_cosine_topk(qq, tt, vv, top_k=k, chunk=64)
        pv, pi = gk.streaming_cosine_topk_plain(qq, tt, vv, top_k=k, chunk=64)
        assert torch.equal(ki, pi) and float((kv - pv).abs().max()) <= 1e-5
        assert ki[:, 2:].eq(0).all() and kv[:, 2:].eq(-1e9).all()


# ------------------------------------- lists in device memory, top_k 65-1024


def _long_list_case(gen, nq, rows, d, n_valid=None):
    """Unit rows with a ragged last tile, a duplicated row (lower index
    first), the last 10 rows invalid (or only `n_valid` valid rows), and
    query 0 equal to row 3."""
    t = gen.normal(size=(rows, d)).astype(np.float32)
    t /= np.linalg.norm(t, axis=1, keepdims=True)
    t[rows - 20] = t[3]
    valid = np.ones(rows, bool)
    valid[-10:] = False
    if n_valid is not None:
        valid[:] = False
        valid[gen.choice(rows - 20, n_valid, replace=False)] = True
        valid[[3, rows - 20]] = True
    q = gen.normal(size=(nq, d)).astype(np.float32)
    q[0] = 2 * t[3]
    return t, valid, q


def _held_to_plain(gk, kind, qq, tt, vv, top_k, chunk):
    """One kernel call and its plain version: values within the kind's
    tolerance (int8: equal), indices equal where the scores stand apart."""
    counter = {"bf16": gk.LAUNCHES, "f32": gk.LAUNCHES_F32, "int8": gk.LAUNCHES_INT8}[kind]
    n0 = counter.count
    if kind == "int8":
        codes, scales = gk.quantize_templates(tt)
        kv, ki = gk.streaming_cosine_topk_int8(qq, codes, scales, vv, top_k=top_k, chunk=chunk)
        pv, pi = gk.streaming_cosine_topk_int8_plain(qq, codes, scales, vv, top_k=top_k,
                                                     chunk=chunk)
        torch.cuda.synchronize()
        assert torch.equal(kv, pv) and torch.equal(ki, pi)
    else:
        rows = tt.to(torch.bfloat16) if kind == "bf16" else tt
        kv, ki = gk.streaming_cosine_topk(qq, rows, vv, top_k=top_k, chunk=chunk)
        pv, pi = gk.streaming_cosine_topk_plain(qq, rows, vv, top_k=top_k + 1, chunk=chunk)
        torch.cuda.synchronize()
        _assert_topk_agrees(kv, ki, pv, pi, 2e-5 if kind == "bf16" else 1e-5)
    assert counter.count == n0 + 1
    return kv, ki


@pytest.mark.parametrize("kind", ["bf16", "f32", "int8"])
@pytest.mark.parametrize("top_k", [65, 100, 256, 1024])
@pytest.mark.parametrize("shape", [(1, 20480 + 32, 512), (65, 8192 + 32, 96),
                                   (129, 12288 + 32, 512)])
def test_gallery_kernels_lists_in_device_memory(dev, gen, kind, top_k, shape):
    """top_k 65 to 1024 (lists in device memory): one launch, the plain
    version's answer, the duplicate row behind the lower index."""
    from facerecognitionpipeline_tpu_torch.ops import gallery_kernel as gk

    nq, rows, d = shape
    t, valid, q = _long_list_case(gen, nq, rows, d)
    tt, vv, qq = (torch.from_numpy(a).to(dev) for a in (t, valid, q))
    kv, ki = _held_to_plain(gk, kind, qq, tt, vv, top_k, 32)
    assert ki[0, :2].tolist() == [3, rows - 20]


@pytest.mark.parametrize("kind", ["bf16", "f32", "int8"])
@pytest.mark.parametrize("top_k", [100, 1024])
def test_gallery_kernels_device_lists_fewer_valid_rows_than_k(dev, gen, kind, top_k):
    """Fewer valid rows than top_k: the surplus slots hold (-1e9, 0)."""
    from facerecognitionpipeline_tpu_torch.ops import gallery_kernel as gk

    t, valid, q = _long_list_case(gen, 70, 8192, 512, n_valid=60)
    tt, vv, qq = (torch.from_numpy(a).to(dev) for a in (t, valid, q))
    kv, ki = _held_to_plain(gk, kind, qq, tt, vv, top_k, 64)
    n = int(valid.sum())
    assert kv[:, n:].eq(-1e9).all() and ki[:, n:].eq(0).all()
    assert bool(vv[ki[:, :n]].all())


def test_bf16_face_processor_launches_k1(dev):
    """A bf16 cascade takes the kernel crop ('auto'): K1 twice per detect."""
    import os

    import cv2

    from facerecognitionpipeline_tpu_torch.models.detector import MTCNNDetector
    from facerecognitionpipeline_tpu_torch.pipeline.processor import FaceProcessor
    from facerecognitionpipeline_tpu_torch.train.detector_train import (
        make_identity,
        render_identity_scene,
    )

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    det = MTCNNDetector(det_size=(320, 320), dtype=torch.bfloat16, device=dev,
                        weights_path=os.path.join(repo, "pretrained", "mtcnn_synthetic.npz"))
    assert det.crop_impl == "kernel"
    proc = FaceProcessor(output_size=112, detector=det, device=dev, quality_filter_config={
        "min_det_score": 0.5, "min_face_size": 40, "check_blur": False})
    img, *_ = render_identity_scene([make_identity(1), make_identity(2)],
                                    np.random.default_rng(3), size=240)
    img = cv2.resize(img, (480, 480))
    n = crop_kernel.LAUNCHES.count
    faces = proc.process_numpy(img, return_all=True)
    assert crop_kernel.LAUNCHES.count - n == 2
    assert len(faces) == 2 and all(f["aligned_face"].shape == (112, 112, 3) for f in faces)


def test_face_matcher_at_streaming_scale_launches_k3_once_per_search(dev, gen, tmp_path):
    """40 000 identities: GalleryManager keeps a bf16 compact copy and every
    search (match_faces_batch, match_single_face) is one K3 launch."""
    from facerecognitionpipeline_tpu_torch.gallery.manager import GalleryManager
    from facerecognitionpipeline_tpu_torch.ops import gallery_kernel as gk
    from facerecognitionpipeline_tpu_torch.pipeline.embedder import FaceEmbedder
    from facerecognitionpipeline_tpu_torch.pipeline.matcher import FaceMatcher

    emb = FaceEmbedder("ir_micro", device=dev, random_ok=True)
    crops = gen.integers(0, 256, (3, 112, 112, 3), dtype=np.uint8)
    planted = emb.extract_embeddings_batch(crops)
    t = gen.normal(size=(40000, 512)).astype(np.float32)
    t /= np.linalg.norm(t, axis=1, keepdims=True)
    t[[11, 20000, 39999]] = planted
    gm = GalleryManager(gallery_path=str(tmp_path / "g.pkl"), verbose=False, device=dev)
    for i in range(40000):
        gm.add_student(f"ID{i:05d}", f"n{i}", t[i:i + 1])
    m = FaceMatcher(embedder=emb, gallery=gm, device=dev)
    n = gk.LAUNCHES.count
    res = m.match_faces_batch(list(crops), top_k=16)
    assert gk.LAUNCHES.count - n == 1
    assert [r[0][0] for r in res] == ["ID00011", "ID20000", "ID39999"]
    assert all(r[0][2] > 0.99 and len(r) == 16 for r in res)
    assert m.match_single_face(crops[1], top_k=64)[0][0] == "ID20000"
    assert gk.LAUNCHES.count - n == 2


@pytest.mark.parametrize("aggregation", ["max", "mean", "topk"])
def test_identity_scores_batch_at_a_large_shape(dev, aggregation):
    """The evaluation's device scorer at 2048 probes x 6000 identities x 5
    x 512: within 1e-5 of the same function in float64 and of the CPU."""
    from facerecognitionpipeline_tpu_torch.evalharness.metrics import identity_scores_batch

    g = torch.Generator(device=dev).manual_seed(4)
    probes = torch.randn((2048, 512), generator=g, device=dev)
    gallery = torch.randn((6000, 5, 512), generator=g, device=dev)
    gallery /= torch.linalg.vector_norm(gallery, dim=2, keepdim=True)
    mask = torch.arange(5, device=dev)[None, :] <= (torch.arange(6000, device=dev) % 5)[:, None]
    gallery *= mask[..., None]
    out = identity_scores_batch(probes, gallery, mask, aggregation, 3)
    ref = identity_scores_batch(probes.double(), gallery.double(), mask, aggregation, 3,
                                dtype=torch.float64)
    assert out.dtype == torch.float32 and out.shape == (2048, 6000)
    assert float((out.double() - ref).abs().max()) <= 1e-5
    cpu = identity_scores_batch(probes[:256].cpu(), gallery.cpu(), mask.cpu(), aggregation, 3)
    assert float((out[:256].cpu() - cpu).abs().max()) <= 1e-5


def _streaming_labeler(dev, gen, tmp_path, n_ids=40000):
    """A ProbeLabeler over 40 000 identities (a bf16 compact copy: K3) with
    three probe crops planted as rows 11, 20000 and 39999."""
    import cv2

    from facerecognitionpipeline_tpu_torch.gallery.manager import GalleryManager
    from facerecognitionpipeline_tpu_torch.pipeline.embedder import FaceEmbedder
    from facerecognitionpipeline_tpu_torch.pipeline.labeling import ProbeLabeler

    emb = FaceEmbedder("ir_micro", device=dev, random_ok=True)
    crops = gen.integers(0, 256, (3, 112, 112, 3), dtype=np.uint8)
    probe_dir = tmp_path / "probes"
    probe_dir.mkdir()
    for i, c in enumerate(crops):
        cv2.imwrite(str(probe_dir / f"p{i}.png"), cv2.cvtColor(c, cv2.COLOR_RGB2BGR))
    t = gen.normal(size=(n_ids, 512)).astype(np.float32)
    t /= np.linalg.norm(t, axis=1, keepdims=True)
    t[[11, 20000, 39999]] = emb.extract_embeddings_batch(crops)
    gm = GalleryManager(gallery_path=str(tmp_path / "g.pkl"), verbose=False, device=dev)
    for i in range(n_ids):
        gm.add_student(f"ID{i:05d}", f"n{i}", t[i:i + 1])
    return ProbeLabeler(embedder=emb, gallery=gm, device=dev), str(probe_dir), gm


def test_probe_labeler_at_streaming_scale_launches_k3_once(dev, gen, tmp_path):
    from facerecognitionpipeline_tpu_torch.ops import gallery_kernel as gk

    labeler, probe_dir, _ = _streaming_labeler(dev, gen, tmp_path)
    n = gk.LAUNCHES.count
    summary = labeler.process_probe_directory(probe_dir, str(tmp_path / "out"), top_k=16)
    assert gk.LAUNCHES.count - n == 1 and summary["processed"] == 3
    with open(tmp_path / "out" / "labeling_results.json") as f:
        results = json.load(f)["results"]
    assert [r["matched_student_id"] for r in results] == ["ID00011", "ID20000", "ID39999"]
    assert all(r["label"] == "SURE" and len(r["top_matches"]) == 16 for r in results)


def test_probe_labeler_cli_answers_top_k_65_on_the_card(dev, gen, tmp_path):
    """F2, repaired: `probe_labeler --top_k 65` against a card-sized gallery
    answers (lists in device memory), with the plain version's top matches
    on the same compact rows, one K3 launch per search."""
    from facerecognitionpipeline_tpu_torch.cli import probe_labeler
    from facerecognitionpipeline_tpu_torch.ops import gallery_kernel as gk

    _, probe_dir, gm = _streaming_labeler(dev, gen, tmp_path)
    gm.save()
    argv = ["--probe_dir", probe_dir, "--gallery_path", gm.gallery_path, "--architecture",
            "ir_micro", "--no_copy", "--device", "cuda"]
    assert probe_labeler.main(argv + ["--top_k", "64"]) == 0
    n = gk.LAUNCHES.count
    out = tmp_path / "out65"
    assert probe_labeler.main(argv + ["--top_k", "65", "--output_dir", str(out)]) == 0
    assert gk.LAUNCHES.count - n == 1
    with open(out / "labeling_results.json") as f:
        results = json.load(f)["results"]
    assert [r["matched_student_id"] for r in results] == ["ID00011", "ID20000", "ID39999"]
    assert all(len(r["top_matches"]) == 65 for r in results)
    _, valid, ids = gm.device_snapshot()
    compact = gm._device.snapshot()[3]
    from facerecognitionpipeline_tpu_torch.pipeline.embedder import FaceEmbedder

    emb = FaceEmbedder("ir_micro", device=dev, random_ok=True)
    import cv2

    crops = [cv2.cvtColor(cv2.imread(str(p)), cv2.COLOR_BGR2RGB)
             for p in sorted((tmp_path / "probes").iterdir())]
    q = torch.from_numpy(emb.extract_embeddings_batch(crops)).to(dev)
    pv, pi = gk.streaming_cosine_topk_plain(q, compact, valid, top_k=65, chunk=64)
    by_name = {r["filename"]: r for r in results}
    for j, p in enumerate(sorted((tmp_path / "probes").iterdir())):
        got = [m["student_id"] for m in by_name[p.name]["top_matches"]]
        want = [ids[i] for i in pi[j].tolist()]
        gap = (pv[j, :-1] - pv[j, 1:]).abs() > 4e-5
        clear = [k for k in range(65) if (k == 0 or gap[k - 1]) and (k == 64 or gap[k])]
        assert [got[k] for k in clear] == [want[k] for k in clear]


# ------------------------------------------------------------- training


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to(v, dev) for v in tree)
    return tree.detach().clone().to(dev).requires_grad_(tree.requires_grad)


def test_train_step_on_the_card_matches_the_cpu(dev):
    """One float32 step at ir_micro from the same state, batch and mask on
    the card (TF32 off) and on the CPU, within the CPU parity tests'
    tolerances: loss 1e-5 relative, parameters 1e-3 absolute, batch_stats
    1e-3 relative."""
    from facerecognitionpipeline_tpu_torch.train.trainer import TrainConfig, Trainer

    cfg = TrainConfig(architecture="ir_micro", num_classes=32, learning_rate=0.05)
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (8, 112, 112, 3)).astype(np.float32)
    y = rng.integers(0, 32, 8).astype(np.int32)
    mask = torch.rand((8, 512, 7, 7), generator=torch.Generator().manual_seed(1)) < 0.6
    init = Trainer(cfg, device="cpu").init_state(0)
    out = {}
    for d in ("cpu", dev):
        s, m = Trainer(cfg, device=d).train_step(_to(init, d), x, y, dropout_mask=mask.to(d))
        out[str(d)] = (float(m["loss"]), _to(s, "cpu"))
    (lc, sc), (lg, sg) = out["cpu"], out[str(dev)]
    assert lg == pytest.approx(lc, rel=1e-5)
    for k, v in sc["params"]["backbone"].items():
        assert (sg["params"]["backbone"][k] - v).abs().max().item() <= 1e-3, k
    for k, v in sc["batch_stats"].items():
        d = (sg["batch_stats"][k] - v).norm().item()
        assert d <= 1e-3 * v.norm().item() + 1e-5 * v.numel() ** 0.5, k
    assert int(sg["step"]) == 1


def test_bf16_train_steps_on_the_card_learn(dev):
    """bf16 compute, float32 parameters, prefetched batches, a learning rate
    from the schedule as a tensor on the card: the loss falls on a repeated
    batch and every parameter stays float32 on the card."""
    from facerecognitionpipeline_tpu_torch.train.data import prefetch_to_device, synthetic_batches
    from facerecognitionpipeline_tpu_torch.train.trainer import (
        TrainConfig,
        Trainer,
        dropout_generator,
    )

    t = Trainer(TrainConfig(architecture="ir_micro", num_classes=16, learning_rate=0.01,
                            lr_schedule="cosine", total_steps=12, warmup_steps=2,
                            dtype=torch.bfloat16), device=dev)
    s = t.init_state(0)
    x, y = next(prefetch_to_device(synthetic_batches(16, 32, seed=0), depth=2, device=dev))
    assert x.device.type == "cuda"
    losses = []
    for i in range(6):
        s, m = t.train_step(s, x, y, dropout_generator(0, i, dev))
        losses.append(m["loss"])
    losses = torch.stack(losses).cpu()
    assert torch.isfinite(losses).all() and losses[-1] < losses[0]
    assert all(p.dtype == torch.float32 and p.device.type == "cuda"
               for p in s["params"]["backbone"].values())


@pytest.mark.parametrize("b,h,cin,cout,stride", [
    (32, 56, 64, 64, 1), (32, 56, 64, 128, 2), (16, 14, 256, 256, 1), (9, 15, 8, 16, 2),
])
def test_int8_forward_sums_on_the_card_equal_the_plain_version(dev, b, h, cin, cout, stride):
    """The int8-forward conv's s32 sums through torch._int_mm equal the
    float64 plain version's, its codes equal the CPU's but for counted
    off-by-one flips, and its backward is the float conv's VJP."""
    from facerecognitionpipeline_tpu_torch.models import irse

    g = torch.Generator(device=dev).manual_seed(b + h)
    x = torch.randn((b, cin, h, h), generator=g, device=dev, dtype=torch.bfloat16)
    w = torch.randn((cout, cin, 3, 3), generator=g, device=dev) / (9 * cin) ** 0.5
    xq, wq, ax, aw = irse.int8_forward_codes(x, w)
    cq = irse.int8_forward_codes(x.cpu(), w.cpu())
    assert (xq.cpu().int() - cq[0].int()).abs().max() <= 1
    assert int((xq.cpu() != cq[0]).sum()) <= max(2, xq.numel() // 10_000)
    assert torch.equal(irse.int8_forward_sums(xq, wq, stride, 1),
                       irse.int8_forward_sums(xq, wq, stride, 1, plain=True))
    xr = x.detach().requires_grad_()
    wr = w.to(torch.bfloat16).detach().requires_grad_()
    y = irse._Int8FwdConvFn.apply(xr, wr, stride, 1)
    gy = torch.randn(y.shape, generator=g, device=dev, dtype=y.dtype)
    y.backward(gy)
    xf, wf = x.detach().requires_grad_(), wr.detach().clone().requires_grad_()
    torch.nn.functional.conv2d(xf, wf, None, stride, 1).backward(gy)
    torch.testing.assert_close(xr.grad, xf.grad)
    torch.testing.assert_close(wr.grad, wf.grad)


def test_fused_int8_embedder_on_the_card_matches_the_unfused_one(dev):
    """FaceEmbedder(quantize='int8', int8_fused=True) on the card: the fused
    body's products through torch._int_mm, embeddings within cosine 0.9999
    of the unfused int8 embedder's (float32) and of its own plain product."""
    from facerecognitionpipeline_tpu_torch.models.irse import FusedQuantBody
    from facerecognitionpipeline_tpu_torch.models.quantize import default_calibration_faces
    from facerecognitionpipeline_tpu_torch.pipeline.embedder import FaceEmbedder

    calib = default_calibration_faces(16, seed=2)
    fused = FaceEmbedder("ir_micro", random_ok=True, quantize="int8", int8_fused=True,
                         calib_faces=calib, device=dev)
    unfused = FaceEmbedder("ir_micro", random_ok=True, quantize="int8", calib_faces=calib,
                           device=dev)
    faces = torch.from_numpy(calib.astype(np.float32)).to(dev)
    a = fused.embed_batch_device(faces)[0]
    b = unfused.embed_batch_device(faces)[0]
    assert (a * b).sum(1).min().item() > 0.9999
    int8_gemm.PRODUCTS.reset()
    fused.embed_batch_device(faces)
    assert int8_gemm.PRODUCTS.count >= 8  # two products per unit, 4 units
    for m in fused.model.modules():
        if isinstance(m, FusedQuantBody):
            m.plain = True
    c = fused.embed_batch_device(faces)[0]
    torch.testing.assert_close(a, c, rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_sharded_searches_over_two_entries_of_the_card(dev, gen, kind):
    """sharded_cosine_topk and dp_sharded_cosine_topk over a mesh of two
    entries of the card, 65 536 rows: each row shard's K3 (bf16) or K4
    (int8) runs once per search, and the merged answer equals the
    single-device search over the whole gallery (ids equal; scores to
    1e-6: a row's score does not depend on the shard it is read in)."""
    from facerecognitionpipeline_tpu_torch.gallery.search import (
        _local_topk,
        dp_sharded_cosine_topk,
        sharded_cosine_topk,
    )
    from facerecognitionpipeline_tpu_torch.ops import gallery_kernel as gk
    from facerecognitionpipeline_tpu_torch.parallel.mesh import Mesh, make_mesh

    g, k, chunk = 65536, 5, 4096
    t = gen.normal(size=(g, 512)).astype(np.float32)
    t /= np.linalg.norm(t, axis=1, keepdims=True)
    t[-37:] = 0
    valid = np.ones(g, bool)
    valid[-37:] = False
    queries = t[gen.integers(0, g - 37, 16)] + gen.normal(0, 0.05, (16, 512)).astype(np.float32)
    tt = torch.from_numpy(t).to(dev)
    rows = tt.to(torch.bfloat16) if kind == "bf16" else gk.quantize_templates(tt)
    vv = torch.from_numpy(valid).to(dev)
    qq = torch.from_numpy(queries).to(dev)
    counter = gk.LAUNCHES if kind == "bf16" else gk.LAUNCHES_INT8
    ws, wi = _local_topk(qq, rows, vv, k, streaming=True, chunk=chunk)
    n0 = counter.count
    s1, i1 = sharded_cosine_topk(Mesh([dev] * 2, ("gallery",)), qq, rows, vv, k,
                                 streaming=True, chunk=chunk)
    s2, i2 = dp_sharded_cosine_topk(make_mesh(data=2, devices=[dev] * 2),
                                    qq.reshape(8, 2, 512), rows, vv, k,
                                    streaming=True, chunk=chunk)
    torch.cuda.synchronize()
    assert counter.count - n0 == 4  # two searches, one launch per row shard
    assert torch.equal(i1, wi) and torch.equal(i2.reshape(16, k), wi)
    torch.testing.assert_close(s1, ws, rtol=0, atol=1e-6)
    torch.testing.assert_close(s2.reshape(16, k), ws, rtol=0, atol=1e-6)
    assert i1.device.type == "cuda" and int(i1.max()) < g - 37


# ------------------------------------- K5 and the compiled step on the card


def _nms_sorted_boxes(b, n, seed, mode):
    """Score-sorted boxes [b, n, 4] float32 and v [b, n] as nms_mask hands
    K5: frame e < 6 a suppression chain of depth 1, 7, 8, 9, 64 or n (the
    last ends at the `it < n` cap; 10 px boxes shifted so that only
    neighbours conflict in this mode) among isolated boxes, then a frame
    with no valid box, then clustered proposals whose last slots hold pairs
    within a few ulps of IoU 0.7, zero-area, inverted, NaN and infinite
    boxes. Returns (boxes, v, depths)."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(20, 620, (b, n // 8 + 1, 2))
    pick = rng.integers(0, centres.shape[1], (b, n))
    c = np.take_along_axis(centres, pick[..., None].repeat(2, -1), 1) + rng.normal(0, 4, (b, n, 2))
    side = rng.uniform(20, 80, (b, n, 1))
    boxes = np.concatenate([c - side / 2, c + side / 2], -1).astype(np.float32)
    v = rng.random((b, n)) < 0.7
    v = np.sort(v, axis=1)[:, ::-1].copy()  # valid first, as the masked sort leaves them
    root = np.float32(3.0 if mode == "min" else 30.0 / 17.0)
    edge = []
    for k in range(16):
        t = root
        for _ in range(abs(k - 8)):
            t = np.nextafter(t, np.float32(np.inf if k > 8 else -np.inf))
        edge += [(0, 20 * k, 10, 20 * k + 10), (t, 20 * k, t + 10, 20 * k + 10)]
    edge += [(0, 400, 10, 410), (3, 400, 3, 410), (8, 400, 2, 410), (np.nan, 400, 10, 410),
             (-np.inf, 400, np.inf, 410), (-np.inf, 402, np.inf, 408)]
    edge = np.array(edge, np.float32)[:n] + np.float32(1000)
    boxes[-1, n - len(edge):] = edge
    v[-1, n - len(edge):] = True
    step = 2.5 if mode == "min" else 1.25
    s = np.arange(n)
    apart = np.stack([20 * (s % 64), 100 + 20 * (s // 64), 20 * (s % 64) + 10,
                      110 + 20 * (s // 64)], 1).astype(np.float32)
    depths = ([d for d in (1, 7, 8, 9, 64) if d <= n] + [n])[:b - 1]
    for e, d in enumerate(depths):
        boxes[e] = apart
        pos = np.round(np.linspace(0, n - 1, d)).astype(int)
        k = np.arange(d, dtype=np.float32)
        boxes[e, pos] = np.stack([step * k, 0 * k, step * k + 10, 0 * k + 10], 1)
        v[e] = True
    if b > 1:
        v[len(depths)] = False
    return torch.from_numpy(boxes), torch.from_numpy(v), depths


@pytest.mark.parametrize("mode", ["union", "min"])
@pytest.mark.parametrize("b,n", [(8, 1152), (8, 1408), (8, 256), (8, 96), (1, 1152), (1, 256),
                                 (1, 96), (3, 33), (2, 6000)])
def test_k5_equals_its_plain_version_to_the_bit(dev, b, n, mode):
    """K5 from sorted boxes at the cascade's shapes (stage 1 at 9 and 11
    scales, stages 2 and 3) at B=8 and B=1, an odd one and one whose packed
    rows live in device memory, in both modes: one launch, the plain
    version's keep mask bit for bit, every other box of a chain kept."""
    from facerecognitionpipeline_tpu_torch.ops import nms_kernel

    boxes, v, depths = _nms_sorted_boxes(b, n, n + b, mode)
    bb, vv = boxes.to(dev), v.to(dev)
    n0 = nms_kernel.LAUNCHES.count
    got = nms_kernel.nms_sorted_kernel(bb, vv, 0.7, mode)
    torch.cuda.synchronize()
    assert nms_kernel.LAUNCHES.count == n0 + 1
    assert torch.equal(got, nms_kernel.nms_sorted_plain(bb, vv, 0.7, mode))
    for e, d in enumerate(depths):
        assert int(got[e].sum()) == (n - d) + (d + 1) // 2
    geo = nms_kernel.nms_launch_geometry(b, n)
    assert geo.rows_in_smem == (n <= 5000) and (geo.cluster > 1) == (n >= 256)


def test_nms_mask_on_the_card_makes_no_n_by_n_tensor(dev):
    """nms_mask on the card computes the conflict bits inside K5: a
    TorchDispatchMode sees no tensor of N * N elements or more, and the
    answer is the CPU's."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from facerecognitionpipeline_tpu_torch.ops import nms, nms_kernel

    class Sizes(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.largest = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor):
                    self.largest = max(self.largest, t.numel())
            return out

    rng = np.random.default_rng(2)
    for n, mode in ((1152, "union"), (256, "union"), (96, "min")):
        boxes, _, _ = _nms_sorted_boxes(8, n, n, mode)
        scores = torch.from_numpy(rng.random((8, n)).astype(np.float32))
        valid = scores > 0.3
        want = nms.nms_mask(boxes, scores, valid, 0.7, mode)
        n0 = nms_kernel.LAUNCHES.count
        with Sizes() as sizes:
            got = nms.nms_mask(boxes.to(dev), scores.to(dev), valid.to(dev), 0.7, mode)
        assert nms_kernel.LAUNCHES.count == n0 + 1
        assert sizes.largest < n * n, (n, sizes.largest)
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("kind", ["bf16", "f32", "int8"])
def test_gallery_kernels_top_k_past_1024(dev, gen, kind):
    """F2's residue repaired: top_k 1025 (lists in device memory past the
    old bound) on the card equals the plain version."""
    from facerecognitionpipeline_tpu_torch.ops import gallery_kernel as gk

    t, valid, q = _long_list_case(gen, 65, 8192 + 32, 512)
    tt, vv, qq = (torch.from_numpy(a).to(dev) for a in (t, valid, q))
    kv, ki = _held_to_plain(gk, kind, qq, tt, vv, 1025, 32)
    assert ki[0, :2].tolist() == [3, 8192 + 32 - 20]


def test_k2_planar_to_the_bit(dev, gen):
    from facerecognitionpipeline_tpu_torch.ops.warp_kernel import (
        warp_patches_kernel,
        warp_patches_plain,
    )

    patches = torch.from_numpy(gen.uniform(0, 255, (20, 128, 128, 3)).astype(np.float32)).to(dev)
    ang = gen.uniform(-0.6, 0.6, 20)
    sc = gen.uniform(0.8, 1.2, 20) * 127 / 111
    coeffs = torch.from_numpy(np.stack(
        [sc * np.cos(ang), -sc * np.sin(ang), gen.uniform(-3, 3, 20),
         sc * np.sin(ang), sc * np.cos(ang), gen.uniform(-3, 3, 20)], 1).astype(np.float32)).to(dev)
    got = warp_patches_kernel(patches, coeffs, 112, 112, planar=True)
    assert got.shape == (20, 3, 112, 112)
    assert torch.equal(got, warp_patches_plain(patches, coeffs, 112, 112, planar=True))
    assert torch.equal(got, warp_patches_kernel(patches, coeffs, 112, 112).permute(0, 3, 1, 2))


@pytest.fixture
def small_engine(dev):
    """A bf16 engine on the card (det 320x320, 8 face slots, ir_micro),
    a float32 gallery and two 2x2 mosaics of the smoke fixture's tiles."""
    return _small_engine(dev)


def _small_engine(dev):
    import os

    from facerecognitionpipeline_tpu_torch.gallery.search import DeviceGallery
    from facerecognitionpipeline_tpu_torch.models.detector import MTCNNDetector
    from facerecognitionpipeline_tpu_torch.pipeline.embedder import FaceEmbedder
    from facerecognitionpipeline_tpu_torch.pipeline.engine import RecognitionEngine

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    det = MTCNNDetector(det_size=(320, 320), max_faces=8, min_face_size=40,
                        dtype=torch.bfloat16, device="cuda",
                        weights_path=os.path.join(repo, "pretrained", "mtcnn_dr.npz"))
    emb = FaceEmbedder("ir_micro", dtype=torch.bfloat16, random_ok=True, device="cuda")
    with np.load(os.path.join(repo, "facerecognitionpipeline_tpu_torch", "testdata",
                              "smoke_scenes.npz")) as z:
        tiles = z["tiles"]
    frames = np.zeros((2, 320, 320, 3), np.uint8)
    for f in range(2):
        for p in range(4):
            r, c = divmod(p, 2)
            frames[f, 160 * r:160 * (r + 1), 160 * c:160 * (c + 1)] = tiles[(4 * f + p) % 16]
    rng = np.random.default_rng(1)
    g = rng.normal(size=(300, 512)).astype(np.float32)
    gallery = DeviceGallery(device="cuda")
    gallery.rebuild([str(i) for i in range(300)], g / np.linalg.norm(g, axis=1, keepdims=True))
    t, v, _ = gallery.device_snapshot()
    return {"det": det, "emb": emb, "engine": RecognitionEngine(det, emb, top_k=3),
            "frames": torch.from_numpy(frames).to(dev), "t": t, "v": v,
            "make": lambda **kw: RecognitionEngine(det, emb, top_k=3, **kw)}


def _tree_equal(a, b):
    if isinstance(b, dict):
        return set(a) == set(b) and all(_tree_equal(a[k], b[k]) for k in b)
    return a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("budget", [None, 3])
def test_graphed_step_equals_the_eager_step(small_engine, budget):
    """process_frames on the card replays one CUDA graph per key, bit-equal
    to the eager step at B=1 and B=2 (with a budget, at rotations whose
    `rotation * 3` wraps int32); a replay adds the captured launch counts."""
    from facerecognitionpipeline_tpu_torch.ops import crop_kernel, nms_kernel, warp_kernel

    eng = small_engine["make"](embed_budget=budget)
    fr, t, v = small_engine["frames"], small_engine["t"], small_engine["v"]
    for b in (1, 2):
        for rot in (0, 1, 2**30 - 1):
            want = eng.step(t, v, fr[:b], 3, rot)
            got = eng.process_frames(fr[:b], t, v, rotation=rot)
            assert _tree_equal(got, want), (b, rot)
    assert len(eng._graphs) == 2 and len(eng._graphs.captures) == 2
    counts = [c.count for c in (crop_kernel.LAUNCHES, warp_kernel.LAUNCHES, nms_kernel.LAUNCHES)]
    eng.process_frames(fr, t, v)
    torch.cuda.synchronize()
    after = [c.count for c in (crop_kernel.LAUNCHES, warp_kernel.LAUNCHES, nms_kernel.LAUNCHES)]
    assert [b - a for a, b in zip(counts, after)] == [3, 1, 3]
    assert all(c["pool_bytes"] >= 0 for c in eng._graphs.captures)


def test_eager_step_holds_no_host_synchronisation(small_engine):
    eng = small_engine["make"](embed_budget=3)
    fr, t, v = small_engine["frames"], small_engine["t"], small_engine["v"]
    eng.step(t, v, fr, 3, 5)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = eng.step(t, v, fr, 3, 5)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert out["face_valid"].any()


def test_back_to_back_replays_leave_the_first_answer_alone(small_engine):
    """An answer copied on a side stream (as the batcher copies them) is
    not changed by the next replay: outputs are cloned off the graph's
    static buffers."""
    eng = small_engine["engine"]
    fr, t, v = small_engine["frames"], small_engine["t"], small_engine["v"]
    want = eng.step(t, v, fr, 3, 0)
    eng.process_frames(fr, t, v)  # captured
    side = torch.cuda.Stream()
    first = eng.process_frames(fr, t, v)
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        host = {k: x.to("cpu", non_blocking=True) for k, x in first.items()
                if isinstance(x, torch.Tensor)}
        for x in first.values():
            if isinstance(x, torch.Tensor):
                x.record_stream(side)
    second = eng.process_frames(torch.flip(fr, dims=[0]), t, v)
    side.synchronize()
    torch.cuda.synchronize()
    for k, x in host.items():
        assert torch.equal(x, want[k].cpu()), k
    assert not torch.equal(second["bboxes"], first["bboxes"])


# ------------------------------------- the pool route, top_k from POOL_MIN_K


def _pool_gallery(gen, rows=65536 + 32, d=512, nq=129):
    """A ragged last tile, a duplicated row (lower index first), the last 10
    rows invalid, query 0 equal to row 3; chunk 2049 divides the rows."""
    return _long_list_case(gen, nq, rows, d)


@pytest.mark.parametrize("kind", ["bf16", "f32", "int8"])
@pytest.mark.parametrize("top_k", [256, 1024, 4096, 14528])
@pytest.mark.parametrize("nq", [1, 65, 129])
def test_pool_route_equals_plain(dev, gen, kind, top_k, nq):
    """The pool route (sample, T_q, gather, select) against the plain
    version: K4 to the bit, K3 within 2e-5 (bf16 rows) and 1e-5 (float32
    rows) with equal indices where the scores stand apart; one launch
    counted on the kind's counter and its pool counter; no query
    unresolved on a random gallery."""
    from facerecognitionpipeline_tpu_torch.ops import gallery_kernel as gk

    rows = 65536 + 32
    t, valid, q = _pool_gallery(gen, rows, 512, nq)
    tt, vv, qq = (torch.from_numpy(a).to(dev) for a in (t, valid, q))
    assert gk.gallery_launch_geometry(nq, rows, 512, kind, 132, top_k).lists == "pool"
    pool = gk.POOL_LAUNCHES[kind]
    n0 = pool.count
    gk.reset_unresolved()
    kv, ki = _held_to_plain(gk, kind, qq, tt, vv, top_k, 2049)
    assert pool.count == n0 + 1 and gk.unresolved_queries() == 0
    assert ki[0, :2].tolist() == [3, rows - 20]


@pytest.mark.parametrize("kind", ["bf16", "f32", "int8"])
def test_pool_route_in_query_blocks_equals_plain(dev, gen, kind):
    """600 queries at top_k 64: the sample's scores bound a block to 256
    queries, so the call launches the pool route three times (256, 256 and
    88 queries, the last on its own grid) into one output; the answer is
    the plain version's, one call counted."""
    from facerecognitionpipeline_tpu_torch.ops import gallery_kernel as gk

    rows, nq = 65536 + 32, 600
    geo = gk.gallery_launch_geometry(nq, rows, 512, kind, 132, 64)
    assert (geo.lists, geo.block) == ("pool", 256)
    t, valid, q = _pool_gallery(gen, rows, 512, nq)
    tt, vv, qq = (torch.from_numpy(a).to(dev) for a in (t, valid, q))
    pool = gk.POOL_LAUNCHES[kind]
    n0 = pool.count
    gk.reset_unresolved()
    kv, ki = _held_to_plain(gk, kind, qq, tt, vv, 64, 2049)
    assert pool.count == n0 + 1 and gk.unresolved_queries() == 0
    assert ki[0, :2].tolist() == [3, rows - 20]


@pytest.mark.parametrize("kind", ["bf16", "f32", "int8"])
def test_pool_route_is_repeatable_to_the_bit(dev, gen, kind):
    """Two calls give the same bits: the pools fill in whatever order the
    blocks append, and the select's total order does not see it."""
    from facerecognitionpipeline_tpu_torch.ops import gallery_kernel as gk

    t, valid, q = _pool_gallery(gen)
    tt, vv, qq = (torch.from_numpy(a).to(dev) for a in (t, valid, q))
    rows = tt.to(torch.bfloat16) if kind == "bf16" else tt
    if kind == "int8":
        codes, scales = gk.quantize_templates(tt)
        first = gk.streaming_cosine_topk_int8(qq, codes, scales, vv, 1024, chunk=2049)
        second = gk.streaming_cosine_topk_int8(qq, codes, scales, vv, 1024, chunk=2049)
    else:
        first = gk.streaming_cosine_topk(qq, rows, vv, 1024, chunk=2049)
        second = gk.streaming_cosine_topk(qq, rows, vv, 1024, chunk=2049)
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


@pytest.mark.parametrize("kind", ["bf16", "f32", "int8"])
def test_pool_route_sends_adversarial_queries_on(dev, gen, kind):
    """Queries 0 and 1 see 1402 rows tie for their best score (past a pool
    of 4 x 256): they go on to the device lists, counted on the card, and
    the answer is the plain version's (the ties by index);
    the forced route "pool_unresolved" sends every query on and answers the
    same."""
    from facerecognitionpipeline_tpu_torch.ops import gallery_kernel as gk

    t, valid, q = _pool_gallery(gen, nq=5)
    t[100:1500] = t[3]
    q[1] = q[0]
    tt, vv, qq = (torch.from_numpy(a).to(dev) for a in (t, valid, q))
    for route, sent in ((None, 2), ("pool_unresolved", 5)):
        gk.reset_unresolved()
        if kind == "int8":
            codes, scales = gk.quantize_templates(tt)
            kv, ki = gk._card_search(qq, codes, vv, 256, scales, route)
            pv, pi = gk.streaming_cosine_topk_int8_plain(qq, codes, scales, vv, 256, chunk=2049)
            torch.cuda.synchronize()
            assert torch.equal(kv, pv) and torch.equal(ki, pi)
        else:
            rows = tt.to(torch.bfloat16) if kind == "bf16" else tt
            kv, ki = gk._card_search(qq, rows, vv, 256, route=route)
            pv, pi = gk.streaming_cosine_topk_plain(qq, rows, vv, 257, chunk=2049)
            torch.cuda.synchronize()
            _assert_topk_agrees(kv, ki, pv, pi, 2e-5 if kind == "bf16" else 1e-5)
        assert gk.unresolved_queries() == sent
        assert ki[0].tolist() == ki[1].tolist() == [3] + list(range(100, 355))


def test_pool_route_in_a_cuda_graph_equals_the_eager_call(dev, gen):
    """A search past the crossover captured in a CUDA graph: the route is
    decided on the card (no host read), so the capture holds; a replay
    equals the eager call."""
    from facerecognitionpipeline_tpu_torch.ops import gallery_kernel as gk

    t, valid, q = _pool_gallery(gen)
    tt, vv, qq = (torch.from_numpy(a).to(dev) for a in (t, valid, q))
    rows = tt.to(torch.bfloat16)
    want = gk.streaming_cosine_topk(qq, rows, vv, 1024, chunk=2049)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        gk.streaming_cosine_topk(qq, rows, vv, 1024, chunk=2049)  # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = gk.streaming_cosine_topk(qq, rows, vv, 1024, chunk=2049)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_stage_bisects_on_the_card(dev):
    """The stage bisects (`pipeline/stage_profile.py`) at a small build:
    every stage graph's replay equals its eager call bit for bit, one
    replay launches the kernels its stage runs (a streaming step K3 or K4
    once, a dense one neither), and every time is the card's."""
    from facerecognitionpipeline_tpu_torch.pipeline import stage_profile as SP

    step = {"crop_resize": 3, "warp_patches": 1, "nms_fixpoint": 3}
    detect = {"crop_resize": 2, "nms_fixpoint": 3}
    fused = SP.profile_fused_step(b=2, faces=8, det=320, chain=2, samples=1,
                                  architecture="ir_micro", device=dev)
    programs = SP.profile_detect(b=2, det=320, chain=2, samples=1, device=dev)
    scale = SP.profile_gallery_scale(b=2, faces=8, det=320, sizes=(4096,),
                                     impls=("dense", "streaming", "streaming_int8"), chain=2,
                                     samples=1, architecture="ir_micro", device=dev)
    for r in fused + programs + scale:
        assert r["replay_equals_eager"] is True, r
        assert r["device_ms"] > 0 and r["timing"] == "cuda-events" and r["card"], r
    launches = {r["stage"]: r["launches"] for r in fused}
    assert launches["detect (cascade)"] == detect
    assert launches["align (kernel K1+K2)"] == {"crop_resize": 1, "warp_patches": 1}
    assert launches["  align (matmul warp, alt)"] == {} and launches["quality gate"] == {}
    assert launches["FULL fused step"] == step
    assert programs[-1]["launches"] == detect and programs[0]["launches"] == {}
    assert [r["launches"] for r in scale] == [
        step, {**step, "gallery_topk": 1}, {**step, "gallery_topk_int8": 1}]


# ------------------------------------------------ the batcher's spans on the card


@contextlib.contextmanager
def _started_batcher(small):
    """A started DeviceBatcher over the small engine (buckets 1 and 2,
    warmed) and its two frames on the host."""
    from facerecognitionpipeline_tpu_torch.serve.batcher import DeviceBatcher

    t, v = small["t"], small["v"]
    b = DeviceBatcher(small["engine"], lambda: (t, v), max_batch=2, max_wait_ms=1.0)
    b.warmup((320, 320))
    b.start()
    try:
        yield b, small["frames"].cpu().numpy()
    finally:
        b.stop()


@pytest.fixture
def card_batcher(small_engine):
    with _started_batcher(small_engine) as got:
        yield got


def test_batcher_steps_count_the_k2_launches(card_batcher):
    """`batcher.steps` against K2's launch delta (one a step; ops/launches.py)."""
    from facerecognitionpipeline_tpu_torch.ops.launches import kernel_counts

    b, frames = card_batcher
    b.submit(frames[0]).result(timeout=120)
    torch.cuda.synchronize()
    k2, steps = kernel_counts()["warp_patches"], b.steps.count
    futs = [b.submit(frames[i % 2]) for i in range(40)]
    for f in futs:
        f.result(timeout=120)
    torch.cuda.synchronize()
    assert b.steps.count - steps == kernel_counts()["warp_patches"] - k2 > 0


def _clock_check(out_dir: str) -> dict:
    """100 steps of a started batcher under `profile_trace` with its tracer,
    in this process's first profiler session. Per step (us, on the exported
    trace's clock): how far the profiler's first device operation of that
    replay (the frames' copy into the graph's buffer, then its kernels) lies
    from the `step.device` span's start, and where each D2H copy starts
    after the span's end."""
    import os

    from facerecognitionpipeline_tpu_torch.telemetry import monitor as tmon

    with _started_batcher(_small_engine(torch.device("cuda"))) as (b, frames):
        b.submit(frames[0]).result(timeout=120)
        torch.cuda.synchronize()
        with tmon.profile_trace(out_dir, tracer=b.tracer):
            for i in range(100):
                b.submit(frames[i % 2]).result(timeout=120)
            torch.cuda.synchronize()
    (name,) = os.listdir(out_dir)
    with open(os.path.join(out_dir, name)) as f:
        ev = json.load(f)["traceEvents"]
    steps = sorted((e for e in ev if e.get("cat") == "program_span" and e["name"] == "step.device"),
                   key=lambda e: e["ts"])
    ops = [e for e in ev if e.get("cat") in ("kernel", "gpu_memcpy")]
    firsts, copies = [], []
    bounds = [s["ts"] for s in steps] + [math.inf]
    prev_end = -math.inf
    for k, s in enumerate(steps):  # the ops between the midpoints to the neighbouring steps
        end = s["ts"] + s["dur"]
        lo, hi = (prev_end + s["ts"]) / 2, (end + bounds[k + 1]) / 2
        mine = [e for e in ops if lo <= e["ts"] < hi]
        step_ops = [e for e in mine if e["cat"] == "kernel" or "DtoD" in e["name"]]
        if step_ops:
            firsts.append(abs(min(e["ts"] for e in step_ops) - s["ts"]))
        copies += [e["ts"] - end for e in mine if "DtoH" in e["name"]]
        prev_end = end
    return {"steps": len(steps), "ops": len(ops), "firsts": firsts, "copies": copies}


def test_step_events_on_the_host_clock_meet_the_profilers_first_kernel(dev, tmp_path):
    """Each `step.device` span, put on the host clock by the tracer's anchor
    and on the profiler's by `profile_trace`, starts within 0.1 ms (median
    over 100 steps) of the first device operation the profiler saw in that
    replay, and ends before the step's answer is copied to the host. The
    check runs in a process of its own (`_clock_check`): in a later profiler
    session of one process the profiler's device timestamps slide against
    its host ones, and other tests here open profiler sessions."""
    import os
    import statistics
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (repo, os.environ.get("PYTHONPATH")) if p)}
    r = subprocess.run([sys.executable, os.path.abspath(__file__), str(tmp_path)], cwd=repo,
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got["steps"] == 100 and got["ops"] and got["copies"]
    assert len(got["firsts"]) >= 90
    assert statistics.median(got["firsts"]) < 100.0, statistics.median(got["firsts"])
    assert statistics.median(got["copies"]) > -100.0, statistics.median(got["copies"])


if __name__ == "__main__":  # the clock check's own process
    import sys

    print(json.dumps(_clock_check(sys.argv[1])))
