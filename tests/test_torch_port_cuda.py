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

import json
import math

import numpy as np
import pytest
import torch

from facerecognitionpipeline_tpu_torch.ops import crop_kernel, int8_gemm, warp_kernel
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
    neighbouring scores are further apart than `tol`."""
    assert ki.dtype == torch.int64 and kv.dtype == torch.float32
    assert float((kv - pv).abs().max()) <= tol
    gap = (pv[:, :-1] - pv[:, 1:]).abs() > 2 * tol
    clear = torch.ones_like(pi, dtype=torch.bool)
    clear[:, :-1] &= gap
    clear[:, 1:] &= gap
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
    with pytest.raises(ValueError, match="ROADMAP.md"):
        gk.streaming_cosine_topk(qq, tt.to(torch.bfloat16), vv, top_k=65, chunk=64)
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
    enrolled faces are recognized, every step launched K1 three times and K2
    once, and the monitor reads device memory from torch.cuda."""
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
    crop_kernel.LAUNCHES.reset()
    warp_kernel.LAUNCHES.reset()
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


def test_probe_labeler_cli_refuses_top_k_over_64_on_the_card(dev, gen, tmp_path):
    """F2: the streaming kernels keep at most 64 entries; `probe_labeler
    --top_k 65` against a card-sized gallery meets their ValueError (the JAX
    Pallas kernel answers; ROADMAP.md F2)."""
    from facerecognitionpipeline_tpu_torch.cli import probe_labeler

    _, probe_dir, gm = _streaming_labeler(dev, gen, tmp_path)
    gm.save()
    argv = ["--probe_dir", probe_dir, "--gallery_path", gm.gallery_path, "--architecture",
            "ir_micro", "--no_copy", "--device", "cuda"]
    assert probe_labeler.main(argv + ["--top_k", "64"]) == 0
    with pytest.raises(ValueError, match="at most top_k=64"):
        probe_labeler.main(argv + ["--top_k", "65"])
