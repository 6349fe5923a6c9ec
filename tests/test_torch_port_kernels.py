"""The port's kernel modules (K1 crop_resize, K2 warp_patches) against the
JAX package's Pallas kernels, on the CPU.

The JAX side runs `crop_resize_pallas` / `warp_patches_affine` in interpret
mode, as tests/test_pallas_crop.py and tests/test_pallas_warp.py do; the
port's wrappers take their plain versions on CPU tensors. Tolerances:

* K1 plain vs the JAX XLA twin `crop_resize(compute_dtype=bf16)`: bit-exact
  (<= 1e-5 abs on unit-scale data). Vs `crop_resize_pallas` in interpret
  mode: <= 1e-5 abs on >= 99.5% of outputs, and at most one bf16 step of
  the rows pass (4e-3 on unit-scale data) anywhere: the interpreted Pallas
  kernel itself disagrees with its XLA twin by one bf16 rounding of a few
  rows (see test_interpreted_pallas_crop_differs_from_its_xla_twin).
* K2 plain vs a float32 numpy evaluation of the kernel's stated math
  (coordinates a0*x + a1*y + a2 without contraction, bf16 patch and column
  weights, f32 rows, f32 row weights): bit-exact. Vs `warp_patches_affine`
  in interpret mode: <= 1e-2 abs on the 0..255 scale for >= 99% of pixels,
  and at most one bf16 step of a hat weight times 255 (~1 grey level)
  anywhere: XLA:CPU contracts the interpreted kernel's a0*x + a1*y into a
  fused multiply-add, which moves a coordinate by one float32 ulp and,
  through the bf16 rounding of the weight, a pixel by up to one level
  (see test_interpreted_pallas_warp_contracts_coordinates).

The CUDA kernels themselves are compared with their plain versions by
tests/test_torch_port_cuda.py (marked `cuda`, skipped without a card) and
by chip_smoke.py.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from facerecognitionpipeline_tpu.ops.pallas_crop import crop_resize_pallas
from facerecognitionpipeline_tpu.ops.pallas_warp import warp_patches_affine
from facerecognitionpipeline_tpu.ops.warp import (
    align_faces_batch_pallas,
    crop_resize as jax_crop_resize,
    reference_template as jax_template,
    warp_coeffs as jax_warp_coeffs,
)
from facerecognitionpipeline_tpu_torch.ops import crop_kernel, cuda_build, warp_kernel
from facerecognitionpipeline_tpu_torch.ops.crop_kernel import (
    crop_resize_kernel,
    crop_resize_plain,
)
from facerecognitionpipeline_tpu_torch.ops.warp import align_faces_batch, reference_template
from facerecognitionpipeline_tpu_torch.ops.warp_kernel import (
    warp_patches_kernel,
    warp_patches_plain,
)

torch.set_num_threads(2)


def _boxes(rng, b, n, s, lo=4.0):
    x1 = rng.uniform(-5, s - 10, (b, n))
    y1 = rng.uniform(-5, s - 10, (b, n))
    w = rng.uniform(lo, s, (b, n))
    h = rng.uniform(lo, s, (b, n))
    return np.stack([x1, y1, x1 + w, y1 + h], axis=-1).astype(np.float32)


def _landmarks(rng, b, f, s):
    """Plausible 5-point sets: the template scaled, rotated and placed."""
    tpl = jax_template(112) - 56.0
    out = np.zeros((b, f, 5, 2), np.float32)
    for i in range(b):
        for j in range(f):
            sc = rng.uniform(0.4, 1.3)
            th = rng.uniform(-0.3, 0.3)
            rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
            c = rng.uniform(40, s - 40, 2)
            out[i, j] = (tpl @ rot.T) * sc + c
    return out


@pytest.mark.parametrize("k", [24, 48])
def test_k1_plain_matches_xla_twin_exactly(rng, k):
    b, n, s = 2, 12, 64
    img = rng.uniform(-1, 1, (b, s, s, 3)).astype(np.float32)
    boxes = _boxes(rng, b, n, s)
    ref = np.stack([
        np.asarray(jax_crop_resize(
            jnp.asarray(img[i]), jnp.asarray(boxes[i]), k, compute_dtype=jnp.bfloat16
        ))
        for i in range(b)
    ])
    out = crop_resize_plain(torch.from_numpy(img), torch.from_numpy(boxes), k).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("k,n", [(24, 16), (48, 8), (16, 7)])
def test_k1_plain_matches_pallas(rng, k, n):
    b, s = 2, 64
    img = rng.uniform(-1, 1, (b, s, s, 3)).astype(np.float32)
    boxes = _boxes(rng, b, n, s)
    ref = np.asarray(crop_resize_pallas(jnp.asarray(img), jnp.asarray(boxes), k))
    out = crop_resize_kernel(torch.from_numpy(img), torch.from_numpy(boxes), k).numpy()
    assert out.shape == (b, n, k, k, 3)
    err = np.abs(out - ref)
    assert (err <= 1e-5).mean() >= 0.995
    assert err.max() <= 4e-3


def test_interpreted_pallas_crop_differs_from_its_xla_twin(rng):
    """Records why the K1 tolerance against the interpreted Pallas kernel
    is not bit-exact: on these inputs the JAX package's own Pallas kernel
    (interpret mode) and XLA `crop_resize` (bf16) disagree by one bf16
    rounding of the rows pass in a few output rows, while the port equals
    the XLA twin bit for bit (test_k1_plain_matches_xla_twin_exactly)."""
    b, n, s, k = 2, 16, 64, 48
    img = np.random.default_rng(0).uniform(-1, 1, (b, s, s, 3)).astype(np.float32)
    r = np.random.default_rng(0)
    r.uniform(-1, 1, (b, s, s, 3))
    boxes = _boxes(r, b, n, s)
    pallas = np.asarray(crop_resize_pallas(jnp.asarray(img), jnp.asarray(boxes), k))
    xla = np.stack([
        np.asarray(jax_crop_resize(
            jnp.asarray(img[i]), jnp.asarray(boxes[i]), k, compute_dtype=jnp.bfloat16
        ))
        for i in range(b)
    ])
    port = crop_resize_plain(torch.from_numpy(img), torch.from_numpy(boxes), k).numpy()
    np.testing.assert_array_equal(port, xla)
    diff = np.abs(pallas - xla)
    assert 0 < diff.max() <= 4e-3
    assert (diff > 0).mean() < 0.005


def test_k1_lossless_integer_window(rng):
    """An integer-aligned window of exactly k pixels is a pixel copy (the
    alignment stage A snap): one-hot weights, output = bf16(frame)."""
    s, k = 160, 32
    img = rng.integers(0, 256, (1, s, s, 3)).astype(np.float32)
    boxes = np.array([[[10, 20, 10 + k, 20 + k], [100, 3, 100 + k, 3 + k]]], np.float32)
    out = crop_resize_kernel(torch.from_numpy(img), torch.from_numpy(boxes), k).numpy()
    np.testing.assert_array_equal(out[0, 0], img[0, 20:20 + k, 10:10 + k])
    np.testing.assert_array_equal(out[0, 1], img[0, 3:3 + k, 100:100 + k])


def test_k1_zero_outside_frame():
    img = np.ones((1, 8, 8, 3), np.float32)
    boxes = np.array([[[-8.0, -8.0, 0.0, 0.0], [8.0, 8.0, 16.0, 16.0]]], np.float32)
    out = crop_resize_kernel(torch.from_numpy(img), torch.from_numpy(boxes), 4).numpy()
    assert np.all(out[0, 0, :3, :3] == 0) and np.all(out[0, 1, 1:, 1:] == 0)


def test_k1_single_frame_api(rng):
    img = torch.from_numpy(rng.uniform(0, 255, (32, 32, 3)).astype(np.float32))
    boxes = torch.from_numpy(_boxes(rng, 1, 5, 32)[0])
    one = crop_resize_kernel(img, boxes, 8)
    batched = crop_resize_kernel(img[None], boxes[None], 8)[0]
    assert one.shape == (5, 8, 8, 3)
    np.testing.assert_array_equal(one.numpy(), batched.numpy())


def _bf16(x):
    return np.asarray(x, np.float32).astype(ml_dtypes.bfloat16).astype(np.float32)


def _numpy_k2(patches, coeffs, oh, ow, contract=False):
    """K2's stated math in float32 numpy. contract=True evaluates
    a0*x + a1*y as fma(a0, x, a1*y), as XLA:CPU does in interpret mode."""
    n, k, _, c = patches.shape
    o = np.arange(oh * ow)
    x = (o % ow).astype(np.float32)
    y = (o // ow).astype(np.float32)
    cf = coeffs.astype(np.float32)

    def coord(a, b, t):
        ax = cf[:, a, None] * x
        by = (cf[:, b, None] * y).astype(np.float32)
        if contract:
            s = (cf[:, a, None].astype(np.float64) * x + by).astype(np.float32)
        else:
            s = (ax + by).astype(np.float32)
        return (s + cf[:, t, None]).astype(np.float32)

    px, py = coord(0, 1, 2), coord(3, 4, 5)
    p16 = _bf16(patches)
    out = np.zeros((n, oh * ow, c), np.float32)
    idx = np.arange(n)[:, None]
    v0, u0 = np.floor(py).astype(int), np.floor(px).astype(int)
    for dv in (0, 1):
        v = v0 + dv
        wy = np.maximum(0, 1 - np.abs(py - v.astype(np.float32))).astype(np.float32)
        row = np.zeros((n, oh * ow, c), np.float32)
        for du in (0, 1):
            u = u0 + du
            wu = _bf16(np.maximum(0, 1 - np.abs(px - u.astype(np.float32))))
            ok = (u >= 0) & (u < k) & (v >= 0) & (v < k)
            val = p16[idx, np.clip(v, 0, k - 1), np.clip(u, 0, k - 1)]
            row = row + np.where(ok[..., None], val * wu[..., None], 0).astype(np.float32)
        ok_v = (v >= 0) & (v < k)
        out = out + np.where(ok_v[..., None], row * wy[..., None], 0).astype(np.float32)
    return out.reshape(n, oh, ow, c)


def _k2_inputs(rng, n=4, k=32):
    patches = rng.uniform(0, 255, (n, k, k, 3)).astype(np.float32)
    th = rng.uniform(-0.4, 0.4, n)
    sc = rng.uniform(0.8, 1.5, n)
    coeffs = np.stack([
        sc * np.cos(th), -sc * np.sin(th), rng.uniform(0, 6, n),
        sc * np.sin(th), sc * np.cos(th), rng.uniform(0, 6, n),
    ], axis=1).astype(np.float32)
    coeffs[0, 2] = -10.0  # samples partly outside the patch
    return patches, coeffs


def test_k2_plain_matches_stated_math_exactly(rng):
    patches, coeffs = _k2_inputs(rng)
    ref = _numpy_k2(patches, coeffs, 24, 20)
    out = warp_patches_kernel(torch.from_numpy(patches), torch.from_numpy(coeffs), 24, 20)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_k2_plain_matches_pallas(rng):
    n, oh, ow = 4, 24, 20
    patches, coeffs = _k2_inputs(rng, n)
    ref = np.asarray(warp_patches_affine(jnp.asarray(patches), jnp.asarray(coeffs), oh, ow))
    out = warp_patches_kernel(torch.from_numpy(patches), torch.from_numpy(coeffs), oh, ow)
    assert out.shape == (n, oh, ow, 3)
    err = np.abs(out.numpy() - ref)
    assert (err <= 1e-2).mean() >= 0.99
    assert err.max() <= 1.5


def test_interpreted_pallas_warp_contracts_coordinates(rng):
    """Where the port and the interpreted Pallas K2 differ by more than
    1e-2, the interpreted kernel equals the stated math with a0*x + a1*y
    contracted into an FMA."""
    patches, coeffs = _k2_inputs(rng, 8)
    pallas = np.asarray(warp_patches_affine(jnp.asarray(patches), jnp.asarray(coeffs), 56, 56))
    port = warp_patches_plain(torch.from_numpy(patches), torch.from_numpy(coeffs), 56, 56).numpy()
    fma = _numpy_k2(patches, coeffs, 56, 56, contract=True)
    far = np.abs(port - pallas) > 1e-2
    assert far.any()
    np.testing.assert_allclose(pallas[far], fma[far], rtol=0, atol=1e-3)


def test_align_faces_batch_matches_pallas(rng):
    """Stage A (K1) + stage B (K2) together, on the JAX package's coeffs."""
    b, f, s = 2, 3, 160
    frames = rng.integers(0, 256, (b, s, s, 3)).astype(np.float32)
    lm = _landmarks(rng, b, f, s)
    ref = np.asarray(align_faces_batch_pallas(
        jnp.asarray(frames), jnp.asarray(lm), jnp.asarray(jax_template(112)), 112
    ))
    out = align_faces_batch(
        torch.from_numpy(frames), torch.from_numpy(lm),
        torch.from_numpy(reference_template(112)), 112,
    ).numpy()
    assert out.shape == (b, f, 112, 112, 3)
    # The similarity fits sum in another order (coefficients agree to
    # ~1e-5 relative), and the bf16 hat weights turn such a coordinate
    # change into up to a grey level. On the engine's rounded 0..255 crops:
    err = np.abs(np.clip(np.round(out), 0, 255) - np.clip(np.round(ref), 0, 255))
    assert (err <= 1).mean() >= 0.99
    assert err.max() <= 2
    # the geometry: integer-snapped windows come out identical
    from facerecognitionpipeline_tpu.ops.warp import similarity_transform as jst
    from facerecognitionpipeline_tpu_torch.ops.warp import similarity_transform, warp_coeffs


    jm = jst(jnp.asarray(lm.reshape(-1, 5, 2)), jnp.asarray(jax_template(112)))
    jb, jc = jax_warp_coeffs(jm, 112, 112, 128)
    tb, tc = warp_coeffs(
        similarity_transform(torch.from_numpy(lm.reshape(-1, 5, 2)),
                             torch.from_numpy(reference_template(112))),
        112, 112, 128,
    )
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-5, atol=1e-5)
    snapped = (tb[:, 2] - tb[:, 0]).numpy() == 128
    np.testing.assert_array_equal(tb.numpy()[snapped], np.asarray(jb)[snapped])
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-5)


def test_cpu_wrappers_do_not_count_launches(rng):
    crop_kernel.LAUNCHES.reset()
    warp_kernel.LAUNCHES.reset()
    img = torch.zeros(1, 16, 16, 3)
    crop_resize_kernel(img, torch.tensor([[[0.0, 0.0, 8.0, 8.0]]]), 4)
    warp_patches_kernel(torch.zeros(1, 8, 8, 3), torch.zeros(1, 6), 4, 4)
    assert crop_kernel.LAUNCHES.count == 0 and warp_kernel.LAUNCHES.count == 0


def test_wrappers_reject_bad_inputs():
    with pytest.raises(ValueError):
        crop_resize_kernel(torch.zeros(1, 8, 8, 3), torch.zeros(1, 2, 3), 4)
    with pytest.raises(ValueError):
        crop_resize_kernel(torch.zeros(2, 8, 8, 3), torch.zeros(1, 2, 4), 4)
    with pytest.raises(ValueError):
        warp_patches_kernel(torch.zeros(1, 8, 6, 3), torch.zeros(1, 6), 4, 4)
    with pytest.raises(ValueError):
        warp_patches_kernel(torch.zeros(2, 8, 8, 3), torch.zeros(1, 6), 4, 4)
    with pytest.raises(ValueError, match="unsupported device"):
        crop_resize_kernel(
            torch.zeros(1, 8, 8, 3, device="meta"),
            torch.zeros(1, 2, 4, device="meta"), 4,
        )


def test_build_flags():
    """sm_90a, no fast math, no FMA contraction; builds go to build/kernels."""
    flags = " ".join(cuda_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast_math" not in flags and "-fmad=false" in flags
    assert cuda_build.BUILD_DIR.endswith("build/kernels")
    paths = {cuda_build._lib_path(n) for n in cuda_build.KERNEL_NAMES}
    assert len(paths) == len(cuda_build.KERNEL_NAMES)


# ------------------------------------------------- launch geometry (K1, K2)
#
# The arithmetic of a launch lives in Python (`crop_launch_geometry`,
# `warp_launch_geometry`) so that it is tested here, where no card is: the
# serving step's shapes and the odd ones the card tests launch.

from facerecognitionpipeline_tpu_torch.ops.crop_kernel import crop_launch_geometry
from facerecognitionpipeline_tpu_torch.ops.warp_kernel import warp_launch_geometry

_SMS = 132  # streaming multiprocessors of an H100
_K1_SERVING = [  # (b, n, h, w, c, k): R-net, O-net, alignment stage A
    (8, 256, 320, 320, 3, 24), (8, 96, 640, 640, 3, 48), (8, 16, 640, 640, 3, 128),
]
_K1_ODD = [
    (2, 5, 33, 45, 3, 7), (2, 5, 40, 56, 1, 12), (1, 3, 24, 31, 4, 8),
    (3, 1, 64, 64, 3, 24), (1, 1, 8, 8, 3, 1), (1, 2, 64, 64, 3, 1000),
    (1, 1, 16, 16, 1, 4096),
]


@pytest.mark.parametrize("shape", _K1_SERVING + _K1_ODD)
def test_k1_launch_geometry(shape):
    b, n, h, w, c, k = shape
    geo = crop_launch_geometry(*shape)
    boxes, bands = geo.grid
    assert boxes == b * n and 1 <= boxes < 2**31 and 1 <= bands <= 65535
    # every output row lies in exactly one band
    assert (bands - 1) * geo.band_rows < k <= bands * geo.band_rows
    assert geo.threads % 32 == 0 and 32 <= geo.threads <= 256
    assert geo.threads - 32 < geo.band_rows * k * c  # no warp without a float
    assert geo.smem_bytes == 16 * (k * c + geo.band_rows)
    assert geo.smem_bytes <= cuda_build.SMEM_LIMIT_BYTES == 232_448


@pytest.mark.parametrize("shape", _K1_SERVING)
def test_k1_serving_geometry_fills_the_card(shape):
    """Each serving launch gives every SM several blocks, and no block has
    more than a few thousand floats behind one set of tap tables."""
    geo = crop_launch_geometry(*shape)
    k, c = shape[5], shape[4]
    assert geo.grid[0] * geo.grid[1] >= 4 * _SMS
    assert geo.band_rows * k * c <= 3072
    assert geo.band_rows == {24: 24, 48: 16, 128: 8}[k]
    assert geo.threads == 256


@pytest.mark.parametrize("shape,match", [
    ((1, 1, 40000, 40000, 3, 8), "32-bit"),  # a frame of more than 2**31 floats
    ((1, 1, 64, 64, 3, 30000), "32-bit"),  # a crop of more than 2**31 floats
    ((1, 1, 64, 64, 4, 4000), "shared memory"),  # tap tables over 227 KB
    ((1, 0, 64, 64, 3, 8), "at least 1"),
])
def test_k1_geometry_refuses(shape, match):
    with pytest.raises(ValueError, match=match):
        crop_launch_geometry(*shape)


_K2_SHAPES = [  # (f, k, c, out_h, out_w): the serving call first
    (128, 128, 3, 112, 112), (1, 128, 3, 112, 112), (130, 128, 3, 112, 112),
    (4, 64, 3, 112, 112), (3, 8, 3, 5, 5), (2, 32, 1, 28, 28), (2, 32, 4, 28, 28),
    (2, 16, 3, 12, 12), (1, 138, 3, 112, 112),
]


@pytest.mark.parametrize("shape", _K2_SHAPES)
def test_k2_launch_geometry(shape):
    f, k, c, oh, ow = shape
    geo = warp_launch_geometry(*shape)
    assert geo.grid == f  # one block per face
    assert geo.threads % 32 == 0 and 32 <= geo.threads <= 1024
    assert geo.threads - 32 < oh * ow  # no warp without a pixel
    assert geo.chunks <= 32 and (geo.chunks - 1) * 4096 < k * k * c <= geo.chunks * 4096
    patch_bytes = 4 * k * k * c
    assert patch_bytes % 16 == 0  # the bulk copy's rule
    staging = geo.threads * c * 4 if geo.vec == 4 else 0
    assert geo.smem_bytes == 256 + patch_bytes + staging
    assert geo.smem_bytes + 64 <= cuda_build.SMEM_LIMIT_BYTES
    if geo.vec == 4:
        assert (oh * ow * c) % 4 == 0
    else:  # direct stores: no float4 possible, or no room for the staging
        assert (oh * ow * c) % 4 or 256 + patch_bytes + geo.threads * c * 4 + 64 > 232_448


def test_k2_serving_geometry():
    geo = warp_launch_geometry(128, 128, 3, 112, 112)
    assert geo == (128, 1024, 4, 12, 256 + 196608 + 12288)


@pytest.mark.parametrize("shape,vec", [
    ((128, 128, 3, 112, 112), 4),  # the serving call: float4 through staging
    ((3, 8, 3, 5, 5), 1),  # 75 floats per face: no float4 possible
    ((2, 32, 1, 27, 27), 1),  # 729 floats per face
    ((1, 138, 3, 112, 112), 1),  # the patch fits, its staging does not
    ((2, 32, 4, 27, 27), 4),  # four channels: any face is a multiple of 4
])
def test_k2_store_path_follows_the_shapes(shape, vec):
    assert warp_launch_geometry(*shape).vec == vec


@pytest.mark.parametrize("k,c", [(160, 3), (140, 3), (256, 1)])
def test_k2_refuses_a_patch_over_shared_memory(k, c):
    """No banded variant: a patch that does not fit one block's shared
    memory is refused with the limit named, never sent to the plain version."""
    with pytest.raises(ValueError, match="shared memory.*232384"):
        warp_launch_geometry(4, k, c, 112, 112)


@pytest.mark.parametrize("k,c", [(7, 3), (5, 1), (9, 2), (3, 3)])
def test_k2_refuses_a_patch_the_bulk_copy_cannot_take(k, c):
    """A patch that is not a multiple of 16 bytes long is refused with the
    rule named, never sent to the plain version."""
    with pytest.raises(ValueError, match="multiple of 16 bytes.*16-byte address"):
        warp_launch_geometry(3, k, c, 5, 5)


def test_k2_geometry_refuses_empty_dimensions():
    with pytest.raises(ValueError, match="at least 1"):
        warp_launch_geometry(0, 8, 3, 8, 8)


def test_cpu_wrappers_take_the_plain_versions(rng):
    """The card's rules (a patch of a multiple of 16 bytes, on a 16-byte
    address) bind the kernel alone: CPU tensors take the plain version
    whatever their shape or address, and no launch is counted."""
    img = torch.from_numpy(rng.uniform(-1, 1, (1, 16, 16, 3)).astype(np.float32))
    boxes = torch.tensor([[[1.0, 2.0, 9.0, 12.0]]])
    n1, n2 = crop_kernel.LAUNCHES.count, warp_kernel.LAUNCHES.count
    assert torch.equal(crop_resize_kernel(img, boxes, 4), crop_resize_plain(img, boxes, 4))
    patches, coeffs = _k2_inputs(rng, 2, 7)  # 147 floats per patch
    flat = torch.zeros(patches.size + 1)
    flat[1:] = torch.from_numpy(patches).reshape(-1)
    p, c = flat[1:].view(2, 7, 7, 3), torch.from_numpy(coeffs)
    assert torch.equal(warp_patches_kernel(p, c, 4, 4), warp_patches_plain(p, c, 4, 4))
    assert (crop_kernel.LAUNCHES.count, warp_kernel.LAUNCHES.count) == (n1, n2)


def test_launch_functions_are_configured_once(monkeypatch):
    """`cuda_build.function` sets a C function's argument types at its first
    use and hands the same object back afterwards."""
    class Lib:
        def __init__(self):
            self.frp_x = lambda *a: 0

    loads = []
    monkeypatch.setattr(cuda_build, "load", lambda name: loads.append(name) or Lib())
    monkeypatch.setattr(cuda_build, "_fns", {})
    import ctypes
    fn = cuda_build.function("k", "frp_x", [ctypes.c_int])
    assert fn.argtypes == [ctypes.c_int] and fn.restype is ctypes.c_int
    assert cuda_build.function("k", "frp_x", [ctypes.c_int]) is fn and loads == ["k"]
