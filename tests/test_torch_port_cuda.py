"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA card (marker `cuda`) and skips without one:
a CUDA kernel has no interpret mode. The file imports neither JAX nor the
JAX package, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest tests/test_torch_port_cuda.py -m cuda

(`--noconftest` because tests/conftest.py sets up JAX.) Tolerances: K1 and
K2 agree with their plain versions to the bit (every sum has at most two
exact bf16 x bf16 products), held at 1e-5 on unit-scale data and 1e-3 on
the 0..255 scale.
"""

import numpy as np
import pytest
import torch

from facerecognitionpipeline_tpu_torch.ops import crop_kernel, warp_kernel
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
from facerecognitionpipeline_tpu_torch.ops.warp_kernel import warp_patches_plain

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
