"""The compiled step of the port, on the CPU: NMS (K5's plain version and
models of its arithmetic and cluster schedule), the embed-budget rotation as
a wrapping int32, the step's freedom from host reads, K2's planar output and
the CUDA-graph bookkeeping of `pipeline/step_graph.py`.

NMS is held to the JAX package's `nms_mask` (its `while_loop`) on suppression
chains built to converge at a chosen depth, and at the `it < n` cap. K5's
IoU (float32 op by op, NaN-propagating max/min, the filter before the
division) is modelled in numpy and held to torch's `pairwise_iou` and
threshold bit for bit, at the threshold and at the edges of the arithmetic;
its schedule (group-major packed rows of the valid boxes, a cluster of
blocks per frame exchanging keep words every sweep, the two-slot flag, a
frame stopping at its own convergence) is modelled in numpy and held to the
plain version bit for bit, as `test_torch_port_gallery_kernel.py` holds
K3/K4's decomposition. The embed-budget step is held to the JAX step
at rotations whose `rotation * embed_budget` passes 2**31, where the JAX
engine's int32 wraps. `StepGraphs` runs with its capture function injected
(an eager stand-in), which checks its keys, generations, output copies and
launch counts without a card.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from facerecognitionpipeline_tpu.models.detector import MTCNNDetector as JaxDetector
from facerecognitionpipeline_tpu.ops.nms import nms_mask as jax_nms_mask
from facerecognitionpipeline_tpu.ops.pallas_warp import warp_patches_affine
from facerecognitionpipeline_tpu.pipeline.embedder import FaceEmbedder as JaxEmbedder
from facerecognitionpipeline_tpu.pipeline.engine import RecognitionEngine as JaxEngine
from facerecognitionpipeline_tpu_torch.gallery.search import DeviceGallery
from facerecognitionpipeline_tpu_torch.models.detector import MTCNNDetector
from facerecognitionpipeline_tpu_torch.ops import cuda_build, nms as tnms
from facerecognitionpipeline_tpu_torch.ops.nms_kernel import (
    MAX_CLUSTER,
    THREADS,
    band_bounds,
    group_offset,
    nms_fixpoint_plain,
    nms_launch_geometry,
    nms_sorted_kernel,
    nms_sorted_plain,
)
from facerecognitionpipeline_tpu_torch.ops.warp_kernel import (
    warp_patches_kernel,
    warp_patches_plain,
)
from facerecognitionpipeline_tpu_torch.pipeline import step_graph
from facerecognitionpipeline_tpu_torch.pipeline.embedder import FaceEmbedder
from facerecognitionpipeline_tpu_torch.pipeline.engine import (
    RecognitionEngine,
    rotation_tensor,
)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, "pretrained", "mtcnn_dr.npz")
FIXTURE = os.path.join(
    REPO, "facerecognitionpipeline_tpu_torch", "testdata", "smoke_scenes.npz"
)
DET = dict(det_size=(160, 160), max_faces=4, min_face_size=40)


# ---------------------------------------------------------------- NMS (K5)


def _chain_boxes(n, chains, rng):
    """n box slots holding suppression chains of the given lengths: boxes
    10 px wide, each 5 px right of the one before (IoU 1/3 with a
    neighbour, 0 further along), scores falling along a chain, chains far
    apart; the remaining slots invalid. Returns boxes [n,4], scores [n],
    valid [n] (float32, float32, bool) with the slots shuffled."""
    boxes = np.zeros((n, 4), np.float32)
    scores = np.zeros(n, np.float32)
    valid = np.zeros(n, bool)
    s = 0
    for c, length in enumerate(chains):
        y = 40.0 * c
        for k in range(length):
            boxes[s] = (5.0 * k, y, 5.0 * k + 10.0, y + 10.0)
            scores[s] = 0.99 - 1e-4 * k - 1e-6 * c
            valid[s] = True
            s += 1
    assert s <= n
    perm = rng.permutation(n)
    return boxes[perm], scores[perm], valid[perm]


# (n, chain lengths per batch element): chains converging at depth 1, 7, 8, 9 and 64, an
# all-invalid element, and a single chain of n boxes whose loop ends at the
# `it < n` cap (n even and odd)
NMS_CASES = [
    (96, [[1], [7], [8], [9]]),
    (96, [[64, 3], [2, 9, 1], []]),
    (40, [[40]]),
    (41, [[41]]),
    (256, [[64, 64, 5], [1] * 30, [17]]),
]


@pytest.mark.parametrize("n,chains", NMS_CASES)
def test_nms_fixpoint_matches_the_jax_while_loop(n, chains):
    rng = np.random.default_rng(n)
    cases = [_chain_boxes(n, c, rng) for c in chains]
    boxes, scores, valid = (np.stack(x) for x in zip(*cases))
    want = np.stack([
        np.asarray(jax_nms_mask(jnp.asarray(b), jnp.asarray(s), jnp.asarray(v),
                                iou_threshold=0.3))
        for b, s, v in cases
    ])
    got = tnms.nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores),
                        torch.from_numpy(valid), iou_threshold=0.3)
    np.testing.assert_array_equal(got.numpy(), want)
    # greedy along a chain keeps every other box
    for c, (b, s, v) in zip(chains, cases):
        assert got.numpy()[chains.index(c)].sum() == sum((length + 1) // 2 for length in c)


def test_nms_fixpoint_kernel_takes_its_plain_version_on_the_cpu():
    """K5's wrapper on CPU tensors is `nms_sorted_plain`: today's torch ops
    (pairwise_iou, the threshold, the below-diagonal mask, the loop)."""
    rng = np.random.default_rng(3)
    boxes = torch.from_numpy(_cascade_boxes(rng, 3, 50))
    v = torch.from_numpy(rng.random((3, 50)) < 0.8)
    for mode in ("union", "min"):
        iou = tnms.pairwise_iou(boxes, mode)
        idx = torch.arange(50)
        conflict = (iou > 0.7) & (idx[None, :] < idx[:, None])
        want = nms_fixpoint_plain(conflict, v).numpy()
        np.testing.assert_array_equal(nms_sorted_plain(boxes, v, 0.7, mode).numpy(), want)
        np.testing.assert_array_equal(nms_sorted_kernel(boxes, v, 0.7, mode).numpy(), want)
    with pytest.raises(ValueError):
        nms_sorted_kernel(boxes, v[:, :49], 0.7)
    with pytest.raises(ValueError):
        nms_sorted_kernel(boxes[..., :3], v, 0.7)
    with pytest.raises(ValueError):
        nms_sorted_kernel(boxes.to("meta"), v.to("meta"), 0.7)


# ------------------------------------------- K5's arithmetic, modelled in numpy


def _cascade_boxes(rng, b, n):
    """[b, n, 4] float32 boxes like a cascade stage's proposals: clusters of
    jittered squares of 20-80 px over a 640 px frame."""
    centres = rng.uniform(20, 620, (b, n // 8 + 1, 2))
    pick = rng.integers(0, centres.shape[1], (b, n))
    c = np.take_along_axis(centres, pick[..., None].repeat(2, -1), 1)
    c = c + rng.normal(0, 4, (b, n, 2))
    side = rng.uniform(20, 80, (b, n, 1))
    return np.concatenate([c - side / 2, c + side / 2], -1).astype(np.float32)


def _edge_boxes(mode, thr=0.7):
    """[m, 4] float32 boxes at the edges of the IoU's arithmetic: pairs of a
    10 px box and one shifted by t, t stepped by ulps around the IoU's root
    (so the float32 IoU lands within a few ulps of thr, on both sides), a
    zero-area and an inverted box over a third, a NaN coordinate, boxes
    reaching infinity (inf - inf inside the IoU) and the NaN area they give."""
    root = np.float32(10 * (1 - thr) if mode == "min" else 10 * (1 - thr) / (1 + thr))
    out = []
    for k in range(24):
        t = root
        for _ in range(abs(k - 12)):
            t = np.nextafter(t, np.float32(np.inf if k > 12 else -np.inf))
        y = np.float32(20 * k)
        out += [(0, y, 10, y + 10), (t, y, t + 10, y + 10)]
    y = 600
    out += [(0, y, 10, y + 10), (3, y, 3, y + 10), (8, y, 2, y + 10),
            (np.nan, y, 10, y + 10), (2, y, 12, np.nan), (-np.inf, y, np.inf, y + 10),
            (-np.inf, y + 2, np.inf, y + 8), (np.inf, y, np.inf, y + 10)]
    return np.array(out, np.float32)


def _conflict_model(boxes, thr, mode):
    """K5's conflict bit (csrc/nms_fixpoint.cu::conflict) in numpy float32,
    op by op: NaN-propagating max/min (np.maximum/np.minimum, as max.NaN),
    each product, sum and difference rounded to float32, the filter on
    thr * d (1 +- 2^-20) and the correctly rounded division where it cannot
    decide. boxes [n, 4] -> [n, n] bool (all i, j)."""
    f = np.float32
    with np.errstate(all="ignore"):
        x1, y1, x2, y2 = (boxes[:, k] for k in range(4))
        area = np.maximum(x2 - x1, f(0)) * np.maximum(y2 - y1, f(0))
        ix1 = np.maximum(x1[:, None], x1[None, :])
        iy1 = np.maximum(y1[:, None], y1[None, :])
        ix2 = np.minimum(x2[:, None], x2[None, :])
        iy2 = np.minimum(y2[:, None], y2[None, :])
        inter = np.maximum(ix2 - ix1, f(0)) * np.maximum(iy2 - iy1, f(0))
        if mode == "min":
            denom = np.minimum(area[:, None], area[None, :])
        else:
            denom = (area[:, None] + area[None, :]) - inter
        d = np.maximum(denom, f(1e-9))
        t = f(thr)
        maybe = (inter > 0) | ((t < 0) & (inter == 0))
        exact = (inter / d) > t
        if not f(1e-20) <= t <= f(1e20):
            return maybe & exact
        a = t * d
        ok = d <= f(1e30)
        sure = ok & (inter > a * f(1 + 2.0**-20))
        near = maybe & ~sure & ~(ok & (inter < a * f(1 - 2.0**-20)))
        assert not (maybe & sure & ~exact).any() and not (maybe & ~near & ~sure & exact).any()
        return maybe & (sure | (near & exact))


def _torch_conflict(boxes, thr, mode):
    return (tnms.pairwise_iou(torch.from_numpy(boxes), mode) > thr).numpy()


@pytest.mark.parametrize("mode", ["union", "min"])
@pytest.mark.parametrize("thr", [0.7, 0.3, 0.5])
def test_k5_iou_arithmetic_equals_pairwise_iou_on_cascade_boxes(mode, thr):
    rng = np.random.default_rng(int(thr * 10))
    boxes = _cascade_boxes(rng, 1, 300)[0]
    np.testing.assert_array_equal(_conflict_model(boxes, thr, mode),
                                  _torch_conflict(boxes, thr, mode))


@pytest.mark.parametrize("mode", ["union", "min"])
@pytest.mark.parametrize("thr", [0.7, 0.3, 0.5])
def test_k5_iou_arithmetic_at_the_threshold_and_the_edges(mode, thr):
    """Pairs within a few ulps of the threshold on both sides, zero-area,
    inverted, NaN and infinite boxes: the model (filter and division) gives
    torch's bits, and the pairs do straddle the threshold."""
    boxes = _edge_boxes(mode, thr)
    got = _conflict_model(boxes, thr, mode)
    np.testing.assert_array_equal(got, _torch_conflict(boxes, thr, mode))
    pairs = got[np.arange(1, 48, 2), np.arange(0, 48, 2)]
    assert pairs.any() and not pairs.all()
    iou = tnms.pairwise_iou(torch.from_numpy(boxes[:48]), mode).numpy()
    near = iou[np.arange(1, 48, 2), np.arange(0, 48, 2)]
    ulp = np.spacing(np.float32(thr))
    assert (np.abs(near - np.float32(thr)) <= 8 * ulp).sum() >= 8


def test_torch_compares_with_the_python_threshold_in_float32():
    """What csrc/nms_fixpoint.cu's note relies on: `iou > thr` with a float32
    tensor and a Python float compares in float32 (float32(0.3) > 0.3 is
    false, as double it would be true), so the kernel takes thr as a float."""
    x = torch.tensor([np.float32(0.3)])
    assert not bool(x > 0.3) and float(np.float32(0.3)) > 0.3


# ------------------------------------------- K5's cluster schedule, modelled


def _sorted_case(rng, b, n, mode, thr=0.7):
    """Score-sorted boxes [b, n, 4] and v [b, n] as nms_mask hands K5."""
    boxes = _cascade_boxes(rng, b, n)
    scores = rng.random((b, n)).astype(np.float32)
    valid = scores > 0.3
    masked = np.where(valid, scores, np.float32(-1e9))
    order = np.argsort(-masked, axis=1, kind="stable")
    return (np.take_along_axis(boxes, order[..., None].repeat(4, -1), 1),
            np.take_along_axis(valid, order, 1))


def _k5_model(boxes, v, thr, mode, rng, cluster=None):
    """K5's cluster schedule in numpy (csrc/nms_fixpoint.cu), per frame: the
    conflict words of the valid rows and of words holding a valid box,
    written into the group-major packing at `group_offset` (everything else
    left as random garbage, which the sweeps must never see); C blocks, each
    owning the groups of its band with its own copies of the four keep
    masks; a sweep computes each block's words from its rows and writes
    them into every block's copy, raises every block's flag slot on a
    change, then crosses one barrier; check c reads slot c % 2 and clears
    the other; the frame stops at its own convergence or at it >= n."""
    b, n = v.shape
    c = cluster or nms_launch_geometry(b, n).cluster
    w_n, bounds = -(-n // 32), band_bounds(n, c)
    out = np.zeros((b, n), bool)
    for e in range(b):
        bits = _conflict_model(boxes[e], thr, mode)
        vpad = np.zeros(32 * w_n, bool)
        vpad[:n] = v[e]
        vbits = (vpad.reshape(w_n, 32).astype(np.uint64)
                 << np.arange(32, dtype=np.uint64)).sum(1)
        nv = int(np.flatnonzero(v[e])[-1]) + 1 if v[e].any() else 0
        gv = -(-nv // 32)
        rows = rng.integers(0, 2**32, group_offset(w_n), dtype=np.uint64)
        for i in range(nv):
            if not v[e, i]:
                continue
            g = i >> 5
            for w in range(g + 1):
                if vbits[w] == 0:
                    continue
                j = np.arange(32 * w, 32 * w + 32)
                ok = (j < i) & vpad[j] & bits[i, np.minimum(j, n - 1)]
                rows[group_offset(g) + 32 * w + (i & 31)] = (
                    ok.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum()
        # per block: [vbits, keep, prev, spare] copies and two flag slots
        masks = [[vbits.copy()] + [rng.integers(0, 2**32, w_n, dtype=np.uint64)
                                   for _ in range(3)] for _ in range(c)]
        flags = [[0, 0] for _ in range(c)]

        def sweep(src, dst, cmp, slot):
            for k in range(c):
                for g in range(bounds[k], bounds[k + 1]):
                    sup = 0
                    if g < gv:
                        for r in range(32):
                            words = rows[group_offset(g) + 32 * np.arange(g + 1) + r]
                            if np.any(words & masks[k][src][:g + 1]):
                                sup |= 1 << r
                    word = masks[k][0][g] & np.uint64(~sup & 0xFFFFFFFF)
                    for kk in range(c):
                        masks[kk][dst][g] = word
                    if cmp is not None and word != masks[k][cmp][g]:
                        for kk in range(c):
                            flags[kk][slot] = 1
            for k in range(1, c):  # past the barrier every copy of dst is the same
                assert (masks[k][dst] == masks[0][dst]).all()

        keep, prev, spare = 1, 2, 3
        sweep(0, keep, None, 0)
        for t in range(1, 7):
            sweep(keep, spare, keep if t == 6 else None, 0)
            prev, keep, spare = keep, spare, prev
        check, it = 0, 7
        while it < n:
            assert len({f[check & 1] for f in flags}) == 1
            if flags[0][check & 1] == 0:
                break
            nxt = (check + 1) & 1
            for f in flags:
                f[nxt] = 0
            sweep(keep, spare, None, nxt)
            sweep(spare, prev, keep, nxt)
            keep, prev = prev, keep
            check, it = check + 1, it + 2
        kb = ((masks[0][keep][:, None] >> np.arange(32, dtype=np.uint64)) & np.uint64(1))
        out[e] = kb.astype(bool).reshape(-1)[:n]
    return out


def _plain(boxes, v, thr, mode):
    return nms_sorted_plain(torch.from_numpy(boxes), torch.from_numpy(v), thr, mode).numpy()


@pytest.mark.parametrize("b,n,mode,cluster", [
    (4, 96, "min", None), (3, 256, "union", None), (2, 70, "union", 2), (5, 33, "min", None),
    (2, 1, "union", None), (2, 300, "union", 4), (2, 200, "min", 8),
])
def test_k5_block_schedule_model_equals_the_plain_loop(b, n, mode, cluster):
    """The cluster model on score-sorted cascade boxes (one frame all
    invalid) equals `nms_sorted_plain` bit for bit."""
    rng = np.random.default_rng(b * 1000 + n)
    boxes, v = _sorted_case(rng, b, n, mode)
    v[0] = False  # an all-invalid frame
    np.testing.assert_array_equal(_k5_model(boxes, v, 0.7, mode, rng, cluster),
                                  _plain(boxes, v, 0.7, mode))


@pytest.mark.parametrize("n", [64, 65])
def test_k5_block_schedule_model_on_chains_to_the_cap(n):
    """Chains of depth 1, 7, 8, 9 and 64 (with isolated boxes around), one
    of all n boxes (the loop ends at the it < n cap, n even and odd), and an
    all-invalid frame: the model equals the plain loop and keeps every other
    box of a chain."""
    rng = np.random.default_rng(11 + n)
    chains = ([64 if n > 64 else n], [9, 8], [7], [1], [n], [])
    cases = [_chain_boxes(n, c, rng) for c in chains]
    boxes, scores, valid = (np.stack(x) for x in zip(*cases))
    masked = np.where(valid, scores, np.float32(-1e9))
    order = np.argsort(-masked, axis=1, kind="stable")
    bs = np.take_along_axis(boxes, order[..., None].repeat(4, -1), 1)
    v = np.take_along_axis(valid, order, 1)
    want = _plain(bs, v, 0.3, "union")
    for cluster in (None, 2):
        np.testing.assert_array_equal(_k5_model(bs, v, 0.3, "union", rng, cluster), want)
    assert [int(want[e].sum()) for e in range(len(chains))] == [
        sum((length + 1) // 2 for length in c) for c in chains]


def test_k5_triangular_packing_and_geometry():
    """The group-major packing, the bands and the launch geometry: every
    row in one band, each band within 2x of the mean's packed words, the
    cascade's shapes in shared memory with a cluster at stage 1, a large N
    in the device scratch, the refusals."""
    total = 0
    for g in range(200):
        assert group_offset(g) == total
        total += 32 * (g + 1)
    for n in list(range(1, 200)) + [256, 1025, 1152, 1408, 3000, 5000, 6000]:
        geo = nms_launch_geometry(1, n)
        bounds = geo.bands
        assert bounds[0] == 0 and bounds[-1] == geo.words == -(-n // 32)
        assert list(bounds) == sorted(bounds) and len(bounds) == geo.cluster + 1
        words = [group_offset(hi) - group_offset(lo) for lo, hi in zip(bounds, bounds[1:])]
        assert sum(words) == geo.row_words == group_offset(geo.words)
        assert max(words) <= 2 * geo.row_words / geo.cluster, n
        assert geo.band_words == max(words)
        assert 1 <= geo.cluster <= MAX_CLUSTER and geo.cluster & (geo.cluster - 1) == 0
    # the cascade's shapes: stage 1 at 9 and 11 scales, stages 2 and 3
    for n, c in ((1152, 16), (1408, 16), (256, 4), (96, 1)):
        geo = nms_launch_geometry(8, n)
        assert geo.rows_in_smem and (geo.cluster, geo.grid, geo.threads) == (c, 8 * c, THREADS)
        assert geo.smem_bytes == (16 * n + 16 * geo.words + 4 * (-(-n // 4) * 4)
                                  + 4 * geo.band_words)
        assert geo.smem_bytes <= cuda_build.SMEM_LIMIT_BYTES - 64
    big = nms_launch_geometry(2, 6000)
    assert not big.rows_in_smem and big.smem_bytes == 16 * big.words
    assert nms_launch_geometry(2, 5000).rows_in_smem
    with pytest.raises(ValueError, match="at least 1"):
        nms_launch_geometry(0, 5)
    with pytest.raises(ValueError, match="indices"):
        nms_launch_geometry(1, 2**20)
    with pytest.raises(ValueError, match="shared memory"):
        nms_launch_geometry(1, 2**20 - 1)
    assert "nms_fixpoint" in cuda_build.KERNEL_NAMES


# ------------------------------------------------------- K2 planar output


@pytest.mark.parametrize("f,k,c,out", [(5, 32, 3, 28), (3, 16, 1, 12), (2, 24, 4, 17)])
def test_k2_planar_output_matches_the_jax_kernel(f, k, c, out):
    rng = np.random.default_rng(f + k)
    patches = rng.uniform(0, 255, (f, k, k, c)).astype(np.float32)
    ang = rng.uniform(-0.5, 0.5, f)
    sc = rng.uniform(0.8, 1.2, f) * (k - 1) / (out - 1)
    coeffs = np.stack([sc * np.cos(ang), -sc * np.sin(ang), rng.uniform(-2, 2, f),
                       sc * np.sin(ang), sc * np.cos(ang), rng.uniform(-2, 2, f)],
                      axis=1).astype(np.float32)
    jp, jc = jnp.asarray(patches), jnp.asarray(coeffs)
    want = np.asarray(warp_patches_affine(jp, jc, out, out, tile=128, planar=True))
    np.testing.assert_array_equal(
        want, np.asarray(warp_patches_affine(jp, jc, out, out, tile=128)).transpose(0, 3, 1, 2))
    tp, tc = torch.from_numpy(patches), torch.from_numpy(coeffs)
    got = warp_patches_plain(tp, tc, out, out, planar=True).numpy()
    assert got.shape == (f, c, out, out)
    # the tolerance of test_torch_port_kernels.py's K2 check: the interpreted
    # Pallas kernel contracts a0*x + a1*y into an FMA, which moves a few
    # sample positions by an ulp
    err = np.abs(got - want)
    assert (err <= 1e-2).mean() >= 0.99
    assert err.max() <= 1.5
    # planar is the channels-last result transposed, bit for bit
    nhwc = warp_patches_kernel(tp, tc, out, out).numpy()
    np.testing.assert_array_equal(warp_patches_kernel(tp, tc, out, out, planar=True).numpy(),
                                  nhwc.transpose(0, 3, 1, 2))


# ----------------------------------------------- the embed-budget rotation


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


@pytest.fixture(scope="module")
def frames():
    with np.load(FIXTURE) as d:
        return np.ascontiguousarray(d["tiles"][:3])


@pytest.fixture(scope="module")
def pair():
    jdet = JaxDetector(**DET, dtype=jnp.bfloat16, weights_path=WEIGHTS, crop_impl="pallas")
    jemb = JaxEmbedder("ir_micro", dtype=jnp.bfloat16, random_ok=True)
    tdet = MTCNNDetector(**DET, dtype=torch.bfloat16, weights_path=WEIGHTS,
                         crop_impl="kernel", device="cpu")
    temb = FaceEmbedder("ir_micro", dtype=torch.bfloat16,
                        variables={"params": _to_numpy(jemb.variables["params"])},
                        device="cpu")
    return jdet, jemb, tdet, temb


@pytest.fixture(scope="module")
def templates():
    rng = np.random.default_rng(7)
    t = rng.normal(size=(40, 512)).astype(np.float32)
    t /= np.linalg.norm(t, axis=1, keepdims=True)
    dg = DeviceGallery(device="cpu")
    dg.rebuild([str(i) for i in range(len(t))], t)
    tt, tv, _ = dg.device_snapshot()
    tt = tt.to(torch.bfloat16)
    return (jnp.asarray(tt.float().numpy()).astype(jnp.bfloat16), jnp.asarray(tv.numpy())), (tt, tv)


@pytest.fixture(scope="module")
def mosaics():
    """Two 480x480 frames, each a 3x3 mosaic of fixture tiles: nine faces a
    frame for six face slots."""
    with np.load(FIXTURE) as d:
        tiles = d["tiles"]
    out = np.zeros((2, 480, 480, 3), np.uint8)
    for f in range(2):
        for p in range(9):
            r, c = divmod(p, 3)
            out[f, 160 * r:160 * (r + 1), 160 * c:160 * (c + 1)] = tiles[(7 * f + p) % 16]
    return out


@pytest.fixture(scope="module")
def budget_engines(pair, templates):
    """The JAX step (compiled once, `rotation` a traced int32) and the
    port's engine at embed_budget 3 of 6 face slots, on a 480x480
    detector, with a gate every detection passes (the rotation's window
    slides over the eligible slots, whatever makes them eligible). Six
    slots, not four: the int32 wrap moves the window by 2**32 mod n
    eligible slots, nothing for n = 1, 2 or 4."""
    from facerecognitionpipeline_tpu.ops.quality import QualityConfig as JaxQuality
    from facerecognitionpipeline_tpu_torch.ops.quality import QualityConfig

    _, jemb, _, temb = pair
    (jt, jv), _ = templates
    det = dict(DET, det_size=(480, 480), max_faces=6)
    jdet = JaxDetector(**det, dtype=jnp.bfloat16, weights_path=WEIGHTS, crop_impl="pallas")
    tdet = MTCNNDetector(**det, dtype=torch.bfloat16, weights_path=WEIGHTS,
                         crop_impl="kernel", device="cpu")
    gate = dict(min_det_score=0.5, min_face_size=0.0, max_yaw=180.0, max_pitch=1e9,
                max_roll=180.0, check_blur=False)
    jeng = JaxEngine(jdet, jemb, top_k=2, align_impl="pallas", embed_budget=3,
                     quality_config=JaxQuality(**gate))
    teng = RecognitionEngine(tdet, temb, top_k=2, embed_budget=3,
                             quality_config=QualityConfig(**gate))
    compiled = {}

    def jax_step(frames, rotation):
        args = (jeng.detector.variables, jeng.embedder.variables, jt, jv,
                jnp.asarray(frames))
        rot = jnp.asarray(rotation, jnp.int32)
        if "step" not in compiled:
            compiled["step"] = (
                jax.jit(jeng._step_impl, static_argnames=("gallery_k",))
                .lower(*args, gallery_k=2, rotation=rot)
                .compile(compiler_options={"xla_allow_excess_precision": False})
            )
        return _to_numpy(compiled["step"](*args, rotation=rot))

    return jax_step, teng


# 7e8 * 3 stays below 2**31; 8e8 * 3 and (2**30 - 1) * 3 pass it and wrap
@pytest.mark.parametrize("rotation", [0, 1, 7 * 10**8, 8 * 10**8, 2**30 - 1])
def test_embed_budget_rotation_wraps_as_the_jax_int32(budget_engines, mosaics, templates,
                                                      rotation):
    """The slots the budget embeds, at the JAX step's own detections: the
    selection depends only on the detections, the gate and `rotation`, so
    `embedded` must be equal, and it is where `rotation * embed_budget`
    wraps in the JAX engine's int32 (an int without the wrap picks other
    slots there, 2**32 mod 5 and mod 6 being 1 and 4)."""
    jax_step, teng = budget_engines
    _, (tt, tv) = templates
    a = jax_step(mosaics, rotation)
    n_elig = (a["face_valid"] & a["quality_ok"]).sum(axis=1)
    assert (n_elig > 4).all(), n_elig
    det = {"bboxes": a["bboxes"], "scores": a["det_scores"],
           "landmarks": a["landmarks"], "valid": a["face_valid"]}
    with torch.inference_mode():
        st = teng._embed(
            teng._shards[0], torch.from_numpy(np.asarray(mosaics, np.float32)),
            {k: torch.from_numpy(np.array(v)) for k, v in det.items()},
            rotation_tensor(rotation, torch.device("cpu")),
        )
        r = teng._finish(st, *teng._match(st["q"], tt, tv, 2), 2)
    np.testing.assert_array_equal(r["embedded"].numpy(), a["embedded"])
    # the int the batcher passes selects as the wrapped int32 tensor does
    b = teng.process_frames(mosaics, tt, tv, rotation=rotation)
    wrapped = torch.tensor((rotation + 2**31) % 2**32 - 2**31, dtype=torch.int32)
    c = teng.step(tt, tv, torch.from_numpy(mosaics), 2, wrapped)
    np.testing.assert_array_equal(b["embedded"].numpy(), c["embedded"].numpy())


def test_rotation_tensor_wraps_ints_to_int32():
    cpu = torch.device("cpu")
    for v, want in [(0, 0), (2**31 - 1, 2**31 - 1), (2**31, -2**31), (-1, -1),
                    (2**32 + 5, 5)]:
        t = rotation_tensor(v, cpu)
        assert t.dtype == torch.int32 and t.dim() == 0 and int(t) == want
    t = torch.tensor(7, dtype=torch.int64)
    assert rotation_tensor(t, cpu).dtype == torch.int32


# ------------------------------------------------- no host reads in the step


class _HostReads(TorchDispatchMode):
    """Records the ops that read a tensor on the host (or would on a card:
    a data-dependent output size, a tensor made from host data)."""

    HOST = ("_local_scalar_dense", "nonzero", "masked_select", "unique", "lift_fresh",
            "_unique2", "item")

    def __init__(self):
        super().__init__()
        self.found = []
        self.paused = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.__name__.split(".")[0]
        if not self.paused and (name in self.HOST or
                                (name == "repeat_interleave" and "output_size" not in (kwargs or {}))
                                or (name == "index" and any(
                                    isinstance(i, torch.Tensor) and i.dtype == torch.bool
                                    for i in (args[1] if len(args) > 1 else ())))):
            self.found.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("route", ["dense", "budget", "i420", "int8_pair"])
def test_the_step_reads_nothing_on_the_host(pair, frames, templates, route, monkeypatch):
    """Every op of the eager step but NMS's plain loop (which K5 replaces on
    the card) runs without reading a tensor on the host: what makes the
    step capturable as a CUDA graph."""
    _, _, tdet, temb = pair
    _, (tt, tv) = templates
    kw = {}
    fr = torch.from_numpy(frames)
    if route == "budget":
        kw["embed_budget"] = 2
    if route == "i420":
        from facerecognitionpipeline_tpu_torch.serve.rawproto import rgb_to_i420

        kw["input_format"] = "i420"
        fr = torch.from_numpy(np.stack([rgb_to_i420(f) for f in frames]))
    if route == "int8_pair":
        from facerecognitionpipeline_tpu_torch.ops.gallery_kernel import quantize_templates

        tt = quantize_templates(tt.float())
    eng = RecognitionEngine(tdet, temb, top_k=2, **kw)
    mode = _HostReads()
    plain = tnms.nms_sorted_kernel

    def unwatched(*a):
        mode.paused = True
        try:
            return plain(*a)
        finally:
            mode.paused = False

    monkeypatch.setattr(tnms, "nms_sorted_kernel", unwatched)
    rot = rotation_tensor(5, torch.device("cpu"))
    with mode:
        out = eng.step(tt, tv, fr, gallery_k=2, rotation=rot)
    assert not mode.found, mode.found
    assert out["face_valid"].any()


# ----------------------------------------------- StepGraphs' bookkeeping


class _FakeCapture:
    """An eager stand-in for `CudaCapture`: the 'graph' recomputes the step
    into the static outputs it returned, and records the launches of a
    counter the step bumps once."""

    def __init__(self, counter):
        self.counter = counter
        self.calls = 0

    def __call__(self, fn, device):
        self.calls += 1
        outputs = fn()

        def replay():
            fresh = fn()
            _copy_into(outputs, fresh)

        return step_graph.Captured(replay, outputs, ((self.counter, 3),), 1024, 0.0)


def _copy_into(dst, src):
    if isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k])
    else:
        dst.copy_(src)


class _TinyEngine:
    """An engine with one shard whose step sums frames and gallery."""

    class _Sh:
        device = torch.device("cpu")

    def __init__(self):
        self._shards = [self._Sh()]

    def _shard_part(self, i, frames, rotation, templates, valid, k):
        t = templates[0] if isinstance(templates, tuple) else templates
        return {"y": frames.float().sum(dim=(1, 2, 3)) + t.float().sum() + rotation.float(),
                "nested": {"k": torch.full((frames.shape[0],), float(k))}}

    def _combine(self, parts, templates, valid, k):
        return parts[0]


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def test_step_graphs_capture_once_per_key_and_drop_old_generations():
    counter = cuda_build.LaunchCounter()
    cap = _FakeCapture(counter)
    graphs = step_graph.StepGraphs(_TinyEngine(), capture=cap)
    t1, v1 = torch.ones(4, 2), torch.ones(4, dtype=torch.bool)
    fr = torch.arange(2 * 2 * 2 * 3, dtype=torch.uint8).reshape(2, 2, 2, 3)

    out = graphs.run(fr, t1, v1, 3, 0)
    assert cap.calls == 1 and len(graphs) == 1 and counter.count == 3
    out2 = graphs.run(fr + 1, t1, v1, 3, 2)  # same key: a replay
    assert cap.calls == 1 and counter.count == 6
    np.testing.assert_allclose(out2["y"].numpy(), out["y"].numpy() + 12 + 2)
    # returned outputs are copies, never the static buffers
    static = list(_leaves(next(iter(graphs._graphs.values())).captured.outputs))
    for got in (out, out2):
        for leaf in _leaves(got):
            assert all(leaf.data_ptr() != s.data_ptr() for s in static)
    # a new batch shape or k is a new key of the same generation
    graphs.run(fr[:1], t1, v1, 3, 0)
    graphs.run(fr, t1, v1, 5, 0)
    assert cap.calls == 3 and len(graphs) == 3
    # a new gallery operand: a new capture, the older graphs dropped
    t2 = torch.ones(4, 2)
    out3 = graphs.run(fr, t2, v1, 3, 0)
    assert cap.calls == 4 and len(graphs) == 1
    np.testing.assert_allclose(out3["y"].numpy(), out["y"].numpy())
    # the same tensors written in place need nothing: a replay reads them
    t2.fill_(2.0)
    out4 = graphs.run(fr, t2, v1, 3, 0)
    assert cap.calls == 4
    np.testing.assert_allclose(out4["y"].numpy(), out["y"].numpy() + 8)
    # an int8 pair is keyed by both its tensors
    pair = (torch.ones(4, 2, dtype=torch.int8), torch.ones(4))
    graphs.run(fr, pair, v1, 3, 0)
    graphs.run(fr, pair, v1, 3, 0)
    assert cap.calls == 5 and len(graphs) == 1
    assert [c["pool_bytes"] for c in graphs.captures] == [1024] * 5
    # every replay added the captured launches once
    assert counter.count == 3 * 8  # eight runs


def test_step_graphs_name_the_key_of_a_failed_capture():
    def broken(fn, device):
        raise RuntimeError("operation not permitted when stream is capturing")

    graphs = step_graph.StepGraphs(_TinyEngine(), capture=broken)
    with pytest.raises(RuntimeError, match=r"frames \(2, 2, 2, 3\) uint8.*k=3"):
        graphs.run(torch.zeros(2, 2, 2, 3, dtype=torch.uint8), torch.ones(4, 2),
                   torch.ones(4, dtype=torch.bool), 3, 0)


def test_launch_counters_are_listed_for_the_graphs():
    from facerecognitionpipeline_tpu_torch.ops import (
        crop_kernel,
        gallery_kernel,
        int8_gemm,
        nms_kernel,
        warp_kernel,
    )

    for c in (crop_kernel.LAUNCHES, warp_kernel.LAUNCHES, gallery_kernel.LAUNCHES,
              gallery_kernel.LAUNCHES_INT8, gallery_kernel.LAUNCHES_F32,
              nms_kernel.LAUNCHES, int8_gemm.PRODUCTS):
        assert c in cuda_build.COUNTERS
    c = cuda_build.LaunchCounter()
    c.bump()
    c.add(4)
    c.add(-2)
    assert c.count == 3


def test_the_cpu_engine_stays_eager(pair, frames, templates):
    _, _, tdet, temb = pair
    _, (tt, tv) = templates
    eng = RecognitionEngine(tdet, temb, top_k=2)
    eng.process_frames(frames[:1], tt, tv)
    assert eng._graphs is None
