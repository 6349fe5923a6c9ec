"""The compiled step of the port, on the CPU: NMS's loop (K5's plain
version and a model of its block schedule), the embed-budget rotation as a
wrapping int32, the step's freedom from host reads, K2's planar output and
the CUDA-graph bookkeeping of `pipeline/step_graph.py`.

NMS is held to the JAX package's `nms_mask` (its `while_loop`) on suppression
chains built to converge at a chosen depth, and at the `it < n` cap. K5's
schedule (triangular bit-packed rows, one block per batch element stopping
at its own convergence, 32-row words per warp) is modelled in numpy and
held to the plain loop bit for bit, as `test_torch_port_gallery_kernel.py`
holds K3/K4's decomposition. The embed-budget step is held to the JAX step
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
    nms_fixpoint_kernel,
    nms_fixpoint_plain,
    nms_launch_geometry,
    row_offset,
    row_words,
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
    rng = np.random.default_rng(3)
    conflict = torch.from_numpy(np.tril(rng.random((3, 50, 50)) < 0.05, -1))
    v = torch.from_numpy(rng.random((3, 50)) < 0.8)
    np.testing.assert_array_equal(
        nms_fixpoint_kernel(conflict, v).numpy(), nms_fixpoint_plain(conflict, v).numpy()
    )
    with pytest.raises(ValueError):
        nms_fixpoint_kernel(conflict, v[:, :49])
    with pytest.raises(ValueError):
        nms_fixpoint_kernel(conflict.to("meta"), v.to("meta"))


def _k5_model(conflict: np.ndarray, v: np.ndarray) -> np.ndarray:
    """K5's block schedule in numpy (csrc/nms_fixpoint.cu): per batch
    element, the rows packed below the diagonal into words at `row_offset`,
    masks of 32-bit words, each sweep building word g from rows 32g..32g+31
    of at most row_words(i) words, the flag compared as the kernel does,
    and the element stopping at its own convergence or at it >= n."""
    b, n = v.shape
    w = row_words(n)
    out = np.zeros((b, n), bool)

    def pack(bits):
        padded = np.zeros(32 * w, bool)
        padded[:len(bits)] = bits
        return (padded.reshape(w, 32).astype(np.uint64) << np.arange(32, dtype=np.uint64)
                ).sum(axis=1).astype(np.uint64)

    for e in range(b):
        rows = np.zeros(row_offset(n), np.uint64)
        for i in range(n):
            if row_words(i):
                rows[row_offset(i):row_offset(i) + row_words(i)] = pack(conflict[e, i, :i])[:row_words(i)]
        vbits = pack(v[e])

        def sweep(src):
            dst = np.zeros(w, np.uint64)
            for g in range(w):
                sup = 0
                for r in range(32):
                    i = 32 * g + r
                    if i < n:
                        off, nw = row_offset(i), row_words(i)
                        if np.any(rows[off:off + nw] & src[:nw]):
                            sup |= 1 << r
                dst[g] = vbits[g] & np.uint64(~sup & 0xFFFFFFFF)
            return dst

        keep = sweep(vbits)
        prev = vbits
        for _ in range(6):
            keep, prev = sweep(keep), keep
        changed = bool(np.any(keep != prev))
        it = 7
        while it < n and changed:
            mid = sweep(keep)
            new = sweep(mid)
            changed = bool(np.any(new != keep))
            keep, prev = new, keep
            it += 2
        bits = ((keep[:, None] >> np.arange(32, dtype=np.uint64)) & np.uint64(1)).astype(bool)
        out[e] = bits.reshape(-1)[:n]
    return out


@pytest.mark.parametrize("b,n,density", [(4, 96, 0.05), (3, 256, 0.01), (2, 70, 0.3),
                                         (5, 33, 0.1), (2, 1, 0.0)])
def test_k5_block_schedule_model_equals_the_plain_loop(b, n, density):
    rng = np.random.default_rng(b * 1000 + n)
    conflict = np.tril(rng.random((b, n, n)) < density, -1)
    v = rng.random((b, n)) < 0.9
    v[0] = False  # an all-invalid element
    want = nms_fixpoint_plain(torch.from_numpy(conflict), torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(_k5_model(conflict, v), want)


def test_k5_block_schedule_model_on_chains_to_the_cap():
    rng = np.random.default_rng(11)
    cases = [_chain_boxes(64, c, rng) for c in ([64], [9, 8], [1], [])]
    boxes, scores, valid = (torch.from_numpy(np.stack(x)) for x in zip(*cases))
    masked = torch.where(valid, scores, torch.full_like(scores, -1e9))
    order = torch.sort(masked, dim=-1, descending=True, stable=True).indices
    bs = torch.gather(boxes, -2, order[..., None].expand(*order.shape, 4))
    v = torch.gather(valid, -1, order)
    iou = tnms.pairwise_iou(bs)
    idx = torch.arange(64)
    conflict = (iou > 0.3) & (idx[None, :] < idx[:, None])
    want = nms_fixpoint_plain(conflict, v).numpy()
    np.testing.assert_array_equal(_k5_model(conflict.numpy(), v.numpy()), want)


def test_k5_triangular_packing_and_geometry():
    total = 0
    for i in range(3000):
        assert row_offset(i) == total
        total += row_words(i)
    # the cascade's shapes: stage 1 at 9 and 11 scales, stages 2 and 3
    for n in (1152, 1408, 256, 96):
        geo = nms_launch_geometry(16, n)
        assert geo.rows_in_smem, n
        assert geo.smem_bytes == 16 * row_words(n) + 4 * row_offset(n)
        assert geo.smem_bytes <= cuda_build.SMEM_LIMIT_BYTES - 64
    big = nms_launch_geometry(2, 4096)
    assert not big.rows_in_smem and big.smem_bytes == 16 * 128
    with pytest.raises(ValueError):
        nms_launch_geometry(0, 5)
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
    plain = tnms.nms_fixpoint_kernel

    def unwatched(*a):
        mode.paused = True
        try:
            return plain(*a)
        finally:
            mode.paused = False

    monkeypatch.setattr(tnms, "nms_fixpoint_kernel", unwatched)
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
