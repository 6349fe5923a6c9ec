"""The port's GalleryManager against the JAX package's, on the CPU.

The same sequence of mutations and searches goes through both managers: the
host side (aggregation, quality filter, outlier removal, files) is the same
numpy code and must give the same templates (atol 1e-6), ids and statistics;
search scores come from each package's device gallery (float32 below the
streaming threshold: within 1e-5). Files written by one manager load in the
other.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from facerecognitionpipeline_tpu.gallery.manager import GalleryManager as JaxManager
from facerecognitionpipeline_tpu_torch.gallery.manager import GalleryManager, StudentRecord
from facerecognitionpipeline_tpu_torch.parallel.mesh import Sharded, make_mesh

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _norm(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _identity_embeddings(rng, n_ids, n_each, noise=0.05):
    centers = _norm(rng.normal(size=(n_ids, 512)).astype(np.float32))
    return centers, [
        _norm(c + noise * rng.normal(size=(n_each, 512)).astype(np.float32))
        for c in centers
    ]


def _pair(tmp_path, **kw):
    j = JaxManager(str(tmp_path / "jax" / "students.pkl"), verbose=False, **kw)
    t = GalleryManager(str(tmp_path / "torch" / "students.pkl"), verbose=False, device="cpu", **kw)
    return j, t


def _assert_same_store(j, t):
    assert list(j.students) == list(t.students)
    for sid, a in j.students.items():
        b = t.students[sid]
        assert (a.name, a.num_samples, a.metadata) == (b.name, b.num_samples, b.metadata)
        np.testing.assert_allclose(b.embeddings, a.embeddings, atol=1e-6)
        np.testing.assert_allclose(b.template_embedding, a.template_embedding, atol=1e-6)


def _assert_same_results(a, b):
    assert [(sid, name) for sid, name, _ in a] == [(sid, name) for sid, name, _ in b]
    np.testing.assert_allclose([s for *_, s in a], [s for *_, s in b], atol=1e-5)


@pytest.mark.parametrize("method", ["mean", "median", "weighted_mean"])
def test_same_sequence_gives_same_gallery(tmp_path, method):
    rng = np.random.default_rng(0)
    centers, embs = _identity_embeddings(rng, 6, 5)
    j, t = _pair(tmp_path, aggregation_method=method)
    for m in (j, t):
        for i, e in enumerate(embs):
            assert m.add_student(f"s{i}", f"Student {i}", e, metadata={"row": i})
        assert not m.add_student("s0", "again", embs[0])  # no overwrite
        assert m.add_student("s1", "Student 1b", embs[1][:1], overwrite=True)  # one sample
    _assert_same_store(j, t)

    extra = _norm(centers[2] + 0.05 * rng.normal(size=(3, 512)).astype(np.float32))
    outlier = _norm(rng.normal(size=(1, 512)).astype(np.float32))
    for m in (j, t):
        assert m.update_embeddings("s2", extra, mode="append")
        assert m.update_embeddings("s3", extra, mode="replace")
        assert m.update_embeddings("s4", np.vstack([embs[4], outlier]), mode="merge")
        assert not m.update_embeddings("nobody", extra)
        with pytest.raises(ValueError, match="mode"):
            m.update_embeddings("s2", extra, mode="prepend")
        assert m.delete_student("s5") and not m.delete_student("s5")
    _assert_same_store(j, t)
    assert t.students["s2"].num_samples == 8 and t.students["s3"].num_samples == 3

    queries = np.vstack([centers[:5], _norm(rng.normal(size=(2, 512)).astype(np.float32))])
    for q in queries:
        _assert_same_results(j.search(q, top_k=3), t.search(q, top_k=3))
    for a, b in zip(j.search_batch(queries, top_k=9), t.search_batch(queries, top_k=9)):
        assert len(b) == 5  # clipped to the gallery
        _assert_same_results(a, b)
    assert t.search(centers[0])[0][0] == "s0"

    sj, st = j.get_statistics(), t.get_statistics()
    for s in (sj, st):
        for row in s["students"]:
            row.pop("enrollment_date")
    assert sj == st and st["num_students"] == 5
    assert [t.id_at(i) for i in (0, 4, 5, -1)] == [j.id_at(i) for i in (0, 4, 5, -1)]
    jt, jv = j.device_arrays()
    tt, tv = t.device_arrays()
    assert tt.dtype == torch.float32
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-6)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_empty_manager(tmp_path):
    _, t = _pair(tmp_path)
    assert t.search(np.zeros(512, np.float32)) == []
    assert t.search_batch(np.zeros((2, 512), np.float32)) == [[], []]
    assert t.get_statistics() == {
        "num_students": 0, "total_embeddings": 0, "avg_embeddings_per_student": 0,
    }
    assert t.id_at(0) is None
    templates, valid, ids = t.device_snapshot()
    assert templates.shape == (128, 512) and not valid.any() and ids == []
    # mesh= passes through to DeviceGallery: the snapshot is the per-shard form
    sharded = GalleryManager(str(tmp_path / "m" / "g.pkl"), verbose=False,
                             mesh=make_mesh(data=2, devices=["cpu"] * 2))
    sharded.add_student("S1", "One", np.eye(2, 512, dtype=np.float32))
    templates, valid, ids = sharded.device_snapshot()
    assert isinstance(templates, Sharded) and len(templates.blocks) == 2
    assert templates.shape == (256, 512) and ids == ["S1"]
    assert valid.gather("cpu").sum() == 1


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_saved_files_load_in_the_other_package(tmp_path, writer):
    rng = np.random.default_rng(1)
    centers, embs = _identity_embeddings(rng, 4, 3)
    j, t = _pair(tmp_path)
    src, dst_cls = (j, GalleryManager) if writer == "jax" else (t, JaxManager)
    for i, e in enumerate(embs):
        src.add_student(f"s{i}", f"Student {i}", e, metadata={"k": [i, "x"]})
    src.save()
    pkl = src.gallery_path
    sidecar = json.load(open(os.path.splitext(pkl)[0] + ".json"))
    assert sidecar["num_students"] == 4 and sidecar["students"]["s2"]["metadata"] == {"k": [2, "x"]}
    assert not os.path.exists(pkl + ".tmp")

    kw = {"device": "cpu"} if writer == "jax" else {}
    dst = dst_cls(pkl, verbose=False, **kw)  # loads on construction
    _assert_same_store(src, dst)
    assert all(type(r).__module__ == dst_cls.__module__ for r in dst.students.values())
    _assert_same_results(src.search(centers[1], 2), dst.search(centers[1], 2))

    # the full-record JSON backup crosses over too
    backup = src.export_for_backup(str(tmp_path / "backup"), "term1")
    other = dst_cls(str(tmp_path / "other" / "g.pkl"), verbose=False, **kw)
    other.load_from_backup_json(backup)
    _assert_same_store(src, other)
    with pytest.raises(ValueError, match="not found"):
        other.load(str(tmp_path / "missing.pkl"), strict=True)


def test_port_loads_a_jax_pickle_without_importing_jax(tmp_path):
    """The renaming unpickler resolves the JAX package's StudentRecord to
    the port's class, so loading imports neither JAX nor the JAX package."""
    rng = np.random.default_rng(2)
    _, embs = _identity_embeddings(rng, 3, 2)
    j = JaxManager(str(tmp_path / "students.pkl"), verbose=False)
    for i, e in enumerate(embs):
        j.add_student(f"s{i}", f"Student {i}", e)
    j.save()
    code = (
        "import sys\n"
        "from facerecognitionpipeline_tpu_torch.gallery.manager import GalleryManager\n"
        f"m = GalleryManager({str(tmp_path / 'students.pkl')!r}, verbose=False, device='cpu')\n"
        "assert sorted(m.students) == ['s0', 's1', 's2'], m.students\n"
        "assert m.search(m.students['s1'].template_embedding, 1)[0][0] == 's1'\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "       or k == 'facerecognitionpipeline_tpu' or k.startswith('facerecognitionpipeline_tpu.')]\n"
        "assert not bad, bad\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
        cwd=REPO, env={**os.environ, "PYTHONPATH": REPO},
    )
    assert r.returncode == 0, r.stderr


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_device_snapshot_is_one_generation_and_compact_at_scale(tmp_path, quantize):
    rng = np.random.default_rng(3)
    t = _norm(rng.normal(size=(70, 512)).astype(np.float32))
    m = GalleryManager(
        str(tmp_path / "g.pkl"), verbose=False, quantize=quantize, device="cpu"
    )
    m._device.streaming_threshold = 64
    m._device.STREAM_CHUNK = 128
    for i in range(60):
        m.add_student(f"s{i}", f"n{i}", t[i])
    templates, valid, ids = m.device_snapshot()
    assert templates.dtype == torch.float32 and templates.shape == (128, 512)
    assert ids == [f"s{i}" for i in range(60)] and int(valid.sum()) == 60
    for i in range(60, 70):
        m.add_student(f"s{i}", f"n{i}", t[i])
    old_ids = ids
    templates, valid, ids = m.device_snapshot()
    assert len(old_ids) == 60 and len(ids) == 70  # the earlier list is its own copy
    if quantize == "int8":
        codes, scales = templates
        assert codes.dtype == torch.int8 and codes.shape == (128, 512) and scales.shape == (128,)
    else:
        assert templates.dtype == torch.bfloat16 and templates.shape == (128, 512)
    assert int(valid.sum()) == 70
    snap_ids, master, snap_valid, compact = m._device.snapshot()
    assert compact is templates and snap_valid is valid and snap_ids == ids
    assert master.dtype == torch.float32
    hit = m.search(t[65], top_k=2)  # through the streaming arm
    assert hit[0][0] == "s65" and hit[0][2] == pytest.approx(1.0, abs=1e-2)
    assert isinstance(m.get_student("s65"), StudentRecord)


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_search_batch_past_64_on_the_streaming_arm_matches_jax(tmp_path, quantize):
    """GalleryManager.search_batch at top_k 65 through the streaming arm (a
    small streaming_threshold; bf16 or int8 compact rows; the JAX class runs
    its Pallas kernel in interpret mode, the port the plain version): the
    same ids in the same order, scores within 1e-5."""
    rng = np.random.default_rng(8)
    t = _norm(rng.normal(size=(80, 512)).astype(np.float32))
    j, m = _pair(tmp_path, quantize=quantize)
    for g in (j, m):
        g._device.streaming_threshold = 64
        g._device.STREAM_CHUNK = 128
        for i in range(80):
            g.add_student(f"s{i}", f"n{i}", t[i])
    queries = _norm(t[[3, 41, 77]] + 0.2 * rng.normal(size=(3, 512)).astype(np.float32))
    got, want = m.search_batch(queries, top_k=65), j.search_batch(queries, top_k=65)
    assert m._device.snapshot()[3] is not None  # the compact copy: streaming
    for a, b in zip(want, got):
        assert len(b) == 65
        _assert_same_results(a, b)
    assert [r[0][0] for r in got] == ["s3", "s41", "s77"]
