"""The calibration-transfer sweep of the port (`evalharness/
quantize_transfer.py`, `examples/torch_quantize_calib_transfer.py`)
against the JAX package's example (`examples/quantize_calib_transfer.py`,
loaded from its file), on the CPU.

* `render_corpus` and `apply_shift`: bit-equal, both modules shrunk to 4
  identities;
* one row per shift kind (brightness 30, contrast 0.7, noise 20) at 4
  identities x 2 probes, with one seeded ir_micro tree in both packages'
  `FaceEmbedder(variables=)`: each cosine of the row within COS_TOL of the
  JAX package's, and every rank-1 decision equal where the probe's top-1
  margin over the second template is at least the int8 band (5e-3) in both
  packages; the rank-1 figures differ by at most the share inside it;
* the port's counterpart of `tests/test_quantize_transfer.py`'s two
  bounds (contrast 0.7: mean cosine >= 0.995, min >= 0.97; clean inputs:
  mean >= 0.995), on the same probes, with the port's int8 embedder;
* the sweep's own bound check and the script's flags (the JAX script's
  plus `--device`).
"""

import argparse
import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import torch

from facerecognitionpipeline_tpu.models.irse import build_backbone as jax_backbone
from facerecognitionpipeline_tpu.models.quantize import (
    default_calibration_faces as jax_calibration_faces,
)
from facerecognitionpipeline_tpu.pipeline.embedder import FaceEmbedder as JaxEmbedder
from facerecognitionpipeline_tpu_torch.evalharness import quantize_transfer as QT
from facerecognitionpipeline_tpu_torch.models.quantize import default_calibration_faces
from facerecognitionpipeline_tpu_torch.pipeline.embedder import FaceEmbedder

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BAND = 5e-3  # the int8 quantization band (ROADMAP.md §3)
# a row's cosines between the packages: the int8 codes of a few activations
# may fall on the other side of a rounding boundary, and the row rounds to 5
# places (measured up to 8.7e-6 on these rows, the rounding included)
COS_TOL = 5e-5
ROWS = [("brightness", 30), ("contrast", 0.7), ("noise", 20)]


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


JAX_SWEEP = _load("quantize_calib_transfer")


@pytest.fixture
def shrunk(monkeypatch):
    for module in (JAX_SWEEP, QT):
        monkeypatch.setattr(module, "N_IDENTITIES", 4)


@pytest.fixture(scope="module")
def jax_variables():
    """Seeded ir_micro variables of the JAX package's backbone."""
    variables = jax.jit(jax_backbone("ir_micro").init)(
        jax.random.PRNGKey(4), np.zeros((1, 112, 112, 3), np.float32))
    return jax.tree_util.tree_map(np.asarray, dict(variables))


def test_render_corpus_bit_equal(shrunk):
    for seed0, per_id in ((77_000, 2), (88_000, 3)):
        got, want = QT.render_corpus(seed0, per_id), JAX_SWEEP.render_corpus(seed0, per_id)
        assert got.shape == want.shape == (4, per_id, 112, 112, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind,levels", list(QT.SWEEPS.items()))
def test_apply_shift_bit_equal(kind, levels):
    images = np.random.default_rng(2).integers(0, 256, (3, 16, 16, 3)).astype(np.uint8)
    for lv in levels:
        for seed in (7, 8):
            got = QT.apply_shift(images, kind, lv, seed=seed)
            want = JAX_SWEEP.apply_shift(images, kind, lv, seed=seed)
            assert got.dtype == np.uint8
            np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        QT.apply_shift(images, "fog", 1.0)


def _jax_row(fp32, int8_synth, make_oracle, calib, probes, kind, level):
    """The example's loop body (`quantize_calib_transfer.py:124-157`) with
    the JAX package."""
    shifted = JAX_SWEEP.apply_shift(probes, kind, level, seed=7)
    ref = fp32.extract_embeddings_batch(shifted)
    q = int8_synth.extract_embeddings_batch(shifted)
    o = make_oracle(JAX_SWEEP.apply_shift(calib, kind, level, seed=8)) \
        .extract_embeddings_batch(shifted)
    return ref, q, o


def _in_band(embs, templates) -> np.ndarray:
    s = np.sort(embs @ templates.T, axis=1)[:, ::-1]
    return s[:, 0] - s[:, 1] < BAND


@pytest.fixture(scope="module")
def rows(jax_variables):
    """The three rows through both packages at 4 identities x 2 probes
    (enrolment 2 a identity)."""
    mp = pytest.MonkeyPatch()
    for module in (JAX_SWEEP, QT):
        mp.setattr(module, "N_IDENTITIES", 4)
    try:
        enroll = QT.render_corpus(77_000, 2).reshape(-1, 112, 112, 3)
        probes = QT.render_corpus(88_000, 2).reshape(-1, 112, 112, 3)
    finally:
        mp.undo()
    labels = np.repeat(np.arange(4), 2)
    calib = jax_calibration_faces()
    np.testing.assert_array_equal(calib, default_calibration_faces())
    out = {}
    for pkg, make in (("port", lambda **kw: FaceEmbedder("ir_micro", variables=jax_variables,
                                                         device="cpu", **kw)),
                      ("jax", lambda **kw: JaxEmbedder("ir_micro", variables=jax_variables,
                                                       **kw))):
        fp32, int8 = make(), make(quantize="int8")
        e = fp32.extract_embeddings_batch(enroll).reshape(4, 2, -1).mean(axis=1)
        templates = e / np.linalg.norm(e, axis=1, keepdims=True)

        def oracle(calib, make=make):
            return make(quantize="int8", calib_faces=calib)

        for kind, lv in ROWS:
            if pkg == "port":
                row, emb = QT.transfer_row(fp32, int8, oracle, calib, probes, labels,
                                           templates, kind, lv)
                out[pkg, kind] = (row, emb, templates)
            else:
                out[pkg, kind] = (None, _jax_row(fp32, int8, oracle, calib, probes, kind, lv),
                                  templates)
    return labels, out


@pytest.mark.parametrize("kind,level", ROWS)
def test_row_matches_jax(rows, kind, level):
    labels, out = rows
    row, (ref, q, o), templates = out["port", kind]
    _, (jref, jq, jo), jtemplates = out["jax", kind]
    np.testing.assert_allclose(templates, jtemplates, rtol=0, atol=1e-5)
    np.testing.assert_allclose(ref, jref, rtol=0, atol=1e-5)
    for got, want in ((q, jq), (o, jo)):  # int8: a code may flip
        np.testing.assert_array_less(0.999, (got * want).sum(1))
    c_synth, c_oracle = (jref * jq).sum(1), (jref * jo).sum(1)
    assert row["shift"] == kind and row["level"] == float(level)
    assert abs(row["cosine_synthcal_mean"] - c_synth.mean()) <= COS_TOL
    assert abs(row["cosine_synthcal_min"] - c_synth.min()) <= COS_TOL
    assert abs(row["cosine_oracle_mean"] - c_oracle.mean()) <= COS_TOL
    assert abs(row["transfer_gap"] - (c_oracle.mean() - c_synth.mean())) <= 2 * COS_TOL
    for key, got, want in (("rank1_fp32", ref, jref), ("rank1_int8", q, jq)):
        band = _in_band(got, templates) | _in_band(want, jtemplates)
        right_p = np.argmax(got @ templates.T, axis=1) == labels
        right_j = np.argmax(want @ jtemplates.T, axis=1) == labels
        assert (right_p == right_j)[~band].all(), key
        assert abs(row[key] - right_j.mean()) <= band.mean() + 1e-12, key


def _render_probes(n_ids=8, per_id=4):
    """tests/test_quantize_transfer.py's probes, rendered by the port."""
    from facerecognitionpipeline_tpu_torch.train.detector_train import (
        make_identity,
        render_identity_crop,
    )

    out, labels = [], []
    for i in range(n_ids):
        ident = make_identity(1000 + i)
        rng = np.random.default_rng(88_000 + i)
        for _ in range(per_id):
            out.append(render_identity_crop(ident, rng, size=112))
            labels.append(i)
    return np.stack(out), np.array(labels)


@pytest.fixture(scope="module")
def port_embedders():
    """As the JAX test: the demo's trained weights where the port has them,
    else a random init (the drift bound is the quantizer's; rank-1 then
    means nothing and is skipped)."""
    from facerecognitionpipeline_tpu_torch.evalharness.synthetic_demo import EMBEDDER_WEIGHTS

    trained = os.path.exists(EMBEDDER_WEIGHTS)
    kw = dict(model_path=EMBEDDER_WEIGHTS) if trained else dict(random_ok=True)
    return (FaceEmbedder("ir_micro", device="cpu", **kw),
            FaceEmbedder("ir_micro", device="cpu", quantize="int8", **kw), trained)


def test_drift_bounded_under_worst_measured_shift(port_embedders):
    fp32, int8, trained = port_embedders
    probes, labels = _render_probes()
    shifted = QT.apply_shift(probes, "contrast", 0.7)
    ref = fp32.extract_embeddings_batch(shifted)
    q = int8.extract_embeddings_batch(shifted)
    cos = np.sum(ref * q, axis=1)
    assert cos.mean() >= QT.BOUNDS["mean"], cos.mean()
    assert cos.min() >= QT.BOUNDS["min"], cos.min()
    if trained:
        enroll, elabels = _render_probes(per_id=2)
        temps = fp32.extract_embeddings_batch(enroll)
        templates = np.stack([temps[elabels == i].mean(axis=0) for i in range(8)])
        templates /= np.linalg.norm(templates, axis=1, keepdims=True)
        r_fp = (np.argmax(ref @ templates.T, axis=1) == labels).mean()
        r_q = (np.argmax(q @ templates.T, axis=1) == labels).mean()
        assert abs(r_fp - r_q) <= QT.BOUNDS["rank1_gap"], (r_fp, r_q)


def test_clean_inputs_not_worse_than_shifted_bound(port_embedders):
    fp32, int8, _ = port_embedders
    probes, _ = _render_probes(n_ids=4, per_id=3)
    cos = np.sum(fp32.extract_embeddings_batch(probes) * int8.extract_embeddings_batch(probes),
                 axis=1)
    assert cos.mean() >= QT.BOUNDS["mean"], cos.mean()


def _summary(**row):
    base = {"shift": "contrast", "level": 0.7, "cosine_synthcal_mean": 0.999,
            "cosine_synthcal_min": 0.99, "cosine_oracle_mean": 0.9995, "transfer_gap": 5e-4,
            "rank1_fp32": 0.9, "rank1_int8": 0.9}
    clean = {**base, "level": 1.0}
    return {"rows": [{**base, **row}, clean]}


@pytest.mark.parametrize("row,failures", [
    ({}, 0),
    ({"cosine_synthcal_mean": 0.99}, 1),
    ({"cosine_synthcal_min": 0.96}, 1),
    ({"rank1_int8": 0.75}, 1),
    ({"level": 0.4}, 1),  # no contrast 0.7 row
])
def test_check_bounds(row, failures):
    assert len(QT.check_bounds(_summary(**row))) == failures


def test_script_takes_the_jax_scripts_flags_and_device(monkeypatch):
    class Parsed(Exception):
        pass

    def capture(self, *args, **kw):
        raise Parsed(self)

    port = _load("torch_quantize_calib_transfer")
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(Parsed) as caught:
        JAX_SWEEP.main()
    monkeypatch.undo()
    want = {a.dest: a.default for a in caught.value.args[0]._actions if a.dest != "help"}
    got = {a.dest: a.default for a in port.build_parser()._actions if a.dest != "help"}
    assert got.pop("device") == "cuda"
    assert got.keys() == want.keys() and got["arch"] == want["arch"] == "ir_micro"
    assert got["weights"] == "pretrained/ir_micro_synthetic_torch.npz"
    assert got["output_dir"] == "reports/quantize_transfer_torch"


def test_the_jax_report_has_the_summary_keys_the_port_returns():
    with open(os.path.join(REPO, "reports", "quantize_transfer", "report.json")) as f:
        jax_rep = json.load(f)
    assert list(jax_rep) == ["arch", "weights", "n_probes", "rows", "worst_shift",
                             "worst_cosine_synthcal_mean", "max_transfer_gap",
                             "rank1_decisions_changed"]
    assert [(r["shift"], r["level"]) for r in jax_rep["rows"]] == [
        (k, float(lv)) for k, levels in QT.SWEEPS.items() for lv in levels]


def test_committed_report():
    """reports/quantize_transfer_torch/report.json (`chip_smoke.py
    --protocols-only transfer` on the card): the JAX report's keys and rows,
    every row within tests/test_quantize_transfer.py's bounds."""
    reports = os.path.join(REPO, "reports")
    with open(os.path.join(reports, "quantize_transfer_torch", "report.json")) as f:
        rep = json.load(f)
    with open(os.path.join(reports, "quantize_transfer", "report.json")) as f:
        jax_rep = json.load(f)
    assert list(rep) == list(jax_rep) and rep["n_probes"] == jax_rep["n_probes"] == 96
    assert [(r["shift"], r["level"]) for r in rep["rows"]] == \
        [(r["shift"], r["level"]) for r in jax_rep["rows"]]
    assert all(list(r) == list(j) for r, j in zip(rep["rows"], jax_rep["rows"]))
    assert QT.check_bounds(rep) == []
    worst = min(rep["rows"], key=lambda r: r["cosine_synthcal_mean"])
    assert rep["worst_cosine_synthcal_mean"] == worst["cosine_synthcal_mean"]
