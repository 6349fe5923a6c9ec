"""The port's evaluation harness (`evalharness/`, `utils/xlsx.py`,
`cli/evaluate_models.py`) against the JAX package's, on the CPU.

Inputs are seeded numpy embeddings (clusters around random unit centres),
fed to both packages. Tolerances:
- `identity_scores_batch` (all three aggregations): within 1e-5 (two
  frameworks' float32 einsums, summed in other orders);
- host functions fed equal inputs (rank metrics, d', bootstrap CI, ROC/AP,
  comparisons, hardening rows, the xlsx writer): equal;
- whole evaluations: counts and rank metrics equal, every float within 1e-5.
  The corpora are seeded so that no decision lies within 1e-5 of a threshold
  or of a rival (`_no_near_decisions` checks it), where a last-bit difference
  in a score could flip a rank or a count.
The port's ROC-AUC and AP are numpy (the card has no scikit-learn); they are
held to scikit-learn within 1e-12.
"""

import json
import os
import pickle
import zipfile

import numpy as np
import pandas as pd
import pytest
import torch

from facerecognitionpipeline_tpu.evalharness import comparison as jcmp
from facerecognitionpipeline_tpu.evalharness import detection as jdet
from facerecognitionpipeline_tpu.evalharness import hardening as jhard
from facerecognitionpipeline_tpu.evalharness import identification as jid
from facerecognitionpipeline_tpu.evalharness import metrics as jm
from facerecognitionpipeline_tpu.evalharness import pipeline as jpipe
from facerecognitionpipeline_tpu.evalharness import verification as jver
from facerecognitionpipeline_tpu.utils import xlsx as jxlsx
from facerecognitionpipeline_tpu_torch.evalharness import comparison as tcmp
from facerecognitionpipeline_tpu_torch.evalharness import detection as tdet
from facerecognitionpipeline_tpu_torch.evalharness import hardening as thard
from facerecognitionpipeline_tpu_torch.evalharness import identification as tid
from facerecognitionpipeline_tpu_torch.evalharness import metrics as tm
from facerecognitionpipeline_tpu_torch.evalharness import pipeline as tpipe
from facerecognitionpipeline_tpu_torch.evalharness import verification as tver
from facerecognitionpipeline_tpu_torch.utils import xlsx as txlsx

TOL = 1e-5
THRESHOLDS = jpipe.DEFAULT_THRESHOLDS


def _norm(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def assert_same(got, want, path="", tol=TOL, rel=0.0):
    """Equal structure; ints, bools, strings and None equal; floats within
    `tol` + `rel` x |want|; DataFrames by their records."""
    if isinstance(want, pd.DataFrame):
        assert isinstance(got, pd.DataFrame), path
        assert list(got.columns) == list(want.columns), path
        assert_same(got.to_dict("records"), want.to_dict("records"), path, tol, rel)
    elif isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), (path, list(got), list(want))
        for k in want:
            assert_same(got[k], want[k], f"{path}/{k}", tol, rel)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]", tol, rel)
    elif isinstance(want, np.ndarray):
        g = np.asarray(got)
        assert g.shape == want.shape, path
        if want.dtype.kind in "fc":
            np.testing.assert_allclose(g, want, atol=tol, rtol=rel, err_msg=path)
        else:
            np.testing.assert_array_equal(g, want, err_msg=path)
    elif isinstance(want, (bool, np.bool_, str)) or want is None:
        assert got == want, (path, got, want)
    elif isinstance(want, (int, np.integer)) and not isinstance(got, (float, np.floating)):
        assert got == want, (path, got, want)
    else:
        assert abs(float(got) - float(want)) <= tol + rel * abs(float(want)), (path, got, want)


def make_corpus(seed, n_ids=6, per_id=4, n_probe=3, unenrolled=2, spread=0.35, shift=0.0):
    """(gallery, probes wrapped in 'all', negatives, segmented probes)."""
    rng = np.random.default_rng(seed)
    centers = _norm(rng.normal(size=(n_ids + unenrolled, 512)) + shift)

    def cluster(i, n):
        return _norm(centers[i] + spread * rng.normal(size=(n, 512)) / np.sqrt(512) * 8)

    gallery = {f"id_{i}": {"embeddings": cluster(i, 1 + (i + per_id) % per_id)}
               for i in range(n_ids)}
    probes = {f"id_{i}": {"embeddings": cluster(i, n_probe)} for i in range(n_ids + unenrolled)}
    negatives = {
        "real": {"embeddings": _norm(rng.normal(size=(9, 512))), "filenames": ["r"] * 9},
        "lfw": {"embeddings": _norm(rng.normal(size=(5, 512))), "filenames": ["l"] * 5},
    }
    segmented = {"pose_easy": {k: probes[k] for k in list(probes)[:4]},
                 "face_small": {k: probes[k] for k in list(probes)[3:]}}
    return gallery, {"all": probes}, negatives, segmented


def _no_near_decisions(gallery, probes, aggregation, k=3):
    """Precondition of the whole-evaluation comparisons: no best score within
    TOL of a threshold or of the runner-up, no true score within TOL of a
    rival."""
    names, packed, mask = jm.pack_gallery(gallery)
    data = probes.get("all", probes)
    rows = np.concatenate([np.atleast_2d(d["embeddings"]) for d in data.values()])
    truth = np.concatenate([[names.index(n) if n in names else -1] * len(
        np.atleast_2d(d["embeddings"])) for n, d in data.items()])
    s = np.asarray(jm.identity_scores_batch(rows, packed, mask, aggregation, k), np.float64)
    top = np.sort(s, axis=1)[:, ::-1]
    assert np.abs(top[:, :1] - np.asarray(THRESHOLDS)[None]).min() > TOL
    if s.shape[1] > 1:
        assert (top[:, 0] - top[:, 1]).min() > TOL
        t = s[np.arange(len(truth)), np.clip(truth, 0, None)]
        gap = np.abs(s - t[:, None])
        gap[np.arange(len(truth)), np.clip(truth, 0, None)] = np.inf
        assert gap[truth >= 0].min(initial=np.inf) > TOL


# ------------------------------------------------------------ device scorer

def _scorer_case(name, rng):
    if name == "ragged":
        sizes = [1, 3, 6, 2, 5]
    elif name == "one_each":
        sizes = [1] * 4
    elif name == "duplicates":  # equal rows: topk keeps ties as lax.top_k
        sizes = [4, 4, 2]
    else:  # "k_above_m": every identity has fewer embeddings than k = 8
        sizes = [2, 3]
    gallery = {f"g{i}": {"embeddings": _norm(rng.normal(size=(n, 512)))}
               for i, n in enumerate(sizes)}
    if name == "duplicates":
        for d in gallery.values():
            d["embeddings"][1:] = d["embeddings"][0]
    probes = rng.normal(size=(7, 512)).astype(np.float32) * 3.0  # not unit: normalised inside
    return gallery, probes, 8 if name == "k_above_m" else 3


@pytest.mark.parametrize("case", ["ragged", "one_each", "duplicates", "k_above_m"])
@pytest.mark.parametrize("aggregation", ["max", "mean", "topk", "unknown"])
def test_identity_scores_batch_like_jax(case, aggregation):
    gallery, probes, k = _scorer_case(case, np.random.default_rng(len(case)))
    names, packed, mask = jm.pack_gallery(gallery)
    tnames, tpacked, tmask = tm.pack_gallery(gallery, device="cpu")
    assert tnames == names
    np.testing.assert_array_equal(tpacked.numpy(), np.asarray(packed))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(mask))
    want = np.asarray(jm.identity_scores_batch(probes, packed, mask, aggregation, k))
    got = tm.identity_scores_batch(torch.from_numpy(probes), tpacked, tmask, aggregation, k)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    ref = tm.identity_scores_batch(torch.from_numpy(probes).double(), tpacked, tmask,
                                   aggregation, k, dtype=torch.float64)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=TOL, rtol=0)


def test_pack_gallery_refuses_an_empty_gallery():
    with pytest.raises(ValueError, match="empty"):
        tm.pack_gallery({}, device="cpu")


def test_score_probes_chunks_like_one_call(monkeypatch):
    gallery, probes, _ = _scorer_case("ragged", np.random.default_rng(3))
    _, packed, mask = tm.pack_gallery(gallery, device="cpu")
    whole = tid._score_probes(probes, packed, mask, "topk", 3)
    monkeypatch.setattr(tid, "_CHUNK", 2)
    chunked = tid._score_probes(probes, packed, mask, "topk", 3)
    assert chunked.shape == whole.shape == (7, 5) and chunked.dtype == np.float32
    # a product over 2 rows may sum in another order than one over 7
    np.testing.assert_allclose(chunked, whole, atol=TOL, rtol=0)


# ------------------------------------------------------- host statistics


@pytest.mark.parametrize("seed", range(4))
def test_rank_metrics_equal(seed):
    rng = np.random.default_rng(seed)
    scores = np.round(rng.normal(size=(40, 12)), 1).astype(np.float32)  # many ties
    truth = rng.integers(-1, 12, 40)
    want = jm.compute_rank_metrics_batch(scores, truth)
    got = tm.compute_rank_metrics_batch(scores, truth)
    assert list(got) == list(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("n_g,n_i", [(0, 5), (5, 0), (30, 200), (1, 1)])
def test_dprime_equal(n_g, n_i):
    rng = np.random.default_rng(n_g + n_i)
    g, i = rng.normal(0.7, 0.1, n_g), rng.normal(0.1, 0.2, n_i)
    assert tm.compute_dprime(g, i) == jm.compute_dprime(g, i)
    assert tm.compute_dprime([0.5, 0.5], [0.5]) == jm.compute_dprime([0.5, 0.5], [0.5]) == 0.0


@pytest.mark.parametrize("size,n_bootstrap,seed", [
    (0, 1000, 0), (1, 1000, 0), (57, 1000, 3), (40_000, 1000, 1), (17, 33, 9),
])
def test_bootstrap_confidence_interval_equal(size, n_bootstrap, seed):
    """The same draws in the same chunks (40 000 values: 400 rows a chunk)."""
    data = np.random.default_rng(size).normal(size=size).astype(np.float32)
    assert tm.bootstrap_confidence_interval(data, n_bootstrap, seed=seed) == \
        jm.bootstrap_confidence_interval(data, n_bootstrap, seed=seed)


@pytest.mark.parametrize("case", ["continuous", "ties", "float64", "one_positive",
                                  "one_class", "all_tied"])
def test_roc_auc_and_ap_match_sklearn(case):
    from sklearn.metrics import auc, average_precision_score, roc_curve

    rng = np.random.default_rng(len(case))
    n = 300
    y = rng.integers(0, 2, n)
    s = rng.normal(size=n).astype(np.float32) + 0.8 * y
    if case == "ties":
        s = np.round(s, 1)
    if case == "float64":
        s = s.astype(np.float64)
    if case == "one_positive":
        y = np.zeros(n, int)
        y[7] = 1
    if case == "one_class":
        y = np.ones(n, int)
    if case == "all_tied":
        s = np.full(n, 0.5, np.float32)
    a, ap, fpr, tpr = tm.roc_auc_and_ap(y, s)
    wa, wap, wfpr, wtpr = jm.roc_auc_and_ap(y, s)  # scikit-learn's
    np.testing.assert_array_equal(fpr, wfpr)
    np.testing.assert_array_equal(tpr, wtpr)
    if case == "one_class":
        assert a is ap is wa is wap is None
        return
    f, t, _ = roc_curve(y, s)
    assert abs(a - auc(f, t)) <= 1e-12 and abs(a - wa) <= 1e-12
    assert abs(ap - average_precision_score(y, s)) <= 1e-12 and abs(ap - wap) <= 1e-12


@pytest.mark.parametrize("value", [None, float("nan"), 0.5, 1, np.float32(0.25), "x"])
def test_fmt_metric_equal(value):
    if value == "x":
        with pytest.raises(ValueError):
            jm.fmt_metric(value)
        with pytest.raises(ValueError):
            tm.fmt_metric(value)
        return
    assert tm.fmt_metric(value) == jm.fmt_metric(value)
    assert tm.fmt_metric(value, ".1f") == jm.fmt_metric(value, ".1f")


# ------------------------------------------------------- whole evaluations


@pytest.fixture(scope="module")
def corpus():
    return make_corpus(11)


@pytest.mark.parametrize("aggregation", ["max", "mean", "topk"])
def test_identification_like_jax(corpus, aggregation):
    gallery, probes, _, _ = corpus
    _no_near_decisions(gallery, probes, aggregation)
    want = jid.evaluate_probes_comprehensive(gallery, probes, THRESHOLDS, aggregation)
    got = tid.evaluate_probes_comprehensive(gallery, probes, THRESHOLDS, aggregation,
                                            device="cpu")
    assert 0.0 < want["threshold_results"]["rank1_accuracy"].iloc[0] < 1.0
    assert_same(got, want)


@pytest.mark.parametrize("aggregation", ["max", "mean", "topk"])
def test_impostors_like_jax(corpus, aggregation):
    gallery, _, negatives, _ = corpus
    _no_near_decisions(gallery, negatives, aggregation)
    want = jid.evaluate_impostors_comprehensive(gallery, negatives, THRESHOLDS, aggregation)
    got = tid.evaluate_impostors_comprehensive(gallery, negatives, THRESHOLDS, aggregation,
                                               device="cpu")
    assert_same(got, want)


@pytest.mark.parametrize("aggregation", ["max", "mean", "topk"])
def test_verification_like_jax(corpus, aggregation):
    gallery, probes, negatives, _ = corpus
    _no_near_decisions(gallery, probes, aggregation)
    _no_near_decisions(gallery, negatives, aggregation)
    want = jver.evaluate_verification_comprehensive(gallery, probes, negatives, THRESHOLDS,
                                                    aggregation)
    got = tver.evaluate_verification_comprehensive(gallery, probes, negatives, THRESHOLDS,
                                                   aggregation, device="cpu")
    assert_same(got, want)


def test_segmented_like_jax(corpus):
    gallery, _, _, segmented = corpus
    for seg in segmented.values():
        _no_near_decisions(gallery, seg, "mean")
    want = jid.evaluate_segmented_comprehensive(gallery, segmented, THRESHOLDS)
    got = tid.evaluate_segmented_comprehensive(gallery, segmented, THRESHOLDS, device="cpu")
    assert_same(got, want)


@pytest.mark.parametrize("call", ["probes", "impostors", "verification"])
def test_empty_inputs_raise_like_jax(corpus, call):
    gallery, probes, negatives, _ = corpus
    empty = {"x": {"embeddings": np.zeros((0, 512), np.float32)}}
    fns = {
        "probes": (lambda m, **kw: m.evaluate_probes_comprehensive(gallery, {}, THRESHOLDS, **kw)),
        "impostors": (lambda m, **kw: m.evaluate_impostors_comprehensive(
            gallery, empty, THRESHOLDS, **kw)),
        "verification": (lambda m, **kw: m.evaluate_verification_comprehensive(
            gallery, probes, empty, THRESHOLDS, **kw)),
    }
    jmod = jver if call == "verification" else jid
    tmod = tver if call == "verification" else tid
    with pytest.raises(ValueError) as want:
        fns[call](jmod)
    with pytest.raises(ValueError) as got:
        fns[call](tmod, device="cpu")
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------ comparisons


@pytest.fixture(scope="module")
def model_results():
    """Two models' results from the JAX package, the input both packages'
    comparison functions are fed."""
    out = {}
    for name, seed, shift in (("adaface_ir_micro", 21, 0.0), ("arcface_ir_micro", 22, 0.05)):
        gallery, probes, negatives, segmented = make_corpus(seed, shift=shift)
        corpus = {"galleries": {"oneshot_base": gallery,
                                "fewshot_augmented": {k: {"embeddings": np.concatenate(
                                    [v["embeddings"]] * 2)} for k, v in gallery.items()}},
                  "probe_positive": probes, "probe_negative": negatives,
                  "probe_positive_segmented": segmented}
        out[name] = jpipe.evaluate_model(corpus)
    return out


@pytest.mark.parametrize("fn", ["generate_comparison_summary", "generate_verification_summary",
                                "analyze_gallery_strategies", "analyze_failure_cases",
                                "compare_models_statistical"])
def test_comparisons_equal(model_results, fn):
    want = getattr(jcmp, fn)(model_results)
    got = getattr(tcmp, fn)(model_results)
    assert_same(got, want, tol=0.0)
    if isinstance(want, pd.DataFrame):
        assert not want.empty


def test_statistical_comparison_on_other_galleries_and_aggregations(model_results):
    for gallery in ("oneshot_base", "nowhere"):
        for agg in ("max", "topk"):
            assert_same(tcmp.compare_models_statistical(model_results, gallery, agg),
                        jcmp.compare_models_statistical(model_results, gallery, agg), tol=0.0)


# -------------------------------------------------------------- hardening


@pytest.mark.parametrize("sigma,seed", [(0.0, 0), (0.5, 1), (2.0, 7)])
def test_perturb_corpus_equal(corpus, sigma, seed):
    _, probes, _, _ = corpus
    want = jhard.perturb_corpus(probes, sigma, seed)
    got = thard.perturb_corpus(probes, sigma, seed)
    assert_same(got, want, tol=0.0)


def test_noise_sweep_like_jax(corpus):
    gallery, probes, negatives, _ = corpus
    sigmas = (0.0, 0.7, 3.0)
    want = jhard.noise_sweep(gallery, probes, negatives, THRESHOLDS, sigmas, seed=3)
    got = thard.noise_sweep(gallery, probes, negatives, THRESHOLDS, sigmas, seed=3,
                            device="cpu")
    assert_same(got, want)
    assert thard.noise_knee(want) == jhard.noise_knee(want)


@pytest.mark.parametrize("n_enrolled", [2, 4])
def test_subsampled_gallery_like_jax(corpus, n_enrolled):
    gallery, probes, negatives, _ = corpus
    want = jhard.subsampled_gallery(gallery, probes, negatives, THRESHOLDS, n_enrolled, seed=5)
    got = thard.subsampled_gallery(gallery, probes, negatives, THRESHOLDS, n_enrolled, seed=5,
                                   device="cpu")
    assert_same(got, want)


def test_cross_model_impostors_and_headline_like_jax(corpus):
    gallery, probes, negatives, _ = corpus
    _, other, _, _ = make_corpus(12)
    want = jhard.cross_model_impostors(gallery, probes, other, THRESHOLDS, negatives)
    got = thard.cross_model_impostors(gallery, probes, other, THRESHOLDS, negatives,
                                      device="cpu")
    assert_same(got, want)
    hard = {"noise_sweep": [{"sigma": 0.0, "rank1_accuracy": 1.0, "eer": 0.0, "dprime": 5.0},
                            {"sigma": 4.0, "rank1_accuracy": 0.6, "eer": 0.3, "dprime": 1.1}],
            "subsampled_gallery_10": jhard.subsampled_gallery(
                gallery, probes, negatives, THRESHOLDS, 3),
            "cross_model_impostors": want}
    assert thard.headline_hard_block(hard) == jhard.headline_hard_block(hard)


@pytest.mark.parametrize("ranks", [(1.0, 0.97, 0.9, 0.5), (0.9, 0.8), (1.0, 1.0), (1.0, 0.95)])
def test_noise_knee_equal(ranks):
    rows = [{"sigma": float(i), "rank1_accuracy": r} for i, r in enumerate(ranks)]
    assert thard.noise_knee(rows) == jhard.noise_knee(rows)
    assert thard.noise_knee(rows, 0.85) == jhard.noise_knee(rows, 0.85)


# --------------------------------------------------------------- pipeline


def write_corpus(root, model_name, seed, shift=0.0):
    """The seven corpus pickles of one model under root/embeddings/model."""
    d = os.path.join(root, "embeddings", model_name)
    os.makedirs(d)
    gallery, probes, negatives, segmented = make_corpus(seed, shift=shift)
    blobs = {
        "gallery_one-shot_base": {k: {"embeddings": v["embeddings"][:1]}
                                  for k, v in gallery.items()},
        "gallery_few-shot_base": gallery,
        "gallery_one-shot_augmented": {k: {"embeddings": np.concatenate(
            [v["embeddings"][:1], v["embeddings"][:1] * 0.5])} for k, v in gallery.items()},
        "gallery_few-shot_augmented": {k: {"embeddings": np.concatenate(
            [v["embeddings"]] * 2)} for k, v in gallery.items()},
        "probe_positive_unsegmented": probes,
        "probe_positive_segmented": segmented,
        "probe_negative": negatives,
    }
    for stem, blob in blobs.items():
        with open(os.path.join(d, f"{stem}.pkl"), "wb") as f:
            pickle.dump(blob, f)
    return d


@pytest.fixture(scope="module")
def pipelines(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("corpora"))
    write_corpus(root, "adaface_ir_micro", 31)
    write_corpus(root, "arcface_ir_micro", 32, shift=0.05)
    models = ["adaface_ir_micro", "arcface_ir_micro", "missing_model"]
    emb = os.path.join(root, "embeddings")
    want = jpipe.run_complete_evaluation_pipeline(models, emb, os.path.join(root, "jax"),
                                                  make_plots=False)
    got = tpipe.run_complete_evaluation_pipeline(models, emb, os.path.join(root, "port"),
                                                 make_plots=False, device="cpu")
    return root, want, got


def test_pipeline_results_like_jax(pipelines):
    root, want, got = pipelines
    assert list(got["results"]) == ["adaface_ir_micro", "arcface_ir_micro"]
    assert_same(got["results"], want["results"])
    g, w = dict(got["exports"]), dict(want["exports"])
    g.pop("generated"), w.pop("generated")
    assert_same(g, w)


@pytest.mark.parametrize("name", ["identification_summary", "verification_summary",
                                  "gallery_strategies", "statistical_comparison"])
def test_pipeline_tables_like_jax(pipelines, name):
    root, _, _ = pipelines
    got = pd.read_csv(os.path.join(root, "port", f"{name}.csv"))
    want = pd.read_csv(os.path.join(root, "jax", f"{name}.csv"))
    assert_same(got, want)
    with open(os.path.join(root, "port", f"{name}.tex")) as f:
        assert f.read().count("\\\\") == len(want) + 1  # header and rows
    gs = txlsx.read_xlsx_rows(os.path.join(root, "port", "evaluation_results.xlsx"))
    ws = jxlsx.read_xlsx_rows(os.path.join(root, "jax", "evaluation_results.xlsx"))
    assert list(gs) == list(ws)
    assert_same(gs[name], ws[name])


def test_pipeline_summary_text_and_json_like_jax(pipelines):
    root, _, _ = pipelines
    with open(os.path.join(root, "port", "executive_summary.txt")) as f:
        got = f.read()
    with open(os.path.join(root, "jax", "executive_summary.txt")) as f:
        assert got == f.read()
    blobs = []
    for who in ("port", "jax"):
        with open(os.path.join(root, who, "evaluation_results.json")) as f:
            blob = json.load(f)
        blob.pop("generated")
        blobs.append(blob)
    assert_same(*blobs)


def test_corpus_loads_in_either_package(pipelines):
    root, _, _ = pipelines
    d = os.path.join(root, "embeddings", "adaface_ir_micro")
    assert_same(tpipe.load_model_corpus(d), jpipe.load_model_corpus(d), tol=0.0)
    assert tpipe.load_model_corpus(os.path.join(root, "nowhere"))["galleries"] == {}


def test_export_plots_writes_the_jax_files(pipelines, tmp_path):
    pytest.importorskip("matplotlib")
    _, want, got = pipelines
    w = jpipe.export_plots(want["results"], str(tmp_path / "jax"))
    g = tpipe.export_plots(got["results"], str(tmp_path / "port"))
    assert [os.path.basename(p) for p in g] == [os.path.basename(p) for p in w]
    assert all(os.path.getsize(p) > 1000 for p in g)


def test_evaluate_models_cli_like_jax(pipelines, tmp_path):
    from facerecognitionpipeline_tpu.cli import evaluate_models as jcli
    from facerecognitionpipeline_tpu_torch.cli import evaluate_models as tcli

    root, _, _ = pipelines
    argv = ["--models", "adaface_ir_micro", "--embeddings_root",
            os.path.join(root, "embeddings"), "--threshold_start", "0.3",
            "--threshold_stop", "0.8", "--threshold_step", "0.1", "--aggregations", "mean",
            "topk", "--no_plots"]
    assert jcli.main(argv + ["--output_dir", str(tmp_path / "jax")]) == 0
    assert tcli.main(argv + ["--output_dir", str(tmp_path / "port"), "--device", "cpu"]) == 0
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    with open(tmp_path / "port" / "executive_summary.txt") as a, \
            open(tmp_path / "jax" / "executive_summary.txt") as b:
        assert a.read() == b.read()
    assert tcli.main(["--models", "nothing", "--embeddings_root", str(tmp_path),
                      "--output_dir", str(tmp_path / "none"), "--device", "cpu"]) == 1


# ------------------------------------------------------------------- xlsx


def _tables():
    df = pd.DataFrame([{"Model": "a", "Rank-1": np.float64(0.5), "n": np.int64(3), "ok": True},
                       {"Model": "b&<c>", "Rank-1": float("nan"), "n": 4, "ok": False}])
    rows = [["h1", "h2", "h3"], [1, 2.5, None], ["x", float("inf"), -3],
            [np.float32(0.25), "é", True]]
    return {
        "frame": {"Results": df},
        "rows": {"Rows": rows},
        "names": {"a/b:c?*[d]" + "x" * 40: rows, "A/B:C?*[D]" + "x" * 40: df,
                  "": [["only"]]},
    }


@pytest.mark.parametrize("case", ["frame", "rows", "names"])
@pytest.mark.parametrize("header_bold", [True, False])
def test_xlsx_member_xml_and_rows_equal(tmp_path, case, header_bold):
    sheets = _tables()[case]
    jp, tp = str(tmp_path / "jax.xlsx"), str(tmp_path / "port.xlsx")
    jxlsx.write_xlsx(jp, sheets, header_bold=header_bold)
    txlsx.write_xlsx(tp, sheets, header_bold=header_bold)
    with zipfile.ZipFile(jp) as a, zipfile.ZipFile(tp) as b:
        assert a.namelist() == b.namelist()
        for member in a.namelist():
            assert b.read(member) == a.read(member), member
    assert txlsx.read_xlsx_rows(tp) == jxlsx.read_xlsx_rows(jp)
    assert txlsx.read_xlsx_rows(jp) == jxlsx.read_xlsx_rows(tp)


def test_xlsx_refuses_no_sheets(tmp_path):
    with pytest.raises(ValueError):
        txlsx.write_xlsx(str(tmp_path / "x.xlsx"), {})


# --------------------------------------------------------- detection suite


@pytest.mark.parametrize("seed", range(3))
def test_iou_and_matching_equal(seed):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(0, 100, (5, 2))
    gt = np.concatenate([gt, gt + rng.uniform(10, 40, (5, 2))], 1).astype(np.float32)
    pred = np.concatenate([gt[:3] + rng.normal(0, 4, (3, 4)), rng.uniform(0, 140, (4, 4))])
    pred[:, 2:] = np.maximum(pred[:, 2:], pred[:, :2] + 1)
    pred = pred.astype(np.float32)
    scores = rng.uniform(0, 1, len(pred)).astype(np.float32)
    np.testing.assert_array_equal(tdet.iou_matrix(pred, gt), jdet.iou_matrix(pred, gt))
    for a, b in ((pred, gt), (pred[:0], gt), (pred, gt[:0])):
        s = scores[: len(a)]
        got, want = tdet.match_detections(a, s, b, 0.4), jdet.match_detections(a, s, b, 0.4)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    s, tp = jdet.match_detections(pred, scores, gt)
    for n_gt in (0, 5, 9):
        assert_same(tdet.pr_curve(s, tp, n_gt), jdet.pr_curve(s, tp, n_gt), tol=0.0)
    assert_same(tdet.pr_curve(s[:0], tp[:0], 3), jdet.pr_curve(s[:0], tp[:0], 3), tol=0.0)


class _FixedDetector:
    """Detections derived from the scene's own pixels, the same for both
    packages, so the suites' bookkeeping is compared on equal inputs."""

    def detect(self, image):
        rng = np.random.default_rng(int(image.sum()) % 2**32)
        out = []
        for _ in range(int(rng.integers(0, 4))):
            x, y = rng.uniform(0, image.shape[1] - 60, 2)
            s = rng.uniform(30, 60)
            out.append({"bbox": np.array([x, y, x + s, y + s * 1.3], np.float32),
                        "det_score": float(rng.uniform(0.3, 1.0))})
        return out


def test_stress_suite_bookkeeping_equal():
    cats = ("baseline", "crowded", "hard_negatives")
    want = jdet.run_stress_suite(_FixedDetector(), cats, n_scenes=3, size=160)
    got = tdet.run_stress_suite(_FixedDetector(), cats, n_scenes=3, size=160)
    assert_same(got, want, tol=0.0)
    assert jdet.STRESS_CATEGORIES == tdet.STRESS_CATEGORIES


def test_stress_suite_with_both_detectors():
    """The port's MTCNNDetector and the JAX one (float32 cascade, the same
    weights) over two stress categories: equal counts and AP within 1e-4."""
    from facerecognitionpipeline_tpu.models.detector import MTCNNDetector as JDetector
    from facerecognitionpipeline_tpu_torch.models.detector import MTCNNDetector

    weights = "pretrained/mtcnn_synthetic.npz"
    jd = JDetector(det_size=(320, 320), weights_path=weights)
    td = MTCNNDetector(det_size=(320, 320), weights_path=weights, device="cpu")
    cats = ("baseline", "occlusion")
    want = jdet.run_stress_suite(jd, cats, n_scenes=2, size=320)
    got = tdet.run_stress_suite(td, cats, n_scenes=2, size=320)
    for cat in cats:
        w, g = want["detail"][cat], got["detail"][cat]
        assert (g["n_images"], g["n_gt_faces"], g["n_detections"]) == (
            w["n_images"], w["n_gt_faces"], w["n_detections"])
        assert w["n_detections"] > 0
        assert abs(g["ap"] - w["ap"]) <= 1e-4
        np.testing.assert_allclose(g["pr_curve"]["thresholds"], w["pr_curve"]["thresholds"],
                                   atol=1e-4)
