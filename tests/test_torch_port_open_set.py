"""The open-set protocol of the port (`evalharness/open_set.py`,
`train/open_set.py`, `examples/torch_{train_open_set,open_set_eval}.py`)
against the JAX package's examples (`examples/open_set_eval.py`,
`examples/train_ir18_open_set.py`, loaded from their files), on the CPU.

Both modules are shrunk the same way (4 gallery and 4 unknown identities,
2 enrolment and 2 probe crops: every embedding call is a batch of 8, one
compiled shape on the JAX side).

* renders and the six corruptions: bit-equal (one rng drawn in the same
  order: the known then the unknown probes of each condition);
* `open_set_dir_far`, `holdout_separation`: within 1e-12 on seeded arrays;
* `evaluate_tier` at ir_micro (seeded JAX weights carried across by
  `models/convert.py` inside `FaceEmbedder(variables=)`), clean and blur:
  fp32 every metric within 1e-4, rank-1 and rank-5 equal; int8 under the
  int8 parity rules: every embedding batch the tier makes at cosine >=
  0.999 between the packages; the largest move of a probe's gallery score
  inside the quantization band (5e-3); score-valued metrics within that
  move, and each decision-valued metric differing by at most the share of
  probes whose decision lies within it of its boundary (a top-1 margin, or
  a best or genuine score near a threshold or tau);
* `embed_for_probe` from one state carried across after one port step, at
  float32: features within 1e-5 (the forward alone; the train tests' 1e-5
  relative loss bound after one step);
* `train_open_set` for 3 steps: the `.npz` loads in both packages'
  `FaceEmbedder` with equal embeddings, the `.meta.json` has the JAX meta's
  keys;
* the scripts' flags and defaults are the JAX scripts' plus `--device`;
* `chip_smoke.py --openset-only` refuses a name that is no recorded recipe;
* the committed reports `reports/openset_torch_<arch>/report.json` meet the
  floors of `tests/test_open_set_trained.py` (restated here) and have the
  JAX report's keys.
"""

import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import torch

from facerecognitionpipeline_tpu.models.irse import build_backbone as jax_backbone
from facerecognitionpipeline_tpu.pipeline.embedder import FaceEmbedder as JaxEmbedder
from facerecognitionpipeline_tpu_torch.evalharness import open_set as port_eval
from facerecognitionpipeline_tpu_torch.models.convert import train_state_to_jax
from facerecognitionpipeline_tpu_torch.pipeline.embedder import FaceEmbedder
from facerecognitionpipeline_tpu_torch.train import open_set as port_train
from facerecognitionpipeline_tpu_torch.train.trainer import (
    TrainConfig,
    Trainer,
    dropout_generator,
)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHRUNK = {"N_GALLERY": 4, "N_UNKNOWN": 4, "ENROLL_PER_ID": 2, "PROBES_PER_ID": 2}
CONDITIONS = ["clean", "blur"]
BAND = 5e-3  # the int8 quantization band (ROADMAP.md §3)
SCORE_KEYS = ("genuine_mean", "impostor_mean", "tau_at_far_0.01", "tau_at_far_0.05",
              "tau_at_far_0.1", "unknown_mean_best", "known_mean_best")


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


JAX_EVAL = _load("open_set_eval")
JAX_TRAIN = _load("train_ir18_open_set")


@pytest.fixture
def shrunk(monkeypatch):
    for module in (JAX_EVAL, port_eval):
        for name, value in SHRUNK.items():
            monkeypatch.setattr(module, name, value)
    return port_eval.render_sets()


@pytest.fixture(scope="module")
def jax_variables():
    """Seeded ir_micro variables of the JAX package's backbone (unfolded:
    each embedder folds them), initialized under jit."""
    variables = jax.jit(jax_backbone("ir_micro").init)(
        jax.random.PRNGKey(4), np.zeros((1, 112, 112, 3), np.float32))
    return jax.tree_util.tree_map(np.asarray, dict(variables))


def test_render_sets_bit_equal(shrunk):
    for got, want in zip(shrunk, JAX_EVAL.render_sets()):
        assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", list(port_eval.CONDITIONS))
def test_corrupt_bit_equal(shrunk, mode):
    """The known then the unknown probes from one rng, as `evaluate_tier`
    draws them; twice, so the second draw starts where the first ended."""
    _, known, unknown = shrunk
    flat = [known.reshape(-1, 112, 112, 3), unknown.reshape(-1, 112, 112, 3)]
    rng_p, rng_j = np.random.default_rng(11), np.random.default_rng(11)
    for _ in range(2):
        for x in flat:
            got, want = port_eval.corrupt(x, mode, rng_p), JAX_EVAL.corrupt(x, mode, rng_j)
            assert got.dtype == np.uint8
            np.testing.assert_array_equal(got, want)
            assert mode == "clean" or (got != x).any()
    with pytest.raises(ValueError, match="unknown corruption mode"):
        port_eval.corrupt(flat[0], "fog", rng_p)


def test_open_set_dir_far_equal():
    rng = np.random.default_rng(3)

    def unit(n):
        v = rng.normal(size=(n, 64))
        return v / np.linalg.norm(v, axis=1, keepdims=True)

    gallery, known, unknown = unit(12), unit(60), unit(40)
    known[:30] += 2 * gallery[np.arange(30) % 12]  # half of them near their identity
    labels = np.arange(60) % 12
    got = port_eval.open_set_dir_far(gallery, known, labels, unknown)
    want = JAX_EVAL.open_set_dir_far(gallery, known, labels, unknown)
    assert got.keys() == want.keys() and got["dir_at_far_0.1"] > 0
    for key in want:
        assert abs(got[key] - want[key]) <= 1e-12, key


def test_holdout_separation_equal():
    rng = np.random.default_rng(5)
    feats = rng.normal(size=(48, 32))
    labels = np.repeat(np.arange(12), 4)
    feats += 1.5 * rng.normal(size=(12, 32))[labels]
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    got = port_train.holdout_separation(feats, labels)
    want = JAX_TRAIN.holdout_separation(feats, labels)
    assert got.keys() == want.keys() and 0 < want["eer"] < 0.5
    for key in want:
        assert abs(got[key] - want[key]) <= 1e-12, key


def test_holdout_probe_sets_bit_equal():
    got, want = port_train.holdout_probe_sets(), JAX_TRAIN.holdout_probe_sets()
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].shape == (96, 112, 112, 3) and got[1].dtype == np.int32


def test_evaluate_tier_fp32_matches_jax(shrunk, jax_variables):
    enroll, known, unknown = shrunk
    got = port_eval.evaluate_tier(FaceEmbedder("ir_micro", variables=jax_variables,
                                               device="cpu"), enroll, known, unknown,
                                  CONDITIONS)
    want = JAX_EVAL.evaluate_tier(JaxEmbedder("ir_micro", variables=jax_variables),
                                  enroll, known, unknown, CONDITIONS)
    assert list(got) == list(want) == CONDITIONS
    for cond in CONDITIONS:
        assert list(got[cond]) == list(want[cond])
        for key, value in want[cond].items():
            assert abs(got[cond][key] - value) <= 1e-4, (cond, key)
        assert got[cond]["rank1"] == want[cond]["rank1"]
        assert got[cond]["rank5"] == want[cond]["rank5"]


def _band_share(enroll_e, known_e, unknown_e, metrics, band) -> float:
    """The share of known plus that of unknown probes whose decisions lie
    within `band` of their boundary: a top-1 margin under it (aggregation
    'mean' and the gallery mean), or a best or genuine score within it of a
    threshold of the sweep or of a tau."""
    thresholds = np.asarray(port_eval.THRESHOLDS + [metrics[k] for k in metrics
                                                    if k.startswith("tau_at_far")])
    mean = enroll_e.mean(axis=1)
    mean /= np.linalg.norm(mean, axis=1, keepdims=True) + 1e-9

    def in_band(probes, genuine=None):
        flat = probes.reshape(-1, probes.shape[-1])
        out = np.zeros(len(flat), bool)
        for scores in (np.einsum("pd,ied->pie", flat, enroll_e).mean(-1), flat @ mean.T):
            top = np.sort(scores, axis=1)[:, ::-1]
            out |= top[:, 0] - top[:, 1] < band
            near = [top[:, 0]] + ([scores[np.arange(len(flat)), genuine]]
                                  if genuine is not None else [])
            for s in near:
                out |= (np.abs(s[:, None] - thresholds[None, :]) < band).any(axis=1)
        return out.mean()

    labels = np.repeat(np.arange(len(known_e)), known_e.shape[1])
    return in_band(known_e, labels) + in_band(unknown_e)


def _recording(embedder) -> list:
    """Every embedding batch the embedder returns, in call order."""
    calls, inner = [], embedder.extract_embeddings_batch

    def record(faces, *args, **kw):
        calls.append(np.asarray(inner(faces, *args, **kw), np.float32))
        return calls[-1]

    embedder.extract_embeddings_batch = record
    return calls


def _gallery_scores(probes, enroll_e):
    """A probe's scores as evaluate_tier decides with them: the mean over an
    identity's enrolment embeddings, and against the normalized mean."""
    mean = enroll_e.mean(axis=1)
    mean /= np.linalg.norm(mean, axis=1, keepdims=True) + 1e-9
    return np.concatenate([np.einsum("pd,ied->pie", probes, enroll_e).mean(-1),
                           probes @ mean.T], axis=1)


def test_evaluate_tier_int8_matches_jax(shrunk, jax_variables):
    enroll, known, unknown = shrunk
    calib = enroll.reshape(-1, 112, 112, 3)
    port = FaceEmbedder("ir_micro", variables=jax_variables, quantize="int8",
                        calib_faces=calib, device="cpu")
    ref = JaxEmbedder("ir_micro", variables=jax_variables, quantize="int8", calib_faces=calib)
    port_calls, jax_calls = _recording(port), _recording(ref)
    got = port_eval.evaluate_tier(port, enroll, known, unknown, CONDITIONS)
    want = JAX_EVAL.evaluate_tier(ref, enroll, known, unknown, CONDITIONS)
    assert list(got) == list(want) == CONDITIONS
    # enrolment, then the known and the unknown probes of each condition
    assert len(port_calls) == len(jax_calls) == 1 + 2 * len(CONDITIONS)
    for a, b in zip(port_calls, jax_calls):
        np.testing.assert_array_less(0.999, (a * b).sum(-1))
    enroll_p = port_calls[0].reshape(*enroll.shape[:2], -1)
    enroll_j = jax_calls[0].reshape(*enroll.shape[:2], -1)
    for i, cond in enumerate(CONDITIONS):
        probes_p, probes_j = port_calls[1 + 2 * i:3 + 2 * i], jax_calls[1 + 2 * i:3 + 2 * i]
        # the largest move of a score between the packages, inside the band
        band = max(float(np.abs(_gallery_scores(p, enroll_p) - _gallery_scores(j, enroll_j))
                         .max()) for p, j in zip(probes_p, probes_j))
        assert band < BAND, (cond, band)
        share = _band_share(enroll_j, probes_j[0].reshape(*known.shape[:2], -1),
                            probes_j[1].reshape(*unknown.shape[:2], -1), want[cond], band)
        assert list(got[cond]) == list(want[cond])
        for key, value in want[cond].items():
            if key in SCORE_KEYS:
                limit = band
            elif key == "dprime":
                limit = 0.05
            else:
                limit = share + 1e-9
            assert abs(got[cond][key] - value) <= limit, (cond, key, got[cond][key], value)


def test_embed_for_probe_matches_jax():
    cfg = dict(architecture="ir_micro", num_classes=8)
    trainer = Trainer(TrainConfig(**cfg), device="cpu")
    state = trainer.init_state(0)
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (8, 112, 112, 3)).astype(np.float32)
    y = rng.integers(0, 8, 8).astype(np.int32)
    # one step, so the running statistics differ from their init
    state, _ = trainer.train_step(state, x, y, dropout_generator(0, 0))
    images = port_train.holdout_probe_sets(n_ids=4, per_id=2)[0]
    got = port_train.embed_for_probe(trainer, state, images)

    from jax.sharding import Mesh

    from facerecognitionpipeline_tpu.train.trainer import TrainConfig as JaxConfig
    from facerecognitionpipeline_tpu.train.trainer import Trainer as JaxTrainer

    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    want = JAX_TRAIN.embed_for_probe(JaxTrainer(JaxConfig(**cfg), mesh), train_state_to_jax(state),
                                     images)
    assert got.shape == want.shape == (8, 512) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_train_open_set_exports_what_both_packages_load(tmp_path):
    out = str(tmp_path / "ir_micro_synthetic_torch.npz")
    trainer, state, meta, losses = port_train.train_open_set(
        "ir_micro", n_ids=4, per_id=2, steps=3, batch=8, lr=0.1, warmup=1, out=out,
        probe=False, seed=0, device="cpu")
    assert len(losses) == 3 and np.isfinite(losses).all() and int(state["step"]) == 3
    with open(os.path.join(REPO, "pretrained", "ir_50_synthetic.meta.json")) as f:
        jax_meta = json.load(f)
    with open(out.replace(".npz", ".meta.json")) as f:
        written = json.load(f)
    assert written == meta and list(meta) == list(jax_meta)
    assert meta["steps"] == 3 and "examples/torch_train_open_set.py" in meta["retrain"]
    faces = port_train.holdout_probe_sets(n_ids=2, per_id=4)[0]
    a = FaceEmbedder("ir_micro", model_path=out, device="cpu").extract_embeddings_batch(faces)
    b = JaxEmbedder("ir_micro", model_path=out).extract_embeddings_batch(faces)
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
    assert not os.path.exists(out + ".step2000")


@pytest.mark.parametrize("entry", ["train", "eval"])
def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch, tmp_path, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = {
        "train": lambda **kw: port_train.train_open_set(
            "ir_micro", 4, 2, 1, 8, out=str(tmp_path / "w.npz"), **kw),
        "eval": lambda **kw: port_eval.run_open_set("ir_micro", str(tmp_path / "w.npz"),
                                                    **kw),
    }[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()


def _flags(parser) -> dict:
    return {a.dest: (a.option_strings, a.default, a.type, a.nargs)
            for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("script,jax_script", [
    ("torch_train_open_set", JAX_TRAIN), ("torch_open_set_eval", JAX_EVAL)])
def test_scripts_take_the_jax_scripts_flags_and_device(monkeypatch, script, jax_script):
    import argparse

    class Parsed(Exception):
        pass

    def capture(self, *args, **kw):
        raise Parsed(self)

    port = _load(script)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(Parsed) as caught:
        jax_script.main()
    monkeypatch.undo()
    want = _flags(caught.value.args[0])
    got = _flags(port.build_parser())
    assert got.pop("device") == (["--device"], "cuda", None, None)
    assert got == want


def test_scripts_train_and_report_on_the_cpu(shrunk, tmp_path, capsys):
    """The two scripts end to end with --device cpu: a 2-step bf16 run's
    weights into the evaluation, its report and plot; a missing weights
    file is refused."""
    out = str(tmp_path / "w.npz")
    train = _load("torch_train_open_set")
    assert train.main(["--architecture", "ir_micro", "--n_ids", "3", "--per_id", "2",
                       "--steps", "2", "--batch", "4", "--warmup", "1", "--out", out,
                       "--device", "cpu"]) == 0
    assert os.path.exists(out) and os.path.exists(out.replace(".npz", ".meta.json"))
    evaluate = _load("torch_open_set_eval")
    report_dir = tmp_path / "report"
    assert evaluate.main(["--architecture", "ir_micro", "--weights", out, "--out",
                          str(report_dir), "--conditions", "clean", "--skip_int8",
                          "--device", "cpu"]) == 0
    with open(report_dir / "report.json") as f:
        report = json.load(f)
    assert list(report) == ["architecture", "weights", "protocol", "fp32"]
    assert report["protocol"]["n_gallery_identities"] == SHRUNK["N_GALLERY"]
    assert (report_dir / "curves.png").exists()  # this machine has matplotlib
    assert "headline (fp32 clean)" in capsys.readouterr().out
    assert evaluate.main(["--weights", str(tmp_path / "absent.npz"), "--device", "cpu"]) == 1



@pytest.mark.parametrize("name", ["ir50", "ir_101"])
def test_chip_smoke_openset_only_refuses_other_names(monkeypatch, capsys, name):
    """`chip_smoke.py --openset-only` takes a recorded recipe's name (or
    none); any other is refused before the kernels are built."""
    import sys

    import chip_smoke
    from facerecognitionpipeline_tpu_torch.ops import cuda_build
    from facerecognitionpipeline_tpu_torch.utils import device

    def no_build():
        raise AssertionError("the kernels were built")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(device, "resolve_device", lambda d: torch.device("cpu"))
    monkeypatch.setattr(cuda_build, "build_all", no_build)
    monkeypatch.setattr(sys, "argv", ["chip_smoke.py", "--openset-only", name])
    assert chip_smoke.main() == 2
    assert f"not {name!r}" in capsys.readouterr().err


# ------------------------------------------------------ the committed reports

ARCHS = ("ir_18", "ir_50")


@pytest.fixture(params=ARCHS)
def report(request):
    path = os.path.join(REPO, "reports", f"openset_torch_{request.param}", "report.json")
    if not os.path.exists(path):
        pytest.skip(f"the port's open-set report for {request.param} not generated")
    with open(path) as f:
        return json.load(f)


def test_report_protocol_scale(report):
    p = report["protocol"]
    assert p["n_gallery_identities"] >= 200
    assert p["n_unknown_identities"] >= 40
    assert "disjoint" in p["held_out"]


def test_report_clean_headline_floors(report):
    clean = report["fp32"]["clean"]
    assert clean["rank1"] >= 0.97
    assert clean["eer"] <= 0.03
    assert clean["tar_at_far_0.01"] >= 0.95
    assert clean["dir_at_far_0.01"] >= 0.95
    assert clean["dprime"] >= 4.0


def test_report_curves_are_sloped_not_saturated(report):
    fp32 = report["fp32"]
    hard_eers = [fp32[c]["eer"] for c in ("blur", "lowlight", "occlusion")]
    assert all(0.01 < e < 0.5 for e in hard_eers), hard_eers
    hard_dirs = [fp32[c]["dir_at_far_0.01"] for c in ("blur", "lowlight", "occlusion")]
    assert all(0.3 < d < 0.999 for d in hard_dirs), hard_dirs
    assert min(hard_eers) > fp32["clean"]["eer"]


def test_report_int8_tier_tracks_fp32(report):
    assert "int8" in report
    for cond, fp in report["fp32"].items():
        q = report["int8"][cond]
        assert abs(q["rank1"] - fp["rank1"]) < 0.03, cond
        assert abs(q["eer"] - fp["eer"]) < 0.03, cond
    drift = report["int8_drift_cosine"]
    assert drift["mean"] > 0.995 and drift["min"] > 0.98


def test_report_keys_are_the_jax_reports(report):
    with open(os.path.join(REPO, "reports", "openset_ir_50", "report.json")) as f:
        want = json.load(f)
    assert list(report) == list(want)
    assert report["protocol"] == want["protocol"]
    assert list(report["int8_drift_cosine"]) == list(want["int8_drift_cosine"])
    for tier in ("fp32", "int8"):
        assert list(report[tier]) == list(want[tier])
        for cond, metrics in want[tier].items():
            assert list(report[tier][cond]) == list(metrics), (tier, cond)
            assert all(np.isfinite(v) for v in report[tier][cond].values()), (tier, cond)
