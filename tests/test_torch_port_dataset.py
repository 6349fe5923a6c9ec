"""The port's offline dataset path (`pipeline/{preprocessing,segmentation,
corpus,labeling}.py` and their CLIs) against the JAX package's, on the CPU.

Both packages load the same `ir_micro` weights (an `.npz` written once from
the port's module) and the same detector file
(`pretrained/mtcnn_synthetic.npz`, float32 cascade at 320x320). Photos are
renders of `render_identity_scene` upscaled 2x, one face each. Tolerances:
filename rules, segmentation categories, file trees, labels and matches
equal; detection scores within 1e-4, boxes within 1 px, quality metrics
within 1e-3 (relative for the blur variance); aligned crops within one grey
level; corpus embeddings and scores within 1e-4 (two frameworks'
convolutions); evaluations of one corpus within 1e-5 (d', a difference of
means over a spread of scores, within 1e-5 relative). Downstream steps run
on the same files in both packages (the port's crops), so each step is held
to its JAX counterpart on equal inputs.
"""

import json
import os
import pickle
import shutil

import cv2
import numpy as np
import pytest
import torch

from facerecognitionpipeline_tpu.cli import label_rename_utility as jrename
from facerecognitionpipeline_tpu.cli import lfw_impostor_helper as jlfw
from facerecognitionpipeline_tpu.evalharness import pipeline as jpipe
from facerecognitionpipeline_tpu.gallery.manager import GalleryManager as JGallery
from facerecognitionpipeline_tpu.models.detector import MTCNNDetector as JDetector
from facerecognitionpipeline_tpu.pipeline import corpus as jcorpus
from facerecognitionpipeline_tpu.pipeline import preprocessing as jprep
from facerecognitionpipeline_tpu.pipeline import segmentation as jseg
from facerecognitionpipeline_tpu.pipeline.embedder import FaceEmbedder as JEmbedder
from facerecognitionpipeline_tpu.pipeline.labeling import ProbeLabeler as JLabeler
from facerecognitionpipeline_tpu.pipeline.processor import FaceProcessor as JProcessor
from facerecognitionpipeline_tpu_torch.cli import label_rename_utility as trename
from facerecognitionpipeline_tpu_torch.cli import lfw_impostor_helper as tlfw
from facerecognitionpipeline_tpu_torch.evalharness import pipeline as tpipe
from facerecognitionpipeline_tpu_torch.gallery.manager import GalleryManager
from facerecognitionpipeline_tpu_torch.models.convert import backbone_variables_from_state
from facerecognitionpipeline_tpu_torch.models.detector import MTCNNDetector
from facerecognitionpipeline_tpu_torch.models.irse import build_backbone
from facerecognitionpipeline_tpu_torch.models.layers import lecun_normal_
from facerecognitionpipeline_tpu_torch.pipeline import corpus as tcorpus
from facerecognitionpipeline_tpu_torch.pipeline import preprocessing as tprep
from facerecognitionpipeline_tpu_torch.pipeline import segmentation as tseg
from facerecognitionpipeline_tpu_torch.pipeline.embedder import FaceEmbedder
from facerecognitionpipeline_tpu_torch.pipeline.labeling import ProbeLabeler
from facerecognitionpipeline_tpu_torch.train.detector_train import (
    make_identity,
    render_identity_scene,
)
from facerecognitionpipeline_tpu_torch.utils.io import save_npz_variables
from tests.test_torch_port_evalharness import assert_same

DETECTOR = "pretrained/mtcnn_synthetic.npz"
DET = (320, 320)
ENROLLED = ["Ann_AA", "Bob_AB", "Cyd_AC"]
VISITORS = ["Visitor_AA", "Visitor_AB"]
CORPUS_QUALITY = {"min_det_score": 0.5, "min_face_size": 40}


def write_photo(path, seed, rng):
    img, *_ = render_identity_scene([make_identity(seed)], rng, size=160)
    img = cv2.resize(img, (320, 320), interpolation=cv2.INTER_LINEAR)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    cv2.imwrite(path, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """dataset/enrollment/{one-shot,few-shot}/<name>/ and raw/: class 01 in
    angle folders, class 02 flat with the angle in the filename."""
    root = str(tmp_path_factory.mktemp("offline"))
    rng = np.random.default_rng(4)
    for i, name in enumerate(ENROLLED):
        write_photo(os.path.join(root, "dataset", "enrollment", "one-shot", name, "p0.png"),
                    500 + i, rng)
        for j in range(2):
            write_photo(os.path.join(root, "dataset", "enrollment", "few-shot", name,
                                     f"p{j}.png"), 500 + i, rng)
        write_photo(os.path.join(root, "raw", "01", "center", f"{name}.png"), 500 + i, rng)
        write_photo(os.path.join(root, "raw", "02", f"{name}_{['left', 'right', 'x'][i]}.png"),
                    500 + i, rng)
    for i, name in enumerate(VISITORS):
        write_photo(os.path.join(root, "raw", "01", "left", f"{name}.png"), 600 + i, rng)
    with open(os.path.join(root, "raw", "not_a_class.txt"), "w") as f:
        f.write("ignored")
    return root


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    model = build_backbone("ir_micro", folded=False)
    lecun_normal_(model, torch.Generator().manual_seed(7))
    path = str(tmp_path_factory.mktemp("w") / "ir_micro.npz")
    save_npz_variables(path, backbone_variables_from_state(model.state_dict()))
    return path


@pytest.fixture(scope="module")
def parts(weights):
    """JAX and port embedders, and detector pairs at the preprocessor's
    threshold (0.3) and the corpus generator's (0.5)."""
    out = {"jax_emb": JEmbedder("ir_micro", model_path=weights),
           "port_emb": FaceEmbedder("ir_micro", model_path=weights, device="cpu")}
    for thresh in (0.3, 0.5):
        out[("jax", thresh)] = JDetector(det_size=DET, det_thresh=thresh, weights_path=DETECTOR)
        out[("port", thresh)] = MTCNNDetector(det_size=DET, det_thresh=thresh,
                                              weights_path=DETECTOR, device="cpu")
    return out


# ------------------------------------------------------------ filename rules


@pytest.mark.parametrize("name", [
    "girl_LEFT_01.png", "Right.jpg", "lefty_right.png", "front.png", "", "leftright",
])
def test_infer_angle_like_jax(name):
    assert tprep.DatasetPreprocessor.infer_angle(name) == \
        jprep.DatasetPreprocessor.infer_angle(name)


@pytest.mark.parametrize("args", [("10A", "left", 1), ("01", "center", 123), ("x", "y", 1000)])
def test_standardize_filename_like_jax(args):
    assert tprep.DatasetPreprocessor.standardize_filename(*args) == \
        jprep.DatasetPreprocessor.standardize_filename(*args)


@pytest.mark.parametrize("name", [
    "Jane_Doe_001_face0.jpg", "bob_12.png", "123.png", "single.jpg", "Ann_AA_01_left_002_face1.jpg",
    "a_b_c.png", "_x_1.png", "lfw_007.jpg",
])
def test_extract_name_from_filename_like_jax(name):
    assert tcorpus.extract_name_from_filename(name) == jcorpus.extract_name_from_filename(name)


def test_to_serializable_like_jax():
    blob = {"a": np.arange(3, dtype=np.float32), "b": [np.int64(4), np.float32(0.5),
                                                        {"c": np.zeros((2, 2))}], "d": "s",
            "e": None, "f": (1, 2)}
    assert tcorpus._to_serializable(blob) == jcorpus._to_serializable(blob)
    assert tprep.PERMISSIVE_QUALITY_CONFIG == jprep.PERMISSIVE_QUALITY_CONFIG
    assert tcorpus.SEGMENT_CATEGORIES == jcorpus.SEGMENT_CATEGORIES
    assert tseg.CATEGORIES == jseg.CATEGORIES


# -------------------------------------------------------------- segmentation


SEG_META = [
    {"filename": "a.jpg", "yaw": 3, "pitch": 3, "blur_score": 900, "det_score": 0.95,
     "face_size": 200},
    {"filename": "b.jpg", "yaw": -5, "pitch": 2, "blur_score": 10, "det_score": 0.9,
     "face_size": 50},
    {"filename": "c.jpg", "yaw": 20, "pitch": -10, "blur_score": 500, "det_score": 0.8,
     "face_size": 100},
    {"filename": "d.jpg", "yaw": 50, "pitch": 30, "blur_score": 400, "det_score": 0.75,
     "face_size": 150},
    {"filename": "e.jpg", "yaw": 2, "pitch": 2, "blur_score": 600, "det_score": 0.5,
     "face_size": 80},
    {"filename": "f.jpg", "yaw": 15, "pitch": 0, "blur_score": 500, "det_score": 0.7,
     "face_size": 79},
    {"filename": "g.jpg"},
]


@pytest.mark.parametrize("kw", [
    {}, {"blur_sharp_percentile": 0, "blur_blurry_percentile": 100},
    {"blur_sharp_percentile": 100, "blur_blurry_percentile": 0},
    {"pose_easy_threshold": 25, "face_medium_threshold": 60, "det_score_threshold": 0.85},
])
def test_categories_like_jax(kw):
    t, j = tseg.ProbeSegmenter(**kw), jseg.ProbeSegmenter(**kw)
    t.compute_blur_thresholds(SEG_META)
    j.compute_blur_thresholds(SEG_META)
    assert (t.blur_sharp_threshold, t.blur_blurry_threshold) == (
        j.blur_sharp_threshold, j.blur_blurry_threshold)
    for m in SEG_META:
        assert t.categorize_face(m) == j.categorize_face(m), m
    assert t.quality_insights(SEG_META) == j.quality_insights(SEG_META)


def test_blur_thresholds_of_an_empty_list_like_jax():
    t, j = tseg.ProbeSegmenter(), jseg.ProbeSegmenter()
    t.compute_blur_thresholds([])
    j.compute_blur_thresholds([])
    assert (t.blur_sharp_threshold, t.blur_blurry_threshold) == (
        j.blur_sharp_threshold, j.blur_blurry_threshold)


def test_filename_mapping_like_jax(tmp_path):
    for f in ("Jane_11_center_001.jpg", "Amy_1_center_001.jpg", "2_left_001.jpg", "x.txt"):
        (tmp_path / f).write_bytes(b"")
    meta = [{"filename": n} for n in ("1_center_001.jpg", "11_center_001.jpg",
                                      "2_left_001.jpg", "3_left_001.jpg")]
    got = tseg.ProbeSegmenter().build_filename_mapping(str(tmp_path), meta)
    assert got == jseg.ProbeSegmenter().build_filename_mapping(str(tmp_path), meta)
    assert got["1_center_001.jpg"] == "Amy_1_center_001.jpg"


def _listing(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = os.path.islink(p)
    return out


@pytest.mark.parametrize("copy_files", [True, False])
def test_segment_dataset_like_jax(tmp_path, copy_files):
    probes = tmp_path / "probes"
    probes.mkdir()
    for m in SEG_META[:-1]:
        (probes / f"Ann_{m['filename']}").write_bytes(b"img")
    meta = tmp_path / "meta.json"
    meta.write_text(json.dumps(SEG_META))
    want = jseg.ProbeSegmenter().segment_dataset(str(probes), str(meta), str(tmp_path / "j"),
                                                 copy_files)
    got = tseg.ProbeSegmenter().segment_dataset(str(probes), str(meta), str(tmp_path / "t"),
                                                copy_files)
    assert got == want
    assert _listing(tmp_path / "t") == _listing(tmp_path / "j")
    for cat in tseg.CATEGORIES:
        name = os.path.join(cat, f"{cat}_metadata.json")
        with open(tmp_path / "t" / name) as a, open(tmp_path / "j" / name) as b:
            assert json.load(a) == json.load(b)


# ------------------------------------------------------------- preprocessing


@pytest.fixture(scope="module")
def preprocessed(tree, parts, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("prep"))
    jp = JProcessor(output_size=224, detector=parts[("jax", 0.3)],
                    quality_filter_config=dict(jprep.PERMISSIVE_QUALITY_CONFIG))
    want = jprep.DatasetPreprocessor(processor=jp).process_dataset(
        os.path.join(tree, "raw"), os.path.join(out, "jax"))
    pre = tprep.DatasetPreprocessor(output_size=224, det_thresh=0.3,
                                    detector=parts[("port", 0.3)], device="cpu")
    got = pre.process_dataset(os.path.join(tree, "raw"), os.path.join(out, "port"))
    return out, want, got, jp, pre


def test_preprocess_dataset_like_jax(preprocessed):
    out, want, got, _, _ = preprocessed
    for key in ("classes", "images", "faces", "angle_counts"):
        assert got[key] == want[key], key
    assert got["images"] == 8 and got["faces"] >= 8
    assert got["angle_counts"] == {"center": 4, "left": 3, "right": 1}
    with open(got["metadata_path"]) as f:
        gm = json.load(f)
    with open(want["metadata_path"]) as f:
        wm = json.load(f)
    assert len(gm) == len(wm)
    for g, w in zip(gm, wm):
        for key in ("filename", "class_id", "source_image", "standardized_name", "face_index",
                    "angle"):
            assert g[key] == w[key], key
        assert abs(g["det_score"] - w["det_score"]) <= 1e-4
        assert np.abs(np.subtract(g["bbox"], w["bbox"])).max() <= 1
        assert abs(g["face_size"] - w["face_size"]) <= 1
        for key in ("yaw", "pitch", "roll"):
            assert abs(g[key] - w[key]) <= 1e-3 * max(1.0, abs(w[key])), key
        assert abs(g["blur_score"] - w["blur_score"]) <= 1e-3 * max(1.0, w["blur_score"])
    assert sorted(os.listdir(os.path.join(out, "port", "probe_positive"))) == \
        sorted(os.listdir(os.path.join(out, "jax", "probe_positive")))


def test_preprocessor_crops_like_jax(tree, preprocessed):
    """What process_single_image writes: the aligned faces, within one grey
    level of the JAX package's."""
    _, _, _, jp, pre = preprocessed
    raw = os.path.join(tree, "raw", "01", "center")
    for name in sorted(os.listdir(raw)):
        want = jp.process_image(os.path.join(raw, name), return_all=True)
        got = pre.processor.process_image(os.path.join(raw, name), return_all=True)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            diff = np.abs(g["aligned_face"].astype(int) - np.asarray(w["aligned_face"], int))
            assert g["aligned_face"].shape == (224, 224, 3) and diff.max() <= 1


def test_preprocessor_edge_cases_like_jax(tmp_path, preprocessed):
    _, _, _, jp, pre = preprocessed
    (tmp_path / "empty").mkdir()
    assert pre.process_dataset(str(tmp_path / "empty"), str(tmp_path / "o1")) == \
        jprep.DatasetPreprocessor(processor=jp).process_dataset(
            str(tmp_path / "empty"), str(tmp_path / "o2")) == {"error": "no_classes"}
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not an image")
    rows = []
    assert pre.process_single_image(str(bad), "c", "center", "c_center_001", str(tmp_path),
                                     rows) == 0 == len(rows)


# -------------------------------------------------------------------- corpus


def _reviewed_tree(crops_dir, meta_path, out_root):
    """probe_labeled/{positive,negative} from the crops' true names (the
    photos' names): what checking the labeler's output by hand gives."""
    with open(meta_path) as f:
        meta = json.load(f)
    for sub in ("positive", "negative"):
        os.makedirs(os.path.join(out_root, "probe_labeled", sub), exist_ok=True)
    for e in meta:
        who = os.path.splitext(e["source_image"])[0].split("_left")[0].split("_right")[0]
        who = who.split("_x")[0]
        sub = "positive" if who in ENROLLED else "negative"
        dst = f"{who}_{e['filename']}" if sub == "positive" else (
            f"lfw_{e['filename']}" if who.endswith("AA") else e["filename"])
        shutil.copy(os.path.join(crops_dir, e["filename"]),
                    os.path.join(out_root, "probe_labeled", sub, dst))
    tseg.ProbeSegmenter().segment_dataset(
        os.path.join(out_root, "probe_labeled", "positive"), meta_path,
        os.path.join(out_root, "probe_labeled", "segmented"))


@pytest.fixture(scope="module")
def corpora(tree, parts, preprocessed, tmp_path_factory, weights):
    """The same dataset and reviewed probe tree through both generators."""
    prep = os.path.join(preprocessed[0], "port")
    roots = {}
    for who in ("jax", "port"):
        roots[who] = str(tmp_path_factory.mktemp(f"corpus_{who}"))
        _reviewed_tree(os.path.join(prep, "probe_positive"),
                       os.path.join(prep, "probe_positive_metadata.json"), roots[who])
    dataset = os.path.join(tree, "dataset")
    jgen = jcorpus.EmbeddingGenerator(
        architecture="ir_micro", dataset_root=dataset, output_root=roots["jax"],
        embedder=parts["jax_emb"],
        processor=JProcessor(output_size=112, detector=parts[("jax", 0.5)],
                             quality_filter_config=dict(CORPUS_QUALITY)))
    tgen = tcorpus.EmbeddingGenerator(
        architecture="ir_micro", dataset_root=dataset, output_root=roots["port"],
        model_path=weights, detector=parts[("port", 0.5)], device="cpu")
    return (jgen.generate_all_embeddings(), tgen.generate_all_embeddings(),
            str(jgen.output_dir), str(tgen.output_dir))


STEMS = ["gallery_one-shot_base", "gallery_one-shot_augmented", "gallery_few-shot_base",
         "gallery_few-shot_augmented", "probe_positive_unsegmented", "probe_positive_segmented",
         "probe_negative"]


@pytest.mark.parametrize("stem", STEMS)
def test_corpus_artifacts_like_jax(corpora, stem):
    _, _, jdir, tdir = corpora
    with open(os.path.join(jdir, f"{stem}.pkl"), "rb") as f:
        want = pickle.load(f)
    with open(os.path.join(tdir, f"{stem}.pkl"), "rb") as f:
        got = pickle.load(f)
    assert want, stem
    assert_same(got, want, tol=1e-4)

    def embeddings(blob):
        for v in blob.values():
            if isinstance(v, dict) and "embeddings" in v:
                yield v["embeddings"]
            elif isinstance(v, dict):
                yield from embeddings(v)
    arrays = [e for e in embeddings(got) if len(e)]
    assert arrays and all(e.dtype == np.float32 and e.shape[1] == 512 for e in arrays)
    with open(os.path.join(tdir, f"{stem}.json")) as f:
        assert json.load(f) == json.loads(json.dumps(tcorpus._to_serializable(got)))


def test_generation_summary_like_jax(corpora):
    want, got, _, _ = corpora
    for key in ("timestamp", "duration_seconds", "output_directory"):
        assert key in got
        want.pop(key), got.pop(key)
    assert got == want
    assert got["gallery"]["few_shot_augmented_persons"] == len(ENROLLED)
    assert got["probe_negative"] == {"real_images": 1, "lfw_images": 1}


def test_corpora_load_in_either_package(corpora):
    _, _, jdir, tdir = corpora
    for d in (jdir, tdir):
        assert_same(tpipe.load_model_corpus(d), jpipe.load_model_corpus(d), tol=0.0)
    assert_same(tpipe.load_model_corpus(tdir), jpipe.load_model_corpus(jdir), tol=1e-4)


def test_corpus_without_directories_like_jax(tmp_path, parts):
    t = tcorpus.EmbeddingGenerator(architecture="ir_micro", dataset_root=str(tmp_path / "no"),
                                   output_root=str(tmp_path / "t"), embedder=parts["port_emb"],
                                   processor=object(), device="cpu")
    j = jcorpus.EmbeddingGenerator(architecture="ir_micro", dataset_root=str(tmp_path / "no"),
                                   output_root=str(tmp_path / "j"), embedder=parts["jax_emb"],
                                   processor=object())
    assert t.process_gallery_enrollment() == j.process_gallery_enrollment() == {}
    assert t.process_probe_positive(True) == j.process_probe_positive(True) == {}
    assert t.process_probe_negative() == j.process_probe_negative() == {}


# ------------------------------------------------------------------ labeling


@pytest.fixture(scope="module")
def labeled(corpora, preprocessed, parts, tmp_path_factory):
    """Both labelers over the port's crops against one gallery file (the
    few-shot base corpus), thresholds set between the scores."""
    _, _, jdir, _ = corpora
    tmp = str(tmp_path_factory.mktemp("label"))
    with open(os.path.join(jdir, "gallery_few-shot_base.pkl"), "rb") as f:
        few = pickle.load(f)
    jg = JGallery(gallery_path=os.path.join(tmp, "g.pkl"), verbose=False)
    for i, (name, d) in enumerate(few.items()):
        jg.add_student(f"STU{i + 1:04d}", name, d["embeddings"])
    jg.save()
    prep = os.path.join(preprocessed[0], "port")
    crops = os.path.join(prep, "probe_positive")
    meta = os.path.join(prep, "probe_positive_metadata.json")
    tg = GalleryManager(gallery_path=os.path.join(tmp, "g.pkl"), verbose=False, device="cpu")
    q = parts["port_emb"].extract_embeddings_batch(
        [cv2.cvtColor(cv2.imread(os.path.join(crops, f)), cv2.COLOR_BGR2RGB)
         for f in sorted(os.listdir(crops))])
    best = np.sort(np.array([r[0][2] for r in tg.search_batch(q, top_k=1)]))
    gaps = np.diff(best)
    cut = np.argsort(gaps)[::-1][:2]  # the two widest gaps between best scores
    unsure, sure = sorted(float(best[c] + gaps[c] / 2) for c in cut)
    assert gaps[cut].min() > 1e-3
    kw = dict(sure_threshold=sure, unsure_threshold=unsure, architecture="ir_micro")
    jl = JLabeler(embedder=parts["jax_emb"], gallery=jg, **kw)
    tl = ProbeLabeler(embedder=parts["port_emb"], gallery=tg, device="cpu", **kw)
    want = jl.process_probe_directory(crops, os.path.join(tmp, "jax"), meta, top_k=2)
    got = tl.process_probe_directory(crops, os.path.join(tmp, "port"), meta, top_k=2)
    return tmp, want, got, jl, tl, crops


def test_labeling_summary_like_jax(labeled):
    _, want, got, _, _, _ = labeled
    want, got = dict(want), dict(got)
    want.pop("timestamp"), got.pop("timestamp")
    assert got == want
    assert sum(v > 0 for v in got["label_distribution"].values()) >= 2


def test_labeling_results_like_jax(labeled):
    tmp, _, _, _, _, _ = labeled
    blobs = {}
    for who in ("jax", "port"):
        with open(os.path.join(tmp, who, "labeling_results.json")) as f:
            blobs[who] = json.load(f)["results"]
    assert len(blobs["port"]) == len(blobs["jax"]) > 0
    for g, w in zip(blobs["port"], blobs["jax"]):
        for key in ("filename", "matched_student_id", "matched_name", "label",
                    "original_metadata"):
            assert g[key] == w[key], key
        assert os.path.basename(g["labeled_path"]) == os.path.basename(w["labeled_path"])
        assert abs(g["confidence"] - w["confidence"]) <= 1e-4
        assert [(m["student_id"], m["name"], m["rank"]) for m in g["top_matches"]] == \
            [(m["student_id"], m["name"], m["rank"]) for m in w["top_matches"]]
        np.testing.assert_allclose([m["score"] for m in g["top_matches"]],
                                   [m["score"] for m in w["top_matches"]], atol=1e-4)
    for label in ("SURE", "UNSURE", "IMPOSTOR"):
        assert sorted(os.listdir(os.path.join(tmp, "port", label))) == \
            sorted(os.listdir(os.path.join(tmp, "jax", label)))


def test_match_face_like_jax(labeled):
    _, _, _, jl, tl, crops = labeled
    face = cv2.cvtColor(cv2.imread(os.path.join(crops, sorted(os.listdir(crops))[0])),
                        cv2.COLOR_BGR2RGB)
    want, got = jl.match_face(face, top_k=3), tl.match_face(face, top_k=3)
    assert got[:2] == want[:2] and got[3] == want[3] and abs(got[2] - want[2]) <= 1e-4
    assert [m["student_id"] for m in got[4]] == [m["student_id"] for m in want[4]]


def test_labeler_refusals_like_jax(labeled, tmp_path):
    _, _, _, jl, tl, _ = labeled
    with pytest.raises(ValueError, match="not found"):
        tl.process_probe_directory(str(tmp_path / "nowhere"))
    (tmp_path / "empty").mkdir()
    (tmp_path / "bad").mkdir()
    (tmp_path / "bad" / "x.png").write_bytes(b"not an image")
    for d in ("empty", "bad"):
        assert tl.process_probe_directory(str(tmp_path / d), copy_files=False) == \
            jl.process_probe_directory(str(tmp_path / d), copy_files=False)


# ------------------------------------------------------------ the whole chain


def test_chain_evaluations_like_jax(corpora):
    """evaluate_model over each package's own corpus (embeddings 1e-4
    apart): equal decisions, scores within 1e-4 (d' and the separation are
    differences over a spread of scores: within 1e-4 plus 1e-3 relative);
    and over one corpus: within 1e-5 (plus 1e-5 relative for d')."""
    _, _, jdir, tdir = corpora
    want = jpipe.evaluate_model(jpipe.load_model_corpus(jdir))
    got = tpipe.evaluate_model(tpipe.load_model_corpus(tdir), device="cpu")
    assert_same(got, want, tol=1e-4, rel=1e-3)
    same = tpipe.evaluate_model(jpipe.load_model_corpus(jdir), device="cpu")
    assert_same(same, want, tol=1e-5, rel=1e-5)


def test_cli_chain_on_the_cpu(tree, weights, tmp_path):
    """dataset_preprocessor -> lfw_impostor_helper -> segment_dataset ->
    embedding_generator -> probe_labeler -> evaluate_models through the
    port's CLIs with --device cpu; the JAX package's evaluate_models on the
    port's corpus writes the same summary."""
    from facerecognitionpipeline_tpu.cli import evaluate_models as jeval
    from facerecognitionpipeline_tpu_torch.cli import (
        dataset_preprocessor,
        embedding_generator,
        evaluate_models,
        probe_labeler,
        segment_dataset,
    )

    det = ["--detector_weights", DETECTOR, "--device", "cpu"]
    prep, out = str(tmp_path / "prep"), str(tmp_path / "out")
    assert dataset_preprocessor.main(["--input_dir", os.path.join(tree, "raw"),
                                      "--output_dir", prep] + det) == 0
    meta = os.path.join(prep, "probe_positive_metadata.json")
    _reviewed_tree(os.path.join(prep, "probe_positive"), meta, out)
    lfw = tmp_path / "lfw" / "Someone"
    lfw.mkdir(parents=True)
    shutil.copy(os.path.join(prep, "probe_positive", sorted(os.listdir(
        os.path.join(prep, "probe_positive")))[0]), lfw / "a.jpg")
    assert tlfw.main(["--lfw_dir", str(tmp_path / "lfw"), "--output_dir",
                      os.path.join(out, "probe_labeled", "negative"), "--seed", "3"]) == 0
    assert segment_dataset.main([
        "--input_dir", os.path.join(out, "probe_labeled", "positive"), "--metadata_file", meta,
        "--output_dir", os.path.join(out, "probe_labeled", "segmented"), "--device",
        "cpu"]) == 0
    assert embedding_generator.main([
        "--dataset_root", os.path.join(tree, "dataset"), "--output_root", out, "--model_type",
        "adaface", "--architecture", "ir_micro", "--model_path", weights] + det) == 0
    emb = os.path.join(out, "embeddings", "adaface_ir_micro")
    with open(os.path.join(emb, "gallery_few-shot_base.pkl"), "rb") as f:
        few = pickle.load(f)
    g = GalleryManager(str(tmp_path / "g.pkl"), verbose=False, device="cpu")
    for i, (name, d) in enumerate(few.items()):
        g.add_student(f"STU{i + 1:04d}", name, d["embeddings"])
    g.save()
    assert probe_labeler.main([
        "--probe_dir", os.path.join(prep, "probe_positive"), "--gallery_path",
        str(tmp_path / "g.pkl"), "--architecture", "ir_micro", "--model_path", weights,
        "--device", "cpu"]) == 0
    with open(os.path.join(prep, "probe_positive_labeled", "labeling_results.json")) as f:
        assert json.load(f)["summary"]["processed"] == len(os.listdir(
            os.path.join(prep, "probe_positive")))
    argv = ["--models", "adaface_ir_micro", "--embeddings_root",
            os.path.join(out, "embeddings"), "--no_plots"]
    assert evaluate_models.main(argv + ["--output_dir", str(tmp_path / "ev_port"),
                                        "--device", "cpu"]) == 0
    assert jeval.main(argv + ["--output_dir", str(tmp_path / "ev_jax")]) == 0
    with open(tmp_path / "ev_port" / "executive_summary.txt") as a, \
            open(tmp_path / "ev_jax" / "executive_summary.txt") as b:
        assert a.read() == b.read()


# ---------------------------------------------------------- helper CLIs


def test_lfw_impostor_helper_like_jax(tmp_path):
    lfw = tmp_path / "lfw"
    rng = np.random.default_rng(1)
    for i in range(9):
        d = lfw / f"Person_{i}"
        d.mkdir(parents=True)
        if i != 4:  # one identity without images
            cv2.imwrite(str(d / f"img{i}.png"), rng.integers(0, 256, (8, 8, 3), np.uint8))
    for n, seed in ((5, 1), (20, 0)):
        a = tlfw.sample_impostors(str(lfw), str(tmp_path / f"t{n}"), n, seed)
        b = jlfw.sample_impostors(str(lfw), str(tmp_path / f"j{n}"), n, seed)
        assert a == b
        for f in sorted(os.listdir(tmp_path / f"j{n}")):
            assert (tmp_path / f"t{n}" / f).read_bytes() == (tmp_path / f"j{n}" / f).read_bytes()
    (tmp_path / "none").mkdir()
    assert tlfw.main(["--lfw_dir", str(tmp_path / "none"), "--output_dir",
                      str(tmp_path / "o")]) == 1


def test_label_rename_utility_like_jax(tmp_path, monkeypatch):
    answers = ["", "i", "Carol", "q"]
    for who, module in (("jax", jrename), ("port", trename)):
        d = tmp_path / who
        d.mkdir()
        for f in ("Ann_01_a.png", "Bob_01_b.png", "Cyd_01_c.png", "Dee_01_d.png", "nolabel.png"):
            (d / f).write_bytes(b"x")
        feed = iter(answers)
        monkeypatch.setattr("builtins.input", lambda prompt="": next(feed))
        assert module.main(["--input_dir", str(d), "--headless"]) == 0
    assert _listing(tmp_path / "port") == _listing(tmp_path / "jax")
    assert os.path.exists(tmp_path / "port" / "corrected" / "Carol_01_c.png")
    assert trename.main(["--input_dir", str(tmp_path / "port" / "corrected" / "x"),
                         "--headless"]) == 1
