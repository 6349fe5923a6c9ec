"""The detector's training protocol in the port (`train/detector_recipes.py`,
`evalharness/detector_reports.py`, `examples/torch_detector_{stress,ood}
_eval.py`, the `variables` setter of `models/detector.py`) against the JAX
package's examples (`examples/detector_{stress,ood}_eval.py`, loaded from
their files), on the CPU.

* assigning `MTCNNDetector.variables` changes what `detect` computes in
  both packages (each equal to its own detector built with those weights;
  the two within the detection tolerances); the port loads in place, and
  refuses a tree of the other kind (float / int8) where JAX fails at its
  first detect;
* the three scene functions draw bit for bit as the examples' (the two
  mixers restated from their closures, in the same draw order);
* `train_recipe` in three processes equals `train_detector` bit for bit;
* the stress suite at 12 scenes on `mtcnn_synthetic.npz`: every scene the
  port detects otherwise than JAX is a tie at P-net's per-scale top-128 cut
  (the proposal maps agree to float32 rounding, the cut's scores within
  1e-6, and JAX's proposals through the port's stages 2-3 give JAX's
  faces; ROADMAP.md section 3);
* the committed reports `reports/detector_{stress,ood}_torch/report.json`
  have the JAX reports' keys, base rows within one face of them, and
  retrained rows above the floors of `tests/test_detector_ood.py` and
  `tests/test_detector_stress.py` (restated here); the committed weights
  meet the stress floors on the CPU and load in the JAX package;
* the entry points default to `cuda` and raise without it; the scripts
  take the JAX scripts' flags plus `--device`; `chip_smoke.py
  --detector-only` refuses other names.
"""

import dataclasses
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerecognitionpipeline_tpu.evalharness import detection as jdet
from facerecognitionpipeline_tpu.evalharness import detection_ood as jood
from facerecognitionpipeline_tpu.models.detector import MTCNNDetector as JaxDetector
from facerecognitionpipeline_tpu.train import detector_train as jtrain
from facerecognitionpipeline_tpu.utils.io import load_npz_variables as jax_load_npz
from facerecognitionpipeline_tpu_torch.evalharness import detection as tdet
from facerecognitionpipeline_tpu_torch.evalharness import detection_ood as tood
from facerecognitionpipeline_tpu_torch.evalharness import detector_reports
from facerecognitionpipeline_tpu_torch.models.detector import MTCNNDetector
from facerecognitionpipeline_tpu_torch.models.quantize import quantize_detector_variables
from facerecognitionpipeline_tpu_torch.train import detector_recipes as recipes
from facerecognitionpipeline_tpu_torch.train.detector_train import train_detector
from facerecognitionpipeline_tpu_torch.utils.io import load_npz_variables

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTHETIC = os.path.join(REPO, "pretrained", "mtcnn_synthetic.npz")
STRESS = os.path.join(REPO, "pretrained", "mtcnn_stress.npz")
CONFIG = dict(det_size=(320, 320), max_faces=32, min_face_size=18,
              stage_thresholds=(0.6, 0.6, 0.5))
SCORE_TOL = 1e-4  # detection scores between the packages (float32 cascades)


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


JAX_STRESS = _load("detector_stress_eval")
JAX_OOD = _load("detector_ood_eval")


def _faces(faces):
    """A detect() list as (boxes [n, 4] int, scores [n]) in box order, so
    that faces of near-equal score compare in one order."""
    boxes = np.asarray([f["bbox"] for f in faces], np.int64).reshape(-1, 4)
    scores = np.asarray([f["det_score"] for f in faces], np.float64)
    order = np.lexsort(boxes.T[::-1])
    return boxes[order], scores[order]


def _same_faces(a, b) -> bool:
    (ba, sa), (bb, sb) = _faces(a), _faces(b)
    return (len(sa) == len(sb) and np.abs(ba - bb).max(initial=0) <= 1
            and np.abs(sa - sb).max(initial=0) <= SCORE_TOL)


def _scenes(category, n, seed):
    rng = np.random.default_rng(seed)
    return [jdet.render_stress_scene(rng, category, size=320)[0] for _ in range(n)]


@pytest.fixture(scope="module")
def jax_synthetic():
    return JaxDetector(weights_path=SYNTHETIC, **CONFIG)


@pytest.fixture(scope="module")
def port_synthetic():
    return MTCNNDetector(weights_path=SYNTHETIC, device="cpu", **CONFIG)


# ------------------------------------------------------------------- F3


def test_assigning_variables_changes_what_detect_computes():
    """The examples' three lines (`det = make_detector(base); det.variables
    = variables; det.save_npz(...)`) in both packages: each detects as its
    own detector built on the new weights, and the packages agree."""
    scenes = _scenes("occlusion", 2, 4)
    jax_new = jax_load_npz(STRESS)
    got = {}
    for name, make in (("jax", lambda **kw: JaxDetector(**CONFIG, **kw)),
                       ("port", lambda **kw: MTCNNDetector(**CONFIG, device="cpu", **kw))):
        det = make(weights_path=SYNTHETIC)
        before = [det.detect(s) for s in scenes]
        det.variables = jax_new
        after = [det.detect(s) for s in scenes]
        built = make(weights_path=STRESS)
        want = [built.detect(s) for s in scenes]
        for a, w in zip(after, want):
            assert _same_faces(a, w), name
            (ba, sa), (bw, sw) = _faces(a), _faces(w)
            np.testing.assert_array_equal(ba, bw)
            np.testing.assert_array_equal(sa, sw)
        assert not all(_same_faces(b, a) for b, a in zip(before, after)), name
        got[name] = after
    for j, t in zip(got["jax"], got["port"]):
        assert _same_faces(j, t)


def test_the_setter_loads_in_place_and_save_npz_writes_the_new_tree(tmp_path):
    """The nets keep their tensors (a CUDA graph captured over the cascade
    reads the new weights) and their dtype; the bf16 cascade then equals
    one built with `variables=`; save_npz writes the assigned tree."""
    new = load_npz_variables(STRESS)
    det = MTCNNDetector(weights_path=SYNTHETIC, dtype=torch.bfloat16, device="cpu", **CONFIG)
    ptrs = {k: v.data_ptr() for k, v in det.nets.state_dict().items()}
    det.variables = new
    assert {k: v.data_ptr() for k, v in det.nets.state_dict().items()} == ptrs
    assert all(p.dtype == torch.bfloat16 for p in det.nets.parameters())
    built = MTCNNDetector(variables=new, dtype=torch.bfloat16, device="cpu", **CONFIG)
    for k, v in built.nets.state_dict().items():
        torch.testing.assert_close(det.nets.state_dict()[k], v, rtol=0, atol=0)
    frames = torch.from_numpy(np.stack(_scenes("baseline", 2, 0)))
    a, b = det.detect_device(frames), built.detect_device(frames)
    for key in a:
        torch.testing.assert_close(a[key], b[key], rtol=0, atol=0)
    path = str(tmp_path / "w.npz")
    det.save_npz(path)
    saved = load_npz_variables(path)
    for x, y in zip(jax.tree_util.tree_leaves(saved), jax.tree_util.tree_leaves(new)):
        np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def int8_tree(port_synthetic):
    amax = port_synthetic.calibrate_amax(
        np.random.default_rng(0).integers(0, 255, (2, 320, 320, 3)).astype(np.uint8))
    return quantize_detector_variables(load_npz_variables(SYNTHETIC), amax)


def test_an_int8_detector_takes_an_int8_tree_in_place(int8_tree):
    """The int8 R/O-nets' derived buffers (packed weights, 1 / act_scale,
    act_scale * scale) are rewritten in place too, so a CUDA graph captured
    over the int8 cascade reads the new tree; the detector then equals one
    built with `variables=`."""
    stress = MTCNNDetector(weights_path=STRESS, device="cpu", **CONFIG)
    calib = np.random.default_rng(1).integers(0, 255, (2, 320, 320, 3)).astype(np.uint8)
    new = quantize_detector_variables(load_npz_variables(STRESS), stress.calibrate_amax(calib))
    det = MTCNNDetector(variables=int8_tree, quantize="int8", device="cpu", **CONFIG)

    def tensors(d):
        return {**dict(d.nets.named_parameters()), **dict(d.nets.named_buffers())}

    ptrs = {k: v.data_ptr() for k, v in tensors(det).items()}
    assert sum(k.endswith(("gemm_w", "inv_act_scale", "out_scale")) for k in ptrs) == 27
    det.variables = new
    assert {k: v.data_ptr() for k, v in tensors(det).items()} == ptrs
    assert det.variables is new
    built = MTCNNDetector(variables=new, quantize="int8", device="cpu", **CONFIG)
    want = tensors(built)
    assert want.keys() == ptrs.keys()
    for k, v in tensors(det).items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0, msg=k)
    frames = torch.from_numpy(np.stack(_scenes("occlusion", 2, 4)))
    a, b = det.detect_device(frames), built.detect_device(frames)
    for key in a:
        torch.testing.assert_close(a[key], b[key], rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["float_into_int8", "int8_into_float"])
def test_a_tree_of_the_other_kind_is_refused_as_jax_cannot_apply_it(kind, int8_tree):
    """Deliberate difference (ROADMAP.md section 3): JAX takes the
    assignment and fails at its first detect (flax finds no `kernel_q`, or
    no `kernel`); the port refuses at the assignment, naming the
    constructor that takes such a tree."""
    from flax.errors import ScopeParamNotFoundError

    float_tree = load_npz_variables(SYNTHETIC)
    built, assigned, quantize = (
        (int8_tree, float_tree, "int8") if kind == "float_into_int8"
        else (float_tree, int8_tree, None))
    scene = _scenes("baseline", 1, 0)[0]
    jd = JaxDetector(variables=built, quantize=quantize, **CONFIG)
    jd.variables = assigned
    with pytest.raises(ScopeParamNotFoundError):
        jd.detect(scene)
    td = MTCNNDetector(variables=built, quantize=quantize, device="cpu", **CONFIG)
    before = td.detect(scene)
    with pytest.raises(ValueError, match=r"MTCNNDetector\(variables=\.\.\., quantize="):
        td.variables = assigned
    assert td.variables is built
    assert _same_faces(td.detect(scene), before)


# ------------------------------------------------------------- the mixers


def _jax_stress_mixed(rng, pure_negative_p=0.3):
    """examples/detector_stress_eval.py:82-87's closure."""
    if rng.random() < 0.5:
        return jtrain.render_scene(rng)
    return jdet.render_stress_training_scene(rng, pure_negative_p=pure_negative_p)


def _jax_dr_mixed(rng):
    """examples/detector_ood_eval.py:109-117's closure."""
    r = rng.random()
    if r < 0.3:
        return jtrain.render_scene(rng)
    if r < 0.7:
        return jdet.render_stress_training_scene(rng, pure_negative_p=0.3)
    return JAX_OOD.facegen_training_scene(rng)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("mixer", ["stress", "stress_p45", "facegen", "dr"])
def test_scene_functions_draw_as_the_examples(mixer, seed):
    port, want = {
        "stress": (recipes.stress_mixed_scene, _jax_stress_mixed),
        "stress_p45": (lambda r: recipes.stress_mixed_scene(r, pure_negative_p=0.45),
                       lambda r: _jax_stress_mixed(r, pure_negative_p=0.45)),
        "facegen": (recipes.facegen_training_scene, JAX_OOD.facegen_training_scene),
        "dr": (recipes.dr_mixed_scene, _jax_dr_mixed),
    }[mixer]
    ra, rb = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(3):
        a, b = port(ra), want(rb)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert ra.bit_generator.state == rb.bit_generator.state


def test_recipes_are_the_examples_defaults():
    """The recipes' settings: the JAX scripts' flag defaults, their
    `train_detector` call (OHEM 0.7) and its defaults (batch 256, seed 0)."""
    import argparse

    class Parsed(Exception):
        pass

    def capture(self, *args, **kw):
        raise Parsed(self)

    defaults = {}
    for name, script in (("stress", JAX_STRESS), ("dr", JAX_OOD)):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(argparse.ArgumentParser, "parse_args", capture)
            with pytest.raises(Parsed) as caught:
                script.main()
        defaults[name] = {a.dest: a.default for a in caught.value.args[0]._actions}
    for recipe, name in ((recipes.STRESS_RECIPE, "stress"), (recipes.DR_RECIPE, "dr")):
        d = defaults[name]
        balance = d["class_balance"] and tuple(float(x) for x in d["class_balance"].split(","))
        assert (recipe.steps, recipe.class_balance) == (d["steps"], balance)
        assert (recipe.batch, recipe.seed, recipe.ohem_fraction) == (256, 0, 0.7)
    assert recipes.STRESS_RECIPE.scene_fn.keywords == {
        "pure_negative_p": defaults["stress"]["pure_negative_p"]}


# ---------------------------------------------------- training in processes


@pytest.mark.parametrize("recipe", [recipes.STRESS_RECIPE, recipes.DR_RECIPE],
                         ids=["stress", "dr"])
def test_train_recipe_in_processes_is_train_detector(recipe):
    small = dataclasses.replace(recipe, steps=3, batch=16)
    history, seconds = {}, {}
    got = recipes.train_recipe(small, device="cpu", processes=3, history=history,
                               seconds=seconds)
    want_history: dict = {}
    want = train_detector(small.steps, small.batch, small.seed, small.scene_fn,
                          ohem_fraction=small.ohem_fraction,
                          class_balance=small.class_balance, device="cpu",
                          history=want_history)
    assert list(got) == list(want) == ["pnet", "rnet", "onet"]
    leaves = jax.tree_util.tree_leaves_with_path
    assert [p for p, _ in leaves(got)] == [p for p, _ in leaves(want)]
    for (_, a), (_, b) in zip(leaves(got), leaves(want)):
        np.testing.assert_array_equal(a, b)
    assert history == want_history
    assert set(seconds) == {"pnet", "rnet", "onet"}


# ------------------------------------------- the stress suite at full size


_JAX_PARTS = JaxDetector(weights_path=SYNTHETIC, **CONFIG)


@jax.jit
def _jax_pnet_maps(variables, frame):
    """JAX's P-net maps (prob, reg) of every pyramid scale of one frame."""
    img = (frame - 127.5) / 128.0
    return [_JAX_PARTS.pnet.apply(variables["pnet"], level[None])
            for level in _JAX_PARTS._pyramid(img)]


def _rank_cut_ties(jd, td, scene, gt) -> list:
    """The checks that class a scene the packages detect differently as
    rounding at P-net's per-scale top-128 cut. At every pyramid scale,
    P-net's maps agree to float32 rounding, and where the two top-128 sets
    differ, every cell in one set only scores within 1e-6 of the 128th
    score. With JAX's maps in place of its own P-net's, the port finds as
    many faces as JAX, as many of them true, at the same scores (a lattice
    of near-equal candidates on one distractor may keep another of its
    boxes). Returns the scales where the sets differ, with each such cell's
    two scores."""
    frame = scene.astype(np.float32)  # 320 x 320: detect's letterbox is the frame
    maps = [(torch.from_numpy(np.array(p)), torch.from_numpy(np.array(r)))
            for p, r in _jax_pnet_maps(jd.variables, jnp.asarray(frame))]
    ti = (torch.from_numpy(frame)[None] - 127.5) / 128.0
    ties = []
    with torch.inference_mode():
        for s, ((pj, _), level) in enumerate(zip(maps, td._pyramid(ti))):
            pj = pj.numpy().ravel()
            pt = td.nets.pnet(level)[0][0].numpy().ravel()
            np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-6)
            k = min(128, pj.size)
            kj = set(np.asarray(jax.lax.top_k(jnp.asarray(pj), k)[1]).tolist())
            kt = set(torch.topk(torch.from_numpy(pt), k)[1].tolist())
            if kj != kt:
                cut = np.sort(pj)[::-1][k - 1]
                cells = sorted(kj ^ kt)
                assert all(abs(pj[c] - cut) <= 1e-6 for c in cells), (s, cut, pj[cells])
                ties.append((s, [(c, float(pj[c]), float(pt[c])) for c in cells]))
    replay = iter(maps)
    td.nets.pnet.forward = lambda x: next(replay)
    try:
        got = td.detect(scene)
    finally:
        del td.nets.pnet.forward
    want = jd.detect(scene)
    (gb, gs), (wb, ws) = _faces(got), _faces(want)
    assert len(gs) == len(ws)
    np.testing.assert_allclose(np.sort(gs), np.sort(ws), rtol=0, atol=SCORE_TOL)
    true_faces = [int(tdet.match_detections(b.astype(np.float32), sc.astype(np.float32), gt)[1]
                      .sum()) for b, sc in ((gb, gs), (wb, ws))]
    assert true_faces[0] == true_faces[1]
    return ties


@pytest.mark.parametrize("category", ["nonface_distractors", "crowded", "occlusion"])
def test_stress_suite_at_full_size_differs_only_at_rank_cut_ties(category, jax_synthetic,
                                                                port_synthetic):
    """The report's 12 scenes of `category` (its seed in the suite) through
    both float32 cascades on mtcnn_synthetic.npz. A scene that differs must
    be a tie at P-net's top-128 cut of a scale (`_rank_cut_ties`). ROADMAP.md
    section 3 records the one such scene of nonface_distractors (scene 11:
    JAX 0.7375529 against the port's 0.73755276 at the cut of scale 1),
    which moves that category from 4.0 to 4.083 false positives a scene."""
    seed = tdet.STRESS_CATEGORIES.index(category)
    assert seed == jdet.STRESS_CATEGORIES.index(category)
    differing = []
    rng = np.random.default_rng(seed)
    for i in range(12):
        scene, gt = jdet.render_stress_scene(rng, category, size=320)
        if _same_faces(jax_synthetic.detect(scene), port_synthetic.detect(scene)):
            continue
        ties = _rank_cut_ties(jax_synthetic, port_synthetic, scene, gt)
        assert ties, f"scene {i} differs with no tie at a top-128 cut"
        differing.append(i)
    assert len(differing) <= 1, differing


# ------------------------------------------------------- committed reports

OOD_FLOORS = {  # tests/test_detector_ood.py:44-55 (dr_retrained_ood AP)
    "facegen": 0.85, "facegen_crowded": 0.8, "facegen_accessories": 0.6,
    "facegen+jpeg": 0.85, "facegen+defocus": 0.7, "facegen+banding": 0.6,
    "facegen+lowlight": 0.3,
}
# tests/test_detector_stress.py:112-181 on the stress weights: (category,
# recall floor, AP floor, precision floor, fp/img ceiling)
STRESS_FLOORS = (
    ("occlusion", 0.85, 0.85, None, None),
    ("hard_negatives", None, None, None, 1.2),
    ("nonface_distractors", 0.85, 0.85, 0.75, 3.0),
    ("domain_shift", 0.85, 0.85, None, 1.0),
    ("motion_blur", 0.80, 0.80, None, 1.0),
)
PAIRS = (("detector_stress_torch", "detector_stress"), ("detector_ood_torch", "detector_ood"))


def _report(name):
    path = os.path.join(REPO, "reports", name, "report.json")
    if not os.path.exists(path):
        pytest.skip(f"{path} not generated (chip_smoke.py --detector-only)")
    with open(path) as f:
        return json.load(f)


@pytest.mark.parametrize("port,jax_name", PAIRS, ids=["stress", "ood"])
def test_report_keys_are_the_jax_reports(port, jax_name):
    got, want = _report(port), _report(jax_name)
    assert list(got) == list(want)
    for row in want:
        assert list(got[row]) == list(want[row]), row
        assert list(got[row]["summary"]) == list(want[row]["summary"]), row
        for cat, detail in want[row]["detail"].items():
            assert list(got[row]["detail"][cat]) == list(detail), (row, cat)
            assert got[row]["detail"][cat]["n_images"] == detail["n_images"] == 12
        for cat, summary in want[row]["summary"].items():
            assert list(got[row]["summary"][cat]) == list(summary), (row, cat)


def test_report_weights_are_the_ports_and_the_jax_bases():
    stress, ood = _report("detector_stress_torch"), _report("detector_ood_torch")
    assert stress["base"]["weights"] == "pretrained/mtcnn_synthetic.npz"
    assert stress["stress_retrained"]["weights"] == "pretrained/mtcnn_stress_torch.npz"
    assert ood["base"]["weights"] == _report("detector_ood")["base"]["weights"]
    assert (ood["base"]["held_out"], ood["dr_retrained_ood"]["held_out"]) == (True, False)
    for row in ("dr_retrained_ood", "dr_retrained_stress"):
        assert ood[row]["weights"] == "pretrained/mtcnn_dr_torch.npz"


@pytest.mark.parametrize("port,jax_name", PAIRS, ids=["stress", "ood"])
def test_report_base_rows_within_one_face_of_the_jax_reports(port, jax_name):
    """The base cascades are the JAX package's own files: the port on the
    card must count as the TPU did, within 0.03 in AP and recall and 3
    false positives in 12 scenes (0.25 a scene). Where chip_smoke.py's
    JAX_CPU_BASE holds the category, the limits hold against JAX on the
    CPU instead (test_base_rows_held_to_jax_on_the_cpu_are_its_rows)."""
    import chip_smoke

    name = "stress" if port == "detector_stress_torch" else "ood"
    got, want = _report(port)["base"], _report(jax_name)["base"]
    for cat, w in want["summary"].items():
        g = got["summary"][cat]
        ref = chip_smoke.JAX_CPU_BASE.get((name, cat), w)
        assert got["detail"][cat]["n_gt_faces"] == want["detail"][cat]["n_gt_faces"]
        for key, tol in chip_smoke.DETECTOR_TOL.items():
            assert (g[key] is None) == (w[key] is None), (cat, key)
            if w[key] is not None:
                assert abs(g[key] - ref[key]) <= tol + 1e-9, (cat, key, g, ref)
    assert chip_smoke.DETECTOR_TOL == {"ap": 0.03, "recall": 0.03, "fp_per_image": 0.25}


def test_base_rows_held_to_jax_on_the_cpu_are_its_rows():
    """chip_smoke.py's JAX_CPU_BASE: the base categories whose JAX report (a
    TPU's) is more than 0.03 from the JAX package's float32 cascade on the
    CPU. At the report's 12 scenes and seed, JAX on the CPU gives the
    pinned row, the port on the CPU gives the same detections, and the JAX
    report is farther than the limit from it."""
    import chip_smoke

    want = _report("detector_ood")["base"]
    weights = os.path.join(REPO, want["weights"])
    assert list(chip_smoke.JAX_CPU_BASE) == [("ood", "facegen+jpeg")]
    for (_, category), pinned in chip_smoke.JAX_CPU_BASE.items():
        seed = 100 * jood.OOD_CATEGORIES.index(category)  # run_ood_suite's, from seed 0
        assert seed == 100 * tood.OOD_CATEGORIES.index(category)
        rows = [
            jood.evaluate_detector_ood_category(JaxDetector(weights_path=weights, **CONFIG),
                                                category, n_scenes=12, seed=seed),
            tood.evaluate_detector_ood_category(
                MTCNNDetector(weights_path=weights, device="cpu", **CONFIG),
                category, n_scenes=12, seed=seed),
        ]
        assert rows[0] == rows[1]
        op = rows[0]["operating_point"]
        assert {"ap": rows[0]["ap"], "recall": op["recall"],
                "fp_per_image": op["false_positives_per_image"]} == pinned
        w = want["summary"][category]
        assert any(abs(w[k] - pinned[k]) > tol for k, tol in chip_smoke.DETECTOR_TOL.items())


@pytest.mark.parametrize("category", sorted(OOD_FLOORS))
def test_report_dr_retrained_ood_meets_the_floors(category):
    ood = _report("detector_ood_torch")
    dr, base = ood["dr_retrained_ood"]["summary"], ood["base"]["summary"]
    assert dr[category]["ap"] >= OOD_FLOORS[category], dr[category]
    if base[category]["ap"] is not None:
        assert dr[category]["ap"] >= base[category]["ap"] - 0.05, (dr[category], base[category])


def test_report_dr_retrained_stress_has_no_collapse():
    """tests/test_detector_ood.py:58-80 on the port's row."""
    s = _report("detector_ood_torch")["dr_retrained_stress"]["summary"]
    for cat in ("baseline", "tiny", "huge", "rotated", "low_contrast", "noisy",
                "domain_shift"):
        assert s[cat]["ap"] >= 0.9, (cat, s[cat])
    assert s["crowded"]["ap"] >= 0.85
    assert s["motion_blur"]["ap"] >= 0.85
    assert s["occlusion"]["ap"] >= 0.7
    assert s["hard_negatives"]["fp_per_image"] <= 1.0


def _meets(op_or_summary, category, recall, ap, precision, max_fp, ap_value):
    r = op_or_summary
    if recall is not None:
        assert r["recall"] >= recall, (category, r)
        assert ap_value >= ap, (category, ap_value)
    if precision is not None:
        assert r["precision"] >= precision, (category, r)
    if max_fp is not None:
        fp = r.get("fp_per_image", r.get("false_positives_per_image"))
        assert fp <= max_fp, (category, r)


@pytest.mark.parametrize("floors", STRESS_FLOORS, ids=[f[0] for f in STRESS_FLOORS])
def test_report_stress_retrained_meets_the_stress_floors(floors):
    s = _report("detector_stress_torch")["stress_retrained"]["summary"][floors[0]]
    _meets(s, *floors, s["ap"])


def test_report_meta_records_the_run():
    for name, recipe in (("mtcnn_stress_torch", "stress"), ("mtcnn_dr_torch", "dr")):
        path = os.path.join(REPO, "pretrained", f"{name}.meta.json")
        if not os.path.exists(path):
            pytest.skip(f"{path} not generated (chip_smoke.py --detector-only)")
        with open(path) as f:
            meta = json.load(f)
        want = {"stress": recipes.STRESS_RECIPE, "dr": recipes.DR_RECIPE}[recipe]
        assert meta["recipe"]["name"] == recipe
        assert meta["recipe"]["steps"] == want.steps
        assert meta["device"].startswith("cuda")
        assert "H100" in meta["card"] and meta["cpu_count"] >= 1
        assert set(meta["seconds_per_net"]) == {"pnet", "rnet", "onet"}
        for net in ("pnet", "rnet", "onet"):
            first, last = meta["losses_first20"][net], meta["losses_last20"][net]
            assert len(first) == len(last) == 20
            assert np.mean(last) < np.mean(first), net


# ----------------------------------------------------- committed weights

STRESS_TORCH = os.path.join(REPO, "pretrained", "mtcnn_stress_torch.npz")
DR_TORCH = os.path.join(REPO, "pretrained", "mtcnn_dr_torch.npz")


def _weights(path):
    if not os.path.exists(path):
        pytest.skip(f"{path} not generated (chip_smoke.py --detector-only)")
    return path


@pytest.fixture(scope="module")
def port_stress_torch():
    return MTCNNDetector(weights_path=_weights(STRESS_TORCH), device="cpu", **CONFIG)


@pytest.mark.parametrize("floors", STRESS_FLOORS, ids=[f[0] for f in STRESS_FLOORS])
def test_committed_stress_weights_meet_the_floors_on_the_cpu(floors, port_stress_torch):
    """tests/test_detector_stress.py's own check (5 scenes, seed 1,
    operating threshold 0.5) of the port's stress weights, on the CPU."""
    r = tdet.evaluate_detector_category(port_stress_torch, floors[0], n_scenes=5, seed=1,
                                        operating_threshold=0.5)
    _meets(r["operating_point"], *floors, r["ap"])


@pytest.mark.parametrize("path", [STRESS_TORCH, DR_TORCH], ids=["stress", "dr"])
def test_committed_weights_load_in_the_jax_package(path):
    jd = JaxDetector(weights_path=_weights(path), **CONFIG)
    td = MTCNNDetector(weights_path=path, device="cpu", **CONFIG)
    for scene in _scenes("baseline", 2, 0):
        assert _same_faces(jd.detect(scene), td.detect(scene))


# ----------------------------------------------------------- entry points


@pytest.mark.parametrize("entry", ["train", "stress", "ood"])
def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = {
        "train": lambda: recipes.train_recipe(dataclasses.replace(recipes.DR_RECIPE, steps=1)),
        "stress": lambda: detector_reports.run_stress_report(n_scenes=1),
        "ood": lambda: detector_reports.run_ood_report(n_scenes=1),
    }[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()


def _flags(parser) -> dict:
    return {a.dest: (a.option_strings, a.default, a.type, a.nargs)
            for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("script,jax_script", [
    ("torch_detector_stress_eval", JAX_STRESS), ("torch_detector_ood_eval", JAX_OOD)])
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
    # the port's reports go beside the JAX package's, never over them
    jax_dir, port_dir = want.pop("output_dir")[1], got.pop("output_dir")[1]
    assert port_dir == jax_dir + "_torch"
    assert got == want


@pytest.mark.parametrize("script", ["torch_detector_stress_eval", "torch_detector_ood_eval"])
def test_scripts_retrain_and_report_on_the_cpu(monkeypatch, tmp_path, script):
    """The scripts end to end with --device cpu at 2 steps a net and one
    scene a category: the report's rows and keys, the weights with their
    .meta.json at the module's path (here a temporary one)."""
    out = str(tmp_path / "w.npz")
    monkeypatch.setattr(detector_reports, "STRESS_WEIGHTS", out)
    monkeypatch.setattr(detector_reports, "DR_WEIGHTS", out)
    report_dir = tmp_path / "report"
    argv = ["--retrain", "--steps", "2", "--n_scenes", "1", "--output_dir", str(report_dir),
            "--device", "cpu"]
    assert _load(script).main(argv) == 0
    with open(report_dir / "report.json") as f:
        report = json.load(f)
    rows = {"torch_detector_stress_eval": ["base", "stress_retrained"],
            "torch_detector_ood_eval": ["base", "dr_retrained_ood", "dr_retrained_stress"]}
    assert list(report) == rows[script]
    assert report[rows[script][1]]["weights"] == os.path.relpath(out, REPO)
    with open(out.replace(".npz", ".meta.json")) as f:
        meta = json.load(f)
    assert meta["recipe"]["steps"] == 2 and meta["device"] == "cpu"
    assert meta["seconds_per_net"].keys() == {"pnet", "rnet", "onet"}
    MTCNNDetector(weights_path=out, device="cpu", **CONFIG)


@pytest.mark.parametrize("name", ["dr", "both"])
def test_chip_smoke_detector_only_refuses_other_names(monkeypatch, capsys, name):
    """`chip_smoke.py --detector-only` takes stress, ood or all (all when
    nothing follows); any other name is refused before the build."""
    import sys

    import chip_smoke
    from facerecognitionpipeline_tpu_torch.ops import cuda_build
    from facerecognitionpipeline_tpu_torch.utils import device

    def no_build():
        raise AssertionError("the kernels were built")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(device, "resolve_device", lambda d: torch.device("cpu"))
    monkeypatch.setattr(cuda_build, "build_all", no_build)
    monkeypatch.setattr(sys, "argv", ["chip_smoke.py", "--detector-only", name])
    assert chip_smoke.main() == 2
    assert f"not {name!r}" in capsys.readouterr().err
