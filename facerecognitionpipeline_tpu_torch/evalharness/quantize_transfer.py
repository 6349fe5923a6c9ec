"""The int8 tier's calibration transfer under input shift.

Counterpart of `examples/quantize_calib_transfer.py:37-178` (the JAX
package's sweep, `reports/quantize_transfer/report.json`). The int8
embedder's activation scales are calibrated on clean synthetic renders by
default (`models/quantize.py::default_calibration_faces`); probes are
shifted in brightness, contrast or Gaussian noise, and for each shift:

* cosine(int8 embedding, fp32 embedding) of the same shifted probe with the
  shipped synthetic calibration;
* the same cosine with oracle scales recalibrated on the shifted
  calibration renders themselves (the transfer term apart from int8's
  rounding);
* rank-1 of fp32 and of int8 probes against clean fp32 templates (the mean
  of ENROLL_PER_ID enrolment crops per identity).

Renders and shifts are numpy with the example's draws, rounding and
clipping, so both packages score the same pixels. The module constants are
read at call time, as the example's are.
"""

from __future__ import annotations

import json
import os
import numpy as np

from facerecognitionpipeline_tpu_torch.evalharness.synthetic_demo import EMBEDDER_WEIGHTS
from facerecognitionpipeline_tpu_torch.utils.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
N_IDENTITIES = 16
PROBES_PER_ID = 6
ENROLL_PER_ID = 4
SWEEPS = {
    "brightness": [-60, -30, 0, 30, 60],
    "contrast": [0.4, 0.7, 1.0, 1.3],
    "noise": [0, 10, 20, 40],
}
REPORT_DIR = os.path.join(REPO, "reports", "quantize_transfer_torch")
# tests/test_quantize_transfer.py's bounds: at the worst measured shift
# (contrast 0.7) and on clean inputs, and rank-1 of int8 within 0.1 of fp32
BOUNDS = {"mean": 0.995, "min": 0.97, "rank1_gap": 0.1}


def render_corpus(seed0: int, per_id: int, size: int = 112) -> np.ndarray:
    """[N_IDENTITIES, per_id, size, size, 3] uint8 crops of identities
    1000.. (seed seed0 + i for identity i)."""
    from facerecognitionpipeline_tpu_torch.train.detector_train import (
        make_identity,
        render_identity_crop,
    )

    out = []
    for i in range(N_IDENTITIES):
        ident = make_identity(1000 + i)
        rng = np.random.default_rng(seed0 + i)
        out.append(np.stack([render_identity_crop(ident, rng, size=size)
                             for _ in range(per_id)]))
    return np.stack(out)


def apply_shift(images: np.ndarray, kind: str, level: float, seed: int = 0) -> np.ndarray:
    """Brightness (+level), contrast (about 128 by level) or Gaussian noise
    (sigma level, from seed), rounded and clipped to uint8."""
    x = images.astype(np.float32)
    if kind == "brightness":
        x = x + level
    elif kind == "contrast":
        x = (x - 128.0) * level + 128.0
    elif kind == "noise":
        rng = np.random.default_rng(seed)
        x = x + rng.normal(scale=level, size=x.shape)
    else:
        raise ValueError(kind)
    return np.clip(np.round(x), 0, 255).astype(np.uint8)


def transfer_row(fp32, int8_synth, make_oracle, calib: np.ndarray, probes: np.ndarray,
                 labels: np.ndarray, templates: np.ndarray, kind: str,
                 level: float) -> tuple:
    """One shift level: the example's row. `make_oracle(faces)` builds the
    int8 embedder calibrated on `faces`; `calib` is the clean synthetic
    calibration set (`default_calibration_faces()`), shifted here for the
    oracle. Returns (row, (fp32, int8, oracle embeddings of the shifted
    probes))."""
    shifted = apply_shift(probes, kind, level, seed=7)
    ref = fp32.extract_embeddings_batch(shifted)
    q = int8_synth.extract_embeddings_batch(shifted)
    c_synth = np.sum(ref * q, axis=1)  # rows already unit-norm
    oracle = make_oracle(apply_shift(calib, kind, level, seed=8))
    o = oracle.extract_embeddings_batch(shifted)
    c_oracle = np.sum(ref * o, axis=1)

    def rank1(embs):
        return float((np.argmax(embs @ templates.T, axis=1) == labels).mean())

    return {
        "shift": kind,
        "level": float(level),
        "cosine_synthcal_mean": round(float(c_synth.mean()), 5),
        "cosine_synthcal_min": round(float(c_synth.min()), 5),
        "cosine_oracle_mean": round(float(c_oracle.mean()), 5),
        "transfer_gap": round(float(c_oracle.mean() - c_synth.mean()), 5),
        "rank1_fp32": rank1(ref),
        "rank1_int8": rank1(q),
    }, (ref, q, o)


def run_transfer(arch: str = "ir_micro", weights: str = EMBEDDER_WEIGHTS, device="cuda",
                 out_dir: str = REPORT_DIR) -> dict:
    """The sweep over SWEEPS with the `.npz` weights of `arch`. Returns the
    example's summary (its keys exactly) and writes it to
    out_dir/report.json."""
    from facerecognitionpipeline_tpu_torch.models.quantize import default_calibration_faces
    from facerecognitionpipeline_tpu_torch.pipeline.embedder import FaceEmbedder

    device = resolve_device(device)
    if not os.path.exists(weights):
        raise FileNotFoundError(
            f"weights {weights} not found: run examples/torch_synthetic_end_to_end.py first")
    fp32 = FaceEmbedder(architecture=arch, model_path=weights, device=device)
    # the shipped default: scales calibrated on clean synthetic renders
    int8_synth = FaceEmbedder(architecture=arch, model_path=weights, quantize="int8",
                              device=device)

    def make_oracle(calib):
        return FaceEmbedder(architecture=arch, model_path=weights, quantize="int8",
                            calib_faces=calib, device=device)

    enroll = render_corpus(seed0=77_000, per_id=ENROLL_PER_ID)
    probes = render_corpus(seed0=88_000, per_id=PROBES_PER_ID)
    flat_probes = probes.reshape(-1, *probes.shape[2:])
    labels = np.repeat(np.arange(N_IDENTITIES), PROBES_PER_ID)
    e = fp32.extract_embeddings_batch(enroll.reshape(-1, *enroll.shape[2:]))
    templates = e.reshape(N_IDENTITIES, ENROLL_PER_ID, -1).mean(axis=1)
    templates /= np.linalg.norm(templates, axis=1, keepdims=True)

    calib = default_calibration_faces()
    rows = []
    for kind, levels in SWEEPS.items():
        for lv in levels:
            row, _ = transfer_row(fp32, int8_synth, make_oracle, calib, flat_probes, labels,
                                  templates, kind, lv)
            rows.append(row)
            print(json.dumps(rows[-1]), flush=True)

    worst = min(rows, key=lambda r: r["cosine_synthcal_mean"])
    summary = {
        "arch": arch,
        "weights": os.path.relpath(weights, REPO),
        "n_probes": int(len(flat_probes)),
        "rows": rows,
        "worst_shift": {k: worst[k] for k in ("shift", "level")},
        "worst_cosine_synthcal_mean": worst["cosine_synthcal_mean"],
        "max_transfer_gap": max(r["transfer_gap"] for r in rows),
        "rank1_decisions_changed": any(r["rank1_int8"] != r["rank1_fp32"] for r in rows),
    }
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "report.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(f"\nworst shift: {summary['worst_shift']} "
          f"cos={summary['worst_cosine_synthcal_mean']} "
          f"max transfer gap={summary['max_transfer_gap']} "
          f"rank-1 changed: {summary['rank1_decisions_changed']}", flush=True)
    return summary


def check_bounds(summary: dict) -> list:
    """What `tests/test_quantize_transfer.py` holds the int8 tier to, on the
    sweep's rows: at contrast 0.7 mean cosine >= 0.995 and min >= 0.97; on
    clean inputs (a level that shifts nothing) mean >= 0.995; on every row
    |rank1_int8 - rank1_fp32| <= 0.1. Returns the failures."""
    keys = {(r["shift"], r["level"]) for r in summary["rows"]}
    out = [] if ("contrast", 0.7) in keys else ["no contrast 0.7 row"]
    for r in summary["rows"]:
        tag = f"{r['shift']} {r['level']:g}"
        if (r["shift"], r["level"]) == ("contrast", 0.7):
            if r["cosine_synthcal_mean"] < BOUNDS["mean"]:
                out.append(f"{tag}: mean cosine {r['cosine_synthcal_mean']} < {BOUNDS['mean']}")
            if r["cosine_synthcal_min"] < BOUNDS["min"]:
                out.append(f"{tag}: min cosine {r['cosine_synthcal_min']} < {BOUNDS['min']}")
        clean = r["level"] == (1.0 if r["shift"] == "contrast" else 0.0)
        if clean and r["cosine_synthcal_mean"] < BOUNDS["mean"]:
            out.append(f"{tag} (clean): mean cosine {r['cosine_synthcal_mean']} "
                       f"< {BOUNDS['mean']}")
        if abs(r["rank1_int8"] - r["rank1_fp32"]) > BOUNDS["rank1_gap"] + 1e-12:
            out.append(f"{tag}: rank-1 int8 {r['rank1_int8']} against fp32 {r['rank1_fp32']}")
    return out
