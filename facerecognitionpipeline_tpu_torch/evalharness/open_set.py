"""Open-set recognition evaluation on held-out identities.

Counterpart of `examples/open_set_eval.py:50-303` (the JAX package's
example): the protocol that scores a backbone trained by
`train/open_set.py` on identities it has never seen.

* gallery: N_GALLERY held-out identities enrolled from ENROLL_PER_ID crops;
* known probes: PROBES_PER_ID fresh crops per enrolled identity;
* unknown probes: N_UNKNOWN further held-out identities (the open set);
* conditions: clean and five photometric or occlusion corruptions;
* protocols: closed-set identification (rank-1/5, MRR), verification (EER,
  TAR at FAR 0.1%/1%/10%, ROC-AUC, d'), impostor rejection at 0.5, and
  open-set DIR at FAR (thresholds from the unknown probes' best scores);
* tiers: fp32 and int8 (post-training quantization calibrated on the
  enrolment crops).

Identity seeds start at HELD_OUT_OFFSET, disjoint from the training seeds
0..n_ids-1 by construction. The functions read the module constants when
they are called, as the example's do. Crops are rendered and corrupted on
the host (numpy, cv2) with the example's draws in the example's order, so
both packages score the same pixels; embedding runs on the embedder's
device, scoring (`evalharness.identification`, `.verification`) on the
same device.
"""

from __future__ import annotations

import json
import os

import numpy as np

from facerecognitionpipeline_tpu_torch.evalharness.identification import (
    evaluate_impostors_comprehensive,
    evaluate_probes_comprehensive,
)
from facerecognitionpipeline_tpu_torch.evalharness.verification import (
    evaluate_verification_comprehensive,
)
from facerecognitionpipeline_tpu_torch.train.facegen import render_crop, sample_identity
from facerecognitionpipeline_tpu_torch.train.open_set import HELD_OUT_OFFSET
from facerecognitionpipeline_tpu_torch.utils.device import resolve_device

N_GALLERY = 200
N_UNKNOWN = 60
ENROLL_PER_ID = 4
PROBES_PER_ID = 10
THRESHOLDS = [round(t, 2) for t in np.arange(0.0, 0.951, 0.05)]
CONDITIONS = ("clean", "blur", "lowlight", "noise", "occlusion", "jpeg")


# ---------------------------------------------------------------- renders


def corrupt(images: np.ndarray, mode: str, rng: np.random.Generator) -> np.ndarray:
    """Photometric/occlusion batteries over uint8 RGB crops [N, H, W, 3]."""
    import cv2

    out = images.copy()
    if mode == "clean":
        return out
    for i in range(len(out)):
        img = out[i]
        if mode == "blur":
            out[i] = cv2.GaussianBlur(img, (9, 9), 2.5)
        elif mode == "lowlight":
            dark = img.astype(np.float32) * rng.uniform(0.25, 0.4)
            dark += rng.normal(0, 10, img.shape)
            out[i] = np.clip(dark, 0, 255).astype(np.uint8)
        elif mode == "noise":
            noisy = img.astype(np.float32) + rng.normal(0, 25, img.shape)
            out[i] = np.clip(noisy, 0, 255).astype(np.uint8)
        elif mode == "occlusion":
            h, w = img.shape[:2]
            ph, pw = int(h * 0.38), int(w * 0.38)
            y = int(rng.integers(0, h - ph))
            x = int(rng.integers(0, w - pw))
            patch = rng.integers(0, 255, size=3)
            img2 = img.copy()
            img2[y:y + ph, x:x + pw] = patch
            out[i] = img2
        elif mode == "jpeg":
            # cv2 codes BGR: round-trip through it and back to RGB
            ok, enc = cv2.imencode(
                ".jpg", img[:, :, ::-1], [int(cv2.IMWRITE_JPEG_QUALITY), 12],
            )
            if ok:
                out[i] = cv2.imdecode(enc, cv2.IMREAD_COLOR)[:, :, ::-1]
        else:
            raise ValueError(f"unknown corruption mode {mode!r}")
    return out


def render_sets(seed: int = 7):
    """(enroll [G,E,112,112,3], known probes [G,P,...], unknown probes
    [U,P,...]), all uint8 RGB, identities disjoint from training; one rng
    drawn in that order."""
    rng = np.random.default_rng(seed)
    gallery_ids = [sample_identity(HELD_OUT_OFFSET + i) for i in range(N_GALLERY)]
    unknown_ids = [sample_identity(HELD_OUT_OFFSET + N_GALLERY + i) for i in range(N_UNKNOWN)]
    enroll = np.stack([
        np.stack([render_crop(ident, rng) for _ in range(ENROLL_PER_ID)])
        for ident in gallery_ids
    ])
    known = np.stack([
        np.stack([render_crop(ident, rng) for _ in range(PROBES_PER_ID)])
        for ident in gallery_ids
    ])
    unknown = np.stack([
        np.stack([render_crop(ident, rng) for _ in range(PROBES_PER_ID)])
        for ident in unknown_ids
    ])
    return enroll, known, unknown


# ---------------------------------------------------------------- scoring


def embed_sets(embedder, crops: np.ndarray) -> np.ndarray:
    """[N, K, 112, 112, 3] uint8 -> [N, K, 512] unit float32."""
    n, k = crops.shape[:2]
    flat = crops.reshape(n * k, *crops.shape[2:])
    embs = embedder.extract_embeddings_batch(list(flat))
    return np.asarray(embs, np.float32).reshape(n, k, -1)


def corpus_dict(embs: np.ndarray, prefix: str) -> dict:
    return {f"{prefix}{i:03d}": {"embeddings": embs[i]} for i in range(len(embs))}


def open_set_dir_far(
    gallery_mat: np.ndarray,
    known: np.ndarray,
    known_label: np.ndarray,
    unknown: np.ndarray,
    fars=(0.01, 0.05, 0.1),
) -> dict:
    """Detection-and-identification rate at thresholds set so that the
    UNKNOWN probes' accept rate equals each target FAR (an accepted unknown
    is a false alarm whatever its best match)."""
    known_scores = known @ gallery_mat.T          # [P, G]
    unknown_scores = unknown @ gallery_mat.T      # [Q, G]
    k_best = known_scores.max(axis=1)
    k_pred = known_scores.argmax(axis=1)
    u_best = unknown_scores.max(axis=1)
    correct = k_pred == known_label
    out = {}
    for far in fars:
        tau = float(np.quantile(u_best, 1 - far))
        dir_rate = float(((k_best >= tau) & correct).mean())
        out[f"dir_at_far_{far}"] = round(dir_rate, 4)
        out[f"tau_at_far_{far}"] = round(tau, 4)
    out["unknown_mean_best"] = round(float(u_best.mean()), 4)
    out["known_mean_best"] = round(float(k_best.mean()), 4)
    return out


def evaluate_tier(embedder, enroll, known, unknown, conditions, seed=11):
    """All metrics of one embedder tier across corruption conditions. One
    rng corrupts the known then the unknown probes of each condition in
    turn; scoring runs on the embedder's device."""
    device = embedder.device
    rng = np.random.default_rng(seed)
    enroll_embs = embed_sets(embedder, enroll)       # [G, E, 512]
    gallery = corpus_dict(enroll_embs, "ID")
    gallery_mean = enroll_embs.mean(axis=1)
    gallery_mean /= np.linalg.norm(gallery_mean, axis=1, keepdims=True) + 1e-9

    results = {}
    for mode in conditions:
        kc = corrupt(known.reshape(-1, *known.shape[2:]), mode, rng)
        uc = corrupt(unknown.reshape(-1, *unknown.shape[2:]), mode, rng)
        ke = embed_sets(embedder, kc.reshape(known.shape))
        ue = embed_sets(embedder, uc.reshape(unknown.shape))

        probes = corpus_dict(ke, "ID")
        negatives = corpus_dict(ue, "UNK")
        ident = evaluate_probes_comprehensive(
            gallery, probes, THRESHOLDS, aggregation="mean", device=device)
        ver = evaluate_verification_comprehensive(
            gallery, probes, negatives, THRESHOLDS, aggregation="mean", device=device)
        rej = evaluate_impostors_comprehensive(
            gallery, negatives, THRESHOLDS, aggregation="mean", device=device)
        df = ident["threshold_results"]
        rej_df = rej["threshold_results"]
        osr = open_set_dir_far(
            gallery_mean, ke.reshape(-1, ke.shape[-1]),
            np.repeat(np.arange(len(ke)), ke.shape[1]), ue.reshape(-1, ue.shape[-1]),
        )
        results[mode] = {
            "rank1": round(float(df["rank1_accuracy"].iloc[0]), 4),
            "rank5": round(float(df["rank5_accuracy"].iloc[0]), 4),
            "mrr": round(float(df["mrr"].iloc[0]), 4),
            "roc_auc": round(float(ver["roc_auc"]), 4),
            "eer": round(float(ver["eer"]), 4),
            "tar_at_far_0.001": round(float(ver["tar_at_far_0.001"]), 4),
            "tar_at_far_0.01": round(float(ver["tar_at_far_0.01"]), 4),
            "tar_at_far_0.1": round(float(ver["tar_at_far_0.1"]), 4),
            "dprime": round(float(ver["dprime"]), 4),
            "genuine_mean": round(float(ver["genuine_mean"]), 4),
            "impostor_mean": round(float(ver["impostor_mean"]), 4),
            "impostor_rejection_at_tau": round(float(
                rej_df.loc[rej_df["threshold"] == 0.5, "rejection_rate"].iloc[0]), 4),
            **osr,
        }
        print(f"    {mode}: rank1 {results[mode]['rank1']:.3f} "
              f"EER {results[mode]['eer']:.3f} "
              f"DIR@FAR1% {results[mode]['dir_at_far_0.01']:.3f}", flush=True)
    return results


def run_open_set(architecture: str, weights: str, conditions=CONDITIONS,
                 skip_int8: bool = False, device="cuda") -> dict:
    """The whole protocol on one backbone's `.npz` weights: render the
    held-out sets, the fp32 tier, then (unless `skip_int8`) the int8 tier
    calibrated on the first 256 enrolment crops and the int8 embeddings'
    cosine to the fp32 ones over the first 128 known probes. Returns the
    report (the example's `report.json` schema)."""
    from facerecognitionpipeline_tpu_torch.pipeline.embedder import FaceEmbedder

    device = resolve_device(device)  # before the renders: no card, no work
    conditions = list(conditions)
    print(f"Rendering held-out sets: {N_GALLERY} gallery + {N_UNKNOWN} "
          f"unknown identities ...", flush=True)
    enroll, known, unknown = render_sets()

    print(f"fp32 tier ({architecture}, {weights}):", flush=True)
    embedder = FaceEmbedder(architecture=architecture, model_path=weights, device=device)
    fp32 = evaluate_tier(embedder, enroll, known, unknown, conditions)
    report = {
        "architecture": architecture,
        "weights": weights,
        "protocol": {
            "n_gallery_identities": N_GALLERY,
            "n_unknown_identities": N_UNKNOWN,
            "enroll_per_id": ENROLL_PER_ID,
            "probes_per_id": PROBES_PER_ID,
            "held_out": "identity seeds disjoint from training by "
                        "construction (facegen id_offset)",
        },
        "fp32": fp32,
    }
    if skip_int8:
        return report

    print("int8 tier (calibrated on enrollment crops):", flush=True)
    calib = enroll.reshape(-1, *enroll.shape[2:])[:256]
    embedder_q = FaceEmbedder(architecture=architecture, model_path=weights,
                              quantize="int8", calib_faces=calib, device=device)
    report["int8"] = evaluate_tier(embedder_q, enroll, known, unknown, conditions)
    probe_flat = known.reshape(-1, *known.shape[2:])[:128]
    f32e = embedder.extract_embeddings_batch(list(probe_flat))
    qe = embedder_q.extract_embeddings_batch(list(probe_flat))
    cos = np.sum(np.asarray(f32e) * np.asarray(qe), axis=1)
    report["int8_drift_cosine"] = {
        "mean": round(float(cos.mean()), 5),
        "min": round(float(cos.min()), 5),
    }
    return report


def write_report(report: dict, out_dir: str) -> str:
    """`report` as out_dir/report.json (the example's layout); returns the
    path."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "report.json")
    with open(path, "w") as f:
        json.dump(report, f, indent=2)
    return path
