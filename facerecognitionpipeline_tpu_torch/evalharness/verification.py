"""Verification evaluation: genuine vs impostor score distributions.

Counterpart of `facerecognitionpipeline_tpu/evalharness/verification.py`,
the notebook's `evaluate_verification_comprehensive`
(evaluate_models_v2.ipynb cell 7): genuine = positive probe vs its own
identity's gallery (aggregated); impostor = negative probe's best score
against any identity; TAR/FAR/FRR threshold table, ROC-AUC, EER at the
sweep granularity, TAR@FAR{0.1%,1%,10%}, d' (ddof=1 pooled), separation,
bootstrap CIs. Scores come from `identification._score_probes` on `device`.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import pandas as pd

from facerecognitionpipeline_tpu_torch.evalharness.identification import _score_probes
from facerecognitionpipeline_tpu_torch.evalharness.metrics import (
    bootstrap_confidence_interval,
    pack_gallery,
    roc_auc_and_ap,
)


def evaluate_verification_comprehensive(
    gallery_embeddings: Dict[str, Dict],
    probe_positive: Dict[str, Dict],
    probe_negative: Dict[str, Dict],
    thresholds: List[float],
    aggregation: str = "mean",
    k: int = 3,
    device="cuda",
) -> Dict:
    """device: where the probes are scored ('cuda' raises without a card)."""
    probe_pos = probe_positive.get("all", probe_positive)
    probe_neg = probe_negative.get("all", probe_negative) if probe_negative else {}

    names, gallery, mask = pack_gallery(gallery_embeddings, device)
    name_to_idx = {n: i for i, n in enumerate(names)}

    # genuine: positive probes scored only against their own identity
    pos_list, pos_idx = [], []
    for true_name, data in probe_pos.items():
        if true_name not in name_to_idx:
            print(f"    Warning: {true_name} not in gallery, skipping...")
            continue
        for emb in np.atleast_2d(np.asarray(data["embeddings"], np.float32)):
            pos_list.append(emb)
            pos_idx.append(name_to_idx[true_name])
    if not pos_list:
        raise ValueError("No genuine scores collected! Check probe_positive data.")
    pos = np.stack(pos_list)
    pos_scores = _score_probes(pos, gallery, mask, aggregation, k)
    genuine_scores = pos_scores[np.arange(len(pos)), np.asarray(pos_idx)]

    # impostor: best aggregated score vs ANY identity
    neg_list = []
    for data in probe_neg.values():
        embs = np.atleast_2d(np.asarray(data["embeddings"], np.float32))
        if embs.size:
            neg_list.append(embs)
    if not neg_list:
        raise ValueError("No impostor scores collected! Check probe_negative data.")
    neg = np.concatenate(neg_list, axis=0)
    impostor_scores = _score_probes(neg, gallery, mask, aggregation, k).max(axis=1)

    n_g, n_i = len(genuine_scores), len(impostor_scores)
    rows = []
    for threshold in thresholds:
        tp = int((genuine_scores >= threshold).sum())
        fp = int((impostor_scores >= threshold).sum())
        rows.append(
            {
                "threshold": threshold,
                "tar": tp / n_g,
                "far": fp / n_i,
                "frr": (n_g - tp) / n_g,
                "tp": tp,
                "fp": fp,
                "tn": n_i - fp,
                "fn": n_g - tp,
            }
        )
    df = pd.DataFrame(rows)

    y_true = np.concatenate([np.ones(n_g), np.zeros(n_i)])
    y_scores = np.concatenate([genuine_scores, impostor_scores])
    roc_auc, _, fpr, tpr = roc_auc_and_ap(y_true, y_scores)

    eer_idx = (df["far"] - df["frr"]).abs().idxmin()
    eer = (df.loc[eer_idx, "far"] + df.loc[eer_idx, "frr"]) / 2
    eer_threshold = df.loc[eer_idx, "threshold"]

    tar_at_far = {}
    for target in (0.001, 0.01, 0.1):
        idx = (df["far"] - target).abs().idxmin()
        tar_at_far[f"tar_at_far_{target}"] = float(df.loc[idx, "tar"])

    g_mean, i_mean = float(genuine_scores.mean()), float(impostor_scores.mean())
    g_std = float(genuine_scores.std(ddof=1)) if n_g > 1 else 0.0
    i_std = float(impostor_scores.std(ddof=1)) if n_i > 1 else 0.0
    pooled = np.sqrt((g_std ** 2 + i_std ** 2) / 2)
    dprime = (g_mean - i_mean) / pooled if pooled > 0 else 0.0
    separation = abs(g_mean - i_mean) / pooled if pooled > 0 else 0.0

    return {
        "threshold_results": df,
        "roc_auc": roc_auc,
        "dprime": float(dprime),
        "separation": float(separation),
        "eer": float(eer),
        "eer_threshold": float(eer_threshold),
        **tar_at_far,
        "genuine_mean": g_mean,
        "genuine_std": g_std,
        "impostor_mean": i_mean,
        "impostor_std": i_std,
        "genuine_scores": genuine_scores.tolist(),
        "impostor_scores": impostor_scores.tolist(),
        "genuine_ci": bootstrap_confidence_interval(genuine_scores),
        "impostor_ci": bootstrap_confidence_interval(impostor_scores),
        "fpr": fpr,
        "tpr": tpr,
        "aggregation": aggregation,
        "n_genuine_pairs": n_g,
        "n_impostor_pairs": n_i,
    }
