"""Identification / impostor-rejection / segmented evaluation.

Counterpart of `facerecognitionpipeline_tpu/evalharness/identification.py`,
with the reference's result schemas (`evaluate_probes_comprehensive`
temp.py:19-152, `evaluate_impostors_comprehensive` temp.py:155-201,
`evaluate_segmented_comprehensive` temp.py:204-225): threshold tables with
rank-k/MRR/TAR/FAR/FRR/precision/recall/F1, ROC-AUC, AP, d',
genuine/impostor score lists + bootstrap CIs. Scoring is one masked einsum
per chunk of 4096 probes on `device` (`metrics.identity_scores_batch`); the
threshold sweep is vectorized on the host.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import pandas as pd
import torch

from facerecognitionpipeline_tpu_torch.evalharness.metrics import (
    bootstrap_confidence_interval,
    compute_dprime,
    compute_rank_metrics_batch,
    identity_scores_batch,
    pack_gallery,
    roc_auc_and_ap,
)

_CHUNK = 4096  # probes per device call


def _score_probes(
    probe_matrix: np.ndarray, gallery, mask, aggregation: str, k: int
) -> np.ndarray:
    """[P,512] host array -> [P,I] float32 host array, scored in chunks of
    `_CHUNK` probes on the packed gallery's device."""
    outs = []
    for start in range(0, len(probe_matrix), _CHUNK):
        chunk = torch.from_numpy(
            np.ascontiguousarray(probe_matrix[start : start + _CHUNK], np.float32)
        ).to(gallery.device)
        outs.append(
            identity_scores_batch(chunk, gallery, mask, aggregation, k).cpu().numpy()
        )
    return np.concatenate(outs, axis=0)


def evaluate_probes_comprehensive(
    gallery_embeddings: Dict[str, Dict],
    probe_embeddings: Dict[str, Dict],
    thresholds: List[float],
    aggregation: str = "mean",
    k: int = 3,
    device="cuda",
) -> Dict:
    """device: where the probes are scored ('cuda' raises without a card)."""
    probe_data = probe_embeddings.get("all", probe_embeddings)
    names, gallery, mask = pack_gallery(gallery_embeddings, device)
    name_to_idx = {n: i for i, n in enumerate(names)}

    probe_list, true_names = [], []
    for true_name, data in probe_data.items():
        for emb in np.atleast_2d(np.asarray(data["embeddings"], np.float32)):
            probe_list.append(emb)
            true_names.append(true_name)
    if not probe_list:
        raise ValueError("No probe embeddings provided")

    probes = np.stack(probe_list)
    scores = _score_probes(probes, gallery, mask, aggregation, k)  # [P, I]
    true_idx = np.array([name_to_idx.get(n, -1) for n in true_names])

    pred_idx = scores.argmax(axis=1)
    best_scores = scores.max(axis=1)
    pred_correct = pred_idx == true_idx

    rank = compute_rank_metrics_batch(scores, true_idx)

    enrolled = true_idx >= 0
    genuine_scores = scores[np.arange(len(probes)), np.clip(true_idx, 0, None)][
        enrolled
    ].tolist()
    impostor_mask = np.ones_like(scores, bool)
    impostor_mask[enrolled, true_idx[enrolled]] = False
    impostor_scores = scores[impostor_mask].tolist()

    n = len(probes)
    thr = np.asarray(thresholds)[:, None]  # [T, 1]
    accepted = best_scores[None, :] >= thr  # [T, P]
    tp = (accepted & pred_correct[None, :]).sum(axis=1)
    fp = (accepted & ~pred_correct[None, :]).sum(axis=1)
    fn = (~accepted).sum(axis=1)

    rank1 = rank["rank1"].mean()
    rank5 = rank["rank5"].mean()
    rank10 = rank["rank10"].mean()
    mrr = rank["reciprocal_rank"].mean()

    rows = []
    for t_i, threshold in enumerate(thresholds):
        acc = accepted[t_i]
        correct_scores = best_scores[acc & pred_correct]
        incorrect_scores = best_scores[acc & ~pred_correct]
        precision = tp[t_i] / (tp[t_i] + fp[t_i]) if (tp[t_i] + fp[t_i]) else 0
        recall = tp[t_i] / (tp[t_i] + fn[t_i]) if (tp[t_i] + fn[t_i]) else 0
        rows.append(
            {
                "threshold": threshold,
                "rank1_accuracy": rank1,
                "rank5_accuracy": rank5,
                "rank10_accuracy": rank10,
                "mrr": mrr,
                "tar": tp[t_i] / n,
                "far": fp[t_i] / n,
                "frr": fn[t_i] / n,
                "precision": precision,
                "recall": recall,
                "f1_score": 2 * precision * recall / (precision + recall)
                if (precision + recall)
                else 0,
                "tp": int(tp[t_i]),
                "fp": int(fp[t_i]),
                "fn": int(fn[t_i]),
                "n_probes": n,
                "avg_correct_score": float(correct_scores.mean())
                if correct_scores.size
                else 0,
                "avg_incorrect_score": float(incorrect_scores.mean())
                if incorrect_scores.size
                else 0,
            }
        )

    roc_auc, avg_precision, fpr, tpr = roc_auc_and_ap(
        pred_correct.astype(int), best_scores
    )

    all_predictions = [
        {
            "true_identity": true_names[i],
            "predicted_identity": names[pred_idx[i]],
            "score": float(best_scores[i]),
            "rank_metrics": {
                "rank1": bool(rank["rank1"][i]),
                "rank5": bool(rank["rank5"][i]),
                "rank10": bool(rank["rank10"][i]),
                "reciprocal_rank": float(rank["reciprocal_rank"][i]),
            },
        }
        for i in range(n)
    ]

    return {
        "threshold_results": pd.DataFrame(rows),
        "roc_auc": roc_auc,
        "average_precision": avg_precision,
        "dprime": compute_dprime(genuine_scores, impostor_scores),
        "genuine_scores": genuine_scores,
        "impostor_scores": impostor_scores,
        "genuine_ci": bootstrap_confidence_interval(genuine_scores),
        "impostor_ci": bootstrap_confidence_interval(impostor_scores),
        "fpr": fpr,
        "tpr": tpr,
        "aggregation": aggregation,
        "all_predictions": all_predictions,
    }


def evaluate_impostors_comprehensive(
    gallery_embeddings: Dict[str, Dict],
    impostor_embeddings: Dict[str, Dict],
    thresholds: List[float],
    aggregation: str = "mean",
    k: int = 3,
    device="cuda",
) -> Dict:
    """Impostor rejection (temp.py:155-201): top identity score per impostor
    probe vs the threshold sweep."""
    names, gallery, mask = pack_gallery(gallery_embeddings, device)

    probes = []
    for data in impostor_embeddings.values():
        embs = np.atleast_2d(np.asarray(data["embeddings"], np.float32))
        if embs.size:
            probes.append(embs)
    if not probes:
        raise ValueError("No impostor embeddings provided")
    probes = np.concatenate(probes, axis=0)

    scores = _score_probes(probes, gallery, mask, aggregation, k)
    impostor_scores = scores.max(axis=1)
    n = len(impostor_scores)

    rows = []
    for threshold in thresholds:
        fp = int((impostor_scores >= threshold).sum())
        tn = n - fp
        rows.append(
            {
                "threshold": threshold,
                "rejection_rate": tn / n,
                "far": fp / n,
                "tn": tn,
                "fp": fp,
                "n_impostors": n,
                "avg_impostor_score": float(impostor_scores.mean()),
            }
        )

    return {
        "threshold_results": pd.DataFrame(rows),
        "impostor_scores": impostor_scores.tolist(),
        "impostor_ci": bootstrap_confidence_interval(impostor_scores),
        "mean_impostor_score": float(impostor_scores.mean()),
        "std_impostor_score": float(impostor_scores.std()),
        "aggregation": aggregation,
    }


def evaluate_segmented_comprehensive(
    gallery_embeddings: Dict[str, Dict],
    probe_embeddings: Dict[str, Dict],
    thresholds: List[float],
    aggregation: str = "mean",
    k: int = 3,
    device="cuda",
) -> Dict[str, Dict]:
    """Per-difficulty-bucket identification (temp.py:204-225)."""
    results = {}
    for segment in (s for s in probe_embeddings if s != "all"):
        results[segment] = evaluate_probes_comprehensive(
            gallery_embeddings,
            {"all": probe_embeddings[segment]},
            thresholds,
            aggregation=aggregation,
            k=k,
            device=device,
        )
    return results
