"""Core evaluation math: device-batched identity scoring + host statistics.

Counterpart of `facerecognitionpipeline_tpu/evalharness/metrics.py`. The
reference evaluates identification with a Python triple loop (per probe, per
identity, per gallery embedding; `identify_probe`, evaluate_models_v2.ipynb
cell 5). Here all probes score against all identities in one masked einsum
on the gallery's device (`identity_scores_batch`, float32 with TF32 off;
the JAX package's is an XLA einsum, no Pallas kernel), and rank metrics
vectorize over the probe axis. The statistics (d', bootstrap CI, ROC-AUC,
AP) are host numpy: the JAX package's functions as they are, and ROC-AUC and
AP by scikit-learn's definitions without scikit-learn.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from facerecognitionpipeline_tpu_torch.ops.nms import top_k
from facerecognitionpipeline_tpu_torch.utils.device import resolve_device

_EPS = 1e-8
_NEG = -1e9


def pack_gallery(gallery_embeddings: Dict[str, Dict], device="cuda") -> tuple:
    """{name: {'embeddings': [M_i, 512]}} -> (names, padded [I, Mmax, 512],
    mask [I, Mmax]), both tensors on `device` ('cuda' raises without a
    card). Embeddings are L2-normalized on the host during packing."""
    dev = resolve_device(device)
    names = list(gallery_embeddings.keys())
    if not names:
        raise ValueError("pack_gallery: gallery_embeddings is empty")
    mats = [np.atleast_2d(np.asarray(gallery_embeddings[n]["embeddings"],
                                     dtype=np.float32)) for n in names]
    m_max = max(m.shape[0] for m in mats)
    dim = mats[0].shape[1]
    packed = np.zeros((len(names), m_max, dim), np.float32)
    mask = np.zeros((len(names), m_max), bool)
    for i, m in enumerate(mats):
        m = m / (np.linalg.norm(m, axis=1, keepdims=True) + _EPS)
        packed[i, : m.shape[0]] = m
        mask[i, : m.shape[0]] = True
    return names, torch.from_numpy(packed).to(dev), torch.from_numpy(mask).to(dev)


def identity_scores_batch(
    probes: torch.Tensor,
    gallery: torch.Tensor,
    mask: torch.Tensor,
    aggregation: str = "mean",
    k: int = 3,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """[P,512] probes x [I,M,512] packed gallery -> [P,I] identity scores
    in `dtype` (float32, as the JAX package; float64 for a reference), on
    the gallery's device.

    aggregation: 'max' | 'mean' | 'topk' over each identity's gallery
    embeddings (notebook aggregate_{max,mean,topk}); unknown names fall back
    to max, as in the reference. 'topk' keeps ties in the lower slot first
    (`ops/nms.py::top_k`, the order of `lax.top_k`)."""
    probes = torch.as_tensor(probes, device=gallery.device).to(dtype)
    p = probes / (torch.linalg.vector_norm(probes, dim=1, keepdim=True) + _EPS)
    sims = torch.einsum("pd,imd->pim", p, gallery.to(dtype))  # [P, I, M]
    valid = mask[None, :, :]
    if aggregation == "mean":
        total = torch.where(valid, sims, 0.0).sum(dim=2)
        count = valid.sum(dim=2).clamp_min(1)
        return total / count
    if aggregation == "topk":
        masked = torch.where(valid, sims, _NEG)
        kk = min(k, sims.shape[2])
        top, _ = top_k(masked, kk)
        cnt = valid.sum(dim=2).clamp_max(kk)
        top = torch.where(top > _NEG / 2, top, 0.0)
        return top.sum(dim=2) / cnt.clamp_min(1)
    return torch.where(valid, sims, _NEG).amax(dim=2)


def compute_rank_metrics_batch(
    scores: np.ndarray, true_idx: np.ndarray, ranks: List[int] = [1, 5, 10]
) -> Dict[str, np.ndarray]:
    """Vectorized rank metrics. scores [P, I]; true_idx [P] (−1 = true
    identity not enrolled). Returns {'rank1': [P] bool, ..., 'reciprocal_rank':
    [P] float} matching notebook compute_rank_metrics (cell 6) semantics:
    rank counts strictly-greater scores (ties resolved optimistically)."""
    p, i = scores.shape
    enrolled = true_idx >= 0
    safe_idx = np.clip(true_idx, 0, i - 1)
    true_scores = scores[np.arange(p), safe_idx]
    higher = np.sum(scores > true_scores[:, None], axis=1)
    rank = higher + 1
    out: Dict[str, np.ndarray] = {}
    for r in ranks:
        out[f"rank{r}"] = enrolled & (rank <= r)
    out["reciprocal_rank"] = np.where(enrolled, 1.0 / rank, 0.0)
    return out


def compute_dprime(genuine_scores, impostor_scores) -> float:
    """(mean_g - mean_i) / pooled std (notebook cell 6)."""
    if len(genuine_scores) == 0 or len(impostor_scores) == 0:
        return 0.0
    g, imp = np.asarray(genuine_scores), np.asarray(impostor_scores)
    pooled = np.sqrt((g.std() ** 2 + imp.std() ** 2) / 2)
    if pooled == 0:
        return 0.0
    return float((g.mean() - imp.mean()) / pooled)


def bootstrap_confidence_interval(
    data, n_bootstrap: int = 1000, confidence: float = 0.95, seed: int = 0
) -> Tuple[float, float]:
    """Percentile bootstrap CI of the mean: the same `default_rng(seed)`
    draws, in the same row chunks (at most 16e6 samples at a time), as the
    JAX package, so equal data give equal bounds."""
    data = np.asarray(data, dtype=np.float64)
    if data.size == 0:
        return (0.0, 0.0)
    rng = np.random.default_rng(seed)
    means = np.empty(n_bootstrap, dtype=np.float64)
    row_chunk = max(1, min(n_bootstrap, int(16e6) // data.size))
    for start in range(0, n_bootstrap, row_chunk):
        stop = min(start + row_chunk, n_bootstrap)
        samples = rng.choice(data, size=(stop - start, data.size), replace=True)
        means[start:stop] = samples.mean(axis=1)
    alpha = 1 - confidence
    return (
        float(np.percentile(means, alpha / 2 * 100)),
        float(np.percentile(means, (1 - alpha / 2) * 100)),
    )


def _binary_clf_curve(y_true: np.ndarray, y_scores: np.ndarray):
    """(fps, tps, thresholds) at each distinct score, descending: the
    counts scikit-learn's `confusion_matrix_at_thresholds` returns (float64
    cumulative sums, the last index of each run of equal scores)."""
    y_true = np.asarray(y_true).ravel() == 1
    y_scores = np.asarray(y_scores).ravel()
    order = np.argsort(y_scores, kind="stable")[::-1]
    y_scores, y_true = y_scores[order], y_true[order].astype(np.float64)
    idx = np.r_[np.nonzero(np.diff(y_scores))[0], y_true.size - 1]
    tps = np.cumsum(y_true, dtype=np.float64)[idx]
    fps = 1 + idx.astype(np.float64) - tps
    return fps, tps, y_scores[idx]


def roc_auc_and_ap(
    y_true: np.ndarray, y_scores: np.ndarray
) -> Tuple[Optional[float], Optional[float], np.ndarray, np.ndarray]:
    """ROC-AUC + average precision, with scikit-learn's definitions (the
    reference's `roc_curve` with its intermediate points dropped, `auc` by
    the trapezoid rule, `average_precision_score` as the step integral of
    the precision-recall curve) in numpy, so the harness needs no sklearn;
    the tests hold it to sklearn within 1e-12.

    With a single class present both metrics are undefined and reported as
    None (-> JSON null, 'n/a' in summaries), never 0.0."""
    if len(set(np.asarray(y_true).tolist())) < 2:
        return None, None, np.array([0.0, 1.0]), np.array([0.0, 1.0])
    fps, tps, _ = _binary_clf_curve(y_true, y_scores)

    ps = tps + fps
    precision = np.where(ps != 0, tps / np.where(ps != 0, ps, 1.0), 0.0)
    recall = tps / tps[-1]
    precision, recall = np.r_[precision[::-1], 1.0], np.r_[recall[::-1], 0.0]
    ap = float(max(0.0, -np.sum(np.diff(recall) * precision[:-1])))

    if fps.shape[0] > 2:  # drop the points inside straight segments
        keep = np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), True]
        fps, tps = fps[keep], tps[keep]
    fpr = np.r_[0.0, fps] / fps[-1]
    tpr = np.r_[0.0, tps] / tps[-1]
    auc = float(np.sum(np.diff(fpr) * (tpr[1:] + tpr[:-1]) / 2.0))
    return auc, ap, fpr, tpr


def fmt_metric(value, spec: str = ".3f") -> str:
    """Format a possibly-undefined (None/NaN) metric for human-facing text."""
    if value is None:
        return "n/a"
    try:
        if np.isnan(value):
            return "n/a"
    except TypeError:
        pass
    return format(value, spec)
