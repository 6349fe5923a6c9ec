"""Hard evaluation variants that put saturated metrics back on a slope.

Counterpart of `facerecognitionpipeline_tpu/evalharness/hardening.py`.
Enrollment-session embeddings of the same person are trivially separable,
so the base protocol (reference `temp.py:968-1141`) sits at 0 errors. The
variants here degrade it in controlled, seeded ways (numpy
`default_rng(seed)`, the JAX package's draws):

* `noise_sweep` — probes perturbed with Gaussian noise of increasing sigma
  (renormalized): rank-1/EER/AUC as a function of sigma.
* `subsampled_gallery` — enroll only `n_enrolled` of the identities; the
  rest become real open-set impostors.
* `cross_model_impostors` — impostor probes drawn from a different model's
  embedding space; rejection must hold across spaces.

All functions consume/produce the corpus dicts of the main pipeline
(`{name: {"embeddings": [N,512]}}`) and score on `device` ('cuda' raises
without a card).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from facerecognitionpipeline_tpu_torch.evalharness.identification import (
    evaluate_probes_comprehensive,
)
from facerecognitionpipeline_tpu_torch.evalharness.verification import (
    evaluate_verification_comprehensive,
)

DEFAULT_SIGMAS = (0.0, 1.0, 2.0, 4.0, 6.0, 8.0)


def _unwrap(corpus: Dict) -> Dict:
    """Accept BOTH corpus layouts the pipeline produces: person-keyed
    ({name: {'embeddings': ...}}) and category-wrapped ({'all': {name:
    ...}}, the layout pipeline/corpus.py:203 saves for unsegmented
    corpora). Same tolerance as evaluate_probes/verification
    (identification.py:51, verification.py:33) — without it, noise_sweep
    KeyErrors on 'embeddings', subsampled_gallery silently turns the whole
    positive set into impostors (no top-level name matches a person), and
    cross_model_impostors crashes in verification."""
    return corpus.get("all", corpus) if corpus else corpus


def perturb_corpus(corpus: Dict[str, Dict], sigma: float, seed: int = 0) -> Dict:
    """Perturb every embedding with an isotropic noise vector whose NORM is
    `sigma * ||embedding||`, then renormalize.

    Sigma is a noise-to-signal ratio, not a per-component std — with 512-d
    unit embeddings a per-component sigma of s carries total norm
    ~sqrt(512)*s and already obliterates the signal at s=0.2. At ratio r the
    expected residual cosine to the clean embedding is ~1/sqrt(1+r^2):
    r=0.5 -> 0.89, r=1 -> 0.71, r=1.5 -> 0.55."""
    corpus = _unwrap(corpus)
    if sigma == 0.0:
        return corpus
    rng = np.random.default_rng(seed)
    out = {}
    for name, data in corpus.items():
        embs = np.atleast_2d(np.asarray(data["embeddings"], np.float32))
        noise = rng.normal(size=embs.shape).astype(np.float32)
        noise *= (
            sigma
            * np.linalg.norm(embs, axis=1, keepdims=True)
            / (np.linalg.norm(noise, axis=1, keepdims=True) + 1e-12)
        )
        noisy = embs + noise
        noisy /= np.linalg.norm(noisy, axis=1, keepdims=True) + 1e-8
        out[name] = {**data, "embeddings": noisy}
    return out


def _headline(gallery, probes, negatives, thresholds, aggregation="mean",
              device="cuda") -> Dict:
    ident = evaluate_probes_comprehensive(
        gallery, probes, thresholds, aggregation=aggregation, device=device
    )
    ver = evaluate_verification_comprehensive(
        gallery, probes, negatives, thresholds, aggregation=aggregation,
        device=device,
    )
    df = ident["threshold_results"]
    auc = ver["roc_auc"]
    return {
        "rank1_accuracy": float(df["rank1_accuracy"].iloc[0]),
        "mrr": float(df["mrr"].iloc[0]),
        "dprime": float(ver["dprime"]),
        "roc_auc": None if auc is None else float(auc),
        "eer": float(ver["eer"]),
        "tar_at_far_1pct": float(ver["tar_at_far_0.01"]),
        "genuine_mean": float(ver["genuine_mean"]),
        "impostor_mean": float(ver["impostor_mean"]),
    }


def noise_sweep(
    gallery: Dict,
    probes: Dict,
    negatives: Dict,
    thresholds: List[float],
    sigmas: Sequence[float] = DEFAULT_SIGMAS,
    seed: int = 0,
    device="cuda",
) -> List[Dict]:
    """Headline metrics per noise sigma applied to the probe embeddings."""
    gallery = _unwrap(gallery)
    rows = []
    for i, sigma in enumerate(sigmas):
        noisy_pos = perturb_corpus(probes, sigma, seed=seed + i)
        noisy_neg = perturb_corpus(negatives, sigma, seed=seed + 1000 + i)
        rows.append(
            {"sigma": float(sigma),
             **_headline(gallery, noisy_pos, noisy_neg, thresholds, device=device)}
        )
    return rows


def subsampled_gallery(
    gallery: Dict,
    probes: Dict,
    negatives: Dict,
    thresholds: List[float],
    n_enrolled: int,
    seed: int = 0,
    device="cuda",
) -> Dict:
    """Enroll a random subset; everyone else's probes become impostors."""
    # negatives too: an 'all'-wrapped negative dict left wrapped would make
    # verification's probe_negative.get('all') select ONLY the wrapped inner
    # dict and silently drop every de-enrolled open-set impostor merged in
    # below — the 'hard' variant would report the easy baseline numbers.
    gallery, probes = _unwrap(gallery), _unwrap(probes)
    negatives = _unwrap(negatives)
    rng = np.random.default_rng(seed)
    names = sorted(gallery)
    keep = set(rng.choice(names, size=min(n_enrolled, len(names)), replace=False))
    sub_gallery = {n: gallery[n] for n in names if n in keep}
    sub_probes = {n: d for n, d in probes.items() if n in keep}
    extra_impostors = {n: d for n, d in probes.items() if n not in keep}
    sub_negatives = {**negatives, **extra_impostors}
    return {
        "n_enrolled": len(sub_gallery),
        # count only the de-enrolled identities — sub_negatives also holds
        # the negative-corpus CATEGORY keys ('real', 'lfw'), not identities
        "n_open_set_identities": len(extra_impostors),
        **_headline(sub_gallery, sub_probes, sub_negatives, thresholds, device=device),
    }


def noise_knee(rows: List[Dict], criterion: float = 0.95) -> Optional[float]:
    """The noise-to-signal ratio at which rank-1 first crosses `criterion`,
    linearly interpolated between the bracketing sweep sigmas.

    THE summary scalar of a noise sweep: saturated protocols report 1.0
    rank-1 at every low sigma, but the knee moves continuously with any
    numeric regression in the scoring stack. None if the sweep never drops
    below the criterion (knee beyond the swept range)."""
    prev = None
    for row in rows:
        if row["rank1_accuracy"] < criterion:
            if prev is None:
                return float(row["sigma"])
            ds = row["sigma"] - prev["sigma"]
            dr = prev["rank1_accuracy"] - row["rank1_accuracy"]
            if dr <= 0:
                return float(row["sigma"])
            frac = (prev["rank1_accuracy"] - criterion) / dr
            return float(prev["sigma"] + frac * ds)
        prev = row
    return None


def headline_hard_block(hard: Dict) -> Dict:
    """Compress one model's hard-variant results into the front-page
    operating points (VERDICT r3 #3: no top-level metric at floor/ceiling).

    Input layout = what examples/real_embedding_eval.py stores per model:
    {'noise_sweep': [...], 'subsampled_gallery_10': {...},
     'cross_model_impostors': {...}}. Every extracted scalar is genuinely
    sloped: the knee interpolates between sweep points, the sigma-point
    metrics sit past the knee, and the margins are score-scale quantities
    that move with any embedding/scoring change."""
    sweep = hard["noise_sweep"]
    by_sigma = {row["sigma"]: row for row in sweep}
    hardest = sweep[-1]
    sub = hard.get("subsampled_gallery_10", {})
    xm = hard.get("cross_model_impostors", {})

    def margin(block):
        if "genuine_mean" not in block or "impostor_mean" not in block:
            return None
        return round(block["genuine_mean"] - block["impostor_mean"], 4)

    out = {
        "noise_knee_sigma": noise_knee(sweep),
        "rank1_at_sigma_max": hardest["rank1_accuracy"],
        "eer_at_sigma_max": hardest["eer"],
        "dprime_at_sigma4": (
            by_sigma[4.0]["dprime"] if 4.0 in by_sigma else None
        ),
        "open_set_margin_n10": margin(sub),
        "open_set_dprime_n10": sub.get("dprime"),
        "cross_model_margin": margin(xm),
        "sigma_max": hardest["sigma"],
    }
    return {k: (round(v, 4) if isinstance(v, float) else v)
            for k, v in out.items()}


def cross_model_impostors(
    gallery: Dict,
    probes: Dict,
    other_model_probes: Dict,
    thresholds: List[float],
    negatives: Optional[Dict] = None,
    device="cuda",
) -> Dict:
    """Impostor set = another model's probe embeddings (different space).

    The embeddings describe the SAME people, but in a foreign model's
    coordinate system — a well-behaved matcher must reject them all."""
    gallery, probes = _unwrap(gallery), _unwrap(probes)
    impostors = {
        f"xmodel_{name}": data
        for name, data in _unwrap(other_model_probes).items()
    }
    if negatives:
        # unwrap first: an 'all' key in the merged dict would make
        # verification discard every xmodel_* impostor via .get('all')
        impostors.update(_unwrap(negatives))
    return _headline(gallery, probes, impostors, thresholds, device=device)
