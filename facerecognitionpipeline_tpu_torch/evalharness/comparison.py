"""Cross-model/gallery analysis: summary tables, statistics, failure modes.

Counterpart of `facerecognitionpipeline_tpu/evalharness/comparison.py`
(host only): the reference's analyses and table schemas
(`generate_comparison_summary` temp.py:232-299, `analyze_gallery_strategies`
temp.py:301-341, `analyze_failure_cases` temp.py:411-457,
`compare_models_statistical` temp.py:460-499, `scipy.stats.ttest_rel`).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import pandas as pd
from scipy import stats


def generate_comparison_summary(all_model_results: Dict) -> pd.DataFrame:
    """Best-threshold identification summary per model x gallery x aggregation."""
    rows = []
    for model_name, model_data in all_model_results.items():
        for gallery_name, gallery_results in model_data.get("basic_probe", {}).items():
            for agg, results in gallery_results.items():
                df = results["threshold_results"]
                # Rank metrics are threshold-independent (computed from the
                # full score ranking), so the reference's bare
                # idxmax(rank1_accuracy) always lands on the FIRST sweep row
                # and reports F1/TAR/FAR at the arbitrary lowest threshold
                # (temp.py:242). Tie-break by F1 so Best_Threshold is a real
                # operating point.
                best = df.loc[
                    df.sort_values(
                        ["rank1_accuracy", "f1_score"], kind="stable"
                    ).index[-1]
                ]
                rows.append(
                    {
                        "Model": model_name,
                        "Gallery": gallery_name,
                        "Aggregation": agg,
                        "Rank-1": best["rank1_accuracy"],
                        "Rank-5": best["rank5_accuracy"],
                        "Rank-10": best["rank10_accuracy"],
                        "MRR": best["mrr"],
                        "ROC-AUC": results["roc_auc"],
                        "d-prime": results["dprime"],
                        "Best_Threshold": best["threshold"],
                        "F1-Score": best["f1_score"],
                        "TAR": best["tar"],
                        "FAR": best["far"],
                    }
                )
    return pd.DataFrame(rows)


def generate_verification_summary(all_model_results: Dict) -> pd.DataFrame:
    """Verification metrics per model x gallery x aggregation (v2 cell 10)."""
    rows = []
    for model_name, model_data in all_model_results.items():
        for gallery_name, gallery_results in model_data.get("verification", {}).items():
            for agg, v in gallery_results.items():
                rows.append(
                    {
                        "Model": model_name,
                        "Gallery": gallery_name,
                        "Aggregation": agg,
                        "ROC-AUC": v["roc_auc"],
                        "EER": v["eer"],
                        "EER_Threshold": v["eer_threshold"],
                        "TAR@FAR=0.1%": v["tar_at_far_0.001"],
                        "TAR@FAR=1%": v["tar_at_far_0.01"],
                        "TAR@FAR=10%": v["tar_at_far_0.1"],
                        "d-prime": v["dprime"],
                        "Genuine_Mean": v["genuine_mean"],
                        "Impostor_Mean": v["impostor_mean"],
                    }
                )
    return pd.DataFrame(rows)


def analyze_gallery_strategies(all_model_results: Dict) -> pd.DataFrame:
    """one-shot vs few-shot x base vs augmented (temp.py:301-341)."""
    rows = []
    for model_name, model_data in all_model_results.items():
        configs = {}
        for gallery_name, gallery_results in model_data.get("basic_probe", {}).items():
            best_rank1, best_agg = 0, None
            for agg, results in gallery_results.items():
                r1 = results["threshold_results"]["rank1_accuracy"].max()
                if r1 > best_rank1:
                    best_rank1, best_agg = r1, agg
            configs[gallery_name] = {"rank1": best_rank1, "agg": best_agg}
        if not configs:
            continue
        g = lambda name: configs.get(name, {}).get("rank1", 0)  # noqa: E731
        rows.append(
            {
                "Model": model_name,
                "Oneshot_Base": g("oneshot_base"),
                "Oneshot_Aug": g("oneshot_augmented"),
                "Fewshot_Base": g("fewshot_base"),
                "Fewshot_Aug": g("fewshot_augmented"),
                "Aug_Improvement_Oneshot": g("oneshot_augmented") - g("oneshot_base"),
                "Aug_Improvement_Fewshot": g("fewshot_augmented") - g("fewshot_base"),
                "Fewshot_Improvement_Base": g("fewshot_base") - g("oneshot_base"),
                "Fewshot_Improvement_Aug": g("fewshot_augmented") - g("oneshot_augmented"),
                "Best_Config": max(configs.items(), key=lambda x: x[1]["rank1"])[0],
                "Best_Rank1": max(c["rank1"] for c in configs.values()),
            }
        )
    return pd.DataFrame(rows)


def analyze_failure_cases(all_model_results: Dict) -> Dict:
    """Misclassification confusion pairs per model x gallery (temp.py:411-457)."""
    analysis = {}
    for model_name, model_data in all_model_results.items():
        for gallery_name, gallery_results in model_data.get("basic_probe", {}).items():
            results = gallery_results.get("mean")
            if not results:
                continue
            predictions = results.get("all_predictions", [])
            if not predictions:
                continue
            misclassified = [
                p for p in predictions
                if p["predicted_identity"] != p["true_identity"]
            ]
            confusion: Dict[str, int] = {}
            identity_errors: Dict[str, int] = {}
            for p in misclassified:
                pair = f"{p['true_identity']} -> {p['predicted_identity']}"
                confusion[pair] = confusion.get(pair, 0) + 1
                identity_errors[p["true_identity"]] = (
                    identity_errors.get(p["true_identity"], 0) + 1
                )
            analysis[f"{model_name}_{gallery_name}"] = {
                "total_predictions": len(predictions),
                "total_errors": len(misclassified),
                "error_rate": len(misclassified) / len(predictions),
                "top_confusion_pairs": sorted(
                    confusion.items(), key=lambda x: x[1], reverse=True
                )[:10],
                "most_confused_identities": sorted(
                    identity_errors.items(), key=lambda x: x[1], reverse=True
                )[:10],
            }
    return analysis


def compare_models_statistical(
    all_model_results: Dict, gallery: str = "fewshot_augmented", agg: str = "mean"
) -> pd.DataFrame:
    """Pairwise paired t-test + Cohen's d on correct-match scores
    (temp.py:460-499)."""
    rows = []
    models = list(all_model_results)
    for i, m1 in enumerate(models):
        for m2 in models[i + 1 :]:
            try:
                r1 = all_model_results[m1]["basic_probe"][gallery][agg]
                r2 = all_model_results[m2]["basic_probe"][gallery][agg]
                s1 = [
                    p["score"] if p["predicted_identity"] == p["true_identity"] else 0
                    for p in r1["all_predictions"]
                ]
                s2 = [
                    p["score"] if p["predicted_identity"] == p["true_identity"] else 0
                    for p in r2["all_predictions"]
                ]
                t_stat, p_value = stats.ttest_rel(s1, s2)
                mean_diff = np.mean(s1) - np.mean(s2)
                pooled = np.sqrt((np.std(s1) ** 2 + np.std(s2) ** 2) / 2)
                d = mean_diff / pooled if pooled > 0 else 0
                rows.append(
                    {
                        "Model_A": m1,
                        "Model_B": m2,
                        "Mean_Diff": mean_diff,
                        "t_statistic": t_stat,
                        "p_value": p_value,
                        "Significant": "Yes" if p_value < 0.05 else "No",
                        "Cohens_d": d,
                        "Effect_Size": "Small"
                        if abs(d) < 0.5
                        else ("Medium" if abs(d) < 0.8 else "Large"),
                    }
                )
            except (KeyError, ValueError):
                continue
    return pd.DataFrame(rows)
